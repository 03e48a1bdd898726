"""Evaluation metrics: the counterpart of shmgan_tpu/eval/metrics.py. Per
image: SSIM (max_val 5 on min-max-rescaled RGB), PSNR (max_val 1), MSE, and
the mean CIE76 and CIE94 colour differences in Lab; a per-image and mean
report, and a jsonl dump with the JAX package's rows.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from shmgan_tpu_torch.ops.color import delta_e_76, delta_e_94, rgb_to_lab
from shmgan_tpu_torch.ops.ssim import psnr as psnr_fn
from shmgan_tpu_torch.ops.ssim import ssim as ssim_fn
from shmgan_tpu_torch.ops.standardize import rescale_01_per_image


@torch.no_grad()
def evaluate_pair(generated, target) -> Dict[str, torch.Tensor]:
    """Per-image metrics of (B, H, W, 3) RGB pairs (tensors or arrays; the
    target goes to the generated tensor's device): a dict of (B,) float32
    tensors, keys in sorted order, as the JAX package's jitted function
    returns them (so rows and dumps list them in its order)."""
    g = torch.as_tensor(generated).float()
    t = torch.as_tensor(target, device=g.device).float()
    lab_g = rgb_to_lab(torch.clamp(g, 0.0, 1.0))
    lab_t = rgb_to_lab(torch.clamp(t, 0.0, 1.0))
    return {"deltaE76": delta_e_76(lab_g, lab_t).mean(dim=(1, 2)),
            "deltaE94": delta_e_94(lab_g, lab_t).mean(dim=(1, 2)),
            "mse": ((g - t) ** 2).mean(dim=(1, 2, 3)),
            "psnr": psnr_fn(g, t, max_val=1.0),
            "ssim": ssim_fn(rescale_01_per_image(g), rescale_01_per_image(t), max_val=5.0)}


class MetricAccumulator:
    """Collects per-image rows and renders the report."""

    COLUMNS = ("time", "mse", "ssim", "psnr", "deltaE76", "deltaE94")

    def __init__(self):
        self.rows: List[Dict[str, float]] = []

    def add(self, metrics: Dict[str, torch.Tensor], wall_time: Optional[float] = None) -> None:
        values = {k: np.asarray(torch.as_tensor(v).detach().cpu(), np.float64)
                  for k, v in metrics.items()}
        for i in range(values["ssim"].shape[0]):
            row = {k: float(v[i]) for k, v in values.items()}
            row["time"] = float(wall_time) if wall_time is not None else float("nan")
            self.rows.append(row)

    def means(self) -> Dict[str, float]:
        if not self.rows:
            return {}
        return {c: float(np.mean([r[c] for r in self.rows])) for c in self.COLUMNS}

    def report(self) -> str:
        """Per-image rows and the mean row, tab-separated (the JAX package's
        text without `tabulate`)."""
        header = ["Image#"] + list(self.COLUMNS)
        table = [[i + 1] + [r[c] for c in self.COLUMNS] for i, r in enumerate(self.rows)]
        means = self.means()
        mean_row = [["MEAN"] + [means[c] for c in self.COLUMNS]]
        lines = ["\t".join(header)]
        lines += ["\t".join(str(x) for x in row) for row in table + mean_row]
        return "\n".join(lines)

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for i, row in enumerate(self.rows):
                f.write(json.dumps({"image": i + 1, **row}) + "\n")
            f.write(json.dumps({"mean": self.means()}) + "\n")
