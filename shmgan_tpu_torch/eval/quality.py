"""What the checkpoint evaluators (quality_eval.py, ood_eval.py, mask_ab.py)
share: the blocks examples/quality_eval.py and examples/ood_eval.py each
repeat, on the port.

  Evaluator(cfg, gen, specseg, batch, device)
      .infer(rgb)      make_infer_fn's gen_rgb_calibrated, gen_rgb_composited
                       and mask of a (N, H, W, 3) float32 array, `batch`
                       images a call, as float32 numpy arrays
      .features(x)     the SpecSeg-feature embedding (eval/fid.py) of N
                       images, `batch` a call, on the device
      .metrics(x, gts, gt_feats, name)
                       PSNR and SSIM (max_val 1) against the diffuse truth,
                       the FID of x's features against gt_feats, and
                       evaluate_pair's table, as the JSON holds them
  mark_beats_identity(result)   the `beats_identity` rule
  specseg_module(specseg_vars, base_filters, device)
                       a float32 SpecSeg filled from a variable tree

Every term is per image, so the evaluation streams in chunks of `batch`
images: the same numbers as one call over the whole set. A mean is numpy's
mean of the per-image float32 values, rounded as the JAX scripts round:
PSNR, SSIM and the table to 4 decimals, FID to 5. Convolutions and matrix
products run in full float32 (no TF32).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Mapping

import numpy as np
import torch

from shmgan_tpu_torch.checkpoint import specseg_in_channels_of
from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.convert import load_flax
from shmgan_tpu_torch.eval.fid import frechet_distance, specseg_features
from shmgan_tpu_torch.eval.metrics import evaluate_pair
from shmgan_tpu_torch.infer import ieee_f32, make_infer_fn
from shmgan_tpu_torch.models.specseg import SpecSeg
from shmgan_tpu_torch.ops.ssim import ssim as ssim_fn

OUTPUTS = ("gen_rgb_calibrated", "gen_rgb_composited", "mask")


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def specseg_module(specseg_vars: Mapping, base_filters: int, device) -> SpecSeg:
    """A float32 SpecSeg in eval mode on `device`, its input channels read
    from the tree, filled from {"params", "batch_stats"}."""
    net = SpecSeg(base_filters=base_filters, in_channels=specseg_in_channels_of(specseg_vars),
                  dtype=torch.float32)
    load_flax(net, specseg_vars["params"], specseg_vars.get("batch_stats"))
    return net.to(device).eval()


class Evaluator:
    """The chunked inference, features and metrics of one (G, SpecSeg)."""

    def __init__(self, cfg: Config, gen: torch.nn.Module, specseg: torch.nn.Module,
                 batch: int, device: torch.device):
        self.gen, self.specseg, self.batch, self.device = gen, specseg, batch, device
        self._infer = make_infer_fn(cfg, outputs=OUTPUTS)

    def _chunks(self, x: np.ndarray) -> Iterator[torch.Tensor]:
        for i in range(0, x.shape[0], self.batch):
            yield torch.from_numpy(np.ascontiguousarray(x[i:i + self.batch], np.float32)
                                   ).to(self.device)

    def infer(self, rgb: np.ndarray) -> Dict[str, np.ndarray]:
        outs = {k: [] for k in OUTPUTS}
        for chunk in self._chunks(rgb):
            out = self._infer(self.gen, self.specseg, chunk)
            for k in OUTPUTS:
                outs[k].append(out[k].float().cpu().numpy())
        return {k: np.concatenate(v) for k, v in outs.items()}

    def features(self, x: np.ndarray) -> torch.Tensor:
        return torch.cat([specseg_features(self.specseg, c) for c in self._chunks(x)])

    @torch.no_grad()
    def metrics(self, x: np.ndarray, gts: np.ndarray, gt_feats: torch.Tensor,
                name: str) -> Dict:
        psnr_i, ssim_i, rows = [], [], []
        with ieee_f32():
            for xc, g in zip(self._chunks(x), self._chunks(gts)):
                mse = ((xc - g) ** 2).mean(dim=(1, 2, 3))
                psnr_i.append((-10.0 * torch.log10(torch.clamp(mse, min=1e-12))).cpu().numpy())
                ssim_i.append(ssim_fn(xc, g, max_val=1.0).cpu().numpy())
                rows.append({k: v.cpu().numpy() for k, v in evaluate_pair(xc, g).items()})
            fid = float(frechet_distance(self.features(x), gt_feats))
        psnr = float(np.mean(np.concatenate(psnr_i)))
        ssim = float(np.mean(np.concatenate(ssim_i)))
        ref_style = {k: round(float(np.mean(np.concatenate([r[k] for r in rows]))), 4)
                     for k in rows[0]}
        log(f"  {name}: PSNR {psnr:.2f} SSIM {ssim:.4f} FID {fid:.4f} "
            f"deltaE76 {ref_style.get('deltaE76', float('nan')):.2f}")
        return {"psnr": round(psnr, 4), "ssim": round(ssim, 4), "fid": round(fid, 5),
                "reference_style": ref_style}


def mark_beats_identity(result: Dict) -> None:
    """gen_calibrated and gen_composited beat the identity when both their
    (rounded) PSNR and SSIM are above the identity baseline's."""
    base = result["identity_baseline"]
    for key in ("gen_calibrated", "gen_composited"):
        m = result[key]
        m["beats_identity"] = bool(m["psnr"] > base["psnr"] and m["ssim"] > base["ssim"])
