"""Batch inference engine: the counterpart of shmgan_tpu/serve.py's
`BatchInferenceEngine.process_images`.

The engine runs at a fixed batch size with the weights resident on the
device, and pads a partial batch to that size, so every call the device sees
has one shape. Numpy in, numpy out.

    gen, specseg = build_models(cfg, device="cuda", seed=0)
    engine = BatchInferenceEngine(cfg, gen, specseg, batch_size=8)
    outputs = engine.process_images(rgb_batch)   # (N, H, W, 3) float32 in [0, 1]

Folder and HTTP serving are not ported yet: they need an image decoder.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.infer import make_infer_fn


class BatchInferenceEngine:
    def __init__(self, cfg: Config, gen: torch.nn.Module, specseg: torch.nn.Module,
                 batch_size: int = 8, with_cyclic: bool = False, device: str = "cuda"):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._gen = gen.to(self.device).eval()
        self._specseg = specseg.to(self.device).eval()
        self._infer = make_infer_fn(cfg, with_cyclic=with_cyclic)

    def process_images(self, rgb: np.ndarray) -> Dict[str, np.ndarray]:
        """(N, H, W, 3) float32 in [0, 1] -> dict of numpy outputs with N
        leading (cyc_rgb: (c_dim, N, H, W, 3))."""
        rgb = np.asarray(rgb, np.float32)
        if rgb.ndim != 4 or rgb.shape[-1] != 3 or rgb.shape[0] == 0:
            raise ValueError(f"process_images: expected (N, H, W, 3), got {rgb.shape}")
        outs = []
        for i in range(0, rgb.shape[0], self.batch_size):
            chunk = rgb[i:i + self.batch_size]
            real = chunk.shape[0]
            if real < self.batch_size:
                pad = np.zeros((self.batch_size - real,) + chunk.shape[1:], np.float32)
                chunk = np.concatenate([chunk, pad])
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            out = self._infer(self._gen, self._specseg, x)
            outs.append({k: (v[:, :real] if k == "cyc_rgb" else v[:real]).cpu().numpy()
                         for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs], axis=1 if k == "cyc_rgb" else 0)
                for k in outs[0]}
