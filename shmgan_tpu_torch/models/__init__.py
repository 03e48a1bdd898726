"""The port's models, and `build_models` (the counterpart of
shmgan_tpu/train/state.py's, without the discriminator)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.models.generator import SHMGenerator
from shmgan_tpu_torch.models.specseg import SpecSeg

__all__ = ["SHMGenerator", "SpecSeg", "build_models"]


def build_models(cfg: Config, device: str = "cuda",
                 seed: Optional[int] = None) -> Tuple[SHMGenerator, SpecSeg]:
    """(G, SpecSeg) in eval mode on `device`.

    With a seed the weights are random at the JAX init's scales, drawn from a
    torch.Generator on the CPU; without one they are left as built, for
    convert.py to fill."""
    m = cfg.model
    gen = SHMGenerator(filter_size=m.filter_size, c_dim=m.c_dim,
                       instance_norm_eps=m.instance_norm_eps,
                       slope=m.leaky_relu_slope, upsample_mode=m.upsample_mode)
    specseg = SpecSeg(base_filters=m.specseg_base_filters,
                      in_channels=m.specseg_in_channels)
    if seed is not None:
        rng = torch.Generator().manual_seed(seed)
        gen.init_(rng)
        specseg.init_(rng)
    return gen.to(device).eval(), specseg.to(device).eval()
