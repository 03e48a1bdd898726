"""The port's models, and `build_models` (the counterpart of
shmgan_tpu/train/state.py's)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from shmgan_tpu_torch.config import Config, compute_dtype
from shmgan_tpu_torch.models.discriminator import SHMDiscriminator
from shmgan_tpu_torch.models.generator import SHMGenerator
from shmgan_tpu_torch.models.specseg import SpecSeg

__all__ = ["SHMDiscriminator", "SHMGenerator", "SpecSeg", "build_models"]


def build_models(cfg: Config, device: str = "cuda", seed: Optional[int] = None
                 ) -> Tuple[SHMGenerator, SHMDiscriminator, SpecSeg]:
    """(G, D, SpecSeg) in eval mode on `device`, computing in
    `cfg.model.compute_dtype` with float32 parameters.

    With a seed the weights are random at the JAX init's scales, drawn from a
    torch.Generator on the CPU (G, then SpecSeg, then D); without one they are
    left as built, for convert.py to fill."""
    m = cfg.model
    dtype = compute_dtype(m.compute_dtype)
    gen = SHMGenerator(filter_size=m.filter_size, c_dim=m.c_dim,
                       instance_norm_eps=m.instance_norm_eps,
                       slope=m.leaky_relu_slope, upsample_mode=m.upsample_mode, dtype=dtype)
    disc = SHMDiscriminator(filter_size=m.filter_size, c_dim=m.c_dim,
                            image_size=m.image_size, instance_norm_eps=m.instance_norm_eps,
                            slope=m.leaky_relu_slope, noise_stddev=m.d_input_noise,
                            dropout_rate=m.d_dropout, dtype=dtype)
    specseg = SpecSeg(base_filters=m.specseg_base_filters,
                      in_channels=m.specseg_in_channels, dtype=dtype)
    if seed is not None:
        rng = torch.Generator().manual_seed(seed)
        gen.init_(rng)
        specseg.init_(rng)
        disc.init_(rng)
    return gen.to(device).eval(), disc.to(device).eval(), specseg.to(device).eval()
