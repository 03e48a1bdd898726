"""Per-image standardisation with the reference's numerics (the counterpart of
shmgan_tpu/ops/standardize.py):

  - moments over the whole image (all of H, W, C together);
  - variance = relu(E[x^2] - E[x]^2), stddev = sqrt(variance);
  - scale = max(stddev, 1/256) at every image size (the reference hardcodes
    num_pixels = 65536, so the floor is rsqrt(65536) even at 128 px);
  - NO mean subtraction.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

MIN_STDDEV = 1.0 / 256.0


class ImageStats(NamedTuple):
    mean: torch.Tensor      # per-image mean (B,)
    stddev: torch.Tensor    # per-image scale actually applied (>= MIN_STDDEV)
    variance: torch.Tensor  # per-image variance


def per_image_standardization(image: torch.Tensor) -> Tuple[torch.Tensor, ImageStats]:
    """(B, ...) -> (image / max(stddev, 1/256), per-image stats), in f32."""
    x = image.float()
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dim=dims)
    variance = torch.clamp(x.square().mean(dim=dims) - mean.square(), min=0.0)
    scale = torch.clamp(torch.sqrt(variance), min=MIN_STDDEV)
    out = x / scale.view((-1,) + (1,) * (x.dim() - 1))
    return out, ImageStats(mean=mean, stddev=scale, variance=variance)
