"""Per-image standardisation with the reference's numerics (the counterpart of
shmgan_tpu/ops/standardize.py):

  - moments over the whole image (all of H, W, C together);
  - variance = relu(E[x^2] - E[x]^2), stddev = sqrt(variance);
  - scale = max(stddev, 1/256) at every image size (the reference hardcodes
    num_pixels = 65536, so the floor is rsqrt(65536) even at 128 px);
  - NO mean subtraction.

and the min-max rescales: over the whole tensor, and per image (the one the
train step's SSIM losses take).
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


def rescale_01(x: torch.Tensor) -> torch.Tensor:
    """Min-max rescale to [0, 1] over the whole tensor; a constant tensor
    becomes zeros (tf divide_no_nan)."""
    denom = x.max() - x.min()
    return torch.where(denom == 0, torch.zeros_like(x), (x - x.min()) / denom)


def rescale_01_per_image(x: torch.Tensor) -> torch.Tensor:
    """Per-image min-max rescale to [0, 1] over everything but the batch
    axis; an image with max == min becomes zeros."""
    dims = tuple(range(1, x.dim()))
    lo = x.amin(dim=dims, keepdim=True)
    hi = x.amax(dim=dims, keepdim=True)
    denom = hi - lo
    return torch.where(denom == 0, torch.zeros_like(x), (x - lo) / denom)
