"""Dichromatic chroma prior for specular masks (the counterpart of
shmgan_tpu/ops/specprior.py): a soft per-pixel score from the min-channel
excess over a robust per-image baseline, united with "bright and
desaturated". No parameters.

Medians and quantiles sort each image's row (`torch.sort`, any length) and
read it as `jnp.quantile` does: the position q * (n - 1) in float32, the
two values either side of it blended linearly, and a median (`jnp.median`)
as the mean of those two, so an even count averages its middle pair.
`torch.quantile` is not used: it refuses rows of more than 2^24 elements.
With `sp` (parallel/spatial.py) the images are bands of rows: each
quantile gathers its one-channel plane whole over the row, which is exact.
"""

from __future__ import annotations

import numpy as np
import torch


def _per_image_quantile(x: torch.Tensor, q: float, midpoint: bool = False,
                        sp=None) -> torch.Tensor:
    """Quantile over everything but the batch axis of (B, H, W, 1) -> (B, 1, 1, 1).
    midpoint: the mean of the two values either side of q * (n - 1), as
    `jnp.median` reads q = 0.5; else their linear blend (`jnp.quantile`)."""
    if sp is not None:
        x = sp.gather_whole(x, 1)
    b = x.shape[0]
    flat = x.reshape(b, -1)
    n = flat.shape[1]
    pos = np.float32(q) * np.float32(n - 1)
    lo_pos = np.floor(pos)
    hi_w = np.float32(pos - lo_pos)
    lo, hi = min(int(lo_pos), n - 1), min(int(np.ceil(pos)), n - 1)
    srt = torch.sort(flat, dim=1).values
    lo_v, hi_v = srt[:, lo], srt[:, hi]
    if midpoint:
        out = (lo_v + hi_v) * 0.5
    else:
        out = lo_v * float(np.float32(1.0) - hi_w) + hi_v * float(hi_w)
    return out.view(b, 1, 1, 1)


def _per_image_median(x: torch.Tensor, sp=None) -> torch.Tensor:
    return _per_image_quantile(x, 0.5, midpoint=True, sp=sp)


def chroma_prior(rgb: torch.Tensor, sp=None) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 1] -> (B, H, W, 1) prior in [0, 1], f32."""
    x = rgb.float()
    mx = x.amax(dim=-1, keepdim=True)
    mn = x.amin(dim=-1, keepdim=True)
    sat = (mx - mn) / torch.clamp(mx, min=1e-3)

    # min-channel excess over the per-image median, in units of the MAD
    med = _per_image_median(mn, sp)
    mad = _per_image_median((mn - med).abs(), sp) + 1e-3
    p_minc = torch.sigmoid(((mn - med) / mad - 6.0) / 2.0)

    # bright (above the image's 90th percentile and an absolute floor) and
    # desaturated
    v = x.mean(dim=-1, keepdim=True)
    p_bright = (torch.sigmoid((v - _per_image_quantile(v, 0.90, sp=sp)) / 0.03)
                * torch.sigmoid((v - 0.5) / 0.1))
    p_desat = torch.sigmoid((0.25 - sat) / 0.08)
    return torch.maximum(p_minc, p_bright * p_desat)


def fuse_mask_prior(p_net: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """Plain mean of the net's probability and the prior."""
    return 0.5 * (p_net.float() + prior)


def specseg_net_input(y_std: torch.Tensor, rgb: torch.Tensor,
                      in_channels: int, sp=None) -> torch.Tensor:
    """SpecSeg input (B, H, W, in_channels): the standardised luma, and for
    in_channels=2 the chroma prior of the same RGB as a second channel."""
    if in_channels == 1:
        return y_std
    if in_channels == 2:
        return torch.cat([y_std, chroma_prior(rgb, sp)], dim=-1)
    raise ValueError(f"specseg_in_channels must be 1 or 2, got {in_channels}")
