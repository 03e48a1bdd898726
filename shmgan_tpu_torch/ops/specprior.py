"""Dichromatic chroma prior for specular masks (the counterpart of
shmgan_tpu/ops/specprior.py): a soft per-pixel score from the min-channel
excess over a robust per-image baseline, united with "bright and
desaturated". No parameters.

`jnp.median` averages the two middle values of an even count where
`torch.median` returns the lower one, so medians are `torch.quantile(.., 0.5)`;
`jnp.quantile` and `torch.quantile` both interpolate linearly.
"""

from __future__ import annotations

import torch


def _per_image_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile over everything but the batch axis of (B, H, W, 1) -> (B, 1, 1, 1)."""
    b = x.shape[0]
    return torch.quantile(x.reshape(b, -1), q, dim=1).view(b, 1, 1, 1)


def chroma_prior(rgb: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 1] -> (B, H, W, 1) prior in [0, 1], f32."""
    x = rgb.float()
    mx = x.amax(dim=-1, keepdim=True)
    mn = x.amin(dim=-1, keepdim=True)
    sat = (mx - mn) / torch.clamp(mx, min=1e-3)

    # min-channel excess over the per-image median, in units of the MAD
    med = _per_image_quantile(mn, 0.5)
    mad = _per_image_quantile((mn - med).abs(), 0.5) + 1e-3
    p_minc = torch.sigmoid(((mn - med) / mad - 6.0) / 2.0)

    # bright (above the image's 90th percentile and an absolute floor) and
    # desaturated
    v = x.mean(dim=-1, keepdim=True)
    p_bright = (torch.sigmoid((v - _per_image_quantile(v, 0.90)) / 0.03)
                * torch.sigmoid((v - 0.5) / 0.1))
    p_desat = torch.sigmoid((0.25 - sat) / 0.08)
    return torch.maximum(p_minc, p_bright * p_desat)


def fuse_mask_prior(p_net: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """Plain mean of the net's probability and the prior."""
    return 0.5 * (p_net.float() + prior)


def specseg_net_input(y_std: torch.Tensor, rgb: torch.Tensor,
                      in_channels: int) -> torch.Tensor:
    """SpecSeg input (B, H, W, in_channels): the standardised luma, and for
    in_channels=2 the chroma prior of the same RGB as a second channel."""
    if in_channels == 1:
        return y_std
    if in_channels == 2:
        return torch.cat([y_std, chroma_prior(rgb)], dim=-1)
    raise ValueError(f"specseg_in_channels must be 1 or 2, got {in_channels}")
