"""Polarimetric helpers (the counterpart of shmgan_tpu/ops/polar.py):

  estimate_diffuse   the estimated diffuse (ED) view, the channel-wise minimum
                     of the four polariser views
  calc_dop           Stokes degree (and angle) of linear polarisation, with tf
                     divide_no_nan's 0 where S0 == 0
  gram_matrix        the batched gram matrix of the NST loss
"""

from __future__ import annotations

from typing import Tuple

import torch


def estimate_diffuse(i0: torch.Tensor, i45: torch.Tensor, i90: torch.Tensor,
                     i135: torch.Tensor) -> torch.Tensor:
    """Per-pixel, per-channel minimum over the four views, same shape."""
    return torch.minimum(torch.minimum(i0, i45), torch.minimum(i90, i135))


def calc_dop(i0_y: torch.Tensor, i45_y: torch.Tensor, i90_y: torch.Tensor,
             i135_y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """S0 = I0 + I90, S1 = I0 - I90, S2 = I45 - I135; DoP = sqrt(S1^2 + S2^2)
    / S0, 0 where S0 == 0; AoP = atan2(S2, S1) / 2."""
    s0 = i0_y + i90_y
    s1 = i0_y - i90_y
    s2 = i45_y - i135_y
    pol = torch.sqrt(s1.square() + s2.square())
    zero = s0 == 0
    dop = torch.where(zero, torch.zeros_like(s0), pol / torch.where(zero, torch.ones_like(s0), s0))
    return dop, 0.5 * torch.atan2(s2, s1)


def gram_matrix(x: torch.Tensor, sp=None) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, C) gram matrix normalised by H * W; with sp
    (parallel/spatial.py) x is a band of rows, and the bands' products are
    summed over the row."""
    b, h, w, c = x.shape
    if sp is not None:
        return sp.reduce(x, lambda t, start, stop: torch.einsum("bijc,bijd->bcd", t, t),
                         1) / float(sp.h * w)
    return torch.einsum("bijc,bijd->bcd", x, x) / float(h * w)
