"""Polarimetric helpers (the counterpart of shmgan_tpu/ops/polar.py). Only
what the train step's NST loss needs is ported so far."""

from __future__ import annotations

import torch


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, C) gram matrix normalised by H * W."""
    b, h, w, c = x.shape
    return torch.einsum("bijc,bijd->bcd", x, x) / float(h * w)
