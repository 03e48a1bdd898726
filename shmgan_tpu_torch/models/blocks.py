"""Generator blocks (the counterparts of shmgan_tpu/models/blocks.py), NCHW.

Submodule and parameter names follow the flax modules', so `convert.py` can
fill them from a flax parameter tree leaf by leaf. Layout facts the port
relies on (each held by a CPU test against flax):

  - flax `ConvTranspose` k3 s2 `SAME` is `conv_transpose2d` with the kernel
    flipped in space, laid out (in, out, kh, kw), `padding=0`, then cropped to
    [:2H, :2W];
  - `jax.image.resize(.., "nearest")` x2 is `interpolate(scale_factor=2,
    mode="nearest")`;
  - flax `max_pool` / `avg_pool` 2x2 with `SAME` padding on even sizes are the
    plain 2x2 pools.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from shmgan_tpu_torch.ops.kernels import instance_norm as in_kernel

INIT_STDDEV = 0.02  # DCGAN-style N(0, 0.02) of every G kernel and IN's beta


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


def max_pool(x: torch.Tensor, size: int) -> torch.Tensor:
    return F.max_pool2d(x, size)


def same_conv(cin: int, cout: int, kernel: int = 3) -> nn.Conv2d:
    """Stride-1 conv with flax's SAME padding (odd kernels, 3x3 by default)."""
    return nn.Conv2d(cin, cout, kernel, padding=kernel // 2)


class InstanceNorm(nn.Module):
    """Per-instance, per-channel normalisation over H, W through the CUDA
    kernel (ops/kernels/instance_norm.py). `scale` is gamma, `bias` beta."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_kernel.instance_norm(x, self.scale, self.bias, self.eps)


class ConvIN(nn.Module):
    """Conv (stride 1, SAME) + leaky_relu + InstanceNorm."""

    def __init__(self, cin: int, features: int, kernel: int = 3, slope: float = 0.2,
                 eps: float = 1e-6):
        super().__init__()
        self.slope = slope
        self.conv = same_conv(cin, features, kernel)
        self.inorm = InstanceNorm(features, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inorm(leaky_relu(self.conv(x), self.slope))


class MaskAttention(nn.Module):
    """Two conv3x3 + leaky_relu over the (optionally 2x2 max-pooled) mask.
    Returns (attention features, pooled mask)."""

    def __init__(self, cin: int, features: int, pool: bool = True, pool_size: int = 2,
                 slope: float = 0.2):
        super().__init__()
        self.pool, self.pool_size, self.slope = pool, pool_size, slope
        self.conv0 = same_conv(cin, features)
        self.conv1 = same_conv(features, features)

    def forward(self, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        pooled = max_pool(mask, self.pool_size) if self.pool else mask
        a = leaky_relu(self.conv0(pooled), self.slope)
        a = leaky_relu(self.conv1(a), self.slope)
        return a, pooled


class ConvTransposeUp(nn.Module):
    """Transposed conv k3 s2 (flax SAME: exactly 2x) + leaky_relu."""

    def __init__(self, cin: int, features: int, slope: float = 0.2):
        super().__init__()
        self.slope = slope
        self.convt = nn.ConvTranspose2d(cin, features, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        return leaky_relu(self.convt(x)[..., :2 * h, :2 * w], self.slope)


class ResizeConvUp(nn.Module):
    """Nearest 2x resize + conv3x3 + leaky_relu. The conv is named `convt`, as
    in flax, so both upsample modes share one parameter tree."""

    def __init__(self, cin: int, features: int, slope: float = 0.2):
        super().__init__()
        self.slope = slope
        self.convt = same_conv(cin, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return leaky_relu(self.convt(x), self.slope)
