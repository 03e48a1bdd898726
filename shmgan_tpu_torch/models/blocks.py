"""Generator and discriminator blocks (the counterparts of
shmgan_tpu/models/blocks.py), NCHW.

Submodule and parameter names follow the flax modules', so `convert.py` can
fill them from a flax parameter tree leaf by leaf. Layout facts the port
relies on (each held by a CPU test against flax):

  - flax `ConvTranspose` k3 s2 `SAME` is `conv_transpose2d` with the kernel
    flipped in space, laid out (in, out, kh, kw), `padding=0`, then cropped to
    [:2H, :2W];
  - `jax.image.resize(.., "nearest")` x2 is `interpolate(scale_factor=2,
    mode="nearest")`;
  - flax `max_pool` / `avg_pool` 2x2 with `SAME` padding on even sizes are the
    plain 2x2 pools;
  - flax `Conv` 3x3 stride 2 `SAME` on even sizes pads (0, 1) on each axis:
    `F.pad(x, (0, 1, 0, 1))`, then `conv2d(stride=2, padding=0)`.

Compute dtype: each block has a `dtype`, as the flax modules' `dtype` field
(float32 or bfloat16). Parameters stay float32; `conv`, `conv_transpose` and
`linear` cast the input, weight and bias to the block's dtype when called, as
flax's `promote_dtype` does, so gradients reach the float32 parameters
through the cast. InstanceNorm returns its input's dtype.

Tensor parallelism (parallel/tp.py): a block with `TP_DIMS` can be cut to
one model rank's slice of its output channels (`tp.shard_model_`, which sets
`tp`); it then runs its conv, leaky_relu and InstanceNorm on the slice,
between `tp.enter` and `tp.leave`, and returns its channels whole.
`TP_DIMS` names the torch dim of each parameter's output channels.

Spatial sharding (parallel/spatial.py): every block's forward takes `sp`,
the Band of its input map (None: the whole map). On a band a convolution
takes the halo rows its window needs (a 3x3 SAME conv one above and one
below, D's stride-2 conv one below, the transposed conv one above), a pool
and a 1x1 conv run on the band, and InstanceNorm takes its moments over
the row; a block whose map the band cannot hold (`sp.fits`) runs whole on
every rank of the row (`sp.whole`) and keeps its band of the result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from shmgan_tpu_torch.ops.kernels import instance_norm as in_kernel
from shmgan_tpu_torch.parallel.tp import enter, leave

INIT_STDDEV = 0.02  # DCGAN-style N(0, 0.02) of every G kernel and IN's beta


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


def _pool(x: torch.Tensor, fn, size: int, sp) -> torch.Tensor:
    if sp is None:
        return fn(x)
    if sp.fits(step=size):
        return sp.local(x, fn)
    return sp.whole(x, fn, sp.h // size)


def avg_pool_2x2(x: torch.Tensor, sp=None) -> torch.Tensor:
    return _pool(x, lambda t: F.avg_pool2d(t, 2), 2, sp)


def max_pool(x: torch.Tensor, size: int, sp=None) -> torch.Tensor:
    return _pool(x, lambda t: F.max_pool2d(t, size), size, sp)


def same_conv(cin: int, cout: int, kernel: int = 3) -> nn.Conv2d:
    """Stride-1 conv with flax's SAME padding (odd kernels, 3x3 by default)."""
    return nn.Conv2d(cin, cout, kernel, padding=kernel // 2)


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def conv(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """m(x) computed in `dtype`: input, weight and bias cast to it."""
    return m._conv_forward(x.to(dtype), m.weight.to(dtype), _cast(m.bias, dtype))


def conv_rows(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """m(x) computed in `dtype`, padded on W only: x carries the rows above
    and below its band that the window takes (spatial.Band.rows)."""
    return F.conv2d(x.to(dtype), m.weight.to(dtype), _cast(m.bias, dtype), m.stride,
                    (0, m.padding[1]))


def conv_lrelu(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, slope: float,
               sp) -> torch.Tensor:
    """leaky_relu(m(x)) of a stride-1 SAME conv, on sp's band of x (sp None:
    the whole map)."""
    p = m.padding[0]
    if sp is None:
        return leaky_relu(conv(m, x, dtype), slope)
    if not sp.fits(halo=p):
        return sp.whole(x, lambda t: leaky_relu(conv(m, t, dtype), slope), sp.h)
    return sp.rows(x, lambda e: leaky_relu(conv_rows(m, e, dtype), slope), p, p)


def conv_transpose(m: nn.ConvTranspose2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """m(x) computed in `dtype`: input, weight and bias cast to it."""
    return F.conv_transpose2d(x.to(dtype), m.weight.to(dtype), _cast(m.bias, dtype), m.stride,
                              m.padding, m.output_padding, m.groups, m.dilation)


def linear(m: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """m(x) computed in `dtype`: input, weight and bias cast to it."""
    return F.linear(x.to(dtype), m.weight.to(dtype), _cast(m.bias, dtype))


class InstanceNorm(nn.Module):
    """Per-instance, per-channel normalisation over H, W through the CUDA
    kernel (ops/kernels/instance_norm.py), computed in f32 and returned in
    the input's dtype. `scale` is gamma, `bias` beta."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        if sp is None:
            return in_kernel.instance_norm(x, self.scale, self.bias, self.eps)
        return sp.instance_norm(x, self.scale, self.bias, self.eps)


class ConvIN(nn.Module):
    """Conv (stride 1, SAME) + leaky_relu + InstanceNorm."""

    TP_DIMS = {"conv.weight": 0, "conv.bias": 0, "inorm.scale": 0, "inorm.bias": 0}

    def __init__(self, cin: int, features: int, kernel: int = 3, slope: float = 0.2,
                 eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.slope, self.dtype, self.tp = slope, dtype, None
        self.conv = same_conv(cin, features, kernel)
        self.inorm = InstanceNorm(features, eps)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        if sp is None:
            x = conv(self.conv, enter(self.tp, x), self.dtype)
            return leave(self.tp, self.inorm(leaky_relu(x, self.slope)))
        if not sp.fits(halo=self.conv.padding[0]):
            return sp.whole(x, self.forward, sp.h)
        return self.inorm(conv_lrelu(self.conv, x, self.dtype, self.slope, sp), sp)


class ConvLReLUIN(nn.Module):
    """Conv 3x3 stride 2 (flax SAME), no bias, + leaky_relu + InstanceNorm:
    the discriminator's strided block."""

    TP_DIMS = {"conv.weight": 0, "inorm.scale": 0, "inorm.bias": 0}

    def __init__(self, cin: int, features: int, slope: float = 0.2, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.slope, self.dtype, self.tp = slope, dtype, None
        self.conv = nn.Conv2d(cin, features, 3, stride=2, padding=0, bias=False)
        self.inorm = InstanceNorm(features, eps)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        if sp is None:
            x = conv(self.conv, F.pad(enter(self.tp, x), (0, 1, 0, 1)), self.dtype)
            return leave(self.tp, self.inorm(leaky_relu(x, self.slope)))
        if not sp.fits(halo=1, step=2):
            return sp.whole(x, self.forward, sp.h // 2)
        # the band and the row below it (SAME at stride 2 pads below only)
        y = sp.rows(x, lambda e: leaky_relu(
            conv(self.conv, F.pad(e, (0, 1)), self.dtype), self.slope), 0, 1)
        return self.inorm(y, sp.at(sp.h // 2))


class MaskAttention(nn.Module):
    """Two conv3x3 + leaky_relu over the (optionally 2x2 max-pooled) mask.
    Returns (attention features, pooled mask). Cut over the model axis, each
    conv runs on its slice and its output is gathered whole."""

    TP_DIMS = {"conv0.weight": 0, "conv0.bias": 0, "conv1.weight": 0, "conv1.bias": 0}

    def __init__(self, cin: int, features: int, pool: bool = True, pool_size: int = 2,
                 slope: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool, self.pool_size, self.slope, self.dtype = pool, pool_size, slope, dtype
        self.tp = None
        self.conv0 = same_conv(cin, features)
        self.conv1 = same_conv(features, features)

    def forward(self, mask: torch.Tensor, sp=None) -> Tuple[torch.Tensor, torch.Tensor]:
        pooled = max_pool(mask, self.pool_size, sp) if self.pool else mask
        a = pooled
        if sp is not None:
            psp = sp.at(sp.h // self.pool_size) if self.pool else sp
            for m in (self.conv0, self.conv1):
                a = conv_lrelu(m, a, self.dtype, self.slope, psp)
            return a, pooled
        for m in (self.conv0, self.conv1):
            a = leave(self.tp, leaky_relu(conv(m, enter(self.tp, a), self.dtype), self.slope))
        return a, pooled


class ConvTransposeUp(nn.Module):
    """Transposed conv k3 s2 (flax SAME: exactly 2x) + leaky_relu. Its weight
    is (in, out, kh, kw): the output channels are dim 1."""

    TP_DIMS = {"convt.weight": 1, "convt.bias": 0}

    def __init__(self, cin: int, features: int, slope: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.slope, self.dtype, self.tp = slope, dtype, None
        self.convt = nn.ConvTranspose2d(cin, features, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        h, w = x.shape[-2:]
        if sp is None:
            y = conv_transpose(self.convt, enter(self.tp, x), self.dtype)
            return leave(self.tp, leaky_relu(y[..., :2 * h, :2 * w], self.slope))
        if not sp.fits(halo=1):
            return sp.whole(x, self.forward, 2 * sp.h)

        def band(e):  # the row above and the band: output rows 2 .. 2 * band + 1
            y = conv_transpose(self.convt, e, self.dtype)
            return leaky_relu(y[..., 2:2 * e.shape[2], :2 * w], self.slope)

        return sp.rows(x, band, 1, 0)


class ResizeConvUp(nn.Module):
    """Nearest 2x resize + conv3x3 + leaky_relu. The conv is named `convt`, as
    in flax, so both upsample modes share one parameter tree."""

    TP_DIMS = {"convt.weight": 0, "convt.bias": 0}

    def __init__(self, cin: int, features: int, slope: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.slope, self.dtype, self.tp = slope, dtype, None
        self.convt = same_conv(cin, features)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        if sp is None:
            x = F.interpolate(enter(self.tp, x), scale_factor=2, mode="nearest")
            return leave(self.tp, leaky_relu(conv(self.convt, x, self.dtype), self.slope))
        if not sp.fits(halo=1):
            return sp.whole(x, self.forward, 2 * sp.h)
        x = sp.local(x, lambda t: F.interpolate(t, scale_factor=2, mode="nearest"))
        return conv_lrelu(self.convt, x, self.dtype, self.slope, sp.at(2 * sp.h))
