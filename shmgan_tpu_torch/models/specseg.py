"""SpecSeg: the specular-highlight segmentation U-Net of
shmgan_tpu/models/specseg.py, in eval mode only (running BatchNorm statistics
with eps 1e-3, no dropout). NHWC at the interface, NCHW inside.

Five levels (base, 2x, 4x, 8x, 16x filters), each two conv3x3 + relu (+ BN on
the contracting path); 2x2 max pool down; transposed conv k2 s2 up (the
flipped flax kernel with padding 0) with skip concats; 1x1 sigmoid head.

Computes in `dtype` (float32 or bfloat16, the JAX module's `dtype`); the
batch norm computes in float32 against its float32 statistics and casts back,
as flax's does, and the head's sigmoid takes a float32 cast: the output is
float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from shmgan_tpu_torch.models.blocks import conv, conv_transpose, same_conv

_KERNEL_STDDEV = 0.05  # Keras RandomNormal default of the double convs
_TRUNC_STDDEV = 0.87962566103423978  # stddev of a unit normal cut at +-2


class _DoubleConv(nn.Module):
    def __init__(self, cin: int, features: int, batch_norm: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = same_conv(cin, features)
        self.conv1 = same_conv(features, features)
        self.bn = nn.BatchNorm2d(features, eps=1e-3) if batch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(conv(self.conv0, x, self.dtype))
        x = F.relu(conv(self.conv1, x, self.dtype))
        if self.bn is not None:
            x = F.batch_norm(x.float(), self.bn.running_mean, self.bn.running_var,
                             self.bn.weight, self.bn.bias, training=False,
                             eps=self.bn.eps).to(self.dtype)
        return x


class SpecSeg(nn.Module):
    def __init__(self, base_filters: int = 16, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n, self.dtype = base_filters, dtype
        widths = [n, n * 2, n * 4, n * 8, n * 16]
        cin = in_channels
        for i, w in enumerate(widths[:-1]):
            self.add_module(f"down{i}", _DoubleConv(cin, w, batch_norm=True, dtype=dtype))
            cin = w
        self.bottom = _DoubleConv(cin, widths[-1], batch_norm=True, dtype=dtype)
        cin = widths[-1]
        for j, w in enumerate(reversed(widths[:-1])):
            self.add_module(f"up{j}_t", nn.ConvTranspose2d(cin, w, 2, stride=2))
            self.add_module(f"up{j}", _DoubleConv(2 * w, w, batch_norm=False, dtype=dtype))
            cin = w
        self.head = nn.Conv2d(cin, 1, 1)
        self.levels = len(widths) - 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, in_channels) -> (B, H, W, 1) probabilities."""
        x = x.permute(0, 3, 1, 2).contiguous()
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"down{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = self.bottom(x)
        for j in range(self.levels):
            x = conv_transpose(getattr(self, f"up{j}_t"), x, self.dtype)
            x = torch.cat([x, skips[-(j + 1)]], dim=1)
            x = getattr(self, f"up{j}")(x)
        y = torch.sigmoid(conv(self.head, x, self.dtype).float())
        return y.permute(0, 2, 3, 1).contiguous()

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "SpecSeg":
        """Random weights at the JAX init's scales: double-conv kernels
        N(0, 0.05); transposed-conv and head kernels LeCun normal (truncated
        at 2 sigma, variance 1/fan_in); biases 0; BN identity statistics."""
        for name, m in self.named_modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                if isinstance(m, nn.ConvTranspose2d) or name == "head":
                    fan_in = m.kernel_size[0] * m.kernel_size[1] * (
                        m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d)
                        else m.weight.shape[1])
                    std = math.sqrt(1.0 / fan_in) / _TRUNC_STDDEV
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                else:
                    nn.init.normal_(m.weight, 0.0, _KERNEL_STDDEV, generator=generator)
                nn.init.zeros_(m.bias)
        return self
