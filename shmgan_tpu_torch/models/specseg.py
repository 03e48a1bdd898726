"""SpecSeg: the specular-highlight segmentation U-Net of
shmgan_tpu/models/specseg.py, NHWC at the interface, NCHW inside.

Eval mode (the default) uses the running BatchNorm statistics (eps 1e-3) and
no dropout. Train mode, `forward(x, train=True, keep=...)`, is flax's
`apply(..., train=True, mutable=["batch_stats"])`: it returns the output and
the new batch statistics. There
  - dropout follows conv0's relu in each of the 9 double convs, at the rates
    DROPOUT (down, bottom) and UP_DROPOUT (up); `keep` holds their 9 keep
    masks (NCHW booleans, `sample_keep`), and kept features are scaled by
    1 / (1 - rate). The draws are arguments, as D's are;
  - batch norm normalises by the batch's own statistics, taken in float32
    as flax's fast variance, max(E[x^2] - E[x]^2, 0) (the biased variance),
    and both running statistics move as 0.99 * running + 0.01 * batch.
    `F.batch_norm(training=True)` would update the running variance with the
    unbiased variance, so the statistics are computed here.

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

from typing import Dict, List, Optional, Sequence, Tuple, Union

from shmgan_tpu_torch.models.blocks import conv, conv_transpose, same_conv

DROPOUT = (0.1, 0.1, 0.2, 0.2, 0.3)  # down0..down3, bottom
UP_DROPOUT = (0.2, 0.2, 0.1, 0.1)    # up0..up3
BN_MOMENTUM = 0.99
_KERNEL_STDDEV = 0.05  # Keras RandomNormal default of the double convs
_TRUNC_STDDEV = 0.87962566103423978  # stddev of a unit normal cut at +-2


class _DoubleConv(nn.Module):
    def __init__(self, cin: int, features: int, batch_norm: bool, dropout: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.conv0 = same_conv(cin, features)
        self.conv1 = same_conv(features, features)
        self.bn = nn.BatchNorm2d(features, eps=1e-3) if batch_norm else None

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """keep given: train mode (dropout with it, batch statistics); it
        returns the new running statistics of its batch norm, if any."""
        train = keep is not None
        x = F.relu(conv(self.conv0, x, self.dtype))
        if train:
            x = torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))
        x = F.relu(conv(self.conv1, x, self.dtype))
        if self.bn is None:
            return x, None
        bn = self.bn
        if not train:
            return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                                bn.bias, training=False, eps=bn.eps).to(self.dtype), None
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp(xf.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)
        stats = {"mean": BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean.detach(),
                 "var": BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var.detach()}
        return y.to(self.dtype), stats


class SpecSeg(nn.Module):
    def __init__(self, base_filters: int = 16, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n, self.dtype = base_filters, dtype
        self.widths = [n, n * 2, n * 4, n * 8, n * 16]
        cin = in_channels
        for i, w in enumerate(self.widths[:-1]):
            self.add_module(f"down{i}", _DoubleConv(cin, w, True, DROPOUT[i], dtype))
            cin = w
        self.bottom = _DoubleConv(cin, self.widths[-1], True, DROPOUT[-1], dtype)
        cin = self.widths[-1]
        for j, w in enumerate(reversed(self.widths[:-1])):
            self.add_module(f"up{j}_t", nn.ConvTranspose2d(cin, w, 2, stride=2))
            self.add_module(f"up{j}", _DoubleConv(2 * w, w, False, UP_DROPOUT[j], dtype))
            cin = w
        self.head = nn.Conv2d(cin, 1, 1)
        self.levels = len(self.widths) - 1

    def block_names(self) -> List[str]:
        """The 9 double convs in the order of `keep`."""
        return ([f"down{i}" for i in range(self.levels)] + ["bottom"]
                + [f"up{j}" for j in range(self.levels)])

    def keep_shapes(self, batch: int, h: int, w: int) -> List[Tuple[int, int, int, int]]:
        """NCHW shapes of the 9 keep masks for a (batch, h, w, C) input."""
        down = [(batch, self.widths[i], h >> i, w >> i) for i in range(self.levels + 1)]
        return down + down[-2::-1]

    def sample_keep(self, generator: torch.Generator, batch: int, h: int, w: int
                    ) -> List[torch.Tensor]:
        """The 9 dropout keep masks of one train-mode call, on the
        generator's device: each feature kept with probability 1 - rate."""
        rates = list(DROPOUT) + list(UP_DROPOUT)
        return [torch.rand(shape, generator=generator, device=generator.device) < 1.0 - r
                for shape, r in zip(self.keep_shapes(batch, h, w), rates)]

    def forward(self, x: torch.Tensor, train: bool = False,
                keep: Optional[Sequence[torch.Tensor]] = None
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict]]:
        """(B, H, W, in_channels) -> (B, H, W, 1) probabilities; with train,
        (probabilities, new batch_stats) from the 9 keep masks, batch_stats
        laid out as flax's {"down0": {"bn": {"mean", "var"}}, ...}."""
        if train and (keep is None or len(keep) != 2 * self.levels + 1):
            raise ValueError(f"train mode takes {2 * self.levels + 1} keep masks")
        keeps = dict(zip(self.block_names(), keep)) if train else {}
        stats: Dict = {}

        def block(name, h):
            h, new = getattr(self, name)(h, keeps.get(name))
            if new is not None:
                stats[name] = {"bn": new}
            return h

        x, skips = self._encode(x.permute(0, 3, 1, 2).contiguous(), block)
        for j in range(self.levels):
            x = conv_transpose(getattr(self, f"up{j}_t"), x, self.dtype)
            x = torch.cat([x, skips[-(j + 1)]], dim=1)
            x = block(f"up{j}", x)
        y = torch.sigmoid(conv(self.head, x, self.dtype).float())
        y = y.permute(0, 2, 3, 1).contiguous()
        return (y, stats) if train else y

    def _encode(self, x: torch.Tensor, block) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The contracting path and the bottom block of NCHW x: (the bottom
        block's output, the skips)."""
        skips = []
        for i in range(self.levels):
            x = block(f"down{i}", x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        return block("bottom", x), skips

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The bottom block's output in eval mode, (B, 16 base, H/16, W/16)
        NCHW in the compute dtype, from (B, H, W, in_channels): the encoder
        features flax's `capture_intermediates` reads at "bottom"."""
        return self._encode(x.permute(0, 3, 1, 2).contiguous(),
                            lambda name, h: getattr(self, name)(h)[0])[0]

    @torch.no_grad()
    def load_batch_stats(self, stats: Dict) -> None:
        """Set the running statistics from a train-mode call's batch_stats."""
        for name, node in stats.items():
            bn = getattr(self, name).bn
            bn.running_mean.copy_(node["bn"]["mean"])
            bn.running_var.copy_(node["bn"]["var"])

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
