"""SHM generator: the mask-attentive U-Net of shmgan_tpu/models/generator.py.

Input (B, H, W, 2*c_dim) = c_dim Y planes + c_dim one-hot label planes, and
the specular mask (B, H, W, 1); output (B, H, W, 1), the generated Y. NHWC at
the interface, NCHW inside. Topology (N = filter_size):
  4 down levels: 2x ConvIN, mask attention on the skip, 2x2 average pool;
  bottleneck:    2x ConvIN 1x1 at 8N;
  4 up levels:   upsample, concat skip, 2x ConvIN;
  head:          conv 1x1 -> 1 channel, leaky_relu.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from shmgan_tpu_torch.models.blocks import (
    INIT_STDDEV, ConvIN, ConvTransposeUp, InstanceNorm, MaskAttention, ResizeConvUp,
    avg_pool_2x2, leaky_relu,
)


class SHMGenerator(nn.Module):
    def __init__(self, filter_size: int = 64, c_dim: int = 5, levels: int = 4,
                 instance_norm_eps: float = 1e-6, slope: float = 0.2,
                 upsample_mode: str = "conv_transpose"):
        super().__init__()
        if upsample_mode not in ("conv_transpose", "resize_conv"):
            raise ValueError(f"unknown upsample_mode {upsample_mode!r}")
        self.levels, self.slope = levels, slope
        n, eps = filter_size, instance_norm_eps
        cin = 2 * c_dim
        for lvl in range(levels):
            feats = n * 2 ** lvl
            self.add_module(f"down{lvl}_0", ConvIN(cin, feats, slope=slope, eps=eps))
            self.add_module(f"down{lvl}_1", ConvIN(feats, feats, slope=slope, eps=eps))
            self.add_module(f"attn{lvl}", MaskAttention(1, feats, pool=lvl > 0,
                                                        slope=slope))
            cin = feats
        for i in range(2):
            self.add_module(f"bottleneck_{i}", ConvIN(cin, cin, kernel=1, slope=slope,
                                                      eps=eps))
        up = ResizeConvUp if upsample_mode == "resize_conv" else ConvTransposeUp
        for ulvl in range(levels):
            feats = n * 2 ** (levels - 1 - ulvl)
            self.add_module(f"up{ulvl}_t", up(cin, feats, slope=slope))
            self.add_module(f"up{ulvl}_0", ConvIN(2 * feats, feats, slope=slope, eps=eps))
            self.add_module(f"up{ulvl}_1", ConvIN(feats, feats, slope=slope, eps=eps))
            cin = feats
        self.head = nn.Conv2d(cin, 1, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous()
        pooled = mask.permute(0, 3, 1, 2).contiguous()
        skips = []
        for lvl in range(self.levels):
            x = getattr(self, f"down{lvl}_1")(getattr(self, f"down{lvl}_0")(x))
            attn, pooled = getattr(self, f"attn{lvl}")(pooled)
            skips.append(x + attn)
            x = avg_pool_2x2(x)
        x = self.bottleneck_1(self.bottleneck_0(x))
        for ulvl in range(self.levels):
            x = getattr(self, f"up{ulvl}_t")(x)
            x = torch.cat([x, skips[self.levels - 1 - ulvl]], dim=1)
            x = getattr(self, f"up{ulvl}_1")(getattr(self, f"up{ulvl}_0")(x))
        y = leaky_relu(self.head(x), self.slope)
        return y.permute(0, 2, 3, 1).contiguous()

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "SHMGenerator":
        """Random weights at the JAX init's scales: every kernel and IN's beta
        N(0, 0.02), conv biases 0, IN's gamma 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.normal_(m.weight, 0.0, INIT_STDDEV, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, InstanceNorm):
                nn.init.ones_(m.scale)
                nn.init.normal_(m.bias, 0.0, INIT_STDDEV, generator=generator)
        return self
