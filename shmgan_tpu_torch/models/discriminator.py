"""SHM discriminator: the PatchGAN with class head and mask attention of
shmgan_tpu/models/discriminator.py. NHWC at the interface, NCHW inside.

  input (B, H, W, 3) RGB and mask (B, H, W, 1);
  [+ noise_stddev * noise] -> 4x ConvLReLUIN (stride 2, widths N..8N)
  -> + MaskAttention(8N) of the mask max-pooled 16x16
  -> ConvLReLUIN(16N) -> [dropout] -> two heads:
  patch map: conv 3x3 SAME, no bias, leaky_relu -> (B, H/32, W/32, 1);
  class logits: Dense(c_dim), no bias, on the features flattened in NHWC
  order (as flax flattens) -> (B, c_dim).

The live pass's random draws are injected, not drawn here: `noise` (B, 3, H,
W) standard normal, and `keep` (B, 16N, H/32, W/32), 1 where dropout keeps a
feature (kept features are scaled by 1 / (1 - rate), as flax's nn.Dropout).
Leaving either out skips that step, as the JAX module's train=False does.

Computes in `dtype` (float32 or bfloat16, the JAX module's `dtype`): the
image and the mask are cast to it, the noise is added in it (a float32 draw
is rounded to it first, as JAX draws the noise in x's dtype), dropout runs in
it, and both outputs come back in float32.

Tensor parallelism (parallel/tp.py): the strided blocks and the attention
can be cut over the model axis as blocks.py says, and the class head's
Dense kernel by its input rows (`TP_DIMS`: the Linear weight's dim 1, in
the NHWC flatten order, so a rank's rows are a run of spatial positions
with all their channels): each rank multiplies its block of the flattened
features, and the partial logits are summed over the model row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from shmgan_tpu_torch.models.blocks import (
    INIT_STDDEV, ConvLReLUIN, InstanceNorm, MaskAttention, conv, leaky_relu, linear,
)
from shmgan_tpu_torch.parallel.tp import reduce_sum, split_last


class SHMDiscriminator(nn.Module):
    TP_DIMS = {"out_class.weight": 1}

    def __init__(self, filter_size: int = 64, c_dim: int = 5, image_size: int = 128,
                 instance_norm_eps: float = 1e-6, slope: float = 0.2,
                 noise_stddev: float = 0.1, dropout_rate: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n, eps = filter_size, instance_norm_eps
        self.slope, self.noise_stddev, self.dropout_rate = slope, noise_stddev, dropout_rate
        self.dtype, self.tp = dtype, None
        cin = 3
        for i, w in enumerate((n, n * 2, n * 4, n * 8)):
            self.add_module(f"block{i}", ConvLReLUIN(cin, w, slope=slope, eps=eps, dtype=dtype))
            cin = w
        self.attn = MaskAttention(1, n * 8, pool=True, pool_size=16, slope=slope, dtype=dtype)
        self.block4 = ConvLReLUIN(n * 8, n * 16, slope=slope, eps=eps, dtype=dtype)
        self.out_realfake = nn.Conv2d(n * 16, 1, 3, padding=1, bias=False)
        side = image_size // 32
        self.out_class = nn.Linear(n * 16 * side * side, c_dim, bias=False)

    def forward(self, img: torch.Tensor, mask: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = img.permute(0, 3, 1, 2).contiguous().to(self.dtype)
        if noise is not None:
            x = x + self.noise_stddev * noise.to(self.dtype)
        for i in range(4):
            x = getattr(self, f"block{i}")(x)
        attn, _ = self.attn(mask.permute(0, 3, 1, 2).contiguous().to(self.dtype))
        x = self.block4(x + attn)
        if keep is not None:
            x = torch.where(keep.bool(), x / (1.0 - self.dropout_rate), torch.zeros_like(x))
        real_fake = leaky_relu(conv(self.out_realfake, x, self.dtype), self.slope)
        flat = split_last(self.tp, x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        logits = reduce_sum(self.tp, linear(self.out_class, flat, self.dtype))
        return real_fake.permute(0, 2, 3, 1).contiguous().float(), logits.float()

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "SHMDiscriminator":
        """Random weights at the JAX init's scales: every kernel and IN's beta
        N(0, 0.02), attention conv biases 0, IN's gamma 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.normal_(m.weight, 0.0, INIT_STDDEV, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, InstanceNorm):
                nn.init.ones_(m.scale)
                nn.init.normal_(m.bias, 0.0, INIT_STDDEV, generator=generator)
        return self
