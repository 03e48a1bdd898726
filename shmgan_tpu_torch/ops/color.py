"""RGB <-> YUV with TF's constants (tf.image.rgb_to_yuv / yuv_to_rgb), on the
last axis of (..., 3) tensors.

Written as explicit multiply-adds, not a (..., 3) x (3, 3) product, as in
shmgan_tpu/ops/color.py: the same arithmetic in the same order in f32.
"""

from __future__ import annotations

import torch


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (any range) -> YUV. Last axis must be 3."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.14714119 * r + -0.28886916 * g + 0.43601035 * b
    v = 0.61497538 * r + -0.51496512 * g + -0.10001026 * b
    return torch.stack([y, u, v], dim=-1)


def yuv_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """YUV -> RGB. Last axis must be 3."""
    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    r = y + 1.13988303 * v
    g = y + -0.394642334 * u + -0.58062185 * v
    b = y + 2.03206185 * u
    return torch.stack([r, g, b], dim=-1)
