"""Colour conversions on the last axis of (..., 3) tensors (the counterpart
of shmgan_tpu/ops/color.py):

  rgb_to_yuv / yuv_to_rgb   TF's constants (tf.image.rgb_to_yuv / yuv_to_rgb)
  rgb_to_lab / lab_to_rgb   sRGB <-> CIE Lab (D65), skimage's rgb2lab
  delta_e_76 / delta_e_94   CIE76 and CIE94 colour differences per pixel
  gray_world_white_balance  a/b chroma pulled toward neutral in Lab

Written as explicit multiply-adds, not a (..., 3) x (3, 3) product, as in
the JAX package: the same arithmetic in the same order in f32. The cube
root of Lab is `x ** (1/3)` (torch has no cbrt): within an ulp of it.
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


# D65 reference white
_XYZ_REF_WHITE = (0.95047, 1.0, 1.08883)
_LAB_EPS = 0.008856   # (6/29)^3
_LAB_KAPPA = 7.787    # (1/3)(29/6)^2, as skimage uses it


def _white(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_XYZ_REF_WHITE, dtype=torch.float32, device=x.device)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB in [0, 1] -> CIE Lab, L in [0, 100]."""
    rgb = rgb.float()
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    lr, lg, lb = linear[..., 0], linear[..., 1], linear[..., 2]
    x = 0.412453 * lr + 0.357580 * lg + 0.180423 * lb
    y = 0.212671 * lr + 0.715160 * lg + 0.072169 * lb
    z = 0.019334 * lr + 0.119193 * lg + 0.950227 * lb
    xyz = torch.stack([x, y, z], dim=-1) / _white(rgb)
    f = torch.where(xyz > _LAB_EPS, xyz.clamp_min(0.0) ** (1.0 / 3.0),
                    _LAB_KAPPA * xyz + 16.0 / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """CIE Lab (D65) -> sRGB in [0, 1] (the inverse of rgb_to_lab)."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def f_inv(t):
        t3 = t ** 3
        return torch.where(t3 > _LAB_EPS, t3, (t - 16.0 / 116.0) / _LAB_KAPPA)

    xyz = torch.stack([f_inv(fx), f_inv(fy), f_inv(fz)], dim=-1) * _white(lab)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = 3.240481 * x + -1.537152 * y + -0.498536 * z
    g = -0.969255 * x + 1.875990 * y + 0.041556 * z
    bl = 0.055647 * x + -0.204041 * y + 1.057311 * z
    linear = torch.clamp(torch.stack([r, g, bl], dim=-1), 0.0, 1.0)
    srgb = torch.where(linear > 0.0031308, 1.055 * linear ** (1.0 / 2.4) - 0.055,
                       12.92 * linear)
    return torch.clamp(srgb, 0.0, 1.0)


def delta_e_76(lab1: torch.Tensor, lab2: torch.Tensor) -> torch.Tensor:
    """CIE76 colour difference per pixel (skimage.color.deltaE_cie76)."""
    return torch.sqrt(((lab1 - lab2) ** 2).sum(dim=-1))


def delta_e_94(lab1: torch.Tensor, lab2: torch.Tensor, kH: float = 1.0, kC: float = 1.0,
               kL: float = 1.0, k1: float = 0.045, k2: float = 0.015) -> torch.Tensor:
    """CIE94 colour difference per pixel (skimage.color.deltaE_ciede94's
    defaults)."""
    L1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    L2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]
    dL = L1 - L2
    C1 = torch.hypot(a1, b1)
    C2 = torch.hypot(a2, b2)
    dC = C1 - C2
    dE2 = ((lab1 - lab2) ** 2).sum(dim=-1)
    dH2 = torch.clamp(dE2 - dL * dL - dC * dC, min=0.0)
    SC = 1.0 + k1 * C1
    SH = 1.0 + k2 * C1
    return torch.sqrt((dL / kL) ** 2 + (dC / (kC * SC)) ** 2 + dH2 / (kH * SH) ** 2)


def gray_world_white_balance(rgb: torch.Tensor, strength: float = 1.1) -> torch.Tensor:
    """Gray-world white balance in Lab: the a/b channels shifted toward
    neutral by the image's mean cast, weighted by luminance. rgb in [0, 1],
    (B, H, W, 3) or (H, W, 3)."""
    lab = rgb_to_lab(torch.clamp(rgb, 0.0, 1.0))
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    dims = (lab.dim() - 3, lab.dim() - 2)   # the spatial axes of L, a, b
    lw = (L / 100.0) * strength
    a = a - a.mean(dim=dims, keepdim=True) * lw
    b = b - b.mean(dim=dims, keepdim=True) * lw
    return lab_to_rgb(torch.stack([L, a, b], dim=-1))
