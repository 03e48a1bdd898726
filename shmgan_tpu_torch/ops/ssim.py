"""SSIM, PSNR and MSE with tf.image.ssim's, tf.image.psnr's and keras
MeanSquaredError's semantics, and the cyclic SSIM loss transform (the
counterpart of shmgan_tpu/ops/ssim.py).
SSIM: an 11-tap Gaussian window with sigma 1.5 as two depthwise VALID
convolutions, k1 = 0.01, k2 = 0.03, and the per-image score the mean over
window positions and channels."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_taps(filter_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(filter_size, dtype=np.float64) - (filter_size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return np.asarray(g / g.sum(), dtype=np.float32)


def _separable_gaussian(x: torch.Tensor, filter_size: int, sigma: float) -> torch.Tensor:
    """Depthwise Gaussian blur, VALID, of (B, C, H, W)."""
    c = x.shape[1]
    taps = torch.from_numpy(_gaussian_taps(filter_size, sigma)).to(x)
    kh = taps.view(1, 1, filter_size, 1).expand(c, 1, filter_size, 1)
    kw = taps.view(1, 1, 1, filter_size).expand(c, 1, 1, filter_size)
    return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM, (B, H, W, C) -> (B,)."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    def blur(t):
        return _separable_gaussian(t, filter_size, filter_sigma)

    mu_a, mu_b = blur(a), blur(b)
    mu_aa, mu_bb, mu_ab = blur(a * a), blur(b * b), blur(a * b)
    var_a = mu_aa - mu_a * mu_a
    var_b = mu_bb - mu_b * mu_b
    cov = mu_ab - mu_a * mu_b
    luminance = (2.0 * mu_a * mu_b + c1) / (mu_a * mu_a + mu_b * mu_b + c1)
    cs = (2.0 * cov + c2) / (var_a + var_b + c2)
    return (luminance * cs).mean(dim=(1, 2, 3))


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float) -> torch.Tensor:
    """Per-image PSNR in dB, (B, ...) -> (B,)."""
    a, b = a.float(), b.float()
    mse_ = ((a - b) ** 2).mean(dim=tuple(range(1, a.dim())))
    return 10.0 / math.log(10.0) * torch.log((max_val ** 2) / mse_)


def ssim_log_loss(s: torch.Tensor) -> torch.Tensor:
    """-log((1 + ssim) / 2), the cyclic SSIM loss transform."""
    return -torch.log((1.0 + s) / 2.0)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The mean squared difference over every element: a scalar."""
    return ((a.float() - b.float()) ** 2).mean()
