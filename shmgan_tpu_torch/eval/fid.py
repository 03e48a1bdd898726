"""Fréchet distance, inception score and the SpecSeg-encoder embedding: the
counterpart of shmgan_tpu/eval/fid.py.

  frechet_distance(feat_a, feat_b)   FID between two (N, D) feature sets, in
                                     float32 as the JAX function computes it
  specseg_features(specseg, rgb)     (B, 16 base) mean-pooled features of
                                     SpecSeg's bottom block
  fid_from_images(specseg, a, b)     FID of two image sets under that embedding
  inception_score(probs)             IS from (N, C) class-probability rows

The matrix square root takes a symmetric eigendecomposition
(`torch.linalg.eigh`; the product sqrt(Sa) Sb sqrt(Sa) is symmetric PSD),
with negative eigenvalues clamped to 0 and the distance clamped at 0: the
trace terms cancel when the two distributions are close, so a tiny FID is a
difference of large numbers. With fewer samples than features the
covariances are singular, and two eigensolvers may disagree in their null
space by rounding; compare FIDs against tr Sa + tr Sb, not their own value.
"""

from __future__ import annotations

import torch

from shmgan_tpu_torch.data.synthetic_device import standardized_luma
from shmgan_tpu_torch.infer import ieee_f32
from shmgan_tpu_torch.models.specseg import SpecSeg
from shmgan_tpu_torch.ops.specprior import specseg_net_input


def _sym_sqrtm(mat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Square root of a symmetric PSD matrix by its eigendecomposition."""
    w, v = torch.linalg.eigh(mat)
    w = torch.clamp(w, min=0.0)
    return (v * torch.sqrt(w + eps)) @ v.T


def _cov(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (D, D) covariance, rows the samples."""
    xc = x - x.mean(dim=0, keepdim=True)
    return (xc.T @ xc) / max(x.shape[0] - 1, 1)


def frechet_distance(feat_a: torch.Tensor, feat_b: torch.Tensor) -> torch.Tensor:
    """|mu_a - mu_b|^2 + tr(Sa + Sb - 2 sqrt(sqrt(Sa) Sb sqrt(Sa))), clamped
    at 0; a float32 scalar on the features' device."""
    with ieee_f32():
        a = feat_a.reshape(feat_a.shape[0], -1).float()
        b = feat_b.reshape(feat_b.shape[0], -1).float()
        sa, sb = _cov(a), _cov(b)
        diff2 = (a.mean(dim=0) - b.mean(dim=0)).square().sum()
        sqrt_sa = _sym_sqrtm(sa)
        middle = _sym_sqrtm(sqrt_sa @ sb @ sqrt_sa)
        return torch.clamp(diff2 + torch.trace(sa) + torch.trace(sb)
                           - 2.0 * torch.trace(middle), min=0.0)


def specseg_in_channels(specseg: SpecSeg) -> int:
    """Input channels of a SpecSeg, from its first conv's weights."""
    return int(specseg.down0.conv0.weight.shape[1])


@torch.no_grad()
def specseg_features(specseg: SpecSeg, rgb: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB in [0, 1] -> (B, 16 base) float32: SpecSeg's bottom
    block, mean-pooled over space, on the input every SpecSeg consumer
    gives it (the standardised luma, and the chroma prior for a 2-channel
    net, the count read from the weights)."""
    with ieee_f32():
        net_in = specseg_net_input(standardized_luma(rgb), rgb, specseg_in_channels(specseg))
        return specseg.features(net_in).float().mean(dim=(2, 3))


def fid_from_images(specseg: SpecSeg, images_a: torch.Tensor,
                    images_b: torch.Tensor) -> torch.Tensor:
    """FID between two image sets under the SpecSeg-encoder embedding."""
    return frechet_distance(specseg_features(specseg, images_a),
                            specseg_features(specseg, images_b))


def inception_score(probs: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """exp(E_x KL(p(y|x) || p(y))) of (N, C) probability rows."""
    probs = probs.float()
    p_y = probs.mean(dim=0, keepdim=True)
    kl = probs * (torch.log(probs + eps) - torch.log(p_y + eps))
    return torch.exp(kl.sum(dim=1).mean())
