"""The SHMGAN loss zoo (the counterpart of shmgan_tpu/train/losses.py), term
by term with the reference's weights and exclusions:

  G adversarial (LSGAN): 5 cyclic + 1 generated, / 6
  classification CE with unnormalised (smoothed) labels
  D adversarial (LSGAN), with D2's term counted again inside D4's sum
  cyclic L1 (RGB), the ED term x10
  cyclic SSIM log-loss (YUV), gated by the input drops, the ED term x10
    inside the / 5
  masked specular MSE: computed, excluded from the totals
  NST content + style

All reductions are means over whole tensors, batch included. The SpecSeg
trainer's objective (train/specseg_train.py) is dice + focal on its
probabilities: `dice_loss`, `binary_focal_loss`, `specseg_loss`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from shmgan_tpu_torch.ops.polar import gram_matrix
from shmgan_tpu_torch.ops.ssim import ssim as ssim_fn
from shmgan_tpu_torch.ops.ssim import ssim_log_loss
from shmgan_tpu_torch.ops.standardize import rescale_01_per_image


def lsgan_to_target(pred: torch.Tensor, target) -> torch.Tensor:
    """mean((pred - target)^2)."""
    return (pred - target).square().mean()


def lsgan_to_zero(pred: torch.Tensor) -> torch.Tensor:
    return pred.square().mean()


def softmax_ce(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """-sum(labels * log_softmax(logits)) meaned over the batch; the labels
    may be unnormalised."""
    return (-(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)).mean()


def masked_mse(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (a * mask - b * mask).square().mean()


def nst_loss(cyc_ed_yuv: torch.Tensor, i0_yuv: torch.Tensor, ed_yuv: torch.Tensor,
             image_size: int, style_weight: float = 100.0,
             content_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """content = mean((cyc_ED - I0)^2); style = mean((gram(cyc_ED) -
    gram(ED))^2) / (2 * 9 * H * W)^2, with H = W = image_size."""
    content = (cyc_ed_yuv - i0_yuv).square().mean()
    factor = 1.0 / (2.0 * 9.0 * image_size * image_size) ** 2
    style = factor * (gram_matrix(cyc_ed_yuv) - gram_matrix(ed_yuv)).square().mean()
    return {"content": content, "style": style,
            "nst": style_weight * style + content_weight * content}


class GanLossInputs(NamedTuple):
    """Everything the loss block consumes; B = batch, V = c_dim views, NHWC.
    drop is (1, V) or (B, V), 1 where an input view was dropped."""
    rf_gen: torch.Tensor       # D1 patch output on the generated image
    lbl_gen: torch.Tensor      # D1 class logits
    rf_target: torch.Tensor    # D2 patch output on the ED original
    rf_cyc: torch.Tensor       # (V, B, h, w, 1) D3 patch outputs on the cyclics
    lbl_cyc: torch.Tensor      # (V, B, c_dim)
    rf_orig: torch.Tensor      # (V, B, h, w, 1) D4 patch outputs on the originals
    lbl_orig: torch.Tensor     # (V, B, c_dim)
    gen_rgb: torch.Tensor      # (B, H, W, 3)
    cyc_rgb: torch.Tensor      # (V, B, H, W, 3)
    cyc_yuv: torch.Tensor      # (V, B, H, W, 3)
    orig_rgb: torch.Tensor     # (V, B, H, W, 3) the originals L1 and D compare with
    ds_yuv: torch.Tensor       # (V, B, H, W, 3) standardised YUV of the originals
    mask: torch.Tensor         # (B, H, W, 1)
    drop: torch.Tensor
    target_label: torch.Tensor  # scalar t ~ U[0.8, 1.2]


def shmgan_losses(inp: GanLossInputs, image_size: int, style_weight: float = 100.0,
                  content_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """Every loss component and the three totals."""
    v = inp.rf_cyc.shape[0]
    t = inp.target_label
    c_dim = inp.lbl_cyc.shape[-1]

    d3_rf_cyc = sum(lsgan_to_target(inp.rf_cyc[i], t) for i in range(v))
    d1_rf = lsgan_to_target(inp.rf_gen, t)
    g_gan = (d3_rf_cyc + d1_rf) / 6.0

    eye = torch.eye(c_dim, dtype=torch.float32, device=inp.lbl_cyc.device)
    d3_cls = sum(softmax_ce(eye[i][None, :], inp.lbl_cyc[i]) for i in range(v))
    target_vec = (eye[c_dim - 1] * t)[None, :]
    d1_cls = softmax_ce(target_vec, inp.lbl_gen)
    g_clsf = (d3_cls + d1_cls) / 6.0
    d4_cls = sum(softmax_ce(eye[i][None, :], inp.lbl_orig[i]) for i in range(v))

    # D2's term is also summed into D4's, and both reach the total: the
    # reference's double count, kept
    d2_rf_target = lsgan_to_target(inp.rf_target, t) + lsgan_to_zero(inp.rf_gen)
    d4_terms = sum(lsgan_to_target(inp.rf_orig[i], t) + lsgan_to_zero(inp.rf_cyc[i])
                   for i in range(v))
    d4_rf_cyc = d4_terms + d2_rf_target

    l1_g1 = (inp.gen_rgb - inp.orig_rgb[v - 1]).abs().mean()
    l1_cyc = [(inp.cyc_rgb[i] - inp.orig_rgb[i]).abs().mean() for i in range(v)]
    l1_total = (sum(l1_cyc[: v - 1]) + l1_g1) / 5.0 + 10.0 * l1_cyc[v - 1]

    drop = inp.drop if inp.drop.dim() == 2 else inp.drop[None, :]
    ssim_losses, ssim_raw = [], []
    for i in range(v):
        s = ssim_fn(rescale_01_per_image(inp.cyc_yuv[i]),
                    rescale_01_per_image(inp.ds_yuv[i]), max_val=5.0)
        ssim_raw.append(s.mean())
        term = ssim_log_loss(s)
        ssim_losses.append(torch.where(drop[:, i] > 0.5, torch.zeros_like(term), term).mean())
    # the ED term x10 inside the / 5, as the reference has it
    ssim_total = (ssim_losses[0] + ssim_losses[1] + ssim_losses[2]
                  + ssim_losses[3] + ssim_losses[4] * 10.0) / 5.0

    # computed but excluded from the totals, as in the reference
    spec = [masked_mse(inp.cyc_yuv[i], inp.ds_yuv[i], inp.mask) for i in range(v)]
    spec_total = (spec[0] + spec[1] + spec[2] + spec[3]) / 5.0 + 5.0 * spec[4]

    nst = nst_loss(inp.cyc_yuv[v - 1], inp.ds_yuv[0], inp.ds_yuv[v - 1],
                   image_size, style_weight, content_weight)

    total_g = (d1_rf + d3_rf_cyc) / 6.0 + 10.0 * l1_total + 10.0 * ssim_total \
        + 10.0 * nst["nst"]
    total_d = (d1_cls + d3_cls) / 6.0 + (d2_rf_target + d4_rf_cyc) / 6.0 \
        + 0.5 * d4_cls + 10.0 * nst["nst"]
    total_c = 10.0 * (d4_cls + nst["nst"])

    return {
        "total_G": total_g, "total_D": total_d, "total_C": total_c,
        "G_gan": g_gan, "G_clsf": g_clsf,
        "D1_rf": d1_rf, "D3_rf_cyc": d3_rf_cyc, "D2_rf_target": d2_rf_target,
        "D4_rf_cyc": d4_rf_cyc, "D1_cls": d1_cls, "D3_cls": d3_cls, "D4_cls": d4_cls,
        "L1": l1_total, "SSIM_loss": ssim_total, "Spec": spec_total,
        "NST": nst["nst"], "content": nst["content"], "style": nst["style"],
        "ssim_mean": torch.stack(ssim_raw).mean(),
    }


# -- the SpecSeg trainer's objective ------------------------------------------

def dice_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Soft dice loss of probabilities against a binary mask."""
    num = 2.0 * (pred * target).sum() + eps
    den = pred.sum() + target.sum() + eps
    return 1.0 - num / den


def binary_focal_loss(pred: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
                      alpha: float = 0.25, eps: float = 1e-7) -> torch.Tensor:
    """Focal loss on probabilities, clipped to [eps, 1 - eps] before the logs."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    pos = -alpha * (1.0 - p) ** gamma * target * torch.log(p)
    neg = -(1.0 - alpha) * p ** gamma * (1.0 - target) * torch.log(1.0 - p)
    return (pos + neg).mean()


def specseg_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """dice + focal, weight 1 each."""
    return dice_loss(pred, target) + binary_focal_loss(pred, target)
