"""Single-RGB specular-free inference: the counterpart of
shmgan_tpu/infer.py's `make_infer_fn`.

Input contract: RGB in [0, 1], (B, H, W, 3). The input plays the I0 role, the
other Y planes are zero and the target label is ED. Every tensor is NHWC. G
and SpecSeg compute in `cfg.model.compute_dtype` (bfloat16 by default, or
float32); preprocessing, the mask's post-processing, the luma refit and the
colour conversions compute in float32, since a bfloat16 tensor meeting a
float32 one promotes to float32 in both frameworks. So `gen_y` comes back in
the compute dtype, as the JAX function returns it, and every other output in
float32. TF32 is off for the float32 convolutions while the function runs.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.ops.color import yuv_to_rgb
from shmgan_tpu_torch.ops.kernels import preprocess
from shmgan_tpu_torch.ops.specprior import (chroma_prior, fuse_mask_prior,
                                            specseg_net_input)

OUTPUTS = ("gen_rgb", "gen_rgb_denorm", "gen_rgb_calibrated", "gen_rgb_composited",
           "mask", "gen_y")


@contextmanager
def ieee_f32():
    """Keep cuDNN and cuBLAS in full float32 (no TF32) inside the block."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fit_affine_luma(gen_y: torch.Tensor, y_ref: torch.Tensor, weight: torch.Tensor):
    """Per-image weighted least-squares fit a*gen_y + b ~= y_ref over
    (B, H, W, 1) tensors; degenerate weights fall back to (1, 0). Returns (a, b)
    of shape (B, 1, 1, 1)."""
    dims = (1, 2, 3)
    sw = weight.sum(dims, keepdim=True)
    sx = (weight * gen_y).sum(dims, keepdim=True)
    sy = (weight * y_ref).sum(dims, keepdim=True)
    sxx = (weight * gen_y * gen_y).sum(dims, keepdim=True)
    sxy = (weight * gen_y * y_ref).sum(dims, keepdim=True)
    det = sw * sxx - sx * sx
    ok = (det > 1e-6) & (sw > 1.0)
    one = torch.ones_like(det)
    a = torch.where(ok, (sw * sxy - sx * sy) / torch.where(ok, det, one), one)
    b = torch.where(ok, (sy - a * sx) / torch.where(ok, sw, one), torch.zeros_like(det))
    return a, b


def _tta_views(x: torch.Tensor) -> List[torch.Tensor]:
    """Dihedral views of (B, H, W, C): the 4 flips, and the 4 transposed ones
    when H == W."""
    views = [x, x.flip(2), x.flip(1), x.flip(1, 2)]
    if x.shape[1] == x.shape[2]:
        xt = x.transpose(1, 2)
        views += [xt, xt.flip(2), xt.flip(1), xt.flip(1, 2)]
    return views


_TTA_INVERSES = (
    lambda v: v,
    lambda v: v.flip(2),
    lambda v: v.flip(1),
    lambda v: v.flip(1, 2),
    lambda v: v.transpose(1, 2),
    lambda v: v.flip(2).transpose(1, 2),
    lambda v: v.flip(1).transpose(1, 2),
    lambda v: v.flip(1, 2).transpose(1, 2),
)


def _specseg_mask(specseg, net_in: torch.Tensor, tta: bool) -> torch.Tensor:
    """SpecSeg probabilities; with tta, averaged over the dihedral views in
    one batched forward."""
    if not tta:
        return specseg(net_in)
    views = _tta_views(net_in)
    b = net_in.shape[0]
    stacked = specseg(torch.cat(views))
    parts = [inv(stacked[i * b:(i + 1) * b])
             for i, inv in enumerate(_TTA_INVERSES[:len(views)])]
    return sum(parts) / float(len(views))


def make_infer_fn(cfg: Config, with_cyclic: bool = False
                  ) -> Callable[..., Dict[str, torch.Tensor]]:
    """fn(gen, specseg, rgb) -> dict of outputs, on rgb's device.

    Outputs (B leading):
      gen_rgb            generated RGB in standardised-YUV scale
      gen_rgb_denorm     gen_rgb x the image's own scale x 255
      gen_rgb_calibrated luma refit to the non-specular pixels + inverse
                         standardisation, clipped to [0, 1]
      gen_rgb_composited input outside the dilated, softened mask, calibrated
                         output inside it
      mask               (B, H, W, 1) specular mask
      gen_y              (B, H, W, 1) generated Y
      cyc_rgb            (c_dim, B, H, W, 3) cyclic reconstructions, with_cyclic
    """
    c_dim = cfg.model.c_dim

    @torch.no_grad()
    def infer(gen, specseg, rgb: torch.Tensor) -> Dict[str, torch.Tensor]:
        with ieee_f32():
            return _infer(gen, specseg, rgb)

    def _infer(gen, specseg, rgb):
        b, h, w, _ = rgb.shape
        yuv, scale = preprocess.fused_standardize_yuv(rgb)
        y = yuv[..., 0:1]
        cbcr = yuv[..., 1:]

        net_in = specseg_net_input(y, rgb, cfg.model.specseg_in_channels)
        mask = _specseg_mask(specseg, net_in, cfg.eval.mask_tta)
        if cfg.eval.mask_chroma_prior:
            mask = fuse_mask_prior(mask, chroma_prior(rgb))

        zeros = rgb.new_zeros((b, h, w, 1))
        labels = rgb.new_zeros((b, h, w, c_dim))
        labels[..., c_dim - 1] = 1.0
        gen_input = torch.cat([y] + [zeros] * (c_dim - 1) + [labels], dim=-1)

        gen_y = gen(gen_input, mask)
        gen_yuv = torch.cat([gen_y, cbcr], dim=-1)
        gen_rgb = yuv_to_rgb(gen_yuv)
        scale = scale.view(-1, 1, 1, 1)
        denorm = yuv_to_rgb(gen_yuv * scale * 255.0)

        # 5x5 dilation (SAME, -inf padding), then 5x5 box softening (SAME,
        # zero padding, / 25)
        m = F.max_pool2d(mask.permute(0, 3, 1, 2), 5, stride=1, padding=2)
        m = F.avg_pool2d(m, 5, stride=1, padding=2, count_include_pad=True)
        m = m.permute(0, 2, 3, 1)

        a_fit, b_fit = fit_affine_luma(gen_y, y, torch.clamp(1.0 - m, 0.0, 1.0))
        cal_yuv = torch.cat([a_fit * gen_y + b_fit, cbcr], dim=-1)
        calibrated = torch.clamp(yuv_to_rgb(cal_yuv * scale), 0.0, 1.0)
        composited = m * calibrated + (1.0 - m) * rgb

        out = {"gen_rgb": gen_rgb, "gen_rgb_denorm": denorm,
               "gen_rgb_calibrated": calibrated, "gen_rgb_composited": composited,
               "mask": mask, "gen_y": gen_y}

        if with_cyclic:
            # every non-target plane carries gen_rgb's own Y, the target plane
            # is zero; the c_dim passes run as one (c_dim * B) G call
            orig_y = gen_rgb[..., 0:1]
            cyc_inputs = []
            for i in range(c_dim):
                planes = orig_y.repeat(1, 1, 1, c_dim)
                planes[..., i] = 0.0
                onehot = rgb.new_zeros((b, h, w, c_dim))
                onehot[..., i] = 1.0
                cyc_inputs.append(torch.cat([planes, onehot], dim=-1))
            cyc_y = gen(torch.cat(cyc_inputs), mask.repeat(c_dim, 1, 1, 1))
            cyc_y = cyc_y.view(c_dim, b, h, w, 1)
            cyc_yuv = torch.cat([cyc_y, cbcr.expand(c_dim, b, h, w, 2)], dim=-1)
            out["cyc_rgb"] = yuv_to_rgb(cyc_yuv)
        return out

    return infer
