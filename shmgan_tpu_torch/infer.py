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

Also here: native-resolution inference (`bucket_shape`, `pad_to_bucket`,
`make_native_infer_fn`) and SpecSeg alone (`make_mask_fn`).

`data_parallel=n` splits each batch into n equal shards, runs shard i on
device i (`cuda:0..n-1`, or the `devices` given, repeats allowed) with a
replica of G and SpecSeg kept there, and concatenates the shards' outputs
in order: the counterpart of the JAX function's batch sharding over n
devices with replicated weights. Inference is per image, so no collective
runs.
"""

from __future__ import annotations

import copy
import itertools
import math
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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


def _check_outputs(outputs, with_cyclic: bool):
    """`outputs` as a tuple (None stays None); unknown keys raise, with the
    JAX package's message."""
    known = set(OUTPUTS) | ({"cyc_rgb"} if with_cyclic else set())
    if outputs is None:
        return None
    outputs = tuple(outputs)
    unknown = set(outputs) - known
    if unknown:
        raise ValueError(f"unknown infer outputs {sorted(unknown)}; known: {sorted(known)}")
    return outputs


def make_infer_fn(cfg: Config, with_cyclic: bool = False, outputs=None,
                  data_parallel: int = 1, devices: Optional[Sequence] = None
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

    `outputs` (an iterable of those keys, in the order wanted) returns only
    those, and computes only what they need: ("mask",) runs no G, and
    without gen_rgb_denorm, the composite or the cyclic pass none of them
    runs. None returns every output.

    data_parallel > 1: each call splits rgb's batch, which it must divide,
    over the devices (see the module's docstring).
    """
    c_dim = cfg.model.c_dim
    outputs = _check_outputs(outputs, with_cyclic)
    order = outputs if outputs is not None else OUTPUTS + (("cyc_rgb",) if with_cyclic else ())

    def wanted(*keys) -> bool:
        return any(k in order for k in keys)

    @torch.no_grad()
    def infer(gen, specseg, rgb: torch.Tensor) -> Dict[str, torch.Tensor]:
        with ieee_f32():
            out = _infer(gen, specseg, rgb)
        return {k: out[k] for k in order}

    def _infer(gen, specseg, rgb):
        b, h, w, _ = rgb.shape
        yuv, scale = preprocess.fused_standardize_yuv(rgb)
        y = yuv[..., 0:1]
        cbcr = yuv[..., 1:]

        net_in = specseg_net_input(y, rgb, cfg.model.specseg_in_channels)
        mask = _specseg_mask(specseg, net_in, cfg.eval.mask_tta)
        if cfg.eval.mask_chroma_prior:
            mask = fuse_mask_prior(mask, chroma_prior(rgb))
        out = {"mask": mask}
        if not wanted(*(set(order) - {"mask"})):
            return out

        zeros = rgb.new_zeros((b, h, w, 1))
        labels = rgb.new_zeros((b, h, w, c_dim))
        labels[..., c_dim - 1] = 1.0
        gen_input = torch.cat([y] + [zeros] * (c_dim - 1) + [labels], dim=-1)

        gen_y = gen(gen_input, mask)
        gen_yuv = torch.cat([gen_y, cbcr], dim=-1)
        out["gen_y"] = gen_y
        gen_rgb = yuv_to_rgb(gen_yuv)
        out["gen_rgb"] = gen_rgb
        scale = scale.view(-1, 1, 1, 1)
        if wanted("gen_rgb_denorm"):
            out["gen_rgb_denorm"] = yuv_to_rgb(gen_yuv * scale * 255.0)

        if wanted("gen_rgb_calibrated", "gen_rgb_composited"):
            # 5x5 dilation (SAME, -inf padding), then 5x5 box softening (SAME,
            # zero padding, / 25)
            m = F.max_pool2d(mask.permute(0, 3, 1, 2), 5, stride=1, padding=2)
            m = F.avg_pool2d(m, 5, stride=1, padding=2, count_include_pad=True)
            m = m.permute(0, 2, 3, 1)

            a_fit, b_fit = fit_affine_luma(gen_y, y, torch.clamp(1.0 - m, 0.0, 1.0))
            cal_yuv = torch.cat([a_fit * gen_y + b_fit, cbcr], dim=-1)
            calibrated = torch.clamp(yuv_to_rgb(cal_yuv * scale), 0.0, 1.0)
            out["gen_rgb_calibrated"] = calibrated
            out["gen_rgb_composited"] = m * calibrated + (1.0 - m) * rgb

        if with_cyclic and wanted("cyc_rgb"):
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

    if data_parallel > 1:
        return _data_parallel(infer, data_parallel, devices)
    return infer


def dp_devices(n: int, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The n devices of data-parallel inference: `devices` (n of them,
    repeats allowed), else cuda:0..n-1, which must be visible."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"data_parallel={n} but {len(devices)} devices given")
        return devices
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > visible:
        raise ValueError(f"data_parallel={n} but only {visible} devices visible")
    return [torch.device("cuda", i) for i in range(n)]


class _Replicas:
    """A copy of each module on each device it is asked for (the module
    itself on its own device). A copy is made again when the module's
    parameters or buffers were replaced or changed in place since it was
    made (their identities and version counters)."""

    def __init__(self):
        self._copies: Dict[Tuple[int, torch.device], tuple] = {}

    def get(self, module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
        if _device_of(module) == device:
            return module
        stamp = tuple((id(t), t._version)
                      for t in itertools.chain(module.parameters(), module.buffers()))
        key = (id(module), device)
        held = self._copies.get(key)
        if held is None or held[0] is not module or held[1] != stamp:
            held = (module, stamp, copy.deepcopy(module).to(device))
            self._copies[key] = held
        return held[2]


def _data_parallel(infer: Callable, n: int, devices: Optional[Sequence]) -> Callable:
    devices = dp_devices(n, devices)
    replicas = _Replicas()

    def run(gen, specseg, rgb: torch.Tensor) -> Dict[str, torch.Tensor]:
        b = rgb.shape[0]
        if b % n:
            raise ValueError(f"batch {b} must divide data_parallel {n}")
        size = b // n
        shards = []
        # every shard is enqueued before any output is gathered, so the
        # devices run at once
        for i, dev in enumerate(devices):
            x = rgb[i * size:(i + 1) * size].to(dev, non_blocking=True)
            with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                shards.append(infer(replicas.get(gen, dev), replicas.get(specseg, dev), x))
        return {k: torch.cat([o[k].to(rgb.device) for o in shards],
                             dim=1 if k == "cyc_rgb" else 0) for k in shards[0]}

    return run


def bucket_shape(h: int, w: int, multiple: int = 16, bucket: int = 64) -> Tuple[int, int]:
    """(h, w) rounded up to a multiple of `bucket` (at least `bucket`), which
    must itself be a multiple of `multiple`: SpecSeg pools 2x2 four times, so
    the extents must divide by 16, and the bucket keeps the set of shapes the
    engines see small."""
    if bucket % multiple != 0:
        raise ValueError(f"bucket {bucket} must be a multiple of {multiple}")
    return (max(bucket, math.ceil(h / bucket) * bucket),
            max(bucket, math.ceil(w / bucket) * bucket))


def pad_to_bucket(rgb, multiple: int = 16, bucket: int = 64):
    """Reflect-pad (B, h, w, 3) up to its bucket shape: (padded float32
    array, (h, w)). Reflection keeps the per-image standardisation's
    statistics representative; where the padding is not smaller than the
    image (a tiny image in a large bucket) the edge is repeated instead."""
    rgb = np.asarray(rgb, np.float32)
    _, h, w, _ = rgb.shape
    ph, pw = bucket_shape(h, w, multiple=multiple, bucket=bucket)
    if (ph, pw) == (h, w):
        return rgb, (h, w)
    mode = "reflect" if (ph - h) < h and (pw - w) < w else "edge"
    return np.pad(rgb, ((0, 0), (0, ph - h), (0, pw - w), (0, 0)), mode=mode), (h, w)


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_native_infer_fn(cfg: Config, with_cyclic: bool = False, multiple: int = 16,
                         bucket: int = 64, outputs=None, data_parallel: int = 1,
                         devices: Optional[Sequence] = None
                         ) -> Callable[..., Dict[str, np.ndarray]]:
    """Inference at any (h, w): fn(gen, specseg, rgb) with rgb a (B, h, w, 3)
    float32 array, reflect-padded to its bucket (pad_to_bucket) on the host,
    run on the models' device (over the data-parallel devices, from the
    host, with data_parallel > 1), every output cropped back to (h, w) and
    returned as float32 numpy arrays. A batch shares one (h, w)."""
    infer = make_infer_fn(cfg, with_cyclic=with_cyclic, outputs=outputs,
                          data_parallel=data_parallel, devices=devices)

    def run(gen, specseg, rgb) -> Dict[str, np.ndarray]:
        rgb_p, (h, w) = pad_to_bucket(rgb, multiple=multiple, bucket=bucket)
        x = torch.from_numpy(rgb_p)
        out = infer(gen, specseg, x if data_parallel > 1 else x.to(_device_of(gen)))
        # the spatial axes are the two before the channel axis, in (B, H, W, C)
        # and in cyc_rgb's (c_dim, B, H, W, C)
        return {k: v[..., :h, :w, :].float().cpu().numpy() for k, v in out.items()}

    return run


def make_mask_fn(cfg: Config, tta: bool = False, prior: Optional[bool] = None
                 ) -> Callable[..., torch.Tensor]:
    """SpecSeg alone: fn(specseg, rgb) -> (B, H, W, 1) specular mask. tta
    averages over the dihedral views; prior fuses the chroma prior
    (default: cfg.eval.mask_chroma_prior)."""
    if prior is None:
        prior = cfg.eval.mask_chroma_prior

    @torch.no_grad()
    def mask_fn(specseg, rgb: torch.Tensor) -> torch.Tensor:
        with ieee_f32():
            yuv, _ = preprocess.fused_standardize_yuv(rgb)
            net_in = specseg_net_input(yuv[..., 0:1], rgb, cfg.model.specseg_in_channels)
            mask = _specseg_mask(specseg, net_in, tta)
            if prior:
                mask = fuse_mask_prior(mask, chroma_prior(rgb))
        return mask

    return mask_fn
