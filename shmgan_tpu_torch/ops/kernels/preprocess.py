"""Fused ingest: RGB -> YUV, then per-image standardisation. The CUDA kernel
and its plain version.

`fused_standardize_yuv(rgb)` launches `csrc/preprocess.cu` for a CUDA tensor
and runs `fused_standardize_yuv_plain` for a CPU tensor; there is no other
fallback. It replaces the TPU kernel `shmgan_tpu/ops/pallas/preprocess.py`
(`fused_standardize_yuv(use_pallas=True)`). `launches` counts kernel launches
(one per call: the kernel's two passes are one launch of the function).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from shmgan_tpu_torch.ops.color import rgb_to_yuv
from shmgan_tpu_torch.ops.standardize import per_image_standardization

launches = 0

# Pixels each block of a pass covers: at 256 x 256 an image splits over 64
# blocks, so a batch of 8 puts 512 blocks on the 132 SMs.
_PIXELS_PER_BLOCK = 1024
_MAX_BLOCKS_PER_IMAGE = 1024

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from shmgan_tpu_torch.runtime.build import load

        fn = load("preprocess").shm_standardize_yuv_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_standardize_yuv_plain(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    out, stats = per_image_standardization(rgb_to_yuv(rgb))
    return out, stats.stddev


def fused_standardize_yuv(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) RGB in [0, 1] -> (standardised YUV (B, H, W, 3), per-image
    scales (B,))."""
    if rgb.device.type == "cpu":
        return fused_standardize_yuv_plain(rgb)
    if rgb.device.type != "cuda":
        raise ValueError(f"fused_standardize_yuv: unsupported device {rgb.device}")
    if rgb.dim() != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"fused_standardize_yuv: expected (B, H, W, 3), got "
                         f"{tuple(rgb.shape)}")
    if rgb.dtype != torch.float32 or not rgb.is_contiguous():
        raise ValueError(f"fused_standardize_yuv: rgb must be contiguous float32, "
                         f"got {rgb.dtype}")
    b, h, w, _ = rgb.shape
    npix = h * w
    if b == 0 or npix == 0:
        raise ValueError("fused_standardize_yuv: empty image or batch")
    yuv = torch.empty_like(rgb)
    scale = torch.empty(b, dtype=torch.float32, device=rgb.device)
    nblk = min(-(-npix // _PIXELS_PER_BLOCK), _MAX_BLOCKS_PER_IMAGE)
    partials = torch.empty((b, nblk, 2), dtype=torch.float32, device=rgb.device)
    global launches
    with torch.cuda.device(rgb.device):
        err = _kernel_fn()(rgb.data_ptr(), partials.data_ptr(), yuv.data_ptr(),
                           scale.data_ptr(), b, npix, nblk,
                           torch.cuda.current_stream(rgb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_standardize_yuv kernel launch failed: CUDA error {err}")
    launches += 1
    return yuv, scale
