"""Fused ingest: RGB -> YUV, then per-image standardisation. The CUDA kernel
and its plain version.

`fused_standardize_yuv(rgb)` launches `csrc/preprocess.cu` for a CUDA tensor
and runs `fused_standardize_yuv_plain` for a CPU tensor; there is no other
fallback. It replaces the TPU kernel `shmgan_tpu/ops/pallas/preprocess.py`
(`fused_standardize_yuv(use_pallas=True)`). The kernel is one launch of one
thread-block cluster per image; `_plan` picks, from the shape alone, its
variant (the image resident in the cluster's shared memory, or streamed in
tiles) and the cluster size. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from shmgan_tpu_torch.ops.color import rgb_to_yuv
from shmgan_tpu_torch.ops.standardize import per_image_standardization

launches = 0

# Blocks per cluster, i.e. per image: 16 (above the portable limit of 8; the
# library allows it when it is loaded) for batches of up to SMALL_BATCH
# images, whose few clusters then reach more SMs; 8 for larger batches, which
# on the H100 run faster in clusters of 8, as long as the image stays
# resident at 8 (chip_smoke.py measures both).
SMALL_BATCH = 4
# Shared memory one block may use: the 227 KB Hopper gives a block, less
# 1 KB for the kernel's static shared memory.
SMEM_BUDGET = 227 * 1024 - 1024
# Pixels per shared-memory tile of the streaming variant (48 KB).
STREAM_TILE_PX = 4096
_BYTES_PER_PX = 12


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    variant: str        # "resident" or "streaming"
    cluster: int        # blocks per image
    px_per_block: int   # pixels of the image each block owns (multiple of 4)
    tile_px: int        # pixels per shared-memory tile
    smem_bytes: int     # dynamic shared memory per block


def _run_px(npix: int, cluster: int) -> int:
    """Pixels each of `cluster` blocks owns: whole pixels in multiples of 4,
    so that every block's run starts 16-byte aligned."""
    return _ceil_div(_ceil_div(npix, cluster), 4) * 4


def _plan(b: int, h: int, w: int, cluster: Optional[int] = None) -> Plan:
    """The launch for a (b, h, w, 3) batch, from its shape alone: the cluster
    size (unless given), and the variant. The image stays resident in shared
    memory when a block's run fits the budget; otherwise the kernel streams
    it in tiles."""
    if b <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"fused_standardize_yuv: empty image or batch ({b}, {h}, {w})")
    if cluster is None:
        resident_at_8 = _run_px(h * w, 8) * _BYTES_PER_PX <= SMEM_BUDGET
        cluster = 8 if b > SMALL_BATCH and resident_at_8 else 16
    px_per_block = _run_px(h * w, cluster)
    if px_per_block * _BYTES_PER_PX <= SMEM_BUDGET:
        return Plan("resident", cluster, px_per_block, px_per_block,
                    px_per_block * _BYTES_PER_PX)
    return Plan("streaming", cluster, px_per_block, STREAM_TILE_PX,
                STREAM_TILE_PX * _BYTES_PER_PX)


_lib = None


def _library():
    """The loaded kernel library, with its shared-memory and cluster-size
    attributes set once for the current device."""
    global _lib
    if _lib is None:
        from shmgan_tpu_torch.runtime.build import load

        lib = load("preprocess")
        lib.shm_standardize_yuv_init.argtypes = []
        lib.shm_standardize_yuv_init.restype = ctypes.c_int
        lib.shm_standardize_yuv_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.shm_standardize_yuv_f32.restype = ctypes.c_int
        lib.shm_standardize_yuv_max_active_clusters.argtypes = [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.shm_standardize_yuv_max_active_clusters.restype = ctypes.c_int
        err = lib.shm_standardize_yuv_init()
        if err != 0:
            raise RuntimeError(f"fused_standardize_yuv: setting the kernel's attributes "
                               f"failed: CUDA error {err}")
        _lib = lib
    return _lib


def max_active_clusters(plan: Plan) -> int:
    """How many clusters of this plan the current device runs at once."""
    count = ctypes.c_int(0)
    err = _library().shm_standardize_yuv_max_active_clusters(
        plan.cluster, plan.smem_bytes, int(plan.variant == "streaming"), ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {err}")
    return count.value


def fused_standardize_yuv_plain(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    out, stats = per_image_standardization(rgb_to_yuv(rgb))
    return out, stats.stddev


def _launch(rgb: torch.Tensor, plan: Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on a checked (B, H, W, 3) CUDA tensor."""
    global launches
    b, h, w, _ = rgb.shape
    yuv = torch.empty_like(rgb)
    scale = torch.empty(b, dtype=torch.float32, device=rgb.device)
    with torch.cuda.device(rgb.device):
        err = _library().shm_standardize_yuv_f32(
            rgb.data_ptr(), yuv.data_ptr(), scale.data_ptr(), b, h * w, plan.cluster,
            plan.px_per_block, plan.tile_px, plan.smem_bytes,
            int(plan.variant == "streaming"),
            torch.cuda.current_stream(rgb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_standardize_yuv kernel launch failed ({plan}): "
                           f"CUDA error {err}")
    launches += 1
    return yuv, scale


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
    return _launch(rgb, _plan(b, h, w))
