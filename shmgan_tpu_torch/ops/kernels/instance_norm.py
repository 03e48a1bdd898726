"""Instance normalisation over NCHW activations: the CUDA kernels (forward and
backward) and their plain versions, for float32 and bfloat16 activations.

`instance_norm(x, gamma, beta, eps)` runs `instance_norm_plain` for a CPU
tensor, which autograd differentiates. For a CUDA tensor it launches
`csrc/instance_norm.cu`: when an input requires grad, through
`_InstanceNormFn`, whose forward also saves each plane's mean and rstd and
whose backward launches the backward kernel (`instance_norm_backward`);
otherwise the forward kernel alone. There is no other fallback.

The kernels replace the TPU kernel `shmgan_tpu/ops/pallas/instance_norm.py`
(`instance_norm_pallas`) and its custom VJP (`_fwd` / `_bwd`). The forward
kernels take one-pass moments by per-thread Welford folds merged pairwise
(Chan et al.) and form x - mean before the affine, so that a flat plane
cancels in neither; the plain version takes two-pass moments, as the JAX
package's `instance_norm_reference` does; the two agree to rounding.
`instance_norm_backward_plain` transcribes `_bwd`.

The forward has four variants (packed, resident, split, two-pass);
`_fwd_plan` picks one from the shape alone (two-pass also for x off a
16-byte boundary), with its threads, cluster and registers, and the launch
takes the plan and refuses one it cannot run. Packed, and resident without a
cluster, keep the two-pass kernel's bits.

Dtypes follow the TPU kernel's: the activations x, y, g and dx are all
float32 or all bfloat16, gamma, beta and the saved mean and rstd are float32,
every moment and affine is computed in float32, y and dx come back in x's
dtype and dgamma, dbeta in float32. A CUDA tensor of any other dtype (float16,
float64) raises.

The backward kernel has three variants (packed, resident, streaming);
`_bwd_plan` picks one from the shape alone, with its threads and its
cluster (resident: up to 8 blocks a plane, so phase B's 256 x 256 planes are
read once in both dtypes; streaming, which reads x and g twice, only above
that or for H*W off 16 bytes), and the launch takes the plan and refuses
one it cannot run.

Bands (parallel/spatial.py): `instance_norm_band(x, gamma, beta, eps, comm)`
normalises a band of rows of every plane, the planes spread over the ranks
of a model row, with the row's moments: the band's mean and M2 by one
launch (`band_moments`), the row's gathered in rank order (`comm.gather`),
then one launch that merges them (Chan et al.'s pairwise update) and
applies the affine (`band_apply`). Its backward takes the band's sums of g
and g * xhat by one launch (`band_bwd_sums`), adds the row's in float32
(`comm.sum_f32`), and forms dx, and this band's dgamma and dbeta, by one
more (`band_bwd_apply`); the first walks the planes in the reverse order of
the second, so that the second starts on the planes still in L2.
`_band_bwd_plan` picks both launches' variant (packed, vector, element) and
block size from the band's shape alone, and the launches refuse a plan they
cannot run. Each step has its plain version beside it, and a CPU tensor runs
those. `instance_norm_split(x, gamma, beta, eps, m)` is the
same arithmetic on a whole map in one process: each of its m bands through
the same steps, the bands' moments and sums joined in rank order.

`launches[kind, dtype]` counts the launches of each kernel by activation
dtype: "forward" and "backward", and the band kernels by the entry point
they serve ("band_forward": `band_moments` and `band_apply`;
"band_backward": `band_bwd_sums` and `band_bwd_apply`; two launches a
call), so a run can show its path went through the kernels;
`kernel_name(kind, dtype)` names each in reports.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

# the kernels' entry points in csrc/instance_norm.cu, by activation dtype
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_fns: Dict[torch.dtype, tuple] = {}
_band_fns: Dict[torch.dtype, tuple] = {}
KINDS = ("forward", "backward", "band_forward", "band_backward")
_KIND_NAMES = {"forward": "", "backward": "_backward", "band_forward": "_band",
               "band_backward": "_band_backward"}
launches: Dict[Tuple[str, torch.dtype], int] = {(k, d): 0 for k in KINDS for d in _SUFFIX}


# The backward's launch plan. Packed: a lane holds at most PACKED_ELEMS
# elements of x (and of g), so planes of up to 32 * PACKED_ELEMS elements
# are packed, several to a warp. Resident: a thread holds at most
# RESIDENT_CHUNKS 16-byte chunks of x (and of g), a block has at most
# RESIDENT_THREADS threads (two such blocks fit an SM's registers) and at
# least RESIDENT_MIN_THREADS (at 32x32 bf16 planes 64 threads of 2 chunks
# each ran faster on the H100 than 128 of one: time_instance_norm.py
# --sweep, PERF.md §6), and a plane takes at most RESIDENT_MAX_CLUSTER
# blocks, the portable cluster size (256 x 256 in f32, 131,072 elements in
# bf16). Above two blocks a thread holds CLUSTER_ELEMS elements: 4 chunks
# of bf16 in blocks of RESIDENT_THREADS, or 8 of f32 in blocks of half as
# many (RESIDENT_MAX_CHUNKS, the kernel's wide form: 112 registers a thread,
# two blocks of 256 an SM), so a block holds as many chunks either way. At
# phase B's 256 x 256 planes 8 chunks of f32 in 256 threads read 9-16 %
# faster than 4 in 512, and 4 chunks of bf16 in 512 threads 0.4-2 % faster
# than any other plan (time_instance_norm.py --phase-b --sweep, an H100,
# PERF.md §6). Streaming: the rest, in STREAM_THREADS-thread blocks that
# read the plane twice. csrc/instance_norm.cu holds the same limits.
PACKED_ELEMS = 8
PACKED_THREADS = 256
RESIDENT_CHUNKS = 4
RESIDENT_MAX_CHUNKS = 8
CLUSTER_ELEMS = 32
RESIDENT_THREADS = 512
RESIDENT_MIN_THREADS = 64
RESIDENT_MAX_CLUSTER = 8
STREAM_THREADS = 256
_VARIANTS = {"packed": 0, "resident": 1, "streaming": 2}


class BwdPlan(NamedTuple):
    variant: str           # "packed", "resident" or "streaming"
    planes_per_block: int  # packed: threads // lanes; else 1
    lanes: int             # threads that own one plane
    threads: int           # threads per block
    cluster: int           # blocks per plane (resident); else 1
    width: int             # elements per chunk: 16 bytes' worth, or 1 when H*W is
                           # not a multiple of that
    chunks: int            # chunks a thread holds (streaming: visits) at most


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _bwd_plan(b: int, c: int, hw: int, dtype: torch.dtype) -> BwdPlan:
    """The backward kernel's launch for a (b, c, H*W) tensor of `dtype`, from
    its shape alone. Packed for planes of up to 32 * PACKED_ELEMS elements:
    lanes = the plane's chunks rounded up to a power of 2, at most 32; resident
    where the plane's 16-byte chunks fit RESIDENT_MAX_CLUSTER blocks'
    registers, in the fewest blocks that hold them (a cluster where that is
    more than one; above two, CLUSTER_ELEMS elements a thread); streaming
    otherwise."""
    if b <= 0 or c <= 0 or hw <= 0:
        raise ValueError(f"instance_norm_backward: empty shape ({b}, {c}, {hw})")
    vec = 16 // dtype.itemsize
    width = vec if hw % vec == 0 else 1
    nchunks = hw // width
    if hw <= 32 * PACKED_ELEMS:
        lanes = min(32, _pow2_ceil(nchunks))
        return BwdPlan("packed", PACKED_THREADS // lanes, lanes, PACKED_THREADS, 1, width,
                       _ceil_div(nchunks, lanes))
    cluster = _ceil_div(nchunks, RESIDENT_THREADS * RESIDENT_CHUNKS)
    if width == vec and cluster <= RESIDENT_MAX_CLUSTER:
        run = _ceil_div(nchunks, cluster)
        per = RESIDENT_CHUNKS if cluster <= 2 else CLUSTER_ELEMS // vec
        threads = min(RESIDENT_THREADS * RESIDENT_CHUNKS // per,
                      max(RESIDENT_MIN_THREADS, 32 * _ceil_div(run, 32 * per)))
        return BwdPlan("resident", 1, threads * cluster, threads, cluster, width,
                       _ceil_div(run, threads))
    return BwdPlan("streaming", 1, STREAM_THREADS, STREAM_THREADS, 1, width,
                   _ceil_div(nchunks, STREAM_THREADS))


# The forward's launch plan (`_fwd_plan`), in 16-byte chunks of a plane.
# Packed: planes of up to 32 * FWD_PACKED_CHUNKS chunks, `lanes` threads a
# plane in blocks of FWD_PACKED_THREADS (64 to 256 read within 5 % of each
# other at every packed shape of the sweep below). Resident at the two-pass kernel's
# map (TWO_PASS_THREADS threads a plane): planes of up to TWO_PASS_THREADS *
# FWD_CHUNKS chunks (128 x 128 in f32, 128 x 256 in bf16), each thread
# holding up to FWD_CHUNKS of them (a power of 2: the kernel's register
# arrays), or, for up to TWO_PASS_THREADS chunks, several planes a block of
# `lanes` = the plane's chunks rounded up to a warp; while the tensor has at
# least FWD_MIN_BLOCKS planes to fill the card (two blocks an SM of the
# H100's 132). There, a tensor of at most FWD_L2_BYTES whose threads would
# hold FWD_L2_CHUNKS chunks or more takes two-pass instead: it stays in the
# 50 MB L2 between the conv that writes it and this launch, so the second
# read hits L2, and two-pass keeps 8 blocks an SM where resident keeps 2 to
# 4 (resident read 5-33 % slower at the five such shapes of the serving,
# native and train lists). Otherwise a cluster of up to FWD_MAX_CLUSTER
# blocks of up to FWD_THREADS a plane (the portable cluster size: no
# attribute to set):
# resident where its blocks' registers hold the plane at up to
# FWD_CLUSTER_CHUNKS chunks a thread, else split, its blocks folding their
# parts in rounds of FWD_SPLIT_CHUNKS chunks a thread, in blocks of
# FWD_SPLIT_THREADS where a part has FWD_SPLIT_WIDE chunks or more. Two-pass:
# H*W not a multiple of 16 bytes, or x off a 16-byte boundary. The cluster
# and split limits rest on `time_instance_norm.py --forward --sweep` (an
# H100, PERF.md §6): 16 chunks a thread in a cluster beat 8 at every shape
# that a cluster holds but one (5 % at 256 x 256 in f32); split blocks of
# 512 threads beat 256 by 5-10 % at parts of 16,384 chunks and more, and
# lost at smaller ones. csrc/instance_norm.cu holds the kernels' own limits
# (512 threads, 16 chunks, 8 blocks, packed 2 chunks a lane).
FWD_PACKED_CHUNKS = 2
FWD_PACKED_THREADS = 256
FWD_THREADS = 256
FWD_CHUNKS = 16
FWD_MIN_BLOCKS = 264
FWD_L2_BYTES = 24 * 2**20
FWD_L2_CHUNKS = 4
FWD_MAX_CLUSTER = 8
FWD_CLUSTER_CHUNKS = 16
FWD_SPLIT_CHUNKS = 16
FWD_SPLIT_THREADS = 512
FWD_SPLIT_WIDE = 16384
TWO_PASS_THREADS = 256
_FWD_VARIANTS = {"packed": 0, "resident": 1, "split": 2, "two_pass": 3}


class FwdPlan(NamedTuple):
    variant: str           # "packed", "resident", "split" or "two_pass"
    planes_per_block: int  # threads // lanes without a cluster; 1 with one
    lanes: int             # threads that own one plane in a block
    threads: int           # threads per block
    cluster: int           # blocks per plane (resident, split); else 1
    width: int             # elements per chunk: 16 bytes' worth, or 1 (two-pass's
                           # element path)
    chunks: int            # chunks a thread holds in registers (two-pass: 1)
    rounds: int            # times a thread fills them (split > 1; two-pass: its visits)


def keeps_two_pass_bits(plan: FwdPlan) -> bool:
    """True where the plan's kernel folds and merges as the two-pass kernel
    does, so that its y, mean and rstd are the two-pass kernel's bit for
    bit: two-pass itself, packed, and resident or split without a cluster
    at its block."""
    return plan.cluster == 1 and (
        plan.variant in ("two_pass", "packed") or plan.lanes == TWO_PASS_THREADS
        or plan.chunks * plan.rounds == 1)


def two_pass_plan(hw: int, width: int) -> FwdPlan:
    """The two-pass kernel's plan for planes of hw elements, `width` of them a
    chunk: 16 bytes' worth where H*W is a multiple of that and x is aligned,
    else 1."""
    return FwdPlan("two_pass", 1, TWO_PASS_THREADS, TWO_PASS_THREADS, 1, width, 1,
                   _ceil_div(hw // width, TWO_PASS_THREADS))


@functools.lru_cache(maxsize=None)
def _fwd_plan(b: int, c: int, hw: int, dtype: torch.dtype, aligned: bool = True) -> FwdPlan:
    """The forward kernel's launch for a (b, c, H*W) tensor of `dtype`, from
    its shape alone (`aligned`: x starts on a 16-byte boundary): packed,
    resident at the two-pass map, a cluster resident or split, or two-pass
    (the limits above). Raises ValueError for an empty shape or one past the
    kernels' grid. Cached: the wrapper asks at every call."""
    if b <= 0 or c <= 0 or hw <= 0:
        raise ValueError(f"instance_norm: empty shape ({b}, {c}, {hw})")
    planes = b * c
    if planes > _INT_MAX or hw > _INT_MAX:
        raise ValueError(f"instance_norm: ({b}, {c}, {hw}) is past the kernels' grid")
    vec = 16 // dtype.itemsize
    if not aligned or hw % vec:
        return two_pass_plan(hw, 1)
    nchunks = hw // vec
    if nchunks <= 32 * FWD_PACKED_CHUNKS:
        lanes = min(32, _pow2_ceil(nchunks))
        return FwdPlan("packed", FWD_PACKED_THREADS // lanes, lanes, FWD_PACKED_THREADS, 1,
                       vec, _ceil_div(nchunks, lanes), 1)
    if nchunks <= TWO_PASS_THREADS * FWD_CHUNKS and planes >= FWD_MIN_BLOCKS:
        if nchunks <= TWO_PASS_THREADS:
            lanes = 32 * _ceil_div(nchunks, 32)
            per = TWO_PASS_THREADS // lanes
            return FwdPlan("resident", per, lanes, lanes * per, 1, vec, 1, 1)
        chunks = _pow2_ceil(_ceil_div(nchunks, TWO_PASS_THREADS))
        if chunks >= FWD_L2_CHUNKS and planes * hw * dtype.itemsize <= FWD_L2_BYTES:
            return two_pass_plan(hw, vec)
        return FwdPlan("resident", 1, TWO_PASS_THREADS, TWO_PASS_THREADS, 1, vec, chunks, 1)
    # a cluster: enough blocks to hold the plane, or to fill the card
    need = max(_ceil_div(nchunks, FWD_THREADS * FWD_CLUSTER_CHUNKS),
               _ceil_div(FWD_MIN_BLOCKS, planes))
    cluster = min(FWD_MAX_CLUSTER, _pow2_ceil(need))
    while cluster > 1 and (cluster - 1) * _ceil_div(nchunks, cluster) >= nchunks:
        cluster //= 2
    run = _ceil_div(nchunks, cluster)
    threads = min(FWD_THREADS, 32 * _ceil_div(run, 32))
    per_thread = _ceil_div(run, threads)
    if per_thread <= FWD_CLUSTER_CHUNKS:
        chunks = _pow2_ceil(per_thread)
        return FwdPlan("resident", 1, threads, threads, cluster, vec, chunks, 1)
    threads = FWD_SPLIT_THREADS if run >= FWD_SPLIT_WIDE else FWD_THREADS
    return FwdPlan("split", 1, threads, threads, cluster, vec, FWD_SPLIT_CHUNKS,
                   _ceil_div(run, threads * FWD_SPLIT_CHUNKS))


# The band backward's launch plan (`_band_bwd_plan`). Packed: bands of up
# to BAND_PACKED_MAX elements, `lanes` threads a plane as the whole-plane
# packed variant (a lane holds at most PACKED_ELEMS elements of x and of g),
# in blocks of BAND_PACKED_THREADS. Vector (H*W a multiple of 16 bytes) and
# element (one element a chunk): one block a plane, of BAND_MIN_THREADS to
# BAND_MAX_THREADS threads, sized so that each thread takes about
# BAND_CHUNKS chunks (the kernel loads BAND_UNROLL of them before it uses
# them). The block sizes rest on `time_instance_norm.py --band --sweep` (an
# H100, PERF.md §6): packed blocks of 128 threads were the fastest, or
# within 2 % of it, at 14 of the step's 16 (band, dtype) pairs that pack;
# a vector block of a quarter of the band's chunks at 10 of the 14 that do
# not (at the other four, D's batch of 16, twice the threads won 2-13 %).
# csrc/instance_norm.cu holds the same limits.
BAND_PACKED_MAX = 32 * PACKED_ELEMS
BAND_PACKED_THREADS = 128
BAND_CHUNKS = 4
BAND_UNROLL = 4
BAND_MIN_THREADS = 32
BAND_MAX_THREADS = 512
_BAND_VARIANTS = {"packed": 0, "vector": 1, "element": 2}
_INT_MAX = 2**31 - 1


class BandPlan(NamedTuple):
    variant: str           # "packed", "vector" or "element"
    planes_per_block: int  # packed: threads // lanes; else 1
    lanes: int             # threads that own one plane
    threads: int           # threads per block
    width: int             # elements per chunk: 16 bytes' worth (packed, vector), else 1
    chunks: int            # chunks of a plane a thread takes at most


def _band_bwd_plan(b: int, c: int, hw: int, dtype: torch.dtype) -> BandPlan:
    """Both launches of the band backward for a (b, c, h, w) band of `dtype`,
    hw = h * w, from its shape alone: packed for bands of up to
    BAND_PACKED_MAX elements (lanes = the band's chunks rounded up to a power
    of 2, at most 32); else vector where hw is a multiple of 16 bytes and
    element where it is not, one block a plane. Raises ValueError for an
    empty shape or one past the kernels' grid."""
    if b <= 0 or c <= 0 or hw <= 0:
        raise ValueError(f"instance_norm band backward: empty shape ({b}, {c}, {hw})")
    if b * c > _INT_MAX or hw > 2**30:
        raise ValueError(f"instance_norm band backward: ({b}, {c}, {hw}) is past the "
                         f"kernels' grid")
    vec = 16 // dtype.itemsize
    width = vec if hw % vec == 0 else 1
    nchunks = hw // width
    if hw <= BAND_PACKED_MAX:
        lanes = min(32, _pow2_ceil(nchunks))
        return BandPlan("packed", BAND_PACKED_THREADS // lanes, lanes, BAND_PACKED_THREADS,
                        width, _ceil_div(nchunks, lanes))
    threads = min(BAND_MAX_THREADS,
                  max(BAND_MIN_THREADS, 32 * _ceil_div(nchunks, 32 * BAND_CHUNKS)))
    return BandPlan("vector" if width == vec else "element", 1, threads, threads, width,
                    _ceil_div(nchunks, threads))


def kernel_name(kind: str, dtype: torch.dtype) -> str:
    """instance_norm, instance_norm_backward, instance_norm_band,
    instance_norm_band_backward, and each with _bf16 for bf16."""
    return "instance_norm" + _KIND_NAMES[kind] + ("_bf16" if dtype == torch.bfloat16 else "")


def _kernel_fns(dtype: torch.dtype):
    """(forward, backward, backward occupancy, forward occupancy, backward
    cluster occupancy) C functions for activations of `dtype`."""
    if dtype not in _fns:
        from shmgan_tpu_torch.runtime.build import load

        lib = load("instance_norm")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fwd = getattr(lib, f"shm_instance_norm_{_SUFFIX[dtype]}")
        fwd.argtypes = [p, p, p, p, p, p, ll, i, ll, ctypes.c_float, i, i, i, i, i, p]
        fwd.restype = i
        bwd = getattr(lib, f"shm_instance_norm_bwd_{_SUFFIX[dtype]}")
        bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, ll, i, i, i, i, p]
        bwd.restype = i
        lib.shm_instance_norm_bwd_blocks_per_sm.argtypes = [i, i, i, i, i, i,
                                                            ctypes.POINTER(i)]
        lib.shm_instance_norm_bwd_blocks_per_sm.restype = i
        lib.shm_instance_norm_bwd_max_active_clusters.argtypes = [i, i, i, i,
                                                                  ctypes.POINTER(i)]
        lib.shm_instance_norm_bwd_max_active_clusters.restype = i
        lib.shm_instance_norm_fwd_blocks_per_sm.argtypes = [i, i, i, i, i,
                                                            ctypes.POINTER(i)]
        lib.shm_instance_norm_fwd_blocks_per_sm.restype = i
        _fns[dtype] = (fwd, bwd, lib.shm_instance_norm_bwd_blocks_per_sm,
                       lib.shm_instance_norm_fwd_blocks_per_sm,
                       lib.shm_instance_norm_bwd_max_active_clusters)
    return _fns[dtype]


def instance_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H, W) in x's dtype; per-(b, c) moments over H,
    W, and the affine, in f32 (`instance_norm_reference`)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)).to(x.dtype)


def instance_norm_backward_plain(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                                 rstd: torch.Tensor, g: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) of instance norm at x for the output gradient g,
    from the per-plane mean and rstd (B, C); `_bwd` of the JAX package: f32
    arithmetic, dx in x's dtype, dgamma and dbeta in f32."""
    n = x.shape[2] * x.shape[3]
    dtype = x.dtype
    x, g = x.float(), g.float()
    inv = rstd[:, :, None, None]
    xhat = (x - mean[:, :, None, None]) * inv
    dgamma = (g * xhat).sum(dim=(0, 2, 3))
    dbeta = g.sum(dim=(0, 2, 3))
    gg = g * gamma.view(1, -1, 1, 1)
    sum_gg = gg.sum(dim=(2, 3), keepdim=True)
    sum_gg_xhat = (gg * xhat).sum(dim=(2, 3), keepdim=True)
    dx = inv / n * (n * gg - sum_gg - xhat * sum_gg_xhat)
    return dx.to(dtype), dgamma, dbeta


def _check(acts: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> None:
    """The activations (x first) contiguous on one card in x's dtype, float32
    or bfloat16; the per-channel and per-plane tensors contiguous float32."""
    x = acts["x"]
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"instance_norm: expected (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"instance_norm: x must be float32 or bfloat16, got {x.dtype}")
    for names, dtype in ((acts, x.dtype), (params, torch.float32)):
        for name, t in names.items():
            if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
                raise ValueError(f"instance_norm: {name} must be contiguous {dtype} on "
                                 f"{x.device}, got {t.dtype} on {t.device}")


def _launch_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                    with_stats: bool, plan: FwdPlan
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One launch of the forward kernel with the given plan, on checked CUDA
    tensors; with_stats also returns the (B, C) mean and rstd."""
    b, c, h, w = x.shape
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"instance_norm: gamma/beta must be ({c},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")
    y = torch.empty_like(x)
    mean = rstd = None
    if with_stats:
        mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
        rstd = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, mean, rstd
    with torch.cuda.device(x.device):
        err = _kernel_fns(x.dtype)[0](
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr() if with_stats else None, rstd.data_ptr() if with_stats else None,
            b * c, c, h * w, float(eps), _FWD_VARIANTS[plan.variant], plan.lanes, plan.threads,
            plan.cluster, plan.chunks, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance_norm kernel launch failed ({plan}): CUDA error {err}")
    launches["forward", x.dtype] += 1
    return y, mean, rstd


def fwd_plan_for(x: torch.Tensor) -> FwdPlan:
    """`_fwd_plan` for a (B, C, H, W) tensor, two-pass where x is off a
    16-byte boundary."""
    b, c, h, w = x.shape
    return _fwd_plan(b, c, h * w, x.dtype, aligned=x.data_ptr() % 16 == 0)


def _forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
             with_stats: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """One launch of the forward kernel, with `_fwd_plan`'s plan; with_stats
    also returns the (B, C) mean and rstd."""
    plan = fwd_plan_for(x) if x.numel() else None
    return _launch_forward(x, gamma, beta, eps, with_stats, plan)


def _launch_backward(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                     rstd: torch.Tensor, g: torch.Tensor, plan: BwdPlan
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel with the given plan, on checked CUDA tensors."""
    b, c, h, w = x.shape
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    scratch = torch.empty(2 * b * c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fns(x.dtype)[1](
            x.data_ptr(), g.data_ptr(), gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), scratch.data_ptr(),
            b, c, h * w, _VARIANTS[plan.variant], plan.lanes, plan.threads, plan.cluster,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance_norm backward kernel launch failed ({plan}): "
                           f"CUDA error {err}")
    launches["backward", x.dtype] += 1
    return dx, dgamma, dbeta


def blocks_per_sm(plan: BwdPlan, dtype: torch.dtype) -> int:
    """How many blocks of the plan's backward kernel fit on one SM of the
    current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    vec = 16 // dtype.itemsize
    count = ctypes.c_int(0)
    err = _kernel_fns(dtype)[2](int(dtype == torch.bfloat16), _VARIANTS[plan.variant],
                                int(plan.width == vec), plan.threads, plan.cluster,
                                plan.chunks, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: "
                           f"CUDA error {err}")
    return count.value


def max_active_clusters(plan: BwdPlan, dtype: torch.dtype) -> int:
    """How many clusters of a resident backward plan with a cluster (more
    than one block a plane) the current device runs at once
    (cudaOccupancyMaxActiveClusters); 0 means the cluster cannot run."""
    count = ctypes.c_int(0)
    err = _kernel_fns(dtype)[4](int(dtype == torch.bfloat16), plan.threads, plan.cluster,
                                plan.chunks, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed ({plan}): CUDA error {err}")
    return count.value


def forward_blocks_per_sm(plan: FwdPlan, dtype: torch.dtype) -> int:
    """How many blocks of the plan's forward kernel fit on one SM of the
    current device (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    count = ctypes.c_int(0)
    err = _kernel_fns(dtype)[3](int(dtype == torch.bfloat16), _FWD_VARIANTS[plan.variant],
                                plan.threads, plan.cluster, plan.chunks, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: "
                           f"CUDA error {err}")
    return count.value


def instance_norm_backward(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                           rstd: torch.Tensor, g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) through the backward kernel, for CUDA tensors: x and
    g (B, C, H, W) in one dtype, gamma (C,), mean and rstd (B, C) from the
    forward in f32. dx comes back in x's dtype, dgamma and dbeta in f32."""
    _check({"x": x, "g": g}, {"gamma": gamma, "mean": mean, "rstd": rstd})
    b, c, h, w = x.shape
    if g.shape != x.shape or gamma.shape != (c,) or mean.shape != (b, c) \
            or rstd.shape != (b, c):
        raise ValueError(f"instance_norm_backward: shapes x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, gamma {tuple(gamma.shape)}, mean "
                         f"{tuple(mean.shape)}, rstd {tuple(rstd.shape)} do not fit")
    if x.numel() == 0:
        return (torch.empty_like(x), torch.zeros(c, dtype=torch.float32, device=x.device),
                torch.zeros(c, dtype=torch.float32, device=x.device))
    return _launch_backward(x, gamma, mean, rstd, g, _bwd_plan(b, c, h * w, x.dtype))


class _InstanceNormFn(torch.autograd.Function):
    """Forward kernel with saved (mean, rstd); backward kernel."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = _forward(x, gamma, beta, eps, with_stats=True)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = instance_norm_backward(x, gamma, mean, rstd, g.contiguous())
        return dx, dgamma, dbeta, None


def instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Instance norm of a contiguous (B, C, H, W) tensor, float32 or bfloat16,
    with per-channel float32 gamma and beta of shape (C,); the result in x's
    dtype. Differentiable in x, gamma and beta: the gradient reaching the
    output comes in the output's dtype, as JAX's cotangent does."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, gamma, beta, eps)
    _check({"x": x}, {"gamma": gamma, "beta": beta})
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _InstanceNormFn.apply(x, gamma, beta, eps)
    return _forward(x, gamma, beta, eps, with_stats=False)[0]


# -- bands of rows, over the ranks of a model row (parallel/spatial.py) ------

def _band_kernel_fns(dtype: torch.dtype):
    """(moments, apply, bwd_sums, bwd_apply) C functions for `dtype`."""
    if dtype not in _band_fns:
        from shmgan_tpu_torch.runtime.build import load

        lib = load("instance_norm")
        p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        sig = {"moments": [p, p, ll, ll, p],
               "apply": [p, p, p, p, i, ll, i, ll, f, p, p, p, p],
               "bwd_sums": [p, p, p, p, p, ll, ll, i, i, i, p],
               "bwd_apply": [p, p, p, p, p, p, p, ll, i, ll, f, p, p, p, i, i, i, p]}
        fns = []
        for name, argtypes in sig.items():
            fn = getattr(lib, f"shm_instance_norm_band_{name}_{_SUFFIX[dtype]}")
            fn.argtypes, fn.restype = argtypes, i
            fns.append(fn)
        _band_fns[dtype] = tuple(fns)
    return _band_fns[dtype]


def _run(fn, what: str, *args, plan: Optional[BandPlan] = None) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"instance_norm band {what} kernel launch failed"
                           f"{f' ({plan})' if plan else ''}: CUDA error {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_band(x: torch.Tensor, **others: torch.Tensor) -> None:
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"instance_norm band: expected a non-empty (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cuda":
        acts = {"x": x, **{k: v for k, v in others.items() if v.dtype != torch.float32}}
        _check(acts, {k: v for k, v in others.items() if k not in acts})


def band_moments_plain(x: torch.Tensor) -> torch.Tensor:
    """(2, B, C) float32: each plane's mean and sum of squared deviations
    (M2) over this band's rows, two-pass."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3))
    m2 = (xf - mean[:, :, None, None]).square().sum(dim=(2, 3))
    return torch.stack([mean, m2])


def band_moments(x: torch.Tensor) -> torch.Tensor:
    """`band_moments_plain` by one launch for a CUDA tensor (per-thread
    Welford, merged over the block); the plain version for a CPU one."""
    _check_band(x)
    if x.device.type == "cpu":
        return band_moments_plain(x)
    b, c, h, w = x.shape
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _run(_band_kernel_fns(x.dtype)[0], "moments", x.data_ptr(), out.data_ptr(), b * c,
             h * w, _stream(x))
    launches["band_forward", x.dtype] += 1
    return out


def _merge(parts: torch.Tensor, n_band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, M2 / n) of the row from its bands' (M, 2, B, C) moments, each
    band n_band elements a plane, merged in rank order (Chan et al.)."""
    n, mean, m2 = float(n_band), parts[0, 0], parts[0, 1]
    for r in range(1, parts.shape[0]):
        total = n + n_band
        delta = parts[r, 0] - mean
        mean = mean + delta * (n_band / total)
        m2 = m2 + parts[r, 1] + delta.square() * (n * n_band / total)
        n = total
    return mean, m2 / n


def band_apply_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     parts: torch.Tensor, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd): the row's moments from `parts` (M, 2, B, C), then
    y = (x - mean) * gamma * rstd + beta in x's dtype; mean and rstd (B, C)."""
    mean, var = _merge(parts, x.shape[2] * x.shape[3])
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    scale = (gamma.view(1, -1) * rstd)[:, :, None, None]
    y = (x.float() - mean[:, :, None, None]) * scale + beta.view(1, -1, 1, 1)
    return y.to(x.dtype), mean, rstd


def band_apply(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               parts: torch.Tensor, eps: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`band_apply_plain` by one launch for a CUDA tensor."""
    b, c, h, w = x.shape
    _check_band(x, gamma=gamma, beta=beta, parts=parts)
    if parts.dim() != 4 or parts.shape[1:] != (2, b, c) or gamma.shape != (c,) \
            or beta.shape != (c,):
        raise ValueError(f"instance_norm band: parts {tuple(parts.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)} do not fit "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return band_apply_plain(x, gamma, beta, parts, eps)
    y = torch.empty_like(x)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        _run(_band_kernel_fns(x.dtype)[1], "apply", x.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), parts.data_ptr(), parts.shape[0], b * c, c, h * w, float(eps),
             y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), _stream(x))
    launches["band_forward", x.dtype] += 1
    return y, mean, rstd


def band_bwd_sums_plain(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor) -> torch.Tensor:
    """(2, B, C) float32: each plane's sums of g and of g * xhat over this
    band's rows."""
    gf = g.float()
    xhat = (x.float() - mean[:, :, None, None]) * rstd[:, :, None, None]
    return torch.stack([gf.sum(dim=(2, 3)), (gf * xhat).sum(dim=(2, 3))])


def _plan_args(plan: BandPlan) -> Tuple[int, int, int]:
    return _BAND_VARIANTS[plan.variant], plan.lanes, plan.threads


def band_bwd_sums(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor, plan: Optional[BandPlan] = None) -> torch.Tensor:
    """`band_bwd_sums_plain` by one launch for a CUDA tensor, with `plan`
    (default `_band_bwd_plan`'s), the planes from the last."""
    _check_band(x, g=g, mean=mean, rstd=rstd)
    if x.device.type == "cpu":
        return band_bwd_sums_plain(x, g, mean, rstd)
    b, c, h, w = x.shape
    plan = plan or _band_bwd_plan(b, c, h * w, x.dtype)
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _run(_band_kernel_fns(x.dtype)[2], "backward sums", x.data_ptr(), g.data_ptr(),
             mean.data_ptr(), rstd.data_ptr(), out.data_ptr(), b * c, h * w,
             *_plan_args(plan), _stream(x), plan=plan)
    launches["band_backward", x.dtype] += 1
    return out


def band_bwd_apply_plain(x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor, local: torch.Tensor,
                         total: torch.Tensor, n: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) of this band: dx from the row's sums `total`
    (2, B, C) and the whole plane's count n (`_bwd` of the JAX package);
    dgamma and dbeta from this band's sums `local`, added over the batch."""
    inv = rstd[:, :, None, None]
    xhat = (x.float() - mean[:, :, None, None]) * inv
    gm = gamma.view(1, -1, 1, 1)
    sum_gg = (gamma.view(1, -1) * total[0])[:, :, None, None]
    sum_gg_xhat = (gamma.view(1, -1) * total[1])[:, :, None, None]
    dx = inv / n * (n * (g.float() * gm) - sum_gg - xhat * sum_gg_xhat)
    return dx.to(x.dtype), local[1].sum(dim=0), local[0].sum(dim=0)


def band_bwd_apply(x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor, local: torch.Tensor,
                   total: torch.Tensor, n: int, plan: Optional[BandPlan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`band_bwd_apply_plain` by one launch for a CUDA tensor, with `plan`
    (default `_band_bwd_plan`'s), the planes from the first: the reverse of
    `band_bwd_sums`."""
    _check_band(x, g=g, gamma=gamma, mean=mean, rstd=rstd, local=local, total=total)
    if x.device.type == "cpu":
        return band_bwd_apply_plain(x, g, gamma, mean, rstd, local, total, n)
    b, c, h, w = x.shape
    plan = plan or _band_bwd_plan(b, c, h * w, x.dtype)
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    with torch.cuda.device(x.device):
        _run(_band_kernel_fns(x.dtype)[3], "backward apply", x.data_ptr(), g.data_ptr(),
             gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(), local.data_ptr(),
             total.data_ptr(), b, c, h * w, float(n), dx.data_ptr(), dgamma.data_ptr(),
             dbeta.data_ptr(), *_plan_args(plan), _stream(x), plan=plan)
    launches["band_backward", x.dtype] += 1
    return dx, dgamma, dbeta


class _Steps(NamedTuple):
    moments: object
    apply: object
    bwd_sums: object
    bwd_apply: object


_KERNEL_STEPS = _Steps(band_moments, band_apply, band_bwd_sums, band_bwd_apply)
_PLAIN_STEPS = _Steps(band_moments_plain, band_apply_plain, band_bwd_sums_plain,
                      band_bwd_apply_plain)


def _steps(x: torch.Tensor, plain: bool) -> _Steps:
    return _PLAIN_STEPS if plain or x.device.type == "cpu" else _KERNEL_STEPS


def instance_norm_band_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                               eps: float, comm, plain: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) of this rank's band: its moments (one launch),
    gathered over the row (`comm.gather`), merged and applied (one launch);
    the plain steps for a CPU tensor or with `plain`."""
    steps = _steps(x, plain)
    parts = comm.gather(steps.moments(x))
    return steps.apply(x, gamma, beta, parts, eps)


def instance_norm_band_backward(x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                                mean: torch.Tensor, rstd: torch.Tensor, comm,
                                plain: bool = False
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) of this rank's band from the forward's mean and
    rstd: its sums (one launch), added over the row in float32
    (`comm.sum_f32`), then dx and this band's dgamma and dbeta (one launch);
    the plain steps for a CPU tensor or with `plain`."""
    steps = _steps(x, plain)
    local = steps.bwd_sums(x, g, mean, rstd)
    total = comm.sum_f32(local)
    return steps.bwd_apply(x, g, gamma, mean, rstd, local, total,
                           x.shape[2] * x.shape[3] * comm.m)


class _BandFn(torch.autograd.Function):
    """IN of this rank's band, the moments and sums joined over `comm`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, comm, plain):
        y, mean, rstd = instance_norm_band_forward(x, gamma, beta, eps, comm, plain)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.comm, ctx.plain = comm, plain
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = instance_norm_band_backward(x, g.contiguous(), gamma, mean, rstd,
                                                        ctx.comm, ctx.plain)
        return dx, dgamma, dbeta, None, None, None


def instance_norm_band(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                       comm) -> torch.Tensor:
    """Instance norm of this rank's band of rows (B, C, h, W) of planes cut
    into comm.m equal bands over a model row; `comm` (parallel/spatial.py's
    Band) gathers the bands' moments in rank order (`gather`) and adds
    float32 sums over the row (`sum_f32`). Through the kernels for a CUDA
    tensor, the plain steps for a CPU one; differentiable in x, gamma and
    beta (dgamma and dbeta: this band's share)."""
    return _BandFn.apply(x.contiguous(), gamma, beta, eps, comm, False)


def instance_norm_band_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                             eps: float, comm) -> torch.Tensor:
    """`instance_norm_band` through the plain steps on any device."""
    return _BandFn.apply(x.contiguous(), gamma, beta, eps, comm, True)


def _bands(h: int, m: int):
    if h % m:
        raise ValueError(f"instance_norm split: {h} rows do not divide into {m} bands")
    return [(j * (h // m), h // m) for j in range(m)]


class _SplitFn(torch.autograd.Function):
    """`_BandFn` of every band of a whole map in one process."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, m, plain):
        steps = _steps(x, plain)
        bands = [x.narrow(2, s, n).contiguous() for s, n in _bands(x.shape[2], m)]
        parts = torch.stack([steps.moments(b) for b in bands])
        outs = [steps.apply(b, gamma, beta, parts, eps) for b in bands]
        mean, rstd = outs[0][1], outs[0][2]
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.m, ctx.steps = m, steps
        return torch.cat([o[0] for o in outs], 2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, gamma, mean, rstd = ctx.saved_tensors
        spans = _bands(x.shape[2], ctx.m)
        xs = [x.narrow(2, s, n).contiguous() for s, n in spans]
        gs = [g.narrow(2, s, n).contiguous() for s, n in spans]
        local = [ctx.steps.bwd_sums(xb, gb, mean, rstd) for xb, gb in zip(xs, gs)]
        total = local[0]
        for part in local[1:]:
            total = total + part
        outs = [ctx.steps.bwd_apply(xb, gb, gamma, mean, rstd, lb, total, x.shape[2] * x.shape[3])
                for xb, gb, lb in zip(xs, gs, local)]
        dgamma, dbeta = outs[0][1], outs[0][2]
        for o in outs[1:]:
            dgamma, dbeta = dgamma + o[1], dbeta + o[2]
        return torch.cat([o[0] for o in outs], 2), dgamma, dbeta, None, None, None


def instance_norm_split(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                        m: int) -> torch.Tensor:
    """Instance norm of a whole (B, C, H, W) map computed as the m bands of a
    model row compute it (`instance_norm_band`), in one process: the kernels
    for a CUDA tensor, the plain steps for a CPU one."""
    return _SplitFn.apply(x.contiguous(), gamma, beta, eps, m, False)


def instance_norm_split_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                              eps: float, m: int) -> torch.Tensor:
    """`instance_norm_split` through the plain steps on any device."""
    return _SplitFn.apply(x.contiguous(), gamma, beta, eps, m, True)
