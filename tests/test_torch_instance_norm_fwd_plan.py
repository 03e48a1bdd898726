"""The launch plan of the instance-norm forward kernels, on the CPU.

`_fwd_plan` decides from the shape alone which variant of the forward runs
(packed: several small planes to a warp; resident: the plane held in
registers, by one block, a group of a block, or a cluster of blocks; split:
a cluster shares a plane and reads its parts again; two-pass: the first
design, for H*W not a multiple of 16 bytes or x off a 16-byte boundary),
with how many threads, blocks a plane and registers. The tests pin the
variant at the shapes the port runs (serving, the train step, native
serving), each limit and the side just past it, walk each plan's mapping
from (block, thread) to elements as csrc/instance_norm.cu computes it (every
element of every plane exactly once, and where the plan keeps the two-pass
kernel's bits, each chunk held and folded where the two-pass kernel holds
and folds it), and hold a numpy emulation of each variant's moments, in its
map and merge order, against the plain version and JAX's
`instance_norm_reference`. The kernels themselves run only on the card
(chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shmgan_tpu.ops.pallas.instance_norm import instance_norm_reference
from shmgan_tpu_torch.ops.kernels import instance_norm as ink

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])

# chip_smoke.py's IN_SHAPES (G at b8, 256 px), TRAIN_IN_SHAPES (the train
# step at b8, 128 px) and NATIVE_IN_SHAPES (G at the 640x832 bucket, batch 2,
# and at 1536x2048, batch 1)
SERVING = [(8, 64, 256, 256), (8, 128, 128, 128), (8, 256, 64, 64), (8, 512, 32, 32),
           (8, 512, 16, 16)]
TRAIN = [(40, 64, 128, 128), (40, 128, 64, 64), (40, 256, 32, 32), (40, 512, 16, 16),
         (40, 512, 8, 8), (16, 64, 64, 64), (16, 128, 32, 32), (16, 256, 16, 16),
         (16, 512, 8, 8), (16, 1024, 4, 4), (80, 64, 64, 64), (80, 128, 32, 32),
         (80, 256, 16, 16), (80, 512, 8, 8), (80, 1024, 4, 4)]
NATIVE = [(2, 64, 640, 832), (2, 128, 320, 416), (2, 256, 160, 208), (2, 512, 80, 104),
          (2, 512, 40, 52), (1, 64, 1536, 2048), (1, 128, 768, 1024), (1, 256, 384, 512),
          (1, 512, 192, 256), (1, 512, 96, 128)]

# (variant, cluster) by (shape, dtype) at the native shapes
NATIVE_PLANS = {
    F32: [("split", 8), ("split", 8), ("resident", 4), ("resident", 1), ("two_pass", 1),
          ("split", 8), ("split", 8), ("split", 8), ("resident", 4), ("two_pass", 1)],
    BF16: [("split", 8), ("resident", 8), ("resident", 2), ("two_pass", 1), ("resident", 1),
           ("split", 8), ("split", 8), ("resident", 8), ("resident", 2), ("two_pass", 1)]}


def _vec(dtype):
    return 16 // dtype.itemsize


def _ids(s):
    return "x".join(map(str, s))


@DTYPES
@pytest.mark.parametrize("shape", SERVING + TRAIN, ids=_ids)
def test_variant_at_the_serving_and_train_shapes(shape, dtype):
    b, c, h, w = shape
    plan = ink._fwd_plan(b, c, h * w, dtype)
    chunks = h * w // _vec(dtype)
    assert plan.width == _vec(dtype)
    if chunks <= 64:                       # 16x16, 8x8, 4x4
        assert plan.variant == "packed"
        assert plan.lanes == min(32, chunks) and plan.chunks == -(-chunks // plan.lanes)
    elif (h, w) == (256, 256):             # G's full-size sites: a cluster holds the plane
        assert (plan.variant, plan.rounds) == ("resident", 1)
        assert plan.cluster == (4 if dtype == F32 else 2) and plan.chunks == 16
    elif (shape, dtype) == ((16, 64, 64, 64), F32):  # 16.8 MB at 4 chunks a thread: L2
        assert plan == ink.two_pass_plan(h * w, _vec(dtype))
    else:                                  # up to 128x128: one block, the two-pass map
        assert (plan.variant, plan.cluster, plan.rounds) == ("resident", 1, 1)
        assert plan.chunks <= ink.FWD_CHUNKS
    # every train shape keeps the two-pass kernel's bits: the bf16 step cannot move
    if shape in TRAIN:
        assert ink.keeps_two_pass_bits(plan)


@DTYPES
@pytest.mark.parametrize("i", range(len(NATIVE)), ids=[_ids(s) for s in NATIVE])
def test_variant_at_the_native_shapes(i, dtype):
    b, c, h, w = NATIVE[i]
    plan = ink._fwd_plan(b, c, h * w, dtype)
    assert (plan.variant, plan.cluster) == NATIVE_PLANS[dtype][i]
    # every block has work, and the grid fills the card at the large planes
    assert b * c * plan.cluster >= ink.FWD_MIN_BLOCKS or plan.cluster == 1
    if plan.variant == "split":
        assert plan.rounds > 1 and plan.chunks == ink.FWD_SPLIT_CHUNKS
        # 512-thread blocks for the largest parts only
        wide = -(-h * w // _vec(dtype) // plan.cluster) >= ink.FWD_SPLIT_WIDE
        assert plan.threads == (ink.FWD_SPLIT_THREADS if wide else ink.FWD_THREADS)


@DTYPES
def test_the_limits(dtype):
    v = _vec(dtype)
    many = ink.FWD_MIN_BLOCKS
    plan = lambda planes, chunks, aligned=True: ink._fwd_plan(  # noqa: E731
        1, planes, chunks * v, dtype, aligned)
    # packed up to 32 * FWD_PACKED_CHUNKS chunks of 16 bytes
    assert plan(many, 64).variant == "packed" and plan(many, 64).chunks == 2
    assert plan(many, 65).variant == "resident"
    # several planes a block up to TWO_PASS_THREADS chunks
    assert plan(many, 128).planes_per_block == 2 and plan(many, 256).planes_per_block == 1
    assert plan(many, 96).planes_per_block == 2 and plan(many, 96).threads == 192
    # one block at the two-pass map up to TWO_PASS_THREADS * FWD_CHUNKS chunks
    last, big = ink.TWO_PASS_THREADS * ink.FWD_CHUNKS, 4 * many  # big: past FWD_L2_BYTES
    assert plan(big, last)[:5] == ("resident", 1, 256, 256, 1) and plan(big, last).chunks == 16
    assert plan(big, last + 1).cluster > 1
    # two-pass for a tensor of up to FWD_L2_BYTES at FWD_L2_CHUNKS chunks a thread
    fits = ink.FWD_L2_BYTES // (16 * 3 * 256)  # planes of 3 * 256 chunks (4 a thread)
    assert plan(fits, 3 * 256).variant == "two_pass"
    assert plan(fits + 1, 3 * 256)[:2] == ("resident", 1)
    assert plan(fits, 2 * 256)[:2] == ("resident", 1)  # 2 chunks a thread
    # ... while the tensor has FWD_MIN_BLOCKS planes
    assert plan(many - 1, 512).cluster == 2 and plan(many, 512)[:5] == ("resident", 1, 256,
                                                                        256, 1)
    assert plan(1, 1024).cluster == ink.FWD_MAX_CLUSTER
    # a cluster holds up to its blocks' FWD_CLUSTER_CHUNKS chunks a thread
    top = ink.FWD_MAX_CLUSTER * ink.FWD_THREADS * ink.FWD_CLUSTER_CHUNKS
    assert plan(many, top)[:5] == ("resident", 1, 256, 256, 8)
    assert plan(many, top).chunks == ink.FWD_CLUSTER_CHUNKS
    assert plan(many, top + 1).variant == "split" and plan(many, top + 1).rounds == 2
    # split blocks of FWD_SPLIT_THREADS from parts of FWD_SPLIT_WIDE chunks
    wide = ink.FWD_MAX_CLUSTER * ink.FWD_SPLIT_WIDE
    assert plan(many, wide - 8).threads == 256 and plan(many, wide).threads == 512
    # two-pass for H*W off a multiple of 16 bytes, and for x off a 16-byte boundary
    assert ink._fwd_plan(2, 8, 17 * 17, dtype).variant == "two_pass"
    assert ink._fwd_plan(2, 8, 5 * 3, dtype).variant == "two_pass"
    odd = plan(many, 4096, aligned=False)
    assert (odd.variant, odd.width, odd.threads) == ("two_pass", 1, ink.TWO_PASS_THREADS)


def test_unaligned_storage_takes_two_pass():
    base = torch.zeros(2 * 8 * 64 * 64 + 1)
    assert ink.fwd_plan_for(base[:-1].view(2, 8, 64, 64)).variant == "resident"
    assert ink.fwd_plan_for(base[1:].view(2, 8, 64, 64)).variant == "two_pass"


@pytest.mark.parametrize("b,c,hw", [(0, 8, 64), (1, 0, 64), (1, 8, 0), (2**16, 2**15, 64),
                                    (1, 1, 2**31)])
def test_plan_rejects_empty_and_oversized(b, c, hw):
    with pytest.raises(ValueError):
        ink._fwd_plan(b, c, hw, F32)


# ------------------------------------------------------------------- walks

def _walk(plan, planes, hw):
    """(plane, chunk, thread, slot) of every chunk each thread of the plan's
    grid holds, in csrc/instance_norm.cu's index arithmetic: `thread` is the
    thread's index within its plane (its group, or rank * threads + thread
    in a cluster), `slot` the place of the chunk in that thread's fold order
    (packed: the butterfly it takes part in). Checks the kernels' limits on
    the way."""
    width, lanes, threads = plan.width, plan.lanes, plan.threads
    nchunks = hw // width
    assert nchunks * width == hw
    out = []
    if plan.variant == "packed":
        blocks = -(-planes * lanes // threads)
        t = np.arange(blocks * threads)
        plane, lane = t // lanes, t % lanes
        for k in range(plan.chunks):
            chunk = lane + k * lanes
            live = (plane < planes) & (chunk < nchunks)
            out.append((plane[live], chunk[live], lane[live], np.full(live.sum(), k)))
        assert plan.chunks <= 2 and lanes <= 32
    elif plan.variant in ("resident", "split"):
        k_ = plan.cluster
        run = -(-nchunks // k_)
        if k_ > 1:
            blk = np.arange(planes * k_)
            plane_b, rank = blk // k_, blk % k_
            groups = 1
        else:
            per = threads // lanes
            blk = np.arange(-(-planes // per))
            plane_b, rank, groups = blk, np.zeros_like(blk), per
        first = rank * run
        i = np.arange(threads)
        group, l = i // lanes, i % lanes
        plane = plane_b[:, None] * groups + group[None, :] if k_ == 1 else \
            np.broadcast_to(plane_b[:, None], (len(blk), threads))
        live_plane = plane < planes
        n = np.where(live_plane, np.minimum(run, nchunks - first[:, None]), 0)
        assert (n[live_plane] > 0).all()  # every block of a cluster has work
        step = lanes * plan.chunks
        rounds = 0
        for r in range(-(-run // step)):
            for k in range(plan.chunks):
                idx = l[None, :] + r * step + k * lanes
                live = idx < n
                if live.any():
                    rounds = max(rounds, r + 1)
                out.append((plane[live], (first[:, None] + idx)[live],
                            (rank[:, None] * threads + l[None, :] + 0 * idx)[live],
                            np.full(live.sum(), r * plan.chunks + k)))
        assert rounds == plan.rounds  # the plan's count is tight
        assert (plan.variant == "resident") == (rounds == 1)
        assert lanes % 32 == 0 and threads <= 512 and k_ <= 8
    else:
        t = np.arange(threads)
        for k in range(-(-nchunks // threads)):
            chunk = t + k * threads
            live = chunk < nchunks
            for p in range(planes):
                out.append((np.full(live.sum(), p), chunk[live], t[live],
                            np.full(live.sum(), k)))
    return [np.concatenate(a) for a in zip(*out)]


# every variant, partial last blocks and groups, one plane, clusters of 2 to
# 8, odd H*W, and the limits just past
WALK_SHAPES = [
    (3, 5, 7, 9), (2, 8, 5, 3), (1, 1, 1, 1), (5, 7, 2, 2), (2, 9, 4, 4), (3, 11, 8, 8),
    (2, 5, 16, 16), (1, 3, 16, 32), (3, 100, 16, 24), (3, 100, 16, 48), (2, 150, 32, 32),
    (2, 140, 64, 64), (2, 133, 128, 128), (1, 300, 128, 136), (1, 4, 64, 64),
    (1, 2, 256, 256), (1, 1, 256, 264), (1, 3, 40, 52), (1, 2, 300, 301), (2, 3, 20, 13),
    (1, 5, 16, 17), (6, 1, 2, 128)]


@DTYPES
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=_ids)
def test_threads_cover_every_element_once(shape, dtype):
    b, c, h, w = shape
    hw = h * w
    plan = ink._fwd_plan(b, c, hw, dtype)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.lanes * plan.planes_per_block == plan.threads or plan.cluster > 1
    plane, chunk, _, _ = _walk(plan, b * c, hw)
    elem = (chunk[:, None] * plan.width + np.arange(plan.width)[None, :]).ravel()
    owner = np.zeros((b * c, hw), np.int64)
    np.add.at(owner, (np.repeat(plane, plan.width), elem), 1)
    assert (owner == 1).all()


@DTYPES
@pytest.mark.parametrize("shape", SERVING[1:] + TRAIN + NATIVE[3:5] + NATIVE[9:], ids=_ids)
def test_kept_plans_hold_and_fold_as_two_pass(shape, dtype):
    """Where keeps_two_pass_bits says so, each chunk is held by the thread
    of the two-pass kernel that holds it (packed: the warp's lane; its slot
    the two-pass kernel's warp, whose butterfly it takes part in) and takes
    the same place in that thread's fold order."""
    b, c, h, w = shape
    plan = ink._fwd_plan(b, c, h * w, dtype)
    assert ink.keeps_two_pass_bits(plan)
    planes = min(b * c, 3 * plan.planes_per_block + 1)  # the first blocks, and a partial one
    _, chunk, thread, slot = _walk(plan, planes, h * w)
    if plan.variant == "packed":
        assert (chunk % 32 == thread).all() and (chunk // 32 == slot).all()
    else:
        assert (chunk % ink.TWO_PASS_THREADS == thread).all()
        assert (chunk // ink.TWO_PASS_THREADS == slot).all()


def test_cluster_and_split_do_not_claim_two_pass_bits():
    for shape, dtype in ((SERVING[0], F32), (NATIVE[0], BF16), ((1, 4, 64, 64), F32)):
        b, c, h, w = shape
        assert not ink.keeps_two_pass_bits(ink._fwd_plan(b, c, h * w, dtype))
    assert ink.keeps_two_pass_bits(ink.two_pass_plan(4096, 4))


# -------------------------------------------------------------- arithmetic

def _merge(a, nb, mb, qb):
    """Chan et al.'s update of moments a = (n, mean, m2) by (nb, mb, qb),
    elementwise in float32, as merge() in csrc/instance_norm.cu (its weight
    divided exactly here); empty moments on both sides leave a."""
    n0, m0, q0 = a
    n = n0 + nb
    safe = np.where(n == 0, np.float32(1), n)
    w = np.where(n == 0, np.float32(0), nb / safe).astype(np.float32)
    d = (mb - m0).astype(np.float32)
    return (n, np.where(n == 0, m0, m0 + d * w).astype(np.float32),
            np.where(n == 0, q0, q0 + (qb + d * d * n0 * w)).astype(np.float32))


def _fold(a, v):
    """Folds the chunks v (..., width) into a, as fold<width>()."""
    k = np.float32(v.shape[-1])
    mean = (v.sum(-1, dtype=np.float32) * (np.float32(1) / k)).astype(np.float32)
    m2 = ((v - mean[..., None]) ** 2).sum(-1, dtype=np.float32)
    return _merge(a, np.full_like(mean, k), mean, m2)


def _empty(shape):
    z = np.zeros(shape, np.float32)
    return (z, z.copy(), z.copy())


def _butterfly(a, lanes):
    """Each lane merges lane ^ o for o = lanes / 2 .. 1, over the last axis."""
    o = lanes // 2
    while o:
        idx = np.arange(a[0].shape[-1]) ^ o
        a = _merge(a, a[0][..., idx], a[1][..., idx], a[2][..., idx])
        o //= 2
    return a


def emulate_forward(x, gamma, beta, plan, eps=1e-6):
    """(y, mean, rstd) of one launch of `plan` in numpy float32, in the
    kernel's map and merge order, for x (B, C, H, W) holding float32 values
    (a vector plan: no two-pass)."""
    b, c, h, w = x.shape
    planes, hw, width = b * c, h * w, plan.width
    nchunks = hw // width
    xs = x.reshape(planes, nchunks, width).astype(np.float32)
    if plan.variant == "packed":
        lanes = plan.lanes
        acc = _empty(planes)
        for k in range(plan.chunks):
            part = _empty((planes, 32))
            idx = np.arange(32) + k * lanes
            live = (np.arange(32) < lanes) & (idx < nchunks)
            v = xs[:, np.minimum(idx, nchunks - 1)]
            folded = _fold(part, v)
            part = tuple(np.where(live, f, p) for f, p in zip(folded, part))
            part = _butterfly(part, lanes)
            acc = _merge(acc, part[0][:, 0], part[1][:, 0], part[2][:, 0])
    else:
        k_, threads = plan.cluster, plan.lanes
        run = -(-nchunks // k_)
        step = threads * plan.chunks
        blocks = []
        for rank in range(k_):
            first, n = rank * run, min(run, nchunks - rank * run)
            part = _empty((planes, threads))
            for r in range(-(-n // step)):
                for k in range(plan.chunks):
                    idx = np.arange(threads) + r * step + k * threads
                    live = idx < n
                    folded = _fold(part, xs[:, first + np.minimum(idx, n - 1)])
                    part = tuple(np.where(live, f, p) for f, p in zip(folded, part))
            warps = []
            for wi in range(threads // 32):
                s = slice(32 * wi, 32 * wi + 32)
                wa = _butterfly(tuple(p[:, s] for p in part), 32)
                warps.append(tuple(p[:, 0] for p in wa))
            acc = _empty(planes)
            for wa in warps:
                acc = _merge(acc, *wa)
            blocks.append(acc)
        acc = _empty(planes)
        for blk in blocks:
            acc = _merge(acc, *blk)
    n, mean, m2 = acc
    var = np.maximum(m2 / np.float32(hw), 0).astype(np.float32)
    rstd = (1 / np.sqrt(var + np.float32(eps))).astype(np.float32)
    scale = np.tile(gamma, b) * rstd
    y = (xs - mean[:, None, None]) * scale[:, None, None] + np.tile(beta, b)[:, None, None]
    return y.reshape(x.shape).astype(np.float32), mean.reshape(b, c), rstd.reshape(b, c)


# (shape, dtype): packed at 1 and 2 chunks a lane and at 2 lanes, resident in
# groups, at the two-pass map and in a cluster, split in a cluster
EMU_CASES = [((3, 40, 16, 16), F32), ((3, 40, 16, 16), BF16), ((2, 140, 4, 4), BF16),
             ((2, 150, 16, 24), F32), ((2, 140, 32, 32), BF16), ((1, 4, 64, 64), F32),
             ((1, 2, 256, 256), F32)]


def _inputs(shape, dtype, seed, flat=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 2.0 + 0.5
    if flat:  # mean 50, spread 0.1: E[x^2] - E[x]^2 loses such a plane in f32
        x = 50.0 + 0.1 * rng.standard_normal(shape)
    x = torch.from_numpy(x.astype(np.float32)).to(dtype).float().numpy()
    gamma = (1.0 + 0.2 * rng.standard_normal(shape[1])).astype(np.float32)
    beta = (0.1 * rng.standard_normal(shape[1])).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("shape,dtype", EMU_CASES,
                         ids=[f"{_ids(s)}-{'f32' if d == F32 else 'bf16'}" for s, d in EMU_CASES])
def test_emulated_variant_matches_plain_and_jax(shape, dtype):
    b, c, h, w = shape
    plan = ink._fwd_plan(b, c, h * w, dtype)
    x, gamma, beta = _inputs(shape, dtype, 61)
    y, mean, rstd = emulate_forward(x, gamma, beta, plan)
    xt = torch.from_numpy(x)
    ref = ink.instance_norm_plain(xt, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-6)
    np.testing.assert_allclose(y, ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mean, xt.mean(dim=(2, 3)).numpy(), rtol=1e-6, atol=1e-6)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    jy = np.asarray(instance_norm_reference(nhwc, jnp.asarray(gamma), jnp.asarray(beta), 1e-6))
    np.testing.assert_allclose(y, jy.transpose(0, 3, 1, 2), rtol=1e-4, atol=1e-4)
    # in the working dtype, as the kernel rounds y
    yd = torch.from_numpy(y).to(dtype).float().numpy()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == F32 else dict(rtol=2.0 ** -7, atol=1e-4)
    np.testing.assert_allclose(yd, ref.to(dtype).float().numpy(), **tol)


@pytest.mark.parametrize("shape,dtype", EMU_CASES,
                         ids=[f"{_ids(s)}-{'f32' if d == F32 else 'bf16'}" for s, d in EMU_CASES])
def test_emulated_variant_keeps_flat_planes(shape, dtype):
    """Flat planes (mean 50, spread 0.1): each variant's moments within a few
    f32 ulps of the float64 mean and 1e-3 of the float64 variance."""
    b, c, h, w = shape
    plan = ink._fwd_plan(b, c, h * w, dtype)
    x, gamma, beta = _inputs(shape, dtype, 62, flat=True)
    _, mean, rstd = emulate_forward(x, gamma, beta, plan)
    xd = x.astype(np.float64)
    mean64 = xd.mean(axis=(2, 3))
    var64 = xd.var(axis=(2, 3))
    ulp = np.spacing(np.float32(50.0))
    assert np.abs(mean - mean64).max() <= 16 * ulp
    # (bf16 rounds some small planes to one value: variance 0)
    np.testing.assert_allclose(1.0 / rstd.astype(np.float64) ** 2 - 1e-6, var64, rtol=1e-3,
                               atol=1e-9)
