"""The launch plan of the instance-norm backward kernel, and the arithmetic of
its packed and resident variants, on the CPU.

`_bwd_plan` decides from the shape alone which variant of the backward kernel
runs (packed: several small planes to a warp; resident: the plane held in the
registers of one block or a cluster of up to 8; streaming: two passes) and
with how many threads. The tests walk each plan's mapping from (block,
thread) to elements as the kernel computes it and check that it covers every
element of every plane once, within the kernel's limits. Numpy emulations of
the packed and resident variants' float32 arithmetic, in their order (each
chunk summed as a tree, a thread's chunks in turn, then a butterfly over a
plane's lanes; resident: then the block's warps in order and the cluster's
blocks in rank order; then the channel sums over B in order), are held
against the plain version and against JAX's gradient of
`instance_norm_reference`. The kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import QG_BATCH, QG_SMALL_BATCH, qg_in_shapes
from shmgan_tpu.ops.pallas.instance_norm import instance_norm_reference
from shmgan_tpu_torch.ops.kernels import instance_norm as ink

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])

# chip_smoke.py's TRAIN_IN_SHAPES: (B, C, H, W) of the train step's IN sites
TRAIN_IN_SHAPES = [
    (40, 64, 128, 128), (40, 128, 64, 64), (40, 256, 32, 32), (40, 512, 16, 16),
    (40, 512, 8, 8), (16, 64, 64, 64), (16, 128, 32, 32), (16, 256, 16, 16),
    (16, 512, 8, 8), (16, 1024, 4, 4), (80, 64, 64, 64), (80, 128, 32, 32),
    (80, 256, 16, 16), (80, 512, 8, 8), (80, 1024, 4, 4)]

# The backward's plan at each train shape's plane, as it has been since the
# train step's kernels were last redesigned: (H, dtype) -> BwdPlan fields
TRAIN_PLANS = {
    (128, F32): ("resident", 1, 1024, 512, 2, 4, 4),
    (64, F32): ("resident", 1, 256, 256, 1, 4, 4),
    (32, F32): ("resident", 1, 64, 64, 1, 4, 4),
    (16, F32): ("packed", 8, 32, 256, 1, 4, 2),
    (8, F32): ("packed", 16, 16, 256, 1, 4, 1),
    (4, F32): ("packed", 64, 4, 256, 1, 4, 1),
    (128, BF16): ("resident", 1, 512, 512, 1, 8, 4),
    (64, BF16): ("resident", 1, 128, 128, 1, 8, 4),
    (32, BF16): ("resident", 1, 64, 64, 1, 8, 2),
    (16, BF16): ("packed", 8, 32, 256, 1, 8, 1),
    (8, BF16): ("packed", 32, 8, 256, 1, 8, 1),
    (4, BF16): ("packed", 128, 2, 256, 1, 8, 1)}

# chip_smoke.qg_in_shapes: the phase-B step's IN sites at 256 px, batch 10,
# and the G1 sites of its f32 check at batch 2
PHASE_B_SHAPES = sorted({s for s, _ in qg_in_shapes(QG_BATCH) + qg_in_shapes(QG_SMALL_BATCH)})

# (B, C, H, W) whose mappings are walked: every variant, odd H*W, one plane,
# partial last blocks, clusters of 2 to 8 in both dtypes, the resident limits
# and just past them
WALK_SHAPES = [
    (3, 5, 7, 9), (2, 8, 5, 3), (1, 1, 1, 1), (1, 3, 1, 2), (5, 7, 2, 2), (2, 9, 4, 4),
    (3, 11, 8, 8), (2, 5, 16, 16), (1, 3, 15, 17), (2, 3, 4, 6), (4, 3, 12, 12),
    (1, 2, 17, 17), (2, 3, 32, 32), (1, 4, 24, 40), (2, 2, 64, 64), (1, 2, 33, 40),
    (1, 2, 100, 100), (1, 1, 128, 128), (1, 2, 128, 132), (1, 1, 128, 256),
    (1, 1, 128, 264), (1, 1, 256, 256), (2, 1, 300, 301), (3, 2, 20, 13),
    (1, 5, 16, 17), (6, 1, 2, 128), (1, 1, 1, 255), (1, 1, 1, 257),
    (1, 1, 192, 224), (1, 1, 224, 224), (1, 1, 200, 200), (1, 1, 256, 260),
    (1, 1, 256, 320), (1, 1, 256, 384), (1, 1, 256, 448), (1, 1, 256, 512),
    (1, 1, 256, 520), (1, 1, 512, 512)]

# chip_smoke.py's tolerances: dx (and y) in f32; dx in bf16 (one bf16 ulp plus
# the f32 atol); dgamma and dbeta of bf16 activations
IN_TOL = dict(rtol=1e-4, atol=1e-4)
IN_TOL_BF16 = dict(rtol=2.0 ** -7, atol=1e-4)
IN_PARAM_TOL_BF16 = dict(rtol=1e-3, atol=1e-3)


def _vec(dtype):
    return 16 // dtype.itemsize


@DTYPES
@pytest.mark.parametrize("shape", TRAIN_IN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_variant_at_the_train_shapes(shape, dtype):
    b, c, h, w = shape
    plan = ink._bwd_plan(b, c, h * w, dtype)
    if h * w <= 16 * 16:
        assert plan.variant == "packed"
        # one lane per 16-byte chunk, at most 32; 256 threads hold many planes
        assert plan.width == _vec(dtype)
        assert plan.lanes == min(32, h * w // _vec(dtype))
        assert plan.planes_per_block == plan.threads // plan.lanes >= 8
    else:
        assert plan.variant == "resident"
        assert plan.chunks <= ink.RESIDENT_CHUNKS and plan.width == _vec(dtype)
        # 128 x 128 in f32 takes a cluster of two 512-thread blocks
        assert plan.cluster == (2 if (dtype, h) == (F32, 128) else 1)
    # the train step keeps its plans exactly, and with them its bits
    assert tuple(plan) == TRAIN_PLANS[h, dtype]


@DTYPES
@pytest.mark.parametrize("shape", PHASE_B_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_variant_at_the_phase_b_shapes(shape, dtype):
    b, c, h, w = shape
    plan = ink._bwd_plan(b, c, h * w, dtype)
    if h < 256:  # the train step's planes: the same plans
        assert tuple(plan) == TRAIN_PLANS[h, dtype]
    else:
        # 256 x 256 is read once, 32 elements a thread: a cluster of 8 blocks
        # of 256 threads holding 8 chunks each in f32, of 4 blocks of 512
        # holding 4 chunks in bf16
        assert (plan.variant, plan.cluster, plan.threads, plan.chunks) == (
            ("resident", 8, 256, 8) if dtype == F32 else ("resident", 4, 512, 4))
        assert plan.lanes == plan.threads * plan.cluster and plan.width == _vec(dtype)
        assert plan.chunks * plan.width == ink.CLUSTER_ELEMS


@DTYPES
@pytest.mark.parametrize("hw", [384 * 384, 512 * 512, 1024 * 1024, 17 * 17, 33 * 33])
def test_streaming_above_the_resident_limit(hw, dtype):
    # planes too large for 8 blocks' registers (512 x 512 training), and
    # planes of more than 256 elements whose H*W is not a multiple of 16 bytes
    plan = ink._bwd_plan(2, 16, hw, dtype)
    assert plan.variant == "streaming"
    assert plan.threads == plan.lanes == ink.STREAM_THREADS and plan.cluster == 1


@pytest.mark.parametrize("dtype,last,first_streamed", [
    (F32, 256 * 256, 256 * 260), (BF16, 256 * 512, 256 * 520)])
def test_the_resident_limit(dtype, last, first_streamed):
    # a plane's 16-byte chunks in at most 8 blocks x 512 threads x 4 chunks
    # (f32: 8 blocks x 256 threads x 8 chunks)
    plan = ink._bwd_plan(1, 1, last, dtype)
    assert (plan.variant, plan.cluster, plan.threads) == ("resident", 8,
                                                          256 if dtype == F32 else 512)
    assert ink._bwd_plan(1, 1, first_streamed, dtype).variant == "streaming"
    assert ink._bwd_plan(1, 1, 256, dtype).variant == "packed"
    assert ink._bwd_plan(1, 1, 256 + _vec(dtype), dtype).variant == "resident"
    # the old limit of two blocks keeps its plan; one chunk past it takes 3
    two = 2 * 512 * 4 * _vec(dtype)
    assert tuple(ink._bwd_plan(1, 1, two, dtype))[:5] == ("resident", 1, 1024, 512, 2)
    assert ink._bwd_plan(1, 1, two + _vec(dtype), dtype).cluster == 3


def _walk(plan, planes, hw):
    """(plane, element) of every element each thread of the plan's grid
    holds, in the kernel's index arithmetic (csrc/instance_norm.cu); checks
    the kernel's limits on the way."""
    width, lanes, threads = plan.width, plan.lanes, plan.threads
    nchunks = hw // width
    assert nchunks * width == hw
    if plan.variant == "packed":
        per_lane = ink.PACKED_ELEMS // width
        blocks = -(-planes * lanes // threads)
        t = np.arange(blocks * threads)
        plane, lane = t // lanes, t % lanes
        k = np.arange(per_lane)
        chunk = lane[:, None] + k[None, :] * lanes          # (thread, k)
        live = (plane[:, None] < planes) & (chunk < nchunks)
        held = live.sum(1) * width
        assert held.max() <= ink.PACKED_ELEMS
        plane = np.broadcast_to(plane[:, None], chunk.shape)
    elif plan.variant == "resident":
        run = -(-nchunks // plan.cluster)
        blk = np.arange(planes * plan.cluster)
        plane_b, rank = blk // plan.cluster, blk % plan.cluster
        first = rank * run
        n = np.minimum(run, nchunks - first)
        assert (n > 0).all()  # every block of a cluster has work
        t = np.arange(threads)
        # the kernel's register arrays: 4 chunks, or 8 above that
        slots = (ink.RESIDENT_CHUNKS if plan.chunks <= ink.RESIDENT_CHUNKS
                 else ink.RESIDENT_MAX_CHUNKS)
        k = np.arange(slots)
        i = t[None, :, None] + k[None, None, :] * threads   # (block, thread, k)
        live = i < n[:, None, None]
        assert (i[:, :, -1:] + threads >= n[:, None, None]).all()  # nothing left over
        chunk = first[:, None, None] + i
        plane = np.broadcast_to(plane_b[:, None, None], chunk.shape)
        # the last chunk slot is live somewhere: the plan's count is tight
        assert live.sum(2).max() == plan.chunks <= ink.RESIDENT_MAX_CHUNKS
    else:
        t = np.arange(threads)
        k = np.arange(-(-nchunks // threads))
        i = t[:, None] + k[None, :] * threads
        live = np.broadcast_to(i < nchunks, (planes,) + i.shape)
        chunk = np.broadcast_to(i, live.shape)
        plane = np.broadcast_to(np.arange(planes)[:, None, None], live.shape)
    plane, chunk = plane[live], chunk[live]
    elem = (chunk[:, None] * width + np.arange(width)[None, :]).ravel()
    return np.repeat(plane, width), elem


@DTYPES
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_threads_cover_every_element_once(shape, dtype):
    b, c, h, w = shape
    hw = h * w
    plan = ink._bwd_plan(b, c, hw, dtype)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert 1 <= plan.cluster <= ink.RESIDENT_MAX_CLUSTER
    if plan.variant == "resident":
        assert plan.threads <= ink.RESIDENT_THREADS
        # 4 chunks a thread up to two blocks, 32 elements above
        assert plan.chunks <= (ink.RESIDENT_CHUNKS if plan.cluster <= 2
                               else ink.CLUSTER_ELEMS // plan.width)
    if plan.variant == "packed":
        assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
    assert plan.lanes * plan.planes_per_block == plan.threads * plan.cluster
    plane, elem = _walk(plan, b * c, hw)
    owner = np.zeros((b * c, hw), np.int64)
    np.add.at(owner, (plane, elem), 1)
    assert (owner == 1).all()


# plans made by hand, as time_instance_norm.py --sweep makes them: clusters
# of 2 to 8 blocks of 128 to 512 threads, up to 8 chunks a thread (the
# kernel's wide form)
HAND_PLANS = [((1, 2, 64, 64), 2, 64), ((1, 1, 256, 256), 4, 512), ((2, 1, 256, 256), 8, 256),
              ((1, 2, 128, 256), 8, 128), ((1, 2, 128, 128), 3, 256), ((1, 1, 200, 200), 7, 256),
              ((3, 1, 96, 96), 5, 128)]


@DTYPES
@pytest.mark.parametrize("shape,cluster,threads", HAND_PLANS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_threads_cover_every_element_once_in_hand_plans(shape, cluster, threads, dtype):
    b, c, h, w = shape
    vec = _vec(dtype)
    nchunks = h * w // vec
    run = -(-nchunks // cluster)
    plan = ink.BwdPlan("resident", 1, threads * cluster, threads, cluster, vec, -(-run // threads))
    assert plan.chunks <= ink.RESIDENT_MAX_CHUNKS  # the kernel takes it
    plane, elem = _walk(plan, b * c, h * w)
    owner = np.zeros((b * c, h * w), np.int64)
    np.add.at(owner, (plane, elem), 1)
    assert (owner == 1).all()


@pytest.mark.parametrize("b,c,hw", [(0, 8, 64), (1, 0, 64), (1, 8, 0)])
def test_plan_rejects_empty(b, c, hw):
    with pytest.raises(ValueError):
        ink._bwd_plan(b, c, hw, F32)


# ---------------------------------------------------------------- arithmetic

def _tree(v):
    """Sums the last axis pairwise in element order, as the kernel sums a
    16-byte chunk: ((0+1)+(2+3))+((4+5)+(6+7))."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def packed_backward_emulated(x, g, gamma, mean, rstd, dtype):
    """(dx, dgamma, dbeta) of the packed variant in numpy float32, in its
    order of operations: per lane the chunks it holds, each summed as a tree,
    added in turn; the plane's lanes by a butterfly over offsets lanes/2 .. 1;
    dgamma and dbeta over B in order. x and g hold values of `dtype` as
    float32; dx comes back rounded to `dtype`."""
    f = np.float32
    b, c, h, w = x.shape
    hw = h * w
    plan = ink._bwd_plan(b, c, hw, dtype)
    assert plan.variant == "packed"
    width, lanes = plan.width, plan.lanes
    n = hw // width
    mu = mean.reshape(b * c, 1, 1).astype(f)
    rs = rstd.reshape(b * c, 1, 1).astype(f)
    xs = x.reshape(b * c, n, width).astype(f)
    gs = g.reshape(b * c, n, width).astype(f)
    xhat = (xs - mu) * rs
    sums = []
    for v in (gs, gs * xhat):
        per_chunk = np.zeros((b * c, plan.chunks * lanes), f)
        per_chunk[:, :n] = _tree(v)
        per_chunk = per_chunk.reshape(b * c, plan.chunks, lanes)  # chunk k * lanes + lane
        acc = np.zeros((b * c, lanes), f)
        for k in range(plan.chunks):
            acc = acc + per_chunk[:, k, :]
        o = lanes // 2
        while o > 0:
            acc = acc + acc[:, np.arange(lanes) ^ o]
            o //= 2
        sums.append(acc[:, 0])
    sg, sgx = sums
    inv_n = f(1) / f(hw)
    k = (np.tile(gamma.astype(f), b) * rs[:, 0, 0])[:, None, None]
    mg, mgx = (sg * inv_n)[:, None, None], (sgx * inv_n)[:, None, None]
    dx = (k * (gs - mg - xhat * mgx)).reshape(b, c, h, w)
    dx = torch.from_numpy(dx).to(dtype).float().numpy()
    dgamma, dbeta = np.zeros(c, f), np.zeros(c, f)
    for i in range(b):
        dgamma = dgamma + sgx.reshape(b, c)[i]
        dbeta = dbeta + sg.reshape(b, c)[i]
    return dx, dgamma, dbeta


# small planes of the packed variant: 16x16, 8x8, 4x4, and odd H*W (the
# scalar form), with H*W a multiple of 16 bytes in f32 but not in bf16
EMU_SHAPES = [(4, 8, 16, 16), (2, 16, 8, 8), (3, 32, 4, 4), (3, 5, 7, 9), (2, 8, 5, 3),
              (2, 4, 4, 6), (2, 3, 12, 20)]


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    b, c = shape[:2]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    # the values of `dtype`, as float32
    x, g = (torch.from_numpy(a).to(dtype).float().numpy() for a in (x, g))
    gamma = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    xt = torch.from_numpy(x)
    mean = xt.mean(dim=(2, 3))
    rstd = torch.rsqrt((xt - mean[:, :, None, None]).square().mean(dim=(2, 3)) + 1e-6)
    return x, g, gamma, beta, mean.numpy(), rstd.numpy()


def _assert_close(got, want, dtype):
    tol, ptol = (IN_TOL, IN_TOL) if dtype == F32 else (IN_TOL_BF16, IN_PARAM_TOL_BF16)
    for name, a, r, t in zip(("dx", "dgamma", "dbeta"), got, want, (tol, ptol, ptol)):
        np.testing.assert_allclose(a, r, **t, err_msg=name)


@DTYPES
@pytest.mark.parametrize("shape", EMU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_emulation_matches_plain(shape, dtype):
    x, g, gamma, _, mean, rstd = _inputs(shape, dtype, 51)
    got = packed_backward_emulated(x, g, gamma, mean, rstd, dtype)
    dx, dgamma, dbeta = ink.instance_norm_backward_plain(
        torch.from_numpy(x).to(dtype), torch.from_numpy(gamma), torch.from_numpy(mean),
        torch.from_numpy(rstd), torch.from_numpy(g).to(dtype))
    assert dx.dtype == dtype
    _assert_close(got, (dx.float().numpy(), dgamma.numpy(), dbeta.numpy()), dtype)


@DTYPES
@pytest.mark.parametrize("shape", EMU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_emulation_matches_jax_grad(shape, dtype):
    x, g, gamma, beta, mean, rstd = _inputs(shape, dtype, 52)
    jdtype = jnp.float32 if dtype == F32 else jnp.bfloat16
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1)).astype(jdtype)  # noqa: E731
    _, vjp = jax.vjp(lambda x_, g_, b_: instance_norm_reference(x_, g_, b_, 1e-6),
                     nhwc(x), jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdgamma, jdbeta = vjp(nhwc(g))
    assert jdx.dtype == jdtype and jdgamma.dtype == jnp.float32
    got = packed_backward_emulated(x, g, gamma, mean, rstd, dtype)
    want = (np.asarray(jdx, np.float32).transpose(0, 3, 1, 2), np.asarray(jdgamma),
            np.asarray(jdbeta))
    _assert_close(got, want, dtype)


def resident_backward_emulated(x, g, gamma, mean, rstd, dtype, plan):
    """(dx, dgamma, dbeta) of the resident variant under `plan` in numpy
    float32, in its order of operations: block r of a plane's cluster holds
    chunks [r * run, (r + 1) * run), its thread t chunks t, t + threads, ...
    of them, each summed as a tree, added in turn; a butterfly over each
    warp's 32 lanes; the block's warps in order; the cluster's blocks in rank
    order; dgamma and dbeta over B in order. An empty slot adds 0, which
    changes no sum. x and g hold values of `dtype` as float32; dx comes back
    rounded to `dtype`."""
    f = np.float32
    b, c, h, w = x.shape
    hw, planes = h * w, b * c
    assert plan.variant == "resident" and plan.width == _vec(dtype)
    width, threads, cluster = plan.width, plan.threads, plan.cluster
    n = hw // width
    run = -(-n // cluster)
    slots = -(-run // threads)
    mu = mean.reshape(planes, 1, 1).astype(f)
    rs = rstd.reshape(planes, 1, 1).astype(f)
    xs = x.reshape(planes, n, width).astype(f)
    gs = g.reshape(planes, n, width).astype(f)
    xhat = (xs - mu) * rs
    lane = np.arange(32)
    sums = []
    for v in (gs, gs * xhat):
        per_chunk = np.zeros((planes, cluster * run), f)
        per_chunk[:, :n] = _tree(v)
        per_block = np.zeros((planes, cluster, slots * threads), f)
        per_block[:, :, :run] = per_chunk.reshape(planes, cluster, run)
        per_block = per_block.reshape(planes, cluster, slots, threads)  # chunk k * threads + t
        acc = np.zeros((planes, cluster, threads), f)
        for k in range(slots):
            acc = acc + per_block[:, :, k, :]
        acc = acc.reshape(planes, cluster, threads // 32, 32)
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[..., lane ^ o]
        warps = acc[..., 0]
        block = np.zeros((planes, cluster), f)
        for wi in range(threads // 32):
            block = block + warps[:, :, wi]
        total = block[:, 0]
        if cluster > 1:
            total = np.zeros(planes, f)
            for r in range(cluster):
                total = total + block[:, r]
        sums.append(total)
    sg, sgx = sums
    inv_n = f(1) / f(hw)
    k = (np.tile(gamma.astype(f), b) * rs[:, 0, 0])[:, None, None]
    mg, mgx = (sg * inv_n)[:, None, None], (sgx * inv_n)[:, None, None]
    dx = (k * (gs - mg - xhat * mgx)).reshape(b, c, h, w)
    dx = torch.from_numpy(dx).to(dtype).float().numpy()
    dgamma, dbeta = np.zeros(c, f), np.zeros(c, f)
    for i in range(b):
        dgamma = dgamma + sgx.reshape(b, c)[i]
        dbeta = dbeta + sg.reshape(b, c)[i]
    return dx, dgamma, dbeta


# small planes forced into clusters by small blocks (RESIDENT_THREADS patched
# to 64, RESIDENT_MIN_THREADS to 32: f32 blocks of 32 threads of 8 chunks
# above two blocks): (shape, blocks a plane in f32, in bf16); then phase B's
# 256 x 256 plane at the real limits
CLUSTER_EMU_CASES = [((2, 3, 40, 48), 2, 1), ((1, 2, 48, 60), 3, 2), ((2, 3, 64, 64), 4, 2),
                     ((1, 2, 60, 80), 5, 3), ((1, 1, 64, 96), 6, 3), ((1, 1, 64, 104), 7, 4),
                     ((2, 2, 64, 128), 8, 4)]


@pytest.fixture()
def small_blocks(monkeypatch):
    monkeypatch.setattr(ink, "RESIDENT_THREADS", 64)
    monkeypatch.setattr(ink, "RESIDENT_MIN_THREADS", 32)


def _cluster_plan(shape, dtype, f32_k, bf16_k):
    b, c, h, w = shape
    plan = ink._bwd_plan(b, c, h * w, dtype)
    assert (plan.variant, plan.cluster) == ("resident", f32_k if dtype == F32 else bf16_k)
    return plan


@DTYPES
@pytest.mark.parametrize("case", CLUSTER_EMU_CASES, ids=lambda v: "x".join(map(str, v[0])))
def test_resident_emulation_matches_plain(case, dtype, small_blocks):
    shape, f32_k, bf16_k = case
    plan = _cluster_plan(shape, dtype, f32_k, bf16_k)
    x, g, gamma, _, mean, rstd = _inputs(shape, dtype, 53)
    got = resident_backward_emulated(x, g, gamma, mean, rstd, dtype, plan)
    dx, dgamma, dbeta = ink.instance_norm_backward_plain(
        torch.from_numpy(x).to(dtype), torch.from_numpy(gamma), torch.from_numpy(mean),
        torch.from_numpy(rstd), torch.from_numpy(g).to(dtype))
    _assert_close(got, (dx.float().numpy(), dgamma.numpy(), dbeta.numpy()), dtype)


def _jax_grads(x, g, gamma, beta, dtype):
    jdtype = jnp.float32 if dtype == F32 else jnp.bfloat16
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1)).astype(jdtype)  # noqa: E731
    _, vjp = jax.vjp(lambda x_, g_, b_: instance_norm_reference(x_, g_, b_, 1e-6),
                     nhwc(x), jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdgamma, jdbeta = vjp(nhwc(g))
    assert jdx.dtype == jdtype and jdgamma.dtype == jnp.float32
    return (np.asarray(jdx, np.float32).transpose(0, 3, 1, 2), np.asarray(jdgamma),
            np.asarray(jdbeta))


@DTYPES
@pytest.mark.parametrize("case", CLUSTER_EMU_CASES, ids=lambda v: "x".join(map(str, v[0])))
def test_resident_emulation_matches_jax_grad(case, dtype, small_blocks):
    shape, f32_k, bf16_k = case
    plan = _cluster_plan(shape, dtype, f32_k, bf16_k)
    x, g, gamma, beta, mean, rstd = _inputs(shape, dtype, 54)
    got = resident_backward_emulated(x, g, gamma, mean, rstd, dtype, plan)
    _assert_close(got, _jax_grads(x, g, gamma, beta, dtype), dtype)


@DTYPES
def test_resident_emulation_at_phase_b_planes(dtype):
    # a 256 x 256 plane in phase B's plan: 8 blocks of 256 in f32, 4 of 512
    # in bf16
    shape = (2, 2, 256, 256)
    plan = ink._bwd_plan(*shape[:2], 256 * 256, dtype)
    assert (plan.variant, plan.cluster) == ("resident", 8 if dtype == F32 else 4)
    x, g, gamma, beta, mean, rstd = _inputs(shape, dtype, 55)
    got = resident_backward_emulated(x, g, gamma, mean, rstd, dtype, plan)
    dx, dgamma, dbeta = ink.instance_norm_backward_plain(
        torch.from_numpy(x).to(dtype), torch.from_numpy(gamma), torch.from_numpy(mean),
        torch.from_numpy(rstd), torch.from_numpy(g).to(dtype))
    _assert_close(got, (dx.float().numpy(), dgamma.numpy(), dbeta.numpy()), dtype)
    _assert_close(got, _jax_grads(x, g, gamma, beta, dtype), dtype)
