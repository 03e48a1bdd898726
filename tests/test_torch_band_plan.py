"""The launch plan of the band instance-norm backward (spatial sharding), on
the CPU.

`_band_bwd_plan` decides from a band's shape alone which variant both of
its launches run (packed: several small bands to a warp; vector: one block a
plane with 16-byte loads; element: one block a plane, one element at a
time) and with how many threads. The tests check the plan at every band
shape of the spatial train step (`chip_smoke.SP_BAND_SHAPES`) and at edge
shapes, and walk each plan's mapping from (block, thread) to elements as
the two kernels compute it (csrc/instance_norm.cu): every element of every
plane once, within the kernels' limits, the sums launch's blocks in the
reverse order of the apply launch's. The kernels themselves run only on the
card (tests/test_torch_spatial_gpu.py).
"""

import numpy as np
import pytest
import torch

from chip_smoke import SP_BAND_SHAPES
from shmgan_tpu_torch.ops.kernels import instance_norm as ink

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])

# (B, C, h, W) of bands at the edges: H*W of 1, 7, 8, 256 and 257, odd band
# rows, H*W a multiple of 16 bytes in f32 but not in bf16, one plane, and
# partial last blocks
EDGE_SHAPES = [(2, 3, 1, 1), (3, 5, 1, 7), (2, 4, 1, 8), (1, 3, 16, 16), (2, 2, 1, 257),
               (3, 5, 5, 16), (2, 3, 3, 7), (1, 2, 17, 32), (2, 3, 3, 100), (1, 1, 9, 9),
               (5, 7, 1, 4), (3, 3, 33, 16), (1, 1, 31, 33)]


def _vec(dtype):
    return 16 // dtype.itemsize


def _shape_id(s):
    return "x".join(map(str, s))


@DTYPES
@pytest.mark.parametrize("shape", [s for s, _ in SP_BAND_SHAPES], ids=_shape_id)
def test_plan_at_the_step_band_shapes(shape, dtype):
    b, c, h, w = shape
    hw = h * w
    plan = ink._band_bwd_plan(b, c, hw, dtype)
    # every band of the step is a multiple of 16 bytes a plane
    assert plan.width == _vec(dtype)
    if hw <= 256:
        # D's deep maps and G's bottleneck: one lane per 16-byte chunk, at
        # most 32, several bands a warp
        assert plan.variant == "packed"
        assert plan.lanes == min(32, hw // _vec(dtype))
        assert plan.threads == ink.BAND_PACKED_THREADS
        assert plan.planes_per_block == plan.threads // plan.lanes >= 4
    else:
        assert plan.variant == "vector"
        assert plan.lanes == plan.threads and plan.planes_per_block == 1
        assert ink.BAND_MIN_THREADS <= plan.threads <= ink.BAND_MAX_THREADS
        assert plan.chunks == -(-(hw // _vec(dtype)) // plan.threads)


@DTYPES
@pytest.mark.parametrize("hw,variant,width", [
    (1, "packed", 1), (7, "packed", 1), (256, "packed", None), (257, "element", 1),
    (300, None, None), (512, "vector", None)])
def test_plan_at_the_edges(hw, variant, width, dtype):
    # None: by dtype. H*W 8 is a whole 16-byte chunk in bf16 and two in f32;
    # 300 is a multiple of 16 bytes in f32 only
    vec = _vec(dtype)
    plan = ink._band_bwd_plan(2, 3, hw, dtype)
    if variant is None:
        variant = "vector" if hw % vec == 0 else "element"
    assert plan.variant == variant
    assert plan.width == (width or (vec if hw % vec == 0 else 1))
    plan8 = ink._band_bwd_plan(2, 3, 8, dtype)
    assert (plan8.variant, plan8.width, plan8.lanes) == ("packed", vec, 8 // vec)


def _walk(plan, planes, hw, apply):
    """(plane, element) of every element each thread of the plan's grid
    takes, in the order the threads take them (block by block as the grid
    is numbered), in the kernels' index arithmetic: the sums launch's, whose
    blocks take their planes from the last, or with `apply` the apply
    launch's, from the first. Checks the kernels' limits on the way."""
    width, lanes, threads = plan.width, plan.lanes, plan.threads
    nchunks = hw // width
    assert nchunks * width == hw and threads % 32 == 0
    if plan.variant == "packed":
        assert lanes & (lanes - 1) == 0 and lanes <= 32 and threads <= ink.PACKED_THREADS
        per_lane = ink.PACKED_ELEMS // width
        blocks = -(-planes * lanes // threads)
        blk = np.arange(blocks)
        blk = blk if apply else blocks - 1 - blk
        t = (blk[:, None] * threads + np.arange(threads)[None, :]).ravel()
        plane, lane = t // lanes, t % lanes
        k = np.arange(per_lane)
        chunk = lane[:, None] + k[None, :] * lanes          # (thread, k)
        live = (plane[:, None] < planes) & (chunk < nchunks)
        assert live.sum(1).max() * width <= ink.PACKED_ELEMS
        assert live.sum(1).max() == plan.chunks
        plane = np.broadcast_to(plane[:, None], chunk.shape)
    else:
        assert plan.variant in ("vector", "element") and lanes == threads <= 512
        blk = np.arange(planes)
        plane_b = blk if apply else planes - 1 - blk
        u = ink.BAND_UNROLL
        bases = np.arange(threads)[:, None] + np.arange(0, nchunks, u * threads)[None, :]
        i = (bases[:, :, None] + np.arange(u)[None, None, :] * threads).reshape(threads, -1)
        live = np.broadcast_to(i < nchunks, (planes,) + i.shape)
        assert live[0].sum(1).max() == plan.chunks
        chunk = np.broadcast_to(i, live.shape)
        plane = np.broadcast_to(plane_b[:, None, None], live.shape)
    plane, chunk = plane[live], chunk[live]
    elem = (chunk[:, None] * width + np.arange(width)[None, :]).ravel()
    return np.repeat(plane, width), elem


@DTYPES
@pytest.mark.parametrize("shape", [(2, 3, h, w) for (_, _, h, w), _ in SP_BAND_SHAPES[:5]]
                         + EDGE_SHAPES, ids=_shape_id)
def test_threads_cover_every_element_once(shape, dtype):
    b, c, h, w = shape
    hw, planes = h * w, b * c
    plan = ink._band_bwd_plan(b, c, hw, dtype)
    assert plan.lanes * plan.planes_per_block == plan.threads
    walks = []
    for apply in (False, True):
        plane, elem = _walk(plan, planes, hw, apply)
        owner = np.zeros((planes, hw), np.int64)
        np.add.at(owner, (plane, elem), 1)
        assert (owner == 1).all()
        walks.append(plane)
    # the apply launch's first block takes the planes of the sums launch's
    # last block
    assert walks[1][0] == 0 and walks[0][-1] < plan.planes_per_block


@pytest.mark.parametrize("b,c,hw", [(0, 8, 64), (1, 0, 64), (1, 8, 0), (2**16, 2**15, 8),
                                    (1, 1, 2**30 + 8)])
def test_plan_refuses_what_the_kernels_cannot_take(b, c, hw):
    # an empty band; more planes than one grid dimension holds; a plane past
    # the kernels' int indexing
    with pytest.raises(ValueError):
        ink._band_bwd_plan(b, c, hw, F32)


def test_cpu_tensors_take_the_plain_steps_whatever_the_plan():
    g = torch.Generator().manual_seed(0)
    x, dy = torch.randn(2, 3, 4, 8, generator=g), torch.randn(2, 3, 4, 8, generator=g)
    gamma = torch.rand(3, generator=g) + 0.5
    mean, rstd = x.mean(dim=(2, 3)), torch.rand(2, 3, generator=g) + 0.5
    plan = ink._band_bwd_plan(2, 3, 32, F32)
    local = ink.band_bwd_sums(x, dy, mean, rstd, plan)
    assert torch.equal(local, ink.band_bwd_sums_plain(x, dy, mean, rstd))
    got = ink.band_bwd_apply(x, dy, gamma, mean, rstd, local, 2 * local, 64, plan)
    want = ink.band_bwd_apply_plain(x, dy, gamma, mean, rstd, local, 2 * local, 64)
    assert all(torch.equal(a, r) for a, r in zip(got, want))
