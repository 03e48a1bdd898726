"""The launch plan of the fused standardise+YUV kernel, on the CPU.

`_plan` decides from the shape alone which variant of the cluster kernel runs
(the image resident in its cluster's shared memory, or streamed in tiles),
how many blocks share an image, and how much shared memory each block takes.
The kernel itself runs only on the card (tests/test_torch_kernels_gpu.py).
"""

import numpy as np
import pytest

from shmgan_tpu_torch.ops.kernels import preprocess as pre

SHAPES = [(8, 64, 64), (8, 256, 256), (1, 256, 256), (1, 512, 512), (2, 640, 640),
          (1, 1024, 1024), (3, 17, 31), (1, 1, 1), (2, 100, 130), (1, 555, 555),
          (1, 556, 556), (1, 2048, 1536)]


@pytest.mark.parametrize("b,h,w", [(8, 64, 64), (8, 256, 256), (1, 512, 512)])
def test_resident_up_to_512px(b, h, w):
    plan = pre._plan(b, h, w)
    assert plan.variant == "resident"
    assert plan.tile_px == plan.px_per_block
    assert plan.smem_bytes == 12 * plan.px_per_block <= pre.SMEM_BUDGET


@pytest.mark.parametrize("b,h,w,cluster", [
    (1, 256, 256, 16), (4, 256, 256, 16), (8, 256, 256, 8), (16, 64, 64, 8),
    (8, 512, 512, 16),  # resident only in clusters of 16
    (8, 1024, 1024, 16)])
def test_cluster_size_by_shape(b, h, w, cluster):
    # small batches spread their few clusters over more SMs; larger batches
    # take clusters of 8 while the image stays resident in them
    assert pre._plan(b, h, w).cluster == cluster


@pytest.mark.parametrize("b,h,w", [(1, 1024, 1024), (2, 640, 640)])
def test_streaming_above_the_clusters_shared_memory(b, h, w):
    plan = pre._plan(b, h, w)
    assert plan.variant == "streaming"
    assert 12 * plan.px_per_block > pre.SMEM_BUDGET
    assert plan.tile_px < plan.px_per_block
    assert plan.smem_bytes == 12 * plan.tile_px <= pre.SMEM_BUDGET


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_blocks_cover_every_pixel_once_within_budget(b, h, w, cluster):
    plan = pre._plan(b, h, w, cluster=cluster)
    assert plan.cluster == cluster
    assert plan.smem_bytes <= pre.SMEM_BUDGET
    # runs of whole pixels in multiples of 4: each starts 16-byte aligned
    assert plan.px_per_block % 4 == 0 and plan.tile_px % 4 == 0
    # the kernel's ranges: block r owns [r * ppb, min((r + 1) * ppb, npix))
    npix = h * w
    owner = np.zeros(npix, np.int64)
    for r in range(plan.cluster):
        lo = min(r * plan.px_per_block, npix)
        owner[lo:min(lo + plan.px_per_block, npix)] += 1
    assert (owner == 1).all()


def test_the_resident_limit_is_the_budget():
    # the largest square image that stays resident at 16 blocks, and the next
    assert pre._plan(1, 555, 555).variant == "resident"
    assert pre._plan(1, 556, 556).variant == "streaming"
    assert pre._plan(1, 392, 392, cluster=8).variant == "resident"
    assert pre._plan(1, 393, 393, cluster=8).variant == "streaming"


@pytest.mark.parametrize("b,h,w", [(0, 8, 8), (1, 0, 8), (1, 8, 0)])
def test_plan_rejects_empty(b, h, w):
    with pytest.raises(ValueError):
        pre._plan(b, h, w)
