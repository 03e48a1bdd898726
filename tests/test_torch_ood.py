"""The port's `data/ood.reference_photo_crops` and `_content_runs`, its
`runtime/native_loader.estimate_diffuse_native`, and the nvcc flags, on the
CPU:

  - crops of synthetic 3 x N grids (white gutters, a narrow label column
    that the width rule drops) written by PIL as RGB, RGBA, palette and
    grey PNGs, resized down (40 -> 32) and up (40 -> 64): equal to the JAX
    package's crops exactly, which read the file through PIL's
    `convert("RGB")` and resize with Pillow's BILINEAR;
  - None where JAX returns None: a missing file, a grid of two rows;
  - the C++ channel-wise minimum equal to JAX's native library's and to
    numpy's, exactly;
  - `-Werror cross-execution-space-call` among the nvcc flags (a host call
    to a __device__ function fails the build).
"""

import io

import numpy as np
import pytest
from PIL import Image

from shmgan_tpu.data import ood as j_ood
from shmgan_tpu.runtime import native_loader as jnl
from shmgan_tpu_torch.data import ood
from shmgan_tpu_torch.runtime import build
from shmgan_tpu_torch.runtime import native_loader as nl

CELL, GUTTER, LABEL_W = 40, 6, 20


def grid_image(rows=3, cols=10, seed=0):
    """(H, W, 3) uint8: rows x cols cells of CELL pixels (random, darker
    than the gutter threshold) between white gutters, and a label LABEL_W
    wide left of each row, a column span that the 0.6-of-median rule
    drops."""
    rng = np.random.default_rng(seed)
    h = rows * CELL + (rows + 1) * GUTTER
    w = LABEL_W + cols * CELL + (cols + 2) * GUTTER
    im = np.full((h, w, 3), 255, np.uint8)
    for r in range(rows):
        y = GUTTER + r * (CELL + GUTTER)
        im[y:y + CELL, GUTTER:GUTTER + LABEL_W] = 90
        for c in range(cols):
            x = 2 * GUTTER + LABEL_W + c * (CELL + GUTTER)
            im[y:y + CELL, x:x + CELL] = rng.integers(0, 230, (CELL, CELL, 3))
    return im


def write_grid(path, mode="RGB", rows=3, cols=10, seed=0):
    """The grid as a PNG written by PIL in `mode` (RGB, RGBA, P or L)."""
    im = Image.fromarray(grid_image(rows, cols, seed))
    if mode == "RGBA":
        alpha = np.random.default_rng(seed + 1).integers(0, 256, im.size[::-1], np.uint8)
        im = Image.merge("RGBA", (*im.split(), Image.fromarray(alpha)))
    elif mode == "P":
        im = im.quantize(colors=200)
    elif mode == "L":
        im = im.convert("L")
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return str(path)


@pytest.mark.parametrize("size", [32, 64], ids=["down", "up"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L"])
def test_reference_photo_crops_equal_jax(tmp_path, mode, size):
    path = write_grid(tmp_path / f"grid_{mode}.png", mode, seed=size)
    got = ood.reference_photo_crops(size, path=path)
    want = j_ood.reference_photo_crops(size, path=path)
    assert sorted(got) == sorted(want) == ["inputs", "ref_masks", "ref_outputs"]
    assert got["inputs"].shape == (10, size, size, 3)
    assert got["ref_masks"].shape == (10, size, size, 1)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_content_runs_equal_jax():
    im = grid_image(seed=3).astype(np.float64)
    for axis in ((0, 2), (1, 2)):
        profile = im.mean(axis=axis)
        assert ood._content_runs(profile) == j_ood._content_runs(profile)
    profile = np.array([255.0] * 3 + [10.0] * 17 + [255.0] + [10.0] * 16 + [0.0] * 20)
    assert ood._content_runs(profile) == j_ood._content_runs(profile) == [(3, 20), (21, 57)]


def test_reference_photo_crops_none_as_jax(tmp_path):
    missing = str(tmp_path / "absent.png")
    assert ood.reference_photo_crops(32, path=missing) is None
    assert j_ood.reference_photo_crops(32, path=missing) is None
    two_rows = write_grid(tmp_path / "two_rows.png", rows=2)
    assert ood.reference_photo_crops(32, path=two_rows) is None
    assert j_ood.reference_photo_crops(32, path=two_rows) is None


@pytest.mark.parametrize("shape", [(4, 16, 24, 3), (3, 7), (1, 5, 5, 3)])
def test_estimate_diffuse_native_equals_jax_and_numpy(shape):
    assert jnl.build_native(), "the JAX package's native library did not build"
    views = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    calls = nl.calls
    got = nl.estimate_diffuse_native(views)
    assert nl.calls == calls + 1
    assert got.shape == views.shape[1:] and got.dtype == np.float32
    np.testing.assert_array_equal(got, jnl.estimate_diffuse_native(views))
    np.testing.assert_array_equal(got, nl.estimate_diffuse_plain(views))
    np.testing.assert_array_equal(got, views.min(axis=0))


def test_estimate_diffuse_native_raises_as_jax_without_the_library(monkeypatch):
    def broken():
        raise RuntimeError("build failed")

    monkeypatch.setattr(nl, "_library", broken)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        nl.estimate_diffuse_native(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError):
        nl.estimate_diffuse_plain(np.zeros((0, 3), np.float32))


def test_nvcc_refuses_host_calls_to_device_functions():
    flags = build.NVCC_FLAGS
    i = flags.index("-Werror")
    assert flags[i + 1] == "cross-execution-space-call"
    assert build._flags(build.source_path("instance_norm")) is flags
