"""The port's profiling hooks (utils/profiling.py) and viz's plots
(utils/viz.py `debug_plot`, `plot_single_image`), on the CPU.

`trace` writes a Chrome trace that holds the `annotate` region; `debug_mode`
raises FloatingPointError on the first NaN an op makes (log(0) * 0 / 0) and,
through autograd's anomaly check, on a NaN a backward makes; without a card
`device_memory_stats` is {}, as JAX gives for a device without stats. The
plots are PNGs that data/codecs.py reads back at their layout's size, each
panel the image rescaled for display (label planes clipped to [0, 1]).
"""

import json

import numpy as np
import pytest
import torch

from shmgan_tpu_torch.data.codecs import decode
from shmgan_tpu_torch.utils import profiling, viz

GAP = viz.GRID_GAP


def test_trace_holds_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("step/generator"):
            torch.randn(16, 16) @ torch.randn(16, 16)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert prof.trace_path.startswith(str(tmp_path / "trace"))
    assert any(e.get("name") == "step/generator" for e in events)
    assert any("mm" in e.get("name", "") for e in events)


def test_debug_mode_raises_on_a_nan():
    with pytest.raises(FloatingPointError, match="NaN"):
        with profiling.debug_mode(nans=True, disable_jit=True):
            torch.log(torch.zeros(3)) * 0 / 0
    with profiling.debug_mode(nans=False):
        assert torch.isnan(torch.log(torch.zeros(3)) * 0).all()
    assert torch.isnan(torch.log(torch.zeros(3)) * 0).all()      # the mode is gone


def test_debug_mode_raises_on_a_nan_in_a_backward():
    """sqrt'(0) = inf meets abs'(0) = 0: the forward is finite, the
    backward makes a NaN."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(FloatingPointError, match="nan"):
        with profiling.debug_mode():
            x.abs().sqrt().sum().backward()


def test_device_memory_stats():
    stats = profiling.device_memory_stats()
    assert isinstance(stats, dict)
    if torch.cuda.is_available():
        assert 0 <= stats["bytes_in_use"] <= stats["peak_bytes_in_use"] <= stats["bytes_limit"]
    else:
        assert stats == {}


def test_debug_plot_png(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 12, 10, 6)).astype(np.float32)   # 3 channels, 3 labels
    path = str(tmp_path / "debug.png")
    out = viz.debug_plot(x, path)
    with open(path, "rb") as f:
        png = decode(f.read())
    assert png.shape == out.shape == (2 * 12 + GAP, 3 * 10 + 2 * GAP, 3)
    assert np.array_equal(png, out)
    c1 = x[0, ..., 1]
    want = np.round((c1 - c1.min()) / (c1.max() - c1.min()) * 255).astype(np.uint8)
    assert np.array_equal(out[:12, 10 + GAP:20 + GAP, 0], want)
    label = np.round(np.clip(x[0, ..., 4], 0, 1) * 255).astype(np.uint8)
    assert np.array_equal(out[12 + GAP:, 10 + GAP:20 + GAP, 1], label)


@pytest.mark.parametrize("shape", [(9, 7), (9, 7, 1), (9, 7, 3)])
def test_plot_single_image_png(tmp_path, shape):
    img = np.random.default_rng(1).random(shape, np.float32)
    path = str(tmp_path / "single.png")
    out = viz.plot_single_image(img, "title", path)
    with open(path, "rb") as f:
        png = decode(f.read())
    rows = 4 if shape[-1] == 3 else 1
    assert png.shape == out.shape == (rows * 9 + (rows - 1) * GAP, 7, 3)
    assert np.array_equal(png, out)
    if rows == 4:
        ch = img[..., 2]
        want = np.round((ch - ch.min()) / (ch.max() - ch.min()) * 255).astype(np.uint8)
        assert np.array_equal(out[3 * (9 + GAP):, :, 0], want)
