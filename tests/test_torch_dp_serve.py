"""The port's data-parallel serving on the CPU: `BatchInferenceEngine(
data_parallel=2)` over ["cpu", "cpu"] at batch 4 (each device call split
into two shards of 2, one a device) against the one-device engine at batch
2, the shard's, within rtol 1e-5 and atol 1e-6 (as the JAX package's
tests/test_serve.py holds its data-parallel engine; a one-device engine at
batch 4 runs G's cyclic pass at batch 20 where a shard runs it at 10, and
oneDNN's f32 convolutions then sum in another order: 1e-5 apart on outputs
of scale 2), and against the JAX engine with
data_parallel=2 on two of the conftest's virtual devices, within
tests/test_torch_serving.py's cross-framework tolerance; the fixed-size
path with the cyclic outputs, and the native path. Also the refusals (a
batch that the shards do not divide, too few devices) and the replicas'
refresh when the weights change.
"""

import numpy as np
import pytest
import torch
from test_torch_serving import _close, _configs, _images, _port, weights  # noqa: F401

from shmgan_tpu.serve import BatchInferenceEngine as JEngine
from shmgan_tpu_torch.infer import _Replicas, make_infer_fn
from shmgan_tpu_torch.serve import BatchInferenceEngine

DP_TOL = dict(rtol=1e-5, atol=1e-6)
NATIVE_SHAPES = [(40, 56), (40, 56), (32, 32), (40, 56), (20, 30)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(weights, **kw):  # noqa: F811
    """The port's one-device engine at batch 2, its two-device engine and the
    JAX two-device engine at batch 4, on one set of weights."""
    jcfg, cfg = _configs()
    one = BatchInferenceEngine(cfg, *_port(cfg, weights), batch_size=2, device="cpu", **kw)
    two = BatchInferenceEngine(cfg, *_port(cfg, weights), batch_size=4, device="cpu",
                               data_parallel=2, **kw)
    jax_two = JEngine(jcfg, *weights, batch_size=4, data_parallel=2, **kw)
    return one, two, jax_two


def test_dp_engine_matches_one_device_and_jax(weights):  # noqa: F811
    one, two, jax_two = _engines(weights, with_cyclic=True)
    rgb = _images(6, 32, 32, seed=31)   # one full call and one padded one
    want, got, jax_got = (e.process_images(rgb) for e in (one, two, jax_two))
    assert set(got) == set(want) == set(jax_got)
    # the JAX engine stacks each call's (5, 4, ...) cyc_rgb on axis 0, padding
    # and all: (10, 4, ...) for the two calls here
    chunks = jax_got["cyc_rgb"].reshape(2, 5, 4, 32, 32, 3)
    jax_got["cyc_rgb"] = np.concatenate(list(chunks), axis=1)[:, :6]
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, err_msg=k, **DP_TOL)
        _close(got[k], jax_got[k], k)
    assert got["cyc_rgb"].shape[:2] == (5, 6)
    one.close(), two.close()


def test_dp_native_matches_one_device_and_jax(weights):  # noqa: F811
    one, two, jax_two = _engines(weights, native_resolution=True)
    images = [_images(1, h, w, seed=40 + i)[0] for i, (h, w) in enumerate(NATIVE_SHAPES)]
    want, got, jax_got = (e.process_images_native(images) for e in (one, two, jax_two))
    assert len(got) == len(want) == len(jax_got) == len(images)
    for img, g, w, j in zip(images, got, want, jax_got):
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape[:2] == img.shape[:2], k
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **DP_TOL)
            _close(g[k], j[k], k)
    one.close(), two.close()


def test_dp_refusals(weights):  # noqa: F811
    _, cfg = _configs()
    gen, specseg = _port(cfg, weights)
    with pytest.raises(ValueError, match="must divide"):
        BatchInferenceEngine(cfg, gen, specseg, batch_size=3, data_parallel=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 devices visible"):
            make_infer_fn(cfg, data_parallel=2)
    with pytest.raises(ValueError, match="3 devices given"):
        make_infer_fn(cfg, data_parallel=2, devices=["cpu"] * 3)
    infer = make_infer_fn(cfg, data_parallel=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="batch 3 must divide data_parallel 2"):
        infer(gen, specseg, torch.from_numpy(_images(3, 32, 32, seed=1)))


def test_replicas_follow_the_weights(weights):  # noqa: F811
    """A replica on another device is made once, kept while the weights stay
    as they are, and made again after they change in place; the module's own
    device takes the module itself."""
    _, cfg = _configs()
    gen, _ = _port(cfg, weights)
    replicas, meta = _Replicas(), torch.device("meta")
    assert replicas.get(gen, torch.device("cpu")) is gen
    first = replicas.get(gen, meta)
    assert first is not gen and next(first.parameters()).device == meta
    assert replicas.get(gen, meta) is first
    with torch.no_grad():
        next(gen.parameters()).add_(1.0)
    assert replicas.get(gen, meta) is not first
