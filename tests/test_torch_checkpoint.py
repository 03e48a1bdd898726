"""The port's flax msgpack reader and writer (runtime/flax_msgpack.py) and its
inference bundles (checkpoint.py) against flax.serialization and the JAX
package's load_inference_bundle, on the CPU: the committed bundles leaf for
leaf, exactly; the writer's bytes identical to flax.serialization.to_bytes;
a bundle the port exports read by JAX's loader; flax's chunked form."""

import dataclasses
import json
import os

import flax
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shmgan_tpu.checkpoint import load_inference_bundle as j_load_inference_bundle
from shmgan_tpu.checkpoint import specseg_in_channels_of as j_specseg_in_channels_of
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.checkpoint import (export_inference_bundle, load_inference_bundle,
                                         model_config, specseg_in_channels_of)
from shmgan_tpu_torch.convert import flax_tree, load_inference_weights
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.runtime import flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLES = ["shmgan_infer.msgpack", "shmgan_infer_256.msgpack"]


def _flat(tree):
    return flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert isinstance(g, np.ndarray) == isinstance(w, (np.ndarray, jax.Array)), path
        if not isinstance(g, np.ndarray):
            assert type(g) is type(w) and g == w, path
            continue
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path


@pytest.fixture(scope="module", params=BUNDLES)
def bundle(request):
    path = os.path.join(REPO, "artifacts", request.param)
    return path, load_inference_bundle(path)


def test_reader_matches_jax_loader(bundle):
    path, (g_params, specseg_vars, header) = bundle
    jg, js, jheader = j_load_inference_bundle(path)
    assert header == jheader
    _assert_trees_equal(g_params, jg)
    _assert_trees_equal(specseg_vars, js)
    assert specseg_in_channels_of(specseg_vars) == j_specseg_in_channels_of(js) == 2


def test_export_reproduces_the_committed_bundle(bundle, tmp_path):
    """Read, filled into the port's modules, exported: the same bytes and
    header as the file (keys sorted as the JAX export leaves them)."""
    path, (g_params, specseg_vars, header) = bundle
    cfg = Config()
    cfg.model = model_config(cfg.model, header)
    gen, _, specseg = build_models(cfg, device="cpu")
    load_inference_weights(gen, specseg, g_params, specseg_vars)
    out = str(tmp_path / "copy.msgpack")
    export_inference_bundle(gen, specseg, cfg, out, header["step"], header["store_dtype"])
    with open(out, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()
    with open(out + ".json") as f:
        assert json.load(f) == header


def _sample_trees():
    rng = np.random.default_rng(0)
    return {
        "arrays": {"b": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                         "bias": rng.standard_normal(8).astype(np.float16)},
                   "a": {"idx": np.arange(300, dtype=np.int64).reshape(3, 100),
                         "flag": np.array([True, False]), "u8": np.arange(7, dtype=np.uint8),
                         "empty": np.zeros((0, 4), np.float32)}},
        "scalars": {"i": 5, "neg": -7, "n8": -100, "n16": -30000, "n32": -2 ** 31,
                    "u8": 200, "u16": 60000, "u32": 2 ** 31, "u64": 2 ** 40, "f": 1.25,
                    "t": True, "no": False, "none": None, "s": "x" * 40, "long": "y" * 300,
                    "np32": np.float32(3.5), "np64": np.float64(-2.0), "npi": np.int32(9),
                    "bytes": b"\x00\x01" * 200, "nested": {"deep": {"er": np.float16(1)}}},
        "wide": {f"k{i:03d}": np.full((2,), i, np.int16) for i in range(70)},
        "big_array": {"x": rng.standard_normal((70000,)).astype(np.float32)},
    }


@pytest.mark.parametrize("name", list(_sample_trees()))
def test_writer_bytes_equal_flax_to_bytes(name):
    tree = _sample_trees()[name]
    data = flax.serialization.to_bytes(tree)
    assert flax_msgpack.dumps(tree) == data
    _assert_trees_equal(flax_msgpack.loads(data), flax.serialization.msgpack_restore(data))


def test_chunked_arrays_read_back(monkeypatch):
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((5, 7, 9)).astype(np.float32),
            "small": np.arange(3, dtype=np.int32)}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_trees_equal(flax_msgpack.loads(data), tree)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    assert flax_msgpack.dumps(tree) == data


def test_bfloat16_leaves_read_as_float32():
    x = jnp.asarray(np.random.default_rng(2).standard_normal((4, 5)), jnp.bfloat16)
    data = flax.serialization.to_bytes({"x": np.asarray(x)})
    got = flax_msgpack.loads(data)["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


@pytest.mark.parametrize("store_dtype", [None, "float16"])
def test_jax_loader_reads_a_port_bundle(tmp_path, store_dtype):
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, image_size=32, filter_size=8,
                                    specseg_base_filters=4, specseg_in_channels=2,
                                    upsample_mode="resize_conv")
    gen, _, specseg = build_models(cfg, device="cpu", seed=4)
    path = str(tmp_path / "port.msgpack")
    export_inference_bundle(gen, specseg, cfg, path, 12, store_dtype)
    jg, js, header = j_load_inference_bundle(path)
    assert header["step"] == 12 and header["filter_size"] == 8
    assert header.get("store_dtype") == store_dtype
    cast = (lambda t: jax.tree_util.tree_map(lambda v: v.astype(np.float16).astype(np.float32), t)
            ) if store_dtype else (lambda t: t)
    params, batch_stats = flax_tree(specseg)
    _assert_trees_equal(jg, cast(flax_tree(gen)[0]))
    _assert_trees_equal(js, cast({"params": params, "batch_stats": batch_stats}))
    # and the port reads its own bundle back into equal modules
    g2, s2, h2 = load_inference_bundle(path)
    assert h2 == header
    _assert_trees_equal(g2, jg)


@pytest.mark.parametrize("cut", [1, 100, 5000])
def test_truncated_bundle_raises(cut):
    data = flax.serialization.to_bytes(_sample_trees()["arrays"])
    with pytest.raises(ValueError):
        flax_msgpack.loads(data[:-cut])
    with pytest.raises(ValueError):
        flax_msgpack.loads(data + b"\x00")


def test_store_dtype_the_writer_cannot_write_raises(tmp_path):
    """Floats are stored as float32, float16 or bfloat16 only (bfloat16
    bytes: tests/test_torch_cli_train.py); any other store dtype raises."""
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, filter_size=8, specseg_base_filters=4)
    gen, _, specseg = build_models(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="store_dtype"):
        export_inference_bundle(gen, specseg, cfg, str(tmp_path / "b"), 0, "int8")
    assert not (tmp_path / "b").exists()
