"""The reference's Keras SpecSeg h5 in the port, on the CPU, against the JAX
package's `load_specseg_h5`.

Keras files are written by h5py in each of the three layouts the loader
reads (Keras 2's full-model save, the reference's; Keras 2's save_weights;
Keras 3's `layers/<layer>/vars/<i>`) by tests/data/torch_h5/make_fixtures.py
from a seeded SpecSeg tree at base 4. The port's `load_specseg_weights`
equals JAX's loader leaf for leaf, dtype and bits, and the tree it was
written from; the port's SpecSeg on it matches JAX's forward within 1e-5
(f32, both on the CPU, other sum orders). The committed full-width fixture
reads the same in both loaders and as its README states (sha256, each
leaf's shape and exact sums). `cli --mode train` with `--specseg_weights`
on the fixture takes one step at filter 8, 128 px and keeps the file's
SpecSeg bit for bit in its checkpoint; `--mode export` puts it in the
bundle.
"""

import hashlib
import importlib.util
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shmgan_tpu.checkpoint import load_specseg_h5 as j_load_specseg_h5
from shmgan_tpu.models.specseg import SpecSeg as JSpecSeg
from shmgan_tpu_torch import cli
from shmgan_tpu_torch.checkpoint import load_inference_bundle, load_specseg_weights
from shmgan_tpu_torch.convert import load_flax
from shmgan_tpu_torch.data.synthetic import write_fixture_tree
from shmgan_tpu_torch.models.specseg import SpecSeg
from shmgan_tpu_torch.runtime import flax_msgpack

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "data", "torch_h5")
FIXTURE = os.path.join(FIXTURE_DIR, "specseg_keras2.h5")

_spec = importlib.util.spec_from_file_location(
    "torch_h5_fixtures", os.path.join(FIXTURE_DIR, "make_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _bit_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert g[k].tobytes() == w[k].tobytes(), k


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """The seeded base-4 tree and its h5 in each layout."""
    root = tmp_path_factory.mktemp("keras")
    tree = fixtures.seeded_vars(4, 1, seed=5)
    paths = {}
    for layout in fixtures.LAYOUTS:
        paths[layout] = str(root / f"specseg_{layout}.h5")
        fixtures.write_keras_h5(paths[layout], tree, layout)
    return tree, paths


@pytest.mark.parametrize("layout", fixtures.LAYOUTS)
def test_load_matches_jax_bit_for_bit(narrow, layout):
    tree, paths = narrow
    got = load_specseg_weights(paths[layout])
    _bit_equal(got, j_load_specseg_h5(paths[layout]))
    _bit_equal(got, tree)


@pytest.mark.parametrize("layout", fixtures.LAYOUTS)
def test_forward_on_the_h5_matches_jax(narrow, layout):
    _, paths = narrow
    variables = load_specseg_weights(paths[layout])
    x = np.random.default_rng(8).random((2, 32, 32, 1), np.float32)
    net = SpecSeg(base_filters=4, in_channels=1).eval()
    load_flax(net, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = JSpecSeg(base_filters=4, dtype=jnp.float32).apply(
        j_load_specseg_h5(paths[layout]), jnp.asarray(x), train=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_missing_layer_raises_naming_it(narrow, tmp_path):
    _, paths = narrow
    path = str(tmp_path / "cut.h5")
    with h5py.File(paths["keras2_model"], "r") as src, h5py.File(path, "w") as dst:
        group = dst.create_group("model_weights")
        for name in src["model_weights"]:
            if name != "conv2d_18":
                src.copy(src["model_weights"][name], group, name)
    with pytest.raises(KeyError, match="conv2d_18"):
        load_specseg_weights(path)


def test_committed_fixture_matches_jax_and_its_readme():
    with open(os.path.join(FIXTURE_DIR, "README.md")) as f:
        readme = f.read()
    with open(FIXTURE, "rb") as f:
        assert f"sha256 `{hashlib.sha256(f.read()).hexdigest()}`" in readme
    got = load_specseg_weights(FIXTURE)
    _bit_equal(got, j_load_specseg_h5(FIXTURE))
    sums = fixtures.leaf_sums(got)
    assert sum(int(np.prod(s)) for s, _, _ in sums.values()) == 1_942_801
    for leaf, (shape, s1, s2) in sums.items():
        assert f"| {leaf} | {shape} | {s1!r} | {s2!r} |" in readme, leaf


def test_cli_train_and_export_keep_the_h5_specseg(tmp_path):
    """One step at filter 8, 128 px: the checkpoint's and the bundle's
    SpecSeg are the file's, bit for bit (loaded, then frozen)."""
    tree = str(tmp_path / "tree")
    write_fixture_tree(tree, 2, 128, seed=4)

    def argv(mode, *extra):
        return ["--mode", mode, "--data_dir", tree, "--image_size", "128",
                "--filter_size", "8", "--batch_size", "2", "--compute_dtype", "float32",
                "--specseg_weights", FIXTURE, "--checkpoint_save_step", "1",
                "--checkpoint_save_dir", str(tmp_path / "ckpt"),
                "--log_dir", str(tmp_path / "logs"), "--model_save_dir", str(tmp_path / "models"),
                "--result_dir", str(tmp_path / "results"), *extra]

    cli.main(argv("train", "--num_epochs", "1"), device="cpu")
    want = load_specseg_weights(FIXTURE)
    with open(tmp_path / "ckpt" / "1" / "state.msgpack", "rb") as f:
        saved = flax_msgpack.loads(f.read())
    assert int(saved["step"]) == 1
    _bit_equal(saved["specseg_vars"], want)
    cli.main(argv("export"), device="cpu")
    _, specseg_vars, header = load_inference_bundle(str(tmp_path / "models" / "shmgan_infer.msgpack"))
    assert header["specseg_in_channels"] == 1 and header["step"] == 1
    _bit_equal(specseg_vars, want)
