"""The port's command line on a train checkpoint, against the JAX package's,
on the CPU: `--mode export` writes JAX's bundle bytes, `--mode test` (fixed
size, native resolution, and a folder of JPEG photos) writes JAX's PNGs and
metrics, serving without a
bundle restores the checkpoint, and `--mode train` runs.

One train state (the shape of JAX's `create_train_state`, each leaf drawn
from numpy, an EMA of G distinct from G, step 7; 32 px, filter 8, SpecSeg
base 16, f32) is checkpointed twice: by the JAX package's Orbax manager, and
by the port's manager from the same weights, converted. The port's directory
also holds a later step 9 on other weights, so `--checkpoint_step 7` is what
picks the step. JAX's `_restored_state` builds its template with
`create_train_state`, here from the same shapes (its own initialisation
compiles for tens of seconds on the CPU; the restore overwrites every leaf).

Tolerances: bundles byte for byte; PNGs within one 8-bit level (f32 on both
sides; a value on a rounding edge may round either way); metrics.jsonl's
values within rtol 1e-4 (measured: 6.1e-6 at worst at a fixed size, 1.4e-5
at native resolution), wall times left out.
"""

import dataclasses
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import shmgan_tpu.train.state as j_state_mod
from shmgan_tpu import cli as j_cli
from shmgan_tpu.checkpoint import CheckpointManager as JCheckpointManager
from shmgan_tpu.checkpoint import export_inference_bundle as j_export_inference_bundle
from shmgan_tpu.config import Config as JConfig
from shmgan_tpu_torch import cli
from shmgan_tpu_torch.checkpoint import CheckpointManager, load_inference_bundle
from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.convert import from_flax, load_flax
from shmgan_tpu_torch.data.codecs import decode, encode_png
from shmgan_tpu_torch.data.synthetic import synth_eval_set, write_fixture_tree
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.serve import BatchInferenceEngine
from shmgan_tpu_torch.train.state import create_train_state

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redraw(tree, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flax.traverse_util.flatten_dict(flax.core.unfreeze(tree)).items():
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        out[path] = (np.abs(v) + 0.5 if path[-1] == "var" else
                     1.0 + 0.1 * v if path[-1] == "scale" else 0.1 * v)
    return flax.traverse_util.unflatten_dict(out)


def _argv(root, mode, *extra):
    return ["--mode", mode, "--image_size", str(SIZE), "--filter_size", "8",
            "--batch_size", "2", "--compute_dtype", "float32",
            "--checkpoint_save_dir", os.path.join(root, "ckpt"),
            "--model_save_dir", os.path.join(root, "models"),
            "--result_dir", os.path.join(root, "results"),
            "--log_dir", os.path.join(root, "logs"), *extra]


def _port_state(cfg, jstate, ema=True):
    gen, disc, specseg = build_models(cfg, device="cpu")
    load_flax(gen, jstate.g_params)
    load_flax(disc, jstate.d_params)
    load_flax(specseg, jstate.specseg_vars["params"], jstate.specseg_vars["batch_stats"])
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             g_ema=0.9 if ema else 0.0))
    state = create_train_state(cfg, (gen, disc, specseg))
    if ema:
        state.ema_g = {k: torch.from_numpy(v)
                       for k, v in from_flax(gen, jstate.ema_g_params).items()}
    state.step = int(jstate.step)
    return state


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    jcfg = JConfig.from_args(_argv(os.path.join(root, "jax"), "test"))
    shapes = jax.eval_shape(lambda: j_state_mod.create_train_state(jcfg, jax.random.PRNGKey(0)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jstate = zeros.replace(step=np.asarray(7, np.int32), g_params=_redraw(shapes.g_params, 91),
                           d_params=_redraw(shapes.d_params, 92),
                           specseg_vars=_redraw(shapes.specseg_vars, 93),
                           ema_g_params=_redraw(shapes.g_params, 94))
    ckpt = JCheckpointManager(jcfg.train.checkpoint_save_dir)
    ckpt.save(jax.tree_util.tree_map(jnp.asarray, jstate))
    ckpt.close()

    cfg = Config.from_args(_argv(os.path.join(root, "port"), "test"))
    port_ckpt = CheckpointManager(cfg.train.checkpoint_save_dir)
    port_ckpt.save(_port_state(cfg, jstate))
    later = zeros.replace(step=np.asarray(9, np.int32), g_params=_redraw(shapes.g_params, 95),
                          d_params=_redraw(shapes.d_params, 96),
                          specseg_vars=_redraw(shapes.specseg_vars, 97))
    port_ckpt.save(_port_state(cfg, later, ema=False))

    # camera images of five scenes with highlights, and their diffuse truth
    inputs, truth, _ = synth_eval_set(5, SIZE, seed=3)
    for name, images in (("test", inputs), ("diffuse", truth)):
        os.makedirs(os.path.join(root, name))
        for i, img in enumerate(images):
            with open(os.path.join(root, name, f"img_{i:05d}.png"), "wb") as f:
                f.write(encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8)))
    os.makedirs(os.path.join(root, "test_jpeg"))
    for i, img in enumerate(inputs):      # the same inputs as JPEG photos, as PIL writes them
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, "test_jpeg", f"img_{i:05d}.jpg"), quality=90)
    return dict(root=root, jstate=jstate, shapes=shapes)


def _template(shapes):
    def create(cfg, rng, specseg_vars=None):
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return create


@pytest.mark.parametrize("export_dtype", ["", "float16"])
def test_export_writes_jax_bundle_bytes(setup, export_dtype):
    """--mode export of the port's checkpoint equals JAX's
    export_inference_bundle of the same state, with its EMA generator."""
    root, jstate = setup["root"], setup["jstate"]
    extra = ["--checkpoint_step", "7", "--export_dtype", export_dtype]
    cli.main(_argv(os.path.join(root, "port"), "export", *extra), device="cpu")
    jcfg = JConfig.from_args(_argv(os.path.join(root, "jax"), "export", *extra))
    path = os.path.join(root, f"jax_{export_dtype or 'f32'}.msgpack")
    j_export_inference_bundle(jstate.replace(g_params=jstate.ema_g_params, ema_g_params=None),
                              jcfg, path, store_dtype=export_dtype or None)
    ours = os.path.join(root, "port", "models", "shmgan_infer.msgpack")
    with open(ours, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    with open(ours + ".json") as a, open(path + ".json") as b:
        assert json.load(a) == json.load(b)


def test_export_bfloat16_raises(setup):
    """--export_dtype bfloat16 (the port rounds through torch to nearest
    even) writes the bytes of JAX's export_inference_bundle(store_dtype=
    "bfloat16") of the same state, as the f32 and float16 cases; the
    port's reader widens them back."""
    root, jstate = setup["root"], setup["jstate"]
    extra = ["--checkpoint_step", "7", "--export_dtype", "bfloat16"]
    cli.main(_argv(os.path.join(root, "port"), "export", *extra), device="cpu")
    jcfg = JConfig.from_args(_argv(os.path.join(root, "jax"), "export", *extra))
    path = os.path.join(root, "jax_bf16.msgpack")
    j_export_inference_bundle(jstate.replace(g_params=jstate.ema_g_params, ema_g_params=None),
                              jcfg, path, store_dtype="bfloat16")
    ours = os.path.join(root, "port", "models", "shmgan_infer.msgpack")
    with open(ours, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    with open(ours + ".json") as a, open(path + ".json") as b:
        assert json.load(a) == json.load(b)
    g_params, _, header = load_inference_bundle(ours)
    assert header["store_dtype"] == "bfloat16"
    assert all(v.dtype == np.float32
               for v in flax.traverse_util.flatten_dict(g_params).values())


@pytest.fixture(scope="module", params=["fixed", "native", "jpeg"])
def mode_runs(request, setup):
    """JAX's --mode test on its Orbax checkpoint and the port's on its own,
    both at step 7, with metrics against the diffuse truth; "jpeg" reads a
    folder of JPEG photos at the fixed size."""
    root = setup["root"]
    test_dir = "test_jpeg" if request.param == "jpeg" else "test"
    extra = ["--test_dir", os.path.join(root, test_dir),
             "--diffuse_dir", os.path.join(root, "diffuse"), "--calc_metrics", "true",
             "--checkpoint_step", "7", "--native_resolution",
             str(request.param == "native").lower()]
    out = {}
    for side in ("jax", "port"):
        argv = _argv(os.path.join(root, side), "test", *extra)
        i = argv.index("--result_dir") + 1
        argv[i] = os.path.join(argv[i], request.param)
        if side == "jax":
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_state_mod, "create_train_state", _template(setup["shapes"]))
                j_cli.main(argv)
        else:
            cli.main(argv, device="cpu")
        out[side] = argv[i]
    return out


def test_test_mode_pngs_match_jax(mode_runs):
    names = sorted(f for f in os.listdir(mode_runs["jax"]) if f.endswith(".png"))
    assert len(names) == 15
    assert sorted(f for f in os.listdir(mode_runs["port"]) if f.endswith(".png")) == names
    for name in names:
        with open(os.path.join(mode_runs["port"], name), "rb") as a, \
                open(os.path.join(mode_runs["jax"], name), "rb") as b:
            got, want = decode(a.read()).astype(int), decode(b.read()).astype(int)
        assert got.shape == want.shape == (SIZE, SIZE, 3), name
        assert np.abs(got - want).max() <= 1, name


def test_test_mode_metrics_match_jax(mode_runs):
    rows = {}
    for side, d in mode_runs.items():
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows[side] = [json.loads(line) for line in f]
    assert len(rows["port"]) == len(rows["jax"]) == 6
    for row, jrow in zip(rows["port"], rows["jax"]):
        assert list(row) == list(jrow)
        flat, jflat = row.get("mean", row), jrow.get("mean", jrow)
        for k in set(jflat) - {"time", "image"}:
            assert np.isfinite(flat[k]), k
            np.testing.assert_allclose(flat[k], jflat[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("use_ema", [True, False])
def test_serving_without_a_bundle_restores_the_checkpoint(setup, use_ema):
    root, jstate = setup["root"], setup["jstate"]
    cfg = Config.from_args(_argv(os.path.join(root, "port"), "serve", "--checkpoint_step",
                                 "7", "--use_ema", str(use_ema).lower()))
    gen, specseg = cli.serving_models(cfg, device="cpu")
    want = from_flax(gen, jstate.ema_g_params if use_ema else jstate.g_params)
    for name, p in gen.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name], err_msg=name)
    out = BatchInferenceEngine(cfg, gen, specseg, batch_size=2, device="cpu").process_images(
        synth_eval_set(1, SIZE, seed=4)[0])
    assert out["gen_rgb_calibrated"].shape == (1, SIZE, SIZE, 3)
    assert np.isfinite(out["gen_rgb_calibrated"]).all()


def test_latest_step_is_the_default(setup):
    cfg = Config.from_args(_argv(os.path.join(setup["root"], "port"), "serve"))
    state = cli._restored_state(cfg, device="cpu")
    assert state.step == 9 and state.ema_g is None


def test_train_mode_runs_and_writes_its_files(tmp_path):
    root = str(tmp_path)
    write_fixture_tree(os.path.join(root, "tree"), 4, SIZE, seed=5)
    cli.main(_argv(root, "train", "--data_dir", os.path.join(root, "tree"), "--num_epochs",
                   "2", "--checkpoint_save_step", "1", "--filter_size", "4"), device="cpu")
    assert CheckpointManager(os.path.join(root, "ckpt")).all_steps() == [2, 4]
    with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 3]
    assert sorted(os.listdir(os.path.join(root, "models", "summaries"))) == [
        "Discriminator_summary.txt", "Generator_summary.txt", "SpecSeg_summary.txt"]


def test_bench_and_cardless_entry_points_raise(setup):
    argv = _argv(os.path.join(setup["root"], "port"), "bench")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        cli.main(argv, device="cpu")
    if torch.cuda.is_available():
        return
    for mode in ("train", "test", "export", "serve"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(_argv(os.path.join(setup["root"], "port"), mode))
