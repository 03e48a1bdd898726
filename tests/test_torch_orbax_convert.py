"""orbax_to_torch.py: the JAX package's Orbax train checkpoints converted
into the port's, on the CPU.

One JAX train state at filter 8, 128 px (the shapes of JAX's
`create_train_state` from its command line's flags, each leaf drawn from
numpy, both Adam states too, step 7) is saved by JAX's own
`CheckpointManager`, once without an EMA generator and once with one, as
tests/test_torch_cli_train.py saves its checkpoint. Each is converted with
the JAX command line's flags, and then:
  - the port's manager restores it leaf for leaf, dtype and bits, against
    JAX's own restore of the Orbax step (EMA included);
  - one further step from it in the port matches JAX's jitted step from
    JAX's restore, by tests/test_torch_train_step.py's tolerances (losses
    rtol 1e-5; parameters and EMA within 2 lr; D's noise, dropout and the
    flip off, the label and drops taken from JAX's step); the checkpoint
    without an EMA gets, on JAX's side, an EMA seeded from G, which moves
    nothing else in the step;
  - `cli --mode test` on it writes JAX's `--mode test` PNGs within one level
    and its metrics within rtol 1e-3.
An Orbax directory the port is pointed at raises with the converter's
command line.
"""

import dataclasses
import importlib.util
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shmgan_tpu.train.state as j_state_mod
from shmgan_tpu import cli as j_cli
from shmgan_tpu.checkpoint import CheckpointManager as JCheckpointManager
from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.train.step import make_train_step as j_make_train_step
from shmgan_tpu_torch import cli
from shmgan_tpu_torch.checkpoint import CheckpointManager
from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.convert import to_flax
from shmgan_tpu_torch.data.codecs import decode, encode_png
from shmgan_tpu_torch.data.synthetic import synth_eval_set
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.train.state import create_train_state, state_payload
from shmgan_tpu_torch.train.step import Draws, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                               os.path.join(REPO, "orbax_to_torch.py"))
orbax_to_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(orbax_to_torch)

SIZE, LR, STEP = 128, 2e-5, 7
CASES = ("no_ema", "ema")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_flags(ckpt):
    return ["--image_size", str(SIZE), "--filter_size", "8", "--batch_size", "2",
            "--compute_dtype", "float32", "--checkpoint_save_dir", ckpt]


def _seeded(shapes, seed):
    """Every float leaf drawn from numpy (BN variances positive, scales near
    1, Adam's nu positive and large against mu), every count the step."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if not jnp.issubdtype(s.dtype, jnp.floating):
            return np.full(s.shape, STEP, s.dtype)
        v = rng.standard_normal(s.shape).astype(np.float32)
        names = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        if "nu" in names:
            return (1e-2 * v * v + 1e-4).astype(np.float32)
        if "mu" in names:
            return 1e-3 * v
        if names[-1] == "var":
            return np.abs(v) + 0.5
        if names[-1] == "scale":
            return 1.0 + 0.1 * v
        return 0.1 * v

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _template(shapes):
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("orbax"))
    jcfg = JConfig.from_args(_model_flags(os.path.join(root, "unused")))
    shapes = jax.eval_shape(lambda: j_state_mod.create_train_state(jcfg, jax.random.PRNGKey(0)))
    state = _seeded(shapes, 11)
    ema = _seeded(shapes.g_params, 12)
    dirs = {}
    for case in CASES:
        src = os.path.join(root, case, "orbax")
        ckpt = JCheckpointManager(src)
        ckpt.save(jax.tree_util.tree_map(jnp.asarray, state.replace(
            ema_g_params=ema if case == "ema" else None)))
        ckpt.close()
        dst = os.path.join(root, case, "torch")
        assert orbax_to_torch.main(["--out", dst, *_model_flags(src)]) == [STEP]
        dirs[case] = (src, dst)

    inputs, truth, _ = synth_eval_set(2, SIZE, seed=3)
    for name, images in (("test", inputs), ("diffuse", truth)):
        os.makedirs(os.path.join(root, name))
        for i, img in enumerate(images):
            with open(os.path.join(root, name, f"img_{i:05d}.png"), "wb") as f:
                f.write(encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8)))
    return dict(root=root, shapes=shapes, dirs=dirs)


def _jax_restore(setup, case):
    src = setup["dirs"][case][0]
    ckpt = JCheckpointManager(src)
    try:
        return ckpt.restore(_template(setup["shapes"]), step=STEP, include_ema=True)
    finally:
        ckpt.close()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", CASES)
def test_port_restores_the_conversion_bit_for_bit(setup, case):
    cfg = Config.from_args(_model_flags(setup["dirs"][case][1]))
    state = create_train_state(cfg, build_models(cfg, device="cpu"))
    state = CheckpointManager(cfg.train.checkpoint_save_dir).restore(state, include_ema=True)
    assert state.step == STEP and (state.ema_g is not None) == (case == "ema")
    got = _flat(state_payload(state))
    want = _flat(flax.serialization.to_state_dict(
        jax.device_get(orbax_to_torch.payload_of(_jax_restore(setup, case)))))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def _step_configs(g_ema):
    jcfg = JConfig.from_args(_model_flags(""))
    jcfg.model = dataclasses.replace(jcfg.model, d_input_noise=0.0, d_dropout=0.0)
    jcfg.train = dataclasses.replace(jcfg.train, g_lr=LR, d_lr=LR, g_ema=0.9)
    jcfg.data = dataclasses.replace(jcfg.data, flip=False)
    cfg = Config()
    for section in ("model", "train", "data", "eval"):
        for f in dataclasses.fields(getattr(cfg, section)):
            setattr(getattr(cfg, section), f.name, getattr(getattr(jcfg, section), f.name))
    cfg.train = dataclasses.replace(cfg.train, g_ema=g_ema)
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_step():
    jcfg, _ = _step_configs(0.9)
    return jax.jit(j_make_train_step(jcfg, debug_grads=True))


@pytest.mark.parametrize("case", CASES)
def test_one_more_step_matches_jax(setup, jax_step, case):
    jstate = _jax_restore(setup, case)
    if jstate.ema_g_params is None:
        jstate = jstate.replace(ema_g_params=jax.tree_util.tree_map(jnp.copy, jstate.g_params))
    views = np.random.default_rng(1).random((5, 2, SIZE, SIZE, 3), np.float32)
    new, jm = jax_step(jstate, jnp.asarray(views), jax.random.PRNGKey(42),
                       jnp.zeros((), jnp.int32))

    _, cfg = _step_configs(0.9 if case == "ema" else 0.0)
    state = create_train_state(cfg, build_models(cfg, device="cpu"))
    state = CheckpointManager(setup["dirs"][case][1]).restore(state)
    draws = Draws(flip=torch.tensor(False), t=torch.tensor(np.asarray(jm["target_label"])),
                  drop=torch.tensor(np.asarray(jm["_drop"])))
    state, tm = make_train_step(cfg)(state, torch.from_numpy(views), draws, 0)

    assert state.step == int(new.step) == STEP + 1
    for k in (k for k in jm if not k.startswith("_")):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    pairs = [(state.gen, jstate.g_params, new.g_params, dict(state.gen.named_parameters())),
             (state.disc, jstate.d_params, new.d_params, dict(state.disc.named_parameters()))]
    if case == "ema":
        pairs.append((state.gen, jstate.g_params, new.ema_g_params, state.ema_g))
    else:
        assert state.ema_g is None
    for module, template, want, tensors in pairs:
        got = _flat(to_flax(module, template, tensors))
        for k, w in _flat(want).items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=2 * LR, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_cli_test_mode_matches_jax(setup, case):
    root = setup["root"]
    out = {}
    for side, ckpt in zip(("jax", "port"), setup["dirs"][case]):
        out[side] = os.path.join(root, case, f"results_{side}")
        argv = ["--mode", "test", "--test_dir", os.path.join(root, "test"),
                "--diffuse_dir", os.path.join(root, "diffuse"), "--calc_metrics", "true",
                "--result_dir", out[side], "--log_dir", os.path.join(root, case, "logs"),
                "--model_save_dir", os.path.join(root, case, "models"), *_model_flags(ckpt)]
        if side == "jax":
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_state_mod, "create_train_state",
                           lambda *a, **k: _template(setup["shapes"]))
                j_cli.main(argv)
        else:
            cli.main(argv, device="cpu")
    names = sorted(f for f in os.listdir(out["jax"]) if f.endswith(".png"))
    assert len(names) == 6
    assert sorted(f for f in os.listdir(out["port"]) if f.endswith(".png")) == names
    for name in names:
        with open(os.path.join(out["port"], name), "rb") as a, \
                open(os.path.join(out["jax"], name), "rb") as b:
            got, want = decode(a.read()).astype(int), decode(b.read()).astype(int)
        assert got.shape == want.shape == (SIZE, SIZE, 3), name
        assert np.abs(got - want).max() <= 1, name
    rows = {}
    for side, d in out.items():
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows[side] = [json.loads(line) for line in f]
    assert len(rows["port"]) == len(rows["jax"]) == 3
    for row, jrow in zip(rows["port"], rows["jax"]):
        flat, jflat = row.get("mean", row), jrow.get("mean", jrow)
        for k in set(jflat) - {"time", "image"}:
            np.testing.assert_allclose(flat[k], jflat[k], rtol=1e-3, err_msg=k)


def test_unconverted_orbax_raises_with_the_command(setup):
    src = setup["dirs"]["no_ema"][0]
    with pytest.raises(NotImplementedError, match="orbax_to_torch.py --checkpoint_save_dir"):
        CheckpointManager(src).latest_step()


def test_converter_step_flag_and_existing_steps(setup, tmp_path):
    src = setup["dirs"]["ema"][0]
    argv = ["--out", str(tmp_path / "one"), "--step", str(STEP), *_model_flags(src)]
    assert orbax_to_torch.main(argv) == [STEP]
    before = (tmp_path / "one" / str(STEP) / "state.msgpack").read_bytes()
    assert orbax_to_torch.main(argv) == []
    assert (tmp_path / "one" / str(STEP) / "state.msgpack").read_bytes() == before
    assert sorted(os.listdir(tmp_path / "one")) == [str(STEP)]
