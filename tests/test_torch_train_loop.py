"""The port's training driver against the JAX package's on the CPU: the epoch
loop (train/loop.py), its checkpoints (checkpoint.CheckpointManager), the
polarimetric dataset and its feed, and the numpy scene source.

One JAX `train(jcfg, max_steps=3)` on a 4-scene, 32-px tree at batch 2 takes
epoch 0's two steps, then one step of epoch 1, with checkpoints at steps 2
and 3, shuffle on. Its state starts from seeded weights (the shape of
`create_train_state`, each leaf drawn from numpy, the optimizer state zero,
as tests/test_torch_bf16.py builds it: JAX's own initialisation compiles for
tens of seconds here). Its step is `make_train_step(jcfg, debug_grads=True)`,
from which a debug callback reads each step's label t and drop pattern. The
port's `train` runs the same 3 steps from the same weights, converted, with
those draws injected. Filter 8, SpecSeg base 4, f32, flip off, D's noise and
dropout off, torch on one thread, as tests/test_torch_train_step.py.

Tolerances:
  - every parameter within 3 x the step test's 2 * lr (three Adam steps,
    each moving a leaf by about lr at most, whatever the sign of a
    near-zero gradient);
  - the metrics.jsonl rows at the same steps with the same keys, each value
    within rtol 1e-5, the step test's loss tolerance; the row of step 3, two
    updates on, with atol 1e-6 beside it: its weights are no longer JAX's
    bit for bit, and SSIM_loss, -log((1 + s) / 2) of an SSIM near 1, is
    about 0.03, so an SSIM that moved by 1e-6 moves it by 4e-5 relative
    (measured: every other value within 3e-6 relative at step 3, and within
    1.1e-6 at step 1);
  - the batches each loop's step was fed, in order, equal;
  - the checkpoint read back by flax.serialization exactly, leaf for leaf.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import signal

import flax
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shmgan_tpu.train.loop as j_loop
from shmgan_tpu.checkpoint import save_specseg_msgpack as j_save_specseg_msgpack
from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.data import synthetic as j_synthetic
from shmgan_tpu.data.loader import PolarimetricDataset as JPolarimetricDataset
from shmgan_tpu.data.loader import SingleFolderDataset as JSingleFolderDataset
from shmgan_tpu.train.state import create_train_state as j_create_train_state
from shmgan_tpu.train.step import make_train_step as j_make_train_step
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.checkpoint import CheckpointManager, load_specseg_weights
from shmgan_tpu_torch.convert import load_flax, to_flax
from shmgan_tpu_torch.data import synthetic
from shmgan_tpu_torch.data.loader import PolarimetricDataset, SingleFolderDataset
from shmgan_tpu_torch.data.pipeline import DevicePrefetcher
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.parallel.mesh import Mesh, training_mesh
from shmgan_tpu_torch.train.loop import train
from shmgan_tpu_torch.train.state import create_train_state, state_payload
from shmgan_tpu_torch.train.step import Draws

LR = 2e-5
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(root, **train):
    """The JAX config and the port's copy of it, their directories under root."""
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(jcfg.model, image_size=SIZE, filter_size=8,
                                     specseg_base_filters=4, d_input_noise=0.0,
                                     d_dropout=0.0, compute_dtype="float32")
    jcfg.train = dataclasses.replace(jcfg.train, **{
        "batch_size": 2, "g_lr": LR, "d_lr": LR, "num_epochs": 2, "checkpoint_save_step": 1,
        "checkpoint_save_dir": os.path.join(root, "ckpt"), "log_dir": os.path.join(root, "logs"),
        "model_save_dir": os.path.join(root, "models"),
        "result_dir": os.path.join(root, "results"), **train})
    jcfg.data = dataclasses.replace(jcfg.data, flip=False,
                                    data_dir=os.path.join(os.path.dirname(root), "tree"))
    jcfg.mesh = dataclasses.replace(jcfg.mesh, data_parallel=1)
    cfg = Config()
    for section in ("model", "train", "data", "eval", "mesh"):
        for f in dataclasses.fields(getattr(cfg, section)):
            setattr(getattr(cfg, section), f.name, getattr(getattr(jcfg, section), f.name))
    return jcfg, cfg


def _redraw(tree, seed, scale=1.0):
    """Every leaf of a shape tree drawn from a numpy seed (variances positive,
    scales near 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flax.traverse_util.flatten_dict(flax.core.unfreeze(tree)).items():
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        out[path] = (np.abs(v) + 0.5 if path[-1] == "var" else
                     1.0 + 0.1 * v if path[-1] == "scale" else 0.1 * scale * v)
    return flax.traverse_util.unflatten_dict(out)


def _seeded_jax_state(jcfg):
    shapes = jax.eval_shape(lambda: j_create_train_state(jcfg, jax.random.PRNGKey(0)))
    state = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return state.replace(g_params=_redraw(shapes.g_params, 81),
                         d_params=_redraw(shapes.d_params, 82, 0.5),
                         specseg_vars=_redraw(shapes.specseg_vars, 83))


def _port_models(cfg, jstate):
    gen, disc, specseg = build_models(cfg, device="cpu")
    load_flax(gen, jstate.g_params)
    load_flax(disc, jstate.d_params)
    load_flax(specseg, jstate.specseg_vars["params"], jstate.specseg_vars["batch_stats"])
    return gen, disc, specseg


class _Recorded:
    """A dataset whose epochs record each batch they yield."""

    def __init__(self, ds):
        self.ds, self.batches = ds, []

    def __len__(self):
        return len(self.ds)

    @property
    def batches_per_epoch(self):
        return self.ds.batches_per_epoch

    def iter_epoch(self, **kw):
        for batch in self.ds.iter_epoch(**kw):
            self.batches.append(np.array(batch))
            yield batch


def _logged(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return result, out.getvalue()


def _rows(cfg, evals=False):
    """The metrics.jsonl rows of the train steps, or with evals those of
    the held-out eval."""
    with open(os.path.join(cfg.train.log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if any(k.startswith("eval/") for k in r) == evals]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loop"))
    j_synthetic.write_fixture_tree(os.path.join(root, "tree"), 4, SIZE, seed=0)
    return root


@pytest.fixture(scope="module")
def runs(tree):
    """The JAX loop and the port's on one tree, weights and draws; then each
    resumed from its last checkpoint with num_epochs 1 (no step left)."""
    jcfg, cfg = _configs(os.path.join(tree, "jax"), shuffle=True)
    jstate0 = _seeded_jax_state(jcfg)
    draws = []

    def spy_step(c):
        inner = j_make_train_step(c, debug_grads=True)

        def step(state, views, rng, epoch):
            state, m = inner(state, views, rng, epoch)
            jax.debug.callback(lambda t, d: draws.append((np.asarray(t), np.asarray(d))),
                               m["target_label"], m["_drop"], ordered=True)
            return state, {k: v for k, v in m.items() if not k.startswith("_")}
        return step

    jds = _Recorded(JPolarimetricDataset(jcfg.data, SIZE, 2))
    held_out = dict(zip(("eval_inputs", "eval_targets"),
                        j_synthetic.synth_eval_set(2, SIZE, seed=5)[:2]), eval_every_epochs=1)
    with pytest.MonkeyPatch.context() as mp:
        # a fresh device copy each time: the loop's step donates its state
        mp.setattr(j_loop, "create_train_state",
                   lambda *a, **k: jax.tree_util.tree_map(jnp.array, jstate0))
        mp.setattr(j_loop, "make_train_step", spy_step)
        jstate, jlog = _logged(lambda: j_loop.train(jcfg, dataset=jds, max_steps=3,
                                                    **held_out))
        jax.effects_barrier()
        _, jlog_resume = _logged(lambda: j_loop.train(
            dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, num_epochs=1)),
            dataset=jds, max_steps=3))

    _, cfg = _configs(os.path.join(tree, "port"), shuffle=True)
    pds = _Recorded(PolarimetricDataset(cfg.data, SIZE, 2))

    def injected(step, shape):
        t, drop = draws[step]
        return Draws(flip=torch.tensor(False), t=torch.tensor(t), drop=torch.tensor(drop))

    state, log = _logged(lambda: train(cfg, dataset=pds, max_steps=3, device="cpu",
                                       models=_port_models(cfg, jstate0), draws=injected,
                                       **held_out))
    resumed = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_epochs=1))
    _, log_resume = _logged(lambda: train(resumed, dataset=pds, device="cpu"))
    return dict(jcfg=jcfg, cfg=cfg, jstate0=jstate0, jstate=jstate, jds=jds, jlog=jlog,
                jlog_resume=jlog_resume, state=state, pds=pds, log=log,
                log_resume=log_resume, draws=draws)


def _flat(tree):
    return flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))


@pytest.mark.parametrize("net", ["G", "D"])
def test_loop_params_match_jax(runs, net):
    state, jstate, jstate0 = runs["state"], runs["jstate"], runs["jstate0"]
    module = state.gen if net == "G" else state.disc
    old = jstate0.g_params if net == "G" else jstate0.d_params
    want = _flat(jstate.g_params if net == "G" else jstate.d_params)
    got = _flat(to_flax(module, old, dict(module.named_parameters())))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], np.asarray(w), rtol=0, atol=3 * 2 * LR,
                                   err_msg=str(path))
    assert state.step == int(jstate.step) == 3 and len(runs["draws"]) == 3


def test_loop_metrics_rows_match_jax(runs):
    jrows, rows = _rows(runs["jcfg"]), _rows(runs["cfg"])
    assert [r["step"] for r in rows] == [r["step"] for r in jrows] == [1, 3]
    for row, jrow in zip(rows, jrows):
        assert set(row) == set(jrow)
        atol = 0.0 if row["step"] == 1 else 1e-6
        for k in set(jrow) - {"step", "time"}:
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-5, atol=atol, err_msg=k)


def test_loop_eval_rows_match_jax(runs):
    """eval_inputs / eval_targets every epoch: the eval/* means of the
    calibrated inference output, at steps 2 and 3, against JAX's, within
    rtol 1e-4, the tolerance of --mode test's metrics in
    tests/test_torch_cli_train.py (measured: 4e-6 at worst)."""
    jrows, rows = _rows(runs["jcfg"], evals=True), _rows(runs["cfg"], evals=True)
    assert [r["step"] for r in rows] == [r["step"] for r in jrows] == [2, 3]
    for row, jrow in zip(rows, jrows):
        assert set(row) == set(jrow) and len(row) == 7
        for k in set(jrow) - {"step", "time"}:
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4, err_msg=k)


def test_loop_batch_order_matches_jax(runs):
    jb, pb = runs["jds"].batches[:3], runs["pds"].batches[:3]
    assert len(jb) == len(pb) == 3
    for a, b in zip(jb, pb):
        np.testing.assert_array_equal(a, b)
    # shuffled: epoch 0 is not the file order
    in_order = np.stack(list(JPolarimetricDataset(runs["jcfg"].data, SIZE, 4).iter_epoch()))
    assert not np.array_equal(np.concatenate(jb[:2], axis=1), in_order[0])


def test_resume_start_epoch_matches_jax(runs):
    want = re.search(r"\[ckpt\] restored step (\d+) \(epoch (\d+)\)", runs["jlog_resume"])
    got = re.search(r"\[ckpt\] restored step (\d+) \(epoch (\d+)\)", runs["log_resume"])
    assert want and got and got.groups() == want.groups() == ("3", "1")
    assert "restored" not in runs["log"] and "restored" not in runs["jlog"]


def test_checkpoint_steps_match_jax(runs):
    jsteps = sorted(int(d) for d in os.listdir(runs["jcfg"].train.checkpoint_save_dir)
                    if d.isdigit())
    assert CheckpointManager(runs["cfg"].train.checkpoint_save_dir).all_steps() == jsteps == [2, 3]


def test_flax_reads_the_port_checkpoint(runs):
    """flax.serialization.from_bytes onto the JAX package's checkpoint payload
    (its Orbax tree) restores the port's checkpoint leaf for leaf."""
    j = runs["jstate0"]
    template = {"step": j.step, "g_params": j.g_params, "d_params": j.d_params,
                "specseg_vars": j.specseg_vars, "g_opt_state": j.g_opt_state,
                "d_opt_state": j.d_opt_state}
    path = os.path.join(runs["cfg"].train.checkpoint_save_dir, "3", "state.msgpack")
    with open(path, "rb") as f:
        restored = flax.serialization.from_bytes(template, f.read())
    assert type(restored["g_opt_state"][1]).__name__ == "ScaleByAdamState"
    flat_want = _flat(state_payload(runs["state"]))
    flat_got = _flat(flax.serialization.to_state_dict(restored))
    assert sorted(flat_want) == sorted(flat_got)
    for path, w in flat_want.items():
        g = np.asarray(flat_got[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert int(restored["step"]) == 3 and int(restored["g_opt_state"][1].count) == 3


def test_second_resume_is_deterministic(runs, tmp_path):
    """Two runs resumed from one checkpoint (default draws, from the seed and
    the step resumed at) end on identical weights."""
    finals = []
    for k in range(2):
        cfg = copy_cfg(runs["cfg"], str(tmp_path / str(k)), num_epochs=2)
        shutil.copytree(runs["cfg"].train.checkpoint_save_dir, cfg.train.checkpoint_save_dir)
        state = train(cfg, dataset=PolarimetricDataset(cfg.data, SIZE, 2), device="cpu",
                      verbose=False)
        assert state.step == 5
        finals.append(state_payload(state))
    for path, a in _flat(finals[0]).items():
        np.testing.assert_array_equal(a, _flat(finals[1])[path], err_msg=str(path))


def copy_cfg(cfg, root, **train_kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_save_dir=os.path.join(root, "ckpt"),
        log_dir=os.path.join(root, "logs"), model_save_dir=os.path.join(root, "models"),
        **train_kw))


# ------------------------------------------------------------ checkpoints alone

def _small_state(g_ema=0.0, seed=0):
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, image_size=SIZE, filter_size=4,
                                    specseg_base_filters=4, compute_dtype="float32")
    cfg.train = dataclasses.replace(cfg.train, g_ema=g_ema)
    return create_train_state(cfg, build_models(cfg, device="cpu", seed=seed))


def test_max_to_keep_and_idempotent_save(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    state = _small_state()
    for step in range(1, 5):
        assert ckpt.save(state, step=step) == step
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    path = tmp_path / "4" / "state.msgpack"
    before = (path.stat().st_mtime_ns, path.read_bytes())
    assert ckpt.save(_small_state(seed=1), step=4) == 4
    assert (path.stat().st_mtime_ns, path.read_bytes()) == before
    assert not [d for d in os.listdir(tmp_path) if not d.isdigit()]


@pytest.mark.parametrize("case", ["ema_ckpt_no_ema_run", "no_ema_ckpt_ema_run",
                                  "ema_ckpt_include_ema", "ema_ckpt_ema_run"])
def test_restore_ema_cases(tmp_path, case):
    """checkpoint.py:82-121's four cases: an EMA checkpoint read without
    EMA drops it; an EMA run over a checkpoint without one starts it from
    the restored G; include_ema, or an EMA run, reads the checkpoint's."""
    saved_ema = case != "no_ema_ckpt_ema_run"
    saved = _small_state(g_ema=0.9 if saved_ema else 0.0, seed=3)
    saved.step = 7
    if saved_ema:
        saved.ema_g = {k: v + 0.25 for k, v in saved.ema_g.items()}
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(saved)
    assert ckpt.has_key(7, "ema_g_params") == saved_ema and ckpt.has_key(7, "g_params")
    run_ema = case in ("no_ema_ckpt_ema_run", "ema_ckpt_ema_run")
    state = ckpt.restore(_small_state(g_ema=0.9 if run_ema else 0.0, seed=4),
                         include_ema=case == "ema_ckpt_include_ema")
    assert state.step == 7
    for p, q in zip(state.gen.parameters(), saved.gen.parameters()):
        assert torch.equal(p, q)
    if case == "ema_ckpt_no_ema_run":
        assert state.ema_g is None
    elif case == "no_ema_ckpt_ema_run":
        for k, p in state.gen.named_parameters():
            assert torch.equal(state.ema_g[k], p) and state.ema_g[k] is not p
    else:
        for k, v in saved.ema_g.items():
            assert torch.equal(state.ema_g[k], v)


def test_optimizer_state_round_trips(tmp_path):
    saved = _small_state(seed=5)
    for opt in (saved.g_opt, saved.d_opt):
        for m in opt.mu + opt.nu:
            m.uniform_(0.0, 1.0)
        opt.count = 11
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(saved, step=11)
    state = ckpt.restore(_small_state(seed=6))
    for a, b in ((state.g_opt, saved.g_opt), (state.d_opt, saved.d_opt)):
        assert a.count == 11 and a.names == b.names
        assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))


def test_orbax_directory_raises(runs):
    ckpt = CheckpointManager(runs["jcfg"].train.checkpoint_save_dir)
    with pytest.raises(NotImplementedError, match="Orbax.*orbax_to_torch.py"):
        ckpt.latest_step()
    with pytest.raises(NotImplementedError):
        ckpt.restore(_small_state())


def test_specseg_weights(tmp_path):
    """A SpecSeg .msgpack of the JAX package loads leaf for leaf; an .h5
    goes to the Keras reader, which raises on a missing file as h5py does
    (tests/test_torch_keras_h5.py reads real ones)."""
    jcfg = _configs(str(tmp_path))[0]
    shapes = jax.eval_shape(lambda: j_create_train_state(jcfg, jax.random.PRNGKey(0)))
    ss = _redraw(shapes.specseg_vars, 9)
    path = str(tmp_path / "ss.msgpack")
    j_save_specseg_msgpack(ss, path)
    got = load_specseg_weights(path)
    assert sorted(_flat(got)) == sorted(_flat(ss))
    for k, v in _flat(ss).items():
        np.testing.assert_array_equal(_flat(got)[k], v)
    with pytest.raises(FileNotFoundError):
        load_specseg_weights(str(tmp_path / "specsegv3_chkpt.h5"))


# ------------------------------------------------------------------ preemption

class _Signalling:
    """A dataset that sends SIGTERM to this process when its epoch is asked
    for a 4th batch. With a prefetch depth of 1 the feed runs one batch
    ahead of the step, so that happens once the step has taken the 2nd
    batch: the guard's flag is up while step 2 runs, whatever the threads'
    timing."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    @property
    def batches_per_epoch(self):
        return self.ds.batches_per_epoch

    def iter_epoch(self, **kw):
        for i, batch in enumerate(self.ds.iter_epoch(**kw)):
            if i == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def test_sigterm_checkpoints_at_the_step_reached(tmp_path):
    root = str(tmp_path)
    synthetic.write_fixture_tree(os.path.join(root, "tree"), 8, SIZE, seed=1)
    _, cfg = _configs(os.path.join(root, "run"), num_epochs=5)
    cfg.model.filter_size = 4
    cfg.data.prefetch = 1
    prev = signal.getsignal(signal.SIGTERM)
    state, log = _logged(lambda: train(
        cfg, dataset=_Signalling(PolarimetricDataset(cfg.data, SIZE, 2)), device="cpu"))
    assert signal.getsignal(signal.SIGTERM) is prev
    assert state.step == 2 and "[preempt] signal received" in log
    assert CheckpointManager(cfg.train.checkpoint_save_dir).all_steps() == [2]


# ----------------------------------------------------------------- the data path

def test_scenes_bit_identical_to_jax():
    for seed in (0, 7):
        a = synthetic.synth_polar_scene(np.random.default_rng(seed), 24, 40)
        b = j_synthetic.synth_polar_scene(np.random.default_rng(seed), 24, 40)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(synthetic.camera_image(a[1], a[0]),
                                      j_synthetic.camera_image(b[1], b[0]))
    for x, y in zip(synthetic.synth_eval_set(3, 32, seed=2),
                    j_synthetic.synth_eval_set(3, 32, seed=2)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ed_mode", ["min", "diffuse"])
def test_fixture_tree_decodes_like_jax(tmp_path, ed_mode):
    """The port's tree holds the JAX package's pixels, file for file, through
    either package's decoder."""
    from shmgan_tpu.data.loader import decode_resize as j_decode_resize
    from shmgan_tpu_torch.data.loader import decode_resize

    synthetic.write_fixture_tree(str(tmp_path / "port"), 3, SIZE, seed=4, ed_mode=ed_mode)
    j_synthetic.write_fixture_tree(str(tmp_path / "jax"), 3, SIZE, seed=4, ed_mode=ed_mode)
    for view in ("I0", "I45", "I90", "I135", "ED"):
        names = sorted(os.listdir(tmp_path / "jax" / view))
        assert sorted(os.listdir(tmp_path / "port" / view)) == names
        for name in names:
            want = j_decode_resize(str(tmp_path / "jax" / view / name), SIZE)
            np.testing.assert_array_equal(
                decode_resize(str(tmp_path / "port" / view / name), SIZE), want)
            np.testing.assert_array_equal(
                j_decode_resize(str(tmp_path / "port" / view / name), SIZE), want)


@pytest.mark.parametrize("case", ["ed", "ed_synthesized", "psd_naming", "shuffle_uncached"])
def test_polarimetric_dataset_matches_jax(tmp_path, case):
    psd = case == "psd_naming"
    dirs = ("I0", "I60", "I90", "I150", "ED") if psd else ("I0", "I45", "I90", "I135", "ED")
    synthetic.write_fixture_tree(str(tmp_path), 5, 24, seed=6, view_dirs=dirs,
                                 write_ed=case != "ed_synthesized")
    jcfg, cfg = _configs(str(tmp_path / "run"))
    for c in (jcfg, cfg):
        c.data = dataclasses.replace(c.data, data_dir=str(tmp_path), use_psd_naming=psd,
                                     cache_in_memory=case != "shuffle_uncached")
    seed = 12 if case == "shuffle_uncached" else None
    want = list(JPolarimetricDataset(jcfg.data, SIZE, 2).iter_epoch(shuffle_seed=seed))
    ds = PolarimetricDataset(cfg.data, SIZE, 2)
    got = list(ds.iter_epoch(shuffle_seed=seed))
    assert len(ds) == 5 and ds.batches_per_epoch == 2 and len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.shape == (5, 2, SIZE, SIZE, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # each of two processes takes its half of every global batch
    halves = [list(ds.iter_epoch(shuffle_seed=seed, process_index=p, process_count=2))
              for p in range(2)]
    for b, (h0, h1) in enumerate(zip(*halves)):
        np.testing.assert_array_equal(np.concatenate([h0, h1], axis=1), want[b])


def test_missing_ed_without_estimate_raises(tmp_path):
    synthetic.write_fixture_tree(str(tmp_path), 2, 16, write_ed=False)
    _, cfg = _configs(str(tmp_path / "run"))
    cfg.data = dataclasses.replace(cfg.data, data_dir=str(tmp_path), est_diffuse=False)
    with pytest.raises(FileNotFoundError):
        PolarimetricDataset(cfg.data, SIZE, 2)


@pytest.mark.parametrize("size", [24, None])
def test_single_folder_dataset_matches_jax(tmp_path, size):
    synthetic.write_fixture_tree(str(tmp_path), 5, SIZE, seed=8)
    folder = str(tmp_path / "I45")
    want = list(JSingleFolderDataset(folder, size, batch_size=2))
    got = list(SingleFolderDataset(folder, size, batch_size=2))
    assert len(got) == len(want) == (3 if size else 5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_prefetcher_yields_in_order_and_raises_the_workers_error():
    batches = [np.full((2, 3), i, np.float32) for i in range(5)]
    got = [t.numpy() for t in DevicePrefetcher(iter(batches), device="cpu", depth=2)]
    assert [int(b[0, 0]) for b in got] == list(range(5))

    def failing():
        yield batches[0]
        raise OSError("unreadable file")

    feed = DevicePrefetcher(failing(), device="cpu", depth=1)
    assert int(next(feed)[0, 0]) == 0
    with pytest.raises(OSError, match="unreadable file"):
        next(feed)


def test_prefetcher_close_stops_a_worker_that_is_ahead():
    feed = DevicePrefetcher(iter([np.zeros(1, np.float32)] * 100), device="cpu", depth=1)
    next(feed)
    feed.close(timeout=10.0)
    assert not feed._thread.is_alive()


def test_entry_points_need_a_card_or_the_cpu(tree):
    """Without CUDA, train raises unless device="cpu"; a layout the port
    cannot run here raises rather than run on one device: data parallelism
    or a model axis, channels or spatial, without a launcher's process
    group. Spatial sharding over a model axis of one rank is the plain
    layout."""
    _, cfg = _configs(os.path.join(tree, "nocard"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train(cfg, verbose=False)
    cfg.mesh.data_parallel = 4
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 4"):
        train(cfg, device="cpu", verbose=False)
    cfg.mesh.data_parallel, cfg.mesh.model_parallel = 1, 2
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        train(cfg, device="cpu", verbose=False)
    cfg.mesh.spatial_sharding = True
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        train(cfg, device="cpu", verbose=False)
    cfg.mesh.model_parallel = 1
    assert training_mesh(cfg) == Mesh(1, 1)
