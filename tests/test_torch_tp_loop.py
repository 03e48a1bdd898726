"""The port's tensor-parallel training loop, checkpoints and command line on
two gloo CPU ranks (a 1x2 mesh: tests/torch_dp_worker.py's tp_loop and
tp_cli), at 32 px, filter 8, SpecSeg base 4, batch 2, f32, tp_min_channels
16 (G's levels 1-3, bottleneck and up levels 0-2, D's blocks 1-3 and its
attention are cut; D's block 4 writes a 1x1 map and stays whole, the JAX
extent rule).

  - `train.loop.train` on 1x2 for 2 steps saves a checkpoint that holds
    the whole state: the ranks' gathered payloads equal the file bit for
    bit; it restores on one rank, bit for bit, and resumes there; its
    parameters are within 2 * 2 * lr of the same 2 steps on one rank, and
    its held-out eval (on the cut G) within rtol 1e-4 of that run's;
  - a one-rank checkpoint restores on 1x2: cut and gathered again, it is
    the file bit for bit; the ranks resume from it;
  - `cli --mode train --model_parallel 2` trains on the two ranks, and
    `--mode export --model_parallel 2` under them writes the bundle that
    a one-process `--mode export` of the same checkpoint writes, byte for
    byte.
"""

import dataclasses
import json
import os
import shutil

import flax
import numpy as np
import pytest
import torch
from torch_dp_worker import spawn_ranks

from shmgan_tpu_torch import Config, cli
from shmgan_tpu_torch.checkpoint import CheckpointManager
from shmgan_tpu_torch.data import synthetic
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.runtime import flax_msgpack
from shmgan_tpu_torch.train.loop import train
from shmgan_tpu_torch.train.state import create_train_state, state_payload

SIZE, LR, MIN_CHANNELS = 32, 2e-5, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(root, tree, mp):
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, image_size=SIZE, filter_size=8,
                                    specseg_base_filters=4, compute_dtype="float32")
    cfg.train = dataclasses.replace(
        cfg.train, batch_size=2, num_epochs=2, g_lr=LR, d_lr=LR, checkpoint_save_step=100,
        checkpoint_save_dir=os.path.join(root, "ckpt"), log_dir=os.path.join(root, "logs"),
        model_save_dir=os.path.join(root, "models"), result_dir=os.path.join(root, "results"))
    cfg.data = dataclasses.replace(cfg.data, data_dir=tree, prefetch=1)
    cfg.mesh = dataclasses.replace(cfg.mesh, data_parallel=1, model_parallel=mp,
                                   tp_min_channels=MIN_CHANNELS)
    return cfg


def _sections(cfg):
    return {s: dataclasses.asdict(getattr(cfg, s)) for s in ("model", "train", "data", "mesh")}


def _cli_argv(mode, root, tree, mp):
    return ["--mode", mode, "--data_dir", tree, "--image_size", str(SIZE), "--filter_size", "8",
            "--batch_size", "2", "--num_epochs", "1", "--compute_dtype", "float32",
            "--model_parallel", str(mp), "--data_parallel", "1",
            "--checkpoint_save_dir", os.path.join(root, "ckpt"),
            "--log_dir", os.path.join(root, "logs"),
            "--model_save_dir", os.path.join(root, "models"),
            "--result_dir", os.path.join(root, "results")]


def _read(cfg, step):
    with open(os.path.join(cfg.train.checkpoint_save_dir, str(step), "state.msgpack"),
              "rb") as f:
        return flax_msgpack.loads(f.read())


def _flat(tree):
    return flax.traverse_util.flatten_dict(tree)


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = np.asarray(got[path])
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w), path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_loop")
    tree = str(root / "tree")
    synthetic.write_fixture_tree(tree, 4, SIZE, seed=0)
    held_out = dict(zip(("eval_inputs", "eval_targets"), synthetic.synth_eval_set(2, SIZE, 5)[:2]),
                    eval_every_epochs=1)
    one = _config(str(root / "one"), tree, 1)
    one_state = train(one, max_steps=2, verbose=False, device="cpu", **held_out)
    resume = _config(str(root / "resume"), tree, 2)
    shutil.copytree(one.train.checkpoint_save_dir, resume.train.checkpoint_save_dir)
    tp = _config(str(root / "tp"), tree, 2)
    torch.save({"run": _sections(tp), "resume": _sections(resume), "eval": held_out},
               root / "tp_loop.pt")
    cli_root = str(root / "cli")
    torch.save({"tp_min_channels": MIN_CHANNELS,
                "argvs": [_cli_argv(m, cli_root, tree, 2) for m in ("train", "export")]},
               root / "tp_cli.pt")
    ranks = spawn_ranks(root, ["tp_loop", "tp_cli"], world=2, timeout=300)
    return dict(root=root, tree=tree, one=one, one_state=one_state, tp=tp, resume=resume,
                cli_root=cli_root, ranks=[r["tp_loop"] for r in ranks],
                cli_cut=[r["tp_cli"]["cut"] for r in ranks])


def test_tp_checkpoint_holds_the_gathered_state(runs):
    saved = _read(runs["tp"], 2)
    assert CheckpointManager(runs["tp"].train.checkpoint_save_dir).all_steps() == [2]
    for r in runs["ranks"]:
        assert r["step"] == 2
        _assert_trees_equal(r["payload"], saved)


def test_tp_checkpoint_restores_and_resumes_on_one_rank(runs, tmp_path):
    cfg = _config(str(tmp_path), runs["tree"], 1)
    shutil.copytree(runs["tp"].train.checkpoint_save_dir, cfg.train.checkpoint_save_dir)
    state = create_train_state(cfg, build_models(cfg, device="cpu", seed=3))
    CheckpointManager(cfg.train.checkpoint_save_dir).restore(state)
    _assert_trees_equal(state_payload(state), _read(runs["tp"], 2))
    resumed = train(cfg, max_steps=2, verbose=False, device="cpu")
    assert resumed.step == 4


def test_tp_loop_matches_one_rank_loop(runs):
    """The same 2 steps (seed, batches, draws) on 1x2 and on one rank."""
    got, want = _flat(_read(runs["tp"], 2)), _flat(state_payload(runs["one_state"]))
    for path, w in want.items():
        if path[0] in ("g_params", "d_params", "ema_g_params"):
            np.testing.assert_allclose(got[path], w, rtol=0, atol=2 * 2 * LR, err_msg=str(path))
        elif path[0] == "step" or path[-1] == "count":
            np.testing.assert_array_equal(got[path], w)


def test_tp_loop_eval_rows_match_one_rank(runs):
    """The held-out eval of a cut G (every rank runs it, rank 0 writes it)
    against the one-rank loop's, within --mode test's rtol 1e-4."""
    def rows(cfg):
        with open(os.path.join(cfg.train.log_dir, "metrics.jsonl")) as f:
            return [r for r in map(json.loads, f) if any(k.startswith("eval/") for k in r)]

    got, want = rows(runs["tp"]), rows(runs["one"])
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2]
    for k in set(want[0]) - {"step", "time"}:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4, err_msg=k)


def test_one_rank_checkpoint_restores_on_the_mesh(runs):
    want = _read(runs["one"], 2)
    for r in runs["ranks"]:
        _assert_trees_equal(r["restored"], want)
        assert r["resumed_step"] == 4
    assert CheckpointManager(runs["resume"].train.checkpoint_save_dir).all_steps() == [2, 4]


def test_tp_cli_trains_and_exports_as_one_process(runs, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = runs["cli_root"]
    # the loop cut, of G: levels 1-3 (2 ConvIN of 4 parameters and an
    # attention of 4 each), the bottleneck (2 ConvIN), up levels 0-2 (an
    # upsample of 2, 2 ConvIN); of D: blocks 1-3 (3 each), the attention
    g_cut = 3 * (2 * 4 + 4) + 2 * 4 + 3 * (2 + 2 * 4)
    for cut in runs["cli_cut"]:
        assert len(cut) == 1 and len(cut[0]) == g_cut + 3 * 3 + 4
    assert CheckpointManager(os.path.join(root, "ckpt")).all_steps() == [2]
    with open(os.path.join(root, "models", "shmgan_infer.msgpack"), "rb") as f:
        under_mesh = f.read()
    argv = _cli_argv("export", root, runs["tree"], 1)
    argv[argv.index("--model_save_dir") + 1] = str(tmp_path / "models")
    cli.main(argv, device="cpu")
    with open(tmp_path / "models" / "shmgan_infer.msgpack", "rb") as f:
        assert f.read() == under_mesh
