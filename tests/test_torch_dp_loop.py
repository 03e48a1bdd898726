"""The port's data-parallel entry points on two CPU ranks over gloo
(tests/torch_dp_worker.py): the epoch loop with its checkpoint and resume,
and a step of the flagship trainer's phase B, each against the same run on
one process, at 32 px, filter 8, SpecSeg base 4, global batch 4, f32.

  loop   `train.loop.train` for 2 steps (D's noise and dropout on, default
         draws from the seed), checkpointing every epoch: one checkpoint
         written (step 2), by rank 0; then resumed on both ranks for 2 more
         (checkpoint 4). The ranks' parameters equal bit for bit, the
         metrics.jsonl rows those of one process (rtol 1e-5 at step 1, the
         step test's loss tolerance; atol 1e-6 beside it at step 3, two
         updates on, as tests/test_torch_train_loop.py), and the parameters
         within 4 x 2 * lr of one process's (four Adam steps).
  gan    `quality_train.main --phase gan --data_parallel 2` for one step on
         the DR curriculum (each rank renders the global batch and takes its
         block) against `--data_parallel 1`: the step-1 checkpoints' Adam
         first moments, (1 - b1) x the clipped gradient, within
         tests/test_torch_train_step.py's gradient tolerances, and the
         parameters within 2 * lr.
  agree  the host agreements phase B makes at a segment's end: the largest
         of the ranks' times, and a flag one rank sets.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_dp_worker import make_config, spawn_ranks

from shmgan_tpu_torch import quality_train
from shmgan_tpu_torch.checkpoint import CheckpointManager
from shmgan_tpu_torch.data import synthetic
from shmgan_tpu_torch.runtime import flax_msgpack
from shmgan_tpu_torch.train.loop import train

LR = 2e-5
GAN_ARGS = ["--cpu", "--phase", "gan", "--image_size", "32", "--filter_size", "8",
            "--specseg_base_filters", "4", "--batch", "4", "--gan_steps", "1", "--chunk", "1",
            "--eval_every", "100", "--eval_n", "2", "--fid_draws", "1",
            "--gan_curriculum", "dr", "--dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop_sections(root, tree):
    return {"model": {"image_size": 32, "filter_size": 8, "specseg_base_filters": 4,
                      "compute_dtype": "float32"},
            "train": {"batch_size": 4, "g_lr": LR, "d_lr": LR, "num_epochs": 4,
                      "checkpoint_save_step": 1,
                      "checkpoint_save_dir": os.path.join(root, "ckpt"),
                      "log_dir": os.path.join(root, "logs"),
                      "model_save_dir": os.path.join(root, "models")},
            "data": {"data_dir": tree, "flip": False}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_loop")
    tree = str(work / "tree")
    synthetic.write_fixture_tree(tree, 8, 32, seed=0)
    torch.save(_loop_sections(str(work / "two"), tree), work / "loop.pt")
    torch.save(GAN_ARGS + ["--data_parallel", "2", "--out", str(work / "gan_two")],
               work / "gan.pt")
    ranks = spawn_ranks(work, ["loop", "gan", "agree"])

    one = {}
    cfg = make_config(_loop_sections(str(work / "one"), tree))
    for run in ("first", "resumed"):
        state = train(cfg, max_steps=2, verbose=False, device="cpu")
        one[run] = {"step": state.step, "gen": state.gen.state_dict(),
                    "disc": state.disc.state_dict()}
    quality_train.main(GAN_ARGS + ["--out", str(work / "gan_one")])
    return dict(work=work, ranks=ranks, one=one, cfg=cfg)


def _rows(root):
    with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_ranks_agree_on_a_segment_time_and_a_flag(runs):
    assert [r["agree"] for r in runs["ranks"]] == [{"max": 1.25, "any": True, "none": False}] * 2


def test_loop_checkpoints_and_resumes_on_two_ranks(runs):
    work = runs["work"]
    assert [r["loop"]["first"]["step"] for r in runs["ranks"]] == [2, 2]
    assert [r["loop"]["resumed"]["step"] for r in runs["ranks"]] == [4, 4]
    assert CheckpointManager(str(work / "two" / "ckpt")).all_steps() == [2, 4]
    assert CheckpointManager(str(work / "one" / "ckpt")).all_steps() == [2, 4]
    # rank 0 alone writes: no temporary directory is left behind
    assert sorted(os.listdir(work / "two" / "ckpt")) == ["2", "4"]


@pytest.mark.parametrize("run", ["first", "resumed"])
def test_loop_ranks_hold_identical_params(run, runs):
    r0, r1 = (r["loop"][run] for r in runs["ranks"])
    for part in ("gen", "disc"):
        for k, v in r0[part].items():
            assert torch.equal(v, r1[part][k]), (part, k)


def test_loop_matches_one_process(runs):
    got, want = runs["ranks"][0]["loop"]["resumed"], runs["one"]["resumed"]
    for part in ("gen", "disc"):
        for k, w in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), w.numpy(), rtol=0,
                                       atol=4 * 2 * LR, err_msg=k)
    rows, want_rows = _rows(str(runs["work"] / "two")), _rows(str(runs["work"] / "one"))
    assert [r["step"] for r in rows] == [r["step"] for r in want_rows] == [1, 3]
    for row, want_row in zip(rows, want_rows):
        assert set(row) == set(want_row)
        atol = 0.0 if row["step"] == 1 else 1e-6
        for k in set(want_row) - {"step", "time"}:
            np.testing.assert_allclose(row[k], want_row[k], rtol=1e-5, atol=atol, err_msg=k)


def _checkpoint(out):
    with open(os.path.join(out, "ckpt", "1", "state.msgpack"), "rb") as f:
        return flax_msgpack.loads(f.read())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("net", ["g", "d"])
def test_phase_b_step_on_two_ranks_matches_one(runs, net):
    got, want = (_checkpoint(str(runs["work"] / d)) for d in ("gan_two", "gan_one"))
    assert int(got["step"]) == int(want["step"]) == 1
    mu_got = dict(_flat(got[f"{net}_opt_state"]["1"]["mu"]))
    mu_want = dict(_flat(want[f"{net}_opt_state"]["1"]["mu"]))
    assert sorted(mu_got) == sorted(mu_want)
    if net == "d":
        for k, w in mu_want.items():
            np.testing.assert_allclose(mu_got[k], w, rtol=2e-3, atol=2e-6, err_msg=k)
    else:
        diff = np.sqrt(sum(np.sum((mu_got[k] - w) ** 2) for k, w in mu_want.items()))
        norm = np.sqrt(sum(np.sum(w ** 2) for w in mu_want.values()))
        assert diff <= 2e-3 * norm, (diff, norm)
        for k, w in mu_want.items():
            assert np.abs(mu_got[k] - w).max() <= 1e-1 * np.abs(w).max(), k
    lr = 2e-4 if net == "g" else 1e-4   # quality_train's --g_lr and --d_lr defaults
    for k, w in _flat(want[f"{net}_params"]):
        np.testing.assert_allclose(dict(_flat(got[f"{net}_params"]))[k], w, rtol=0,
                                   atol=2 * lr, err_msg=k)
    summary = os.path.join(str(runs["work"] / "gan_two"), "quality_summary.json")
    assert os.path.exists(summary)
