"""The port's training loop and command line on 1x2 and 2x2 spatial meshes
of gloo CPU ranks (tests/torch_dp_worker.py's sp_loop), at 32 px, filter 8,
SpecSeg base 4, batch 2, f32, with the JAX defaults' flip, D noise and
dropout: each rank feeds its band of rows of its data index's block of
every batch (`rank_feed`'s band) and takes its rows of the global draws;
D's last block and patch head run whole on the ranks of a row (the
gather-whole rule).

  - `train.loop.train` on the mesh for 2 steps saves a checkpoint of the
    whole state: every rank's payload equals the file bit for bit, and it
    restores on one rank bit for bit;
  - its parameters are within 2 * 2 * lr of the same 2 steps on one rank
    from the same seed (the same global batches and draws);
  - `cli --mode train` with a config whose mesh is spatial (the CLI has no
    flag for it, as in the JAX package) trains on the mesh.
"""

import dataclasses
import os

import flax
import numpy as np
import pytest
import torch
from torch_dp_worker import spawn_ranks

from shmgan_tpu_torch import Config
from shmgan_tpu_torch.checkpoint import CheckpointManager
from shmgan_tpu_torch.data import synthetic
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.runtime import flax_msgpack
from shmgan_tpu_torch.train.loop import train
from shmgan_tpu_torch.train.state import create_train_state, state_payload

SIZE, LR = 32, 2e-5
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(root, tree, dp, mp):
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, image_size=SIZE, filter_size=8,
                                    specseg_base_filters=4, compute_dtype="float32")
    cfg.train = dataclasses.replace(
        cfg.train, batch_size=2, num_epochs=2, g_lr=LR, d_lr=LR, checkpoint_save_step=100,
        checkpoint_save_dir=os.path.join(root, "ckpt"), log_dir=os.path.join(root, "logs"),
        model_save_dir=os.path.join(root, "models"), result_dir=os.path.join(root, "results"))
    cfg.data = dataclasses.replace(cfg.data, data_dir=tree, prefetch=1)
    cfg.mesh = dataclasses.replace(cfg.mesh, data_parallel=dp, model_parallel=mp,
                                   spatial_sharding=True)
    return cfg


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
def one_rank(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp_loop_one")
    tree = str(root / "tree")
    synthetic.write_fixture_tree(tree, 4, SIZE, seed=0)
    one = _config(str(root / "one"), tree, 1, 1)
    return tree, train(one, max_steps=2, verbose=False, device="cpu")


@pytest.fixture(scope="module", params=list(LAYOUTS))
def runs(request, one_rank, tmp_path_factory):
    dp, mp = LAYOUTS[request.param]
    root = tmp_path_factory.mktemp(f"sp_loop_{request.param}")
    tree, one_state = one_rank
    sp = _config(str(root / "sp"), tree, dp, mp)
    cli_root = str(root / "cli")
    argv = ["--mode", "train", "--data_dir", tree, "--image_size", str(SIZE),
            "--filter_size", "8", "--batch_size", "2", "--num_epochs", "1",
            "--compute_dtype", "float32", "--model_parallel", str(mp),
            "--data_parallel", str(dp),
            "--checkpoint_save_dir", os.path.join(cli_root, "ckpt"),
            "--log_dir", os.path.join(cli_root, "logs"),
            "--model_save_dir", os.path.join(cli_root, "models"),
            "--result_dir", os.path.join(cli_root, "results")]
    torch.save({"run": {s: dataclasses.asdict(getattr(sp, s))
                        for s in ("model", "train", "data", "mesh")},
                "argv": argv}, root / "sp_loop.pt")
    ranks = spawn_ranks(root, ["sp_loop"], world=dp * mp, timeout=300)
    return dict(layout=(dp, mp), one_state=one_state, sp=sp, cli_root=cli_root,
                ranks=[r["sp_loop"] for r in ranks])


def test_spatial_loop_checkpoint_restores_on_one_rank(runs):
    sp = runs["sp"]
    assert CheckpointManager(sp.train.checkpoint_save_dir).all_steps() == [2]
    with open(os.path.join(sp.train.checkpoint_save_dir, "2", "state.msgpack"), "rb") as f:
        saved = flax_msgpack.loads(f.read())
    for r in runs["ranks"]:
        assert r["step"] == 2
        _assert_trees_equal(r["payload"], saved)
    state = create_train_state(sp, build_models(sp, device="cpu", seed=1))
    CheckpointManager(sp.train.checkpoint_save_dir).restore(state)
    _assert_trees_equal(state_payload(state), saved)


def test_spatial_loop_matches_one_rank(runs):
    """The same 2 steps from the same seed on one rank: the same global
    batches and draws; the parameters within 2 * 2 * lr."""
    want = _flat(state_payload(runs["one_state"]))
    got = _flat(runs["ranks"][0]["payload"])
    for path in (p for p in want if p[0] in ("g_params", "d_params")):
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(want[path]), rtol=0,
                                   atol=4 * LR, err_msg=str(path))


def test_spatial_cli_trains_from_a_config(runs):
    """cli --mode train with the config's spatial mesh: 4 scenes at batch
    2, one epoch, 2 steps on the mesh, one checkpoint."""
    ckpt = CheckpointManager(os.path.join(runs["cli_root"], "ckpt"))
    assert ckpt.all_steps() == [2]
