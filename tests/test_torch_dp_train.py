"""The port's data-parallel train step on two CPU ranks over gloo against the
JAX step on a dp=2 mesh and against the port's one-rank step, at 128 px,
filter 8, SpecSeg base 4, global batch 4 (2 a rank), f32.

Two ranks (tests/torch_dp_worker.py, spawned on a free localhost port) each
take their block of the global batch and the global draws' `Draws.shard`;
the step averages the gradients and the losses across them. Two cases:

  jax    the reference-parity flags, D's noise and dropout off, flip off,
         from seeded weights (tests/test_torch_train_loop.py's
         `_seeded_jax_state`); JAX's `make_train_step(debug_grads=True)`
         jitted over a dp=2 mesh (`shard_train_state`, `shard_batch`), its
         label t and drop pattern injected into the port;
  draws  the quality flags (live G1, G1 reconstruction, per-sample drops,
         the single-input pattern, consistent domains, the EMA) with D's
         noise and dropout on and the flip on: the global batch's draws
         from `sample_draws`, so each rank's rows of the per-sample drop
         and of the [generated; ED] stacks of noise and keep masks are
         held against the one-rank step.

Tolerances, tests/test_torch_train_step.py's: every D gradient leaf rtol
2e-3, atol 2e-6; G's gradients within 2e-3 as a whole (L2) and each leaf
within 1e-1 of its largest magnitude; every loss rtol 1e-5; the updated
parameters within 2 * lr. The two ranks' parameters after the step are
equal bit for bit. The rank feed: each rank's `rank_feed` batches,
concatenated in rank order, are the one-process dataset's global batches
exactly (as tests/test_multiprocess_feed.py holds the JAX feed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_loop import _port_models, _seeded_jax_state
from torch_dp_worker import spawn_ranks

from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.parallel.mesh import make_mesh as j_make_mesh
from shmgan_tpu.parallel.mesh import shard_batch, shard_train_state
from shmgan_tpu.train.step import make_train_step as j_make_train_step
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.convert import to_flax
from shmgan_tpu_torch.data import synthetic
from shmgan_tpu_torch.data.loader import PolarimetricDataset
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.train.state import create_train_state
from shmgan_tpu_torch.train.step import Draws, make_train_step, sample_draws

LR = 2e-5
SIZE = 128
BATCH = 4
QUALITY = dict(live_g1=True, g1_recon_weight=0.5, consistent_domains=True,
               scalar_channel_dropout=False, single_input_prob=0.5, g_ema=0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sections(cfg):
    return {s: dataclasses.asdict(getattr(cfg, s)) for s in ("model", "train", "data")}


def _configs(**train):
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(jcfg.model, image_size=SIZE, filter_size=8,
                                     specseg_base_filters=4, d_input_noise=0.0,
                                     d_dropout=0.0, compute_dtype="float32")
    jcfg.train = dataclasses.replace(jcfg.train, batch_size=BATCH, g_lr=LR, d_lr=LR, **train)
    jcfg.data = dataclasses.replace(jcfg.data, flip=False)
    cfg = Config()
    for section in ("model", "train", "data"):
        for f in dataclasses.fields(getattr(cfg, section)):
            setattr(getattr(cfg, section), f.name, getattr(getattr(jcfg, section), f.name))
    return jcfg, cfg


def _one_rank(cfg, models, views, draws):
    state = create_train_state(cfg, tuple(m for m in models))
    state, m = make_train_step(cfg, debug_grads=True)(state, torch.from_numpy(views), draws, 0)
    return {"grads": m["_grads"], "metrics": {k: v for k, v in m.items()
                                              if not k.startswith("_")},
            "gen": state.gen.state_dict(), "disc": state.disc.state_dict()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp_train")
    views = np.random.default_rng(1).random((5, BATCH, SIZE, SIZE, 3), np.float32)

    # case jax: JAX's step over a dp=2 mesh
    jcfg, cfg = _configs()
    jstate0 = _seeded_jax_state(jcfg)
    jcfg_dp = dataclasses.replace(jcfg, mesh=dataclasses.replace(jcfg.mesh, data_parallel=2))
    mesh = j_make_mesh(jcfg_dp)
    step = jax.jit(j_make_train_step(jcfg_dp, debug_grads=True))
    jnew, jm = step(shard_train_state(jax.tree_util.tree_map(jnp.asarray, jstate0), mesh),
                    shard_batch(jnp.asarray(views), mesh), jax.random.PRNGKey(42),
                    jnp.zeros((), jnp.int32))
    jax_draws = Draws(flip=torch.tensor(False),
                      t=torch.tensor(np.asarray(jm["target_label"])),
                      drop=torch.tensor(np.asarray(jm["_drop"])))

    # case draws: the quality flags, D's noise and dropout on, flip on
    _, qcfg = _configs(**QUALITY)
    qcfg.model.d_input_noise, qcfg.model.d_dropout = 0.1, 0.2
    qcfg.data.flip = True
    q_draws = sample_draws(qcfg, torch.Generator().manual_seed(7), 5, BATCH, SIZE, SIZE)
    assert q_draws.drop.shape == (BATCH, 5) and q_draws.noise.shape[0] == 2 * BATCH

    cases, one_rank = [], {}
    for name, c, draws in (("jax", cfg, jax_draws), ("draws", qcfg, q_draws)):
        models = _port_models(c, jstate0)
        cases.append({"name": name, "config": _sections(c),
                      "weights": [{k: v.clone() for k, v in m.state_dict().items()}
                                  for m in models],
                      "views": torch.from_numpy(views), "draws": dataclasses.asdict(draws)})
        one_rank[name] = _one_rank(c, models, views, draws)
    torch.save(cases, work / "step_cases.pt")

    # the rank feed on a 12-scene tree, global batch 4, shuffled
    tree = str(work / "tree")
    synthetic.write_fixture_tree(tree, 12, 16, seed=0)
    feed_cfg = Config()
    feed_cfg.model.image_size, feed_cfg.train.batch_size = 16, BATCH
    feed_cfg.data.data_dir = tree
    torch.save({"config": _sections(feed_cfg), "shuffle_seed": 5}, work / "feed.pt")
    global_batches = list(PolarimetricDataset(feed_cfg.data, 16, BATCH).iter_epoch(
        shuffle_seed=5))[:2]

    ranks = spawn_ranks(work, ["step", "feed"])
    return dict(jcfg=jcfg, jstate0=jstate0, jnew=jnew, jm=jm, one_rank=one_rank,
                ranks=ranks, global_batches=global_batches)


def _module(cfg, net):
    gen, disc, _ = build_models(cfg, device="cpu")
    return gen if net == "G" else disc


def _check_grads(got, want, net):
    """tests/test_torch_train_step.py's gradient tolerances, over {name:
    array} trees."""
    if net == "D":
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=2e-3, atol=2e-6, err_msg=k)
        return
    diff = np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items()))
    norm = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    assert diff <= 2e-3 * norm, (diff, norm)
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-1 * np.abs(w).max(), k


def _np_tree(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


@pytest.mark.parametrize("net", ["G", "D"])
def test_two_rank_gradients_match_jax_dp_mesh(runs, net):
    _, cfg = _configs()
    template = runs["jstate0"].g_params if net == "G" else runs["jstate0"].d_params
    module = _module(cfg, net)
    got = to_flax(module, template, runs["ranks"][0]["step"]["jax"]["grads"][net])
    want = runs["jm"]["_grads"][net]
    flat_got = dict((jax.tree_util.keystr(p), np.asarray(v))
                    for p, v in jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict((jax.tree_util.keystr(p), np.asarray(v))
                     for p, v in jax.tree_util.tree_flatten_with_path(want)[0])
    assert sorted(flat_got) == sorted(flat_want)
    _check_grads(flat_got, flat_want, net)


def test_two_rank_losses_match_jax_dp_mesh(runs):
    jm = runs["jm"]
    metrics = runs["ranks"][0]["step"]["jax"]["metrics"]
    keys = [k for k in jm if not k.startswith("_")]
    assert set(keys) == set(metrics)
    for k in keys:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jm[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D"])
def test_two_rank_params_match_jax_dp_mesh(runs, net):
    _, cfg = _configs()
    old = runs["jstate0"].g_params if net == "G" else runs["jstate0"].d_params
    new = runs["jnew"].g_params if net == "G" else runs["jnew"].d_params
    module = _module(cfg, net)
    module.load_state_dict(runs["ranks"][0]["step"]["jax"]["gen" if net == "G" else "disc"])
    got = to_flax(module, old, dict(module.named_parameters()))
    for (path, w), (_, g) in zip(jax.tree_util.tree_flatten_with_path(new)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=2 * LR,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", ["jax", "draws"])
def test_two_ranks_match_one_rank(runs, case):
    """The port on two ranks against the port on one, from the same weights
    and global draws: gradients, losses, updated parameters."""
    got, want = runs["ranks"][0]["step"][case], runs["one_rank"][case]
    for net in ("G", "D"):
        _check_grads(_np_tree(got["grads"][net]), _np_tree(want["grads"][net]), net)
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].numpy(), w.numpy(), rtol=1e-5, err_msg=k)
    for part in ("gen", "disc"):
        for k, w in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), w.numpy(), rtol=0, atol=2 * LR,
                                       err_msg=k)


@pytest.mark.parametrize("case", ["jax", "draws"])
def test_ranks_hold_identical_params(runs, case):
    r0, r1 = (r["step"][case] for r in runs["ranks"])
    for part in ("gen", "disc"):
        assert r0[part].keys() == r1[part].keys()
        for k in r0[part]:
            assert torch.equal(r0[part][k], r1[part][k]), (part, k)
    for net in ("G", "D"):
        for k in r0["grads"][net]:
            assert torch.equal(r0["grads"][net][k], r1["grads"][net][k]), (net, k)


def test_rank_feed_assembles_the_global_batch(runs):
    for b, want in enumerate(runs["global_batches"]):
        parts = [r["feed"][b].numpy() for r in runs["ranks"]]
        assert all(p.shape == (5, BATCH // 2, 16, 16, 3) for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts, axis=1), want)
