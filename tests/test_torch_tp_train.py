"""The port's tensor-parallel train step on gloo CPU ranks against the JAX
step on the same (dp, mp) mesh and against the port's one-rank step, at
128 px, filter 8, SpecSeg base 4, global batch 4, f32, tp_min_channels 32:
G's levels 2-3, its bottleneck and up levels 0-1, and D's blocks 2-4, its
attention and its class head (2048 input rows) are cut over the model axis.

Layouts 1x2 and 2x2 (tests/torch_dp_worker.py's tp_step, 2 and 4 ranks
spawned on a free localhost port). Each rank cuts the whole seeded state to
its slices (`shard_state`) and takes one step with debug_grads on its data
index's block of the views and its `Draws.shard`. Two cases:

  jax    the reference-parity flags, D's noise and dropout off, flip off;
         JAX's `make_train_step(debug_grads=True)` jitted over the same
         mesh, its state placed by `shard_train_state(min_channels=32)`,
         its label t and drop pattern injected into the port;
  draws  (2x2 only) the quality flags with D's noise and dropout on and
         the flip on, from `sample_draws`: each rank's rows of the draws,
         held against the one-rank step.

Tolerances, tests/test_torch_train_step.py's: every D gradient leaf rtol
2e-3, atol 2e-6; G's gradients within 2e-3 as a whole (L2) and each leaf
within 1e-1 of its largest magnitude; every loss rtol 1e-5; the updated
parameters within 2 * lr. Leaves kept whole on every rank are equal on all
ranks bit for bit, and so are the gathered ones; the cut leaves are the
ones whose JAX spec names the model axis; 26 of the step's 46 IN calls run
on a slice of the channels; broadcast_state of a cut state restores every
rank's slices from data index 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dp_train import BATCH, LR, QUALITY, SIZE, _check_grads, _configs, _module
from test_torch_dp_train import _np_tree, _one_rank, _sections
from test_torch_train_loop import _port_models, _seeded_jax_state
from torch_dp_worker import spawn_ranks

from shmgan_tpu.parallel.mesh import make_mesh as j_make_mesh
from shmgan_tpu.parallel.mesh import param_shardings, shard_batch, shard_train_state
from shmgan_tpu.train.step import make_train_step as j_make_train_step
from shmgan_tpu_torch.convert import to_flax
from shmgan_tpu_torch.ops.kernels import instance_norm as ink
from shmgan_tpu_torch.tp_gap import mark_cut, split_compute
from shmgan_tpu_torch.train.step import Draws, sample_draws

MIN_CHANNELS = 32
LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tp_configs(dp, mp, **train):
    jcfg, cfg = _configs(**train)
    jcfg.mesh = dataclasses.replace(jcfg.mesh, data_parallel=dp, model_parallel=mp,
                                    tp_min_channels=MIN_CHANNELS)
    cfg.mesh.data_parallel, cfg.mesh.model_parallel = dp, mp
    cfg.mesh.tp_min_channels = MIN_CHANNELS
    return jcfg, cfg


def _sections_mesh(cfg):
    return {**_sections(cfg), "mesh": dataclasses.asdict(cfg.mesh)}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def runs(request, tmp_path_factory):
    dp, mp = LAYOUTS[request.param]
    work = tmp_path_factory.mktemp(f"tp_{request.param}")
    views = np.random.default_rng(1).random((5, BATCH, SIZE, SIZE, 3), np.float32)

    jcfg, cfg = _tp_configs(dp, mp)
    jstate0 = _seeded_jax_state(jcfg)
    mesh = j_make_mesh(jcfg)
    placed = shard_train_state(jax.tree_util.tree_map(jnp.asarray, jstate0), mesh,
                               image_size=SIZE, min_channels=MIN_CHANNELS)
    specs = {net: jax.tree_util.tree_map(lambda s: tuple(s.spec), param_shardings(
        tree, mesh, image_size=SIZE, min_channels=MIN_CHANNELS))
        for net, tree in (("G", jstate0.g_params), ("D", jstate0.d_params))}
    step = jax.jit(j_make_train_step(jcfg, debug_grads=True))
    jnew, jm = step(placed, shard_batch(jnp.asarray(views), mesh), jax.random.PRNGKey(42),
                    jnp.zeros((), jnp.int32))
    jax_draws = Draws(flip=torch.tensor(False), t=torch.tensor(np.asarray(jm["target_label"])),
                      drop=torch.tensor(np.asarray(jm["_drop"])))
    cases = [("jax", cfg, jax_draws)]
    if dp > 1:
        _, qcfg = _tp_configs(dp, mp, **QUALITY)
        qcfg.model.d_input_noise, qcfg.model.d_dropout = 0.1, 0.2
        qcfg.data.flip = True
        cases.append(("draws", qcfg, sample_draws(qcfg, torch.Generator().manual_seed(7), 5,
                                                  BATCH, SIZE, SIZE)))
    payload, one_rank, split, in_shapes = [], {}, {}, []
    plain = ink.instance_norm

    def recording(x, *args):
        in_shapes.append(tuple(x.shape))
        return plain(x, *args)

    for name, c, draws in cases:
        models = _port_models(c, jstate0)
        payload.append({"name": name, "config": _sections_mesh(c),
                        "weights": [{k: v.clone() for k, v in m.state_dict().items()}
                                    for m in models],
                        "views": torch.from_numpy(views), "draws": dataclasses.asdict(draws)})
        with pytest.MonkeyPatch.context() as patch:
            if name == "jax":
                patch.setattr(ink, "instance_norm", recording)
            one_rank[name] = _one_rank(c, models, views, draws)
        split_models = _port_models(c, jstate0)
        for m in split_models[:2]:
            mark_cut(m, mp, SIZE, MIN_CHANNELS)
        with split_compute(mp):
            split[name] = _one_rank(c, split_models, views, draws)
    torch.save(payload, work / "tp_step_cases.pt")
    ranks = spawn_ranks(work, ["tp_step"], world=dp * mp)
    return dict(layout=(dp, mp), cfg=cfg, jstate0=jstate0, jnew=jnew, jm=jm, specs=specs,
                one_rank=one_rank, split=split, in_shapes=in_shapes,
                ranks=[r["tp_step"] for r in ranks])


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("net", ["G", "D"])
def test_tp_gradients_match_jax_mesh(runs, net):
    template = runs["jstate0"].g_params if net == "G" else runs["jstate0"].d_params
    module = _module(runs["cfg"], net)
    for r in runs["ranks"]:
        got = _flat(to_flax(module, template, r["jax"]["grads"][net]))
        want = _flat(runs["jm"]["_grads"][net])
        assert sorted(got) == sorted(want)
        _check_grads(got, want, net)


def test_tp_losses_match_jax_mesh(runs):
    jm = runs["jm"]
    keys = [k for k in jm if not k.startswith("_")]
    for r in runs["ranks"]:
        assert set(keys) == set(r["jax"]["metrics"])
        for k in keys:
            np.testing.assert_allclose(r["jax"]["metrics"][k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D"])
def test_tp_params_match_jax_mesh(runs, net):
    old = runs["jstate0"].g_params if net == "G" else runs["jstate0"].d_params
    new = _flat(runs["jnew"].g_params if net == "G" else runs["jnew"].d_params)
    module = _module(runs["cfg"], net)
    got = _flat(to_flax(module, old, runs["ranks"][0]["jax"]["gen" if net == "G" else "disc"]))
    assert sorted(got) == sorted(new)
    for path, w in new.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2 * LR, err_msg=path)


def test_tp_matches_one_rank(runs):
    """The port on the mesh against the port on one rank, from the same
    weights and global draws: gradients, losses, updated parameters."""
    for case, want in runs["one_rank"].items():
        got = runs["ranks"][0][case]
        for net in ("G", "D"):
            _check_grads(_np_tree(got["grads"][net]), _np_tree(want["grads"][net]), net)
        assert set(got["metrics"]) == set(want["metrics"])
        for k, w in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k].numpy(), w.numpy(), rtol=1e-5,
                                       err_msg=f"{case} {k}")
        for part in ("gen", "disc"):
            for k, w in want[part].items():
                np.testing.assert_allclose(got[part][k].numpy(), w.numpy(), rtol=0,
                                           atol=2 * LR, err_msg=f"{case} {k}")


def test_tp_step_is_its_split_in_one_process(runs):
    """The port on the mesh against the same step on one rank with every
    cut block computed as its M slices in one process (tp_gap.split_compute:
    the mesh's arithmetic without a collective). On a 1 x M mesh they are
    one computation: gradients, losses and updated parameters bit for bit.
    On a 2 x M mesh the data mean of the halves' gradients stands between
    them: the one-rank tolerances."""
    dp, _ = runs["layout"]
    for case, want in runs["split"].items():
        got = runs["ranks"][0][case]
        assert set(got["metrics"]) == set(want["metrics"])
        for net in ("G", "D"):
            if dp == 1:
                for k, w in want["grads"][net].items():
                    assert torch.equal(got["grads"][net][k], w), (case, net, k)
            else:
                _check_grads(_np_tree(got["grads"][net]), _np_tree(want["grads"][net]), net)
        for k, w in want["metrics"].items():
            if dp == 1:
                assert torch.equal(got["metrics"][k], w), (case, k)
            else:
                np.testing.assert_allclose(got["metrics"][k].numpy(), w.numpy(), rtol=1e-5,
                                           err_msg=f"{case} {k}")
        for part in ("gen", "disc"):
            for k, w in want[part].items():
                if dp == 1:
                    assert torch.equal(got[part][k], w), (case, part, k)
                else:
                    np.testing.assert_allclose(got[part][k].numpy(), w.numpy(), rtol=0,
                                               atol=2 * LR, err_msg=f"{case} {k}")


def test_tp_ranks_agree_bit_for_bit(runs):
    """Leaves whole on every rank are equal on all ranks after the step, as
    are the gathered leaves and gradients; ranks of one model index hold the
    same slices."""
    r0 = runs["ranks"][0]
    for r in runs["ranks"][1:]:
        for case in r0:
            a, b = r0[case], r[case]
            for part in ("gen", "disc"):
                for k in a[part]:
                    assert torch.equal(a[part][k], b[part][k]), (case, part, k)
                for k, t in a["local"][part].items():
                    if k not in a["cut"][part] or b["coords"][1] == a["coords"][1]:
                        assert torch.equal(t, b["local"][part][k]), (case, part, k)
            for net in ("G", "D"):
                for k in a["grads"][net]:
                    assert torch.equal(a["grads"][net][k], b["grads"][net][k]), (case, net, k)


def test_tp_cuts_the_leaves_jax_shards(runs):
    """The cut kernels are those whose JAX spec names the model axis (the
    port also cuts the biases, gamma and beta behind them, which JAX keeps
    whole); a cut parameter holds 1/M of its leaf, the rest are whole."""
    _, mp = runs["layout"]
    r = runs["ranks"][-1]["jax"]
    for net, part in (("G", "gen"), ("D", "disc")):
        module = _module(runs["cfg"], net)
        template = runs["jstate0"].g_params if net == "G" else runs["jstate0"].d_params
        cut, full = r["cut"][part], dict(module.named_parameters())
        for k, t in r["local"][part].items():
            assert t.numel() == full[k].numel() // (mp if k in cut else 1), k
        marks = _flat(to_flax(module, template, {k: torch.full(p.shape, float(k in cut))
                                                 for k, p in full.items()}))
        specs = {jax.tree_util.keystr(p): s for p, s in jax.tree_util.tree_flatten_with_path(
            runs["specs"][net], is_leaf=lambda x: isinstance(x, tuple))[0]}
        assert any("model" in s for s in specs.values()), net
        for path, spec in specs.items():
            if path.endswith("['kernel']"):
                assert (marks[path].max() == 1.0) == ("model" in spec), path


def test_tp_instance_norm_runs_on_channel_slices(runs):
    """46 IN calls a step a rank (G1 18, cyclic G 18, live D 5, frozen D 5),
    in the one-rank step's order, 26 of them (10 + 10 + 3 + 3) on C / M of
    its channels and on the data index's rows."""
    dp, mp = runs["layout"]
    whole = runs["in_shapes"]
    assert len(whole) == 46
    for r in runs["ranks"]:
        shapes = r["jax"]["in_shapes"]
        assert len(shapes) == 46
        sliced = 0
        for (b, c, h, w), (wb, wc, wh, ww) in zip(shapes, whole):
            assert (b * dp, h, w) == (wb, wh, ww) and c in (wc, wc // mp)
            sliced += c != wc
        assert sliced == 26


def test_tp_broadcast_state_restores_slices(runs):
    """After the other ranks' G parameters, first moments and step were
    moved, broadcast_state gives each rank its model index's slices from
    data index 0 and the whole leaves and step from rank 0."""
    by_coords = {r["jax"]["coords"]: r["jax"] for r in runs["ranks"]}
    for (i, j), r in by_coords.items():
        b, cut = r["broadcast"], r["cut"]["gen"]
        assert b["step"] == 1
        for k, t in b["gen"].items():
            src = by_coords[(0, j) if k in cut else (0, 0)]
            assert torch.equal(t, src["local"]["gen"][k]), k
            assert torch.equal(b["mu"][k], src["mu"][k]), k
