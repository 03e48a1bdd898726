"""The port's spatially sharded train step on gloo CPU ranks against the JAX
step on the same spatial mesh and against the port's one-rank step, at
128 px, filter 8, SpecSeg base 4, global batch 4, f32.

Layouts 1x2 and 2x2 (tests/torch_dp_worker.py's sp_step, 2 and 4 ranks
spawned on a free localhost port). Each rank holds every parameter whole
and takes one step with debug_grads on its band of rows (`local_band`) of
its data index's block of the views, with its rows of the draws
(`Draws.shard`, then `Draws.rows`). Cases:

  jax     the reference-parity flags, D's noise and dropout off, flip off;
          JAX's `make_train_step(debug_grads=True)` jitted over the same
          mesh, its state placed by `shard_train_state(spatial=True)` and
          its views by `shard_batch(spatial=True)` (H on the model axis,
          GSPMD's halos), its label t and drop pattern injected into the
          port;
  draws   the quality flags (live G1, G1 reconstruction, per-sample drops,
          the single-input pattern, consistent domains, the EMA, the
          chroma prior's second SpecSeg channel, `resize_conv`, and both
          models recomputed in the backward, `remat="models"`) with D's
          noise and dropout on and the flip on, from `sample_draws`: each
          rank's rows of the noise and keep masks, and the flip's exchange
          of the bands, held against the one-rank step;
  gather  (1x2) the parity flags at 32 px, JAX's own spatial test's shape:
          D's last block writes a 1x1 map, which does not divide over the
          model axis, so it and the patch head run whole on both ranks
          (the gather-whole rule) and each keeps its band of the result
          (rank 0 the row, rank 1 none); against the one-rank step.

Tolerances, tests/test_torch_tp_train.py's (tests/test_torch_train_step.py's):
every D gradient leaf rtol 2e-3, atol 2e-6; G's gradients within 2e-3 as a
whole (L2) and each leaf within 1e-1 of its largest magnitude; every loss
rtol 1e-5; the updated parameters within 2 * lr. Every rank holds the same
parameters and gradients bit for bit. On 1x2 the parity step is its split
in one process (`spatial.split_compute`: each band computed as its rank
computes it) bit for bit; the quality step, whose G is used twice, sums
its gradients in another order there and is held at the one-rank
tolerances, as is everything on 2x2. The one-rank steps and their splits
are computed once and held against both layouts' ranks.
"""

import copy
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
from shmgan_tpu.parallel.mesh import shard_batch, shard_train_state
from shmgan_tpu.train.step import make_train_step as j_make_train_step
from shmgan_tpu_torch.convert import to_flax
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.ops.kernels import instance_norm as ink
from shmgan_tpu_torch.parallel.spatial import split_compute
from shmgan_tpu_torch.train.step import Draws, sample_draws

LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}
GATHER_SIZE = 32
# the one-rank step and its split by case, shared by the layouts (both cut
# the model axis in 2) where the case's draws are the same
_REFERENCES = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sp_configs(dp, mp, **train):
    jcfg, cfg = _configs(**train)
    jcfg.mesh = dataclasses.replace(jcfg.mesh, data_parallel=dp, model_parallel=mp,
                                    spatial_sharding=True)
    cfg.mesh.data_parallel, cfg.mesh.model_parallel = dp, mp
    cfg.mesh.spatial_sharding = True
    return jcfg, cfg


def _same_draws(a, b):
    pairs = [(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)]
    return all(x is y or (x is not None and y is not None and torch.equal(x, y))
               for x, y in pairs)


def _references(name, cfg, models, views, draws, mp):
    """(the one-rank step, its split in mp bands in one process, the IN
    shapes of the one-rank step) of a case, computed once for its draws."""
    cached = _REFERENCES.get((name, mp))
    if cached is not None and _same_draws(cached[0], draws):
        return cached[1:]
    in_shapes, plain = [], ink.instance_norm

    def recording(x, *args):
        in_shapes.append(tuple(x.shape))
        return plain(x, *args)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(ink, "instance_norm", recording)
        one_rank = _one_rank(cfg, copy.deepcopy(models), views, draws)
    with split_compute(mp):
        split = _one_rank(cfg, models, views, draws)
    _REFERENCES[name, mp] = (draws, one_rank, split, in_shapes)
    return one_rank, split, in_shapes


def _case(name, cfg, models, views, draws):
    return {"name": name, "config": {**_sections(cfg), "mesh": dataclasses.asdict(cfg.mesh)},
            "weights": [{k: v.clone() for k, v in m.state_dict().items()} for m in models],
            "views": torch.from_numpy(views), "draws": dataclasses.asdict(draws)}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def runs(request, tmp_path_factory):
    dp, mp = LAYOUTS[request.param]
    work = tmp_path_factory.mktemp(f"sp_{request.param}")
    views = np.random.default_rng(1).random((5, BATCH, SIZE, SIZE, 3), np.float32)

    jcfg, cfg = _sp_configs(dp, mp)
    jstate0 = _seeded_jax_state(jcfg)
    mesh = j_make_mesh(jcfg)
    placed = shard_train_state(jax.tree_util.tree_map(jnp.asarray, jstate0), mesh,
                               spatial=True, image_size=SIZE)
    step = jax.jit(j_make_train_step(jcfg, debug_grads=True))
    jnew, jm = step(placed, shard_batch(jnp.asarray(views), mesh, spatial=True),
                    jax.random.PRNGKey(42), jnp.zeros((), jnp.int32))
    jax_draws = Draws(flip=torch.tensor(False), t=torch.tensor(np.asarray(jm["target_label"])),
                      drop=torch.tensor(np.asarray(jm["_drop"])))
    _, qcfg = _sp_configs(dp, mp, **QUALITY)
    qcfg.model.d_input_noise, qcfg.model.d_dropout = 0.1, 0.2
    qcfg.model.specseg_in_channels, qcfg.model.upsample_mode = 2, "resize_conv"
    qcfg.train.remat = "models"
    qcfg.data.flip = True
    q_draws = sample_draws(qcfg, torch.Generator().manual_seed(7), 5, BATCH, SIZE, SIZE)
    q_draws.flip = torch.tensor(True)
    cases, one_rank, split, in_shapes = [], {}, {}, {}
    for name, c, draws in (("jax", cfg, jax_draws), ("draws", qcfg, q_draws)):
        models = (_port_models(c, jstate0) if name == "jax"
                  else build_models(c, device="cpu", seed=3))
        cases.append(_case(name, c, models, views, draws))
        one_rank[name], split[name], in_shapes[name] = _references(name, c, models, views,
                                                                   draws, mp)
    if dp == 1:
        _, gcfg = _sp_configs(dp, mp)
        gcfg.model.image_size = GATHER_SIZE
        g_views = np.random.default_rng(2).random((5, BATCH, GATHER_SIZE, GATHER_SIZE, 3),
                                                  np.float32)
        g_draws = sample_draws(gcfg, torch.Generator().manual_seed(8), 5, BATCH, GATHER_SIZE,
                               GATHER_SIZE)
        models = build_models(gcfg, device="cpu", seed=4)
        cases.append(_case("gather", gcfg, models, g_views, g_draws))
        one_rank["gather"] = _one_rank(gcfg, models, g_views, g_draws)
    torch.save(cases, work / "sp_step_cases.pt")
    ranks = spawn_ranks(work, ["sp_step"], world=dp * mp)
    return dict(layout=(dp, mp), cfg=cfg, jstate0=jstate0, jnew=jnew, jm=jm,
                one_rank=one_rank, split=split, in_shapes=in_shapes["jax"],
                ranks=[r["sp_step"] for r in ranks])


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("net", ["G", "D"])
def test_spatial_gradients_match_jax_mesh(runs, net):
    template = runs["jstate0"].g_params if net == "G" else runs["jstate0"].d_params
    module = _module(runs["cfg"], net)
    want = _flat(runs["jm"]["_grads"][net])
    for r in runs["ranks"]:
        got = _flat(to_flax(module, template, r["jax"]["grads"][net]))
        assert sorted(got) == sorted(want)
        _check_grads(got, want, net)


def test_spatial_losses_match_jax_mesh(runs):
    jm = runs["jm"]
    keys = [k for k in jm if not k.startswith("_")]
    for r in runs["ranks"]:
        assert set(keys) == set(r["jax"]["metrics"])
        for k in keys:
            np.testing.assert_allclose(r["jax"]["metrics"][k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D"])
def test_spatial_params_match_jax_mesh(runs, net):
    old = runs["jstate0"].g_params if net == "G" else runs["jstate0"].d_params
    new = _flat(runs["jnew"].g_params if net == "G" else runs["jnew"].d_params)
    module = _module(runs["cfg"], net)
    module.load_state_dict(runs["ranks"][0]["jax"]["gen" if net == "G" else "disc"])
    got = _flat(to_flax(module, old, dict(module.named_parameters())))
    assert sorted(got) == sorted(new)
    for path, w in new.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2 * LR, err_msg=path)


@pytest.mark.parametrize("case", ["jax", "draws", "gather"])
def test_spatial_matches_one_rank(runs, case):
    """The port on the spatial mesh against the port on one rank, from the
    same weights and global draws: gradients, losses, updated parameters."""
    if case not in runs["one_rank"]:
        assert case == "gather" and runs["layout"][0] > 1
        return
    want, got = runs["one_rank"][case], runs["ranks"][0][case]
    for net in ("G", "D"):
        _check_grads(_np_tree(got["grads"][net]), _np_tree(want["grads"][net]), net)
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].numpy(), w.numpy(), rtol=1e-5,
                                   err_msg=f"{case} {k}")
    for part in ("gen", "disc"):
        for k, w in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), w.numpy(), rtol=0, atol=2 * LR,
                                       err_msg=f"{case} {k}")


def test_spatial_step_is_its_split_in_one_process(runs):
    """The mesh against the same step on one rank computed as its M bands
    in one process (spatial.split_compute): on 1 x 2 the parity step
    bit for bit (gradients, losses, updated parameters); otherwise the
    one-rank tolerances."""
    dp, _ = runs["layout"]
    for case, want in runs["split"].items():
        got = runs["ranks"][0][case]
        exact = dp == 1 and case == "jax"
        for net in ("G", "D"):
            if exact:
                for k, w in want["grads"][net].items():
                    assert torch.equal(got["grads"][net][k], w), (case, net, k)
            else:
                _check_grads(_np_tree(got["grads"][net]), _np_tree(want["grads"][net]), net)
        for k, w in want["metrics"].items():
            if exact:
                assert torch.equal(got["metrics"][k], w), (case, k)
            else:
                np.testing.assert_allclose(got["metrics"][k].numpy(), w.numpy(), rtol=1e-5,
                                           err_msg=f"{case} {k}")
        for part in ("gen", "disc"):
            for k, w in want[part].items():
                if exact:
                    assert torch.equal(got[part][k], w), (case, part, k)
                else:
                    np.testing.assert_allclose(got[part][k].numpy(), w.numpy(), rtol=0,
                                               atol=2 * LR, err_msg=f"{case} {k}")


def test_spatial_ranks_agree_bit_for_bit(runs):
    """Every rank holds the same parameters and (summed, averaged)
    gradients after the step, bit for bit."""
    r0 = runs["ranks"][0]
    for r in runs["ranks"][1:]:
        for case in r0:
            for part in ("gen", "disc"):
                for k in r0[case][part]:
                    assert torch.equal(r0[case][part][k], r[case][part][k]), (case, part, k)
            for net in ("G", "D"):
                for k in r0[case]["grads"][net]:
                    assert torch.equal(r0[case]["grads"][net][k], r[case]["grads"][net][k])


def test_spatial_instance_norm_runs_on_bands(runs):
    """46 IN calls a step a rank, in the one-rank step's order, each on
    H / M of its rows through the band entry point and on the data index's
    images; at 32 px only D's last block (live and frozen) runs whole."""
    dp, mp = runs["layout"]
    whole = runs["in_shapes"]
    assert len(whole) == 46
    for r in runs["ranks"]:
        calls = r["jax"]["in_shapes"]
        assert len(calls) == 46
        for (kind, (b, c, h, w)), (wb, wc, wh, ww) in zip(calls, whole):
            assert kind == "band" and (b * dp, c, h * mp, w) == (wb, wc, wh, ww)
        if dp == 1:
            kinds = [kind for kind, _ in r["gather"]["in_shapes"]]
            assert len(kinds) == 46 and kinds.count("whole") == 2
