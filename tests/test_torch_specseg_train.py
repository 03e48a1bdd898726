"""SpecSeg training on the port against the JAX package's, on the CPU: the
losses, the learning-rate schedule, SpecSeg's train mode, three
`make_specseg_train_step` steps, the SpecSeg file, the flagship trainer's
phase A (shmgan_tpu_torch/quality_train.py against examples/quality_train.py),
and the chroma prior's quantiles at and past 2^24 pixels.

SpecSeg at base 4, 32 px, batch 3, f32; its weights drawn by the port's init
and converted. Dropout: flax's `Dropout.__call__` is patched in this file to
take the test's numpy keep masks, in call order, as `lax.select(keep,
x / keep_prob, 0)`; the port takes the same masks (NCHW). JAX's step is
jitted once with the masks as arguments.

Tolerances:
  - losses and the chroma prior within 1e-6 (f32, the same operations);
    `_per_image_quantile` exactly (the same two sorted values, the same f32
    weights);
  - the train-mode forward within 1e-5, the new batch statistics within
    1e-5 relative, gradients within 1e-4 of the largest of their leaf
    (convolutions sum in another order);
  - three train steps: metrics within 1e-5 relative, batch statistics and
    Adam moments within 1e-4 relative to their leaf's scale, parameters
    within 6 lr (an Adam step moves a leaf by about lr whatever its
    gradient's size, so a gradient within rounding of zero may step either
    way; measured far below);
  - the exported file byte for byte; JAX's SpecSeg on the port's file within
    1e-5 of the port's mask.
"""

import contextlib
import dataclasses
import importlib.util
import json
import os

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from shmgan_tpu.checkpoint import load_specseg_msgpack as j_load_specseg_msgpack
from shmgan_tpu.checkpoint import save_specseg_msgpack as j_save_specseg_msgpack
from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.models import SpecSeg as JSpecSeg
from shmgan_tpu.ops import specprior as j_specprior
from shmgan_tpu.train import losses as j_losses
from shmgan_tpu.train import specseg_train as j_specseg_train
from shmgan_tpu_torch import quality_train
from shmgan_tpu_torch.checkpoint import (load_specseg_msgpack, load_specseg_weights,
                                         save_specseg_msgpack, specseg_msgpack_in_channels)
from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.convert import flax_tree, load_flax, to_flax
from shmgan_tpu_torch.ops import specprior
from shmgan_tpu_torch.train import losses
from shmgan_tpu_torch.train.specseg_train import (create_specseg_state, make_specseg_train_step,
                                                  specseg_vars_from_state, train_specseg)
from shmgan_tpu_torch.train.state import lr_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BASE, B = 32, 4, 3
LR = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores; torch on one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


# -- the chroma prior's quantiles -----------------------------------------------------

def test_per_image_quantile_past_2_24_matches_jnp_quantile():
    """A row of 2^24 + 64 elements, which torch.quantile refuses."""
    x = np.random.default_rng(0).random((1, 2 ** 24 + 64, 1, 1), np.float32)
    ref = np.asarray(jnp.quantile(jnp.asarray(x).reshape(1, -1), jnp.asarray([0.5, 0.9]),
                                  axis=1))
    for q, r in zip((0.5, 0.9), ref[:, 0]):
        got = specprior._per_image_quantile(t(x), q)
        assert got.shape == (1, 1, 1, 1)
        assert got.item() == r, (q, got.item(), r)


def test_chroma_prior_even_pixel_count_matches_jax():
    """6 x 10 pixels: the median averages the middle pair, as jnp.median."""
    rgb = np.random.default_rng(1).random((2, 6, 10, 3), np.float32)
    rgb[0, :2, :3] = 0.97  # a bright, desaturated patch
    mn = rgb.min(-1, keepdims=True)
    np.testing.assert_array_equal(specprior._per_image_median(t(mn)).numpy(),
                                  np.asarray(j_specprior._per_image_median(jnp.asarray(mn))))
    np.testing.assert_allclose(specprior.chroma_prior(t(rgb)).numpy(),
                               np.asarray(j_specprior.chroma_prior(jnp.asarray(rgb))), atol=1e-6)


# -- losses, schedule -------------------------------------------------------------------

def test_specseg_losses_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.random((B, SIZE, SIZE, 1), np.float32)
    pred[0, 0, :4, 0] = [0.0, 1.0, 1e-9, 1 - 1e-9]  # the clip before the logs
    mask = (rng.random((B, SIZE, SIZE, 1)) < 0.2).astype(np.float32)
    for port, jfn in ((losses.dice_loss, j_losses.dice_loss),
                      (losses.binary_focal_loss, j_losses.binary_focal_loss),
                      (losses.specseg_loss, j_losses.specseg_loss)):
        got = port(t(pred), t(mask)).item()
        ref = float(jfn(jnp.asarray(pred), jnp.asarray(mask)))
        assert np.isfinite(got) and abs(got - ref) <= 1e-6 * max(1.0, abs(ref)), (port, got, ref)


def test_lr_schedule_matches_optax():
    sched = lr_schedule(2e-4, 100, 0.5)
    ref = optax.exponential_decay(2e-4, 100, 0.5, staircase=False)
    for count in (0, 1, 50, 100, 333):
        assert sched(count) == pytest.approx(float(ref(count)), rel=1e-6)


# -- SpecSeg in train mode ---------------------------------------------------------------

_KEEPS = []


@contextlib.contextmanager
def injected_dropout():
    """flax's Dropout takes the next of _KEEPS (NHWC) instead of its rng."""
    def call(self, inputs, deterministic=None, rng=None):
        if fnn.merge_param("deterministic", self.deterministic, deterministic):
            return inputs
        keep = _KEEPS.pop(0)
        return lax.select(keep, inputs / (1.0 - self.rate), jnp.zeros_like(inputs))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", call)
        yield


def _cfg(in_channels=1):
    cfg = Config()
    cfg.model.image_size, cfg.model.specseg_base_filters = SIZE, BASE
    cfg.model.specseg_in_channels = in_channels
    cfg.train.g_lr = LR
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(jcfg.model, image_size=SIZE, specseg_base_filters=BASE,
                                     specseg_in_channels=in_channels)
    jcfg.train = dataclasses.replace(jcfg.train, g_lr=LR)
    return cfg, jcfg


def _batches(n, in_channels=1):
    rng = np.random.default_rng(3)
    images = rng.standard_normal((n, B, SIZE, SIZE, in_channels)).astype(np.float32) * 3
    masks = (rng.random((n, B, SIZE, SIZE, 1)) < 0.25).astype(np.float32)
    return images, masks


def _keeps(net, n):
    """n steps' 9 keep masks each, numpy NCHW."""
    g = torch.Generator().manual_seed(4)
    return [[k.numpy() for k in net.sample_keep(g, B, SIZE, SIZE)] for _ in range(n)]


def _nhwc(keeps):
    return [jnp.asarray(k.transpose(0, 2, 3, 1)) for k in keeps]


@pytest.fixture(scope="module")
def trained():
    """Three steps of each side from the same weights, batches and masks."""
    cfg, jcfg = _cfg()
    state = create_specseg_state(cfg, torch.Generator().manual_seed(5), "cpu")
    init = specseg_vars_from_state(state)
    images, masks = _batches(3)
    keeps = _keeps(state.net, 3)

    # the init's shapes (optimizer state zero, as tx.init gives it), then the
    # port's weights
    jstate = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda r: j_specseg_train.create_specseg_state(jcfg, r),
                       jax.random.PRNGKey(0)))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, init["params"]),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, init["batch_stats"]))
    step = j_specseg_train.make_specseg_train_step(jcfg)

    @jax.jit
    def jstep(st, img, msk, keep):
        _KEEPS[:] = list(keep)
        return step(st, img, msk, jax.random.PRNGKey(0))

    jmetrics, pmetrics = [], []
    port_step = make_specseg_train_step(cfg)
    with injected_dropout():
        for i in range(3):
            jstate, m = jstep(jstate, jnp.asarray(images[i]), jnp.asarray(masks[i]),
                              _nhwc(keeps[i]))
            jmetrics.append({k: float(v) for k, v in m.items()})
            state, m = port_step(state, t(images[i]), t(masks[i]), [t(k) for k in keeps[i]])
            pmetrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=cfg, jcfg=jcfg, state=state, jstate=jstate, init=init, jm=jmetrics,
                pm=pmetrics)


def _leaves(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(flax.core.unfreeze(tree)).items()}


def test_train_mode_forward_batch_stats_and_gradients_match_flax(trained):
    cfg, init = trained["cfg"], trained["init"]
    state = create_specseg_state(cfg, None, "cpu")
    load_flax(state.net, init["params"], init["batch_stats"])
    images, masks = _batches(1)
    keeps = _keeps(state.net, 1)[0]

    pred, stats = state.net(t(images[0]), train=True, keep=[t(k) for k in keeps])
    loss = losses.specseg_loss(pred, t(masks[0]))
    names = [n for n, _ in state.net.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in state.net.named_parameters()])
    port_grads = {n: g for n, g in zip(names, grads)}

    net = JSpecSeg(base_filters=BASE)

    def loss_fn(params, keep):
        _KEEPS[:] = list(keep)
        out, mutated = net.apply({"params": params, "batch_stats": init["batch_stats"]},
                                 jnp.asarray(images[0]), train=True, mutable=["batch_stats"])
        return j_losses.specseg_loss(out, jnp.asarray(masks[0])), (out, mutated["batch_stats"])

    with injected_dropout():
        jgrads, (jpred, jstats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, init["params"]), _nhwc(keeps))
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred), atol=1e-5)
    got_stats = _leaves({k: {"bn": {s: v.numpy() for s, v in n["bn"].items()}}
                         for k, n in stats.items()})
    for k, ref in _leaves(jstats).items():
        np.testing.assert_allclose(got_stats[k], ref, rtol=1e-5, atol=1e-7, err_msg=k)
    got = _leaves(to_flax(state.net, init["params"], port_grads))
    for k, ref in _leaves(jgrads).items():
        np.testing.assert_allclose(got[k], ref, atol=1e-4 * np.abs(ref).max(), rtol=0,
                                   err_msg=k)


def test_eval_mode_unchanged_by_train_mode(trained):
    """Train mode leaves the module's running statistics to the step, and
    eval mode reads them as before."""
    state = trained["state"]
    x = t(_batches(1)[0][0])
    before = [b.clone() for b in state.net.buffers()]
    state.net(x, train=True, keep=state.net.sample_keep(torch.Generator(), B, SIZE, SIZE))
    assert all(torch.equal(a, b) for a, b in zip(before, state.net.buffers()))
    with pytest.raises(ValueError, match="keep masks"):
        state.net(x, train=True)


def test_three_train_steps_match_jax(trained):
    state, jstate = trained["state"], trained["jstate"]
    for pm, jm in zip(trained["pm"], trained["jm"]):
        for k in ("dice", "focal", "loss", "iou"):
            assert pm[k] == pytest.approx(jm[k], rel=1e-5, abs=1e-7), (k, pm, jm)
    assert state.step == int(jstate.step) == 3
    got = specseg_vars_from_state(state)
    for k, ref in _leaves(jstate.params).items():
        assert np.abs(_leaves(got["params"])[k] - ref).max() <= 6 * LR, k
    moved = sum(np.abs(ref - _leaves(trained["init"]["params"])[k]).max() > 0
                for k, ref in _leaves(jstate.params).items())
    assert moved == len(_leaves(jstate.params))
    for k, ref in _leaves(jstate.batch_stats).items():
        np.testing.assert_allclose(_leaves(got["batch_stats"])[k], ref,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)
    mu, nu = state.opt.moments()
    adam = jstate.opt_state[1]
    for tree, ref in ((mu, adam.mu), (nu, adam.nu)):
        got_m = _leaves(to_flax(state.net, trained["init"]["params"], tree))
        for k, r in _leaves(ref).items():
            np.testing.assert_allclose(got_m[k], r, atol=1e-4 * np.abs(r).max(), err_msg=k)
    assert state.opt.count == int(adam.count) == 3


def test_train_specseg_runs():
    cfg, _ = _cfg()
    images, masks = _batches(1)
    state = train_specseg(cfg, images[0], masks[0], num_steps=2, batch_size=2, device="cpu")
    assert state.step == 2 and state.opt.count == 2


# -- the SpecSeg file -----------------------------------------------------------------------

@pytest.mark.parametrize("in_channels", [1, 2])
def test_specseg_file_is_jax_bytes_and_jax_reads_it(tmp_path, in_channels):
    cfg, _ = _cfg(in_channels)
    state = create_specseg_state(cfg, torch.Generator().manual_seed(6), "cpu")
    with torch.no_grad():  # running statistics other than the identity
        for i, b in enumerate(state.net.buffers()):
            if b.is_floating_point():
                b.add_(0.1 * (i + 1))
    variables = specseg_vars_from_state(state)
    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    save_specseg_msgpack(variables, ours)
    j_save_specseg_msgpack({"params": variables["params"],
                            "batch_stats": variables["batch_stats"]}, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert specseg_msgpack_in_channels(ours) == in_channels
    loaded = load_specseg_weights(ours)
    assert _leaves(loaded).keys() == _leaves(variables).keys()
    with pytest.raises(ValueError, match="input channels"):
        load_specseg_msgpack(ours, in_channels=3 - in_channels)

    jvars = j_load_specseg_msgpack(ours, base_filters=BASE, image_size=SIZE)
    x = np.random.default_rng(7).standard_normal((2, SIZE, SIZE, in_channels)).astype(np.float32)
    ref = JSpecSeg(base_filters=BASE).apply(jvars, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = state.net(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_h5_weights_still_refused(tmp_path):
    """A name other than .msgpack goes to the Keras h5 reader (as in the JAX
    package), which refuses a file that is not HDF5: here a SpecSeg msgpack
    under the reference's h5 name."""
    path = str(tmp_path / "specsegv3_chkpt.h5")
    save_specseg_msgpack({"params": {"w": np.ones(2, np.float32)}}, path)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        load_specseg_weights(path)


# -- the flagship trainer's phase A ------------------------------------------------------------

def _jax_quality_train():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_train", os.path.join(REPO, "examples", "quality_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(out, *extra):
    return ["--cpu", "--phase", "specseg", "--image_size", str(SIZE),
            "--specseg_base_filters", str(BASE), "--specseg_batch", "2", "--specseg_steps",
            "4", "--chunk", "2", "--out", str(out), *extra]


@pytest.fixture(scope="module")
def jax_summary(tmp_path_factory):
    """JAX's phase A on the base curriculum, 2 steps: its summary's keys.
    Its state starts from zeros of the init's shapes (`jax.eval_shape`):
    JAX's eager init compiles op by op for tens of seconds here."""
    real = j_specseg_train.create_specseg_state

    def zeros_state(cfg, rng):
        shapes = jax.eval_shape(lambda r: real(cfg, r), rng)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    out = tmp_path_factory.mktemp("jax_q")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_specseg_train, "create_specseg_state", zeros_state)
        return _jax_quality_train().main(_argv(out, "--specseg_steps", "2"))


def test_flags_and_defaults_are_jaxs():
    jq = _jax_quality_train()
    assert vars(quality_train.parse_args([])) == vars(jq.parse_args([]))
    argv = ["--specseg_curriculum", "dr3", "--specseg_in_channels", "2", "--phase", "specseg",
            "--specseg_probe", "ood", "--dtype", "float32", "--batch", "3", "--seed", "9"]
    a, ja = quality_train.parse_args(argv), jq.parse_args(argv)
    assert vars(a) == vars(ja)
    cfg, jcfg = quality_train.build_cfg(a), jq.build_cfg(ja)
    for part in ("model", "train"):
        ours = dataclasses.asdict(getattr(cfg, part))
        for k, v in dataclasses.asdict(getattr(jcfg, part)).items():
            if k in ours:
                assert ours[k] == v, (part, k)


@pytest.mark.parametrize("curriculum,in_channels", [("base", 1), ("dr2", 2)])
def test_phase_a_on_the_cpu(tmp_path, jax_summary, curriculum, in_channels):
    summary = quality_train.main(_argv(tmp_path, "--specseg_curriculum", curriculum,
                                       "--specseg_in_channels", str(in_channels)))
    with open(tmp_path / "quality_summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    assert summary.keys() == jax_summary.keys()
    assert summary["args"].keys() == jax_summary["args"].keys()
    ss, jss = summary["specseg"], jax_summary["specseg"]
    assert ss.keys() == jss.keys() and ss["selected"].keys() == jss["selected"].keys()
    assert ss["steps"] == 4 and ss["curriculum"] == curriculum
    assert ss["in_channels"] == in_channels and ss["selected"]["step"] == 4
    assert (ss["selected"]["heldout_dr_iou"] is None) == (curriculum == "base")
    variables = load_specseg_weights(ss["weights"])
    assert specseg_msgpack_in_channels(ss["weights"]) == in_channels
    assert all(np.isfinite(v).all() for v in _leaves(variables).values())


@pytest.mark.parametrize("scores,kind", [((0.2, 0.6), "ema"), ((0.6, 0.2), "live")])
def test_phase_a_exports_the_best_of_live_and_ema(tmp_path, monkeypatch, scores, kind):
    """A scripted probe: the export is the snapshot it scored best."""
    seen, states = [], []
    real_create = quality_train.create_specseg_state

    def create(*a, **k):
        states.append(real_create(*a, **k))
        return states[-1]

    def make_probe(a, device):
        def probe(net):
            seen.append(flax_tree(net))
            return scores[len(seen) - 1], 0.1 * len(seen), None
        return probe

    monkeypatch.setattr(quality_train, "create_specseg_state", create)
    monkeypatch.setattr(quality_train, "make_probe", make_probe)
    summary = quality_train.main(_argv(tmp_path))["specseg"]
    assert len(seen) == 2
    best = int(np.argmax(scores))
    assert summary["selected"] == {"score": scores[best], "step": 4, "kind": kind,
                                   "heldout_dr_iou": None}
    assert summary["heldout_iou"] == pytest.approx(0.1 * (best + 1))
    exported = _leaves(load_specseg_weights(summary["weights"]))
    for k, v in _leaves({"params": seen[best][0], "batch_stats": seen[best][1]}).items():
        np.testing.assert_array_equal(exported[k], v, err_msg=k)
    live = _leaves(specseg_vars_from_state(states[0]))
    differs = any(not np.array_equal(exported[k], live[k]) for k in live if "params" in k)
    assert differs == (kind == "ema")


BUNDLE_256 = os.path.join(REPO, "artifacts", "shmgan_infer_256.msgpack")  # resize_conv


@pytest.mark.parametrize("argv,match", [
    pytest.param(["--init_from", "ckpt", "--init_from_bundle", BUNDLE_256],
                 "mutually exclusive", id="argv0-phase B"),
    pytest.param(["--phase", "gan", "--init_from_bundle", BUNDLE_256],
                 "upsample_mode=resize_conv; pass --upsample_mode", id="argv1-phase B"),
    pytest.param(["--phase", "both", "--init_from", "empty"], "no checkpoint found",
                 id="argv2-phase B"),
    pytest.param(["--phase", "specseg", "--data_parallel", "2"],
                 "torchrun --nproc_per_node 2", id="argv3-item 11")])
def test_phase_a_refusals(tmp_path, argv, match):
    """What the trainer refuses before any work: both warm starts at once, a
    bundle of another upsample_mode, an --init_from without a checkpoint
    (phase B, also under --phase both), and data parallelism without a
    launcher's process group."""
    out = tmp_path / "never"
    (tmp_path / "empty").mkdir()
    argv = [str(tmp_path / a) if a in ("ckpt", "empty") else a for a in argv]
    error = RuntimeError if "torchrun" in match else SystemExit
    with pytest.raises(error, match=match):
        quality_train.main(argv + ["--cpu", "--out", str(out)])
    assert not out.exists()
