"""The port's train step against JAX `make_train_step(debug_grads=True)` on the
CPU, leaf for leaf, at a small width: filter 8, batch 2, SpecSeg base 4, f32
(compute_dtype "float32" on both sides: the port's config copies every field
of the JAX one), at the configuration's own 128 px. (At 32 px D's last
instance norm normalises 1x1 planes, so D's outputs do not depend on its
input and 18 of its 21 gradient leaves are exactly zero; G's bottleneck
normalises 2x2 planes.)

Both steps start from one state: JAX's `create_train_state`, carried into the
port by convert.py. D's noise and dropout are off and the flip is off, as in
tests/test_grad_equivalence.py; the label t and the drop pattern are taken
from the JAX step's metrics and injected into the port's.

Tolerances:
  - every D gradient leaf rtol 2e-3, atol 2e-6, element by element (those of
    tests/test_grad_equivalence.py);
  - G's gradients as a whole: ||port - jax|| <= 2e-3 ||jax|| (measured:
    3e-5 with the parity flags, 1.3e-4 with the quality flags), and each G
    leaf within 1e-1 of its own largest magnitude (measured: 3.6e-2 at
    worst, on up1_0's conv bias). Element by element at 2e-3 / 2e-6 G's
    leaves do not hold across frameworks in f32: each conv feeds leaky_relu
    then instance norm, whose input gradient sums to zero over a plane, so
    a conv bias's gradient (and the plane-mean part of its kernel's) is the
    small residue of a cancelling sum. JAX's own f32 gradients differ from
    the port's computed in float64 by up to 1e-2 of a leaf's largest
    magnitude there, and so do the port's in f32, at other leaves;
  - every loss rtol 1e-5;
  - the updated params and the EMA within 2 * lr, since one Adam step moves
    a leaf by about lr at most, whatever the sign of a near-zero gradient.

Run twice: with the reference-parity flags, and with the quality flags
(live_g1, g1_recon_weight, consistent_domains, per-sample drops, the
single-input pattern, the EMA), so that those branches are held too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shmgan_tpu.config import Config as JConfig
from shmgan_tpu.train.state import create_train_state as j_create_train_state
from shmgan_tpu.train.step import make_train_step as j_make_train_step
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.convert import load_flax, to_flax
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.train.state import create_train_state
from shmgan_tpu_torch.train.step import Draws, make_train_step

LR = 2e-5
SIZE = 128
FLAGS = {
    "parity": {},
    "quality": dict(live_g1=True, g1_recon_weight=0.5, consistent_domains=True,
                    scalar_channel_dropout=False, single_input_prob=0.5, g_ema=0.9),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once, and torch's thread
    pool then contends with theirs (a step here ran ~100x slower than alone),
    so the port runs on one thread in these tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(flags):
    jcfg = JConfig()
    jcfg.model = dataclasses.replace(jcfg.model, image_size=SIZE, filter_size=8,
                                     specseg_base_filters=4, d_input_noise=0.0,
                                     d_dropout=0.0, compute_dtype="float32")
    jcfg.train = dataclasses.replace(jcfg.train, batch_size=2, g_lr=LR, d_lr=LR, **flags)
    jcfg.data = dataclasses.replace(jcfg.data, flip=False)
    cfg = Config()
    for section in ("model", "train", "data", "eval"):
        for f in dataclasses.fields(getattr(cfg, section)):
            setattr(getattr(cfg, section), f.name, getattr(getattr(jcfg, section), f.name))
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_state():
    jcfg, _ = _configs({})
    return jax.jit(lambda k: j_create_train_state(jcfg, k))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=list(FLAGS))
def run(request, jax_state):
    """One JAX step and one port step from the same state and draws."""
    jcfg, cfg = _configs(FLAGS[request.param])
    state = jax_state
    if cfg.train.g_ema > 0:
        state = state.replace(ema_g_params=jax.tree_util.tree_map(jnp.copy, state.g_params))
    views = np.random.default_rng(1).random((5, 2, SIZE, SIZE, 3), np.float32)
    step = jax.jit(j_make_train_step(jcfg, debug_grads=True))
    new_jstate, jm = step(state, jnp.asarray(views), jax.random.PRNGKey(42),
                          jnp.zeros((), jnp.int32))

    gen, disc, specseg = build_models(cfg, device="cpu")
    load_flax(gen, state.g_params)
    load_flax(disc, state.d_params)
    load_flax(specseg, state.specseg_vars["params"], state.specseg_vars["batch_stats"])
    tstate = create_train_state(cfg, (gen, disc, specseg))
    draws = Draws(flip=torch.tensor(False), t=torch.tensor(np.asarray(jm["target_label"])),
                  drop=torch.tensor(np.asarray(jm["_drop"])))
    tstate, tm = make_train_step(cfg, debug_grads=True)(tstate, torch.from_numpy(views),
                                                        draws, 0)
    return dict(cfg=cfg, old=state, new=new_jstate, jm=jm, tstate=tstate, tm=tm)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _compare_trees(got, want, **tol):
    got_flat = dict((jax.tree_util.keystr(p), v) for p, v in _leaves(got))
    want_flat = _leaves(want)
    assert len(got_flat) == len(want_flat)
    for path, w in want_flat:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got_flat[key], np.asarray(w), err_msg=key, **tol)


@pytest.mark.parametrize("net", ["G", "D"])
def test_gradients_match_jax(run, net):
    module = run["tstate"].gen if net == "G" else run["tstate"].disc
    template = run["old"].g_params if net == "G" else run["old"].d_params
    got = to_flax(module, template, run["tm"]["_grads"][net])
    want = run["jm"]["_grads"][net]
    if net == "D":
        _compare_trees(got, want, rtol=2e-3, atol=2e-6)
        return
    pairs = [(jax.tree_util.keystr(p), np.asarray(a), np.asarray(b))
             for (p, b), (_, a) in zip(_leaves(want), _leaves(got))]
    assert len(pairs) == len(_leaves(template))
    diff = np.sqrt(sum(np.sum((a - b) ** 2) for _, a, b in pairs))
    norm = np.sqrt(sum(np.sum(b ** 2) for _, _, b in pairs))
    assert diff <= 2e-3 * norm, (diff, norm)
    for key, a, b in pairs:
        assert np.abs(a - b).max() <= 1e-1 * np.abs(b).max(), key


def test_losses_match_jax(run):
    jm, tm = run["jm"], run["tm"]
    keys = [k for k in jm if not k.startswith("_")]
    assert set(keys) == {k for k in tm if not k.startswith("_")}
    for k in keys:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D"])
def test_updated_params_match_jax(run, net):
    module = run["tstate"].gen if net == "G" else run["tstate"].disc
    want = run["new"].g_params if net == "G" else run["new"].d_params
    old = run["old"].g_params if net == "G" else run["old"].d_params
    got = to_flax(module, old, dict(module.named_parameters()))
    _compare_trees(got, want, rtol=0, atol=2 * LR)
    moved = sum(not np.array_equal(np.asarray(a), np.asarray(b))
                for (_, a), (_, b) in zip(_leaves(want), _leaves(old)))
    assert moved == len(_leaves(old))


def test_ema_and_step_count_match_jax(run):
    tstate, new = run["tstate"], run["new"]
    assert tstate.step == int(new.step) == 1
    if run["cfg"].train.g_ema == 0:
        assert tstate.ema_g is None and new.ema_g_params is None
        return
    got = to_flax(tstate.gen, run["old"].g_params, tstate.ema_g)
    _compare_trees(got, new.ema_g_params, rtol=0, atol=2 * LR)
