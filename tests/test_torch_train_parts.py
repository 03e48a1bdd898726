"""The pieces of the port's train step against the JAX package on the CPU:
config defaults, the discriminator, SSIM and the loss zoo, the optimizer,
instance norm's backward and its autograd wiring, and `sample_draws`'
distributions. Inputs and weights are numpy draws from fixed seeds, handed
to both sides.

Tolerances: D rtol 1e-5 / atol 1e-6 in eval mode, atol 1e-5 with noise or
dropout (convolutions summed in another order; the noisy input and the
1/0.8-scaled features give O(1) logits that differ by up to 2e-6);
losses and SSIM rtol 1e-5 (atol 1e-7 for SSIM, a difference of near-equal
terms); optimizer rtol 1e-5; IN backward rtol 2e-3 / atol 1e-4, as
tests/test_pallas_in.py holds the Pallas kernel's VJP; draws within 5
standard errors of their expected rates.
"""

import copy
import dataclasses

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shmgan_tpu import config as jconfig
from shmgan_tpu.models.discriminator import SHMDiscriminator as JDisc
from shmgan_tpu.ops.pallas.instance_norm import instance_norm_reference
from shmgan_tpu.ops.ssim import ssim as j_ssim
from shmgan_tpu.train import losses as jlosses
from shmgan_tpu.train.state import make_optimizer as j_make_optimizer
from shmgan_tpu_torch import Config
from shmgan_tpu_torch import config as tconfig
from shmgan_tpu_torch.convert import load_flax, to_flax
from shmgan_tpu_torch.models import SHMDiscriminator, build_models
from shmgan_tpu_torch.ops.kernels import instance_norm as ink
from shmgan_tpu_torch.ops.ssim import ssim
from shmgan_tpu_torch.train import losses
from shmgan_tpu_torch.train.state import create_train_state, make_optimizer
from shmgan_tpu_torch.train.step import make_scan_train_steps, make_train_step, sample_draws

N, SIZE, B, C_DIM = 8, 64, 2, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once, and torch's thread
    pool then contends with theirs (a step here ran ~100x slower than alone),
    so the port runs on one thread in these tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["ModelConfig", "TrainConfig", "DataConfig", "EvalConfig"])
def test_config_defaults_match_jax(name):
    jdefaults = getattr(jconfig, name)()
    for f in dataclasses.fields(getattr(tconfig, name)):
        assert getattr(jdefaults, f.name) == f.default or (
            f.default is dataclasses.MISSING), f"{name}.{f.name}"


class TestDiscriminator:
    @pytest.fixture(scope="class")
    def weights(self):
        shapes = jax.eval_shape(lambda: JDisc(filter_size=N, c_dim=C_DIM).init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, SIZE, SIZE, 1))))
        flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(shapes["params"]))
        rng = np.random.default_rng(5)
        drawn = {}
        for path, leaf in flat.items():
            v = rng.standard_normal(leaf.shape).astype(np.float32)
            drawn[path] = 1.0 + 0.1 * v if path[-1] == "scale" else 0.05 * v
        return flax.traverse_util.unflatten_dict(drawn)

    def _inputs(self):
        img = np.random.default_rng(6).random((2 * B, SIZE, SIZE, 3), np.float32)
        mask = np.random.default_rng(7).random((2 * B, SIZE, SIZE, 1), np.float32)
        return img, mask

    def _port(self, params, rate=0.2):
        d = SHMDiscriminator(filter_size=N, c_dim=C_DIM, image_size=SIZE, dropout_rate=rate)
        return load_flax(d, params)

    def _close(self, got, want, atol=1e-6):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=atol)

    def test_eval_mode(self, weights):
        img, mask = self._inputs()
        want = JDisc(filter_size=N, c_dim=C_DIM).apply({"params": weights}, img, mask,
                                                       train=False)
        got = self._port(weights)(_t(img), _t(mask))
        assert got[0].shape == (2 * B, 2, 2, 1) and got[1].shape == (2 * B, C_DIM)
        self._close(got, want)

    def test_noise_path(self, weights):
        img, mask = self._inputs()
        noise = _np(8, (2 * B, 3, SIZE, SIZE))
        want = JDisc(filter_size=N, c_dim=C_DIM).apply(
            {"params": weights}, img + 0.1 * noise.transpose(0, 2, 3, 1), mask, train=False)
        keep = torch.ones((2 * B, 16 * N, 2, 2))
        got = self._port(weights, rate=0.0)(_t(img), _t(mask), noise=_t(noise), keep=keep)
        self._close(got, want, atol=1e-5)

    def test_dropout_path(self, weights):
        img, mask = self._inputs()
        keep = np.random.default_rng(9).random((2 * B, 16 * N, 2, 2)) < 0.8

        def fixed_mask(next_fun, args, kwargs, context):
            if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
                x = args[0]
                return jnp.where(keep.transpose(0, 2, 3, 1), x / 0.8, 0.0)
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(fixed_mask):
            want = JDisc(filter_size=N, c_dim=C_DIM, noise_stddev=0.0, dropout_rate=0.2).apply(
                {"params": weights}, img, mask, train=True)
        no_drop = JDisc(filter_size=N, c_dim=C_DIM).apply({"params": weights}, img, mask,
                                                          train=False)
        assert not np.allclose(np.asarray(want[1]), np.asarray(no_drop[1]))
        got = self._port(weights)(_t(img), _t(mask), keep=_t(keep))
        self._close(got, want, atol=1e-5)

    def test_seeded_init_scales(self):
        cfg = Config()
        cfg.model.filter_size, cfg.model.specseg_base_filters = N, 4
        _, disc, _ = build_models(cfg, device="cpu", seed=0)
        assert abs(disc.block3.conv.weight.std().item() - 0.02) < 0.002
        assert disc.out_class.weight.shape == (C_DIM, 16 * N * 4 * 4)  # 128 px
        assert torch.equal(disc.block4.inorm.scale, torch.ones(16 * N))

    def test_dense_round_trips_through_flax_layout(self, weights):
        d = self._port(weights)
        back = to_flax(d, weights, dict(d.named_parameters()))
        for path, leaf in flax.traverse_util.flatten_dict(weights).items():
            got = flax.traverse_util.flatten_dict(back)[path]
            np.testing.assert_array_equal(got, leaf, err_msg=str(path))


def _loss_inputs(seed):
    v, h = C_DIM, SIZE
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        rf_gen=f(B, 1, 1, 1), lbl_gen=f(B, C_DIM), rf_target=f(B, 1, 1, 1),
        rf_cyc=f(v, B, 1, 1, 1), lbl_cyc=f(v, B, C_DIM), rf_orig=f(v, B, 1, 1, 1),
        lbl_orig=f(v, B, C_DIM), gen_rgb=f(B, h, h, 3), cyc_rgb=f(v, B, h, h, 3),
        cyc_yuv=f(v, B, h, h, 3), orig_rgb=r.random((v, B, h, h, 3), np.float32),
        ds_yuv=f(v, B, h, h, 3), mask=r.random((B, h, h, 1), np.float32),
        drop=(r.random((B, v)) < 0.5).astype(np.float32),
        target_label=np.float32(1.07))


@pytest.mark.parametrize("drop_rows", [1, B], ids=["scalar-drop", "per-sample-drop"])
def test_every_loss_matches_jax(drop_rows):
    inp = _loss_inputs(21)
    inp["drop"] = inp["drop"][:drop_rows]
    want = jlosses.shmgan_losses(
        jlosses.GanLossInputs(**{k: jnp.asarray(v) for k, v in inp.items()}), image_size=SIZE)
    got = losses.shmgan_losses(
        losses.GanLossInputs(**{k: torch.tensor(v) for k, v in inp.items()}), image_size=SIZE)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)


def test_ssim_matches_jax():
    a = np.random.default_rng(1).random((3, 24, 20, 3), np.float32)
    b = np.clip(a + _np(2, a.shape, 0.1), 0, 1)
    got = ssim(_t(a), _t(b), max_val=1.0).numpy()
    np.testing.assert_allclose(got, np.asarray(j_ssim(a, b, max_val=1.0)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ssim(_t(a), _t(a), max_val=5.0).numpy(), 1.0, rtol=1e-6)


def test_optimizer_matches_optax_chain():
    jcfg, cfg = jconfig.Config(), Config()
    for c in (jcfg.train, cfg.train):
        c.lr_decay_steps = 2  # the decay shows within three steps
    lr = 1e-2
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: _np(i, s) for i, (k, s) in enumerate(shapes.items())}
    tx = j_make_optimizer(lr, jcfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tparams, lr, cfg)
    for step in range(3):
        # some gradients beyond the clip of 1
        grads = {k: _np(10 + 3 * step + i, s, 2.0) for i, (k, s) in enumerate(shapes.items())}
        updates, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate,
                                    jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        opt.step({k: _t(g) for k, g in grads.items()})
    mu, nu = opt.moments()
    adam = jstate[1]
    for k in shapes:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(mu[k].numpy(), np.asarray(adam.mu[k]), rtol=1e-5)
        np.testing.assert_allclose(nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-5)
    assert opt.count == int(adam.count) == 3


IN_SHAPES = [(4, 8, 16, 16), (2, 16, 8, 8), (3, 32, 4, 4), (2, 6, 7, 9), (1, 3, 5, 3)]


def _stats(x):
    mean = x.mean(dim=(2, 3))
    var = (x - mean[:, :, None, None]).square().mean(dim=(2, 3))
    return mean, torch.rsqrt(var + 1e-6)


@pytest.mark.parametrize("shape", IN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_instance_norm_backward_plain_matches_jax_grad(shape):
    b, c, h, w = shape
    x = _np(31, shape, 2.0) + 0.5
    g = _np(32, shape)
    gamma, beta = 1.0 + _np(33, (c,), 0.2), _np(34, (c,), 0.1)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    _, vjp = jax.vjp(lambda x_, g_, b_: instance_norm_reference(x_, g_, b_, 1e-6),
                     nhwc(x), jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdgamma, jdbeta = vjp(nhwc(g))
    mean, rstd = _stats(_t(x))
    dx, dgamma, dbeta = ink.instance_norm_backward_plain(_t(x), _t(gamma), mean, rstd, _t(g))
    tol = dict(rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx).transpose(0, 3, 1, 2), **tol)
    np.testing.assert_allclose(dgamma.numpy(), np.asarray(jdgamma), **tol)
    np.testing.assert_allclose(dbeta.numpy(), np.asarray(jdbeta), **tol)


@pytest.mark.parametrize("live", ["x", "gamma", "beta"])
def test_instance_norm_output_has_grad_fn(live):
    """Whenever an input requires grad, the output carries the gradient."""
    x, gamma, beta = torch.randn(2, 3, 4, 4), torch.ones(3), torch.zeros(3)
    {"x": x, "gamma": gamma, "beta": beta}[live].requires_grad_(True)
    y = ink.instance_norm(x, gamma, beta)
    assert y.grad_fn is not None and y.requires_grad


def test_autograd_function_wiring(monkeypatch):
    """_InstanceNormFn (the card's path) with its two launches swapped for
    their plain versions: the stats it saves and the gradients it returns,
    in their order, equal autograd's through the plain forward."""
    def fake_forward(x, gamma, beta, eps, with_stats):
        mean, rstd = _stats(x)
        return ink.instance_norm_plain(x, gamma, beta, eps), mean, rstd

    monkeypatch.setattr(ink, "_forward", fake_forward)
    monkeypatch.setattr(ink, "instance_norm_backward", ink.instance_norm_backward_plain)
    shape = (2, 4, 6, 5)
    ins = [_t(_np(41, shape)), _t(1.0 + _np(42, (4,), 0.1)), _t(_np(43, (4,), 0.1))]
    g = _t(_np(44, shape))
    a = [t.clone().requires_grad_(True) for t in ins]
    ink._InstanceNormFn.apply(*a, 1e-6).backward(g)
    b = [t.clone().requires_grad_(True) for t in ins]
    ink.instance_norm_plain(*b, 1e-6).backward(g)
    for ta, tb in zip(a, b):
        torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-5, atol=1e-6)


def test_sample_draws_distributions():
    cfg = Config()
    cfg.model.filter_size = N
    cfg.train.scalar_channel_dropout = False
    gen = torch.Generator().manual_seed(0)
    n, b, v = 400, 4, C_DIM
    draws = [sample_draws(cfg, gen, v, b, 64, 64) for _ in range(n)]

    def within(samples, p, m):  # m Bernoulli(p) trials: 5 standard errors
        assert abs(samples - p) <= 5 * np.sqrt(p * (1 - p) / m), (samples, p)

    within(np.mean([bool(d.flip) for d in draws]), 0.5, n)
    t = np.array([float(d.t) for d in draws])
    assert t.min() >= 0.8 and t.max() <= 1.2 and abs(t.mean() - 1.0) < 5 * 0.4 / np.sqrt(12 * n)
    assert draws[0].drop.shape == (b, v)
    within(torch.stack([d.drop for d in draws]).mean().item(), 0.5, n * b * v)
    keep = torch.stack([d.keep for d in draws]).float()
    assert draws[0].keep.shape == (2 * b, 16 * N, 2, 2)
    within(keep.mean().item(), 0.8, keep.numel())
    noise = torch.stack([d.noise for d in draws])
    assert draws[0].noise.shape == (2 * b, 3, 64, 64)
    assert abs(noise.std().item() - 1.0) < 0.01 and abs(noise.mean().item()) < 0.01

    cfg.train.single_input_prob = 1.0  # every pattern keeps one polarised view
    cfg.data.flip = False
    cfg.model.d_input_noise = cfg.model.d_dropout = 0.0
    d = sample_draws(cfg, gen, v, b, 64, 64)
    assert not bool(d.flip) and d.noise is None and d.keep is None
    assert torch.equal(d.drop.sum(1), torch.full((b,), v - 1.0))
    assert not d.drop[:, v - 1].eq(0).any()


class TestStepMechanics:
    """The port's own step at 64 px, filter 4, batch 1: remat, the G gate, the
    K-step loop. Port against port, so the same arithmetic: exact."""

    S, W = 64, 4

    def _setup(self, **train):
        cfg = Config()
        cfg.model.image_size, cfg.model.filter_size, cfg.model.specseg_base_filters = \
            self.S, self.W, 4
        for k, val in train.items():
            setattr(cfg.train, k, val)
        state = create_train_state(cfg, build_models(cfg, device="cpu", seed=0))
        gen = torch.Generator().manual_seed(1)
        views = torch.rand((C_DIM, 1, self.S, self.S, 3), generator=gen)
        return cfg, state, views, sample_draws(cfg, gen, C_DIM, 1, self.S, self.S)

    @pytest.mark.parametrize("remat", ["models", "gen", "disc"])
    def test_remat_keeps_the_gradients(self, remat):
        cfg, state, views, draws = self._setup()
        _, ref = make_train_step(cfg, debug_grads=True)(copy.deepcopy(state), views, draws, 0)
        cfg.train.remat = remat
        _, got = make_train_step(cfg, debug_grads=True)(state, views, draws, 0)
        for net in ("G", "D"):
            for k, g in ref["_grads"][net].items():
                torch.testing.assert_close(got["_grads"][net][k], g, rtol=0, atol=0)

    def test_unknown_remat_raises(self):
        cfg = Config()
        cfg.train.remat = "everything"
        with pytest.raises(ValueError):
            make_train_step(cfg)

    def test_g_waits_for_train_G_after(self):
        cfg, state, views, draws = self._setup(train_G_after=2)
        g0 = {k: p.detach().clone() for k, p in state.gen.named_parameters()}
        d0 = {k: p.detach().clone() for k, p in state.disc.named_parameters()}
        state, _ = make_train_step(cfg)(state, views, draws, 1)
        assert all(torch.equal(p, g0[k]) for k, p in state.gen.named_parameters())
        assert not any(torch.equal(p, d0[k]) for k, p in state.disc.named_parameters())
        assert (state.g_opt.count, state.d_opt.count, state.step) == (0, 1, 1)
        state, _ = make_train_step(cfg)(state, views, draws, 2)
        assert not all(torch.equal(p, g0[k]) for k, p in state.gen.named_parameters())

    def test_scan_equals_single_steps(self):
        cfg, state, views, _ = self._setup()
        gen = torch.Generator().manual_seed(2)
        draws = [sample_draws(cfg, gen, C_DIM, 1, self.S, self.S) for _ in range(3)]
        batches = torch.stack([views, views.flip(2), views * 0.5])
        single, step = copy.deepcopy(state), make_train_step(cfg)
        losses_single = []
        for batch, d in zip(batches, draws):
            single, m = step(single, batch, d, 0)
            losses_single.append(m["total_G"])
        state, metrics = make_scan_train_steps(cfg)(state, batches, draws, 0)
        assert state.step == 3 and metrics["total_G"].shape == (3,)
        torch.testing.assert_close(metrics["total_G"], torch.stack(losses_single), rtol=0, atol=0)
        for (k, p), q in zip(state.gen.named_parameters(), single.gen.parameters()):
            assert torch.equal(p, q), k
