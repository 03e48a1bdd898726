"""The port's blocks, SpecSeg and generator against the flax modules on the
CPU, with the same weights carried over by convert.py.

Every leaf of the flax tree is redrawn from a numpy seed before it is
carried over (biases, IN's gamma/beta and BN's statistics included), so a
leaf that lands in the wrong place shows. Tolerance: abs 1e-4 for single
blocks, 5e-4 (relative to the output's scale) for whole networks: the two
frameworks sum the convolutions in other orders, in f32.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shmgan_tpu.models import blocks as jblocks
from shmgan_tpu.models.generator import SHMGenerator as JGenerator
from shmgan_tpu.models.specseg import SpecSeg as JSpecSeg
from shmgan_tpu_torch import Config
from shmgan_tpu_torch.convert import load_flax, load_inference_weights
from shmgan_tpu_torch.models import blocks, build_models
from shmgan_tpu_torch.models.generator import SHMGenerator
from shmgan_tpu_torch.models.specseg import SpecSeg


def _redraw(tree, seed):
    """Every leaf replaced by seeded noise of its shape (variances positive).
    The tree may hold shapes only (jax.eval_shape): flax's eager init takes
    tens of seconds on the CPU."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(tree))
    out = {}
    for path, leaf in flat.items():
        v = rng.standard_normal(leaf.shape).astype(np.float32)
        out[path] = np.abs(v) + 0.5 if path[-1] == "var" else 0.2 * v
    return flax.traverse_util.unflatten_dict(out)


def _nhwc(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _from_nchw(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _n_params(tree):
    return sum(np.size(x) for x in jax.tree_util.tree_leaves(tree))


def _shapes(jmod, *args, **kwargs):
    return jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, **kwargs))


def _run_block(jmod, tmod, x, seed=0):
    params = _redraw(_shapes(jmod, jnp.asarray(x))["params"], seed)
    load_flax(tmod, params)
    assert _n_params(params) == sum(p.numel() for p in tmod.parameters())
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_to_nchw(x))
    return got, want


class TestBlocks:
    @pytest.mark.parametrize("kernel", [3, 1])
    def test_conv_in(self, kernel):
        x = _nhwc(1, (2, 8, 8, 4))
        got, want = _run_block(jblocks.ConvIN(6, kernel=kernel, dtype=jnp.float32),
                               blocks.ConvIN(4, 6, kernel=kernel), x)
        np.testing.assert_allclose(_from_nchw(got), np.asarray(want), atol=1e-4)

    @pytest.mark.parametrize("pool", [False, True])
    def test_mask_attention(self, pool):
        m = np.abs(_nhwc(2, (2, 8, 8, 1)))
        got, want = _run_block(jblocks.MaskAttention(5, pool=pool, dtype=jnp.float32),
                               blocks.MaskAttention(1, 5, pool=pool), m)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_from_nchw(g), np.asarray(w), atol=1e-4)

    @pytest.mark.parametrize("mode", ["conv_transpose", "resize_conv"])
    def test_upsample(self, mode):
        x = _nhwc(3, (2, 4, 6, 4))
        jcls, tcls = ((jblocks.ConvTransposeUp, blocks.ConvTransposeUp)
                      if mode == "conv_transpose" else
                      (jblocks.ResizeConvUp, blocks.ResizeConvUp))
        got, want = _run_block(jcls(3, dtype=jnp.float32), tcls(4, 3), x)
        assert got.shape == (2, 3, 8, 12)
        np.testing.assert_allclose(_from_nchw(got), np.asarray(want), atol=1e-4)

    def test_instance_norm(self):
        x = _nhwc(4, (2, 8, 8, 6)) + 1.0
        got, want = _run_block(jblocks.InstanceNorm(dtype=jnp.float32),
                               blocks.InstanceNorm(6), x)
        np.testing.assert_allclose(_from_nchw(got), np.asarray(want), atol=1e-4)

    def test_pools(self):
        x = _nhwc(5, (2, 8, 8, 3))
        np.testing.assert_allclose(_from_nchw(blocks.avg_pool_2x2(_to_nchw(x))),
                                   np.asarray(jblocks.avg_pool_2x2(jnp.asarray(x))),
                                   atol=1e-6)
        np.testing.assert_array_equal(_from_nchw(blocks.max_pool(_to_nchw(x), 2)),
                                      np.asarray(jblocks.max_pool(jnp.asarray(x), 2)))


def _scaled_close(got, want, tol=5e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()))


class TestSpecSeg:
    @pytest.mark.parametrize("in_channels", [1, 2])
    def test_matches_flax(self, in_channels):
        x = _nhwc(6, (2, 32, 32, in_channels))
        jnet = JSpecSeg(base_filters=4, dtype=jnp.float32)
        variables = _redraw(_shapes(jnet, jnp.asarray(x), train=False), 7)
        net = SpecSeg(base_filters=4, in_channels=in_channels)
        load_flax(net, variables["params"], variables["batch_stats"])
        assert _n_params(variables) == (sum(p.numel() for p in net.parameters())
                                        + sum(b.numel() for n, b in net.named_buffers()
                                              if "running" in n))
        with torch.no_grad():
            got = net(torch.from_numpy(x)).numpy()
        want = jax.jit(lambda v, a: jnet.apply(v, a, train=False))(variables, jnp.asarray(x))
        _scaled_close(got, want)


class TestGenerator:
    @pytest.mark.parametrize("mode", ["conv_transpose", "resize_conv"])
    def test_matches_flax(self, mode):
        x = _nhwc(8, (2, 32, 32, 10))
        mask = np.random.default_rng(9).random((2, 32, 32, 1), dtype=np.float32)
        jnet = JGenerator(filter_size=8, c_dim=5, dtype=jnp.float32, upsample_mode=mode)
        params = _redraw(_shapes(jnet, jnp.asarray(x), jnp.asarray(mask))["params"], 10)
        net = SHMGenerator(filter_size=8, c_dim=5, upsample_mode=mode)
        load_flax(net, params)
        assert _n_params(params) == sum(p.numel() for p in net.parameters())
        with torch.no_grad():
            got = net(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        want = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(mask))
        _scaled_close(got, want)

    def test_rejects_unknown_upsample_mode(self):
        with pytest.raises(ValueError):
            SHMGenerator(filter_size=8, upsample_mode="bilinear")


class TestConvert:
    @pytest.fixture()
    def tree(self):
        jnet = jblocks.ConvIN(6, dtype=jnp.float32)
        return _redraw(_shapes(jnet, jnp.zeros((1, 4, 4, 3)))["params"], 0)

    def test_leftover_leaf_raises(self, tree):
        tree["conv"]["extra"] = np.zeros(3, np.float32)
        with pytest.raises(KeyError):
            load_flax(blocks.ConvIN(3, 6), tree)

    def test_missing_leaf_raises(self, tree):
        del tree["inorm"]["bias"]
        with pytest.raises(KeyError, match="inorm.bias"):
            load_flax(blocks.ConvIN(3, 6), tree)

    def test_wrong_shape_raises(self, tree):
        with pytest.raises(ValueError):
            load_flax(blocks.ConvIN(4, 6), tree)

    def test_unexpected_collection_raises(self):
        cfg = Config()
        cfg.model.filter_size, cfg.model.specseg_base_filters = 8, 4
        gen, specseg = build_models(cfg, device="cpu")
        with pytest.raises(KeyError):
            load_inference_weights(gen, specseg, {}, {"params": {}, "dropout": {}})


class TestSeededInit:
    def _cfg(self):
        cfg = Config()
        cfg.model.filter_size, cfg.model.specseg_base_filters = 8, 4
        return cfg

    def test_same_seed_same_weights(self):
        a = build_models(self._cfg(), device="cpu", seed=3)
        b = build_models(self._cfg(), device="cpu", seed=3)
        c = build_models(self._cfg(), device="cpu", seed=4)
        for ma, mb, mc in zip(a, b, c):
            sa, sb, sc = ma.state_dict(), mb.state_dict(), mc.state_dict()
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
            assert any(not torch.equal(sa[k], sc[k]) for k in sa)

    def test_scales_follow_jax_init(self):
        gen, specseg = build_models(self._cfg(), device="cpu", seed=0)
        w = gen.up0_0.conv.weight
        assert abs(w.std().item() - 0.02) < 0.002 and not gen.up0_0.conv.bias.any()
        assert torch.equal(gen.up0_0.inorm.scale, torch.ones(64))
        assert abs(specseg.down2.conv1.weight.std().item() - 0.05) < 0.005
        assert torch.equal(specseg.down0.bn.running_var, torch.ones(4))
