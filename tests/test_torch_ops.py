"""The port's ops and the plain versions of its two kernels, held against the
JAX package on the CPU. Inputs come from numpy seeds and go to both sides.

Tolerances: colour and standardisation are the same f32 arithmetic (abs 1e-6
to 1e-5); the chroma prior adds sorts and sigmoids (abs 1e-5); instance norm
compares two-pass with one-pass moments (rtol 1e-4, atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from shmgan_tpu.ops import color as jcolor
from shmgan_tpu.ops import specprior as jprior
from shmgan_tpu.ops import standardize as jstd
from shmgan_tpu.ops.pallas.instance_norm import (instance_norm_pallas,
                                                 instance_norm_reference)
from shmgan_tpu.ops.pallas.preprocess import fused_standardize_yuv as j_fused
from shmgan_tpu_torch.ops import color, specprior, standardize
from shmgan_tpu_torch.ops.kernels import instance_norm as ink
from shmgan_tpu_torch.ops.kernels import preprocess as pre


def _rgb(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestColor:
    def test_rgb_to_yuv(self):
        x = _rgb((2, 8, 8, 3))
        np.testing.assert_allclose(color.rgb_to_yuv(_t(x)).numpy(),
                                   np.asarray(jcolor.rgb_to_yuv(jnp.asarray(x))),
                                   atol=1e-6)

    def test_yuv_to_rgb_inverts(self):
        x = _rgb((2, 8, 8, 3), seed=1) * 2 - 0.5
        np.testing.assert_allclose(color.yuv_to_rgb(_t(x)).numpy(),
                                   np.asarray(jcolor.yuv_to_rgb(jnp.asarray(x))),
                                   atol=1e-6)
        back = color.yuv_to_rgb(color.rgb_to_yuv(_t(x))).numpy()
        np.testing.assert_allclose(back, x, atol=1e-5)


class TestStandardize:
    @pytest.mark.parametrize("shape", [(3, 16, 16, 3), (2, 32, 24, 1)])
    def test_matches_jax(self, shape):
        x = _rgb(shape, seed=2) * 3.0
        out, stats = standardize.per_image_standardization(_t(x))
        jout, jstats = jstd.per_image_standardization(jnp.asarray(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
        for a, b in zip(stats, jstats):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)

    def test_floor_is_one_over_256_at_any_size(self):
        _, stats = standardize.per_image_standardization(torch.zeros(2, 8, 8, 3))
        assert torch.all(stats.stddev == 1.0 / 256.0)


class TestSpecPrior:
    @pytest.mark.parametrize("hw", [(16, 16), (15, 17)])  # even and odd pixel counts
    def test_chroma_prior_matches_jax(self, hw):
        x = _rgb((2,) + hw + (3,), seed=3)
        x[0, 4:7, 4:7] = 0.97  # a bright, desaturated patch
        np.testing.assert_allclose(specprior.chroma_prior(_t(x)).numpy(),
                                   np.asarray(jprior.chroma_prior(jnp.asarray(x))),
                                   atol=1e-5)

    def test_median_of_even_count_averages_middle_pair(self):
        x = torch.tensor([1.0, 2.0, 3.0, 10.0]).view(1, 2, 2, 1)
        assert specprior._per_image_quantile(x, 0.5).item() == 2.5
        assert float(jnp.median(jnp.array([1.0, 2.0, 3.0, 10.0]))) == 2.5

    @pytest.mark.parametrize("in_channels", [1, 2])
    def test_net_input_and_fusion(self, in_channels):
        rgb = _rgb((2, 16, 16, 3), seed=4)
        y = _rgb((2, 16, 16, 1), seed=5)
        got = specprior.specseg_net_input(_t(y), _t(rgb), in_channels)
        want = jprior.specseg_net_input(jnp.asarray(y), jnp.asarray(rgb), in_channels)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        fused = specprior.fuse_mask_prior(_t(y), got[..., -1:])
        np.testing.assert_allclose(fused.numpy(), np.asarray(
            jprior.fuse_mask_prior(jnp.asarray(y), want[..., -1:])), atol=1e-5)

    def test_net_input_rejects_other_widths(self):
        with pytest.raises(ValueError):
            specprior.specseg_net_input(torch.zeros(1, 4, 4, 1), torch.zeros(1, 4, 4, 3), 3)


class TestPreprocessPlain:
    """Plain version of the fused standardise+YUV kernel vs both JAX paths."""

    @pytest.fixture()
    def rgb(self):
        x = _rgb((3, 32, 128, 3), seed=6)
        x[1] = 0.0  # the all-zero image: scale 1/256, output 0
        return x

    def _check(self, rgb, jyuv, jscale):
        yuv, scale = pre.fused_standardize_yuv(_t(rgb))
        np.testing.assert_allclose(yuv.numpy(), np.asarray(jyuv), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-5, atol=1e-6)
        assert scale[1].item() == 1.0 / 256.0 and not yuv[1].any()

    def test_vs_xla_path(self, rgb):
        self._check(rgb, *j_fused(jnp.asarray(rgb), use_pallas=False))

    def test_vs_pallas_kernel_interpreted(self, rgb):
        with pltpu.force_tpu_interpret_mode():
            jyuv, jscale = j_fused(jnp.asarray(rgb), use_pallas=True)
        self._check(rgb, jyuv, jscale)

    def test_cpu_tensor_takes_plain_version_and_counts_nothing(self, rgb):
        before = pre.launches
        pre.fused_standardize_yuv(_t(rgb))
        assert pre.launches == before


class TestInstanceNormPlain:
    """Plain version of the IN kernel (NCHW) vs the JAX kernel (NHWC)."""

    @pytest.fixture(params=[(2, 16, 128, 8), (2, 16, 16, 64)], ids=["c8", "c64"])
    def data(self, request):
        rng = np.random.default_rng(7)
        x = rng.standard_normal(request.param, dtype=np.float32) + 0.5
        c = request.param[-1]
        gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
        beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
        return x, gamma, beta

    def _port(self, x, gamma, beta):
        y = ink.instance_norm(_t(x).permute(0, 3, 1, 2).contiguous(), _t(gamma), _t(beta))
        return y.permute(0, 2, 3, 1).numpy()

    def test_vs_pallas_kernel_interpreted(self, data):
        x, gamma, beta = data
        with pltpu.force_tpu_interpret_mode():
            want = instance_norm_pallas(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
        np.testing.assert_allclose(self._port(x, gamma, beta), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)

    def test_vs_reference(self, data):
        x, gamma, beta = data
        want = instance_norm_reference(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
        np.testing.assert_allclose(self._port(x, gamma, beta), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


class TestWrappersRejectBadInput:
    def test_instance_norm_rejects_non_cpu_non_cuda(self):
        x = torch.zeros(1, 2, 4, 4, device="meta")
        with pytest.raises(ValueError):
            ink.instance_norm(x, torch.ones(2, device="meta"), torch.zeros(2, device="meta"))

    def test_preprocess_rejects_non_cpu_non_cuda(self):
        with pytest.raises(ValueError):
            pre.fused_standardize_yuv(torch.zeros(1, 4, 4, 3, device="meta"))
