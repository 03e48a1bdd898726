"""The ops of spatial sharding (shmgan_tpu_torch/parallel/spatial.py and the
kernels' band entry points) against the unsharded ones and the JAX
package's, f32 on the CPU.

Two gloo ranks (tests/torch_dp_worker.py's sp_units) each take their band
of rows of the same seeded inputs and run: a 3x3 SAME conv through the halo
exchange, and its input gradient; the band instance norm (its plain steps
on the CPU) with some planes flat (mean 50, spread 0.1), and its gradients;
SSIM (max_val 5, the train step's) of a band pair whose 11-tap window
crosses the band edge; the per-image rescale of an input whose minimum and
maximum repeat in both bands; the band preprocess. The bands joined in
rank order are held against the whole-map versions and the JAX package's:
conv and rescale values within 1e-6, gradients within 1e-5 (f32 sums in
another order), IN, SSIM and preprocess within the port's IN and
preprocess tolerances (1e-4, 1e-5). The same ops in one process
(`spatial.Split`) are the mesh's bands bit for bit, and a model row of one
rank (`spatial.LocalRow`) is the whole-map op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu
from torch_dp_worker import spawn_ranks

from shmgan_tpu.ops.pallas.instance_norm import instance_norm_pallas
from shmgan_tpu.ops.pallas.preprocess import fused_standardize_yuv as j_fused
from shmgan_tpu.ops.ssim import ssim as j_ssim
from shmgan_tpu.ops.standardize import rescale_01_per_image as j_rescale
from shmgan_tpu_torch.ops.kernels import instance_norm as ink
from shmgan_tpu_torch.ops.kernels import preprocess as pre
from shmgan_tpu_torch.parallel import spatial

RANKS = 2
IN_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 24, 10)).astype(np.float32)
    x[:, 1] = 50.0 + 0.1 * rng.standard_normal((2, 24, 10)).astype(np.float32)  # flat planes
    ties = rng.random((2, 24, 6, 3)).astype(np.float32)
    ties[:, 3, 1, 0] = ties[:, 20, 4, 2] = -1.0   # each image's minimum, once in each band
    ties[:, 5, 0, 1] = ties[:, 17, 2, 2] = 2.0    # and its maximum
    return {k: torch.from_numpy(v) for k, v in {
        "x": x, "w": 0.2 * rng.standard_normal((3, 4, 3, 3)).astype(np.float32),
        "gy": rng.standard_normal((2, 4, 24, 10)).astype(np.float32),
        "gamma": (1.0 + 0.1 * rng.standard_normal(4)).astype(np.float32),
        "beta": (0.1 * rng.standard_normal(4)).astype(np.float32),
        "a": (3.0 * rng.random((2, 24, 16, 3))).astype(np.float32),
        "b": (3.0 * rng.random((2, 24, 16, 3))).astype(np.float32),
        "ties": ties, "gr": rng.standard_normal((2, 24, 6, 3)).astype(np.float32),
        "rgb": rng.random((3, 24, 8, 3)).astype(np.float32)}.items()}


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp_units")
    spec = _inputs()
    torch.save(spec, work / "sp_units.pt")
    ranks = [r["sp_units"] for r in spawn_ranks(work, ["sp_units"], world=RANKS)]
    return spec, ranks


def _joined(ranks, key, index, dim):
    return torch.cat([r[key][index] for r in ranks], dim)


def test_halo_conv_matches_the_unsharded_conv(units):
    spec, ranks = units
    x = spec["x"].clone().requires_grad_(True)
    y = F.conv2d(x, spec["w"], padding=1)
    (dx,) = torch.autograd.grad(y, x, spec["gy"][:, :3])
    assert [r["span"] for r in ranks] == [(0, 12), (12, 24)]
    torch.testing.assert_close(_joined(ranks, "conv", 0, 2), y.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(_joined(ranks, "conv", 1, 2), dx, rtol=0, atol=1e-5)


def _in_float64(x, gamma, gy):
    """Instance norm's output (gamma applied, beta 0) and input gradient in
    float64, NCHW."""
    x, gamma, gy = (t.double().numpy() for t in (x, gamma, gy))
    g = gamma[None, :, None, None]
    mean = x.mean(axis=(2, 3), keepdims=True)
    inv = 1.0 / np.sqrt(((x - mean) ** 2).mean(axis=(2, 3), keepdims=True) + 1e-6)
    xhat, gg, n = (x - mean) * inv, gy * g, x.shape[2] * x.shape[3]
    dx = inv / n * (n * gg - gg.sum(axis=(2, 3), keepdims=True)
                    - xhat * (gg * xhat).sum(axis=(2, 3), keepdims=True))
    return xhat * g, dx


def test_band_instance_norm_matches_jax(units):
    """The band IN (rank order moments, merged) against JAX's instance norm
    and its custom VJP (the Pallas kernel in interpret mode); dgamma and
    dbeta are each rank's share, summed here. The flat planes (channel 1)
    are held against float64 instead, at the same tolerance: there JAX's
    own f32 output is 2.6e-4 from float64, the band's 4.6e-5."""
    spec, ranks = units
    nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 1).numpy())  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda x, g, b: instance_norm_pallas(x, g, b, 1e-6), nhwc(spec["x"]),
                         jnp.asarray(spec["gamma"].numpy()), jnp.asarray(spec["beta"].numpy()))
        dx, dgamma, dbeta = vjp(nhwc(spec["gy"]))
    nchw = lambda a: torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)  # noqa: E731
    got_y, got_dx = _joined(ranks, "in", 0, 2), _joined(ranks, "in", 1, 2)
    rough = [0, 2, 3]
    torch.testing.assert_close(got_y[:, rough], nchw(y)[:, rough], **IN_TOL)
    torch.testing.assert_close(got_dx[:, rough], nchw(dx)[:, rough], **IN_TOL)
    y64, dx64 = _in_float64(spec["x"], spec["gamma"], spec["gy"])
    np.testing.assert_allclose(got_y[:, 1].double().numpy() - spec["beta"][1].item(),
                               y64[:, 1], **IN_TOL)
    np.testing.assert_allclose(got_dx[:, 1].double().numpy(), dx64[:, 1], **IN_TOL)
    torch.testing.assert_close(sum(r["in"][2] for r in ranks),
                               torch.from_numpy(np.array(dgamma)), **IN_TOL)
    torch.testing.assert_close(sum(r["in"][3] for r in ranks),
                               torch.from_numpy(np.array(dbeta)), **IN_TOL)


def test_band_ssim_matches_jax(units):
    spec, ranks = units
    a, b = (jnp.asarray(spec[k].numpy()) for k in ("a", "b"))
    s, (da, db) = jax.value_and_grad(lambda a, b: j_ssim(a, b, 5.0).sum(), argnums=(0, 1))(a, b)
    want = np.asarray(j_ssim(a, b, 5.0))
    for r in ranks:  # every rank holds the whole images' scores
        np.testing.assert_allclose(r["ssim"][0].numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_joined(ranks, "ssim", 1, 1).numpy(), np.asarray(da),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(_joined(ranks, "ssim", 2, 1).numpy(), np.asarray(db),
                               rtol=1e-4, atol=1e-7)


def test_band_rescale_with_ties_matches_jax(units):
    """The min and max over the row, each taken twice in each image, one in
    each band: the gradient is split among the ties across the ranks as
    jax.grad of jnp.min / jnp.max splits it."""
    spec, ranks = units
    y, vjp = jax.vjp(j_rescale, jnp.asarray(spec["ties"].numpy()))
    (dx,) = vjp(jnp.asarray(spec["gr"].numpy()))
    np.testing.assert_allclose(_joined(ranks, "rescale", 0, 1).numpy(), np.asarray(y),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_joined(ranks, "rescale", 1, 1).numpy(), np.asarray(dx),
                               rtol=1e-5, atol=1e-5)


def test_band_preprocess_matches_jax(units):
    spec, ranks = units
    yuv, scale = j_fused(jnp.asarray(spec["rgb"].numpy()))
    np.testing.assert_allclose(_joined(ranks, "pre", 0, 1).numpy(), np.asarray(yuv),
                               rtol=1e-5, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["pre"][1].numpy(), np.asarray(scale), rtol=1e-5, atol=1e-5)


def test_split_is_the_mesh_in_one_process(units):
    """spatial.Split computes each band as its rank does: the conv, its
    input gradient and the band IN, bit for bit."""
    spec, ranks = units
    sp = spatial.Split(RANKS, spec["x"].shape[2])
    x = spec["x"].clone().requires_grad_(True)
    y = sp.rows(x, lambda e: F.conv2d(e, spec["w"], padding=(0, 1)), 1, 1)
    (dx,) = torch.autograd.grad(y, x, spec["gy"][:, :3])
    assert torch.equal(y.detach(), _joined(ranks, "conv", 0, 2))
    assert torch.equal(dx, _joined(ranks, "conv", 1, 2))
    x = spec["x"].clone().requires_grad_(True)
    gamma, beta = (spec[k].clone().requires_grad_(True) for k in ("gamma", "beta"))
    y = sp.instance_norm(x, gamma, beta, 1e-6)
    dx, dgamma, dbeta = torch.autograd.grad(y, (x, gamma, beta), spec["gy"])
    assert torch.equal(y.detach(), _joined(ranks, "in", 0, 2))
    assert torch.equal(dx, _joined(ranks, "in", 1, 2))
    assert torch.equal(dgamma, ranks[0]["in"][2] + ranks[1]["in"][2])
    assert torch.equal(dbeta, ranks[0]["in"][3] + ranks[1]["in"][3])
    yuv, scale = pre.fused_standardize_yuv_split(spec["rgb"], RANKS)
    assert torch.equal(yuv, _joined(ranks, "pre", 0, 1))
    assert torch.equal(scale, ranks[0]["pre"][1])


def test_one_rank_row_is_the_whole_map_op():
    """A model row of one rank: the band IN and its backward are the
    whole-plane plain versions, the band preprocess the whole-image one;
    the band of a map that does not divide is GSPMD's ceil cut."""
    spec = _inputs()
    row = spatial.LocalRow()
    x = spec["x"].clone().requires_grad_(True)
    gamma, beta = (spec[k].clone().requires_grad_(True) for k in ("gamma", "beta"))
    y = ink.instance_norm_band(x, gamma, beta, 1e-6, row)
    got = (y.detach(), *torch.autograd.grad(y, (x, gamma, beta), spec["gy"]))
    y = ink.instance_norm_plain(x, gamma, beta, 1e-6)
    want = (y.detach(), *torch.autograd.grad(y, (x, gamma, beta), spec["gy"]))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **IN_TOL)
    for g, w in zip(pre.fused_standardize_yuv_band(spec["rgb"], row),
                    pre.fused_standardize_yuv_plain(spec["rgb"])):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert [spatial.span(1, 2, j) for j in range(2)] == [(0, 1), (1, 1)]
    assert [spatial.span(6, 4, j) for j in range(4)] == [(0, 2), (2, 4), (4, 6), (6, 6)]


def test_flat_plane_float64_reference():
    """chip_smoke.in_reference_f64, which the card's band IN checks hold a
    flat plane's backward against: its y, dx, dgamma and dbeta are float64
    autograd's of instance norm; a plane's mean moved by FLAT_ULPS f32 ulps
    (either way) moves dx and dgamma by no more than the errors it states,
    and dx by nearly that."""
    import chip_smoke

    spec = _inputs()
    x, gy = spec["x"].double().requires_grad_(True), spec["gy"].double()
    gamma, beta = (spec[k].double().requires_grad_(True) for k in ("gamma", "beta"))
    (y, dx, dgamma, dbeta), (dx_err, dgamma_err) = chip_smoke.in_reference_f64(
        x.detach(), gamma.detach(), beta.detach(), gy)
    mean = x.mean((2, 3), keepdim=True)
    xhat = (x - mean) * torch.rsqrt((x - mean).square().mean((2, 3), keepdim=True) + 1e-6)
    want_y = xhat * gamma[:, None, None] + beta[:, None, None]
    want = torch.autograd.grad(want_y, (x, gamma, beta), gy)
    for got, w in zip((y, dx, dgamma, dbeta), (want_y.detach(), *want)):
        torch.testing.assert_close(got, w, rtol=1e-10, atol=1e-10)

    xd = spec["x"].double()
    n = xd.shape[2] * xd.shape[3]
    mean = xd.mean((2, 3), keepdim=True)
    rstd = torch.rsqrt((xd - mean).square().mean((2, 3), keepdim=True) + 1e-6)
    top = xd.abs().amax((2, 3), keepdim=True)
    ulp = torch.finfo(torch.float32).eps * torch.exp2(torch.floor(torch.log2(top)))
    gm = spec["gamma"].double()[:, None, None]
    for sign in (1.0, -1.0):
        xhat = (xd - (mean + sign * chip_smoke.FLAT_ULPS * ulp)) * rstd
        moved_dx = rstd / n * (n * gm * gy - gm * gy.sum((2, 3), keepdim=True)
                               - xhat * gm * (gy * xhat).sum((2, 3), keepdim=True))
        moved_dgamma = (gy * xhat).sum((0, 2, 3))
        assert ((moved_dx - dx).abs() <= dx_err * (1 + 1e-6)).all()
        assert ((moved_dgamma - dgamma).abs() <= dgamma_err * (1 + 1e-6)).all()
        assert ((moved_dx - dx).abs() / dx_err)[:, 1].max() > 0.9  # the bound is reached
