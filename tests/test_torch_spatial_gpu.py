"""The band entry points of the port's CUDA kernels (spatial sharding,
shmgan_tpu_torch/parallel/spatial.py) against their plain versions, on the
card: a whole map cut into bands computed band by band in one process, as
the ranks of a model row compute it.

Marked `gpu`; each test skips where there is no CUDA card. This file imports
neither JAX nor the JAX package:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_spatial_gpu.py
"""

import pytest
import torch

from shmgan_tpu_torch.ops.kernels import instance_norm as ink
from shmgan_tpu_torch.ops.kernels import preprocess as pre
from shmgan_tpu_torch.parallel.spatial import LocalRow


@pytest.fixture()
def cuda():
    """The card, decided when the test runs; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])

# (B, C, H, W) maps and their bands, reaching each variant of the band
# backward (ink._band_bwd_plan): vector (32 x 32 and 128 x 256 bands, the
# latter two passes of a thread's loop; 18 x 18 in f32), element (17 x 17;
# 18 x 18 in bf16), packed with 16-byte chunks (16 x 16, 9 x 24: odd band
# rows; 1 x 4 in f32) and with single elements (3 x 7; 1 x 4 in bf16)
BAND_CASES = [((4, 8, 64, 32), 2), ((3, 5, 12, 7), 4), ((2, 16, 2, 4), 2),
              ((2, 3, 34, 17), 2), ((2, 4, 36, 18), 2), ((4, 6, 32, 16), 2),
              ((3, 4, 18, 24), 2), ((1, 2, 256, 256), 2)]


def _band_inputs(cuda, shape, dtype, seed=4):
    """x with the planes of channel 0 flat (mean 50, spread 0.1), dy, gamma,
    beta."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, device=cuda, generator=g) + 0.5
    x[:, 0] = 50.0 + 0.1 * torch.randn(x[:, 0].shape, device=cuda, generator=g)
    x, dy = x.to(dtype), torch.randn(shape, device=cuda, generator=g).to(dtype)
    gamma = torch.rand(shape[1], device=cuda, generator=g) + 0.5
    beta = 0.1 * torch.randn(shape[1], device=cuda, generator=g)
    return x, dy, gamma, beta


def _split_grads(x, dy, gamma, beta, bands):
    """(y, dx, dgamma, dbeta) of instance_norm_split through the kernels."""
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    y = ink.instance_norm_split(*leaves, 1e-6, bands)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


@pytest.mark.gpu
@DTYPES
@pytest.mark.parametrize("shape,bands", BAND_CASES)
def test_band_instance_norm(cuda, dtype, shape, bands):
    """y within one bf16 ulp + 1e-4 (f32: 1e-4) of the plain steps, the
    planes of channel 0 flat (mean 50, spread 0.1); dx of the other
    channels the same, dbeta and their dgamma within 1e-3 (f32: 1e-4). A
    flat plane's backward amplifies each forward's rounding of its mean by
    its rstd: there each side's dx and dgamma is held against float64
    within those tolerances plus the error of a mean FLAT_ULPS f32 ulps off
    (chip_smoke.in_reference_f64). Two launches a band call a band."""
    x, dy, gamma, beta = _band_inputs(cuda, shape, dtype)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-4)
    ptol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-3, atol=1e-3)
    from chip_smoke import in_reference_f64

    out = []
    for fn in (ink.instance_norm_split, ink.instance_norm_split_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
        before = dict(ink.launches)
        y = fn(*leaves, 1e-6, bands)
        grads = torch.autograd.grad(y, leaves, dy)
        out.append((y, *grads))
        calls = {k: n - before[k] for k, n in ink.launches.items() if n != before[k]}
        want = ({} if fn is ink.instance_norm_split_plain else
                {("band_forward", dtype): 2 * bands, ("band_backward", dtype): 2 * bands})
        assert calls == want
    (y, dx, dgamma, dbeta), (ry, rdx, rdgamma, rdbeta) = out
    torch.testing.assert_close(y.float(), ry.float(), **tol)
    torch.testing.assert_close(dx[:, 1:].float(), rdx[:, 1:].float(), **tol)
    torch.testing.assert_close(dgamma[1:], rdgamma[1:], **ptol)
    torch.testing.assert_close(dbeta, rdbeta, **ptol)
    (_, dx64, dgamma64, _), (dx_err, dgamma_err) = in_reference_f64(
        x[:, :1], gamma[:1], beta[:1], dy[:, :1])
    for side_dx, side_dgamma in ((dx, dgamma), (rdx, rdgamma)):
        assert ((side_dx[:, :1].double() - dx64).abs()
                <= tol["atol"] + tol["rtol"] * dx64.abs() + dx_err).all()
        assert ((side_dgamma[:1].double() - dgamma64).abs()
                <= ptol["atol"] + ptol["rtol"] * dgamma64.abs() + dgamma_err).all()


@pytest.mark.gpu
@DTYPES
@pytest.mark.parametrize("shape,bands", BAND_CASES)
def test_band_split_is_its_bands_bit_for_bit(cuda, dtype, shape, bands):
    """Two calls of the split through the kernels are bit for bit alike, and
    the split is bit for bit its bands computed one by one through the band
    kernels, as the ranks of a model row compute them (the moments gathered
    in rank order, the backward's sums added in rank order)."""
    x, dy, gamma, beta = _band_inputs(cuda, shape, dtype)
    first, again = (_split_grads(x, dy, gamma, beta, bands) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    h = shape[2] // bands
    xs = [x.narrow(2, j * h, h).contiguous() for j in range(bands)]
    gs = [dy.narrow(2, j * h, h).contiguous() for j in range(bands)]
    parts = torch.stack([ink.band_moments(xb) for xb in xs])
    fwd = [ink.band_apply(xb, gamma, beta, parts, 1e-6) for xb in xs]
    mean, rstd = fwd[0][1], fwd[0][2]
    local = [ink.band_bwd_sums(xb, gb, mean, rstd) for xb, gb in zip(xs, gs)]
    total = local[0]
    for part in local[1:]:
        total = total + part
    bwd = [ink.band_bwd_apply(xb, gb, gamma, mean, rstd, lb, total, shape[2] * shape[3])
           for xb, gb, lb in zip(xs, gs, local)]
    dgamma, dbeta = bwd[0][1], bwd[0][2]
    for o in bwd[1:]:
        dgamma, dbeta = dgamma + o[1], dbeta + o[2]
    bands_out = (torch.cat([f[0] for f in fwd], 2), torch.cat([o[0] for o in bwd], 2),
                 dgamma, dbeta)
    assert all(torch.equal(a, b) for a, b in zip(first, bands_out))


@pytest.mark.gpu
@DTYPES
@pytest.mark.parametrize("shape", [(2, 8, 4, 8), (2, 4, 32, 64), (3, 2, 3, 100)])
def test_band_backward_unaligned(cuda, dtype, shape):
    """Both backward launches on x and g one element past a 16-byte aligned
    base (the packed and vector variants move each 16-byte chunk one element
    at a time there): bit for bit the result on aligned copies, and within
    the plain steps' tolerance."""
    x, dy, gamma, beta = _band_inputs(cuda, shape, dtype, seed=6)
    n = x.numel()
    xs, gs = (torch.empty(n + 1, dtype=dtype, device=cuda) for _ in range(2))
    xs[1:].copy_(x.flatten())
    gs[1:].copy_(dy.flatten())
    xu, gu = xs[1:].view(shape), gs[1:].view(shape)
    assert xu.data_ptr() % 16 and gu.data_ptr() % 16
    _, mean, rstd = ink.instance_norm_band_forward(x, gamma, beta, 1e-6, LocalRow())
    count = shape[2] * shape[3]
    outs = []
    for a, b in ((xu, gu), (x, dy)):
        local = ink.band_bwd_sums(a, b, mean, rstd)
        outs.append((local, *ink.band_bwd_apply(a, b, gamma, mean, rstd, local, local, count)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    local = ink.band_bwd_sums_plain(x, dy, mean, rstd)
    want = ink.band_bwd_apply_plain(x, dy, gamma, mean, rstd, local, local, count)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-4)
    torch.testing.assert_close(outs[0][0], local, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(outs[0][1][:, 1:].float(), want[0][:, 1:].float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,lanes,threads,hw", [
    ("packed", 4, 256, 1024),    # a band past what 4 lanes hold
    ("packed", 3, 96, 32),       # lanes not a power of 2
    ("vector", 64, 64, 7 * 37),  # H*W not a multiple of 16 bytes
    ("element", 1024, 1024, 512),  # more threads than the kernels take
    ("element", 64, 128, 512)])  # lanes other than the block
def test_band_backward_refuses_a_plan_it_cannot_run(cuda, variant, lanes, threads, hw):
    x = torch.randn(2, 3, 1, hw, device=cuda)
    mean, rstd = x.mean(dim=(2, 3)), torch.ones(2, 3, device=cuda)
    plan = ink.BandPlan(variant, max(1, threads // lanes), lanes, threads, 1, 1)
    before = dict(ink.launches)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ink.band_bwd_sums(x, x, mean, rstd, plan)
    sums = mean[None].repeat(2, 1, 1)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        ink.band_bwd_apply(x, x, torch.ones(3, device=cuda), mean, rstd, sums, sums, hw, plan)
    assert ink.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape,bands", [((40, 128, 128, 3), 2), ((3, 24, 17, 3), 4)])
def test_band_preprocess(cuda, shape, bands):
    """The band preprocess in bands against its plain steps and against the
    whole-image plain version within 1e-5; a black image takes the floor
    1/256; through a one-rank row it is the whole-image function."""
    x = torch.rand(shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(5))
    x[0] = 0.0
    before = pre.band_launches
    yuv, scale = pre.fused_standardize_yuv_split(x, bands)
    assert pre.band_launches == before + 2 * bands
    for ryuv, rscale in (pre.fused_standardize_yuv_plain(x),
                         pre.fused_standardize_yuv_band(x, LocalRow())):
        torch.testing.assert_close(yuv, ryuv, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(scale, rscale, rtol=1e-5, atol=1e-5)
    assert scale[0].item() == 1.0 / 256.0
