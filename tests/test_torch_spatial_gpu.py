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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,bands", [((4, 8, 64, 32), 2), ((3, 5, 12, 7), 4),
                                         ((2, 16, 2, 4), 2)])
def test_band_instance_norm(cuda, dtype, shape, bands):
    """y within one bf16 ulp + 1e-4 (f32: 1e-4) of the plain steps, the
    planes of channel 0 flat (mean 50, spread 0.1); dx of the other
    channels the same, dbeta and their dgamma within 1e-3 (f32: 1e-4). A
    flat plane's backward amplifies each forward's rounding of its mean by
    its rstd: there each side's dx and dgamma is held against float64
    within those tolerances plus the error of a mean FLAT_ULPS f32 ulps off
    (chip_smoke.in_reference_f64). Two launches a band call a band."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, device=cuda, generator=g) + 0.5
    x[:, 0] = 50.0 + 0.1 * torch.randn(x[:, 0].shape, device=cuda, generator=g)
    x, dy = x.to(dtype), torch.randn(shape, device=cuda, generator=g).to(dtype)
    gamma = torch.rand(shape[1], device=cuda, generator=g) + 0.5
    beta = 0.1 * torch.randn(shape[1], device=cuda, generator=g)
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
