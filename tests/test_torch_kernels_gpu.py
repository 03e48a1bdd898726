"""The port's CUDA kernels against their plain versions, on the card, with
float32 and with bfloat16 activations.

Marked `gpu`; each test skips where there is no CUDA card. This file imports
neither JAX nor the JAX package, so it runs on a machine with the card and
no JAX, without the repo's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from shmgan_tpu_torch.ops.kernels import instance_norm as ink
from shmgan_tpu_torch.ops.kernels import preprocess as pre


@pytest.fixture()
def cuda():
    """The card, decided when the test runs; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def launched(before):
    """The IN kernels launched since `before`, a copy of `ink.launches`."""
    return {k: n - before[k] for k, n in ink.launches.items() if n != before[k]}


@pytest.mark.gpu
class TestKernelsOnCard:
    """The CUDA kernels vs their plain versions on the card."""

    @pytest.mark.parametrize("shape", [(2, 64, 32, 32), (3, 5, 7, 9), (1, 512, 16, 16)])
    def test_instance_norm(self, cuda, shape):
        g = torch.Generator(device=cuda).manual_seed(0)
        x = torch.randn(shape, device=cuda, generator=g) + 0.5
        gamma = torch.rand(shape[1], device=cuda, generator=g) + 0.5
        beta = torch.randn(shape[1], device=cuda, generator=g) * 0.1
        before = dict(ink.launches)
        y = ink.instance_norm(x, gamma, beta)
        assert launched(before) == {("forward", torch.float32): 1}
        torch.testing.assert_close(y, ink.instance_norm_plain(x, gamma, beta),
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("shape", [(1, 2, 1536, 2048), (2, 4, 33, 31)])
    def test_instance_norm_flat_planes(self, cuda, shape):
        """Planes whose mean is large against their spread, as in a flat
        image region, against float64: one-pass moments of x (E[x^2] -
        E[x]^2) in f32 lose their variance, and more so over a 2048x1536
        plane's long per-thread sums; the kernel's of x less the plane's
        first element do not."""
        g = torch.Generator(device=cuda).manual_seed(2)
        x = 50.0 + 0.1 * torch.randn(shape, device=cuda, generator=g)
        gamma = torch.rand(shape[1], device=cuda, generator=g) + 0.5
        beta = torch.randn(shape[1], device=cuda, generator=g) * 0.1
        y = ink.instance_norm(x, gamma, beta)
        xd = x.double()
        mean = xd.mean(dim=(2, 3), keepdim=True)
        xhat = (xd - mean) * torch.rsqrt((xd - mean).square().mean(dim=(2, 3), keepdim=True)
                                         + 1e-6)
        ref = xhat * gamma.double()[:, None, None] + beta.double()[:, None, None]
        torch.testing.assert_close(y.double(), ref, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("shape", [(2, 64, 64, 3), (3, 17, 31, 3), (2, 100, 130, 3),
                                       (1, 256, 256, 3), (2, 640, 640, 3)])
    def test_preprocess(self, cuda, shape):
        x = torch.rand(shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
        x[0] = 0.0
        before = pre.launches
        yuv, scale = pre.fused_standardize_yuv(x)
        assert pre.launches == before + 1
        ryuv, rscale = pre.fused_standardize_yuv_plain(x)
        torch.testing.assert_close(yuv, ryuv, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(scale, rscale, rtol=1e-5, atol=1e-5)
        assert scale[0].item() == 1.0 / 256.0

    def test_preprocess_on_unaligned_storage(self, cuda):
        # a contiguous view 4 bytes past an aligned base takes the 4-byte path
        shape = (3, 64, 64, 3)
        x = torch.rand(3 * 64 * 64 * 3 + 1, device=cuda)[1:].view(shape)
        yuv, scale = pre.fused_standardize_yuv(x)
        ryuv, rscale = pre.fused_standardize_yuv_plain(x)
        torch.testing.assert_close(yuv, ryuv, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(scale, rscale, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("shape", [(8, 256, 256, 3), (2, 640, 640, 3)],
                             ids=["resident", "streaming"])
    def test_preprocess_is_deterministic(self, cuda, shape):
        # the moments are summed in a fixed order: no atomics, no scratch
        x = torch.rand(shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
        yuv, scale = pre.fused_standardize_yuv(x)
        yuv2, scale2 = pre.fused_standardize_yuv(x)
        assert torch.equal(yuv, yuv2) and torch.equal(scale, scale2)

    @pytest.mark.parametrize("shape", [(2, 256, 256, 3), (8, 256, 256, 3)],
                             ids=["cluster16", "cluster8"])
    def test_preprocess_on_every_device(self, cuda, shape):
        """The kernel's shared-memory and cluster-size attributes hold for
        the device that set them; the wrapper sets them on each device
        before its first launch there. Both shapes need more than 48 KB of
        shared memory a block, the first a cluster of 16. Skips below two
        cards: one card cannot show the fault."""
        n = torch.cuda.device_count()
        if n < 2:
            pytest.skip("needs two CUDA cards: the attributes are per device")
        for i in range(n):
            dev = torch.device("cuda", i)
            x = torch.rand(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(i))
            before = pre.launches
            yuv, scale = pre.fused_standardize_yuv(x)
            assert pre.launches == before + 1 and i in pre._configured
            ryuv, rscale = pre.fused_standardize_yuv_plain(x)
            torch.testing.assert_close(yuv, ryuv, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(scale, rscale, rtol=1e-5, atol=1e-5)

    def test_instance_norm_on_unaligned_storage(self, cuda):
        # a contiguous view 4 bytes past an aligned base takes the scalar path
        shape = (2, 3, 8, 8)
        n = 2 * 3 * 8 * 8
        x = torch.randn(n + 1, device=cuda)[1:].view(shape)
        gamma, beta = torch.ones(3, device=cuda), torch.zeros(3, device=cuda)
        torch.testing.assert_close(ink.instance_norm(x, gamma, beta),
                                   ink.instance_norm_plain(x, gamma, beta),
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("shape", [(2, 64, 32, 32), (3, 5, 7, 9), (4, 1024, 4, 4),
                                       (2, 8, 5, 3)])
    def test_instance_norm_backward(self, cuda, shape):
        g = torch.Generator(device=cuda).manual_seed(3)
        x = torch.randn(shape, device=cuda, generator=g) + 0.5
        dy = torch.randn(shape, device=cuda, generator=g)
        gamma = torch.rand(shape[1], device=cuda, generator=g) + 0.5
        mean = x.mean(dim=(2, 3))
        rstd = torch.rsqrt((x - mean[:, :, None, None]).square().mean(dim=(2, 3)) + 1e-6)
        before = dict(ink.launches)
        got = ink.instance_norm_backward(x, gamma, mean, rstd, dy)
        assert launched(before) == {("backward", torch.float32): 1}
        again = ink.instance_norm_backward(x, gamma, mean, rstd, dy)
        for a, b, ref in zip(got, again, ink.instance_norm_backward_plain(x, gamma, mean,
                                                                        rstd, dy)):
            torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-4)
            assert torch.equal(a, b)  # deterministic: no atomics

    def test_instance_norm_gradients_reach_inputs(self, cuda):
        """The kernel path is differentiable: x, gamma and beta get the plain
        version's gradients, through the backward kernel."""
        g = torch.Generator(device=cuda).manual_seed(4)
        shape = (4, 16, 12, 12)
        ins = [torch.randn(shape, device=cuda, generator=g),
               torch.rand(16, device=cuda, generator=g) + 0.5,
               torch.randn(16, device=cuda, generator=g)]
        dy = torch.randn(shape, device=cuda, generator=g)
        a = [t.clone().requires_grad_(True) for t in ins]
        before = dict(ink.launches)
        y = ink.instance_norm(*a)
        assert y.grad_fn is not None
        y.backward(dy)
        assert launched(before) == {("forward", torch.float32): 1,
                                    ("backward", torch.float32): 1}
        b = [t.clone().requires_grad_(True) for t in ins]
        ink.instance_norm_plain(*b).backward(dy)
        for ta, tb in zip(a, b):
            assert ta.grad is not None
            torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-4, atol=1e-4)

    def test_wrappers_reject_wrong_dtype(self, cuda):
        for dtype in (torch.float64, torch.float16):
            with pytest.raises(ValueError):
                ink.instance_norm(torch.zeros(1, 2, 4, 4, device=cuda, dtype=dtype),
                                  torch.ones(2, device=cuda), torch.zeros(2, device=cuda))
        with pytest.raises(ValueError):  # gamma and beta stay f32 for bf16 activations
            ink.instance_norm(torch.zeros(1, 2, 4, 4, device=cuda, dtype=torch.bfloat16),
                              torch.ones(2, device=cuda, dtype=torch.bfloat16),
                              torch.zeros(2, device=cuda))
        x = torch.zeros(1, 2, 4, 4, device=cuda, dtype=torch.bfloat16)
        stats = torch.zeros(1, 2, device=cuda)
        with pytest.raises(ValueError):  # x and g share one dtype
            ink.instance_norm_backward(x, torch.ones(2, device=cuda), stats, stats + 1,
                                       torch.zeros(1, 2, 4, 4, device=cuda))
        with pytest.raises(ValueError):
            pre.fused_standardize_yuv(torch.zeros(1, 4, 4, 3, device=cuda).transpose(1, 2))

    # bf16 activations: y and dx within one bf16 ulp of the plain version
    # (rtol 2^-7) plus the f32 kernel's atol, dgamma and dbeta (f32) within 1e-3
    BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-4)

    @pytest.mark.parametrize("shape", [(2, 64, 32, 32), (3, 5, 7, 9), (4, 1024, 4, 4),
                                       (2, 8, 5, 3)])
    def test_instance_norm_bf16(self, cuda, shape):
        g = torch.Generator(device=cuda).manual_seed(5)
        x = (torch.randn(shape, device=cuda, generator=g) + 0.5).bfloat16()
        gamma = torch.rand(shape[1], device=cuda, generator=g) + 0.5
        beta = torch.randn(shape[1], device=cuda, generator=g) * 0.1
        before = dict(ink.launches)
        y = ink.instance_norm(x, gamma, beta)
        assert launched(before) == {("forward", torch.bfloat16): 1}
        ref = ink.instance_norm_plain(x, gamma, beta)
        assert y.dtype == ref.dtype == torch.bfloat16
        torch.testing.assert_close(y.float(), ref.float(), **self.BF16_TOL)
        assert torch.equal(y, ink.instance_norm(x, gamma, beta))

    @pytest.mark.parametrize("shape", [(2, 64, 32, 32), (3, 5, 7, 9), (4, 1024, 4, 4),
                                       (2, 8, 5, 3)])
    def test_instance_norm_backward_bf16(self, cuda, shape):
        g = torch.Generator(device=cuda).manual_seed(6)
        x = (torch.randn(shape, device=cuda, generator=g) + 0.5).bfloat16()
        dy = torch.randn(shape, device=cuda, generator=g).bfloat16()
        gamma = torch.rand(shape[1], device=cuda, generator=g) + 0.5
        xf = x.float()
        mean = xf.mean(dim=(2, 3))
        rstd = torch.rsqrt((xf - mean[:, :, None, None]).square().mean(dim=(2, 3)) + 1e-6)
        before = dict(ink.launches)
        got = ink.instance_norm_backward(x, gamma, mean, rstd, dy)
        assert launched(before) == {("backward", torch.bfloat16): 1}
        assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
        again = ink.instance_norm_backward(x, gamma, mean, rstd, dy)
        ref = ink.instance_norm_backward_plain(x, gamma, mean, rstd, dy)
        torch.testing.assert_close(got[0].float(), ref[0].float(), **self.BF16_TOL)
        for a, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-3)
        assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics

    def test_instance_norm_bf16_gradients_reach_inputs(self, cuda):
        """bf16 activations through the kernels: x gets a bf16 gradient, gamma
        and beta f32 ones, those of the plain version."""
        g = torch.Generator(device=cuda).manual_seed(7)
        shape = (4, 16, 12, 12)
        ins = [torch.randn(shape, device=cuda, generator=g).bfloat16(),
               torch.rand(16, device=cuda, generator=g) + 0.5,
               torch.randn(16, device=cuda, generator=g)]
        dy = torch.randn(shape, device=cuda, generator=g).bfloat16()
        a = [t.clone().requires_grad_(True) for t in ins]
        before = dict(ink.launches)
        y = ink.instance_norm(*a)
        assert y.dtype == torch.bfloat16 and y.grad_fn is not None
        y.backward(dy)
        assert launched(before) == {("forward", torch.bfloat16): 1,
                                    ("backward", torch.bfloat16): 1}
        b = [t.clone().requires_grad_(True) for t in ins]
        ink.instance_norm_plain(*b).backward(dy)
        assert a[0].grad.dtype == torch.bfloat16 and a[1].grad.dtype == torch.float32
        torch.testing.assert_close(a[0].grad.float(), b[0].grad.float(), **self.BF16_TOL)
        for ta, tb in zip(a[1:], b[1:]):
            torch.testing.assert_close(ta.grad, tb.grad, rtol=1e-3, atol=1e-3)

    # every variant of the forward in both dtypes: packed (8x8, 16x16), resident
    # at the two-pass map (two planes a block in bf16 at 32x32; one block at
    # 64x64), in a cluster (few planes), split (planes past a cluster's
    # registers), two-pass (H*W not a multiple of 16 bytes)
    FWD_CASES = [(300, 1, 8, 8), (300, 1, 16, 16), (300, 1, 32, 32), (300, 1, 64, 64),
                 (1, 4, 64, 64), (1, 2, 256, 512), (3, 5, 7, 9)]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    @pytest.mark.parametrize("shape", FWD_CASES, ids=lambda v: "x".join(map(str, v)))
    def test_instance_norm_forward_variants(self, cuda, shape, dtype):
        b, c, h, w = shape
        plan = ink._fwd_plan(b, c, h * w, dtype)
        g = torch.Generator(device=cuda).manual_seed(10)
        x = (torch.randn(shape, device=cuda, generator=g) + 0.5).to(dtype)
        gamma = torch.rand(c, device=cuda, generator=g) + 0.5
        beta = torch.randn(c, device=cuda, generator=g) * 0.1
        before = dict(ink.launches)
        got = ink._forward(x, gamma, beta, 1e-6, True)
        assert launched(before) == {("forward", dtype): 1}
        again = ink._forward(x, gamma, beta, 1e-6, True)
        assert all(torch.equal(a, r) for a, r in zip(got, again))  # no atomics
        tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else self.BF16_TOL
        torch.testing.assert_close(got[0].float(), ink.instance_norm_plain(
            x, gamma, beta).float(), **tol)
        if ink.keeps_two_pass_bits(plan):
            two = ink._launch_forward(x, gamma, beta, 1e-6, True,
                                      ink.two_pass_plan(h * w, 16 // x.element_size()))
            assert all(torch.equal(a, t) for a, t in zip(got, two))

    def test_instance_norm_forward_refuses_a_plan_it_cannot_run(self, cuda):
        x = torch.randn(2, 8, 64, 64, device=cuda)
        gamma, beta = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
        plan = ink._fwd_plan(2, 8, 64 * 64, torch.float32)
        for bad in (plan._replace(threads=2 * plan.threads), plan._replace(lanes=48),
                    plan._replace(variant="split")):
            with pytest.raises(RuntimeError, match="CUDA error 1"):
                ink._launch_forward(x, gamma, beta, 1e-6, False, bad)
        with pytest.raises(RuntimeError, match="CUDA error 1"):  # x off 16 bytes
            ink._launch_forward(x.flatten()[1:].view(1, 1, 1, -1)[..., :4096 * 8 - 4],
                                gamma[:1], beta[:1], 1e-6, False,
                                ink._fwd_plan(1, 1, 4096 * 8 - 4, torch.float32))

    # every variant of the backward kernel in both dtypes: shape, then (variant,
    # blocks per plane) in f32 and in bf16; packed with 16-byte chunks and with
    # single elements (H*W not a multiple of 16 bytes), resident in one block
    # and in clusters of 2 to 8 (phase B's 256 x 256 planes: 8 in f32, 4 in
    # bf16), streaming above 8 blocks' registers and off 16 bytes
    VARIANT_CASES = [
        ((2, 64, 8, 8), ("packed", 1), ("packed", 1)),
        ((2, 32, 16, 16), ("packed", 1), ("packed", 1)),
        ((3, 5, 7, 9), ("packed", 1), ("packed", 1)),
        ((2, 8, 5, 3), ("packed", 1), ("packed", 1)),
        ((2, 64, 32, 32), ("resident", 1), ("resident", 1)),
        ((2, 16, 64, 64), ("resident", 1), ("resident", 1)),
        ((2, 8, 128, 128), ("resident", 2), ("resident", 1)),
        ((1, 4, 128, 256), ("resident", 4), ("resident", 2)),
        ((1, 2, 200, 200), ("resident", 5), ("resident", 3)),
        ((1, 2, 192, 224), ("resident", 6), ("resident", 3)),
        ((1, 3, 224, 224), ("resident", 7), ("resident", 4)),
        ((2, 16, 256, 256), ("resident", 8), ("resident", 4)),
        ((1, 2, 512, 512), ("streaming", 1), ("streaming", 1)),
        ((1, 2, 33, 33), ("streaming", 1), ("streaming", 1))]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    @pytest.mark.parametrize("shape,f32_plan,bf16_plan", VARIANT_CASES,
                             ids=lambda v: "x".join(map(str, v)))
    def test_instance_norm_backward_variants(self, cuda, shape, f32_plan, bf16_plan, dtype):
        b, c, h, w = shape
        plan = ink._bwd_plan(b, c, h * w, dtype)
        assert (plan.variant, plan.cluster) == (f32_plan if dtype == torch.float32
                                                else bf16_plan)
        g = torch.Generator(device=cuda).manual_seed(8)
        x = (torch.randn(shape, device=cuda, generator=g) + 0.5).to(dtype)
        dy = torch.randn(shape, device=cuda, generator=g).to(dtype)
        gamma = torch.rand(c, device=cuda, generator=g) + 0.5
        y, mean, rstd = ink._forward(x, gamma, torch.zeros_like(gamma), 1e-6, with_stats=True)
        before = dict(ink.launches)
        got = ink.instance_norm_backward(x, gamma, mean, rstd, dy)
        assert launched(before) == {("backward", dtype): 1}
        again = ink.instance_norm_backward(x, gamma, mean, rstd, dy)
        ref = ink.instance_norm_backward_plain(x, gamma, mean, rstd, dy)
        tol, ptol = ((dict(rtol=1e-4, atol=1e-4),) * 2 if dtype == torch.float32
                     else (self.BF16_TOL, dict(rtol=1e-3, atol=1e-3)))
        assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32]
        torch.testing.assert_close(got[0].float(), ref[0].float(), **tol)
        for a, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, r, **ptol)
        assert all(torch.equal(a, r) for a, r in zip(got, again))  # no atomics

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    @pytest.mark.parametrize("shape", [(3, 16, 8, 8), (2, 8, 32, 32), (1, 2, 128, 128)])
    def test_instance_norm_backward_on_unaligned_storage(self, cuda, shape, dtype):
        # x, g and dx views one element past an aligned base: the same plan,
        # 16-byte chunks moved one element at a time
        n = torch.Size(shape).numel()
        g = torch.Generator(device=cuda).manual_seed(9)
        x = (torch.randn(n + 1, device=cuda, generator=g) + 0.5).to(dtype)[1:].view(shape)
        dy = torch.randn(n + 1, device=cuda, generator=g).to(dtype)[1:].view(shape)
        gamma = torch.rand(shape[1], device=cuda, generator=g) + 0.5
        xf = x.float()
        mean = xf.mean(dim=(2, 3))
        rstd = torch.rsqrt((xf - mean[:, :, None, None]).square().mean(dim=(2, 3)) + 1e-6)
        got = ink.instance_norm_backward(x, gamma, mean, rstd, dy)
        ref = ink.instance_norm_backward_plain(x, gamma, mean, rstd, dy)
        tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else self.BF16_TOL
        torch.testing.assert_close(got[0].float(), ref[0].float(), **tol)
        for a, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-3)

    def test_backward_refuses_a_plan_it_cannot_run(self, cuda):
        """A plan the kernels cannot run at the shape launches nothing and
        raises: no other variant takes over."""
        x = torch.randn(2, 4, 16, 16, device=cuda)
        stats = torch.ones(2, 4, device=cuda)
        gamma = torch.ones(4, device=cuda)
        good = ink._bwd_plan(2, 4, 256, torch.float32)
        bad = [good._replace(lanes=3), good._replace(lanes=4),  # 3: not a power of 2
               good._replace(threads=1024), good._replace(cluster=2),
               ink.BwdPlan("resident", 1, 128, 128, 1, 4, 1)._replace(lanes=64),
               ink.BwdPlan("streaming", 1, 128, 128, 1, 4, 1),
               good._replace(variant="streaming")]
        # a cluster of 9 (past the portable 8) where 9 x 512 threads would
        # hold the plane; more than 8 chunks a thread; a cluster on H*W off
        # 16 bytes
        big = torch.randn(1, 1, 256, 256, device=cuda)
        odd = torch.randn(1, 1, 33, 33, device=cuda)
        one = torch.ones(1, 1, device=cuda)
        plan = ink._bwd_plan(1, 1, 256 * 256, torch.float32)
        assert (plan.variant, plan.cluster) == ("resident", 8)
        bad_big = [plan._replace(cluster=9, lanes=9 * 512),
                   plan._replace(cluster=2, lanes=1024, chunks=16),
                   plan._replace(cluster=4, threads=256, lanes=1024, chunks=16)]
        bad_odd = [ink.BwdPlan("resident", 1, 2 * 64, 64, 2, 1, 5),
                   ink.BwdPlan("resident", 1, 2 * 64, 64, 2, 4, 2)]
        before = dict(ink.launches)
        for t, p, cases in ((x, stats, bad), (big, one, bad_big), (odd, one, bad_odd)):
            for plan in cases:
                with pytest.raises(RuntimeError, match="CUDA error 1"):
                    ink._launch_backward(t, gamma[:t.shape[1]], p, p, t, plan)
        assert launched(before) == {}

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    def test_backward_at_eight_chunks_a_thread(self, cuda, dtype):
        """A resident plan made by hand with 8 chunks a thread (the kernel's
        wide form, which the sweep times) against the plain version."""
        shape = (2, 3, 256, 256)
        vec = 16 // dtype.itemsize
        nchunks = 256 * 256 // vec
        cluster = nchunks // (512 * 8)
        plan = ink.BwdPlan("resident", 1, 512 * cluster, 512, cluster, vec, 8)
        g = torch.Generator(device=cuda).manual_seed(10)
        x = (torch.randn(shape, device=cuda, generator=g) + 0.5).to(dtype)
        dy = torch.randn(shape, device=cuda, generator=g).to(dtype)
        gamma = torch.rand(3, device=cuda, generator=g) + 0.5
        _, mean, rstd = ink._forward(x, gamma, torch.zeros_like(gamma), 1e-6, with_stats=True)
        got = ink._launch_backward(x, gamma, mean, rstd, dy, plan)
        again = ink._launch_backward(x, gamma, mean, rstd, dy, plan)
        ref = ink.instance_norm_backward_plain(x, gamma, mean, rstd, dy)
        tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else self.BF16_TOL
        torch.testing.assert_close(got[0].float(), ref[0].float(), **tol)
        for a, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-3)
        assert all(torch.equal(a, r) for a, r in zip(got, again))
        assert ink.blocks_per_sm(plan, dtype) >= 1

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
    def test_resident_plans_fit_two_blocks_per_sm(self, cuda, dtype):
        for hw in (32 * 32, 64 * 64, 128 * 128, 256 * 256):
            plan = ink._bwd_plan(40, 64, hw, dtype)
            assert plan.variant == "resident"
            assert ink.blocks_per_sm(plan, dtype) >= 2
            if plan.cluster > 1:  # the card runs such clusters at once
                assert ink.max_active_clusters(plan, dtype) >= 1
