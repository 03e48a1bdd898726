"""The port's CUDA kernels against their plain versions, on the card.

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


@pytest.mark.gpu
class TestKernelsOnCard:
    """The CUDA kernels vs their plain versions on the card."""

    @pytest.mark.parametrize("shape", [(2, 64, 32, 32), (3, 5, 7, 9), (1, 512, 16, 16)])
    def test_instance_norm(self, cuda, shape):
        g = torch.Generator(device=cuda).manual_seed(0)
        x = torch.randn(shape, device=cuda, generator=g) + 0.5
        gamma = torch.rand(shape[1], device=cuda, generator=g) + 0.5
        beta = torch.randn(shape[1], device=cuda, generator=g) * 0.1
        before = ink.launches
        y = ink.instance_norm(x, gamma, beta)
        assert ink.launches == before + 1
        torch.testing.assert_close(y, ink.instance_norm_plain(x, gamma, beta),
                                   rtol=1e-4, atol=1e-4)

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

    def test_instance_norm_on_unaligned_storage(self, cuda):
        # a contiguous view 4 bytes past an aligned base takes the scalar path
        shape = (2, 3, 8, 8)
        n = 2 * 3 * 8 * 8
        x = torch.randn(n + 1, device=cuda)[1:].view(shape)
        gamma, beta = torch.ones(3, device=cuda), torch.zeros(3, device=cuda)
        torch.testing.assert_close(ink.instance_norm(x, gamma, beta),
                                   ink.instance_norm_plain(x, gamma, beta),
                                   rtol=1e-4, atol=1e-4)

    def test_wrappers_reject_wrong_dtype(self, cuda):
        with pytest.raises(ValueError):
            ink.instance_norm(torch.zeros(1, 2, 4, 4, device=cuda, dtype=torch.float64),
                              torch.ones(2, device=cuda), torch.zeros(2, device=cuda))
        with pytest.raises(ValueError):
            pre.fused_standardize_yuv(torch.zeros(1, 4, 4, 3, device=cuda).transpose(1, 2))
