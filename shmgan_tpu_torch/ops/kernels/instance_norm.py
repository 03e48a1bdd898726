"""Instance normalisation over NCHW activations: the CUDA kernels (forward and
backward) and their plain versions.

`instance_norm(x, gamma, beta, eps)` runs `instance_norm_plain` for a CPU
tensor, which autograd differentiates. For a CUDA tensor it launches
`csrc/instance_norm.cu`: when an input requires grad, through
`_InstanceNormFn`, whose forward also saves each plane's mean and rstd and
whose backward launches the backward kernel (`instance_norm_backward`);
otherwise the forward kernel alone. There is no other fallback.

The kernels replace the TPU kernel `shmgan_tpu/ops/pallas/instance_norm.py`
(`instance_norm_pallas`) and its custom VJP (`_fwd` / `_bwd`). The forward
kernel takes one-pass moments, the plain version two-pass ones, as the JAX
package's `instance_norm_reference` does, so the two agree to rounding.
`instance_norm_backward_plain` transcribes `_bwd`.

`launches` and `backward_launches` count kernel launches, so a run can show
its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

launches = 0
backward_launches = 0

_fwd = None
_bwd = None


def _kernel_fns():
    global _fwd, _bwd
    if _fwd is None:
        from shmgan_tpu_torch.runtime.build import load

        lib = load("instance_norm")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fwd = lib.shm_instance_norm_f32
        fwd.argtypes = [p, p, p, p, p, p, ll, i, ll, ctypes.c_float, p]
        fwd.restype = i
        bwd = lib.shm_instance_norm_bwd_f32
        bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, ll, p]
        bwd.restype = i
        _fwd, _bwd = fwd, bwd
    return _fwd, _bwd


def instance_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H, W); per-(b, c) moments over H, W, in f32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)


def instance_norm_backward_plain(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                                 rstd: torch.Tensor, g: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) of instance norm at x for the output gradient g,
    from the per-plane mean and rstd (B, C); `_bwd` of the JAX package."""
    n = x.shape[2] * x.shape[3]
    inv = rstd[:, :, None, None]
    xhat = (x - mean[:, :, None, None]) * inv
    dgamma = (g * xhat).sum(dim=(0, 2, 3))
    dbeta = g.sum(dim=(0, 2, 3))
    gg = g * gamma.view(1, -1, 1, 1)
    sum_gg = gg.sum(dim=(2, 3), keepdim=True)
    sum_gg_xhat = (gg * xhat).sum(dim=(2, 3), keepdim=True)
    dx = inv / n * (n * gg - sum_gg - xhat * sum_gg_xhat)
    return dx, dgamma, dbeta


def _check(x: torch.Tensor, **others: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"instance_norm: expected (B, C, H, W), got {tuple(x.shape)}")
    for name, t in (("x", x), *others.items()):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"instance_norm: {name} must be contiguous float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")


def _forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
             with_stats: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """One launch of the forward kernel; with_stats also returns the (B, C)
    mean and rstd."""
    global launches
    b, c, h, w = x.shape
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"instance_norm: gamma/beta must be ({c},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")
    y = torch.empty_like(x)
    mean = rstd = None
    if with_stats:
        mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
        rstd = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, mean, rstd
    with torch.cuda.device(x.device):
        err = _kernel_fns()[0](
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr() if with_stats else None, rstd.data_ptr() if with_stats else None,
            b * c, c, h * w, float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance_norm kernel launch failed: CUDA error {err}")
    launches += 1
    return y, mean, rstd


def instance_norm_backward(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                           rstd: torch.Tensor, g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) through the backward kernel, for CUDA tensors: x and
    g (B, C, H, W), gamma (C,), mean and rstd (B, C) from the forward."""
    global backward_launches
    _check(x, g=g, gamma=gamma, mean=mean, rstd=rstd)
    b, c, h, w = x.shape
    if g.shape != x.shape or gamma.shape != (c,) or mean.shape != (b, c) \
            or rstd.shape != (b, c):
        raise ValueError(f"instance_norm_backward: shapes x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, gamma {tuple(gamma.shape)}, mean "
                         f"{tuple(mean.shape)}, rstd {tuple(rstd.shape)} do not fit")
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    scratch = torch.empty(2 * b * c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fns()[1](
            x.data_ptr(), g.data_ptr(), gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), scratch.data_ptr(),
            b, c, h * w, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance_norm backward kernel launch failed: CUDA error {err}")
    backward_launches += 1
    return dx, dgamma, dbeta


class _InstanceNormFn(torch.autograd.Function):
    """Forward kernel with saved (mean, rstd); backward kernel."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = _forward(x, gamma, beta, eps, with_stats=True)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = instance_norm_backward(x, gamma, mean, rstd, g.contiguous())
        return dx, dgamma, dbeta, None


def instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Instance norm of a contiguous f32 (B, C, H, W) tensor with per-channel
    gamma and beta of shape (C,). Differentiable in x, gamma and beta."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, gamma, beta, eps)
    _check(x, gamma=gamma, beta=beta)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _InstanceNormFn.apply(x, gamma, beta, eps)
    return _forward(x, gamma, beta, eps, with_stats=False)[0]
