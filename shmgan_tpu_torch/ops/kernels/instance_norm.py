"""Instance normalisation over NCHW activations: the CUDA kernel and its plain
version.

`instance_norm(x, gamma, beta, eps)` launches `csrc/instance_norm.cu` for a
CUDA tensor and runs `instance_norm_plain` for a CPU tensor; there is no other
fallback. The kernel replaces the TPU kernel
`shmgan_tpu/ops/pallas/instance_norm.py` (`instance_norm_pallas`); it takes
one-pass moments, the plain version two-pass ones, as the JAX package's
`instance_norm_reference` does, so the two agree to rounding.

`launches` counts kernel launches, so a run can show its path went through the
kernel. Only the forward is ported: the backward belongs to the training slice.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from shmgan_tpu_torch.runtime.build import load

        fn = load("instance_norm").shm_instance_norm_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def instance_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H, W); per-(b, c) moments over H, W, in f32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)


def instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Instance norm of a contiguous f32 (B, C, H, W) tensor with per-channel
    gamma and beta of shape (C,)."""
    if x.device.type == "cpu":
        return instance_norm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"instance_norm: expected (B, C, H, W), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"instance_norm: {name} must be contiguous float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"instance_norm: gamma/beta must be ({c},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    global launches
    with torch.cuda.device(x.device):
        err = _kernel_fn()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                           y.data_ptr(), b * c, c, h * w, float(eps),
                           torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance_norm kernel launch failed: CUDA error {err}")
    launches += 1
    return y
