"""Wrappers of the port's CUDA kernels, each beside its plain PyTorch version."""

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Kernel launches in this process so far, by kernel name."""
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink
    from shmgan_tpu_torch.ops.kernels import preprocess as pre

    return {**{ink.kernel_name(*k): n for k, n in ink.launches.items()},
            "fused_standardize_yuv": pre.launches,
            "fused_standardize_yuv_band": pre.band_launches}
