"""PyTorch / CUDA port of shmgan_tpu's single-RGB inference path.

Imports torch, numpy and the standard library only. The JAX package
(shmgan_tpu) is the reference that the port's tests hold it against.
"""

from shmgan_tpu_torch.config import Config, EvalConfig, ModelConfig

__all__ = ["Config", "EvalConfig", "ModelConfig"]
