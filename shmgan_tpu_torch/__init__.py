"""PyTorch / CUDA port of shmgan_tpu: single-RGB inference and serving, the
fused train step, and training through its loop, checkpoints and CLI.

Imports torch, numpy and the standard library only. The JAX package
(shmgan_tpu) is the reference that the port's tests hold it against.
"""

from shmgan_tpu_torch.config import (Config, DataConfig, EvalConfig, MeshConfig,
                                     ModelConfig, ServeConfig, TrainConfig)

__all__ = ["Config", "DataConfig", "EvalConfig", "MeshConfig", "ModelConfig", "ServeConfig",
           "TrainConfig"]
