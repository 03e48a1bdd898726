"""The configuration fields that inference reads: an own copy of
shmgan_tpu/config.py's ModelConfig and EvalConfig, with the same defaults.

The port computes in float32 throughout (the JAX package's
compute_dtype="float32"); bf16 compute is not ported yet. The image size is
the input's own: nothing in inference reads a configured one.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    filter_size: int = 64          # base conv width of G
    c_dim: int = 5                 # polarimetric domains (I0, I45, I90, I135, ED)
    specseg_base_filters: int = 16
    # 1 = standardised luma only; 2 = luma + the chroma prior (ops/specprior.py)
    specseg_in_channels: int = 1
    instance_norm_eps: float = 1e-6
    leaky_relu_slope: float = 0.2
    # "conv_transpose" (reference parity) or "resize_conv" (nearest 2x + conv3x3)
    upsample_mode: str = "conv_transpose"


@dataclass
class EvalConfig:
    # average SpecSeg's probabilities over the dihedral views
    mask_tta: bool = False
    # fuse the dichromatic chroma prior into the specular mask
    mask_chroma_prior: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
