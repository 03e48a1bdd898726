"""The configuration fields that inference and the train step read: an own
copy of shmgan_tpu/config.py's ModelConfig, TrainConfig, DataConfig and
EvalConfig, with the same defaults.

`model.compute_dtype` is the models' compute dtype, as in the JAX package:
"bfloat16" (its default) or "float32". Parameters are float32 at either; each
convolution and dense layer casts its input, weight and bias to the compute
dtype, instance norm and SpecSeg's batch norm compute in float32 and hand
back the compute dtype, and the rest of inference and of the train step
(preprocessing, losses, SSIM, the optimizer) stays float32. Inference takes
the input's own image size; `model.image_size` sizes the discriminator's
class head and the NST loss's style factor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a `model.compute_dtype` name; raises on any other."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"model.compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                         f"got {name!r}")
    return COMPUTE_DTYPES[name]


@dataclass
class ModelConfig:
    image_size: int = 128
    filter_size: int = 64          # base conv width of G and D
    c_dim: int = 5                 # polarimetric domains (I0, I45, I90, I135, ED)
    specseg_base_filters: int = 16
    # 1 = standardised luma only; 2 = luma + the chroma prior (ops/specprior.py)
    specseg_in_channels: int = 1
    instance_norm_eps: float = 1e-6
    leaky_relu_slope: float = 0.2
    d_input_noise: float = 0.1     # D's GaussianNoise stddev on its live pass
    d_dropout: float = 0.2         # D's dropout rate on its live pass
    # "conv_transpose" (reference parity) or "resize_conv" (nearest 2x + conv3x3)
    upsample_mode: str = "conv_transpose"
    # the models' compute dtype; parameters stay float32 (see the docstring)
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        compute_dtype(self.compute_dtype)


@dataclass
class TrainConfig:
    batch_size: int = 1
    g_lr: float = 2e-5
    d_lr: float = 2e-5
    beta1: float = 0.5
    beta2: float = 0.99
    adam_eps: float = 1e-7         # outside the square root, as optax's scale_by_adam
    lr_decay_steps: int = 10000    # lr * rate ** (count / steps), continuous
    lr_decay_rate: float = 0.95
    grad_clip: float = 1.0         # elementwise clip before Adam
    randomness: float = 0.50       # Bernoulli drop probability of each input view
    target_label_low: float = 0.8  # per-step label smoothing t ~ U[low, high]
    target_label_high: float = 1.2
    train_G_after: int = 0         # epochs before G updates begin
    style_weight: float = 100.0    # NST loss weights
    content_weight: float = 1.0
    # one drop pattern shared by the batch (reference parity) or one per sample
    scalar_channel_dropout: bool = True
    # quality-mode flags (defaults are reference parity; see the JAX config)
    live_g1: bool = False
    g1_recon_weight: float = 0.0
    single_input_prob: float = 0.0
    consistent_domains: bool = False
    # "none" | "models" | "disc" | "gen": which forwards run under
    # torch.utils.checkpoint (recomputed in the backward)
    remat: str = "none"
    g_ema: float = 0.0             # EMA decay of G's params; 0 = off


@dataclass
class DataConfig:
    flip: bool = True              # per-step paired random up/down flip


@dataclass
class EvalConfig:
    # average SpecSeg's probabilities over the dihedral views
    mask_tta: bool = False
    # fuse the dichromatic chroma prior into the specular mask
    mask_chroma_prior: bool = False


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
