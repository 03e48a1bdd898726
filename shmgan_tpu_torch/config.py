"""The port's configuration tree: an own copy of shmgan_tpu/config.py's
ModelConfig, TrainConfig, DataConfig, MeshConfig, EvalConfig and ServeConfig,
with the same defaults, and of `Config.from_args`, the CLI surface, with the
same flag names and defaults. The port keeps the fields that inference, the
train step and its loop, serving and the CLI read or set; of MeshConfig,
the two axes' sizes and spatial sharding.

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

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises,
    rather than run on the CPU: the CPU is taken only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run on the CPU")
    return device


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
    d_repeat_num: int = 6          # dead in the reference; kept for CLI parity
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
    num_epochs: int = 200
    n_critic: int = 5              # dead in the reference; kept for CLI parity
    log_step: int = 1
    checkpoint_save_step: int = 10
    g_lr: float = 2e-5
    d_lr: float = 2e-5
    beta1: float = 0.5
    beta2: float = 0.99
    adam_eps: float = 1e-7         # outside the square root, as optax's scale_by_adam
    lr_decay_steps: int = 10000    # lr * rate ** (count / steps), continuous
    lr_decay_rate: float = 0.95
    num_iteration: int = 20000     # dead in the reference
    num_iteration_decay: int = 100000  # dead in the reference
    grad_clip: float = 1.0         # elementwise clip before Adam
    seed: int = 25
    randomness: float = 0.50       # Bernoulli drop probability of each input view
    target_label_low: float = 0.8  # per-step label smoothing t ~ U[low, high]
    target_label_high: float = 1.2
    train_G_after: int = 0         # epochs before G updates begin
    style_weight: float = 100.0    # NST loss weights
    content_weight: float = 1.0
    delete_old_checkpoints: bool = False
    checkpoint_save_dir: str = "./checkpoints"
    model_save_dir: str = "./models"
    result_dir: str = "./results"  # test mode and serve --serve_watch_dir write here
    log_dir: str = "./logs/train"
    checkpoint_max_to_keep: int = 3
    # per-epoch shuffle derived from (seed, epoch); off = the reference's file order
    shuffle: bool = False
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
    # restore the latest checkpoint when training starts
    auto_resume: bool = True


@dataclass
class DataConfig:
    data_dir: str = "./data/PolarizedSource"
    test_dir: str = "./data/test"
    diffuse_dir: str = "./data/test_diffuse"
    est_diffuse: bool = True       # synthesize ED from the 4 views when folder absent
    flip: bool = True              # per-step paired random up/down flip
    # sub-folder names of the five aligned views, in the two naming schemes
    view_dirs: tuple = ("I0", "I45", "I90", "I135", "ED")
    psd_view_dirs: tuple = ("I0", "I60", "I90", "I150", "ED")
    use_psd_naming: bool = False
    prefetch: int = 4              # host -> device prefetch depth
    num_workers: int = 4           # decode / resize worker threads
    cache_in_memory: bool = True   # cache the decoded float32 views in RAM


@dataclass
class MeshConfig:
    # -1 means "all": every launched rank the model axis leaves in training
    # (parallel/mesh.py), one device in serving, as the JAX engine reads it
    data_parallel: int = -1
    # tensor parallelism in training: the output channels of the wide conv
    # kernels split over this many ranks (parallel/tp.py); serving ignores it
    model_parallel: int = 1
    # shard feature maps spatially (H) over the model axis in training, with
    # every parameter whole (parallel/spatial.py); the CLI has no flag for it
    spatial_sharding: bool = False
    # conv kernels with at least this many output channels are split over
    # the model axis; narrower ones stay whole on every rank
    tp_min_channels: int = 256


@dataclass
class EvalConfig:
    calc_metrics: bool = False
    specseg_weights: str = "specsegv3_chkpt.h5"
    # deploy the checkpoint's EMA generator tree when it carries one
    use_ema: bool = True
    # serve / test each photo at its own resolution (reflect-pad to a
    # bucketed shape, crop back: infer.make_native_infer_fn)
    native_resolution: bool = False
    # average SpecSeg's probabilities over the dihedral views
    mask_tta: bool = False
    # fuse the dichromatic chroma prior into the specular mask
    mask_chroma_prior: bool = False
    # storage dtype of exported bundles ("" = keep float32)
    export_dtype: str = ""
    # checkpoint step to restore for test/serve/export (0 = the latest)
    checkpoint_step: int = 0


@dataclass
class ServeConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    batch_size: int = 1
    # when set, run the folder-watch daemon instead of the HTTP server
    watch_dir: str = ""
    # serve from an inference bundle (checkpoint.load_inference_bundle)
    weights_bundle: str = ""
    # >0: concurrent HTTP requests of one size aggregate into one device call
    batch_window_ms: float = 0.0
    # image sizes (or "native") to warm engines for before accepting traffic
    warm_sizes: tuple = ()


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    mode: str = "train"

    @classmethod
    def from_args(cls, argv: Optional[list] = None) -> "Config":
        """A Config from the CLI surface of shmgan_tpu/config.py: the same
        flags, defaults and choices."""
        p = argparse.ArgumentParser(description="SHMGAN on PyTorch: specular highlight "
                                                "mitigation")
        p.add_argument("--est_diffuse", type=_strtobool, default=True)
        p.add_argument("--flip", type=_strtobool, default=True)
        p.add_argument("--mode", type=str, default="train",
                       choices=["train", "test", "serve", "export", "bench"])
        p.add_argument("--serve_host", type=str, default="0.0.0.0")
        p.add_argument("--serve_port", type=int, default=8000)
        p.add_argument("--serve_batch_size", type=int, default=1)
        p.add_argument("--serve_watch_dir", type=str, default="")
        p.add_argument("--serve_weights_bundle", type=str, default="")
        p.add_argument("--serve_batch_window_ms", type=float, default=0.0)
        p.add_argument("--serve_warm_sizes", type=str, default="",
                       help="comma-separated image sizes (or 'native') to warm "
                            "serving engines for at startup")
        p.add_argument("--calc_metrics", type=_strtobool, default=False)
        p.add_argument("--delete_old_checkpoints", type=_strtobool, default=False)
        p.add_argument("--image_size", type=int, default=128)
        p.add_argument("--batch_size", type=int, default=1)
        p.add_argument("--num_epochs", type=int, default=200)
        p.add_argument("--n_critic", type=int, default=5)
        p.add_argument("--log_step", type=int, default=1)
        p.add_argument("--checkpoint_save_step", type=int, default=10)
        p.add_argument("--filter_size", type=int, default=64)
        p.add_argument("--c_dim", type=int, default=5)
        p.add_argument("--g_lr", type=float, default=2e-5)
        p.add_argument("--d_lr", type=float, default=2e-5)
        p.add_argument("--beta1", type=float, default=0.5)
        p.add_argument("--beta2", type=float, default=0.99)
        p.add_argument("--num_iteration_decay", type=int, default=100000)
        p.add_argument("--d_repeat_num", type=int, default=6)
        p.add_argument("--data_dir", type=str, default="./data/PolarizedSource")
        p.add_argument("--test_dir", type=str, default="./data/test")
        p.add_argument("--diffuse_dir", type=str, default="./data/test_diffuse")
        p.add_argument("--model_save_dir", type=str, default="./models")
        p.add_argument("--checkpoint_save_dir", type=str, default="./checkpoints")
        p.add_argument("--result_dir", type=str, default="./results")
        p.add_argument("--log_dir", type=str, default="./logs/train")
        p.add_argument("--num_iteration", type=int, default=20000)
        p.add_argument("--specseg_weights", type=str, default="specsegv3_chkpt.h5")
        p.add_argument("--use_ema", type=_strtobool, default=True,
                       help="test/serve/export with the checkpoint's EMA "
                            "generator tree when present")
        p.add_argument("--native_resolution", type=_strtobool, default=False,
                       help="inference at each photo's own resolution (no square resize)")
        p.add_argument("--mask_tta", type=_strtobool, default=False,
                       help="average the SpecSeg mask over dihedral "
                            "flip/transpose views at inference")
        p.add_argument("--mask_chroma_prior", type=_strtobool, default=False,
                       help="fuse the dichromatic chroma prior into "
                            "inference-path specular masks (ops/specprior.py)")
        p.add_argument("--export_dtype", type=str, default="",
                       choices=["", "float16", "bfloat16"],
                       help="storage dtype for --mode export bundles")
        p.add_argument("--checkpoint_step", type=int, default=0,
                       help="restore this checkpoint step for test/serve/export "
                            "(0 = latest)")
        p.add_argument("--compute_dtype", type=str, default="bfloat16",
                       choices=["float32", "bfloat16"])
        p.add_argument("--upsample_mode", type=str, default="conv_transpose",
                       choices=["conv_transpose", "resize_conv"])
        p.add_argument("--specseg_in_channels", type=int, default=1, choices=[1, 2],
                       help="SpecSeg input channels: 1 = parity (luma only), "
                            "2 = + dichromatic chroma prior channel")
        p.add_argument("--remat", type=str, default="none",
                       choices=["none", "models", "disc", "gen"],
                       help="recompute model forwards in the train step's backward")
        p.add_argument("--seed", type=int, default=25)
        p.add_argument("--data_parallel", type=int, default=-1)
        p.add_argument("--model_parallel", type=int, default=1)
        p.add_argument("--psd_naming", type=_strtobool, default=False)
        a = p.parse_args(argv)

        cfg = cls()
        cfg.mode = a.mode
        cfg.model = dataclasses.replace(
            cfg.model, image_size=a.image_size, filter_size=a.filter_size,
            c_dim=a.c_dim, d_repeat_num=a.d_repeat_num,
            compute_dtype=a.compute_dtype, upsample_mode=a.upsample_mode,
            specseg_in_channels=a.specseg_in_channels)
        cfg.train = dataclasses.replace(
            cfg.train, batch_size=a.batch_size, num_epochs=a.num_epochs,
            n_critic=a.n_critic, log_step=a.log_step,
            checkpoint_save_step=a.checkpoint_save_step, g_lr=a.g_lr, d_lr=a.d_lr,
            beta1=a.beta1, beta2=a.beta2, num_iteration_decay=a.num_iteration_decay,
            num_iteration=a.num_iteration, seed=a.seed,
            delete_old_checkpoints=a.delete_old_checkpoints,
            checkpoint_save_dir=a.checkpoint_save_dir, model_save_dir=a.model_save_dir,
            result_dir=a.result_dir, log_dir=a.log_dir, remat=a.remat)
        cfg.data = dataclasses.replace(
            cfg.data, data_dir=a.data_dir, test_dir=a.test_dir,
            diffuse_dir=a.diffuse_dir, est_diffuse=a.est_diffuse, flip=a.flip,
            use_psd_naming=a.psd_naming)
        cfg.mesh = dataclasses.replace(
            cfg.mesh, data_parallel=a.data_parallel, model_parallel=a.model_parallel)
        cfg.eval = dataclasses.replace(
            cfg.eval, calc_metrics=a.calc_metrics,
            specseg_weights=a.specseg_weights, use_ema=a.use_ema,
            native_resolution=a.native_resolution, mask_tta=a.mask_tta,
            mask_chroma_prior=a.mask_chroma_prior, export_dtype=a.export_dtype,
            checkpoint_step=a.checkpoint_step)
        cfg.serve = dataclasses.replace(
            cfg.serve, host=a.serve_host, port=a.serve_port,
            batch_size=a.serve_batch_size, watch_dir=a.serve_watch_dir,
            weights_bundle=a.serve_weights_bundle,
            batch_window_ms=a.serve_batch_window_ms,
            warm_sizes=tuple(
                s.strip() if s.strip() == "native" else int(s)
                for s in a.serve_warm_sizes.split(",") if s.strip()))
        return cfg

    def describe(self) -> str:
        """Option dump, as the JAX package's."""
        lines = ["------------ Options -------------"]
        for section in ("model", "train", "data", "mesh", "eval"):
            for f in dataclasses.fields(getattr(self, section)):
                lines.append(f"{section}.{f.name}: {getattr(getattr(self, section), f.name)}")
        lines.append(f"mode: {self.mode}")
        lines.append("-------------- End ----------------")
        return "\n".join(lines)


def _strtobool(x) -> bool:
    if isinstance(x, bool):
        return x
    return str(x).strip().lower() in ("1", "true", "yes", "y", "t")
