"""SpecSeg training: the counterpart of shmgan_tpu/train/specseg_train.py.
The mask U-Net learns dice + focal on (standardised input, binary mask)
pairs, with batch statistics while it trains, dropout from injected keep
masks (`SpecSeg.sample_keep`), and the GAN's optimizer recipe: clip ->
Adam -> exponential decay (`train.state.ClipAdamDecay`) at `cfg.train.g_lr`.

SpecSeg trains in float32 whatever `model.compute_dtype` says, as the JAX
package builds it with flax's default dtype, and with TF32 off.

    state = create_specseg_state(cfg, torch.Generator().manual_seed(0), "cuda")
    step = make_specseg_train_step(cfg)
    keep = state.net.sample_keep(gen, b, h, w)
    state, metrics = step(state, images, masks, keep)   # dice, focal, loss, iou
    variables = specseg_vars_from_state(state)          # {"params", "batch_stats"}
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from shmgan_tpu_torch.config import Config, torch_device
from shmgan_tpu_torch.convert import flax_tree
from shmgan_tpu_torch.infer import ieee_f32
from shmgan_tpu_torch.models.specseg import SpecSeg
from shmgan_tpu_torch.train.losses import binary_focal_loss, dice_loss
from shmgan_tpu_torch.train.state import ClipAdamDecay, make_optimizer


@dataclasses.dataclass
class SpecSegTrainState:
    """The net (parameters and running statistics, updated in place), its
    optimizer and the step counter."""
    net: SpecSeg
    opt: ClipAdamDecay
    step: int = 0


def create_specseg_state(cfg: Config, generator: Optional[torch.Generator] = None,
                         device="cuda") -> SpecSegTrainState:
    """A float32 SpecSeg of cfg.model's width and input channels, with the
    JAX init's scales drawn from `generator` (a CPU generator; None leaves
    the weights as built, to be filled), on `device`, and a fresh optimizer
    at cfg.train.g_lr."""
    m = cfg.model
    net = SpecSeg(base_filters=m.specseg_base_filters, in_channels=m.specseg_in_channels,
                  dtype=torch.float32)
    if generator is not None:
        net.init_(generator)
    net = net.to(torch_device(device))
    return SpecSegTrainState(net=net, opt=make_optimizer(dict(net.named_parameters()),
                                                         cfg.train.g_lr, cfg))


def iou(pred: torch.Tensor, target: torch.Tensor, thresh: float = 0.5,
        empty: Optional[float] = 1.0) -> torch.Tensor:
    """IoU of the masks at `thresh`; `empty` when the union is empty (None:
    inter / max(union, 1e-7), as the flagship trainer's probe takes it)."""
    p = (pred > thresh).float()
    t = (target > thresh).float()
    inter = (p * t).sum()
    union = torch.maximum(p, t).sum()
    ratio = inter / torch.clamp(union, min=1e-7)
    if empty is None:
        return ratio
    return torch.where(union > 0, ratio, torch.full_like(ratio, empty))


def make_specseg_train_step(cfg: Config) -> Callable:
    """step(state, images, masks, keep) -> (state, {"dice", "focal", "loss",
    "iou"}): images (B, H, W, in_channels), masks (B, H, W, 1) binary, keep
    the net's 9 dropout keep masks. One backward of dice + focal through
    the train-mode net, the optimizer step, the new running statistics.
    The metrics are 0-d tensors on the state's device (no sync)."""
    del cfg

    def step(state: SpecSegTrainState, images: torch.Tensor, masks: torch.Tensor,
             keep: List[torch.Tensor]) -> Tuple[SpecSegTrainState, Dict[str, torch.Tensor]]:
        net = state.net
        names = state.opt.names
        params = dict(net.named_parameters())
        with ieee_f32(), torch.enable_grad():
            pred, stats = net(images.float(), train=True, keep=keep)
            d = dice_loss(pred, masks)
            f = binary_focal_loss(pred, masks)
            loss = d + f
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        state.opt.step(dict(zip(names, grads)))
        net.load_batch_stats(stats)
        state.step += 1
        return state, {"dice": d.detach(), "focal": f.detach(), "loss": loss.detach(),
                       "iou": iou(pred.detach(), masks)}

    return step


def specseg_vars_from_state(state: SpecSegTrainState) -> Dict:
    """The net as the frozen variable tree {"params", "batch_stats"} the GAN
    and the serving surfaces take (numpy, host copies)."""
    params, batch_stats = flax_tree(state.net)
    return {"params": params, "batch_stats": batch_stats}


def train_specseg(cfg: Config, images: np.ndarray, masks: np.ndarray, num_steps: int = 100,
                  batch_size: Optional[int] = None, verbose: bool = False,
                  device="cuda") -> SpecSegTrainState:
    """A small in-memory trainer: images and masks (N, H, W, C) arrays;
    each step takes `batch_size` pairs drawn with replacement. Init,
    sampling and dropout come from generators seeded with cfg.train.seed."""
    device = torch_device(device)
    batch_size = batch_size or cfg.train.batch_size
    init = torch.Generator().manual_seed(cfg.train.seed)
    state = create_specseg_state(cfg, init, device)
    step = make_specseg_train_step(cfg)
    drop = torch.Generator(device=device).manual_seed(cfg.train.seed)
    images_t = torch.as_tensor(np.asarray(images, np.float32), device=device)
    masks_t = torch.as_tensor(np.asarray(masks, np.float32), device=device)
    _, h, w, _ = images_t.shape
    for i in range(num_steps):
        idx = torch.randint(0, images_t.shape[0], (batch_size,), generator=init).to(device)
        keep = state.net.sample_keep(drop, batch_size, h, w)
        state, metrics = step(state, images_t[idx], masks_t[idx], keep)
        if verbose and (i + 1) % 20 == 0:
            print(f"[specseg {i + 1}/{num_steps}] loss={float(metrics['loss']):.4f} "
                  f"iou={float(metrics['iou']):.3f}", flush=True)
    return state
