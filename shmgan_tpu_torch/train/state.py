"""Train state: G, D, the frozen SpecSeg, the step counter, the two
optimizers and the optional EMA of G's parameters (the counterpart of
shmgan_tpu/train/state.py).

The port updates the modules' parameters, the optimizer moments and the EMA
in place, where the JAX package returns a new tree; `copy.deepcopy` of a
state copies all of them together.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.models import SHMDiscriminator, SHMGenerator, SpecSeg


class ClipAdamDecay:
    """optax.chain(clip(grad_clip), scale_by_adam(b1, b2, eps),
    scale_by_learning_rate(exponential_decay)) over named parameters, in place:

      g = clip(g, -grad_clip, grad_clip)
      mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
      u = (mu / (1 - b1^(count+1))) / (sqrt(nu / (1 - b2^(count+1))) + eps)
      p -= lr * rate^(count / decay_steps) * u;  count += 1

    with eps outside the square root and the decay continuous, its count
    taken before the increment, as optax has them."""

    def __init__(self, params: Dict[str, nn.Parameter], lr: float, cfg: Config):
        t = cfg.train
        self.names: List[str] = list(params)
        self.params = [params[k] for k in self.names]
        self.lr, self.clip = lr, t.grad_clip
        self.b1, self.b2, self.eps = t.beta1, t.beta2, t.adam_eps
        self.decay_steps, self.decay_rate = t.lr_decay_steps, t.lr_decay_rate
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def moments(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        return dict(zip(self.names, self.mu)), dict(zip(self.names, self.nu))

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        g = torch._foreach_clamp_min([grads[k] for k in self.names], -self.clip)
        torch._foreach_clamp_max_(g, self.clip)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                        1.0 - self.b2))
        n = self.count + 1
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - self.b2 ** n))
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(torch._foreach_div(self.mu, 1.0 - self.b1 ** n), denom)
        lr = self.lr * self.decay_rate ** (self.count / self.decay_steps)
        torch._foreach_add_(self.params, torch._foreach_mul(u, -lr))
        self.count = n


def make_optimizer(params: Dict[str, nn.Parameter], lr: float, cfg: Config) -> ClipAdamDecay:
    """clip(+-grad_clip) -> Adam -> the shared exponential decay."""
    return ClipAdamDecay(params, lr, cfg)


@dataclasses.dataclass
class TrainState:
    gen: SHMGenerator
    disc: SHMDiscriminator
    specseg: SpecSeg                 # frozen
    g_opt: ClipAdamDecay
    d_opt: ClipAdamDecay
    step: int = 0                    # global step counter
    # EMA of G's parameters by name (cfg.train.g_ema > 0), else None
    ema_g: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(cfg: Config, models: Tuple[SHMGenerator, SHMDiscriminator, SpecSeg]
                       ) -> TrainState:
    """The state around (G, D, SpecSeg) from `models.build_models` (seeded,
    or filled by convert.py): fresh optimizers, SpecSeg frozen, and the EMA a
    real copy of G's parameters when enabled."""
    gen, disc, specseg = models
    specseg.requires_grad_(False)
    g_params = dict(gen.named_parameters())
    ema = ({k: p.detach().clone() for k, p in g_params.items()}
           if cfg.train.g_ema > 0.0 else None)
    return TrainState(gen=gen, disc=disc, specseg=specseg,
                      g_opt=make_optimizer(g_params, cfg.train.g_lr, cfg),
                      d_opt=make_optimizer(dict(disc.named_parameters()), cfg.train.d_lr, cfg),
                      ema_g=ema)
