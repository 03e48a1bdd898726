"""Train state: G, D, the frozen SpecSeg, the step counter, the two
optimizers and the optional EMA of G's parameters (the counterpart of
shmgan_tpu/train/state.py).

The port updates the modules' parameters, the optimizer moments and the EMA
in place, where the JAX package returns a new tree; `copy.deepcopy` of a
state copies all of them together.

`state_payload` lays a state out as the tree the JAX package checkpoints
(`flax.serialization.to_state_dict` of its Orbax payload), and
`load_state_payload` fills a state from such a tree (checkpoint.py writes and
reads it). `broadcast_state` makes every rank of a process group hold rank
0's state (parallel/mesh.py).

Tensor parallelism: `shard_state` cuts a whole state to this rank's slices
over the model axis (parallel/tp.py), its Adam moments and EMA with them;
clip and Adam are elementwise, so each rank updates its slices alone. A cut
state's `state_payload` gathers every slice whole (each rank of a model
row joins), so checkpoints hold the JAX package's tree whatever the mesh,
and a restore fills a whole state, which `shard_state` then cuts, as the
JAX loop restores and then places its state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.convert import flax_tree, from_flax, load_flax, to_flax
from shmgan_tpu_torch.models import SHMDiscriminator, SHMGenerator, SpecSeg
from shmgan_tpu_torch.parallel import tp
from shmgan_tpu_torch.parallel.mesh import RankLayout, broadcast_


def lr_schedule(initial_lr: float, decay_steps: int = 10000,
                decay_rate: float = 0.95) -> Callable[[int], float]:
    """optax.exponential_decay(staircase=False): count -> the learning rate
    initial_lr * decay_rate^(count / decay_steps)."""
    return lambda count: initial_lr * decay_rate ** (count / decay_steps)


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
        self.schedule = lr_schedule(lr, t.lr_decay_steps, t.lr_decay_rate)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def moments(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        return dict(zip(self.names, self.mu)), dict(zip(self.names, self.nu))

    def rebind(self, params: Dict[str, nn.Parameter], mu: Dict[str, torch.Tensor],
               nu: Dict[str, torch.Tensor]) -> None:
        """Update `params` (the same names) from now on, with these moments."""
        self.params = [params[k] for k in self.names]
        self.mu, self.nu = [mu[k] for k in self.names], [nu[k] for k in self.names]

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
        lr = self.schedule(self.count)
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
    # this rank's place in the mesh (`shard_state`); None: the whole state,
    # averaged over every rank of a process group
    layout: Optional[RankLayout] = None


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


def param_count(tree: Mapping) -> int:
    """Number of elements in a tree of arrays (a flax-layout tree)."""
    return sum(param_count(v) if isinstance(v, Mapping) else int(np.size(v))
               for v in tree.values())


def _opt_payload(module: nn.Module, template: Mapping, opt: ClipAdamDecay) -> Dict:
    """optax's chain state (clip, scale_by_adam, scale_by_learning_rate) as
    flax's state dict: {"0": {}, "1": {"count", "mu", "nu"}, "2": {"count"}},
    both counts the optimizer's, the moments whole."""
    mu, nu = (tp.gather_named(module, m) for m in opt.moments())
    count = np.asarray(opt.count, np.int32)
    return {"0": {}, "1": {"count": count, "mu": to_flax(module, template, mu),
                           "nu": to_flax(module, template, nu)},
            "2": {"count": count.copy()}}


def state_payload(state: TrainState) -> Dict[str, Any]:
    """The state as the JAX package's checkpoint tree, numpy on the host:
    step, g_params, d_params, specseg_vars {params, batch_stats},
    g_opt_state, d_opt_state, and ema_g_params when the EMA is on. A state
    cut over the model axis is gathered whole: every rank of its model row
    calls this."""
    g_params, d_params = (
        to_flax(m, flax_tree(m)[0], tp.gather_named(m, dict(m.named_parameters())))
        for m in (state.gen, state.disc))
    ss_params, ss_stats = flax_tree(state.specseg)
    payload = {"step": np.asarray(state.step, np.int32), "g_params": g_params,
               "d_params": d_params,
               "specseg_vars": {"params": ss_params, "batch_stats": ss_stats},
               "g_opt_state": _opt_payload(state.gen, g_params, state.g_opt),
               "d_opt_state": _opt_payload(state.disc, d_params, state.d_opt)}
    if state.ema_g is not None:
        payload["ema_g_params"] = to_flax(state.gen, g_params,
                                          tp.gather_named(state.gen, state.ema_g))
    return payload


def is_model_sharded(state: TrainState) -> bool:
    """Whether `state` is cut over a model axis of more than one rank."""
    return state.layout is not None and state.layout.model_parallel > 1


def shard_state(state: TrainState, layout: RankLayout, image_size: int,
                min_channels: int) -> TrainState:
    """Cut a whole state, in place, to this rank's slices over the model axis
    (`tp.shard_model_` of G and D at `image_size`, the JAX rule's
    `min_channels`), each optimizer's moments and the EMA as their
    parameters, and keep `layout`. The whole state must be alike on every
    rank (built from one seed, or broadcast)."""
    for module, opt in ((state.gen, state.g_opt), (state.disc, state.d_opt)):
        tp.shard_model_(module, layout, image_size, min_channels)
        mu, nu = (tp.slice_named(module, m, layout) for m in opt.moments())
        opt.rebind(dict(module.named_parameters()), mu, nu)
    if state.ema_g is not None:
        state.ema_g = tp.slice_named(state.gen, state.ema_g, layout)
    state.layout = layout
    return state


def _named_tensors(module: nn.Module, tree: Mapping, names: List[str],
                   like: torch.Tensor) -> Dict[str, torch.Tensor]:
    arrays = from_flax(module, tree)
    if set(arrays) != set(names):
        raise KeyError(f"{type(module).__name__}: the tree's leaves "
                       f"{sorted(set(arrays) ^ set(names))} do not match")
    return {k: torch.from_numpy(arrays[k]).to(like.device) for k in names}


def _load_opt(module: nn.Module, payload: Mapping, opt: ClipAdamDecay) -> None:
    adam = payload["1"]
    counts = (int(adam["count"]), int(payload["2"]["count"]))
    if counts[0] != counts[1]:
        raise ValueError(f"optimizer counts differ: adam {counts[0]}, schedule {counts[1]}")
    like = opt.params[0]
    for moments, tree in ((opt.mu, adam["mu"]), (opt.nu, adam["nu"])):
        named = _named_tensors(module, tree, opt.names, like)
        with torch.no_grad():
            for dst, name in zip(moments, opt.names):
                dst.copy_(named[name])
    opt.count = counts[0]


def load_state_payload(state: TrainState, payload: Mapping, with_ema: bool) -> TrainState:
    """Fill `state` in place from a `state_payload` tree. with_ema: the
    state keeps an EMA afterwards, the payload's or, where it has none, a
    copy of the restored G; without it the state has none."""
    load_flax(state.gen, payload["g_params"])
    load_flax(state.disc, payload["d_params"])
    ss = payload["specseg_vars"]
    load_flax(state.specseg, ss["params"], ss.get("batch_stats"))
    _load_opt(state.gen, payload["g_opt_state"], state.g_opt)
    _load_opt(state.disc, payload["d_opt_state"], state.d_opt)
    state.step = int(payload["step"])
    state.ema_g = None
    if with_ema:
        g_named = dict(state.gen.named_parameters())
        if "ema_g_params" in payload:
            state.ema_g = _named_tensors(state.gen, payload["ema_g_params"], list(g_named),
                                         next(iter(g_named.values())))
        else:
            state.ema_g = {k: p.detach().clone() for k, p in g_named.items()}
    return state


def broadcast_state(state: TrainState) -> TrainState:
    """Overwrite, in place, every rank's parameters (G, D, SpecSeg's and its
    batch statistics), Adam moments, EMA, step and optimizer counts with
    rank 0's: after a restore or a warm start, so that the replicas start
    alike whatever each rank read. In a state cut over the model axis each
    slice comes from the rank of data index 0 that holds the same slice,
    over the data column, and the rest from rank 0. A no-op without a
    process group."""
    whole = [*state.specseg.parameters(), *state.specseg.buffers()]
    cut = []
    for module, opt, ema in ((state.gen, state.g_opt, state.ema_g),
                             (state.disc, state.d_opt, None)):
        dims = tp.sharded_params(module)
        mu, nu = opt.moments()
        for name, p in module.named_parameters():
            group = cut if name in dims else whole
            group += [p, mu[name], nu[name]] + ([ema[name]] if ema is not None else [])
    counts = torch.tensor([state.step, state.g_opt.count, state.d_opt.count],
                          dtype=torch.int64, device=state.g_opt.params[0].device)
    with torch.no_grad():
        broadcast_(whole + [counts])
        if cut:
            layout = state.layout
            broadcast_(cut, src=int(layout.mesh.devices[0, layout.model_index]),
                       group=layout.data_group)
    state.step, state.g_opt.count, state.d_opt.count = (int(c) for c in counts.tolist())
    return state
