"""Tensor parallelism over the model axis: the counterpart of the JAX
package's output-channel sharding of the wide conv kernels
(shmgan_tpu/parallel/mesh.py `param_shardings`), written as Megatron's
collectives around the port's blocks.

`shard_model_(model, layout, image_size, min_channels)` cuts, in place, every
block whose kernel the JAX rule (`mesh.param_spec`) splits to model rank j's
slice of its output channels: the conv's weight and bias, and instance
norm's gamma and beta behind it (the JAX package keeps those whole on every
device; the port keeps the slice that its conv's slice feeds, and gathers
them whole into checkpoints, `gather_named`). Such a block then runs

    x  -> enter: identity; backward, all_reduce(sum) of dx over the model row
       -> the conv on its slice of the output channels
       -> leaky_relu and InstanceNorm on that slice: the IN kernels launch on
          (B, C / M, H, W)
       -> leave: all_gather of the channels; backward, this rank's slice of g

so every activation between blocks is whole and alike on the M ranks of a
row. D's class head, whose Dense kernel the JAX rule splits by input rows,
is row-parallel: its slice of the flattened features (`_SplitLast`, whose
backward gathers the input gradient) times its rows, then an all_reduce(sum)
of the partial logits. The sums run in float32 whatever the compute dtype
and are returned in it; all_gather moves activations in their own dtype
(bfloat16 too: the gather does no arithmetic).

torch.distributed.tensor was not used: its convolution rule
(`torch/distributed/tensor/_ops/_conv_ops.py`, `convolution_rules`) gives the
output the input's placements and reads no sharding of the weight, so a
conv whose weight is split on its output channels has no placement there,
and the instance-norm kernels are custom autograd functions it has no rule
for.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.autograd import Function

from shmgan_tpu_torch.convert import flax_shapes, kernel_axes
from shmgan_tpu_torch.parallel.mesh import MIN_SHARDED_CHANNELS, RankLayout, param_specs


def _all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of t, taken in float32, in t's dtype."""
    out = t.float().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' t, in rank order, joined along `dim`."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _own_slice(t: torch.Tensor, dim: int, layout: RankLayout) -> torch.Tensor:
    n = t.shape[dim] // layout.model_parallel
    return t.narrow(dim, layout.model_index * n, n).contiguous()


class _Enter(Function):
    """Identity; backward, the sum of the row's partial input gradients."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.group = layout.model_group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _Leave(Function):
    """All_gather of the channels (dim 1); backward, this rank's slice."""

    @staticmethod
    def forward(ctx, y, layout):
        ctx.layout = layout
        return _all_gather(y, 1, layout.model_group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, 1, ctx.layout), None


class _SplitLast(Function):
    """This rank's block of the last dim; backward, the blocks gathered."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.group = layout.model_group
        return _own_slice(x, x.dim() - 1, layout)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, g.dim() - 1, ctx.group), None


class _ReduceSum(Function):
    """The sum of the row's partial results; backward, identity."""

    @staticmethod
    def forward(ctx, y, layout):
        return _all_reduce_f32(y, layout.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(layout: Optional[RankLayout], x: torch.Tensor) -> torch.Tensor:
    """Before a block split over the model axis (layout None: not split)."""
    return x if layout is None else _Enter.apply(x, layout)


def leave(layout: Optional[RankLayout], y: torch.Tensor) -> torch.Tensor:
    """After a split block's per-channel tail: its channels made whole."""
    return y if layout is None else _Leave.apply(y, layout)


def split_last(layout: Optional[RankLayout], x: torch.Tensor) -> torch.Tensor:
    """Before a row-parallel product: this rank's block of x's last dim."""
    return x if layout is None else _SplitLast.apply(x, layout)


def reduce_sum(layout: Optional[RankLayout], y: torch.Tensor) -> torch.Tensor:
    """After a row-parallel product: the partial results summed (in float32,
    returned in y's dtype)."""
    return y if layout is None else _ReduceSum.apply(y, layout)


def shard_model_(model: nn.Module, layout: RankLayout, image_size: int,
                 min_channels: int = MIN_SHARDED_CHANNELS) -> Dict[str, int]:
    """Cut `model` (whole, as built) in place to model rank
    layout.model_index's slices: every block with a `TP_DIMS` ({parameter:
    torch dim of its output channels or input rows}) whose kernels the JAX
    rule splits at `image_size` gets its parameters replaced by their
    slices and `tp = layout`. Returns {parameter name: dim} of the cut
    parameters. A no-op at model_parallel 1, and on a spatial layout, whose
    model axis holds rows of the activations and every parameter whole (the
    JAX rule's `model_parallel = ... and not spatial`)."""
    m = layout.model_parallel
    cut: Dict[str, int] = {}
    if m == 1 or layout.spatial:
        return cut
    specs = param_specs(flax_shapes(model), m, image_size, min_channels)
    for prefix, block in model.named_modules():
        dims = getattr(type(block), "TP_DIMS", None)
        if not dims:
            continue
        split = {}
        for name, dim in dims.items():
            owner_path, _, leaf = name.rpartition(".")
            if leaf != "weight":
                continue
            node = specs  # the spec of the flax kernel at <prefix>/<owner_path>/kernel
            for key in f"{prefix}.{owner_path}".strip(".").split(".") + ["kernel"]:
                node = node[key]
            axis = node.index("model") if "model" in node else None
            want = None if axis is None else kernel_axes(block.get_submodule(owner_path))[dim]
            if axis is not None and axis != want:
                raise ValueError(f"{prefix}.{name}: the JAX rule splits flax axis {axis}, "
                                 f"the block splits torch dim {dim} (flax axis {want})")
            split[name] = axis is not None
        if not any(split.values()):
            continue
        if not all(split.values()):
            raise ValueError(f"{prefix or type(model).__name__}: the JAX rule splits only "
                             f"{sorted(k for k, v in split.items() if v)} of its kernels")
        with torch.no_grad():
            for name, dim in dims.items():
                owner_path, _, leaf = name.rpartition(".")
                owner = block.get_submodule(owner_path)
                p = getattr(owner, leaf)
                if p.shape[dim] % m:
                    raise ValueError(f"{prefix}.{name}: {p.shape[dim]} not divisible by {m}")
                setattr(owner, leaf, nn.Parameter(_own_slice(p.detach(), dim, layout).clone(),
                                                  requires_grad=p.requires_grad))
                cut[f"{prefix}.{name}".strip(".")] = dim
        block.tp = layout
    return cut


def sharded_params(model: nn.Module) -> Dict[str, int]:
    """{parameter name: dim} of the parameters `shard_model_` cut."""
    out = {}
    for prefix, block in model.named_modules():
        if getattr(block, "tp", None) is not None:
            for name, dim in type(block).TP_DIMS.items():
                out[f"{prefix}.{name}".strip(".")] = dim
    return out


def model_layout(model: nn.Module) -> Optional[RankLayout]:
    """The layout `model` was cut for, or None if it is whole."""
    for block in model.modules():
        if getattr(block, "tp", None) is not None:
            return block.tp
    return None


def slice_named(model: nn.Module, named: Mapping[str, torch.Tensor],
                layout: RankLayout) -> Dict[str, torch.Tensor]:
    """Whole tensors by parameter name (moments, an EMA) cut as
    `shard_model_` cut `model`'s parameters."""
    dims = sharded_params(model)
    return {k: _own_slice(v, dims[k], layout).clone() if k in dims else v
            for k, v in named.items()}


def gather_named(model: nn.Module, named: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Tensors by parameter name of a cut `model` (its parameters, their
    gradients or moments) made whole: one all_gather over the model row per
    cut tensor, in name order; every rank of the row calls it. The rest is
    returned as it is."""
    layout = model_layout(model)
    if layout is None:
        return dict(named)
    dims = sharded_params(model)
    return {k: _all_gather(v.detach(), dims[k], layout.model_group) if k in dims else v
            for k, v in named.items()}


def shard_counts(model: nn.Module) -> Dict[str, int]:
    """{"cut": n, "whole": n}: the parameter elements of `model` on this
    rank that are its slices and that are whole."""
    dims = sharded_params(model)
    counts = {"cut": 0, "whole": 0}
    for name, p in model.named_parameters():
        counts["cut" if name in dims else "whole"] += p.numel()
    return counts
