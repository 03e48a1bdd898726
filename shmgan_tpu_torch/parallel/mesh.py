"""The (data, model) mesh of a training run over torch.distributed: the
counterpart of shmgan_tpu/parallel/mesh.py.

Training runs one process a card, as `torchrun` launches it:

    torchrun --nproc_per_node N -m shmgan_tpu_torch.cli --mode train \\
        --data_parallel D --model_parallel M --batch_size B ...

with D * M = N (D = -1 means N // M). Rank i * M + j sits at data index i
and model index j, as the JAX package's `reshape(dp, mp)` lays devices out.
Each rank reads RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT
from its environment (`maybe_initialize_distributed`) and runs on
`cuda:LOCAL_RANK`. `rank_layout` places it and joins the process groups of
its model row (the M ranks of its data index) and of its data column (the
D ranks of its model index).

The data axis: the M ranks of data index i feed block i of every global
batch, and every gradient is averaged over the data axis after the
backward (`all_reduce_mean_`), so every rank takes the same optimizer step:
the update GSPMD makes in the JAX package from a replicated state and a
batch-sharded input. Instance norm normalises each (sample, channel) plane,
so the kernels run unchanged on every rank.

The model axis (tensor parallelism, parallel/tp.py): `param_spec` is the
JAX package's rule for which kernels split their output channels over the
M ranks of a row (`_param_spec`, `_output_extent`); everything else stays
whole on every rank. With `mesh.spatial_sharding` the model axis holds rows
of the activations instead (parallel/spatial.py): every parameter is whole,
each rank of a row holds its band of every feature map's rows, and the
gradients are summed over the row before the data axis averages them. At
model_parallel 1 it is the plain layout, as in the JAX package.

Only `all_reduce`, `all_gather` and `broadcast` run on the tensors, so the
path runs over NCCL, or over gloo with CUDA or CPU tensors. Flags the host
decides (a signal, a deadline) are agreed over a gloo group on CPU tensors
(`agree_any`), which waits on no device.

Serving is one process over a list of devices: infer.make_infer_fn's
`data_parallel`; it ignores the model axis, as the JAX package's serving
does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# conv kernels with at least this many output channels split over the model
# axis (MeshConfig.tp_min_channels, the JAX package's _MIN_SHARDED_CHANNELS)
MIN_SHARDED_CHANNELS = 256
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# the gloo group over which host flags are agreed: the default group when it
# is gloo, else one made beside it
_host_group = None


def launched() -> bool:
    """Whether a launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) is present."""
    return all(k in os.environ for k in _LAUNCH_ENV)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def maybe_initialize_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group the launcher's environment describes, once;
    a no-op without one. backend: "nccl" or "gloo" (default: "nccl" when a
    card is present, else "gloo"). With a card, `cuda:LOCAL_RANK` becomes
    the current device first, before any kernel loads. Returns whether a
    process group is up."""
    global _host_group
    if dist.is_initialized():
        return True
    if not launched():
        return False
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend=backend, init_method="env://")
    _host_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    return True


def shutdown_distributed() -> None:
    """Leave the process group, when one is up."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Whether this process is rank 0, which writes checkpoints, exports,
    logs and evals."""
    return rank() == 0


def local_device(device) -> torch.device:
    """The device of this rank: `cuda` without an index is `cuda:LOCAL_RANK`
    under a process group; anything else stays as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", local_rank())
    return device


def launch_line(dp: int, mp: int = 1) -> str:
    """The command that launches a dp x mp training run."""
    flags = f"--data_parallel {dp}" + (f" --model_parallel {mp}" if mp > 1 else "")
    return f"torchrun --nproc_per_node {dp * mp} -m shmgan_tpu_torch.cli {flags} ..."


@dataclass(frozen=True)
class Mesh:
    """A (data, model) layout of ranks; devices[i, j] is the rank at data
    index i and model index j, as in the JAX package's mesh. spatial: the
    model axis holds rows of the activations (more than one model rank)."""
    data_parallel: int
    model_parallel: int
    spatial: bool = False

    @property
    def shape(self) -> Tuple[int, int]:
        return self.data_parallel, self.model_parallel

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.data_parallel * self.model_parallel).reshape(self.shape)


def make_mesh(cfg, n: int) -> Mesh:
    """The layout of cfg.mesh over n devices, by the JAX package's rules:
    data_parallel -1 takes every device the model axis leaves, and a layout
    larger than n raises. Spatial sharding over a model axis of one rank is
    the plain layout."""
    mp = max(1, cfg.mesh.model_parallel)
    dp = cfg.mesh.data_parallel
    if dp == -1:
        dp = n // mp
    if dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs more than the {n} devices present")
    return Mesh(dp, mp, spatial=bool(cfg.mesh.spatial_sharding) and mp > 1)


def training_mesh(cfg) -> Mesh:
    """The layout of a training run, one rank a device: data_parallel x
    model_parallel must be WORLD_SIZE (data_parallel -1 means WORLD_SIZE //
    model_parallel). A layout of more than one rank needs a process group
    (`maybe_initialize_distributed`): without one it raises and says how to
    launch, rather than run on one device."""
    dp, mp = cfg.mesh.data_parallel, max(1, cfg.mesh.model_parallel)
    if (dp > 1 or mp > 1) and not dist.is_initialized():
        raise RuntimeError(
            f"data_parallel={dp} x model_parallel={mp} runs one process a device, joined "
            f"in a process group; none is up. Launch with "
            f"`{launch_line(max(dp, 1), mp)}` (the port does not run them on one device)")
    n = world_size()
    if dp == -1:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"data_parallel={cfg.mesh.data_parallel} x model_parallel={mp} but "
                         f"{n} processes were launched: each rank holds one device of the "
                         f"mesh, so data_parallel must be WORLD_SIZE / model_parallel or -1")
    return make_mesh(cfg, n)


@dataclass(frozen=True)
class RankLayout:
    """This rank's place in a training mesh: devices[data_index,
    model_index], and the process groups of its data column (the ranks of
    its model index, over which gradients are averaged) and of its model
    row (the ranks of its data index, over which a kernel's channels are
    split). Groups are None without a process group. A copy of a layout
    is the layout: groups are handles of the process."""
    mesh: Mesh
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def model_parallel(self) -> int:
        return self.mesh.model_parallel

    @property
    def data_parallel(self) -> int:
        return self.mesh.data_parallel

    @property
    def spatial(self) -> bool:
        """Whether the model row holds bands of rows (parallel/spatial.py)
        rather than slices of channels."""
        return self.mesh.spatial

    def __deepcopy__(self, memo) -> "RankLayout":
        return self


def rank_layout(mesh: Mesh) -> RankLayout:
    """This rank's RankLayout in `mesh`; under a process group every rank
    calls it, since each joins every row's and column's group as it is
    made."""
    if not dist.is_initialized():
        return RankLayout(mesh)
    if mesh.model_parallel == 1:  # data parallelism alone: the data column is everyone
        return RankLayout(mesh, rank())
    i, j = divmod(rank(), mesh.model_parallel)
    rows = [dist.new_group([int(r) for r in row]) for row in mesh.devices]
    cols = [dist.new_group([int(r) for r in col]) for col in mesh.devices.T]
    return RankLayout(mesh, i, j, data_group=cols[j], model_group=rows[i])


def _output_extent(path: str, image_size: int) -> Optional[int]:
    """The spatial extent of the feature map the kernel at flax path `path`
    ("block2/conv/kernel") writes: D's block{i} halves the image i + 1
    times, and G's bottleneck sits after 4 pools; None elsewhere. The JAX
    package's rule, regular expressions and all: `down(\\d+)/` never matches
    G's "down2_0/..." paths, so G's down levels have no extent."""
    m = re.search(r"block(\d+)/", path)
    if m:
        return image_size // (2 ** (int(m.group(1)) + 1))
    m = re.search(r"down(\d+)/", path)
    if m:
        return image_size // (2 ** (int(m.group(1)) + 1))
    if "bottleneck" in path:
        return image_size // 16
    return None


def param_spec(path: str, shape: Sequence[int], model_parallel: int, image_size: int = 0,
               min_channels: int = MIN_SHARDED_CHANNELS) -> Tuple[Optional[str], ...]:
    """How the leaf at flax path `path` of flax shape `shape` lies over the
    model axis, as a PartitionSpec's tuple: ("model" on the output channels
    of a conv kernel (kh, kw, in, out) with out >= min_channels and
    divisible by model_parallel, unless its feature map is under 2 wide;
    on the rows of a Dense kernel (in, out) with in >= 1024 and divisible;
    () (whole on every rank) otherwise and whenever model_parallel is 1.
    The JAX package's `_param_spec`."""
    if model_parallel <= 1:
        return ()
    shape = tuple(shape)
    if len(shape) == 4 and shape[-1] >= min_channels and shape[-1] % model_parallel == 0:
        if image_size:
            extent = _output_extent(path, image_size)
            if extent is not None and extent < 2:
                return ()
        return (None, None, None, "model")
    if len(shape) == 2 and shape[0] % model_parallel == 0 and shape[0] >= 1024:
        return ("model", None)
    return ()


def param_specs(tree: Mapping, model_parallel: int, image_size: int = 0,
                min_channels: int = MIN_SHARDED_CHANNELS, prefix: str = "") -> Dict:
    """`param_spec` of every leaf of a flax tree (leaves: arrays, or shape
    tuples as `convert.flax_shapes` gives them), as a tree of the same
    keys: the JAX package's `param_shardings(...)` specs."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out[key] = param_specs(val, model_parallel, image_size, min_channels, path)
        else:
            out[key] = param_spec(path, getattr(val, "shape", val), model_parallel,
                                  image_size, min_channels)
    return out


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    by_kind: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    return list(by_kind.values())


def _collective_(tensors: Sequence[torch.Tensor], op) -> None:
    """op(flat) on each dtype's tensors flattened into one buffer, then the
    buffer copied back into them."""
    for group in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average each tensor across the ranks of `group` (default: every
    rank), in place: one all_reduce (a sum, then / the group's size on every
    rank) per dtype. A no-op without a process group or in a one-rank
    group. Every rank of the group ends with the same bits."""
    if not tensors or _group_size(group) == 1:
        return
    n = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _collective_(tensors, mean)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None, divisor: int = 1) -> None:
    """Sum each tensor across the ranks of `group` (default: every rank),
    then divide by `divisor` (unless 1), in place: one all_reduce per dtype.
    A no-op without a process group or in a one-rank group."""
    if not tensors or _group_size(group) == 1:
        return

    def total(flat):
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat.div_(divisor)

    _collective_(tensors, total)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite each tensor with rank `src`'s (a global rank in `group`,
    default every rank), in place: one broadcast per dtype. A no-op without
    a process group."""
    if not dist.is_initialized() or not tensors:
        return
    _collective_(tensors, lambda flat: dist.broadcast(flat, src, group=group))


def agree_any(flag: bool) -> bool:
    """Whether any rank's flag is set, agreed over the gloo group on a CPU
    tensor (no device wait). Without a process group: the flag."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group)
    return bool(t.item())


def barrier() -> None:
    """Wait for every rank (over the gloo group); a no-op without a group."""
    if dist.is_initialized():
        dist.barrier(group=_host_group)
