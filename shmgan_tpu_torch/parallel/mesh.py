"""Data parallelism over torch.distributed: the counterpart of the data axis
of shmgan_tpu/parallel/mesh.py.

Training runs one process a card, as `torchrun` launches it:

    torchrun --nproc_per_node N -m shmgan_tpu_torch.cli --mode train \\
        --data_parallel N --batch_size B ...

Each rank reads RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT
from its environment (`maybe_initialize_distributed`), holds a full replica
of the state on `cuda:LOCAL_RANK`, feeds its contiguous block of every
global batch, and averages every gradient across the ranks after the
backward (`all_reduce_mean_`), so all ranks take the same optimizer step.
That is the update GSPMD makes in the JAX package from a replicated state
and a batch-sharded input. Instance norm normalises each (sample, channel)
plane, so the kernels run unchanged on every rank.

Only `all_reduce` and `broadcast` run on the tensors, so the path runs
over NCCL, or over gloo with CUDA or CPU tensors. Flags the host decides
(a signal, a deadline) are agreed over a gloo group on CPU tensors
(`agree_any`), which waits on no device.

Serving is one process over a list of devices: infer.make_infer_fn's
`data_parallel`. Tensor parallelism over the model axis and spatial
sharding are not ported (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

LAUNCH = "torchrun --nproc_per_node {n} -m shmgan_tpu_torch.cli --data_parallel {n} ..."
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


@dataclass(frozen=True)
class Mesh:
    """A (data, model) layout of ranks; devices[i, j] is the rank at data
    index i and model index j, as in the JAX package's mesh."""
    data_parallel: int
    model_parallel: int

    @property
    def shape(self) -> Tuple[int, int]:
        return self.data_parallel, self.model_parallel

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.data_parallel * self.model_parallel).reshape(self.shape)


def make_mesh(cfg, n: int) -> Mesh:
    """The layout of cfg.mesh over n devices, by the JAX package's rules:
    data_parallel -1 takes every device the model axis leaves, and a layout
    larger than n raises. A model axis above 1 raises as unported."""
    mp = max(1, cfg.mesh.model_parallel)
    dp = cfg.mesh.data_parallel
    if dp == -1:
        dp = n // mp
    if dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs more than the {n} devices present")
    cfg.mesh.check_ported()
    return Mesh(dp, mp)


def training_mesh(cfg) -> Mesh:
    """The layout of a training run, one rank a replica: a model axis raises
    as unported; data_parallel must be WORLD_SIZE (or -1, which means it).
    Above 1 it needs a process group
    (`maybe_initialize_distributed`): without one it raises and says how to
    launch, rather than run on one device."""
    cfg.mesh.check_ported()
    dp = cfg.mesh.data_parallel
    if dp > 1 and not dist.is_initialized():
        raise RuntimeError(
            f"data_parallel={dp} runs one process a card, joined in a process group; "
            f"none is up. Launch with `{LAUNCH.format(n=dp)}` (the port does not run "
            f"data parallelism on one device)")
    n = world_size()
    if dp not in (-1, n):
        raise ValueError(f"data_parallel={dp} but {n} processes were launched: each rank "
                         f"holds one replica, so data_parallel must be WORLD_SIZE or -1")
    return make_mesh(cfg, n)


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


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average each tensor across the ranks, in place: one all_reduce (a sum,
    then / WORLD_SIZE on every rank) per dtype. A no-op without a process
    group. Every rank ends with the same bits."""
    if not dist.is_initialized() or not tensors:
        return
    n = dist.get_world_size()

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(n)

    _collective_(tensors, mean)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank `src`'s, in place: one broadcast per
    dtype. A no-op without a process group."""
    if not dist.is_initialized() or not tensors:
        return
    _collective_(tensors, lambda flat: dist.broadcast(flat, src))


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
