"""A dry run of the port's meshes on n CPU ranks: the counterpart of the JAX
package's `dryrun_multichip` (__graft_entry__.py), which compiles its step
on n virtual CPU devices.

    python -m shmgan_tpu_torch.parallel.dryrun 4

starts n processes, one gloo group on a free localhost port, each one rank
on the CPU, and runs two meshes at 32 px, filter 16, SpecSeg base 4:

  1. data_parallel n / 2 x model_parallel 2 (model_parallel 1 for an odd n),
     tp_min_channels 64 (at this width the default 256 would cut nothing),
     global batch n / 2: the seeded state cut to each rank's slices
     (`train.state.shard_state`), one step;
  2. pure data parallelism over n, global batch n: one step.

Each must end with finite losses, one step taken, and every rank holding
the same whole parameters bit for bit (gathered over the model axis,
hashed, and the hashes compared): so the gradient averages span the mesh
and the cut blocks' collectives put the slices back together. Rank 0
prints one line a mesh, ending in OK, with the elements of G and D that
each rank holds as slices and whole. Any failing rank fails the run with
its output.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import socket
import subprocess
import sys
from typing import List

import torch
import torch.distributed as dist

from shmgan_tpu_torch.config import Config

SIZE = 32


def _plans(n: int):
    mp = 2 if n > 1 and n % 2 == 0 else 1
    plans = [(n // mp, mp, 64)]
    if n > 1:
        plans.append((n, 1, Config().mesh.tp_min_channels))
    return plans


def _step(dp: int, mp: int, min_channels: int) -> str:
    from shmgan_tpu_torch.data.pipeline import local_batch
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.parallel import tp
    from shmgan_tpu_torch.parallel.mesh import rank_layout, training_mesh
    from shmgan_tpu_torch.train.state import create_train_state, shard_state
    from shmgan_tpu_torch.train.step import make_train_step, sample_draws

    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, image_size=SIZE, filter_size=16,
                                    specseg_base_filters=4)
    cfg.train = dataclasses.replace(cfg.train, batch_size=dp)
    cfg.mesh = dataclasses.replace(cfg.mesh, data_parallel=dp, model_parallel=mp,
                                   tp_min_channels=min_channels)
    layout = rank_layout(training_mesh(cfg))
    state = shard_state(create_train_state(cfg, build_models(cfg, device="cpu", seed=0)),
                        layout, SIZE, min_channels)
    gen = torch.Generator().manual_seed(1)
    views = torch.rand((cfg.model.c_dim, dp, SIZE, SIZE, 3), generator=gen)
    draws = sample_draws(cfg, gen, cfg.model.c_dim, dp, SIZE, SIZE)
    state, metrics = make_train_step(cfg)(
        state, local_batch(views, layout.data_index, dp),
        draws.shard(layout.data_index, dp), 0)
    total_g, total_d = float(metrics["total_G"]), float(metrics["total_D"])
    if not (torch.isfinite(metrics["total_G"]) and torch.isfinite(metrics["total_D"])):
        raise AssertionError(f"non-finite losses: total_G={total_g} total_D={total_d}")
    if state.step != 1:
        raise AssertionError(f"step {state.step} after one step")
    digest = hashlib.sha256()
    for module in (state.gen, state.disc):
        for name, t in tp.gather_named(module, dict(module.named_parameters())).items():
            digest.update(name.encode())
            digest.update(t.detach().contiguous().numpy().tobytes())
    digests: List[str] = [""] * dist.get_world_size()
    dist.all_gather_object(digests, digest.hexdigest())
    if len(set(digests)) != 1:
        raise AssertionError(f"the ranks' parameters differ after the step: {digests}")
    counts = {net: tp.shard_counts(m) for net, m in (("G", state.gen), ("D", state.disc))}
    if mp > 1 and not counts["G"]["cut"]:
        raise AssertionError("model_parallel > 1 but nothing was cut")
    kind = "dp x tp" if mp > 1 else "pure dp"
    held = "  ".join(f"{net} cut/whole {c['cut']}/{c['whole']}" for net, c in counts.items())
    return (f"[dryrun_multichip] mesh={{'data': {dp}, 'model': {mp}}} ({kind}) "
            f"total_G={total_g:.4f} total_D={total_d:.4f} {held} ranks agree OK")


def _rank_main() -> None:
    from shmgan_tpu_torch.parallel.mesh import (is_main, maybe_initialize_distributed,
                                                shutdown_distributed, world_size)

    torch.set_num_threads(1)
    if not maybe_initialize_distributed("gloo"):
        raise RuntimeError("dryrun rank: no launcher environment")
    try:
        for dp, mp, min_channels in _plans(world_size()):
            line = _step(dp, mp, min_channels)
            if is_main():
                print(line, flush=True)
    finally:
        shutdown_distributed()


def dryrun_multichip(n: int = 4, timeout: float = 600.0) -> List[str]:
    """Run the two meshes on n CPU ranks (see the module's docstring); print
    and return rank 0's lines. Raises with a failing rank's output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
        procs.append(subprocess.Popen([sys.executable, "-m", "shmgan_tpu_torch.parallel.dryrun",
                                       "--rank"], cwd=root, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip: ranks failed: {failed}")
    lines = [line for line in logs[0].splitlines() if line.startswith("[dryrun_multichip]")]
    for line in lines:
        print(line, flush=True)
    if len(lines) != len(_plans(n)) or not all(line.endswith("OK") for line in lines):
        raise RuntimeError(f"dryrun_multichip: expected {len(_plans(n))} OK lines, got {lines}")
    return lines


if __name__ == "__main__":
    if sys.argv[1:] == ["--rank"]:
        _rank_main()
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
