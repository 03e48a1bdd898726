"""One rank of the port's data-parallel CPU tests (tests/test_torch_dp_*.py).

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dp_worker.py <workdir> <job> [<job> ...]

joins the gloo group of n ranks from the launcher's environment and runs
each job in turn on the CPU, reading its inputs from `<workdir>` and
writing `<workdir>/<job>_<rank>.pt`:

  step   every case of step_cases.pt (a config, a state and the global
         batch's views and draws): one train step with debug_grads on this
         rank's block of the views and its `Draws.shard`; the averaged
         gradients, the metrics and the parameters after the step;
  feed   the first two batches `data.pipeline.rank_feed` hands this rank
         from the tree and config of feed.pt;
  loop   `train.loop.train` for 2 steps from the config of loop.pt, then
         again, resuming from its checkpoint, for 2 more; the parameters
         after each;
  gan    `quality_train.main` with the arguments of gan.pt.

Imports no JAX: the ranks run the port alone.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from shmgan_tpu_torch import Config  # noqa: E402
from shmgan_tpu_torch.parallel.mesh import (maybe_initialize_distributed, rank,  # noqa: E402
                                            shutdown_distributed, world_size)


def make_config(sections):
    """A Config with the fields {section: {name: value}} set."""
    cfg = Config()
    for section, fields in sections.items():
        for name, value in fields.items():
            setattr(getattr(cfg, section), name, value)
    return cfg


def _models(cfg, weights):
    from shmgan_tpu_torch.models import build_models

    models = build_models(cfg, device="cpu", seed=0)
    for m, sd in zip(models, weights):
        m.load_state_dict(sd)
    return models


def job_step(workdir):
    from shmgan_tpu_torch.data.pipeline import local_batch
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import Draws, make_train_step

    out = {}
    for case in torch.load(os.path.join(workdir, "step_cases.pt"), weights_only=False):
        cfg = make_config(case["config"])
        state = create_train_state(cfg, _models(cfg, case["weights"]))
        views = local_batch(case["views"], rank(), world_size())
        draws = Draws(**case["draws"]).shard(rank(), world_size())
        state, m = make_train_step(cfg, debug_grads=True)(state, views, draws, 0)
        out[case["name"]] = {
            "grads": m.pop("_grads"), "metrics": {k: v for k, v in m.items()
                                                  if not k.startswith("_")},
            "gen": state.gen.state_dict(), "disc": state.disc.state_dict()}
    return out


def job_feed(workdir):
    from shmgan_tpu_torch.data.loader import PolarimetricDataset
    from shmgan_tpu_torch.data.pipeline import rank_feed

    spec = torch.load(os.path.join(workdir, "feed.pt"), weights_only=False)
    cfg = make_config(spec["config"])
    ds = PolarimetricDataset(cfg.data, cfg.model.image_size, cfg.train.batch_size)
    feed = rank_feed(ds, shuffle_seed=spec["shuffle_seed"], device="cpu", depth=1)
    try:
        return [next(feed).clone() for _ in range(2)]
    finally:
        feed.close()


def job_loop(workdir):
    from shmgan_tpu_torch.train.loop import train

    cfg = make_config(torch.load(os.path.join(workdir, "loop.pt"), weights_only=False))
    out = {}
    for run in ("first", "resumed"):
        state = train(cfg, max_steps=2, verbose=False, device="cpu")
        out[run] = {"step": state.step, "gen": state.gen.state_dict(),
                    "disc": state.disc.state_dict()}
    return out


def job_gan(workdir):
    from shmgan_tpu_torch import quality_train

    quality_train.main(torch.load(os.path.join(workdir, "gan.pt"), weights_only=False))
    return {}


def spawn_ranks(workdir, jobs, world=2, timeout=240):
    """Run this file as `world` ranks of one gloo group on a free localhost
    port, each doing `jobs`; -> each rank's {job: result}. A rank that fails
    fails the caller with its output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       str(workdir), *jobs], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
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
        raise AssertionError(f"ranks failed: {failed}")
    return [{job: torch.load(os.path.join(workdir, f"{job}_{r}.pt"), weights_only=False)
             for job in jobs} for r in range(world)]


JOBS = {"step": job_step, "feed": job_feed, "loop": job_loop, "gan": job_gan}


def main(workdir, jobs):
    torch.set_num_threads(1)
    if not maybe_initialize_distributed("gloo"):
        raise RuntimeError("no launcher environment")
    try:
        for job in jobs:
            torch.save(JOBS[job](workdir), os.path.join(workdir, f"{job}_{rank()}.pt"))
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
