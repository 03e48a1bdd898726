"""One rank of the port's data-, tensor-parallel and spatial CPU tests
(tests/test_torch_dp_*.py, tests/test_torch_tp_*.py,
tests/test_torch_spatial_*.py).

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
  tp_step    every case of tp_step_cases.pt (as step's, with a mesh in its
         config): the whole state cut to this rank's slices
         (`shard_state`), one step on its data index's block; the
         gradients and parameters gathered whole, this rank's own slices,
         the names cut, the IN shapes (B, C, H, W) the step normalised, and
         a broadcast_state of the cut state after the other ranks'
         slices were moved;
  tp_loop    from tp_loop.pt: `train.loop.train` on the mesh for 2 steps,
         with its held-out eval, and the gathered payload after them; a
         one-rank checkpoint restored, cut and gathered again; then resumed
         for 2 steps;
  tp_cli     `cli.main` --mode train, then --mode export, with the argv of
         tp_cli.pt (tp_min_channels, which has no flag, set from it too);
         the parameters the loop cut.
  sp_step    every case of sp_step_cases.pt (as step's, with a spatial
         mesh in its config): one step on this rank's band of its data
         index's block (`local_band`) and its rows of the draws
         (`Draws.rows`); the gradients, metrics and parameters, and the
         (B, C, H, W) of every IN call (band and whole);
  sp_units   the ops of parallel/spatial.py on this rank's band of the
         inputs of sp_units.pt: a halo'd conv's output and its input
         gradient, the band IN's output and gradients, SSIM, the per-image
         rescale and the preprocess;
  sp_loop    from sp_loop.pt: `train.loop.train` on the spatial mesh for 2
         steps (and `cli.main --mode train` with the config's mesh, when
         given), the payload after them.

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


def _named(module):
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def job_tp_step(workdir):
    import copy

    from shmgan_tpu_torch.data.pipeline import local_batch
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink
    from shmgan_tpu_torch.parallel import tp
    from shmgan_tpu_torch.parallel.mesh import rank_layout, training_mesh
    from shmgan_tpu_torch.train.state import broadcast_state, create_train_state, shard_state
    from shmgan_tpu_torch.train.step import Draws, make_train_step

    shapes, plain = [], ink.instance_norm

    def recording(x, *args):
        shapes.append(tuple(x.shape))
        return plain(x, *args)

    ink.instance_norm = recording
    out = {}
    for case in torch.load(os.path.join(workdir, "tp_step_cases.pt"), weights_only=False):
        cfg = make_config(case["config"])
        layout = rank_layout(training_mesh(cfg))
        state = shard_state(create_train_state(cfg, _models(cfg, case["weights"])), layout,
                            cfg.model.image_size, cfg.mesh.tp_min_channels)
        views = local_batch(case["views"], layout.data_index, layout.data_parallel)
        draws = Draws(**case["draws"]).shard(layout.data_index, layout.data_parallel)
        del shapes[:]
        state, m = make_train_step(cfg, debug_grads=True)(state, views, draws, 0)
        # every rank but rank 0 moves its whole leaves; every rank but those
        # of data index 0 its slices too
        moved, cut = copy.deepcopy(state), tp.sharded_params(state.gen)
        with torch.no_grad():
            mu = moved.g_opt.moments()[0]
            for name, p in moved.gen.named_parameters():
                if layout.data_index > 0 or (layout.model_index > 0 and name not in cut):
                    p.add_(1.0)
                    mu[name].add_(1.0)
            if layout.data_index > 0 or layout.model_index > 0:
                moved.step += 5
        broadcast_state(moved)
        out[case["name"]] = {
            "grads": m.pop("_grads"), "metrics": {k: v for k, v in m.items()
                                                  if not k.startswith("_")},
            "gen": tp.gather_named(state.gen, _named(state.gen)),
            "disc": tp.gather_named(state.disc, _named(state.disc)),
            "local": {"gen": _named(state.gen), "disc": _named(state.disc)},
            "cut": {"gen": tp.sharded_params(state.gen), "disc": tp.sharded_params(state.disc)},
            "in_shapes": list(shapes), "coords": (layout.data_index, layout.model_index),
            "broadcast": {"gen": _named(moved.gen), "mu": moved.g_opt.moments()[0],
                          "step": moved.step},
            "mu": {k: t.clone() for k, t in state.g_opt.moments()[0].items()}}
    ink.instance_norm = plain
    return out


def job_tp_loop(workdir):
    from shmgan_tpu_torch.checkpoint import CheckpointManager
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.parallel.mesh import rank_layout, training_mesh
    from shmgan_tpu_torch.train.loop import train
    from shmgan_tpu_torch.train.state import create_train_state, shard_state, state_payload

    spec = torch.load(os.path.join(workdir, "tp_loop.pt"), weights_only=False)
    cfg, resume = make_config(spec["run"]), make_config(spec["resume"])
    state = train(cfg, max_steps=2, verbose=False, device="cpu", **spec["eval"])
    out = {"step": state.step, "payload": state_payload(state)}
    # a one-rank checkpoint on this mesh: restored whole, cut, gathered again
    restored = create_train_state(resume, build_models(resume, device="cpu", seed=1))
    CheckpointManager(resume.train.checkpoint_save_dir).restore(restored)
    shard_state(restored, rank_layout(training_mesh(resume)), resume.model.image_size,
                resume.mesh.tp_min_channels)
    out["restored"] = state_payload(restored)
    out["resumed_step"] = train(resume, max_steps=2, verbose=False, device="cpu").step
    return out


def job_tp_cli(workdir):
    import dataclasses

    from shmgan_tpu_torch import cli
    from shmgan_tpu_torch.config import Config
    from shmgan_tpu_torch.parallel import tp
    from shmgan_tpu_torch.train import loop

    spec = torch.load(os.path.join(workdir, "tp_cli.pt"), weights_only=False)
    original, parse = Config.__dict__["from_args"], Config.from_args

    def from_args(argv=None):
        cfg = parse(argv)
        cfg.mesh = dataclasses.replace(cfg.mesh, tp_min_channels=spec["tp_min_channels"])
        return cfg

    cut, shard_state = [], loop.shard_state

    def recording(state, *args):
        state = shard_state(state, *args)
        cut.append(sorted(tp.sharded_params(state.gen)) + sorted(tp.sharded_params(state.disc)))
        return state

    Config.from_args, loop.shard_state = staticmethod(from_args), recording
    try:
        for argv in spec["argvs"]:
            cli.main(argv, device="cpu")
    finally:
        Config.from_args, loop.shard_state = original, shard_state
    return {"cut": cut}


def job_sp_step(workdir):
    from shmgan_tpu_torch.data.pipeline import local_band, local_batch
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink
    from shmgan_tpu_torch.parallel.mesh import rank_layout, training_mesh
    from shmgan_tpu_torch.train.state import create_train_state, shard_state
    from shmgan_tpu_torch.train.step import Draws, make_train_step

    shapes, whole, band = [], ink.instance_norm, ink.instance_norm_band

    def recording(fn, kind):
        def call(x, *args):
            shapes.append((kind, tuple(x.shape)))
            return fn(x, *args)
        return call

    ink.instance_norm, ink.instance_norm_band = recording(whole, "whole"), recording(band, "band")
    out = {}
    try:
        for case in torch.load(os.path.join(workdir, "sp_step_cases.pt"), weights_only=False):
            cfg = make_config(case["config"])
            layout = rank_layout(training_mesh(cfg))
            state = shard_state(create_train_state(cfg, _models(cfg, case["weights"])), layout,
                                cfg.model.image_size, cfg.mesh.tp_min_channels)
            i, j = layout.data_index, layout.model_index
            dp, mp = layout.data_parallel, layout.model_parallel
            views = local_band(local_batch(case["views"], i, dp), j, mp).contiguous()
            draws = Draws(**case["draws"]).shard(i, dp).rows(j, mp)
            del shapes[:]
            state, m = make_train_step(cfg, debug_grads=True)(state, views, draws, 0)
            out[case["name"]] = {
                "grads": m.pop("_grads"), "metrics": {k: v for k, v in m.items()
                                                      if not k.startswith("_")},
                "gen": state.gen.state_dict(), "disc": state.disc.state_dict(),
                "in_shapes": list(shapes), "coords": (i, j)}
    finally:
        ink.instance_norm, ink.instance_norm_band = whole, band
    return out


def job_sp_units(workdir):
    import torch.nn.functional as F

    from shmgan_tpu_torch.ops.kernels import instance_norm as ink
    from shmgan_tpu_torch.ops.ssim import ssim
    from shmgan_tpu_torch.ops.standardize import rescale_01_per_image
    from shmgan_tpu_torch.parallel.mesh import Mesh, rank_layout
    from shmgan_tpu_torch.parallel.spatial import Band

    spec = torch.load(os.path.join(workdir, "sp_units.pt"), weights_only=False)
    m = world_size()
    sp = Band(rank_layout(Mesh(1, m, spatial=True)), spec["x"].shape[2])
    start, stop = sp.span()

    def mine(t, dim=2):
        return t.narrow(dim, start, stop - start).detach().clone().requires_grad_(True)

    out = {}
    x = mine(spec["x"])  # (B, C, H, W)
    y = sp.rows(x, lambda e: F.conv2d(e, spec["w"], padding=(0, 1)), 1, 1)
    (dx,) = torch.autograd.grad(y, x, mine(spec["gy"][:, :3].contiguous()))
    out["conv"] = (y.detach(), dx)
    x = mine(spec["x"])
    gamma, beta = (spec[k].clone().requires_grad_(True) for k in ("gamma", "beta"))
    y = ink.instance_norm_band(x, gamma, beta, 1e-6, sp)
    out["in"] = (y.detach(), *torch.autograd.grad(y, (x, gamma, beta), mine(spec["gy"])))
    a, b = mine(spec["a"], 1), mine(spec["b"], 1)  # (B, H, W, C)
    s = ssim(a, b, max_val=5.0, sp=sp.at(spec["a"].shape[1]))
    out["ssim"] = (s.detach(), *torch.autograd.grad(s.sum(), (a, b)))
    t = mine(spec["ties"], 1)
    r = rescale_01_per_image(t, sp.at(spec["ties"].shape[1]))
    out["rescale"] = (r.detach(), *torch.autograd.grad(r, t, mine(spec["gr"], 1)))
    out["pre"] = sp.at(spec["rgb"].shape[1]).preprocess(mine(spec["rgb"], 1).detach())
    out["span"] = (start, stop)
    return out


def job_sp_loop(workdir):
    import dataclasses

    from shmgan_tpu_torch import cli
    from shmgan_tpu_torch.config import Config
    from shmgan_tpu_torch.train.loop import train
    from shmgan_tpu_torch.train.state import state_payload

    spec = torch.load(os.path.join(workdir, "sp_loop.pt"), weights_only=False)
    cfg = make_config(spec["run"])
    state = train(cfg, max_steps=2, verbose=False, device="cpu")
    out = {"step": state.step, "payload": state_payload(state)}
    if spec.get("argv"):
        original, parse = Config.__dict__["from_args"], Config.from_args

        def from_args(argv=None):
            parsed = parse(argv)
            parsed.mesh = dataclasses.replace(parsed.mesh, spatial_sharding=True)
            return parsed

        Config.from_args = staticmethod(from_args)
        try:
            cli.main(spec["argv"], device="cpu")
        finally:
            Config.from_args = original
    return out


JOBS = {"step": job_step, "feed": job_feed, "loop": job_loop, "gan": job_gan,
        "tp_step": job_tp_step, "tp_loop": job_tp_loop, "tp_cli": job_tp_cli,
        "sp_step": job_sp_step, "sp_units": job_sp_units, "sp_loop": job_sp_loop}


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
