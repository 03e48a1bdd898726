"""Reads how far the bf16 train step on a 1 x 2 model mesh sits from the
one-rank bf16 step, by chip_smoke.py's gap measure, and what moves it.

    python3 shmgan_tpu_torch/tp_gap.py [--seeds 15 16 17 18] [--batches N] [--out FILE]

On one card, at chip_smoke's model_parallel configuration (the JAX defaults:
128 px, filter 64, batch 8, tp_min_channels 256, weights from seed 0), on
--batches seeded batches of each seed (default chip_smoke's
STEP_GAP_BATCHES, as its model_parallel phase pools them; `_tp_batches`;
seed 15 gives chip_smoke's own), the same train step with debug_grads runs
as:
  one       one rank in bf16 through the kernels;
  f32       one rank in float32: the yardstick is ||one - f32||;
  repeat    `one` again: the floor of run-to-run differences;
  split     one rank in bf16 with every convolution and instance norm that
            the JAX rule cuts computed as two calls, one on each model
            rank's slice of its output channels, and the class head as two
            partial products summed in f32: the mesh's arithmetic without
            a collective;
  no_cudnn  one rank in bf16 with cuDNN off (PyTorch's own convolutions):
            another correct rounding of every convolution;
  mesh      two gloo ranks on the card (chip_smoke.tp_rank's setting), as
            the code is ("mesh, none") and with each of FAULTS planted in
            memory in parallel/tp.py, every one touching bf16 tensors only.
For each pair (a, b) it prints every reading of chip_smoke's gap rule
(gap_readings: G's and D's gradients, D's scale along f32, the losses each
against its own bf16 error) of a against b, ||a - b|| / ||b - f32||, per
batch and pooled over each seed's batches as chip_smoke pools them, and over
every batch: each run against one, and each mesh run against split. Prints
one JSON line, also written to --out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BF16 = torch.bfloat16
DEVICE = "cuda"
SEEDS = (15, 16, 17, 18)
# each fault: the tp.py functions it replaces (parallel/tp.py's names)
FAULTS = {
    "none": "the code as it is",
    "enter sum in bf16": "the input gradients summed over the model row in bf16, not f32",
    "enter dx x 1.01": "every cut block's summed input gradient scaled by 1.01",
    "leave y x 1.01": "model rank 1's channels scaled by 1.01 after every gather",
    "leave other slice": "every cut block's backward takes the other rank's slice of g",
}


def _patcher():
    """(patch(name), restore()): plant the fault `name` in parallel/tp.py."""
    from shmgan_tpu_torch.parallel import tp

    enter_bwd, leave_fwd, leave_bwd = tp._Enter.backward, tp._Leave.forward, tp._Leave.backward

    def enter_sum_bf16(ctx, g):
        if g.dtype != BF16:
            return enter_bwd(ctx, g)
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None

    def enter_dx_scaled(ctx, g):
        dx, none = enter_bwd(ctx, g)
        return ((dx.float() * 1.01).to(BF16) if dx.dtype == BF16 else dx), none

    def leave_y_scaled(ctx, y, layout):
        out = leave_fwd(ctx, y, layout)
        if out.dtype != BF16:
            return out
        n = out.shape[1] // layout.model_parallel
        return torch.cat([out[:, :n], (out[:, n:].float() * 1.01).to(BF16)], 1)

    def leave_other_slice(ctx, g):
        if g.dtype != BF16:
            return leave_bwd(ctx, g)
        layout = ctx.layout
        n = g.shape[1] // layout.model_parallel
        j = (layout.model_index + 1) % layout.model_parallel
        return g.narrow(1, j * n, n).contiguous(), None

    planted = {"none": {}, "enter sum in bf16": {"enter": enter_sum_bf16},
               "enter dx x 1.01": {"enter": enter_dx_scaled},
               "leave y x 1.01": {"leave_fwd": leave_y_scaled},
               "leave other slice": {"leave_bwd": leave_other_slice}}

    def restore():
        tp._Enter.backward = staticmethod(enter_bwd)
        tp._Leave.forward = staticmethod(leave_fwd)
        tp._Leave.backward = staticmethod(leave_bwd)

    def patch(name):
        restore()
        fns = planted[name]
        if "enter" in fns:
            tp._Enter.backward = staticmethod(fns["enter"])
        if "leave_fwd" in fns:
            tp._Leave.forward = staticmethod(fns["leave_fwd"])
        if "leave_bwd" in fns:
            tp._Leave.backward = staticmethod(fns["leave_bwd"])

    return patch, restore


def mark_cut(model, m, image_size, min_channels):
    """Give every module whose parameters tp.shard_model_ cuts for an m-rank
    model axis (read from a copy) `_split_dims`, {parameter leaf: dim}; the
    mark survives the deep copies the step makes."""
    from shmgan_tpu_torch.parallel import tp
    from shmgan_tpu_torch.parallel.mesh import Mesh, RankLayout

    cut = tp.shard_model_(copy.deepcopy(model), RankLayout(Mesh(1, m)), image_size,
                          min_channels)
    for name, dim in cut.items():
        path, _, leaf = name.rpartition(".")
        owner = model.get_submodule(path)
        owner._split_dims = {**getattr(owner, "_split_dims", {}), leaf: dim}


class _Joined(torch.autograd.Function):
    """The slices joined on dim 1; backward, each slice's gradient as a
    tensor of its own, as tp.leave's backward gives each rank its slice."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.sizes = [p.shape[1] for p in parts]
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        return tuple(t.contiguous() for t in g.split(ctx.sizes, 1))


@contextmanager
def split_compute(m):
    """Within: every module with `_split_dims` (mark_cut) computes as m calls
    on the m model ranks' slices, joined as the mesh joins them."""
    from shmgan_tpu_torch.models import blocks, discriminator
    from shmgan_tpu_torch.ops.kernels import instance_norm as in_kernel

    conv, convt = blocks.conv, blocks.conv_transpose
    inorm, linear = blocks.InstanceNorm.forward, discriminator.linear

    def part(t, dim, j):
        n = t.shape[dim] // m
        return t.narrow(dim, j * n, n)

    def own(t, dim, j, dtype=None):  # a tensor of its own, as the rank's slice is
        return part(t, dim, j).to(dtype or t.dtype, memory_format=torch.contiguous_format,
                                   copy=True)

    def entered(x):
        # one node whose gradient is the m slices' summed before it meets
        # x's other uses, as tp.enter's all_reduce sums them
        return x.view_as(x)

    def weight(mod, dim, j, dtype):
        return own(mod.weight, dim, j, dtype)

    def bias(mod, j, dtype):
        return None if mod.bias is None else own(mod.bias, 0, j, dtype)

    def split_conv(mod, x, dtype):
        if not hasattr(mod, "_split_dims"):
            return conv(mod, x, dtype)
        w, x = mod._split_dims["weight"], entered(x)
        return _Joined.apply(*[mod._conv_forward(x.to(dtype), weight(mod, w, j, dtype),
                                                 bias(mod, j, dtype)) for j in range(m)])

    def split_convt(mod, x, dtype):
        if not hasattr(mod, "_split_dims"):
            return convt(mod, x, dtype)
        w, x = mod._split_dims["weight"], entered(x)
        return _Joined.apply(*[F.conv_transpose2d(x.to(dtype), weight(mod, w, j, dtype),
                                                  bias(mod, j, dtype), mod.stride, mod.padding,
                                                  mod.output_padding, mod.groups, mod.dilation)
                               for j in range(m)])

    def split_inorm(self, x):
        if not hasattr(self, "_split_dims"):
            return inorm(self, x)
        return _Joined.apply(*[in_kernel.instance_norm(own(x, 1, j), own(self.scale, 0, j),
                                                       own(self.bias, 0, j), self.eps)
                               for j in range(m)])

    def split_linear(mod, x, dtype):
        if not hasattr(mod, "_split_dims"):
            return linear(mod, x, dtype)
        sums = [F.linear(own(x, x.dim() - 1, j, dtype), weight(mod, 1, j, dtype)).float()
                for j in range(m)]
        return sum(sums[1:], sums[0]).to(dtype)

    blocks.conv, blocks.conv_transpose = split_conv, split_convt
    blocks.InstanceNorm.forward, discriminator.linear = split_inorm, split_linear
    try:
        yield
    finally:
        blocks.conv, blocks.conv_transpose = conv, convt
        blocks.InstanceNorm.forward, discriminator.linear = inorm, linear


class _OneRank:
    """The one-rank runs of a batch (rank 0 runs them while rank 1 waits
    in its first collective)."""

    def __init__(self, cs):
        from shmgan_tpu_torch.models import build_models
        from shmgan_tpu_torch.profile_train import training_config
        from shmgan_tpu_torch.train.state import create_train_state
        from shmgan_tpu_torch.train.step import make_train_step

        self.cfg = {d: training_config(d) for d in ("bfloat16", "float32")}
        self.state = {d: create_train_state(c, build_models(c, device=DEVICE, seed=0))
                      for d, c in self.cfg.items()}
        self.step = {d: make_train_step(c, debug_grads=True) for d, c in self.cfg.items()}
        c, s, self.m = self.cfg["bfloat16"], self.state["bfloat16"], cs.TP_RANKS
        for model in (s.gen, s.disc):
            mark_cut(model, self.m, c.model.image_size, c.mesh.tp_min_channels)

    def _run(self, dtype, batch):
        from shmgan_tpu_torch.train import step as step_module

        # one rank alone: its gradients join no average over the process group
        with mock.patch.object(step_module, "all_reduce_mean_", lambda *a, **k: None):
            return self.step[dtype](copy.deepcopy(self.state[dtype]), *batch, 0)[1]

    def runs(self, batch):
        out = {"f32": self._run("float32", batch), "one": self._run("bfloat16", batch),
               "repeat": self._run("bfloat16", batch)}
        with split_compute(self.m):
            out["split"] = self._run("bfloat16", batch)
        try:
            with torch.backends.cudnn.flags(enabled=False):
                out["no_cudnn"] = self._run("bfloat16", batch)
        except RuntimeError as e:  # a convolution PyTorch has no own CUDA version of
            print(f"no_cudnn: not measured: {str(e)[:200]}", flush=True)
        return out


def _reduce(cs, runs):
    """Each pair's chip_smoke._step_gap_stats (a against b, beside f32),
    and each run's losses."""
    pairs = [(a, "one") for a in runs if a not in ("one", "f32")]
    pairs += [(a, "split") for a in runs if a.startswith("mesh, ")]
    stats = {f"{a} vs {b}": cs._step_gap_stats(runs[a], runs[b], runs["f32"])
             for a, b in pairs if a in runs and b in runs}
    keys = sorted(k for k in runs["f32"] if not k.startswith("_") and k != "target_label")
    losses = {name: {k: float(m[k]) for k in keys} for name, m in runs.items()}
    return {"stats": stats, "losses": losses}


def rank(workdir):
    """One rank (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT from the
    environment): the plan in <workdir>/plan.json; writes <workdir>/gap<r>.pt
    (rank 0: each batch's _reduce)."""
    import chip_smoke as cs
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.parallel.mesh import (maybe_initialize_distributed, rank_layout,
                                                shutdown_distributed, training_mesh)
    from shmgan_tpu_torch.parallel.mesh import rank as rank_index
    from shmgan_tpu_torch.train.state import create_train_state, shard_state
    from shmgan_tpu_torch.train.step import make_train_step

    with open(os.path.join(workdir, "plan.json")) as f:
        plan = json.load(f)
    if not maybe_initialize_distributed("gloo"):
        raise RuntimeError("tp_gap.rank: no launcher environment")
    r, results = rank_index(), []
    patch, restore = _patcher()
    try:
        cfg = cs._tp_config("bfloat16")
        state = shard_state(create_train_state(cfg, build_models(cfg, device=DEVICE, seed=0)),
                            rank_layout(training_mesh(cfg)), cfg.model.image_size,
                            cfg.mesh.tp_min_channels)
        step = make_train_step(cfg, debug_grads=True)
        one = _OneRank(cs) if r == 0 else None
        for seed in plan["seeds"]:
            batches, _ = cs._tp_batches(cfg, plan["batches"], seed)
            for i, batch in enumerate(batches):
                runs = one.runs(batch) if one else {}
                for name in plan["faults"]:
                    patch(name)
                    try:
                        m = step(copy.deepcopy(state), *batch, 0)[1]
                    finally:
                        restore()
                    if one:
                        runs[f"mesh, {name}"] = m
                if one:
                    results.append({"seed": seed, "batch": i, **_reduce(cs, runs)})
                    print(f"seed {seed} batch {i} done", flush=True)
                del runs
        torch.save(results, os.path.join(workdir, f"gap{r}.pt"))
    finally:
        restore()
        shutdown_distributed()


def summarize(cs, results):
    """{pair: {part: {"batches": [...], "seeds": {seed: pooled}, "all": x}}}
    of chip_smoke.gap_readings of a against b (||a - b|| / ||b - f32||),
    from rank 0's results."""
    out = {}
    for pair in results[0]["stats"]:
        out[pair] = {}
        per_batch = [cs.gap_readings([r["stats"][pair]]) for r in results]
        by_seed = {seed: cs.gap_readings([r["stats"][pair] for r in results
                                          if r["seed"] == seed])
                   for seed in sorted({r["seed"] for r in results})}
        every = cs.gap_readings([r["stats"][pair] for r in results])
        for part in every:
            out[pair][part] = {"batches": [b[part] for b in per_batch],
                               "seeds": {s: v[part] for s, v in by_seed.items()},
                               "all": every[part]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--faults", nargs="+", default=list(FAULTS), choices=list(FAULTS))
    ap.add_argument("--batches", type=int, default=None,
                    help="batches a seed (default chip_smoke.STEP_GAP_BATCHES)")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)

    import chip_smoke as cs

    cs.device_phase()
    cs.build_phase()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "plan.json"), "w") as f:
            json.dump({"seeds": args.seeds, "faults": args.faults,
                       "batches": args.batches or cs.STEP_GAP_BATCHES}, f)
        results = cs._run_ranks(tmp, "shmgan_tpu_torch.tp_gap.rank", cs.TP_RANKS, "gap",
                                args.timeout)[0]
    summary = summarize(cs, results)
    for pair, parts in summary.items():
        for part, row in parts.items():
            cs.say(f"{pair}, {part}: all {row['all']:.3f}; by seed "
                   + ", ".join(f"{s} {v:.3f}" for s, v in row["seeds"].items())
                   + "; by batch " + ", ".join(f"{v:.3f}" for v in row["batches"]))
    worst = {}
    for r in results:
        f32 = r["losses"]["f32"]
        for name in ("one", "split", "mesh, none"):
            if name in r["losses"]:
                k = max(f32, key=lambda k: abs(r["losses"][name][k] - f32[k])
                        / max(abs(f32[k]), 1e-30))
                worst.setdefault(name, []).append(
                    (r["seed"], r["batch"], k,
                     (r["losses"][name][k] - f32[k]) / max(abs(f32[k]), 1e-30)))
    for name, rows in worst.items():
        cs.say(f"{name}: the loss furthest from f32, by batch: " + ", ".join(
            f"{s}/{b} {k} {v:+.2e}" for s, b, k, v in rows))
    line = json.dumps({"faults": {k: FAULTS[k] for k in args.faults}, "summary": summary,
                       "losses": [{"seed": r["seed"], "batch": r["batch"],
                                   "losses": r["losses"]} for r in results]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
