"""Reads how repeatable the float32 train step on a 1 x 2 spatial mesh is
against one rank's whole step, and what moves it.

    python3 shmgan_tpu_torch/sp_repeat.py [--repeats 6] [--out FILE]

On one card, at chip_smoke's spatial configuration (f32, the JAX defaults:
128 px, filter 64, batch 8, weights from seed 0, chip_smoke's SP_SEED
batch), each mode runs the step with debug_grads `repeats` times, each from
a fresh state after chip_smoke's warm-up step (`_tp_steps`):
  one       one rank, the whole step, in this process (which joins no
            process group);
  mesh      two gloo ranks on the card (chip_smoke.sp_rank's setting), the
            code as it is;
  sync      the mesh with torch.cuda.synchronize() before and after every
            collective of parallel/spatial.py (`_all_gather`,
            `_all_reduce_f32`): no copy of gloo's can overlap the card's
            work;
  determ    one rank and the mesh with cuDNN deterministic (its benchmark
            is off throughout, PyTorch's default).
Each run is read against the first `one` run (`determ`: the first
deterministic one-rank run) and against the first run of its own mode, as
chip_smoke's _compare_step reads it: ||diff|| / ||ref|| of G's and of D's
gradients (and D's leaf that holds most of the difference, with how many
of its elements differ), and the worst relative difference of the losses. Prints one JSON
line, also written to --out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MODES = ("mesh", "sync", "determ")


def _flat(metrics):
    """({net: {leaf: float64 vector}} of G's and D's gradients, the losses
    by name)."""
    grads = {net: {k: g.double().flatten() for k, g in metrics["_grads"][net].items()}
             for net in ("G", "D")}
    return grads, {k: float(v) for k, v in metrics.items() if not k.startswith("_")}


def _reading(got, ref):
    """||diff|| / ||ref|| of each network's gradients; for D also the leaf
    that holds most of ||diff||, its share of it, and how many of its
    elements differ by more than 1e-3 of its largest |ref|; the worst
    relative difference of the losses."""
    (g, losses), (r, ref_losses) = got, ref
    out = {}
    for net in ("G", "D"):
        diffs = {k: g[net][k] - r[net][k] for k in r[net]}
        norm = torch.cat(list(diffs.values())).norm()
        out[net] = (norm / torch.cat(list(r[net].values())).norm()).item()
        if net == "D":
            leaf = max(diffs, key=lambda k: diffs[k].norm())
            out["D_leaf"] = leaf
            out["D_leaf_share"] = (diffs[leaf].norm() / norm.clamp_min(1e-300)).item()
            out["D_leaf_elems"] = int((diffs[leaf].abs()
                                       > 1e-3 * r[net][leaf].abs().max()).sum())
    out["losses"] = max(abs(losses[k] - ref_losses[k]) / max(abs(ref_losses[k]), 1e-30)
                        for k in ref_losses)
    return out


def _synced(fn):
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out
    return call


def _setting():
    """chip_smoke's spatial f32 configuration, its batch, and a fresh whole
    state from seed 0."""
    import chip_smoke as cs
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.train.state import create_train_state

    cfg = cs._sp_config("float32")
    batches, _ = cs._tp_batches(cfg, 1, seed=cs.SP_SEED)
    return cfg, batches, lambda: create_train_state(cfg, build_models(cfg, device="cuda",
                                                                      seed=0))


def _record(readings, firsts, mode, ref, run):
    """Read `run` against `ref` and against its mode's first run."""
    own = firsts.setdefault(mode, run)
    row = readings.setdefault(mode, {"vs_one": [], "vs_own_first": []})
    row["vs_one"].append(_reading(run, ref))
    row["vs_own_first"].append(_reading(run, own))


def rank(workdir):
    """One rank of the mesh (RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT
    from the environment, LOCAL_RANK 0): SP_REPEATS steps a mode of MODES,
    each from a fresh state; rank 0 reads them against the one-rank firsts
    in <workdir>/one.pt. Writes <workdir>/rep<r>.pt (rank 0's readings)."""
    import chip_smoke as cs
    from shmgan_tpu_torch.parallel import spatial
    from shmgan_tpu_torch.parallel.mesh import (maybe_initialize_distributed, rank as rank_of,
                                                rank_layout, shutdown_distributed,
                                                training_mesh)
    from shmgan_tpu_torch.train.state import shard_state

    repeats = int(os.environ["SP_REPEATS"])
    if not maybe_initialize_distributed("gloo"):
        raise RuntimeError("sp_repeat: no launcher environment")
    r, readings, firsts = rank_of(), {}, {}
    cfg, batches, fresh = _setting()
    layout = rank_layout(training_mesh(cfg))
    ones = torch.load(os.path.join(workdir, "one.pt"), weights_only=False) if r == 0 else {}
    gather, reduce = spatial._all_gather, spatial._all_reduce_f32
    try:
        for mode in MODES:
            torch.backends.cudnn.deterministic = mode == "determ"
            if mode == "sync":
                spatial._all_gather, spatial._all_reduce_f32 = _synced(gather), _synced(reduce)
            try:
                for _ in range(repeats):
                    state = shard_state(fresh(), layout, cfg.model.image_size,
                                        cfg.mesh.tp_min_channels)
                    run = _flat(cs._tp_steps(cfg, state, batches, layout,
                                             "instance_norm_band")[1][0])
                    if r == 0:
                        _record(readings, firsts, mode,
                                ones["one determ" if mode == "determ" else "one"], run)
            finally:
                spatial._all_gather, spatial._all_reduce_f32 = gather, reduce
        torch.save(readings, os.path.join(workdir, f"rep{r}.pt"))
    finally:
        torch.backends.cudnn.deterministic = False
        shutdown_distributed()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sp_repeat: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    # one rank's steps in this process, which joins no process group (a
    # step in a group of two would average over it)
    cfg, batches, fresh = _setting()
    readings, firsts = {}, {}
    for mode in ("one", "one determ"):
        torch.backends.cudnn.deterministic = mode == "one determ"
        for _ in range(args.repeats):
            run = _flat(cs._tp_steps(cfg, fresh(), batches)[1][0])
            _record(readings, firsts, mode, firsts.get(mode, run), run)
    torch.backends.cudnn.deterministic = False
    del batches
    torch.cuda.empty_cache()
    os.environ["SP_REPEATS"] = str(args.repeats)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(firsts, os.path.join(tmp, "one.pt"))
        readings.update(cs._run_ranks(tmp, "shmgan_tpu_torch.sp_repeat.rank", cs.SP_RANKS,
                                      "rep", 1200)[0])
    for mode, rows in readings.items():
        for against, values in rows.items():
            print(f"{mode} {against}: " + "; ".join(
                ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in x.items()) for x in values))
    line = json.dumps({"device": torch.cuda.get_device_name(0), "repeats": args.repeats,
                       "readings": readings})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
