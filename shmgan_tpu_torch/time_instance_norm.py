"""Times the instance-norm kernels of one checkout on the card, to compare
commits.

    python3 shmgan_tpu_torch/time_instance_norm.py [--tree DIR]
        [--forward | --band | --phase-b] [--sweep]

Imports `shmgan_tpu_torch` from DIR (default: the checkout this file is in),
so the same timings can run against an older commit unpacked elsewhere; run
each checkout in its own process, in turns (old, new, new, old), on one
card. At the 15 IN shapes of the train step
(`chip_smoke.TRAIN_IN_SHAPES`), with f32 and with bf16 activations, it times
that checkout's `instance_norm_backward` on the inputs chip_smoke uses, with
`chip_smoke.py`'s timers (from the checkout this file is in): `device_ms`
from CUDA-graph replays (L2 warm) and `device_cold_ms` of one call after an
L2 flush, and their sums over the sites of one train step. With --sweep
(a checkout that has `_bwd_plan`) it also times, at each shape, the resident
variant at every block size from 32 to 512 threads in one block and in a
cluster of two, and the streaming variant, beside the plan's choice: the
measurement the plan's constants rest on.

With --band it times the band backward instead (spatial sharding: the sums
launch and the apply launch of `instance_norm_band_backward`, through a
one-rank row, `spatial.LocalRow`) at every band shape the spatial train
step gives it (`chip_smoke.SP_BAND_SHAPES`), both dtypes: `device_ms`,
`device_cold_ms` and the bytes bound (x and g read once, dx written once)
at each shape, and their sums over one rank's step weighted by calls a
step. With --band --sweep (a checkout that has `_band_bwd_plan`) it also
times, at each shape, the packed variant (bands of up to 256 elements) at
64, 128 and 256 threads, and the vector (H*W a multiple of 16 bytes) and
element variants at 32 to 512 threads, beside the plan's choice.

With --phase-b it times the backward (`instance_norm_backward`) at the
phase-B step's 46 IN sites (`chip_smoke.qg_in_shapes`: 256 px, batch 10,
in bf16 and in f32, and the G1 sites of chip_smoke's f32 step at batch 2):
its plan, `device_ms`, `device_cold_ms`, the plain version's `ms`, the
bytes bound (x and g read once, dx written once) and autograd through
`F.instance_norm` (`device_ms` through a retained graph) at each shape,
and their sums over one step weighted by calls a step. With --phase-b
--sweep it also times, at each shape above two resident blocks' registers
(the 256 x 256 planes), every resident plan the kernels accept among
clusters of 1 to 8 blocks of 128, 256 or 512 threads (4 or 8 chunks a
thread), and the streaming variant, beside the plan's choice.

With --forward it times the forward (`_forward`, one launch a call) at
the serving shapes (`chip_smoke.IN_SHAPES`, b8 at 256 px), the native
shapes (`chip_smoke.NATIVE_IN_SHAPES`, batch 2 at the 640x832 bucket and
batch 1 at 1536x2048) and the train step's (`chip_smoke.TRAIN_IN_SHAPES`,
with the stats the backward reads), both dtypes: `device_ms`,
`device_cold_ms`, the bytes bound (x read once, y written once) and
`F.instance_norm`'s `device_ms` at each shape, and their sums over one G
call (serving, each native batch) and one train step. With --forward
--sweep (a checkout that has `_fwd_plan`) it also times, at each shape,
every plan the kernels accept among: packed at 64 to 256 threads, resident
at the two-pass map (several planes a block at 1, 2 and 4 planes), a
cluster of 2, 4 or 8 blocks of 128 to 512 threads (resident where its
registers hold the plane, else split at 4, 8 or 16 chunks a thread), and
two-pass, beside the plan's choice: the measurement the plan's limits rest
on.

Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _sweep(cs, ink, plan, x, gamma, mean, rstd, dy, clusters=(1, 2),
           threads=(32, 64, 128, 256, 512), iters=50):
    """device_ms of each other plan the kernels accept at this shape, among
    resident plans of `clusters` blocks of `threads` (as many chunks a thread
    as the run needs) and streaming: {"variant/threads/cluster": ms}, a
    resident key of 8 chunks a thread ending in "/c8"."""
    vec = 16 // x.element_size()
    nchunks = x.shape[2] * x.shape[3] // vec
    others = []
    for k in clusters:
        run = -(-nchunks // k)
        if (k - 1) * run < nchunks:
            others += [ink.BwdPlan("resident", 1, t * k, t, k, vec, -(-run // t))
                       for t in threads]
    others.append(ink.BwdPlan("streaming", 1, 256, 256, 1, vec, -(-nchunks // 256)))
    out = {}
    for p in others:
        if (p.variant, p.threads, p.cluster) == (plan.variant, plan.threads, plan.cluster):
            continue
        try:
            ink._launch_backward(x, gamma, mean, rstd, dy, p)
        except RuntimeError:  # the kernels refuse this plan at this shape
            continue
        wide = p.variant == "resident" and p.chunks > 4
        key = f"{p.variant}/{p.threads}/{p.cluster}" + ("/c8" if wide else "")
        out[key] = cs.device_ms(lambda: ink._launch_backward(x, gamma, mean, rstd, dy, p), iters)
    return out


def _phase_b_main(cs, ink, args, dev, smi):
    """--phase-b: the backward at the phase-B step's shapes."""
    import torch

    groups = [("phase_b", torch.bfloat16, cs.qg_in_shapes(cs.QG_BATCH)),
              ("phase_b", torch.float32, cs.qg_in_shapes(cs.QG_BATCH)),
              ("phase_b_b2_g1", torch.float32, cs.qg_in_shapes(cs.QG_SMALL_BATCH)[:1])]
    keys = ("device_ms", "device_cold_ms", "plain_ms", "bound_ms", "library_device_ms")
    rows, totals = [], {}
    for group, dtype, shapes in groups:
        g = torch.Generator(device=dev).manual_seed(0)
        name = str(dtype).split(".")[-1]
        total = totals.setdefault(f"{group}_{name}", dict.fromkeys(keys, 0.0))
        for shape, calls in shapes:
            b, c, h, w = shape
            x, gamma, beta, dy = cs._in_inputs(dev, g, shape, dtype)
            _, mean, rstd = ink._forward(x, gamma, beta, 1e-6, with_stats=True)
            call = lambda: ink.instance_norm_backward(x, gamma, mean, rstd, dy)  # noqa: E731
            iters = 5 if x.numel() > 1 << 26 else 10 if x.numel() > 1 << 24 else 50
            bound_ms, _ = cs.bound(3 * x.numel() * x.element_size() + (2 * b * c + 3 * c) * 4,
                                   10 * x.numel())
            row = dict(group=group, dtype=name, shape=list(shape), calls_per_step=calls,
                       device_ms=cs.device_ms(call, iters),
                       device_cold_ms=cs.device_cold_ms(call),
                       plain_ms=cs.time_ms(lambda: ink.instance_norm_backward_plain(
                           x, gamma, mean, rstd, dy), iters),
                       bound_ms=bound_ms,
                       library_device_ms=cs.library_backward_ms(x, gamma, beta, dy, iters)[1])
            if hasattr(ink, "_bwd_plan"):
                plan = ink._bwd_plan(b, c, h * w, dtype)
                row.update(variant=plan.variant, threads=plan.threads, cluster=plan.cluster,
                           chunks=plan.chunks)
                two_blocks = 2 * ink.RESIDENT_THREADS * ink.RESIDENT_CHUNKS
                if args.sweep and h * w // (16 // x.element_size()) > two_blocks:
                    row["others"] = _sweep(cs, ink, plan, x, gamma, mean, rstd, dy,
                                           clusters=range(1, 9), threads=(128, 256, 512),
                                           iters=iters)
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
            for k in keys:
                total[k] += calls * row[k]
            del x, dy, mean, rstd
            torch.cuda.empty_cache()
    print(json.dumps({"tree": args.tree, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "phase_b": True, "per_step": totals, "rows": rows}))


def _band_plans(ink, shape, dtype):
    """Every band plan the sweep times at this (B, C, h, W): packed at 64 to
    256 threads where the band fits, vector where H*W is a multiple of 16
    bytes, and element, at 32 to 512 threads."""
    b, c, h, w = shape
    hw, vec = h * w, 16 // dtype.itemsize
    plans = []
    if hw <= ink.BAND_PACKED_MAX:
        width = vec if hw % vec == 0 else 1
        lanes = min(32, 1 << (hw // width - 1).bit_length())
        plans += [ink.BandPlan("packed", t // lanes, lanes, t, width, -(-hw // width // lanes))
                  for t in (64, 128, 256) if t >= lanes]
    for variant, width in (("vector", vec), ("element", 1)):
        if hw % width == 0:
            plans += [ink.BandPlan(variant, 1, t, t, width, -(-hw // width // t))
                      for t in (32, 64, 128, 256, 512)]
    return plans


def _band_main(cs, ink, args, dev, smi):
    """--band: the band backward at chip_smoke.SP_BAND_SHAPES."""
    import torch
    from shmgan_tpu_torch.parallel.spatial import LocalRow

    row, rows, totals = LocalRow(), [], {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(0)
        name = str(dtype).split(".")[-1]
        total = totals.setdefault(name, dict(device_ms=0.0, device_cold_ms=0.0, bound_ms=0.0))
        for shape, calls in cs.SP_BAND_SHAPES:
            b, c, h, w = shape
            x, gamma, beta, dy = cs._in_inputs(dev, g, shape, dtype)
            _, mean, rstd = ink.instance_norm_band_forward(x, gamma, beta, 1e-6, row)
            call = lambda: ink.instance_norm_band_backward(x, dy, gamma, mean, rstd, row)  # noqa
            bound_ms, _ = cs.bound(3 * x.numel() * x.element_size(), 10.0 * x.numel())
            out = dict(dtype=name, shape=list(shape), calls_per_step=calls,
                       device_ms=cs.device_ms(call, 50), device_cold_ms=cs.device_cold_ms(call),
                       bound_ms=bound_ms)
            if hasattr(ink, "_band_bwd_plan"):
                plan = ink._band_bwd_plan(b, c, h * w, dtype)
                out.update(variant=plan.variant, threads=plan.threads)
                if args.sweep:
                    n = h * w * row.m
                    others = {}
                    for p in _band_plans(ink, shape, dtype):
                        def pair(p=p):
                            local = ink.band_bwd_sums(x, dy, mean, rstd, p)
                            return ink.band_bwd_apply(x, dy, gamma, mean, rstd, local, local,
                                                      n, p)
                        others[f"{p.variant}/{p.threads}"] = cs.device_ms(pair, 50)
                    out["others"] = others
            rows.append(out)
            for k in total:
                total[k] += calls * out[k]
            del x, dy
    print(json.dumps({"tree": args.tree, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "band": True, "per_step": totals, "rows": rows}))


def _fwd_plans(ink, shape, dtype):
    """Every forward plan the --forward --sweep times at this (B, C, H, W),
    for x on a 16-byte boundary."""
    b, c, h, w = shape
    hw, vec = h * w, 16 // dtype.itemsize
    plans = [ink.two_pass_plan(hw, vec if hw % vec == 0 else 1)]
    if hw % vec:
        return plans
    n = hw // vec

    def blocks(lanes, threads, cluster, chunks):
        run = -(-n // cluster)
        rounds = -(-run // (lanes * chunks))
        return ink.FwdPlan("resident" if rounds == 1 else "split",
                           threads // lanes if cluster == 1 else 1, lanes, threads, cluster,
                           vec, chunks, rounds)

    if n <= 32 * ink.FWD_PACKED_CHUNKS:
        lanes = min(32, 1 << (n - 1).bit_length())
        plans += [ink.FwdPlan("packed", t // lanes, lanes, t, 1, vec, -(-n // lanes), 1)
                  for t in (64, 128, 256) if t >= lanes]
    if n <= 256:
        lanes = 32 * -(-n // 32)
        plans += [blocks(lanes, lanes * k, 1, 1) for k in (1, 2, 4) if lanes * k <= 512]
    for lanes in (32, 64, 128, 256):  # one block or a group a plane, at other maps
        per = -(-n // lanes)
        if lanes < n and per <= 16:
            ch = 1 << (per - 1).bit_length()
            plans += [blocks(lanes, t, 1, ch) for t in (128, 256, 512) if t >= lanes]
    for k in (2, 4, 8):
        run = -(-n // k)
        if (k - 1) * run >= n:
            continue
        for t in (128, 256, 512):
            per = -(-run // t)
            if per <= 16:
                plans.append(blocks(t, t, k, 1 << (per - 1).bit_length()))
            else:
                plans += [blocks(t, t, k, ch) for ch in (4, 8, 16)]
    return plans


def _fwd_main(cs, ink, args, dev, smi):
    """--forward: the forward at the serving, native and train shapes."""
    import torch
    import torch.nn.functional as F

    groups = [("serving", cs.IN_SHAPES, False), ("native_b2", cs.NATIVE_IN_SHAPES[:5], False),
              ("native_b1", cs.NATIVE_IN_SHAPES[5:], False),
              ("train", cs.TRAIN_IN_SHAPES, True)]
    rows, totals = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(0)
        name = str(dtype).split(".")[-1]
        for group, shapes, stats in groups:
            total = totals.setdefault(f"{group}_{name}", dict(
                device_ms=0.0, device_cold_ms=0.0, bound_ms=0.0, library_device_ms=0.0))
            for shape, sites in shapes:
                b, c, h, w = shape
                x, gamma, beta, _ = cs._in_inputs(dev, g, shape, dtype)
                call = lambda: ink._forward(x, gamma, beta, 1e-6, stats)  # noqa: E731
                iters = 5 if x.numel() > 1 << 26 else 10 if x.numel() > 1 << 24 else 50
                bound_ms, _ = cs.bound(2 * x.numel() * x.element_size(), 5.0 * x.numel())
                row = dict(dtype=name, group=group, shape=list(shape), sites=sites,
                           device_ms=cs.device_ms(call, iters),
                           device_cold_ms=cs.device_cold_ms(call), bound_ms=bound_ms,
                           library_device_ms=cs.device_ms(lambda: F.instance_norm(
                               x, weight=gamma, bias=beta, eps=1e-6), iters))
                if hasattr(ink, "_fwd_plan"):
                    plan = ink._fwd_plan(b, c, h * w, dtype)
                    row.update(variant=plan.variant, lanes=plan.lanes, threads=plan.threads,
                               cluster=plan.cluster, chunks=plan.chunks, rounds=plan.rounds)
                    if args.sweep:
                        others = {}
                        for p in _fwd_plans(ink, shape, dtype):
                            key = (f"{p.variant}/{p.lanes}/{p.threads}/{p.cluster}/"
                                   f"{p.chunks}")
                            try:
                                ink._launch_forward(x, gamma, beta, 1e-6, stats, p)
                            except RuntimeError:  # the kernels refuse this plan here
                                continue
                            others[key] = cs.device_ms(lambda p=p: ink._launch_forward(
                                x, gamma, beta, 1e-6, stats, p), iters)
                        row["others"] = others
                rows.append(row)
                print(json.dumps(row), file=sys.stderr, flush=True)
                for k in total:
                    total[k] += sites * row[k]
                del x
    print(json.dumps({"tree": args.tree, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "forward": True, "sums": totals, "rows": rows}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE), help="checkout whose package is timed")
    ap.add_argument("--band", action="store_true",
                    help="time the band backward at chip_smoke.SP_BAND_SHAPES")
    ap.add_argument("--forward", action="store_true",
                    help="time the forward at the serving, native and train shapes")
    ap.add_argument("--phase-b", action="store_true",
                    help="time the backward at the phase-B step's 46 IN sites")
    ap.add_argument("--sweep", action="store_true", help="also time other plans")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    if not torch.cuda.is_available():
        raise SystemExit("time_instance_norm needs a CUDA card")
    if not Path(ink.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {ink.__file__}, not the package under {tree}")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    args.tree = str(tree)
    if args.band:
        return _band_main(cs, ink, args, dev, smi)
    if args.forward:
        return _fwd_main(cs, ink, args, dev, smi)
    if args.phase_b:
        return _phase_b_main(cs, ink, args, dev, smi)
    rows, totals = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(0)
        name = str(dtype).split(".")[-1]
        total = totals.setdefault(name, dict(device_ms=0.0, device_cold_ms=0.0))
        for shape, sites in cs.TRAIN_IN_SHAPES:
            c = shape[1]
            x, gamma, beta, dy = cs._in_inputs(dev, g, shape, dtype)
            _, mean, rstd = ink._forward(x, gamma, beta, 1e-6, with_stats=True)
            call = lambda: ink.instance_norm_backward(x, gamma, mean, rstd, dy)  # noqa: E731
            iters = 10 if x.numel() > 1 << 24 else 50
            row = dict(dtype=name, shape=list(shape), sites_per_step=sites,
                       device_ms=cs.device_ms(call, iters), device_cold_ms=cs.device_cold_ms(call))
            if hasattr(ink, "_bwd_plan"):
                plan = ink._bwd_plan(shape[0], c, shape[2] * shape[3], dtype)
                row.update(variant=plan.variant, threads=plan.threads, cluster=plan.cluster)
                if args.sweep:
                    row["others"] = _sweep(cs, ink, plan, x, gamma, mean, rstd, dy)
            rows.append(row)
            for k in total:
                total[k] += sites * row[k]
            del x, dy
    print(json.dumps({"tree": str(tree), "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "per_step": totals, "rows": rows}))


if __name__ == "__main__":
    main()
