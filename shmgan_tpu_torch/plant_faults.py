"""Shows that chip_smoke.py's checks fail a wrong instance-norm path.

    python3 shmgan_tpu_torch/plant_faults.py                # bf16 checks
    python3 shmgan_tpu_torch/plant_faults.py --train-loop   # f32 train_loop
    python3 shmgan_tpu_torch/plant_faults.py --sweep 16 [--seeds ...] [--out F]

In one process on the card it builds the kernels, then plants each fault in
turn by patching the wrapper in memory (no file changes) and runs chip_smoke
checks with it in place. By default the faults touch bf16 activations only,
and the checks are three of chip_smoke's bf16 ones (after its f32 serve
phase, whose outputs the bf16 gate compares against): autograd through the
kernels against autograd through the plain version at the train step's 15 IN
shapes, the serve_bf16 phase and the train_bf16 phase. With --train-loop the
faults touch f32 activations only, and the check is chip_smoke's train_loop
phase (the loop through the kernels against the plain loop). A bf16 train
step is held by chip_smoke's gap rule (`gap_readings`): over
STEP_GAP_BATCHES batches, G's and D's gradients (L2), each of D's leaves'
scale along its f32 gradient, and the losses each against its own bf16
error, every part at GAP_C. The faults:
  none                  the code as it is: every check must pass;
  dx x 1.01             the backward's dx scaled by 1.01 in `_InstanceNormFn`;
  dgamma, dbeta zeroed  the backward's parameter gradients dropped;
  y x 1.01              the forward kernel's output scaled by 1.01.
Prints one RESULT line per fault and check with its worst reading beside
its limit, then two JSON lines: {fault: {check: {reading label: [reading,
limit]}}} and {fault: {check: "passed" | "failed"}}. Exits non-zero if the
unfaulted code fails a check or a planted fault passes every check.

With --sweep N it runs no check: for each of --seeds, N batches of the
train_bf16 setting under every fault and of the triplets and phase-B
settings honest, each seed's gap_readings printed (SWEEP lines) and every
batch's statistics written to --out as JSON, for choosing the rule. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BF16 = torch.bfloat16


def _faults(ink, dtype):
    """The faults, each touching activations of `dtype` only."""
    fwd, bwd = ink._forward, ink._InstanceNormFn.backward

    def dx_scaled(ctx, g):
        dx, dgamma, dbeta, eps = bwd(ctx, g)
        return (dx.float() * 1.01).to(dx.dtype) if dx.dtype == dtype else dx, dgamma, dbeta, eps

    def params_zeroed(ctx, g):
        dx, dgamma, dbeta, eps = bwd(ctx, g)
        if dx.dtype == dtype:
            dgamma, dbeta = torch.zeros_like(dgamma), torch.zeros_like(dbeta)
        return dx, dgamma, dbeta, eps

    def y_scaled(x, gamma, beta, eps, with_stats):
        y, mean, rstd = fwd(x, gamma, beta, eps, with_stats)
        return (y.float() * 1.01).to(y.dtype) if y.dtype == dtype else y, mean, rstd

    def restore():
        ink._forward, ink._InstanceNormFn.backward = fwd, staticmethod(bwd)

    def patch(name, fn):
        restore()
        if name == "_forward":
            ink._forward = fn
        elif fn is not None:
            ink._InstanceNormFn.backward = staticmethod(fn)

    return {"none": (None, None), "dx x 1.01": ("backward", dx_scaled),
            "dgamma, dbeta zeroed": ("backward", params_zeroed),
            "y x 1.01": ("_forward", y_scaled)}, patch, restore


def autograd_checks(cs, ink, readings):
    """chip_smoke's autograd check at the 15 IN shapes of the train step,
    bf16; each shape's reading, max |kernels - plain| / (atol + rtol
    |plain|) over y, dx, dgamma and dbeta (limit 1), appended to
    `readings`."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    tols = (cs.IN_TOL_BF16, cs.IN_TOL_BF16, cs.IN_PARAM_TOL_BF16, cs.IN_PARAM_TOL_BF16)
    for shape, _ in cs.TRAIN_IN_SHAPES:
        c = shape[1]
        x = F.leaky_relu(torch.randn(shape, device=dev, generator=g) + 0.5, 0.2).to(BF16)
        gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
        beta = 0.02 * torch.randn(c, device=dev, generator=g)
        dy = torch.randn(shape, device=dev, generator=g).to(BF16)
        got, ref = [], []
        for fn, res in ((ink.instance_norm, got), (ink.instance_norm_plain, ref)):
            leaves = [t.detach().clone().requires_grad_(True) for t in (x, gamma, beta)]
            y = fn(*leaves, 1e-6)
            res.extend([y.detach(), *torch.autograd.grad(y, leaves, dy)])
        readings.append((f"autograd {shape}", max(
            float(((a.float() - r.float()).abs() / (t["atol"] + t["rtol"] * r.float().abs())).max())
            for a, r, t in zip(got, ref, tols)), 1.0))
        cs._autograd_check(ink, ink.kernel_name("backward", BF16), shape, x, gamma, beta, dy,
                           tols)


@contextmanager
def recorded(cs, readings):
    """chip_smoke's gap checks inside the block (_gap_check on outputs,
    _gap_verdict on a train step's parts), each reading appended to
    `readings` as (label, ratio, limit): every check runs, and the block
    raises the first check's AssertionError at its end."""
    check, verdict, failed = cs._gap_check, cs._gap_verdict, []

    def spy_check(label, kernels, plain, f32, limit=cs.GAP_C):
        k, p, f = (np.asarray(t, np.float64).ravel() for t in (kernels, plain, f32))
        readings.append((label, float(np.linalg.norm(k - p) / max(np.linalg.norm(p - f),
                                                                   1e-300)), limit))
        try:
            check(label, kernels, plain, f32, limit)
        except AssertionError as e:
            failed.append(e)

    def spy_verdict(label, ratio, limit):
        readings.append((label, float(ratio), limit))
        try:
            verdict(label, ratio, limit)
        except AssertionError as e:
            failed.append(e)

    with mock.patch.object(cs, "_gap_check", spy_check), \
            mock.patch.object(cs, "_gap_verdict", spy_verdict):
        yield
    if failed:
        raise failed[0]


def _sweep(cs, faults, patch, seeds, n, batches_of, cfgs, states, what, out, step_index=0):
    """For each seed, n batches (batches_of(seed, n)): the bf16 step through
    the plain versions, the f32 step (the yardstick) and the bf16 step
    through the kernels with each fault planted, all from the same weights;
    each batch's chip_smoke._step_gap_stats, and each seed's gap_readings
    printed and kept in out[what][fault][seed]."""
    from shmgan_tpu_torch.profile_serve import plain_versions
    from shmgan_tpu_torch.train.step import make_train_step

    cfg, f32_cfg = cfgs
    state, f32_state = states
    checked = make_train_step(cfg, debug_grads=True)
    f32_step = make_train_step(f32_cfg, debug_grads=True)
    rec = out.setdefault(what, {name: {} for name in faults})
    for seed in seeds:
        stats = {name: [] for name in faults}
        for views, draws in batches_of(seed, n):
            _, f = f32_step(copy.deepcopy(f32_state), views, draws, step_index)
            with plain_versions():
                _, p = checked(copy.deepcopy(state), views, draws, step_index)
            for name, (where, fn) in faults.items():
                patch(where, fn)
                _, k = checked(copy.deepcopy(state), views, draws, step_index)
                stats[name].append(cs._step_gap_stats(k, p, f))
                del k
            patch(None, None)
            del f, p
        for name in faults:
            got = cs.gap_readings(stats[name])
            rec[name][seed] = {"readings": got, "batches": [
                {"G": st["G"].tolist(), "D": st["D"].tolist(), "losses": st["losses"].tolist()}
                for st in stats[name]]}
            cs.say(f"SWEEP {what} seed {seed}, fault '{name}', {n} batches: " + ", ".join(
                f"{k} {v:.3f}" for k, v in got.items()))
        out.setdefault("loss_keys", stats[next(iter(faults))][0]["loss_keys"])


def sweep(cs, faults, patch, seeds, n, path):
    """The gap rule's readings over many seeds, for choosing and checking
    the rule: n batches of each seed in chip_smoke's train_bf16 setting
    (uniform views, every fault), its triplets setting and phase B's (the
    trained bundle at 256 px), honest only in those two; the readings and
    each batch's statistics written as JSON to path."""
    from shmgan_tpu_torch import quality_train as qt
    from shmgan_tpu_torch.checkpoint import load_inference_bundle
    from shmgan_tpu_torch.data.synthetic import write_triplet_fixture_tree
    from shmgan_tpu_torch.data.triplets import TripletDataset, triplet_to_views
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import sample_draws

    out = {"seeds": list(seeds), "batches": n}
    cfgs = training_config("bfloat16"), training_config("float32")
    states = tuple(create_train_state(c, build_models(c, device="cuda", seed=0)) for c in cfgs)
    v, b, size = cfgs[0].model.c_dim, cfgs[0].train.batch_size, cfgs[0].model.image_size
    _sweep(cs, faults, patch, seeds, n, lambda seed, k: cs._tp_batches(cfgs[0], k, seed=seed)[0],
           cfgs, states, "train", out)

    honest = {"none": faults["none"]}
    with tempfile.TemporaryDirectory() as root:
        write_triplet_fixture_tree(root, b * n * len(seeds), cs.SS_SIZE, seed=7)
        blocks = list(TripletDataset(root, cs.SS_SIZE, batch_size=b * n).iter_epoch(
            shuffle_seed=0))

    def triplets(seed, k):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        block = blocks[list(seeds).index(seed)]
        return [(torch.from_numpy(triplet_to_views(
            {key: a[i * b:(i + 1) * b] for key, a in block.items()})).cuda(),
            sample_draws(cfgs[0], gen, v, b, size, size)) for i in range(k)]
    _sweep(cs, honest, patch, seeds, n, triplets, cfgs, states, "triplets", out)
    del states
    torch.cuda.empty_cache()

    bundle = load_inference_bundle(str(Path(cs.ROOT) / cs.BUNDLE))
    qcfgs = cs._qg_cfg("bfloat16"), cs._qg_cfg("float32")
    s, qb = cs.QG_SIZE, cs.QG_BATCH

    def phase_b(seed, k):
        for i in range(k):
            gen = qt.stream(seed, qt.GAN_STREAM + qb + cs.QG_BATCH_STRIDE * i, "cuda")
            views = qt.sdr.synth_views_batch_dr(gen, qb, s, s, ed_mode="diffuse",
                                                camera_swap_prob=0.25)
            yield views, sample_draws(qcfgs[1], gen, v, qb, s, s)
    _sweep(cs, honest, patch, seeds, n, phase_b, qcfgs,
           tuple(cs._qg_state(c, bundle) for c in qcfgs), "quality_gan", out, step_index=1)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out))
    worst = {what: {name: max(max(r["readings"].values()) for r in per.values())
                    for name, per in out[what].items()} for what in ("train", "triplets",
                                                                      "quality_gan")}
    cs.say(f"SWEEP worst reading over {len(seeds)} seeds of {n} batches: {json.dumps(worst)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train-loop", action="store_true",
                    help="f32 faults against chip_smoke's train_loop phase")
    ap.add_argument("--sweep", type=int, default=0, metavar="N",
                    help="no checks: N batches a seed of the gap rule's raw readings")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(100, 108)))
    ap.add_argument("--out", default="gap_sweep.json")
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    cs.device_phase()
    cs.build_phase()
    if args.sweep:
        faults, patch, restore = _faults(ink, BF16)
        try:
            sweep(cs, faults, patch, args.seeds, args.sweep, args.out)
        finally:
            restore()
        return 0
    if args.train_loop:
        faults, patch, restore = _faults(ink, torch.float32)
        checks = {"train_loop": cs.train_loop_phase}
    else:
        _, f32_outputs = cs.serve_phase()
        faults, patch, restore = _faults(ink, BF16)
        checks = {"autograd": lambda got: autograd_checks(cs, ink, got),
                  "serve_bf16": lambda: cs.serve_phase("bfloat16", f32_outputs),
                  "train_bf16": cs.train_bf16_phase}
    results, readings = {}, {}
    try:
        for name, (where, fn) in faults.items():
            patch(where, fn)
            results[name], readings[name] = {}, {}
            for check, run in checks.items():
                cs.say(f"=== fault '{name}': {check}")
                got = []
                try:
                    with recorded(cs, got):
                        run(got) if check == "autograd" else run()
                    results[name][check] = "passed"
                except AssertionError as e:
                    results[name][check] = "failed"
                    cs.say(f"  {str(e)[:300]}")
                readings[name][check] = {label: [round(r, 4), limit] for label, r, limit in got}
                worst = max(got, key=lambda t: t[1] / t[2], default=None)
                cs.say(f"RESULT fault '{name}': {check} {results[name][check]}" + (
                    f" (worst reading {worst[1]:.3f}, limit {worst[2]}, at {worst[0]})"
                    if worst else ""))
    finally:
        restore()
    cs.say(json.dumps(readings))
    cs.say(json.dumps(results))
    clean = all(r == "passed" for r in results["none"].values())
    caught = all("failed" in results[name].values() for name in faults if name != "none")
    return 0 if clean and caught else 1


if __name__ == "__main__":
    sys.exit(main())
