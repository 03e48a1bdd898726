"""Train-step measurement of the port on one CUDA card.

    python -m shmgan_tpu_torch.profile_train [--compute_dtype bfloat16|float32]
        [--loop | --specseg | --gan | --loop-gap [--gap_views tree|triplets]]

Builds the train state at full width on weights from seed 0 (the JAX
package's default model: 128 px, filter 64, c_dim 5, SpecSeg base 16, batch
8, flip on, reference-parity flags) computing in the given dtype (default
bfloat16, the JAX package's default; float32 with --loop-gap), then:
  1. times steps through the kernels and through their plain versions in
     turns (kernels, plain, plain, kernels, ...), each on a fresh batch and
     fresh draws, and reports the median step ms and images/s (B images a
     step) of each, and the peak device memory of the kernel path;
  2. traces one step with torch.profiler and splits its device time into
     convolutions, each of the port's kernels, copies and everything else,
     with the device's idle share of the step's wall time.
With --loop it measures the steps of the training driver instead
(`train.loop.train` on a tree of synthetic scenes, fed by its
DevicePrefetcher): the host time of every loop step, and a trace of steps
4-8 of the epoch, split as above, from a synchronisation before step 4 to
one after step 8.
With --specseg it measures phase A's SpecSeg step at the flagship trainer's
width (128 px, batch 32, SpecSeg base 16, float32), for the dr2 recipe at 2
input channels and the base recipe at 1: the host ms of 20 steps (a batch
rendered on the card, then make_specseg_train_step), each between two
synchronisations, and traces of 10 steps, of 10 renders alone and of 10
train steps alone on one batch, split as above.
With --gan it measures phase B's step at the flagship trainer's recipe of
the trained 256-px bundle (bf16, 256 px, batch 10, the DR curriculum,
resize_conv, G's EMA, 2-channel SpecSeg; seeded weights): the host ms of
10 steps (the DR views rendered on the card, then the step), each between
two synchronisations, and a trace of 5 steps, split as above.
With --loop-gap it asks why one step's gradients, through the kernels and
through the plain versions, part further on a batch of chip_smoke.py's
than on random inputs (128 px, batch 8, weights from seed 0):
--gap_views tree (the default) takes train_loop's first batch of a
16-scene synthetic tree and its first draws, triplets the `triplets`
phase's views (the first 8 triplets of a 32-triplet tree through
triplet_to_views, where the four view slots hold one image) and draws.
For that batch and for a random one, with cuDNN's algorithm choice as it
is and fixed (cudnn.deterministic): the relative L2 distance of G's and
D's gradients between two runs of one step, kernels against plain, plain
against plain and kernels against kernels, and in bf16 each path against
the plain f32 step; with cuDNN's choice fixed, also the plain version
computing its moments in one pass, E[x^2] - E[x]^2, as the kernel (and
the TPU kernel) does, and instance norms that mix the two (`MIXES`: the
forward's output, the statistics the backward takes, the backward), each
against the plain version and against the kernels; and the
instance-norm planes' largest rstd and the count of planes whose variance
is under 1e-4, for each batch.
Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import tempfile
import time
from unittest import mock

import torch

from shmgan_tpu_torch import Config
from shmgan_tpu_torch.config import COMPUTE_DTYPES
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.profile_serve import (PROFILER_ACTIVITIES, device_split,
                                            plain_versions, split_profile)
from shmgan_tpu_torch.train.state import create_train_state
from shmgan_tpu_torch.train.step import make_train_step, sample_draws

STEPS = 10


def training_config(compute_dtype: str) -> Config:
    """The JAX package's default configuration at batch 8, computing in
    `compute_dtype`."""
    cfg = Config()
    cfg.train.batch_size = 8
    cfg.model.compute_dtype = compute_dtype
    return cfg


LOOP_STEPS = (3, 8)   # steps 4-8 (counted from 1) of a 10-step epoch are traced


def loop_profile(cfg: Config) -> dict:
    """Host ms of each step of one 10-step epoch of train.loop.train, and a
    profile of steps 4-8 (split_profile)."""
    from shmgan_tpu_torch.data.synthetic import write_fixture_tree
    from shmgan_tpu_torch.train import loop

    make = loop.make_train_step
    starts, out = [], {}

    def spied(c, debug_grads=False):
        inner = make(c, debug_grads)

        def step(state, views, draws, epoch):
            n = len(starts)
            if n == LOOP_STEPS[0]:
                torch.cuda.synchronize()
                out["prof"] = torch.profiler.profile(activities=PROFILER_ACTIVITIES)
                out["prof"].__enter__()
                out["t0"] = time.perf_counter()
            starts.append(time.perf_counter())
            result = inner(state, views, draws, epoch)
            if n + 1 == LOOP_STEPS[1]:
                torch.cuda.synchronize()
                out["wall_ms"] = (time.perf_counter() - out["t0"]) * 1e3
                out["prof"].__exit__(None, None, None)
            return result

        return step

    b = cfg.train.batch_size
    with tempfile.TemporaryDirectory() as root:
        write_fixture_tree(os.path.join(root, "tree"), 10 * b, cfg.model.image_size)
        cfg.data.data_dir = os.path.join(root, "tree")
        cfg.train.num_epochs, cfg.train.checkpoint_save_step = 1, 1
        for name in ("checkpoint_save_dir", "log_dir", "model_save_dir"):
            setattr(cfg.train, name, os.path.join(root, name))
        with mock.patch.object(loop, "make_train_step", spied):
            loop.train(cfg, verbose=False)
    step_ms = [(t1 - t0) * 1e3 for t0, t1 in zip(starts, starts[1:])]
    return {"loop_step_ms_in_order": [round(t, 2) for t in step_ms],
            "loop_median_step_ms": statistics.median(step_ms),
            "loop_images_per_s_at_median": b / statistics.median(step_ms) * 1e3,
            "profile_steps": f"{LOOP_STEPS[0] + 1}-{LOOP_STEPS[1]}",
            "profile": split_profile(out["prof"], out["wall_ms"])}


SPECSEG_RECIPES = (("dr2", 2), ("base", 1))


def specseg_profile() -> dict:
    """Host ms and device splits of phase A's step, per recipe."""
    from shmgan_tpu_torch import quality_train as qt
    from shmgan_tpu_torch.train.specseg_train import (create_specseg_state,
                                                      make_specseg_train_step)

    out = {}
    for curriculum, channels in SPECSEG_RECIPES:
        a = qt.parse_args(["--phase", "specseg", "--specseg_curriculum", curriculum,
                           "--specseg_in_channels", str(channels)])
        cfg = qt.build_cfg(a)
        cfg.train.g_lr = a.specseg_lr
        state = create_specseg_state(cfg, torch.Generator().manual_seed(0), "cuda")
        step, batch_fn = make_specseg_train_step(cfg), qt.specseg_batch_fn(a)
        b, s = a.specseg_batch, a.image_size

        def render(i):
            gen = qt.stream(a.seed, i, "cuda")
            return gen, batch_fn(gen, b, s, s)

        def train(i, batch=None):
            nonlocal state
            gen, (img, msk) = batch or render(i)
            state, _ = step(state, img, msk, state.net.sample_keep(gen, b, s, s))

        for i in range(5):
            train(i)
        times = []
        for i in range(5, 25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train(i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fixed = render(99)
        med = statistics.median(times)
        out[f"{curriculum}_{channels}ch"] = {
            "step_ms_in_order": [round(t, 2) for t in times], "median_step_ms": med,
            "images_per_s_at_median": b / med * 1e3,
            "profile_10_steps": device_split(lambda: [train(i) for i in range(100, 110)]),
            "profile_10_renders": device_split(lambda: [render(i) for i in range(110, 120)]),
            "profile_10_steps_one_batch": device_split(
                lambda: [train(i, fixed) for i in range(10)])}
    return out


GAN_RECIPE = ("--phase", "gan", "--image_size", "256", "--batch", "10", "--gan_curriculum",
              "dr", "--upsample_mode", "resize_conv", "--g_ema", "0.999",
              "--specseg_in_channels", "2")


def gan_profile() -> dict:
    """Host ms and a device split of phase B's step (views and step)."""
    from shmgan_tpu_torch import quality_train as qt

    a = qt.parse_args(list(GAN_RECIPE))
    cfg = qt.build_cfg(a)
    state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
    step = make_train_step(cfg)
    v, b, s = cfg.model.c_dim, a.batch, a.image_size

    def train(i):
        nonlocal state
        gen = qt.stream(a.seed, qt.GAN_STREAM + i, "cuda")
        views = qt.sdr.synth_views_batch_dr(gen, b, s, s, ed_mode=a.ed_mode,
                                            camera_swap_prob=a.camera_swap_prob)
        state, _ = step(state, views, sample_draws(cfg, gen, v, b, s, s), 1)

    for i in range(3):
        train(i)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3, 13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    return {"recipe": " ".join(GAN_RECIPE), "step_ms_in_order": [round(t, 2) for t in times],
            "median_step_ms": med, "images_per_s_at_median": b / med * 1e3,
            "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "profile_5_steps": device_split(lambda: [train(i) for i in range(13, 18)])}


LOOP_GAP_SCENES = 16
# (forward output, statistics saved for the backward, backward): "kernel" is
# the CUDA kernel (its one-pass statistics); "two_pass" the mean and
# variance of the JAX package's custom VJP `_fwd`, which the TPU kernel's
# output does not give; "plain" the plain version's output, or the
# backward's plain version (the JAX package's `_bwd`)
MIXES = (("kernel", "two_pass", "kernel"), ("kernel", "kernel", "plain"),
         ("plain", "two_pass", "kernel"), ("plain", "two_pass", "plain"))


class _MixedInstanceNorm(torch.autograd.Function):
    """An instance norm whose forward output, saved statistics and backward
    each come from the kernel or the plain arithmetic (`MIXES`)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, mix):
        from shmgan_tpu_torch.ops.kernels import instance_norm as ink

        fwd, stats, bwd = mix
        y, mean, rstd = ink._forward(x, gamma, beta, eps, with_stats=True)
        if fwd == "plain":
            y = ink.instance_norm_plain(x, gamma, beta, eps)
        if stats == "two_pass":
            xf = x.float()
            mean = xf.mean(dim=(2, 3))
            var = (xf - mean[..., None, None]).square().mean(dim=(2, 3))
            rstd = torch.rsqrt(var + eps)
        ctx.bwd = bwd
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        from shmgan_tpu_torch.ops.kernels import instance_norm as ink

        x, gamma, mean, rstd = ctx.saved_tensors
        fn = ink.instance_norm_backward if ctx.bwd == "kernel" else \
            ink.instance_norm_backward_plain
        dx, dgamma, dbeta = fn(x, gamma, mean, rstd, g.contiguous())
        return dx, dgamma, dbeta, None, None


def _grad_gap(a: dict, b: dict) -> dict:
    """Relative L2 distance of two runs' gradients, each network as one
    vector: ||a - b|| / ||b||."""
    out = {}
    for net in ("G", "D"):
        ga, gb = a["_grads"][net], b["_grads"][net]
        diff = sum(float((ga[k].double() - gb[k].double()).square().sum()) for k in gb)
        norm = sum(float(gb[k].double().square().sum()) for k in gb)
        out[net] = (diff / norm) ** 0.5
    return out


def _gap_batch(cfg: Config, views: str, device: str):
    """(views, draws) of one step of chip_smoke.py's train_loop phase
    ("tree") or triplets phase ("triplets") at `cfg`'s size."""
    from shmgan_tpu_torch.data.loader import PolarimetricDataset
    from shmgan_tpu_torch.data.synthetic import write_fixture_tree, write_triplet_fixture_tree
    from shmgan_tpu_torch.data.triplets import TripletDataset, triplet_to_views
    from shmgan_tpu_torch.train.loop import draw_source

    v, b, s = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
    with tempfile.TemporaryDirectory() as root:
        if views == "tree":
            write_fixture_tree(os.path.join(root, "tree"), LOOP_GAP_SCENES, s, seed=0)
            cfg.data.data_dir = os.path.join(root, "tree")
            batch = next(iter(PolarimetricDataset(cfg.data, s, b).iter_epoch()))
            batch = torch.from_numpy(batch).to(device)
            return batch, draw_source(cfg, device, 0)(0, batch.shape)
        write_triplet_fixture_tree(root, 32, s, seed=7)
        triplets = next(TripletDataset(root, s, batch_size=32).iter_epoch(shuffle_seed=0))
    batch = torch.from_numpy(triplet_to_views({k: a[:b] for k, a in triplets.items()}))
    return batch.to(device), sample_draws(cfg, torch.Generator(device=device).manual_seed(1),
                                          v, b, s, s)


def loop_gap_probe(device="cuda", views="tree", dtype="float32") -> dict:
    """The bare step's gradient gaps on one batch of chip_smoke.py's and on
    a random one (see the module's docstring)."""
    import copy

    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    cfgs = {d: training_config(d) for d in {dtype, "float32"}}
    batch, draws = _gap_batch(cfgs[dtype], views, device)
    batches = {views: batch,
               "random": torch.rand(batch.shape, device=device,
                                    generator=torch.Generator(device=device).manual_seed(0))}
    models = {d: build_models(c, device=device, seed=0) for d, c in cfgs.items()}
    steps = {d: make_train_step(c, debug_grads=True) for d, c in cfgs.items()}
    real_plain = ink.instance_norm_plain
    planes = {}

    def one_pass(x, gamma, beta, eps=1e-6):
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(xf.square().mean(dim=(2, 3), keepdim=True) - mean.square(), min=0.0)
        y = (xf - mean) * torch.rsqrt(var + eps)
        return (y * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)).to(x.dtype)

    def run(x, plain: bool, record: str = "", moments=None, in_dtype=dtype):
        state = create_train_state(cfgs[in_dtype], copy.deepcopy(models[in_dtype]))

        def recorded(x, gamma, beta, eps=1e-6):
            var = x.detach().float().var(dim=(2, 3), unbiased=False)
            planes.setdefault(record, []).append(var.flatten())
            return real_plain(x, gamma, beta, eps)

        with (plain_versions() if plain else contextlib.nullcontext()), \
                (mock.patch.object(ink, "instance_norm", recorded) if record
                 else contextlib.nullcontext()), \
                (mock.patch.object(ink, "instance_norm", moments) if moments
                 else contextlib.nullcontext()):
            _, metrics = steps[in_dtype](state, x, draws, 0)
        return {"_grads": {net: {k: g.detach().clone() for k, g in metrics["_grads"][net].items()}
                           for net in ("G", "D")}}

    out = {}
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        for fixed in (False, True):
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = fixed, False
            for name, x in batches.items():
                k1, p1 = run(x, False), run(x, True, record=name if not fixed else "")
                k2, p2 = run(x, False), run(x, True)
                row = out[f"{name}{'_cudnn_fixed' if fixed else ''}"] = {
                    "kernels_vs_plain": _grad_gap(k1, p1), "plain_vs_plain": _grad_gap(p2, p1),
                    "kernels_vs_kernels": _grad_gap(k2, k1)}
                if dtype != "float32":
                    f32 = run(x, True, in_dtype="float32")
                    row["kernels_vs_f32"], row["plain_vs_f32"] = (_grad_gap(k1, f32),
                                                                  _grad_gap(p1, f32))
                if fixed:
                    row["kernels_vs_plain_one_pass"] = _grad_gap(
                        k1, run(x, True, moments=one_pass))
                    for mix in MIXES:
                        got = run(x, False, moments=lambda x, gamma, beta, eps=1e-6, m=mix:
                                  _MixedInstanceNorm.apply(x, gamma, beta, eps, m))
                        row["/".join(mix)] = {"vs_plain": _grad_gap(got, p1),
                                              "vs_kernels": _grad_gap(got, k1)}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    eps = cfgs[dtype].model.instance_norm_eps
    for name, var in planes.items():
        var = torch.cat(var)
        out[name]["in_planes"] = int(var.numel())
        out[name]["in_max_rstd"] = float(torch.rsqrt(var.min() + eps))
        out[name]["in_planes_var_under_1e-4"] = int((var < 1e-4).sum())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compute_dtype", choices=sorted(COMPUTE_DTYPES), default=None,
                    help="bfloat16 by default; float32 by default with --loop-gap")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--loop", action="store_true",
                      help="measure train.loop.train's steps instead of the bare step")
    mode.add_argument("--specseg", action="store_true",
                      help="measure phase A's SpecSeg step instead of the GAN's")
    mode.add_argument("--gan", action="store_true",
                      help="measure phase B's step at the 256-px recipe, bf16")
    mode.add_argument("--loop-gap", action="store_true",
                      help="the step's gradient gaps on one of chip_smoke.py's batches")
    ap.add_argument("--gap_views", choices=("tree", "triplets"), default="tree",
                    help="--loop-gap's batch: train_loop's first, or the triplets phase's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    args.compute_dtype = args.compute_dtype or ("float32" if args.loop_gap else "bfloat16")
    cfg = training_config(args.compute_dtype)
    if args.loop or args.specseg or args.gan or args.loop_gap:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        head = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
        if args.loop_gap:
            print(json.dumps({**head, "compute_dtype": args.compute_dtype,
                              "views": args.gap_views,
                              **loop_gap_probe(views=args.gap_views, dtype=args.compute_dtype)}))
        elif args.gan:
            print(json.dumps({**head, "compute_dtype": "bfloat16", **gan_profile()}))
        elif args.specseg:
            print(json.dumps({**head, "compute_dtype": "float32", **specseg_profile()}))
        else:
            print(json.dumps({**head, "compute_dtype": args.compute_dtype,
                              "batch": cfg.train.batch_size, **loop_profile(cfg)}))
        return
    v, b, s = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
    state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def timed_step(plain: bool) -> float:
        nonlocal state
        views = torch.rand((v, b, s, s, 3), device="cuda", generator=gen)
        draws = sample_draws(cfg, gen, v, b, s, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plain:
            with plain_versions():
                state, _ = step(state, views, draws, 0)
        else:
            state, _ = step(state, views, draws, 0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for plain in (False, True):  # warm-up of both paths
        timed_step(plain)
    torch.cuda.reset_peak_memory_stats()
    times = {"kernels": [], "plain": []}
    for i in range(STEPS):
        for plain in ((False, True) if i % 2 == 0 else (True, False)):
            times["plain" if plain else "kernels"].append(timed_step(plain))
    peak = torch.cuda.max_memory_allocated()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "compute_dtype": args.compute_dtype, "batch": b,
              "size": s, "steps_per_path": STEPS, "peak_device_memory_gib": peak / 2**30}
    for path, ts in times.items():
        result[f"{path}_step_ms_in_order"] = [round(t * 1e3, 2) for t in ts]
        med = statistics.median(ts)
        result[path] = {"median_step_ms": med * 1e3, "min_step_ms": min(ts) * 1e3,
                        "max_step_ms": max(ts) * 1e3, "images_per_s_at_median": b / med}
    result["kernels_won_pairs"] = sum(k < p for k, p in zip(times["kernels"], times["plain"]))
    result["profile"] = device_split(lambda: timed_step(False))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
