"""Train-step measurement of the port on one CUDA card.

    python -m shmgan_tpu_torch.profile_train [--compute_dtype bfloat16|float32]
        [--loop | --specseg]

Builds the train state at full width on weights from seed 0 (the JAX
package's default model: 128 px, filter 64, c_dim 5, SpecSeg base 16, batch
8, flip on, reference-parity flags) computing in the given dtype (default
bfloat16, the JAX package's default), then:
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
Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compute_dtype", choices=sorted(COMPUTE_DTYPES), default="bfloat16")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--loop", action="store_true",
                      help="measure train.loop.train's steps instead of the bare step")
    mode.add_argument("--specseg", action="store_true",
                      help="measure phase A's SpecSeg step instead of the GAN's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    cfg = training_config(args.compute_dtype)
    if args.loop or args.specseg:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        head = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
        if args.specseg:
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
