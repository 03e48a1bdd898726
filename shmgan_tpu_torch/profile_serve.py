"""Serving measurement of the port on one CUDA card.

    python -m shmgan_tpu_torch.profile_serve [--compute_dtype bfloat16|float32]
        [--batch 8] [--size 256]

Builds BatchInferenceEngine at full width on weights from seed 0 (the
committed 256-px bundle's hyperparameters; batch 8 and 256 px unless given)
computing in the given dtype (default bfloat16, the JAX package's default),
then:
  1. times full-batch requests end to end (numpy in, numpy out): first a run
     through the kernels alone, then through the kernels and through their
     plain versions in turns (kernel, plain, plain, kernel, ...), and reports
     images/s and request latency of each;
  2. traces one request with torch.profiler and splits the device time
     (device-side events only) into convolutions, each of the port's
     kernels (instance norm, its backward, and the preprocess cluster
     kernel), copies and everything else, with the device's idle share of the
     request's wall time (which the profiler itself lengthens).
Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch

from shmgan_tpu_torch import Config
from shmgan_tpu_torch.config import COMPUTE_DTYPES
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.ops.kernels import instance_norm as ink
from shmgan_tpu_torch.ops.kernels import preprocess as pre
from shmgan_tpu_torch.serve import BatchInferenceEngine

# device kernel names of the port's kernels, by the key of their share
OUR_KERNELS = {"instance_norm_ms": ("instance_norm_kernel", "instance_norm_fwd_"),
               "instance_norm_backward_ms": ("instance_norm_bwd_", "channel_sums_kernel"),
               "preprocess_ms": ("standardize_yuv",)}
CONV_MARKERS = ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90", "winograd", "fft")
BATCH, SIZE, REQUESTS = 8, 256, 20


def serving_config(compute_dtype: str) -> Config:
    """artifacts/shmgan_infer_256.msgpack.json's hyperparameters, with the
    chroma prior fused into the mask as it is served, computing in
    `compute_dtype`."""
    cfg = Config()
    cfg.model.compute_dtype = compute_dtype
    cfg.model.filter_size = 64
    cfg.model.c_dim = 5
    cfg.model.specseg_base_filters = 16
    cfg.model.specseg_in_channels = 2
    cfg.model.upsample_mode = "resize_conv"
    cfg.eval.mask_chroma_prior = True
    return cfg


@contextmanager
def plain_versions():
    """Route the kernel wrappers (the band entry points of parallel/spatial.py
    too) to their plain versions inside the block."""
    with mock.patch.object(ink, "instance_norm", ink.instance_norm_plain), \
            mock.patch.object(pre, "fused_standardize_yuv", pre.fused_standardize_yuv_plain), \
            mock.patch.object(ink, "instance_norm_band", ink.instance_norm_band_plain), \
            mock.patch.object(pre, "fused_standardize_yuv_band",
                              pre.fused_standardize_yuv_band_plain):
        yield


def _timed(engine, rgb) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.process_images(rgb)
    return time.perf_counter() - t0


PROFILER_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
                       torch.profiler.ProfilerActivity.CUDA]


def device_split(fn):
    """Device time by category for one call of fn, from torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return split_profile(prof, wall_ms)


def split_profile(prof, wall_ms: float):
    """A finished profile's device time by category (convolutions, each of
    the port's kernels, copies, the rest), busy ms and idle share of
    `wall_ms`, and the ten largest device kernels."""
    split = {"conv_ms": 0.0, **{k: 0.0 for k in OUR_KERNELS}, "copy_ms": 0.0,
             "other_ms": 0.0}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops also report the device time of their kernels
        us = ev.self_device_time_total
        if us <= 0:
            continue
        name = ev.key
        low = name.lower()
        ours = [key for key, names in OUR_KERNELS.items() if any(k in name for k in names)]
        if ours:
            split[ours[0]] += us / 1e3
        elif low.startswith(("memcpy", "memset")):
            split["copy_ms"] += us / 1e3
        elif any(k in low for k in CONV_MARKERS):
            split["conv_ms"] += us / 1e3
        else:
            split["other_ms"] += us / 1e3
        top.append((us / 1e3, ev.count, name[:90]))
    busy = sum(split.values())
    if busy == 0:
        return {"device_split": "not measured (the profiler saw no device time)"}
    top.sort(reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms), **split,
            "top_kernels": [dict(ms=ms, count=n, name=k) for ms, n, k in top[:10]]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compute_dtype", choices=sorted(COMPUTE_DTYPES), default="bfloat16")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--size", type=int, default=SIZE)
    args = ap.parse_args()
    batch, size = args.batch, args.size
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")

    cfg = serving_config(args.compute_dtype)
    gen, _, specseg = build_models(cfg, device="cuda", seed=0)
    engine = BatchInferenceEngine(cfg, gen, specseg, batch_size=batch, device="cuda")
    rgb = np.random.default_rng(0).random((batch, size, size, 3), np.float32)
    for _ in range(2):  # warm-up of the kernel path
        engine.process_images(rgb)
    alone = [_timed(engine, rgb) for _ in range(REQUESTS)]
    for _ in range(2):  # warm-up of the plain path
        with plain_versions():
            engine.process_images(rgb)

    times = {"kernels": [], "plain": []}
    for i in range(REQUESTS):
        order = ("kernels", "plain") if i % 2 == 0 else ("plain", "kernels")
        for path in order:
            if path == "plain":
                with plain_versions():
                    times[path].append(_timed(engine, rgb))
            else:
                times[path].append(_timed(engine, rgb))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "compute_dtype": args.compute_dtype, "batch": batch, "size": size,
              "requests_per_path": REQUESTS}
    for path, ts in (("kernels_alone", alone), *times.items()):
        result[f"{path}_request_ms_in_order"] = [round(t * 1e3, 2) for t in ts]
        ts = sorted(ts)
        result[path] = {"median_request_ms": statistics.median(ts) * 1e3,
                        "p90_request_ms": ts[int(0.9 * (len(ts) - 1))] * 1e3,
                        "min_request_ms": ts[0] * 1e3,
                        "images_per_s_at_median": batch / statistics.median(ts)}
    result["kernels_won_pairs"] = sum(k < p for k, p in zip(times["kernels"], times["plain"]))
    result["profile"] = device_split(lambda: engine.process_images(rgb))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
