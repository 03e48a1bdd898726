"""Smoke run of the PyTorch port on one CUDA card: build, kernels, serving.

    python3 chip_smoke.py

Phases (each prints its name before it starts and its seconds after):
  device   the card's name, count, CUDA version, nvidia-smi's name and power limit;
  build    compiles csrc/*.cu with nvcc (one process per source) and prints
           what ptxas reports;
  kernels  holds each kernel against its plain PyTorch version on the card at
           the shapes the serving path gives it, and times kernel, plain
           version, the library yardstick (IN only) and the memory bound;
  serve    BatchInferenceEngine at full width (the committed 256-px bundle's
           hyperparameters) on seeded random weights serves three requests;
           counts the kernel launches of each, and checks every output against
           the same engine run through the plain versions on the card, and
           against the CPU at a small size.
The last lines are the card's nvidia-smi line, one JSON line of kernel
numbers, and `{"ok": true, "device": {...}}`. Any failure raises and exits
non-zero before the last line. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

# The port computes in float32: TF32 off wherever it is compared with anything.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores (data sheet)

IN_SHAPES = [  # (B, C, H, W) of G's 18 IN sites at 256 px, batch 8; sites per G call
    ((8, 64, 256, 256), 4), ((8, 128, 128, 128), 4), ((8, 256, 64, 64), 4),
    ((8, 512, 32, 32), 4), ((8, 512, 16, 16), 2)]
PRE_SHAPE = (8, 256, 256, 3)
IN_TOL = dict(rtol=1e-4, atol=1e-4)   # one-pass vs two-pass moments, other sum order
PRE_TOL = dict(rtol=1e-5, atol=1e-5)  # same arithmetic, other sum order
SERVE_ATOL = 1e-3                     # kernel path vs plain path, whole engine


def say(*args) -> None:
    print(*args, flush=True)


def phase(name, fn, *args):
    say(f"== phase {name}")
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"== phase {name} done in {time.perf_counter() - t0:.3f} s")
    return out


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    say(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    say(f"nvidia-smi: {smi}")
    return smi


def build_phase():
    from shmgan_tpu_torch.runtime.build import build_all, find_nvcc

    say(f"nvcc: {find_nvcc()}")
    for name, (secs, log) in build_all().items():
        say(f"built {name}.cu in {secs:.2f} s")
        for line in log.splitlines():
            if "ptxas" in line:
                say(f"  {line.strip()}")


def kernels_phase():
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink
    from shmgan_tpu_torch.ops.kernels import preprocess as pre

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    in_total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0)
    in_bound_by = set()
    for shape, sites in IN_SHAPES:
        b, c, h, w = shape
        # post-leaky-relu-like activations: mean and spread comparable
        x = F.leaky_relu(torch.randn(shape, device=dev, generator=g) + 0.5, 0.2)
        gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
        beta = 0.02 * torch.randn(c, device=dev, generator=g)
        y = ink.instance_norm(x, gamma, beta, 1e-6)
        ref = ink.instance_norm_plain(x, gamma, beta, 1e-6)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        ok = torch.allclose(y, ref, **IN_TOL)
        say(f"instance_norm {shape}: max_abs_err={err:.3e} tol rtol={IN_TOL['rtol']} "
            f"atol={IN_TOL['atol']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"instance_norm kernel disagrees at {shape}: {err}")
        iters = 20 if x.numel() > 1 << 24 else 100
        ms = time_ms(lambda: ink.instance_norm(x, gamma, beta, 1e-6), iters)
        plain_ms = time_ms(lambda: ink.instance_norm_plain(x, gamma, beta, 1e-6), iters)
        lib_ms = time_ms(lambda: F.instance_norm(x, weight=gamma, bias=beta, eps=1e-6),
                         iters)
        bms, by = bound(2 * x.numel() * 4 + 2 * c * 4, 5 * x.numel())
        say(f"  ms={ms:.4f} plain_ms={plain_ms:.4f} F.instance_norm_ms={lib_ms:.4f} "
            f"bound_ms={bms:.4f} ({by}) sites_per_G={sites}")
        in_bound_by.add(by)
        rows.append(dict(shape=list(shape), sites_per_g_call=sites, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms))
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bound_ms", bms)):
            in_total[k] += sites * v
        in_total["max_abs_err"] = max(in_total["max_abs_err"], err)
        del x, y, ref

    rgb = torch.rand(PRE_SHAPE, device=dev, generator=g)
    with_zero = rgb.clone()
    with_zero[3] = 0.0
    pre_err = 0.0
    for name, batch in (("random", rgb), ("one all-zero image", with_zero)):
        yuv, scale = pre.fused_standardize_yuv(batch)
        ryuv, rscale = pre.fused_standardize_yuv_plain(batch)
        torch.cuda.synchronize()
        err = max((yuv - ryuv).abs().max().item(), (scale - rscale).abs().max().item())
        ok = (torch.allclose(yuv, ryuv, **PRE_TOL) and torch.allclose(scale, rscale, **PRE_TOL))
        if batch is with_zero:
            ok = ok and scale[3].item() == 1.0 / 256.0 and not yuv[3].any().item()
        say(f"fused_standardize_yuv {PRE_SHAPE} ({name}): max_abs_err={err:.3e} tol "
            f"rtol={PRE_TOL['rtol']} atol={PRE_TOL['atol']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_standardize_yuv kernel disagrees ({name}): {err}")
        pre_err = max(pre_err, err)
    pre_ms = time_ms(lambda: pre.fused_standardize_yuv(rgb), 200)
    pre_plain = time_ms(lambda: pre.fused_standardize_yuv_plain(rgb), 200)
    pre_bound, pre_by = bound(2 * rgb.numel() * 4 + PRE_SHAPE[0] * 4, 25 * rgb.numel() / 3)
    say(f"  ms={pre_ms:.4f} plain_ms={pre_plain:.4f} bound_ms={pre_bound:.4f} ({pre_by})")

    return [
        dict(name="instance_norm", route="cuda",
             source="shmgan_tpu_torch/csrc/instance_norm.cu",
             replaces="shmgan_tpu/ops/pallas/instance_norm.py:197",
             launches=0, max_abs_err=in_total["max_abs_err"], ms=in_total["ms"],
             plain_ms=in_total["plain_ms"], bound_ms=in_total["bound_ms"],
             bound_by="/".join(sorted(in_bound_by)), library_ms=in_total["library_ms"],
             per="the 18 launches of one G call at batch 8, 256 px", shapes=rows),
        dict(name="fused_standardize_yuv", route="cuda",
             source="shmgan_tpu_torch/csrc/preprocess.cu",
             replaces="shmgan_tpu/ops/pallas/preprocess.py:75",
             launches=0, max_abs_err=pre_err, ms=pre_ms, plain_ms=pre_plain,
             bound_ms=pre_bound, bound_by=pre_by, library_ms=None,
             per="one launch at (8, 256, 256, 3)"),
    ]


def _compare(out, ref, label):
    worst = 0.0
    for k in ref:
        err = float(np.abs(out[k] - ref[k]).max())
        unit = k in ("gen_rgb_calibrated", "gen_rgb_composited", "mask")
        tol = SERVE_ATOL if unit else SERVE_ATOL * max(1.0, float(np.abs(ref[k]).max()))
        say(f"  {label} {k}: max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"{label}: {k} differs by {err} > {tol}")
        worst = max(worst, err)
    return worst


def serve_phase(kernel_rows):
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink
    from shmgan_tpu_torch.ops.kernels import preprocess as pre
    from shmgan_tpu_torch.profile_serve import plain_versions, serving_config
    from shmgan_tpu_torch.serve import BatchInferenceEngine

    size, batch = 256, 8
    cfg = serving_config()

    gen, specseg = build_models(cfg, device="cuda", seed=0)
    engine = BatchInferenceEngine(cfg, gen, specseg, batch_size=batch, device="cuda")
    cyclic = BatchInferenceEngine(cfg, gen, specseg, batch_size=batch, with_cyclic=True,
                                  device="cuda")
    say(f"G params={sum(p.numel() for p in gen.parameters())} "
        f"SpecSeg params={sum(p.numel() for p in specseg.parameters())}")

    rng = np.random.default_rng(0)
    requests = [("full batch of 8", engine, rng.random((8, size, size, 3), np.float32), 1),
                ("partial batch of 5", engine, rng.random((5, size, size, 3), np.float32), 1),
                ("full batch of 8, with_cyclic", cyclic,
                 rng.random((8, size, size, 3), np.float32), 2)]
    for _, eng, rgb, _ in requests:  # warm-up: cuDNN's algorithm choice, allocator
        eng.process_images(rgb)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    results, totals = [], {"instance_norm": 0, "fused_standardize_yuv": 0}
    for label, eng, rgb, g_calls in requests:
        ink.launches = 0
        pre.launches = 0
        t0 = time.perf_counter()
        out = eng.process_images(rgb)
        secs = time.perf_counter() - t0
        n_in, n_pre = ink.launches, pre.launches
        say(f"request '{label}': {rgb.shape[0] / secs:.2f} images/s ({secs:.4f} s), "
            f"instance_norm launches={n_in}, fused_standardize_yuv launches={n_pre}")
        if n_in != 18 * g_calls or n_pre != 1:
            raise AssertionError(f"'{label}': expected {18 * g_calls} IN and 1 preprocess "
                                 f"launches, got {n_in} and {n_pre}")
        for k, v in out.items():
            want = ((cfg.model.c_dim,) if k == "cyc_rgb" else ()) + (rgb.shape[0], size, size)
            if v.shape[:-1] != want or not np.isfinite(v).all():
                raise AssertionError(f"'{label}': output {k} has shape {v.shape} "
                                     f"or non-finite values")
        totals["instance_norm"] += n_in
        totals["fused_standardize_yuv"] += n_pre
        results.append(out)
    say(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # the same engine through the plain versions (kernels not launched)
    with plain_versions():
        ink.launches = pre.launches = 0
        for (label, eng, rgb, _), out in zip(requests, results):
            _compare(out, eng.process_images(rgb), f"kernels vs plain, '{label}':")
        if ink.launches or pre.launches:
            raise AssertionError("plain run launched a kernel")

    # the card against the CPU (plain versions) on a small input, same weights
    small = rng.random((2, 64, 64, 3), np.float32)
    on_card = BatchInferenceEngine(cfg, gen, specseg, batch_size=2,
                                   device="cuda").process_images(small)
    on_cpu = BatchInferenceEngine(cfg, copy.deepcopy(gen).cpu(), copy.deepcopy(specseg).cpu(),
                                  batch_size=2, device="cpu").process_images(small)
    _compare(on_card, on_cpu, "card vs CPU, 64 px:")

    for row in kernel_rows:
        row["launches"] = totals[row["name"]]


def main() -> int:
    current = "device"
    try:
        smi = phase("device", device_phase)
        current = "build"
        phase("build", build_phase)
        current = "kernels"
        rows = phase("kernels", kernels_phase)
        current = "serve"
        phase("serve", serve_phase, rows)
    except Exception:
        traceback.print_exc()
        say(f"chip_smoke FAILED in phase {current}")
        return 1
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
