"""Smoke run of the PyTorch port on one CUDA card: build, kernels, serving.

    python3 chip_smoke.py

Phases (each prints its name before it starts and its seconds after):
  device   the card's name, count, CUDA version, nvidia-smi's name and power limit;
  build    compiles csrc/*.cu with nvcc (one process per source) and prints
           what ptxas reports;
  kernels  holds each kernel against its plain PyTorch version on the card at
           the shapes the serving path gives it (the preprocess kernel also
           in both its variants, at both cluster sizes, on an unaligned input,
           and call against call, bit for bit), and times kernel, plain
           version, the library yardstick (IN only) and the memory bound. A
           kernel has two times: `ms`, back to back with the wrapper's host
           cost, and `device_ms`, its own time from CUDA-graph replays; the
           preprocess kernel also `device_cold_ms`, with L2 flushed first;
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
PRE_STREAM_SHAPE = (2, 640, 640, 3)   # too large for a cluster's shared memory
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
    """ms per call, back to back between two CUDA events: the wrapper's host
    cost is inside whenever it exceeds the kernel's device time."""
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


def device_ms(fn, calls: int = 100, replays: int = 5) -> float:
    """The kernels' own time per call: `calls` calls captured in one CUDA graph
    (after a warm-up that loads and configures every library), its replays
    timed with CUDA events. The host is not in the way; L2 is warm."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def device_cold_ms(fn, reps: int = 30) -> float:
    """Median ms of one call timed alone, after a 256 MB write that evicts the
    50 MB L2. The write takes longer than the host needs to enqueue the call,
    so the events time the device, not the host."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del flush
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def share(bound_ms: float, ms: float) -> str:
    """The bound as a share of a time; above 100 % only when L2 serves the bytes."""
    pct = 100.0 * bound_ms / ms
    return f"{pct:.1f} % of bound" + (" (above 100 %: L2)" if pct > 100.0 else "")


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


def instance_norm_row(dev, g):
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    rows = []
    total = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                 library_device_ms=0.0, bound_ms=0.0, max_abs_err=0.0)
    bound_by = set()
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
        del y, ref
        iters = 20 if x.numel() > 1 << 24 else 100
        kernel = lambda: ink.instance_norm(x, gamma, beta, 1e-6)  # noqa: E731
        library = lambda: F.instance_norm(x, weight=gamma, bias=beta, eps=1e-6)  # noqa: E731
        ms = time_ms(kernel, iters)
        dev_ms = device_ms(kernel, iters)
        plain_ms = time_ms(lambda: ink.instance_norm_plain(x, gamma, beta, 1e-6), iters)
        lib_ms = time_ms(library, iters)
        lib_dev_ms = device_ms(library, iters)
        bms, by = bound(2 * x.numel() * 4 + 2 * c * 4, 5 * x.numel())
        say(f"  ms={ms:.4f} ({share(bms, ms)}) device_ms={dev_ms:.4f} "
            f"({share(bms, dev_ms)}) plain_ms={plain_ms:.4f} F.instance_norm_ms={lib_ms:.4f} "
            f"F.instance_norm_device_ms={lib_dev_ms:.4f} bound_ms={bms:.4f} ({by}) "
            f"sites_per_G={sites}")
        bound_by.add(by)
        rows.append(dict(shape=list(shape), sites_per_g_call=sites, max_abs_err=err, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library_device_ms=lib_dev_ms, bound_ms=bms))
        for k, v in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                     ("library_ms", lib_ms), ("library_device_ms", lib_dev_ms),
                     ("bound_ms", bms)):
            total[k] += sites * v
        total["max_abs_err"] = max(total["max_abs_err"], err)
        del x
    say(f"instance_norm per G call: ms={total['ms']:.4f} ({share(total['bound_ms'], total['ms'])}) "
        f"device_ms={total['device_ms']:.4f} ({share(total['bound_ms'], total['device_ms'])}) "
        f"F.instance_norm_device_ms={total['library_device_ms']:.4f} "
        f"bound_ms={total['bound_ms']:.4f}")
    return dict(name="instance_norm", route="cuda",
                source="shmgan_tpu_torch/csrc/instance_norm.cu",
                replaces="shmgan_tpu/ops/pallas/instance_norm.py:197",
                launches=0, max_abs_err=total["max_abs_err"], ms=total["ms"],
                device_ms=total["device_ms"], plain_ms=total["plain_ms"],
                bound_ms=total["bound_ms"], bound_by="/".join(sorted(bound_by)),
                library_ms=total["library_ms"],
                library_device_ms=total["library_device_ms"],
                per="the 18 launches of one G call at batch 8, 256 px", shapes=rows)


def preprocess_checks(dev, g):
    """Both variants and both cluster sizes against the plain version; the
    all-zero image exactly; repeat calls bit for bit. Returns the worst error."""
    from shmgan_tpu_torch.ops.kernels import preprocess as pre

    b, h, w, _ = PRE_SHAPE
    cases = [
        (PRE_SHAPE, "planned", pre._plan(b, h, w)),
        (PRE_SHAPE, "resident, clusters of 16", pre._plan(b, h, w, cluster=16)),
        (PRE_SHAPE, "streaming, 4 tiles a block",
         pre.Plan("streaming", 16, 4096, 1024, 1024 * 12)),
        ((1, 256, 256, 3), "planned", pre._plan(1, 256, 256)),
        ((1, 512, 512, 3), "planned", pre._plan(1, 512, 512)),
        (PRE_STREAM_SHAPE, "planned", pre._plan(*PRE_STREAM_SHAPE[:3])),
        ((3, 17, 31, 3), "planned, odd H*W", pre._plan(3, 17, 31)),
        (PRE_SHAPE, "planned, input 4 bytes past an aligned base", pre._plan(b, h, w)),
    ]
    worst = 0.0
    for shape, label, plan in cases:
        n = int(np.prod(shape))
        if "4 bytes past" in label:
            x = torch.rand(n + 1, device=dev, generator=g)[1:].view(shape)
        else:
            x = torch.rand(shape, device=dev, generator=g)
        x[-1] = 0.0  # the all-zero image: scale exactly 1/256, output exactly 0
        if label.startswith("planned"):
            assert pre._plan(*shape[:3]) == plan
            yuv, scale = pre.fused_standardize_yuv(x)
            yuv2, scale2 = pre.fused_standardize_yuv(x)
        else:
            yuv, scale = pre._launch(x, plan)
            yuv2, scale2 = pre._launch(x, plan)
        ryuv, rscale = pre.fused_standardize_yuv_plain(x)
        torch.cuda.synchronize()
        err = max((yuv - ryuv).abs().max().item(), (scale - rscale).abs().max().item())
        close = torch.allclose(yuv, ryuv, **PRE_TOL) and torch.allclose(scale, rscale, **PRE_TOL)
        zero = scale[-1].item() == 1.0 / 256.0 and not yuv[-1].any().item()
        same = torch.equal(yuv, yuv2) and torch.equal(scale, scale2)
        say(f"fused_standardize_yuv {shape} {label} ({plan.variant}, K={plan.cluster}, "
            f"{plan.smem_bytes} B a block): max_abs_err={err:.3e} tol rtol={PRE_TOL['rtol']} "
            f"atol={PRE_TOL['atol']} {'ok' if close else 'FAIL'}; all-zero image "
            f"{'exact' if zero else 'FAIL'}; repeat {'bit-identical' if same else 'FAIL'}")
        if not (close and zero and same):
            raise AssertionError(f"fused_standardize_yuv {shape} {label}: err={err} "
                                 f"zero={zero} repeat={same}")
        worst = max(worst, err)
        del x, yuv, yuv2, ryuv
    return worst


def preprocess_row(dev, g):
    from shmgan_tpu_torch.ops.kernels import preprocess as pre

    pre_err = preprocess_checks(dev, g)
    clusters = []
    for k in (16, 8):
        for b in (PRE_SHAPE[0], 1):
            plan = pre._plan(b, 256, 256, cluster=k)
            x = torch.rand((b, 256, 256, 3), device=dev, generator=g)
            dms = device_ms(lambda: pre._launch(x, plan))
            active = pre.max_active_clusters(plan)
            say(f"fused_standardize_yuv ({b}, 256, 256, 3) K={k} ({plan.variant}, "
                f"{plan.smem_bytes} B a block): max active clusters={active} "
                f"device_ms={dms:.5f}")
            clusters.append(dict(batch=b, cluster=k, variant=plan.variant,
                                 smem_bytes=plan.smem_bytes, max_active_clusters=active,
                                 device_ms=dms))
    shapes = []
    for shape in (PRE_SHAPE, (1, 256, 256, 3), PRE_STREAM_SHAPE):
        x = torch.rand(shape, device=dev, generator=g)
        plan = pre._plan(*shape[:3])
        ms = time_ms(lambda: pre.fused_standardize_yuv(x), 200)
        dms = device_ms(lambda: pre.fused_standardize_yuv(x))
        cold = device_cold_ms(lambda: pre.fused_standardize_yuv(x))
        plain_ms = time_ms(lambda: pre.fused_standardize_yuv_plain(x), 50)
        bms, by = bound(2 * x.numel() * 4 + shape[0] * 4, 25 * x.numel() / 3)
        say(f"fused_standardize_yuv {shape} ({plan.variant}, K={plan.cluster}): "
            f"ms={ms:.5f} ({share(bms, ms)}) device_ms={dms:.5f} ({share(bms, dms)}) "
            f"device_cold_ms={cold:.5f} ({share(bms, cold)}) plain_ms={plain_ms:.4f} "
            f"bound_ms={bms:.5f} ({by})")
        shapes.append(dict(shape=list(shape), variant=plan.variant, cluster=plan.cluster,
                           ms=ms, device_ms=dms, device_cold_ms=cold, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by))
        del x
    head = {k: v for k, v in shapes[0].items() if k not in ("shape", "variant", "cluster")}
    return dict(name="fused_standardize_yuv", route="cuda",
                source="shmgan_tpu_torch/csrc/preprocess.cu",
                replaces="shmgan_tpu/ops/pallas/preprocess.py:75",
                launches=0, max_abs_err=pre_err, **head, library_ms=None,
                per="one launch at (8, 256, 256, 3)", shapes=shapes, clusters=clusters)


def kernels_phase():
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    return [instance_norm_row(dev, g), preprocess_row(dev, g)]


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
