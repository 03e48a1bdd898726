"""Smoke run of the PyTorch port on one CUDA card: build, kernels, serving,
training, in float32 and in bfloat16 (the JAX package's default compute
dtype).

    python3 chip_smoke.py

Phases (each prints its name before it starts and its seconds after):
  device      the card's name, count, CUDA version, nvidia-smi's name and
              power limit, and utils.device's report;
  build       compiles csrc/*.cu with nvcc (one process per source) and prints
              what ptxas reports;
  kernels     holds each kernel against its plain PyTorch version on the card
              at the shapes its path gives it: the IN forward at the serving
              shapes, the IN backward (and the forward with its stats) at every
              IN shape of the train step (repeat calls bit for bit), each with
              f32 and with bf16 activations, and autograd through the kernels
              (the path the models take) against autograd through the plain
              version at those shapes; the backward's plan (variant, threads,
              blocks per SM) at each shape, its streaming variant at one larger
              shape and its packed and resident variants on unaligned storage,
              checked the same way; the preprocess kernel in both its
              variants, at both cluster sizes, on an unaligned input, at the
              native path's bucket (2, 640, 832, 3) (streaming, timed too), and
              call against call, bit for bit. It times kernel, plain version, the
              library yardstick (F.instance_norm's forward, and its backward
              through a retained graph, in the same dtype) and the memory
              bound. A kernel has three times: `ms`, back to back with the
              wrapper's host cost, `device_ms`, its own time from CUDA-graph
              replays (L2 warm), and `device_cold_ms`, one call alone with L2
              flushed first;
  serve       BatchInferenceEngine at full width in f32 (the committed 256-px
              bundle's hyperparameters) on seeded random weights serves three
              requests; counts the kernel launches of each, times five more,
              and checks every output against the same engine run through the
              plain versions on the card, and against the CPU at a small size;
  serve_bf16  the same in bf16: launches, times, and each output of the kernel
              path no further (relative L2) from the plain path's than the
              plain path's is from the f32 phase's output of that request;
  bundle      artifacts/shmgan_infer_256.msgpack (the trained 256-px weights)
              read by the port's reader: leaf count and shapes against the
              models, written back by the port's writer bit for bit and
              exported from the loaded models bit for bit; then serve and
              serve_bf16's three requests on those weights and on seeded
              scenes with highlights (the card against the CPU at batch 2,
              256 px), and the b8 bf16 request timed with every output and
              with outputs=("gen_rgb_calibrated", "mask"), in turns;
  serve_native process_images_native on the bundle at a square, a
              non-square and a 612x816 photo (bucket 640x832: the preprocess
              kernel's streaming variant, recorded launch by launch), f32 and
              bf16: launches, each output against the plain versions, ms per
              shape;
  formats     every committed codec fixture (tests/data/torch_codecs/: JPEG
              baseline, progressive, subsampled, restart, greyscale, odd
              sizes and two photos; GIF; 16-bit and Adam7 PNG; 16-bit and
              maxval-100 P6; palette and RLE8 BMP) decoded on the host
              against PIL's pixels (the PNG beside it), exactly, with the
              decode ms of each beside the PNG decode of the same pixels;
              the 612x816 and 2048x1536 JPEG photos through
              process_images_native on the bundle in f32 and bf16
              (launches, each output against the plain versions, the
              612x816 bucket's streaming preprocess, ms);
  serve_http  `python -m shmgan_tpu_torch.cli --mode serve` on the bundle as a
              subprocess (batch 8, a 20 ms window): /healthz by a deadline,
              PNGs at size=256 with each output=, at size=native, resized
              from 612x816, the 612x816 JPEG fixture at size=256 and
              size=native and a GIF fixture, each within one level of an
              in-process engine's pixels (of PIL's pixels for a JPEG or
              GIF); host decode ms of the JPEG and GIF bodies; 16
              concurrent requests in fewer device calls than requests;
              request ms and requests/s; the server's kernel
              launches from /stats; host PNG and resize ms. The server is
              terminated in any case;
  serve_folder process_folder and watch_folder(max_iterations=3), square and
              native, on ten PNGs and every JPEG, GIF, 16-bit PNG and BMP
              fixture: the files written, their shapes, the square job's
              pixels against process_images', launches;
  data_parallel two ranks of one gloo group on the one card (NCCL refuses
              two ranks on one device), each a process running dp_rank: the
              fused step at the JAX defaults (128 px, filter 64, global batch
              8, 4 a rank, the same draws) in f32 and bf16, each rank's
              launches exactly (46, 28, 1), the ranks' parameters bit for
              bit, the f32 step against one rank's on the global batch by
              _compare_step, two-rank step ms beside one rank's; cli --mode
              train --data_parallel 1 under a one-rank NCCL group (2 steps,
              a checkpoint), then --mode export; the bundle's engine with
              data_parallel=2 on ["cuda:0", "cuda:0"] in f32 and bf16, each
              output within SERVE_ATOL of the one-device engine at the
              shard's batch, 2 x (18, 1) launches a request, request ms
              beside the one-device engine at batch 8;
  model_parallel a 1 x 2 mesh (tensor parallelism) of two gloo ranks on
              the one card, each a process running tp_rank: the seeded
              state cut to each rank's slices at the JAX defaults (128 px,
              filter 64, batch 8, tp_min_channels 256), one counted step in
              f32 and four in bf16, each rank's launches exactly (46, 28,
              1), the leaves whole on both ranks bit for bit; the
              gathered f32 step against one rank's by _compare_step; the
              bf16 steps against the same steps computed in one process
              with every cut block run as its two slices (within
              TP_SPLIT_RTOL), through the kernels against themselves
              through the plain versions (GAP_C) and against one rank's
              (TP_GAP_C); the IN
              kernels against their plain versions at every other shape
              the step gave them (the channel slices, G1's batch); a timed
              step over gloo beside one rank's; train.loop.train for 2
              steps on a 16-scene tree and its checkpoint restored on one
              rank, equal to the ranks' gathered state bit for bit;
  spatial     a 1 x 2 spatial mesh (H over the model axis, every parameter
              whole) of two gloo ranks on the one card, each a process
              running sp_rank on its band of 64 of the 128 rows at the JAX
              defaults (filter 64, batch 8): one counted step in f32 and
              four in bf16, each rank's launches exactly 92 band IN
              forward kernels, 56 band backward kernels and 2 band
              preprocess kernels (46, 28 and 1 calls of two launches each),
              the parameters on both ranks bit for bit; the f32 step against
              one rank's by _compare_step; the bf16 steps against the same
              steps computed band by band in one process
              (spatial.split_compute, TP_SPLIT_RTOL), through the kernels
              against the plain versions (GAP_C), and against one rank's
              (a reading); the band IN kernels against their plain versions
              at every band shape of the step with flat planes (their
              backward held, with the plain version's, against float64
              within its rounding of the plane's mean), the band
              preprocess against its plain and the whole-image versions;
              each rank's peak memory beside one rank's whole step at 128
              px and, in bf16, at 256 px; step ms over gloo beside one
              rank's; train.loop.train for 2 steps and its checkpoint
              restored on one rank bit for bit; the band entry points timed
              through a one-rank row for the kernels line;
  train       the fused train step at full width in f32 (the JAX package's
              default model: 128 px, filter 64, batch 8) on seeded weights: one
              step through the kernels against the same step through the plain
              versions (every gradient leaf and every loss), the launches of
              each kernel in a step, ten more steps (median step ms, images/s,
              peak device memory), one K = 3 make_scan_train_steps call, and
              the card against the CPU on one step at batch 2;
  train_bf16  the same step in bf16 on four random batches: through the
              kernels against the plain versions, G's and D's gradients and
              the losses no further apart, over the four, than the plain
              bf16 step is from the f32 step on the same weights and draws;
              the launches of a step; ten timed steps;
  triplets    a triplet tree at 128 px (write_triplet_fixture_tree,
              TripletDataset): specseg_pairs card vs CPU, one SpecSeg step at
              b32 on the pairs card vs CPU, one GAN step at the JAX defaults
              on triplet_to_views' stack in bf16 on four batches and in f32
              on one (launches exactly (46, 28, 1) each; f32 kernels vs
              plain by LOOP_MOMENT_RTOL; bf16 by the gap rule);
  train_loop  train.loop.train in f32 on a 16-scene synthetic tree, 2 epochs
              of 2 steps, from one set of seeded models, through the kernels
              and through the plain versions: launches (exactly 4 steps'),
              every batch the feed handed a step against the dataset's,
              bit for bit, the optimizers' first moments after step 1
              (LOOP_MOMENT_RTOL), each net's parameters and first moments
              after step 4 and every metrics row (step 1 within LOSS_RTOL; later rows) by
              the gap rule against the plain loop from weights moved by lr;
  train_cli   the command line in bf16 on a 40-scene tree: --mode train (10
              steps, launches, loop step ms beside train_bf16's bare step),
              a resume to epoch 3 (the restored state against checkpoint 10
              bit for bit), SIGTERM to a --mode train subprocess after its
              first metrics row (exit 0, a checkpoint at the step reached,
              max_to_keep), --mode export (the bundle against the
              checkpoint), --mode test with metrics on 8 camera images of
              the tree (24 PNGs, one preprocess launch), --mode test on a
              folder of every JPEG and GIF fixture (three PNGs each), and
              serving_models without a bundle answering one request;
  specseg_train the flagship trainer's phase A, f32: one SpecSeg train step
              on the card against one on the CPU (dr2 at 2 channels, batch
              32, 128 px, base 16; the optimizer's first moment, batch
              statistics, metrics); both
              curricula's renders on the card against the CPU on the same
              draws (base, the GAN's views, dr3 with every texture family);
              quality_train.main --phase specseg at that width, about 30 s
              each (fixed step counts), the shipped bundle's recipe (dr2, 2 channels) and base at
              1 channel: steps, steps/s, images/s, peak memory, the first and
              last chunk's loss (the last below the first), the selected
              snapshot's probe score against the untrained net's on the same
              probe (above it), no kernel launched; the dr2 export reloaded
              with its channels read from the file and served through
              make_mask_fn (one preprocess launch); cli --mode train for 2
              steps on it (exactly 2 x (46, 28, 1) launches);
  quality_gan the flagship trainer's phase B at the trained 256-px bundle's
              recipe (bf16, batch 10, the DR curriculum, resize_conv, G's
              EMA at 0.999, 2-channel SpecSeg): one step at 256 px, b10,
              through the kernels against the plain versions by the gap
              rule, and one in f32 at b2 by the train step's rule (the IN
              backward's streaming variant in both dtypes); one oracle chunk
              (8 images, f32) on the card against the CPU; then
              quality_train.main --phase gan warm-started from the bundle
              (its SpecSeg written as the frozen net's file) for QG_STEPS
              steps with two evals of 3 draws of 64 images: launches exactly
              QG_STEPS x (46, 46, 1) in training (G1 is live in this recipe,
              so its 18 IN sites have a backward too) and draws x 8 x (18, 1)
              f32 an eval, the backward's streaming launches counted; step
              ms, images/s, peak memory, seconds an eval and in its FIDs; the
              first eval beats the identity; best_bundle.msgpack reloaded and
              serving one request;
  keras_h5    the reference's Keras SpecSeg, tests/data/torch_h5/
              specseg_keras2.h5 (base 16, 1 channel, seeded), read through
              load_specseg_weights: sha256, each leaf's shape, sum and sum
              of squares as its README states, exactly, and the read s;
              cli --mode train --specseg_weights on it (a subprocess, bf16,
              the JAX defaults, 2 steps): launches exactly 2 x (46, 28, 1),
              the checkpoint's SpecSeg bit for bit the file's; --mode
              export, the bundle served at b8, 256 px in f32 through the
              kernels against the plain versions (SERVE_ATOL), (18, 1)
              launches; utils/profiling's trace() and annotate() around a
              bf16 train step (CUDA kernel events of the IN forward, IN
              backward and preprocess kernels, the region), its (46, 28, 1)
              launches, device_memory_stats(), debug_mode(nans=True) on a
              CUDA NaN; save_dataset_hdf5 of the served gen_rgb read back
              through runtime/hdf5.py bit for bit; the times beside the
              card's name and power limit.
The card against the CPU is compared in f32 only: bf16 rounds at other places
there, and bf16 convolutions at full width are slow on a CPU.
The last lines are the card's nvidia-smi line, one JSON line of kernel
numbers, and `{"ok": true, "device": {...}}`. Any failure raises and exits
non-zero before the last line. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import copy
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import nullcontext
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

# TF32 off wherever float32 is compared with anything.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores (data sheet)

IN_SHAPES = [  # (B, C, H, W) of G's 18 IN sites at 256 px, batch 8; sites per G call
    ((8, 64, 256, 256), 4), ((8, 128, 128, 128), 4), ((8, 256, 64, 64), 4),
    ((8, 512, 32, 32), 4), ((8, 512, 16, 16), 2)]
# (B, C, H, W) of the train step's IN sites at 128 px, batch 8, and their
# count in one step: the cyclic G pass (5B), live D (2B), frozen D (10B)
TRAIN_IN_SHAPES = [
    ((40, 64, 128, 128), 4), ((40, 128, 64, 64), 4), ((40, 256, 32, 32), 4),
    ((40, 512, 16, 16), 4), ((40, 512, 8, 8), 2),
    ((16, 64, 64, 64), 1), ((16, 128, 32, 32), 1), ((16, 256, 16, 16), 1),
    ((16, 512, 8, 8), 1), ((16, 1024, 4, 4), 1),
    ((80, 64, 64, 64), 1), ((80, 128, 32, 32), 1), ((80, 256, 16, 16), 1),
    ((80, 512, 8, 8), 1), ((80, 1024, 4, 4), 1)]

# an IN backward shape above the resident limit, in both dtypes: the
# streaming variant, checked but not counted in the per-step sums
IN_STREAM_SHAPE = (2, 16, 256, 256)
# IN backward shapes checked on storage one element past an aligned base
# (packed and resident variants)
IN_UNALIGNED_SHAPES = [(16, 512, 8, 8), (16, 64, 64, 64)]

ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLE = "artifacts/shmgan_infer_256.msgpack"   # the trained 256-px weights
# photo shapes of serve_native: square, not square, and one whose bucket
# (640x832) is too large for a cluster's shared memory (the streaming variant)
NATIVE_SHAPES = [(256, 256), (300, 452), (612, 816)]

# the committed codec fixtures (tests/data/torch_codecs/): each file beside
# <name>.png, the pixels PIL's convert("RGB") gives for it
CODEC_DIR = os.path.join(ROOT, "tests", "data", "torch_codecs")
CODEC_FIXTURES = 26
FORMAT_PHOTOS = ("photo_612x816.jpg", "photo_2048x1536.jpg")
# serve_folder's extra inputs: every JPEG and GIF fixture, the 16-bit PNGs, the BMPs
FOLDER_FORMATS = (".jpg", ".gif", "16.png", ".bmp")

PRE_SHAPE = (8, 256, 256, 3)
PRE_STREAM_SHAPE = (2, 640, 640, 3)   # too large for a cluster's shared memory
PRE_TRAIN_SHAPE = (40, 128, 128, 3)   # the train step's 5 views of 8 images
PRE_NATIVE_SHAPE = (2, 640, 832, 3)   # serve_native's 612x816 bucket: the streaming variant
IN_TOL = dict(rtol=1e-4, atol=1e-4)   # one-pass vs two-pass moments, other sum order
# bf16 activations (y, dx): kernel and plain version round the same f32
# formula, computed in another order, so within one bf16 ulp (rtol 2^-7),
# plus the f32 kernel's own atol for values near 0, where a bf16 ulp is finer
# than the f32 difference
IN_TOL_BF16 = dict(rtol=2.0 ** -7, atol=1e-4)
IN_PARAM_TOL_BF16 = dict(rtol=1e-3, atol=1e-3)  # dgamma, dbeta (f32) of bf16 activations
# bf16 paths, kernels vs plain versions: each output, each network's gradients
# and the losses no further apart (relative L2) than GAP_C times the plain
# bf16 path's own distance from f32. On an H100 the two bf16 paths, which
# differ only in where an IN output rounds, read 0.23-0.90 of that distance;
# an IN backward whose dx is 1.01 times too large reads 1.09 on G's
# gradients (shmgan_tpu_torch/plant_faults.py)
GAP_C = 1.0
# a bf16 train step's gap, its losses above all, is held over this many
# batches at once. One batch is one draw of bf16 rounding noise that the
# nets amplify: one build of the kernels read the losses' ratio at 1.265,
# 0.600, 0.785 and 0.894 on four random batches (H100); a kernel fault
# moves every batch alike, so pooling keeps it as large
STEP_GAP_BATCHES = 4
PRE_TOL = dict(rtol=1e-5, atol=1e-5)  # same arithmetic, other sum order
# a flat plane's backward (mean 50, spread 0.1) against float64: any f32
# arithmetic rounds the plane's mean, by a few ulps of its largest |x| (the
# kernels' per-thread Welford and Chan's merge, the plain versions' sums),
# and xhat carries that error times rstd (10) everywhere on the plane; each
# side is held within its tolerance plus the first-order error of a mean
# FLAT_ULPS ulps off (in_reference_f64)
FLAT_ULPS = 16
SERVE_ATOL = 1e-3                     # kernel path vs plain path, whole engine
# train step, kernel path vs plain path and card vs CPU: G's and D's gradients
# as a whole within 2e-3 (L2, relative), each leaf within 2.5e-1 of its own
# largest magnitude (a conv bias feeding leaky_relu then IN has a gradient
# that is the residue of a cancelling sum: f32 rounding moved such leaves by
# up to 7.4e-2 of their scale on the card; a wrong or missing gradient path
# moves a leaf by ~1), every loss within 1e-4 (relative)
GRAD_NORM_RTOL, GRAD_LEAF_RTOL, LOSS_RTOL = 2e-3, 2.5e-1, 1e-4


def in_reference_f64(x, gamma, beta, dy, eps=1e-6):
    """IN of (B, C, H, W) x in float64: (y, dx, dgamma, dbeta) for the
    output gradient dy, and the errors (of dx (B, C, H, W), of dgamma (C,))
    that a plane's mean off by FLAT_ULPS f32 ulps of the plane's largest
    |x| gives them at most: xhat is then off by e = FLAT_ULPS * ulp * rstd
    over the whole plane, so dgamma by e |sum(g)| (added over the batch)
    and dx by rstd |gamma| e (|sum(g xhat)| + (|xhat| + e) |sum(g)|) / n."""
    xd, gd = x.double(), dy.double()
    gm, bt = gamma.double()[:, None, None], beta.double()[:, None, None]
    n = x.shape[2] * x.shape[3]
    mean = xd.mean((2, 3), keepdim=True)
    rstd = torch.rsqrt((xd - mean).square().mean((2, 3), keepdim=True) + eps)
    xhat = (xd - mean) * rstd
    sg, sgx = gd.sum((2, 3), keepdim=True), (gd * xhat).sum((2, 3), keepdim=True)
    dx = rstd / n * (n * gm * gd - gm * sg - xhat * gm * sgx)
    top = xd.abs().amax((2, 3), keepdim=True)
    ulp = torch.finfo(torch.float32).eps * torch.exp2(torch.floor(torch.log2(top)))
    e = FLAT_ULPS * ulp * rstd
    dx_err = rstd * gm.abs() * e * (sgx.abs() + (xhat.abs() + e) * sg.abs()) / n
    return ((xhat * gm + bt, dx, (gd * xhat).sum((0, 2, 3)), gd.sum((0, 2, 3))),
            (dx_err, (e * sg.abs()).sum((0, 2, 3))))


def _in_name(dtype, kind="forward"):
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    return ink.kernel_name(kind, dtype)


def step_launches(dtype):
    """Launches of one train step computing in `dtype`, by kernel, in the
    reference-parity mode: IN forwards in G1 (18), the cyclic G (18), live and
    frozen D (5 + 5); IN backwards in all but G1, whose params are stopped."""
    return {**{k: 0 for k in _launch_counts()}, _in_name(dtype): 46,
            _in_name(dtype, "backward"): 28, "fused_standardize_yuv": 1}


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


def device_ms(fn, calls: int = 100, replays: int = 5, stream=None) -> float:
    """The kernels' own time per call: `calls` calls captured in one CUDA graph
    (after a warm-up that loads and configures every library), its replays
    timed with CUDA events. The host is not in the way; L2 is warm. `stream`
    is the capture stream (default: a side stream of the graph's own)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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
    from shmgan_tpu_torch.utils.device import print_device_report

    print_device_report()
    return smi


def build_phase():
    from shmgan_tpu_torch.runtime.build import build_all, find_nvcc

    say(f"nvcc: {find_nvcc()}")
    for name, (secs, log) in build_all().items():
        say(f"built {name}.cu in {secs:.2f} s")
        for line in log.splitlines():
            if "ptxas" in line:
                say(f"  {line.strip()}")


def instance_norm_row(dev, g, dtype=torch.float32):
    """The IN forward at the serving shapes, activations in `dtype`."""
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    name = _in_name(dtype)
    tol = IN_TOL if dtype == torch.float32 else IN_TOL_BF16
    rows = []
    keys = ("ms", "device_ms", "device_cold_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms")
    total = dict.fromkeys(keys, 0.0)
    bound_by, worst = set(), 0.0
    for shape, sites in IN_SHAPES:
        b, c, h, w = shape
        # post-leaky-relu-like activations: mean and spread comparable
        x = F.leaky_relu(torch.randn(shape, device=dev, generator=g) + 0.5, 0.2).to(dtype)
        gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
        beta = 0.02 * torch.randn(c, device=dev, generator=g)
        y = ink.instance_norm(x, gamma, beta, 1e-6).float()
        ref = ink.instance_norm_plain(x, gamma, beta, 1e-6).float()
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        ok = torch.allclose(y, ref, **tol)
        say(f"{name} {shape}: max_abs_err={err:.3e} tol rtol={tol['rtol']:.3g} "
            f"atol={tol['atol']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} kernel disagrees at {shape}: {err}")
        del y, ref
        iters = 20 if x.numel() > 1 << 24 else 100
        kernel = lambda: ink.instance_norm(x, gamma, beta, 1e-6)  # noqa: E731
        library = lambda: F.instance_norm(x, weight=gamma, bias=beta, eps=1e-6)  # noqa: E731
        bms, by = bound(2 * x.numel() * x.element_size() + 2 * c * 4, 5 * x.numel())
        row = dict(ms=time_ms(kernel, iters), device_ms=device_ms(kernel, iters),
                   device_cold_ms=device_cold_ms(kernel),
                   plain_ms=time_ms(lambda: ink.instance_norm_plain(x, gamma, beta, 1e-6),
                                    iters),
                   library_ms=time_ms(library, iters),
                   library_device_ms=device_ms(library, iters), bound_ms=bms)
        say(f"  ms={row['ms']:.4f} ({share(bms, row['ms'])}) device_ms={row['device_ms']:.4f} "
            f"({share(bms, row['device_ms'])}) device_cold_ms={row['device_cold_ms']:.4f} "
            f"({share(bms, row['device_cold_ms'])}) plain_ms={row['plain_ms']:.4f} "
            f"F.instance_norm_ms={row['library_ms']:.4f} "
            f"F.instance_norm_device_ms={row['library_device_ms']:.4f} bound_ms={bms:.4f} "
            f"({by}) sites_per_G={sites}")
        bound_by.add(by)
        worst = max(worst, err)
        rows.append(dict(shape=list(shape), sites_per_g_call=sites, max_abs_err=err, **row))
        for k in keys:
            total[k] += sites * row[k]
        del x
    say(f"{name} per G call: ms={total['ms']:.4f} ({share(total['bound_ms'], total['ms'])}) "
        f"device_ms={total['device_ms']:.4f} ({share(total['bound_ms'], total['device_ms'])}) "
        f"device_cold_ms={total['device_cold_ms']:.4f} "
        f"({share(total['bound_ms'], total['device_cold_ms'])}) "
        f"F.instance_norm_device_ms={total['library_device_ms']:.4f} "
        f"bound_ms={total['bound_ms']:.4f}")
    return dict(name=name, route="cuda", dtype=str(dtype).split(".")[-1],
                source="shmgan_tpu_torch/csrc/instance_norm.cu",
                replaces="shmgan_tpu/ops/pallas/instance_norm.py:197",
                launches=0, max_abs_err=worst, **total, bound_by="/".join(sorted(bound_by)),
                per="the 18 launches of one G call at batch 8, 256 px", shapes=rows)


def library_backward_ms(x, gamma, beta, dy, iters):
    """F.instance_norm's backward, torch.autograd.grad through a retained
    graph: (ms, device_ms). The forward is recorded on a side stream, so its
    backward runs there, and the CUDA graph captures on that stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, gamma, beta)]
        y = F.instance_norm(leaves[0], weight=leaves[1], bias=leaves[2], eps=1e-6)
        fn = lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)  # noqa: E731
        ms = time_ms(fn, iters)
        dms = device_ms(fn, iters, stream=side)
    torch.cuda.current_stream().wait_stream(side)
    return ms, dms


def _autograd_check(ink, name, shape, x, gamma, beta, dy, tols):
    """Autograd through `instance_norm` (the kernels, as the models call them:
    the forward saves its mean and rstd, the backward takes a cotangent in
    the output's dtype) against autograd through the plain version: y, dx
    (x's dtype), dgamma and dbeta (float32). Returns the worst error."""
    got, ref = [], []
    for fn, out in ((ink.instance_norm, got), (ink.instance_norm_plain, ref)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, gamma, beta)]
        y = fn(*leaves, 1e-6)
        out.extend([y.detach(), *torch.autograd.grad(y, leaves, dy)])
    torch.cuda.synchronize()
    want = [x.dtype, x.dtype, torch.float32, torch.float32]
    if [t.dtype for t in got] != want or [t.dtype for t in ref] != want:
        raise AssertionError(f"{name} autograd {shape}: dtypes {[t.dtype for t in got]}, "
                             f"plain {[t.dtype for t in ref]}, expected {want}")
    err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
    ok = all(torch.allclose(a.float(), r.float(), **t) for a, r, t in zip(got, ref, tols))
    say(f"{name} autograd {shape}: max_abs_err={err:.3e} (y, dx, dgamma, dbeta) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: autograd through the kernels disagrees at {shape}: {err}")
    return err


def _backward_check(ink, name, shape, x, gamma, beta, dy, tol, ptol):
    """The forward with its stats against the plain forward; the backward
    kernel from those stats against its plain version, a repeat call bit for
    bit; autograd through the kernels against the plain version. Returns
    (worst error, mean, rstd)."""
    dtype = x.dtype
    y, mean, rstd = ink._forward(x, gamma, beta, 1e-6, with_stats=True)
    y = y.float()
    ref_y = ink.instance_norm_plain(x, gamma, beta, 1e-6).float()
    fwd_err = (y - ref_y).abs().max().item()
    ok_fwd = torch.allclose(y, ref_y, **tol)
    say(f"{_in_name(dtype)} {shape} (with stats): max_abs_err={fwd_err:.3e} "
        f"{'ok' if ok_fwd else 'FAIL'}")
    if not ok_fwd:
        raise AssertionError(f"{_in_name(dtype)} forward disagrees at {shape}: {fwd_err}")
    del y, ref_y
    got = ink.instance_norm_backward(x, gamma, mean, rstd, dy)
    again = ink.instance_norm_backward(x, gamma, mean, rstd, dy)
    ref = ink.instance_norm_backward_plain(x, gamma, mean, rstd, dy)
    torch.cuda.synchronize()
    if got[0].dtype != dtype or ref[0].dtype != dtype or got[1].dtype != torch.float32:
        raise AssertionError(f"{name}: dtypes {[t.dtype for t in got]}")
    err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
    ok = all(torch.allclose(a.float(), r.float(), **t)
             for a, r, t in zip(got, ref, (tol, ptol, ptol)))
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    say(f"{name} {shape}: max_abs_err={err:.3e} (dx, dgamma, dbeta) "
        f"tol dx rtol={tol['rtol']:.3g} atol={tol['atol']}, dgamma/dbeta "
        f"rtol={ptol['rtol']} atol={ptol['atol']} {'ok' if ok else 'FAIL'}; "
        f"repeat {'bit-identical' if same else 'FAIL'}")
    if not (ok and same):
        raise AssertionError(f"{name} disagrees at {shape}: err={err} repeat={same}")
    del got, again, ref
    err = max(err, _autograd_check(ink, name, shape, x, gamma, beta, dy,
                                   (tol, tol, ptol, ptol)))
    return err, mean, rstd


def _in_inputs(dev, g, shape, dtype, unaligned=False):
    """x (post-leaky-relu-like: mean and spread comparable), gamma, beta, dy;
    with `unaligned`, x and dy are views one element past an aligned base."""
    k, n = int(unaligned), int(np.prod(shape))
    x = F.leaky_relu(torch.randn(n + k, device=dev, generator=g) + 0.5, 0.2).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(shape[1], device=dev, generator=g)
    beta = 0.02 * torch.randn(shape[1], device=dev, generator=g)
    dy = torch.randn(n + k, device=dev, generator=g).to(dtype)
    return x[k:].view(shape), gamma, beta, dy[k:].view(shape)


def _backward_extra_checks(ink, name, dev, dtype, tol, ptol):
    """The backward's streaming variant at IN_STREAM_SHAPE, and its packed and
    resident variants on unaligned storage, each checked as the train shapes
    are (_backward_check), on draws of their own generator (the other rows'
    inputs stay those of earlier versions of this script). Returns the worst
    error."""
    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = [(IN_STREAM_SHAPE, False, "streaming")] + [
        (s, True, None) for s in IN_UNALIGNED_SHAPES]
    for shape, unaligned, want in cases:
        b, c, h, w = shape
        plan = ink._bwd_plan(b, c, h * w, dtype)
        if want is not None and plan.variant != want:
            raise AssertionError(f"{name} {shape}: plan {plan}, expected {want}")
        x, gamma, beta, dy = _in_inputs(dev, g, shape, dtype, unaligned)
        if unaligned and (x.data_ptr() % 16 == 0 or dy.data_ptr() % 16 == 0):
            raise AssertionError(f"{name} {shape}: inputs are 16-byte aligned")
        say(f"{name} {shape} plan: {plan.variant}"
            f"{', x and dy one element past an aligned base' if unaligned else ''}")
        worst = max(worst, _backward_check(ink, name, shape, x, gamma, beta, dy, tol, ptol)[0])
        del x, dy
    return worst


def instance_norm_backward_row(dev, g, dtype=torch.float32):
    """The IN backward at every IN shape of the train step, activations in
    `dtype`: its plan, against its plain version (from the forward kernel's
    own mean and rstd), repeat calls bit for bit, autograd through the kernels
    against autograd through the plain version, and timed; the forward (with
    its stats) checked and its device time beside it. Then the streaming
    variant and unaligned storage (_backward_extra_checks), not timed."""
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    name = _in_name(dtype, "backward")
    # (y and dx, dgamma and dbeta)
    tol, ptol = (IN_TOL, IN_TOL) if dtype == torch.float32 else (IN_TOL_BF16, IN_PARAM_TOL_BF16)

    rows = []
    keys = ("ms", "device_ms", "device_cold_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "forward_device_ms")
    total = dict.fromkeys(keys, 0.0)
    bound_by, worst = set(), 0.0
    for shape, sites in TRAIN_IN_SHAPES:
        b, c, h, w = shape
        x, gamma, beta, dy = _in_inputs(dev, g, shape, dtype)
        plan = ink._bwd_plan(b, c, h * w, dtype)
        per_sm = ink.blocks_per_sm(plan, dtype)
        say(f"{name} {shape} plan: {plan.variant}, {plan.lanes} threads a plane, "
            f"{plan.threads} a block, cluster {plan.cluster}, {per_sm} blocks per SM")
        err, mean, rstd = _backward_check(ink, name, shape, x, gamma, beta, dy, tol, ptol)
        worst = max(worst, err)
        iters = 10 if x.numel() > 1 << 24 else 50
        kernel = lambda: ink.instance_norm_backward(x, gamma, mean, rstd, dy)  # noqa: E731
        lib_ms, lib_dev_ms = library_backward_ms(x, gamma, beta, dy, iters)
        bms, by = bound(3 * x.numel() * x.element_size() + (2 * b * c + 3 * c) * 4,
                        10 * x.numel())
        row = dict(ms=time_ms(kernel, iters), device_ms=device_ms(kernel, iters),
                   device_cold_ms=device_cold_ms(kernel),
                   plain_ms=time_ms(lambda: ink.instance_norm_backward_plain(
                       x, gamma, mean, rstd, dy), iters),
                   library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=bms,
                   forward_device_ms=device_ms(
                       lambda: ink.instance_norm(x, gamma, beta, 1e-6), iters))
        say(f"  ms={row['ms']:.4f} ({share(bms, row['ms'])}) device_ms={row['device_ms']:.4f} "
            f"({share(bms, row['device_ms'])}) device_cold_ms={row['device_cold_ms']:.4f} "
            f"({share(bms, row['device_cold_ms'])}) plain_ms={row['plain_ms']:.4f} "
            f"F.instance_norm_backward_ms={lib_ms:.4f} "
            f"F.instance_norm_backward_device_ms={lib_dev_ms:.4f} bound_ms={bms:.4f} ({by}) "
            f"forward_device_ms={row['forward_device_ms']:.4f} sites_per_step={sites}")
        bound_by.add(by)
        rows.append(dict(shape=list(shape), sites_per_step=sites, variant=plan.variant,
                         threads=plan.threads, cluster=plan.cluster, blocks_per_sm=per_sm,
                         max_abs_err=err, **row))
        for k in keys:
            total[k] += sites * row[k]
        del x, dy
    worst = max(worst, _backward_extra_checks(ink, name, dev, dtype, tol, ptol))
    say(f"{name} per train step: ms={total['ms']:.4f} "
        f"device_ms={total['device_ms']:.4f} ({share(total['bound_ms'], total['device_ms'])}) "
        f"device_cold_ms={total['device_cold_ms']:.4f} "
        f"({share(total['bound_ms'], total['device_cold_ms'])}) "
        f"F.instance_norm_backward_device_ms={total['library_device_ms']:.4f} "
        f"bound_ms={total['bound_ms']:.4f}; the forward's 28 matching launches "
        f"device_ms={total['forward_device_ms']:.4f}")
    return dict(name=name, route="cuda", dtype=str(dtype).split(".")[-1],
                source="shmgan_tpu_torch/csrc/instance_norm.cu",
                replaces="shmgan_tpu/ops/pallas/instance_norm.py:225",
                launches=0, max_abs_err=worst, **total, bound_by="/".join(sorted(bound_by)),
                per="the 28 backward launches of one train step at batch 8, 128 px",
                shapes=rows)


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
        (PRE_TRAIN_SHAPE, "planned, the train step's V*B views", pre._plan(*PRE_TRAIN_SHAPE[:3])),
        (PRE_NATIVE_SHAPE, "planned, the native path's bucket", pre._plan(*PRE_NATIVE_SHAPE[:3])),
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
    for shape in (PRE_SHAPE, (1, 256, 256, 3), PRE_STREAM_SHAPE, PRE_TRAIN_SHAPE,
                  PRE_NATIVE_SHAPE):
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
    # the f32 rows first: their inputs are then the same draws in every
    # version of this script, so their errors compare across commits
    return [instance_norm_row(dev, g), instance_norm_backward_row(dev, g),
            preprocess_row(dev, g), instance_norm_row(dev, g, torch.bfloat16),
            instance_norm_backward_row(dev, g, torch.bfloat16)]


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


def _gap_check(label, kernels, plain, f32, limit=GAP_C):
    """One output of a bf16 path (arrays, flattened here) through the kernels
    and through the plain versions: ||kernels - plain|| <= limit ||plain -
    f32|| (limit GAP_C unless given), relative L2 to the f32 output of the
    same input. The limit comes from the plain path and the f32 path
    alone."""
    k, p, f = (np.asarray(t, np.float64).ravel() for t in (kernels, plain, f32))
    ref = max(np.linalg.norm(f), 1e-300)
    d_kp, d_pf = np.linalg.norm(k - p) / ref, np.linalg.norm(p - f) / ref
    say(f"  {label}: ||kernels - plain||={d_kp:.3e}, ||plain - f32||={d_pf:.3e} (relative "
        f"L2), ratio {d_kp / max(d_pf, 1e-300):.3f} (limit {limit})")
    if not d_kp <= limit * d_pf:
        raise AssertionError(f"{label}: kernels vs plain {d_kp} > {limit} x plain vs f32 "
                             f"{d_pf}")


def serve_phase(compute_dtype="float32", f32_outputs=None, bundle=None):
    """Three requests at full width through the kernels, counted, against the
    same requests through the plain versions: in f32 within SERVE_ATOL, and
    against the CPU; in bf16 by the gap to `f32_outputs`, the f32 phase's
    outputs of the same requests. On seeded weights and uniform noise, or,
    given a bundle (load_inference_bundle's triple), on its weights and on
    seeded scenes with highlights (the CPU comparison then at batch 2, 256
    px). Returns (launches, outputs)."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_serve import plain_versions, serving_config
    from shmgan_tpu_torch.serve import BatchInferenceEngine

    size, batch = 256, 8
    cfg = serving_config(compute_dtype)
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(0)
    if bundle is None:
        gen, _, specseg = build_models(cfg, device="cuda", seed=0)
        weights = "seeded weights"

        def draw(n, s=size):
            return rng.random((n, s, s, 3), np.float32)
        small_size = 64
    else:
        gen, specseg = bundle_models(cfg, bundle)
        weights = f"trained bundle (step {bundle[2]['step']})"

        def draw(n, s=size):
            return scenes(n, s, s, rng)
        small_size = size
    engine = BatchInferenceEngine(cfg, gen, specseg, batch_size=batch, device="cuda")
    cyclic = BatchInferenceEngine(cfg, gen, specseg, batch_size=batch, with_cyclic=True,
                                  device="cuda")
    say(f"compute dtype {compute_dtype}, {weights}; G params="
        f"{sum(p.numel() for p in gen.parameters())} "
        f"SpecSeg params={sum(p.numel() for p in specseg.parameters())}")

    requests = [("full batch of 8", engine, draw(8), 1),
                ("partial batch of 5", engine, draw(5), 1),
                ("full batch of 8, with_cyclic", cyclic, draw(8), 2)]
    for _, eng, rgb, _ in requests:  # warm-up: cuDNN's algorithm choice, allocator
        eng.process_images(rgb)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    results = []
    totals = {k: 0 for k in _launch_counts()}
    in_name = _in_name(dtype)
    for label, eng, rgb, g_calls in requests:
        _launch_counts(reset=True)
        t0 = time.perf_counter()
        out = eng.process_images(rgb)
        secs = time.perf_counter() - t0
        counts = _launch_counts(reset=True)
        want = {**{k: 0 for k in totals}, in_name: 18 * g_calls,
                "fused_standardize_yuv": 1}
        say(f"request '{label}': {rgb.shape[0] / secs:.2f} images/s ({secs:.4f} s), "
            f"{in_name} launches={counts[in_name]}, fused_standardize_yuv "
            f"launches={counts['fused_standardize_yuv']}")
        if counts != want:
            raise AssertionError(f"'{label}': launches {counts}, expected {want}")
        for k, v in out.items():
            shape = ((cfg.model.c_dim,) if k == "cyc_rgb" else ()) + (rgb.shape[0], size, size)
            if v.shape[:-1] != shape or not np.isfinite(v).all():
                raise AssertionError(f"'{label}': output {k} has shape {v.shape} "
                                     f"or non-finite values")
        for k in totals:
            totals[k] += counts[k]
        results.append(out)
    say(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    rgb = requests[0][2]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.process_images(rgb)
        times.append(time.perf_counter() - t0)
    _launch_counts(reset=True)
    med = float(np.median(times))
    say(f"full batch of 8, {compute_dtype}, {weights}: median request {med * 1e3:.2f} ms "
        f"({batch / med:.2f} images/s) over {len(times)} requests")

    # the same engine through the plain versions (kernels not launched)
    with plain_versions():
        for i, ((label, eng, rgb, _), out) in enumerate(zip(requests, results)):
            plain = eng.process_images(rgb)
            if f32_outputs is None:
                _compare(out, plain, f"kernels vs plain, '{label}':")
            else:
                for k in plain:
                    _gap_check(f"kernels vs plain, '{label}': {k}", out[k], plain[k],
                               f32_outputs[i][k])
        if any(_launch_counts(reset=True).values()):
            raise AssertionError("plain run launched a kernel")

    if dtype == torch.float32:
        # the card against the CPU (plain versions) at batch 2, same weights
        small = draw(2, small_size)
        on_card = BatchInferenceEngine(cfg, gen, specseg, batch_size=2,
                                       device="cuda").process_images(small)
        on_cpu = BatchInferenceEngine(cfg, copy.deepcopy(gen).cpu(),
                                      copy.deepcopy(specseg).cpu(), batch_size=2,
                                      device="cpu").process_images(small)
        _launch_counts(reset=True)
        _compare(on_card, on_cpu, f"card vs CPU, {small_size} px:")
    return totals, results


def scenes(n, h, w, rng):
    """n smooth (h, w) scenes with three bright, near-white highlights each:
    float32 in [0, 1], from `rng`."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    imgs = []
    for _ in range(n):
        base = rng.uniform(0.15, 0.6, 3)[None, None] * (0.6 + 0.4 * xx[..., None])
        for _ in range(3):
            cy, cx = rng.uniform(0.2, 0.8) * h / max(h, w), rng.uniform(0.2, 0.8) * w / max(h, w)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.004)[..., None]
            base = base + (0.95 - base) * blob
        imgs.append(base + 0.02 * rng.standard_normal((h, w, 3)))
    return np.clip(np.stack(imgs), 0, 1).astype(np.float32)


def bundle_models(cfg, bundle, device="cuda"):
    """(G, SpecSeg) on `device` with a bundle's weights; the bundle's header
    sets cfg.model's hyperparameters."""
    from shmgan_tpu_torch.checkpoint import model_config
    from shmgan_tpu_torch.convert import load_inference_weights
    from shmgan_tpu_torch.models import build_models

    g_params, specseg_vars, header = bundle
    cfg.model = model_config(cfg.model, header)
    gen, _, specseg = build_models(cfg, device="cpu")
    load_inference_weights(gen, specseg, g_params, specseg_vars)
    return gen.to(device), specseg.to(device)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _sum_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def bundle_phase():
    """The trained 256-px bundle read with the port's reader: its leaves
    against the models' tensors, one for one, shape for shape; written back
    by the port's writer (and exported from the loaded models) bit for bit;
    then served (serve_phase) in f32 and bf16, and the b8 bf16 request timed
    with every output and with the two the folder job writes. Returns
    (launches, the bundle)."""
    import tempfile

    from shmgan_tpu_torch.checkpoint import export_inference_bundle, load_inference_bundle
    from shmgan_tpu_torch.convert import flax_tree
    from shmgan_tpu_torch.profile_serve import serving_config
    from shmgan_tpu_torch.runtime import flax_msgpack

    path = os.path.join(ROOT, BUNDLE)
    data = _read(path)
    t0 = time.perf_counter()
    bundle = load_inference_bundle(path)
    secs = time.perf_counter() - t0
    g_params, specseg_vars, header = bundle
    leaves = list(_leaves(g_params)) + list(_leaves(specseg_vars))
    say(f"{BUNDLE}: {len(data)} bytes, read in {secs:.3f} s; header {header}; "
        f"{len(leaves)} leaves, {sum(v.size for v in leaves)} values, dtypes "
        f"{sorted({str(v.dtype) for v in leaves})}")
    cfg = serving_config("float32")
    # strict: each leaf fills one tensor of its own shape (convert.load_flax)
    gen, specseg = bundle_models(cfg, bundle, device="cpu")
    want = [v.shape for m in (gen, specseg) for tree in flax_tree(m) for v in _leaves(tree)]
    if sorted(v.shape for v in leaves) != sorted(want) or header["image_size"] != 256:
        raise AssertionError(f"bundle leaves {len(leaves)} do not match the models' "
                             f"{len(want)} tensors (or the header is not 256 px)")
    raw = flax_msgpack.loads(data)
    if flax_msgpack.dumps(raw) != data:
        raise AssertionError("the port's writer does not give back the bundle's bytes")
    with tempfile.TemporaryDirectory() as tmp:
        copy_path = os.path.join(tmp, "bundle.msgpack")
        export_inference_bundle(gen, specseg, cfg, copy_path, header["step"],
                                header.get("store_dtype"))
        with open(copy_path, "rb") as f:
            same = f.read() == data
        with open(copy_path + ".json") as f, open(path + ".json") as g:
            same_header = json.load(f) == json.load(g)
    say(f"round trip: reader -> writer bit-identical; reader -> models -> "
        f"export_inference_bundle {'bit-identical' if same else 'FAIL'}, header "
        f"{'equal' if same_header else 'FAIL'}")
    if not (same and same_header):
        raise AssertionError("the exported bundle differs from the file it was read from")
    del raw, gen, specseg

    f32_counts, f32_outputs = serve_phase("float32", bundle=bundle)
    bf16_counts, _ = serve_phase("bfloat16", f32_outputs, bundle=bundle)
    outputs_timing(bundle)
    return _sum_counts(f32_counts, bf16_counts), bundle


def outputs_timing(bundle):
    """The b8 bf16 request with every output and with outputs=
    ("gen_rgb_calibrated", "mask"), in turns."""
    from shmgan_tpu_torch.profile_serve import serving_config
    from shmgan_tpu_torch.serve import BatchInferenceEngine

    cfg = serving_config("bfloat16")
    gen, specseg = bundle_models(cfg, bundle)
    engines = {"all six": BatchInferenceEngine(cfg, gen, specseg, batch_size=8),
               "calibrated+mask": BatchInferenceEngine(
                   cfg, gen, specseg, batch_size=8,
                   outputs=("gen_rgb_calibrated", "mask"))}
    rgb = scenes(8, 256, 256, np.random.default_rng(3))
    for eng in engines.values():
        eng.process_images(rgb)
    times = {k: [] for k in engines}
    for i in range(16):
        order = list(engines) if i % 2 == 0 else list(engines)[::-1]
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[k].process_images(rgb)
            times[k].append((time.perf_counter() - t0) * 1e3)
    _launch_counts(reset=True)
    for k, ts in times.items():
        say(f"b8 bf16 request, outputs {k}: median {np.median(ts):.2f} ms, p90 "
            f"{np.percentile(ts, 90):.2f} ms, min {min(ts):.2f} ms over {len(ts)} (in turns)")
    for eng in engines.values():
        eng.close()


def _native_runs(bundle, images, batch_size, calls, label, after):
    """process_images_native on the trained bundle over `images` (batch
    `batch_size`, `calls` device calls), in f32, then in bf16: launches
    counted (18 IN forwards and one preprocess a call), the preprocess
    variant of each launch recorded, every output finite at its image's
    shape and held against the same run through the plain versions (f32
    within SERVE_ATOL, bf16 by the gap to the f32 outputs); then
    after(engine, compute_dtype, [(launch shape, variant)]). Returns the
    launches of both runs, summed."""
    from shmgan_tpu_torch.ops.kernels import preprocess as pre
    from shmgan_tpu_torch.profile_serve import plain_versions, serving_config
    from shmgan_tpu_torch.serve import BatchInferenceEngine

    totals, f32_outs = [], None
    for compute_dtype in ("float32", "bfloat16"):
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
        cfg = serving_config(compute_dtype)
        gen, specseg = bundle_models(cfg, bundle)
        eng = BatchInferenceEngine(cfg, gen, specseg, batch_size=batch_size,
                                   native_resolution=True)
        eng.process_images_native(images)  # warm-up
        torch.cuda.synchronize()
        plans, launch = [], pre._launch

        def spy(rgb, plan):
            plans.append((tuple(rgb.shape), plan.variant))
            return launch(rgb, plan)

        _launch_counts(reset=True)
        with mock.patch.object(pre, "_launch", spy):
            outs = eng.process_images_native(images)
        torch.cuda.synchronize()
        counts = _launch_counts(reset=True)
        want = {**{k: 0 for k in counts}, _in_name(dtype): 18 * calls,
                "fused_standardize_yuv": calls}
        say(f"{label} {compute_dtype}: launches {counts}; preprocess launches {plans}")
        if counts != want:
            raise AssertionError(f"{label} launches {counts}, expected {want}")
        for img, out in zip(images, outs):
            for k, v in out.items():
                if v.shape[:2] != img.shape[:2] or not np.isfinite(v).all():
                    raise AssertionError(f"{label} {k}: shape {v.shape} for an image of "
                                         f"{img.shape}, or non-finite values")
        with plain_versions():
            plain = eng.process_images_native(images)
        if any(_launch_counts(reset=True).values()):
            raise AssertionError(f"the plain {label} run launched a kernel")
        for i, (img, out, ref) in enumerate(zip(images, outs, plain)):
            tag = f"kernels vs plain, {label} {img.shape[0]}x{img.shape[1]} #{i}"
            if f32_outs is None:
                _compare(out, ref, tag + ":")
            else:
                for k in ref:
                    _gap_check(f"{tag}: {k}", out[k], ref[k], f32_outs[i][k])
        after(eng, compute_dtype, plans)
        _launch_counts(reset=True)
        eng.close()
        totals.append(counts)
        f32_outs = outs
    return _sum_counts(*totals)


def serve_native_phase(bundle):
    """_native_runs at NATIVE_SHAPES, two images each (batch 2): the largest
    bucket, and it alone, takes the streaming preprocess; ms per shape."""
    from shmgan_tpu_torch.infer import bucket_shape

    rng = np.random.default_rng(2)
    images = [img for h, w in NATIVE_SHAPES for img in scenes(2, h, w, rng)]
    big = (2,) + bucket_shape(*NATIVE_SHAPES[-1]) + (3,)

    def after(eng, compute_dtype, plans):
        streamed = [s for s, v in plans if v == "streaming"]
        if streamed != [big]:
            raise AssertionError(f"expected exactly {big} to take the streaming variant: {plans}")
        for j, (h, w) in enumerate(NATIVE_SHAPES):
            pair = images[2 * j:2 * j + 2]
            ts = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.process_images_native(pair)
                ts.append((time.perf_counter() - t0) * 1e3)
            say(f"serve_native {compute_dtype} {h}x{w} (bucket {bucket_shape(h, w)}), batch 2: "
                f"median {np.median(ts):.2f} ms ({2e3 / np.median(ts):.2f} images/s), min "
                f"{min(ts):.2f} ms over {len(ts)}")

    return _native_runs(bundle, images, 2, len(NATIVE_SHAPES), "native", after)


def codec_fixtures():
    """{name: (the fixture's bytes, the bytes of the PNG of PIL's pixels)},
    sorted by name."""
    names = sorted(f for f in os.listdir(CODEC_DIR)
                   if os.path.isfile(os.path.join(CODEC_DIR, f + ".png")))
    if len(names) != CODEC_FIXTURES:
        raise AssertionError(f"{len(names)} codec fixtures, expected {CODEC_FIXTURES}")
    return {n: (_read(os.path.join(CODEC_DIR, n)), _read(os.path.join(CODEC_DIR, n + ".png")))
            for n in names}


def formats_phase(bundle):
    """Every committed codec fixture decoded on the host by data/codecs.py
    against PIL's pixels (its PNG, read by the port's PNG decoder), exactly;
    decode ms of each beside the PNG decode of the same pixels; then the two
    largest photos, one a call, through process_images_native on the
    trained bundle in f32 and in bf16 (_native_runs: launches, outputs held
    against the plain versions), the 612x816 photo's preprocess streaming;
    ms each."""
    from shmgan_tpu_torch.data.codecs import decode
    from shmgan_tpu_torch.data.loader import to_unit

    decoded, wrong = {}, []
    for name, (data, ref) in codec_fixtures().items():
        reps = 2 if len(data) > 100_000 else 5
        got, want = decode(data), decode(ref)
        dec = [_timed_ms(lambda: decode(data)) for _ in range(reps)]
        png = [_timed_ms(lambda: decode(ref)) for _ in range(reps)]
        same = got.shape == want.shape and np.array_equal(got, want)
        diff = "" if same else (
            f"; DIFFERS: max {int(np.abs(got.astype(int) - want).max())} levels at "
            f"{float((got != want).mean()):.2e} of values" if got.shape == want.shape
            else f"; DIFFERS: shape {got.shape} vs {want.shape}")
        say(f"decode {name} ({len(data)} bytes, {got.shape[0]}x{got.shape[1]}): median "
            f"{np.median(dec):.2f} ms over {reps}; the PNG of the same pixels ({len(ref)} "
            f"bytes) {np.median(png):.2f} ms; {'equal to PIL' if same else ''}{diff}")
        if not same:
            wrong.append(name)
        decoded[name] = got
    if wrong:
        raise AssertionError(f"fixtures decoded otherwise than PIL: {wrong}")

    images = [to_unit(decoded[n]) for n in FORMAT_PHOTOS]

    def after(eng, compute_dtype, plans):
        if plans[0] != ((1, 640, 832, 3), "streaming"):
            raise AssertionError(f"the 612x816 photo took {plans[0]}, not the streaming variant")
        for name, img in zip(FORMAT_PHOTOS, images):
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.process_images_native([img])
                ts.append((time.perf_counter() - t0) * 1e3)
            say(f"formats {name} {compute_dtype}: process_images_native median "
                f"{np.median(ts):.2f} ms over 3")

    return _native_runs(bundle, images, 1, len(images), "formats", after)


def _http(url, body=None, timeout=120):
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers["Content-Type"], r.read()


def serve_http_phase():
    """`python -m shmgan_tpu_torch.cli --mode serve` on the trained bundle as
    a subprocess (batch 8, a 20 ms window): /healthz within a deadline; PNGs
    made by the port's encoder from seeded scenes POSTed at size=256 with
    each output=, at size=native, and resized from 612x816, and the 612x816
    JPEG fixture (at size=256 and size=native) and a GIF fixture; each
    response's pixels within one level of an in-process engine's on the
    same decoded input (for a JPEG or GIF, PIL's pixels); the host decode
    ms of the JPEG and GIF bodies; 16 concurrent requests in fewer device calls than requests;
    request ms and requests/s; the server's own kernel launches (/stats).
    The server is terminated in any case."""
    import base64
    import socket
    import tempfile
    import urllib.error
    from concurrent.futures import ThreadPoolExecutor

    from shmgan_tpu_torch.cli import serving_models
    from shmgan_tpu_torch.config import Config
    from shmgan_tpu_torch.data.codecs import decode, encode_png, resize_bilinear
    from shmgan_tpu_torch.serve import BatchInferenceEngine
    from shmgan_tpu_torch.serve_http import HTTP_OUTPUTS, _decode_request_image

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["--mode", "serve", "--serve_weights_bundle", os.path.join(ROOT, BUNDLE),
            "--serve_host", "127.0.0.1", "--serve_port", str(port),
            "--serve_batch_size", "8", "--serve_batch_window_ms", "20"]
    url = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(4)
    u8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.uint8)  # noqa: E731
    square = u8(scenes(1, 256, 256, rng)[0])
    photo = u8(scenes(1, 300, 452, rng)[0])
    big = u8(scenes(1, 612, 816, rng)[0])
    burst = [encode_png(u8(x)) for x in scenes(16, 256, 256, rng)]

    # host codec costs, per image
    for label, img in (("256x256", square), ("612x816", big)):
        png = encode_png(img)
        enc = [_timed_ms(lambda: encode_png(img)) for _ in range(5)]
        dec = [_timed_ms(lambda: decode(png)) for _ in range(5)]
        say(f"host PNG {label}: encode {np.median(enc):.2f} ms, decode (filter 0) "
            f"{np.median(dec):.2f} ms, {len(png)} bytes")
    res = [_timed_ms(lambda: resize_bilinear(big, (256, 256))) for _ in range(5)]
    say(f"host resize 612x816 -> 256x256 (Pillow's bilinear): {np.median(res):.2f} ms")

    fixtures = codec_fixtures()
    jpeg, gif = fixtures["photo_612x816.jpg"], fixtures["palette.gif"]
    for label, (data, _) in (("JPEG 612x816", jpeg), ("GIF 256x256", gif)):
        dec = [_timed_ms(lambda: decode(data)) for _ in range(5)]
        say(f"host decode of the {label} body ({len(data)} bytes): median "
            f"{np.median(dec):.2f} ms over 5")

    cfg = Config.from_args(argv)
    gen, specseg = serving_models(cfg)
    engines = {256: BatchInferenceEngine(cfg, gen, specseg, batch_size=8, outputs=HTTP_OUTPUTS),
               "native": BatchInferenceEngine(cfg, gen, specseg, batch_size=8,
                                              outputs=HTTP_OUTPUTS, native_resolution=True)}

    def local(body, size):
        rgb = _decode_request_image(body, size)
        if size == "native":
            return engines[size].process_images_native([rgb[0]])[0]
        return {k: v[0] for k, v in engines[size].process_images(rgb).items()}

    # the server shares the card: hand back what earlier phases left cached
    torch.cuda.empty_cache()
    say(f"device memory before the server: {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"reserved by this process")
    with tempfile.TemporaryFile() as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "shmgan_tpu_torch.cli", *argv],
                                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.perf_counter() + 300
            while True:
                if proc.poll() is not None:
                    raise RuntimeError(f"the server exited with {proc.returncode}")
                try:
                    health = json.loads(_http(url + "/healthz", timeout=5)[2])
                    break
                except OSError:
                    if time.perf_counter() > deadline:
                        raise RuntimeError("the server did not answer /healthz in 300 s")
                    time.sleep(0.5)
            say(f"server up in {time.perf_counter() - t0:.1f} s: /healthz {health}")
            before = json.loads(_http(url + "/stats")[2])

            # (query, output, label, body, the PNG of its decoded pixels): the
            # in-process engine reads the PNG of PIL's pixels of a JPEG or GIF body
            pngs = [(q, o, f"{img.shape[0]}x{img.shape[1]} PNG", encode_png(img))
                    for q, o, img in (
                        ("size=256", "image", square), ("size=256", "composited", square),
                        ("size=256", "mask", square), ("size=256", "json", square),
                        ("size=native", "image", photo), ("size=native", "mask", photo),
                        ("size=256", "image", big))]
            checks = [(q, o, label, body, body) for q, o, label, body in pngs] + [
                ("size=256", "image", "612x816 JPEG", *jpeg),
                ("size=native", "image", "612x816 JPEG", *jpeg),
                ("size=256", "image", "256x256 GIF", *gif)]
            worst = 0
            for query, output, label, body, ref_body in checks:
                size = "native" if query == "size=native" else 256
                try:
                    status, ctype, reply = _http(f"{url}/v1/specfree?{query}&output={output}",
                                                 body)
                except urllib.error.HTTPError as e:
                    raise AssertionError(f"POST {query} output={output} ({label} in): "
                                         f"{e.code} {e.read()[:2000]!r}") from None
                ref = local(ref_body, size)
                if output == "json":
                    payload = json.loads(reply)
                    got = decode(base64.b64decode(payload["image_png_b64"]))
                    want = u8(ref["gen_rgb_calibrated"])
                    if abs(payload["mask_coverage"] - float(ref["mask"].mean())) > 1e-3:
                        raise AssertionError(f"json mask_coverage {payload['mask_coverage']}")
                else:
                    got = decode(reply)
                    want = u8({"image": ref["gen_rgb_calibrated"],
                               "composited": ref["gen_rgb_composited"],
                               "mask": np.repeat(ref["mask"], 3, axis=-1)}[output])
                diff = int(np.abs(got.astype(int) - want).max()) if got.shape == want.shape else -1
                say(f"POST {query} output={output} ({label} in): {status} "
                    f"{ctype}, {got.shape}, max |server - in-process| = {diff} levels, "
                    f"{float((got != want).mean()) if diff >= 0 else 1.0:.2e} of values differ")
                if status != 200 or not 0 <= diff <= 1:
                    raise AssertionError(f"POST {query} output={output}: status {status}, "
                                         f"difference {diff}")
                worst = max(worst, diff)

            calls0 = json.loads(_http(url + "/stats")[2])["device_calls"]

            def one(body):
                t = time.perf_counter()
                status, _, reply = _http(url + "/v1/specfree?size=256", body)
                return status, decode(reply).shape, (time.perf_counter() - t) * 1e3

            t1 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=16) as ex:
                results = list(ex.map(one, burst))
            wall = time.perf_counter() - t1
            after = json.loads(_http(url + "/stats")[2])
            calls = after["device_calls"] - calls0
            lat = [r[2] for r in results]
            say(f"16 concurrent size=256 requests: {calls} device calls, {16 / wall:.2f} "
                f"requests/s, request ms median {np.median(lat):.2f} p90 "
                f"{np.percentile(lat, 90):.2f}")
            if any(r[:2] != (200, (256, 256, 3)) for r in results) or not calls < 16:
                raise AssertionError(f"concurrent requests: {[r[:2] for r in results]}, "
                                     f"{calls} device calls")
            seq = [one(burst[i])[2] for i in range(10)]
            say(f"10 sequential size=256 requests: request ms median {np.median(seq):.2f} "
                f"p90 {np.percentile(seq, 90):.2f} ({1e3 / np.median(seq):.2f} requests/s)")
            after = json.loads(_http(url + "/stats")[2])
            counts = {k: after["kernel_launches"][k] - before["kernel_launches"][k]
                      for k in before["kernel_launches"]}
            n = after["device_calls"] - before["device_calls"]
            want = {**{k: 0 for k in counts}, _in_name(torch.bfloat16): 18 * n,
                    "fused_standardize_yuv": n}
            say(f"server: {after['requests']} requests, {after['errors']} errors, {n} device "
                f"calls, kernel launches {counts}")
            if counts != want or after["errors"]:
                raise AssertionError(f"server launches {counts}, expected {want}; errors "
                                     f"{after['errors']}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            log.seek(0)
            for line in log.read().decode(errors="replace").splitlines()[-8:]:
                say(f"  server: {line}")
    for eng in engines.values():
        eng.close()
    return counts


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _timed_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def serve_folder_phase(bundle):
    """10 PNGs (five 256x256, five 300x452) and the codec fixtures of
    FOLDER_FORMATS (every JPEG and GIF, the 16-bit PNGs, the BMPs) through
    process_folder and watch_folder(max_iterations=3), square (256) and
    native, bf16 on the trained bundle: the files written (names, shapes),
    the square job's pixels against the same engine's process_images,
    watch_folder's files against process_folder's, and the launches of the
    four jobs (18 IN forwards and one preprocess a device call: a square job
    calls once a batch of 8, a native one once a batch of 8 of one size)."""
    import tempfile

    from shmgan_tpu_torch.data.codecs import decode, encode_png
    from shmgan_tpu_torch.data.loader import decode_resize, list_images
    from shmgan_tpu_torch.profile_serve import serving_config
    from shmgan_tpu_torch.serve import BatchInferenceEngine

    cfg = serving_config("bfloat16")
    gen, specseg = bundle_models(cfg, bundle)
    rng = np.random.default_rng(5)
    inputs = {f"photo{i:02d}.png": encode_png((img * 255).astype(np.uint8)) for i, img in
              enumerate(list(scenes(5, 256, 256, rng)) + list(scenes(5, 300, 452, rng)))}
    # fixtures as fx_<name>_<ext>.<ext>: palette.gif and palette.bmp write distinct outputs
    inputs.update({"fx_" + n.replace(".", "_") + os.path.splitext(n)[1]: data
                   for n, (data, _) in codec_fixtures().items() if n.endswith(FOLDER_FORMATS)})
    file_of = {os.path.splitext(n)[0]: n for n in inputs}
    names = sorted(file_of)
    native_sizes = {b: decode(inputs[n]).shape[:2] for b, n in file_of.items()}
    by_size = {}
    for hw in native_sizes.values():
        by_size[hw] = by_size.get(hw, 0) + 1
    calls = 2 * (-(-len(inputs) // 8) + sum(-(-n // 8) for n in by_size.values()))
    kw = dict(batch_size=8, outputs=("gen_rgb_calibrated", "mask"))
    engines = {"square": BatchInferenceEngine(cfg, gen, specseg, **kw),
               "native": BatchInferenceEngine(cfg, gen, specseg, native_resolution=True, **kw)}
    with tempfile.TemporaryDirectory() as tmp:
        in_dir = os.path.join(tmp, "in")
        os.makedirs(in_dir)
        for name, data in inputs.items():
            with open(os.path.join(in_dir, name), "wb") as f:
                f.write(data)
        for eng in engines.values():
            eng.warmup()
        _launch_counts(reset=True)
        written = {}
        for kind, eng in engines.items():
            for job in ("process_folder", "watch_folder"):
                out_dir = os.path.join(tmp, f"{kind}_{job}")
                t0 = time.perf_counter()
                if job == "process_folder":
                    n = eng.process_folder(in_dir, out_dir)
                else:
                    eng.watch_folder(in_dir, out_dir, poll_s=0.05, max_iterations=3)
                    n = len(names)
                secs = time.perf_counter() - t0
                files = sorted(os.listdir(out_dir))
                want = sorted(f"{b}_{s}.png" for b in names for s in ("specfree", "mask"))
                written[kind, job] = {f: _read(os.path.join(out_dir, f)) for f in files}
                shapes = [decode(written[kind, job][f"{b}_specfree.png"]).shape[:2]
                          for b in names]
                sizes = [(256, 256) if kind == "square" else native_sizes[b] for b in names]
                say(f"{kind} {job}: {n} images in {secs:.3f} s, {len(files)} files")
                if n != len(names) or files != want or shapes != sizes:
                    raise AssertionError(f"{kind} {job}: {n} images, files {files}, shapes "
                                         f"{shapes}")
        counts = _launch_counts(reset=True)
        want = {**{k: 0 for k in counts}, _in_name(torch.bfloat16): 18 * calls,
                "fused_standardize_yuv": calls}
        say(f"serve_folder launches {counts} ({calls} device calls in four jobs on "
            f"{len(inputs)} files, {len(by_size)} native sizes)")
        if counts != want:
            raise AssertionError(f"serve_folder launches {counts}, expected {want}")
        for kind in engines:
            if written[kind, "process_folder"] != written[kind, "watch_folder"]:
                raise AssertionError(f"{kind}: watch_folder wrote other files than "
                                     f"process_folder")
        listed = list_images(in_dir)       # the folder job's order, so its batches
        direct = engines["square"].process_images(
            np.stack([decode_resize(p, 256) for p in listed]))
        _launch_counts(reset=True)
        for j, b in enumerate(os.path.splitext(os.path.basename(p))[0] for p in listed):
            got = decode(written["square", "process_folder"][f"{b}_specfree.png"])
            if not np.array_equal(got, (np.clip(direct["gen_rgb_calibrated"][j], 0, 1) * 255)
                                  .astype(np.uint8)):
                raise AssertionError(f"{b}_specfree.png differs from process_images' output")
        say("square files equal process_images' outputs, truncated to 8 bits")
    for eng in engines.values():
        eng.close()
    return counts


def _launch_counts(reset: bool = False):
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink
    from shmgan_tpu_torch.ops.kernels import launch_counts
    from shmgan_tpu_torch.ops.kernels import preprocess as pre

    counts = launch_counts()
    if reset:
        ink.launches.update(dict.fromkeys(ink.launches, 0))
        pre.launches = pre.band_launches = 0
    return counts


def _compare_grads(a, r, label, norm_rtol=GRAD_NORM_RTOL) -> bool:
    """Whether two runs' gradients of one network, {name: tensor}, agree:
    within `norm_rtol` as a whole (L2, relative), each leaf within
    GRAD_LEAF_RTOL of its largest; prints the readings."""
    pairs = [(k, a[k].double().cpu(), r[k].double().cpu()) for k in r]
    diff = sum(((x - y) ** 2).sum().item() for _, x, y in pairs) ** 0.5
    norm = sum((y ** 2).sum().item() for _, _, y in pairs) ** 0.5
    leaf, k_worst = max((((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item(), k)
                        for k, x, y in pairs)
    say(f"  {label} ({len(pairs)} leaves): ||diff||/||ref||={diff / norm:.3e} (tol "
        f"{norm_rtol}); worst leaf max|diff|/max|ref|={leaf:.3e} at {k_worst} (tol "
        f"{GRAD_LEAF_RTOL})")
    return diff <= norm_rtol * norm and all(
        (x - y).abs().max() <= GRAD_LEAF_RTOL * y.abs().max() for _, x, y in pairs)


def _compare_step(got, ref, label, norm_rtol=GRAD_NORM_RTOL):
    """Gradients and losses of two runs of one train step (see GRAD_NORM_RTOL)."""
    for net in ("G", "D"):
        name = f"{label} {net} gradients"
        if not _compare_grads(got["_grads"][net], ref["_grads"][net], name, norm_rtol):
            raise AssertionError(f"{name} differ")
    keys = [k for k in ref if not k.startswith("_")]
    rel = {k: abs(float(got[k]) - float(ref[k])) / max(abs(float(ref[k])), 1e-30) for k in keys}
    k_worst = max(rel, key=rel.get)
    say(f"  {label} losses ({len(keys)}): worst relative difference {rel[k_worst]:.3e} at "
        f"{k_worst} (tol {LOSS_RTOL})")
    if rel[k_worst] > LOSS_RTOL:
        raise AssertionError(f"{label}: loss {k_worst} differs by {rel[k_worst]}")


def train_phase():
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_serve import plain_versions
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import (make_scan_train_steps, make_train_step,
                                             sample_draws)

    cfg = training_config("float32")
    v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
    state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
    say(f"train config: {size} px, batch {b}, filter {cfg.model.filter_size}, SpecSeg base "
        f"{cfg.model.specseg_base_filters}, flip {cfg.data.flip}; G params="
        f"{sum(p.numel() for p in state.gen.parameters())} D params="
        f"{sum(p.numel() for p in state.disc.parameters())}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def batch():
        return torch.rand((v, b, size, size, 3), device="cuda", generator=gen)

    checked, fast = make_train_step(cfg, debug_grads=True), make_train_step(cfg)
    views, draws = batch(), sample_draws(cfg, gen, v, b, size, size)
    fast(copy.deepcopy(state), views, draws, 0)  # warm-up: cuDNN's choices, allocator
    torch.cuda.synchronize()
    g0 = [p.detach().clone() for p in state.gen.parameters()]
    d0 = [p.detach().clone() for p in state.disc.parameters()]

    # 1-2. one step through the kernels, counted, against the plain path
    plain_state = copy.deepcopy(state)
    _launch_counts(reset=True)
    state, through_kernels = checked(state, views, draws, 0)
    torch.cuda.synchronize()
    step_counts = _launch_counts(reset=True)
    say(f"one train step: launches {step_counts} (expected {step_launches(torch.float32)})")
    if step_counts != step_launches(torch.float32):
        raise AssertionError(f"train step launches {step_counts}, expected "
                             f"{step_launches(torch.float32)}")
    with plain_versions():
        plain_state, through_plain = checked(plain_state, views, draws, 0)
    if any(_launch_counts(reset=True).values()):
        raise AssertionError("the plain train step launched a kernel")
    _compare_step(through_kernels, through_plain, "kernels vs plain, full width:")
    del plain_state, through_plain, through_kernels

    # 3. ten steps with sampled draws
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        views, draws = batch(), sample_draws(cfg, gen, v, b, size, size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = fast(state, views, draws, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, val in metrics.items() if not torch.isfinite(val).all()]
        if bad:
            raise AssertionError(f"non-finite losses after step {state.step}: {bad}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(times))
    say(f"train steps: median {med * 1e3:.2f} ms ({b / med:.2f} images/s at B={b}), min "
        f"{min(times) * 1e3:.2f} ms, max {max(times) * 1e3:.2f} ms over {len(times)} steps; "
        f"peak device memory {peak:.3f} GiB; losses of the last: total_G="
        f"{float(metrics['total_G']):.4f} total_D={float(metrics['total_D']):.4f}")
    moved = (sum(not torch.equal(p, q) for p, q in zip(state.gen.parameters(), g0)),
             sum(not torch.equal(p, q) for p, q in zip(state.disc.parameters(), d0)))
    say(f"params changed: G {moved[0]}/{len(g0)}, D {moved[1]}/{len(d0)}")
    if moved != (len(g0), len(d0)):
        raise AssertionError(f"not every parameter moved: {moved}")

    # 4. one K = 3 call of the K-step loop
    before = state.step
    batches = torch.stack([batch() for _ in range(3)])
    state, stacked = make_scan_train_steps(cfg)(
        state, batches, [sample_draws(cfg, gen, v, b, size, size) for _ in range(3)], 0)
    torch.cuda.synchronize()
    if state.step != before + 3 or any(val.shape != (3,) or not torch.isfinite(val).all()
                                       for val in stacked.values()):
        raise AssertionError("make_scan_train_steps: wrong step count, shape or values")
    say(f"make_scan_train_steps K=3: total_G {stacked['total_G'].tolist()}")
    counts = _launch_counts(reset=True)
    want = {k: 13 * n for k, n in step_launches(torch.float32).items()}
    say(f"launches over those 13 steps: {counts}")
    if counts != want:
        raise AssertionError(f"13 train steps launched {counts}, expected {want}")
    totals = {k: step_counts[k] + counts[k] for k in counts}

    # 5. the card against the CPU on one step at batch 2, same weights and draws
    small = training_config("float32")
    small.train.batch_size = 2
    models = build_models(small, device="cpu", seed=1)
    cpu_state = create_train_state(small, tuple(copy.deepcopy(m) for m in models))
    card_state = create_train_state(small, tuple(m.to("cuda") for m in models))
    cpu_gen = torch.Generator().manual_seed(1)
    views = torch.rand((v, 2, size, size, 3), generator=cpu_gen)
    draws = sample_draws(small, cpu_gen, v, 2, size, size)
    step = make_train_step(small, debug_grads=True)
    t0 = time.perf_counter()
    _, on_cpu = step(cpu_state, views, draws, 0)
    say(f"the step at batch 2 on the CPU took {time.perf_counter() - t0:.2f} s")
    _, on_card = step(card_state, views.cuda(), draws.to("cuda"), 0)
    _launch_counts(reset=True)
    _compare_step(on_card, on_cpu, f"card vs CPU, batch 2, {size} px:")
    return totals


LOSSES = "losses (each scaled by its f32 value)"


def _gap_vectors(m, f32):
    """A train step's metrics `m` as the gap rule reads them, beside the
    same step's in f32: {"G gradients", "D gradients": each network's
    gradients as one float64 vector; LOSSES: every loss divided by its f32
    value}."""
    keys = sorted(k for k in f32 if not k.startswith("_") and k != "target_label")
    out = {f"{net} gradients": torch.cat([m["_grads"][net][k].double().flatten().cpu()
                                          for k in sorted(m["_grads"][net])]).numpy()
           for net in ("G", "D")}
    out[LOSSES] = np.array([float(m[k]) / max(abs(float(f32[k])), 1e-30) for k in keys])
    return out


def _compare_step_gap(steps, label, limit=GAP_C):
    """bf16 steps through the kernels against the same steps through the
    plain versions, `steps` a list of (kernels, plain, f32) metrics, one
    batch each: G's and D's gradients, each network as one vector, and the
    losses as one vector (_gap_vectors), each held by _gap_check (at
    `limit`) over all the batches at once (STEP_GAP_BATCHES), each batch's
    ratio printed beside."""
    keys = sorted(k for k in steps[0][2] if not k.startswith("_") and k != "target_label")
    vecs = [[_gap_vectors(m, step[2]) for m in step] for step in steps]
    for i, step in enumerate(vecs):
        k_, p_, f_ = (v[LOSSES] for v in step)
        say(f"  {label} batch {i}, each loss, (kernels - plain, plain - f32) / |f32|: "
            + ", ".join(f"{k} {a - b:+.2e} {b - c:+.2e}" for k, a, b, c in zip(keys, k_, p_, f_)))
    for name in vecs[0][0]:
        per = [tuple(v[name] for v in step) for step in vecs]
        if len(per) > 1:
            say(f"  {label} {name}, ratio of each batch (read): " + ", ".join(
                f"{np.linalg.norm(k - p) / max(np.linalg.norm(p - f), 1e-300):.3f}"
                for k, p, f in per))
        _gap_check(f"{label} {name}" + (f", {len(per)} batches" if len(per) > 1 else ""),
                   *(np.concatenate(x) for x in zip(*per)), limit=limit)


def _bf16_step_check(cfg, f32_cfg, state, batches, what):
    """One bf16 train step (seed-0 weights in `state`) through the kernels
    on each (views, draws) of `batches`: its launches, exactly
    step_launches'; against the same step through the plain versions by
    the gap to the same step in f32 on the card (_compare_step_gap).
    Returns the state stepped on the first batch and the launches."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_serve import plain_versions
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import make_train_step

    checked = make_train_step(cfg, debug_grads=True)
    start, stepped, counts, steps = copy.deepcopy(state), None, [], []
    want = step_launches(torch.bfloat16)
    for views, draws in batches:
        # the same step in f32 on the same weights (seed 0), views and draws
        f32_state = create_train_state(f32_cfg, build_models(f32_cfg, device="cuda", seed=0))
        _, in_f32 = make_train_step(f32_cfg, debug_grads=True)(f32_state, views, draws, 0)
        del f32_state
        _launch_counts(reset=True)
        state, through_kernels = checked(copy.deepcopy(start), views, draws, 0)
        torch.cuda.synchronize()
        counts.append(_launch_counts(reset=True))
        if stepped is None:
            stepped = state
        say(f"one bf16 train step{what}: launches {counts[-1]} (expected {want})")
        if counts[-1] != want:
            raise AssertionError(f"bf16 train step{what} launches {counts[-1]}, expected {want}")
        with plain_versions():
            _, through_plain = checked(copy.deepcopy(start), views, draws, 0)
        if any(_launch_counts(reset=True).values()):
            raise AssertionError("the plain train step launched a kernel")
        steps.append((through_kernels, through_plain, in_f32))
    _compare_step_gap(steps, f"kernels vs plain, bf16{what}:")
    return stepped, _sum_counts(*counts)


def train_bf16_phase():
    """The train step at full width computing in bf16: one step through the
    kernels on each of STEP_GAP_BATCHES random batches against the same
    step through the plain versions, by the gap to the same step in f32 on
    the card; launches of each kernel a step; ten timed steps."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import make_train_step, sample_draws

    cfg, f32_cfg = training_config("bfloat16"), training_config("float32")
    v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
    state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
    say(f"train config: {size} px, batch {b}, filter {cfg.model.filter_size}, compute dtype "
        f"{cfg.model.compute_dtype}, parameters {next(state.gen.parameters()).dtype}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def batch():
        return torch.rand((v, b, size, size, 3), device="cuda", generator=gen)

    fast = make_train_step(cfg)
    batches = [(batch(), sample_draws(cfg, gen, v, b, size, size))
               for _ in range(STEP_GAP_BATCHES)]
    fast(copy.deepcopy(state), *batches[0], 0)  # warm-up: cuDNN's choices, allocator
    torch.cuda.synchronize()
    state, step_counts = _bf16_step_check(cfg, f32_cfg, state, batches, "")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        views, draws = batch(), sample_draws(cfg, gen, v, b, size, size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = fast(state, views, draws, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        bad = [k for k, val in metrics.items() if not torch.isfinite(val).all()]
        if bad:
            raise AssertionError(f"non-finite losses after step {state.step}: {bad}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(times))
    say(f"bf16 train steps: median {med * 1e3:.2f} ms ({b / med:.2f} images/s at B={b}), "
        f"min {min(times) * 1e3:.2f} ms, max {max(times) * 1e3:.2f} ms over {len(times)} "
        f"steps; peak device memory {peak:.3f} GiB; losses of the last: total_G="
        f"{float(metrics['total_G']):.4f} total_D={float(metrics['total_D']):.4f}")
    counts = _launch_counts(reset=True)
    want = {k: 10 * n for k, n in step_launches(torch.bfloat16).items()}
    if counts != want:
        raise AssertionError(f"10 bf16 train steps launched {counts}, expected {want}")
    return {k: step_counts[k] + counts[k] for k in counts}, dict(median_ms=med * 1e3,
                                                                 images_per_s=b / med)


# triplets: a SHIQ-style tree of TRIPLET_SCENES triplets at SS_SIZE px; one
# SpecSeg step at SS_BATCH on its pairs, one GAN step on the first batch's views
TRIPLET_SCENES = 32


def triplets_phase():
    """The triplet adapter on the card: write_triplet_fixture_tree at 128 px,
    TripletDataset; specseg_pairs on the card against the CPU (within
    SS_STD_RTOL of each image's scale); one SpecSeg step at b32, 1 channel,
    base 16 on the pairs, card vs CPU (_ss_step_check); one GAN step at the
    JAX defaults (128 px, b8, filter 64) on triplet_to_views' stack of the
    b32 batch's triplets, 8 at a time, in bf16 on STEP_GAP_BATCHES batches
    and in f32 on the first: launches exactly step_launches' in each; f32
    through the kernels against the plain versions by LOOP_MOMENT_RTOL;
    bf16 by the gap rule. The four view slots hold one image, so many
    instance-norm planes are near constant, where one-pass moments in f32
    cancel (csrc/instance_norm.cu keeps them from it)."""
    from shmgan_tpu_torch.data.synthetic import write_triplet_fixture_tree
    from shmgan_tpu_torch.data.triplets import TripletDataset, specseg_pairs, triplet_to_views
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_serve import plain_versions
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import make_train_step, sample_draws

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_triplet_fixture_tree(root, TRIPLET_SCENES, SS_SIZE, seed=7)
        t1 = time.perf_counter()
        ds = TripletDataset(root, SS_SIZE, batch_size=SS_BATCH)
        t2 = time.perf_counter()
        batch = next(ds.iter_epoch(shuffle_seed=0))
    say(f"triplet tree: {TRIPLET_SCENES} triplets at {SS_SIZE} px written in {t1 - t0:.2f} s, "
        f"read in {t2 - t1:.2f} s; mask coverage {float(batch['mask'].mean()):.4f}")
    y_card, m_card = specseg_pairs(batch, "cuda")
    y_cpu, m_cpu = specseg_pairs(batch, "cpu")
    scale = y_cpu.flatten(1).abs().amax(1)
    err = float(((y_card.cpu() - y_cpu).flatten(1).abs().amax(1) / scale).max())
    say(f"specseg_pairs card vs CPU: max|diff| / image scale {err:.3e} (tol {SS_STD_RTOL}); "
        f"masks equal {torch.equal(m_card.cpu(), m_cpu)}")
    if err > SS_STD_RTOL or not torch.equal(m_card.cpu(), m_cpu) \
            or y_card.device.type != "cuda":
        raise AssertionError("specseg_pairs on the card differs from the CPU's")
    _launch_counts(reset=True)
    _ss_step_check("triplet pairs, 1 channel", y_cpu, m_cpu)
    if any(_launch_counts(reset=True).values()):
        raise AssertionError("the SpecSeg step launched a kernel")

    cfg, f32_cfg = training_config("bfloat16"), training_config("float32")
    v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
    gen = torch.Generator(device="cuda").manual_seed(1)
    # the SpecSeg batch's triplets, b at a time, as the GAN's batches
    batches = [(torch.from_numpy(triplet_to_views(
        {k: a[i * b:(i + 1) * b] for k, a in batch.items()})).cuda(),
        sample_draws(cfg, gen, v, b, size, size)) for i in range(STEP_GAP_BATCHES)]
    views, draws = batches[0]
    if tuple(views.shape) != (v, b, size, size, 3):
        raise AssertionError(f"triplet views {tuple(views.shape)}")
    state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
    make_train_step(cfg)(copy.deepcopy(state), views, draws, 0)  # warm-up
    torch.cuda.synchronize()
    _launch_counts(reset=True)
    _, counts = _bf16_step_check(cfg, f32_cfg, state, batches, " on triplet views")
    del state

    f32_state = create_train_state(f32_cfg, build_models(f32_cfg, device="cuda", seed=0))
    plain_state = copy.deepcopy(f32_state)
    checked = make_train_step(f32_cfg, debug_grads=True)
    _launch_counts(reset=True)
    _, through_kernels = checked(f32_state, views, draws, 0)
    torch.cuda.synchronize()
    f32_counts = _launch_counts(reset=True)
    say(f"one f32 train step on triplet views: launches {f32_counts}")
    if f32_counts != step_launches(torch.float32):
        raise AssertionError(f"f32 triplet step launches {f32_counts}")
    with plain_versions():
        _, through_plain = checked(plain_state, views, draws, 0)
    if any(_launch_counts(reset=True).values()):
        raise AssertionError("the plain train step launched a kernel")
    _compare_step(through_kernels, through_plain, "kernels vs plain, f32 on triplet views:",
                  LOOP_MOMENT_RTOL)
    return _sum_counts(counts, f32_counts)


# the loop phases' trees: 16 scenes make 2 batches of 8 an epoch (train_loop:
# 2 epochs, 4 steps), 40 make 5 (train_cli: 2 epochs, 10 steps, checkpoints
# at steps 5 and 10, then a third epoch on resume)
LOOP_SCENES, CLI_SCENES = 16, 40
# train_loop, kernels vs plain. Step 1 starts from the same weights and batch
# in both runs, so each optimizer's first moment after it, (1 - b1) clip(g),
# holds the kernels' gradients against the plain ones: each net within
# LOOP_MOMENT_RTOL (L2, relative), each leaf within GRAD_LEAF_RTOL of its
# largest. The second moment is the first's square times a constant at step
# 1, so it adds nothing. The loop's gradients part further than the bare
# step's (GRAD_NORM_RTOL): two unfaulted H100 runs read 1.6e-3 to 2.9e-3 for
# G and D, where an IN backward whose f32 dx is 1.01 times too large reads
# 3.2e-2 to 3.8e-2 (shmgan_tpu_torch/plant_faults.py --train-loop); 1e-2
# lies about 3.3 times from each. After 4 steps each net's parameters and
# first moments are held by the gap rule: ||kernels - plain|| <= GAP_C
# ||perturbed - plain|| (L2), where `perturbed` is the plain loop from the same
# models with every G and D parameter moved by lr, in a seeded random
# direction. No per-element limit on the parameters: Adam moves an element by
# about lr a step whatever the size of its gradient, so where rounding flips a
# near-zero gradient's sign the runs part by lr-sized steps (two H100 runs of
# one tree read 6.78 and 8.22 lr after 4 steps, and a third 8.29 against the
# 8 lr limit first used), and the most Adam allows, about 8.8 lr, is no
# test. The metrics row of step 1 (the same weights in both runs) within
# LOSS_RTOL, each loss; a row after updates by the gap rule over the row (each
# loss scaled by the plain run's).
# (4 x LOSS_RTOL, the first choice, read 5.5e-4 at D1_cls of step 3 on an
# H100: one update's sign flips move a loss by more than rounding does.)
LOOP_MOMENT_RTOL = 1e-2
SIGTERM_DEADLINE_S = 300


class _StepSpy:
    """Stands in for the loop's make_train_step: records the host time at
    each step's start and, with keep_views, a device copy of each step's
    views (made on the step's stream, so after the feed's copy event); keeps
    a copy of each optimizer's first moment after the first step (`mu1`,
    {"G" | "D": {name: tensor}}); after the `steps`-th step it waits for the
    device and records the end."""

    def __init__(self, steps: int, keep_views: bool = False):
        from shmgan_tpu_torch.train.step import make_train_step

        self._make, self.steps, self.keep_views = make_train_step, steps, keep_views
        self.starts, self.views, self.end, self.mu1 = [], [], None, None

    def _wrapped(self, cfg, debug_grads=False):
        inner = self._make(cfg, debug_grads)

        def step(state, views, draws, epoch):
            self.starts.append(time.perf_counter())
            if self.keep_views:
                self.views.append(views.clone())
            out = inner(state, views, draws, epoch)
            if len(self.starts) == 1:
                self.mu1 = {net: {k: m.clone() for k, m in opt.moments()[0].items()}
                            for net, opt in (("G", out[0].g_opt), ("D", out[0].d_opt))}
            if len(self.starts) == self.steps:
                torch.cuda.synchronize()
                self.end = time.perf_counter()
            return out

        return step

    def patched(self):
        return mock.patch("shmgan_tpu_torch.train.loop.make_train_step", self._wrapped)

    def step_ms(self):
        """ms of each step on the host's clock: from its start to the next
        step's, the last to the device's end. Steps overlap the device's
        work on the previous ones; the medians compare with the bare step's,
        timed alone between two synchronisations."""
        t = self.starts + [self.end]
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])]


def _loop_config(cfg, root, tree, epochs):
    cfg.data.data_dir = tree
    cfg.train.num_epochs = epochs
    cfg.train.checkpoint_save_step = 1
    for name in ("checkpoint_save_dir", "log_dir", "model_save_dir", "result_dir"):
        setattr(cfg.train, name, os.path.join(root, name))
    return cfg


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _leaves_equal(got, want, label):
    """Two flax-layout trees of arrays, bit for bit."""
    g, w = dict(_paths(got)), dict(_paths(want))
    if sorted(g) != sorted(w):
        raise AssertionError(f"{label}: leaves {sorted(set(g) ^ set(w))} differ")
    bad = [k for k in w if not (np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
                                and np.array_equal(g[k], w[k]))]
    if bad:
        k = bad[0]
        say(f"  {label}: {k}: {np.asarray(g[k]).ravel()[:4]} vs {np.asarray(w[k]).ravel()[:4]}")
        raise AssertionError(f"{label}: {len(bad)} of {len(w)} leaves differ, e.g. {bad[:3]}")
    say(f"  {label}: {len(w)} leaves equal bit for bit")


def train_loop_phase():
    """train.loop.train at full width in f32 on a 16-scene tree, 2 epochs of 2
    steps, from one set of seeded models: through the kernels (launches
    counted: exactly 4 steps' worth), then inside plain_versions() (none),
    and inside plain_versions() from those models moved by lr (the gap
    rule's reference). Every batch the feed handed a step against the
    dataset's numpy batch, bit for bit; the optimizers' first moments after
    step 1, each net's parameters after step 4 and every metrics.jsonl row of
    the kernels' run against the plain run's."""
    from shmgan_tpu_torch.data.loader import PolarimetricDataset
    from shmgan_tpu_torch.data.synthetic import write_fixture_tree
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_serve import plain_versions
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.loop import train

    with tempfile.TemporaryDirectory() as root:
        tree = os.path.join(root, "tree")
        t0 = time.perf_counter()
        write_fixture_tree(tree, LOOP_SCENES, 128, seed=0)
        say(f"wrote {LOOP_SCENES} 128-px scenes in {time.perf_counter() - t0:.2f} s")
        models = build_models(training_config("float32"), device="cuda", seed=0)
        lr = training_config("float32").train.g_lr
        perturbed = copy.deepcopy(models)
        dev = next(models[0].parameters()).device
        noise = torch.Generator(device=dev).manual_seed(1)
        with torch.no_grad():
            for p in [*perturbed[0].parameters(), *perturbed[1].parameters()]:
                sign = torch.randint(0, 2, p.shape, device=dev, generator=noise) * 2 - 1
                p.add_(lr * sign)
        runs = {}
        for path in ("kernels", "plain", "perturbed"):
            cfg = _loop_config(training_config("float32"), os.path.join(root, path), tree, 2)
            spy = _StepSpy(4, keep_views=path == "kernels")
            _launch_counts(reset=True)
            t0 = time.perf_counter()
            with spy.patched(), nullcontext() if path == "kernels" else plain_versions():
                state = train(cfg, verbose=False, models=copy.deepcopy(
                    perturbed if path == "perturbed" else models))
            wall = time.perf_counter() - t0
            runs[path] = (cfg, state, spy, _launch_counts(reset=True))
            ms = spy.step_ms()
            say(f"{path}: 4 loop steps, step ms {[round(x, 2) for x in ms]}, train() "
                f"{wall:.2f} s; launches {runs[path][3]}")
        cfg, state, spy, counts = runs["kernels"]
        want = {k: 4 * n for k, n in step_launches(torch.float32).items()}
        if counts != want:
            raise AssertionError(f"4 loop steps launched {counts}, expected {want}")
        if any(runs["plain"][3].values()) or any(runs["perturbed"][3].values()):
            raise AssertionError("a plain loop launched a kernel")

        ds = PolarimetricDataset(cfg.data, cfg.model.image_size, cfg.train.batch_size)
        batches = [b for _ in range(2) for b in ds.iter_epoch()]
        if len(spy.views) != len(batches) or not all(
                np.array_equal(v.cpu().numpy(), b) for v, b in zip(spy.views, batches)):
            raise AssertionError("a batch the feed handed the step differs from the dataset's")
        say(f"  the {len(batches)} batches the steps took equal the dataset's, bit for bit")

        failed = []   # every comparison is read before the phase fails
        for net in ("G", "D"):
            label = f"kernels vs plain, {net}'s first moment after step 1"
            if not _compare_grads(spy.mu1[net], runs["plain"][2].mu1[net], label,
                                  LOOP_MOMENT_RTOL):
                failed.append(label)
        plain, moved = runs["plain"][1], runs["perturbed"][1]
        for net, opt in (("gen", "g_opt"), ("disc", "d_opt")):
            for what, leaves in (
                    ("parameters", lambda st: list(getattr(st, net).parameters())),
                    ("first moments", lambda st: getattr(st, opt).moments()[0].values())):
                trio = list(zip(leaves(state), leaves(plain), leaves(moved)))
                d_kp = sum(float((p - q).detach().double().square().sum())
                           for p, q, _ in trio) ** 0.5
                d_mp = sum(float((m - q).detach().double().square().sum())
                           for _, q, m in trio) ** 0.5
                say(f"  kernels vs plain, {net}'s {what} after 4 steps ({len(trio)} leaves): "
                    f"||kernels - plain||={d_kp:.3e}, ||perturbed - plain||={d_mp:.3e} (L2), "
                    f"ratio {d_kp / max(d_mp, 1e-300):.3f} (tol {GAP_C})")
                if not d_kp <= GAP_C * d_mp:
                    failed.append(f"{net}'s {what} after 4 steps: kernels vs plain {d_kp} > "
                                  f"{GAP_C} x perturbed vs plain {d_mp}")
        rows, plain_rows, moved_rows = (_rows(runs[p][0].train.log_dir)
                                        for p in ("kernels", "plain", "perturbed"))
        if not [r["step"] for r in rows] == [r["step"] for r in plain_rows] == \
                [r["step"] for r in moved_rows] == [1, 3]:
            raise AssertionError(f"metrics rows at steps {[r['step'] for r in rows]}")
        for row, ref, moved in zip(rows, plain_rows, moved_rows):
            keys = sorted(set(ref) - {"step", "time"})
            if sorted(set(row) - {"step", "time"}) != keys:
                raise AssertionError(f"metrics keys differ at step {row['step']}")
            rel = {k: abs(row[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in keys}
            k = max(rel, key=rel.get)
            d_kp = float(np.sqrt(sum(r * r for r in rel.values())))
            d_mp = float(np.sqrt(sum(((moved[k] - ref[k]) / max(abs(ref[k]), 1e-30)) ** 2
                                     for k in keys)))
            say(f"  metrics row of step {row['step']} ({len(keys)} values): worst relative "
                f"difference {rel[k]:.3e} at {k}; ||kernels - plain||={d_kp:.3e}, "
                f"||perturbed - plain||={d_mp:.3e} (relative L2), ratio "
                f"{d_kp / max(d_mp, 1e-300):.3f}")
            if row["step"] == 1 and rel[k] > LOSS_RTOL:
                failed.append(f"metrics at step 1: {k} differs by {rel[k]} > {LOSS_RTOL}")
            if row["step"] > 1 and not d_kp <= GAP_C * d_mp:
                failed.append(f"metrics at step {row['step']}: kernels vs plain {d_kp} > "
                              f"{GAP_C} x perturbed vs plain {d_mp}")
        if failed:
            raise AssertionError(f"train_loop, kernels vs plain: {failed}")
    return counts


def _wait_for_rows(path, n_before, proc, deadline, log_path):
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            with open(log_path) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"the training subprocess exited early ({proc.returncode}); "
                                 f"its log ends:\n{tail}")
        if os.path.exists(path):
            with open(path) as f:
                if len(f.readlines()) > n_before:
                    return
        time.sleep(0.2)
    raise AssertionError("no metrics row from the training subprocess by its deadline")


def train_cli_phase(bare):
    """The command line on the card in bf16 (the default) at full width:
    --mode train (2 epochs, counted launches, step times beside the bare
    step's), a resume to epoch 3 (the restored tensors against the saved
    ones), a SIGTERM to a training subprocess, --mode export (against the
    checkpoint), --mode test with metrics on 8 camera images of the tree
    and on a folder of every JPEG and GIF fixture, and serving_models
    without a bundle answering one request."""
    import shmgan_tpu_torch.train.loop as loop
    from shmgan_tpu_torch import Config, cli
    from shmgan_tpu_torch.checkpoint import CheckpointManager, load_inference_bundle
    from shmgan_tpu_torch.convert import from_flax
    from shmgan_tpu_torch.data.codecs import decode, encode_png
    from shmgan_tpu_torch.data.synthetic import synth_eval_set, write_fixture_tree
    from shmgan_tpu_torch.runtime import flax_msgpack
    from shmgan_tpu_torch.serve import BatchInferenceEngine
    from shmgan_tpu_torch.train.state import state_payload

    with tempfile.TemporaryDirectory() as root:
        tree = os.path.join(root, "tree")
        write_fixture_tree(tree, CLI_SCENES, 128, seed=1)
        d = {k: os.path.join(root, k) for k in ("ckpt", "logs", "models", "results")}

        def argv(mode, *extra):
            return ["--mode", mode, "--data_dir", tree, "--batch_size", "8",
                    "--checkpoint_save_step", "1", "--checkpoint_save_dir", d["ckpt"],
                    "--log_dir", d["logs"], "--model_save_dir", d["models"],
                    "--result_dir", d["results"], *extra]

        def step_file(step):
            with open(os.path.join(d["ckpt"], str(step), "state.msgpack"), "rb") as f:
                return flax_msgpack.loads(f.read())

        finals = []
        real_train = loop.train

        def keep_final(*a, **k):
            finals.append(real_train(*a, **k))
            return finals[-1]

        # 1. --mode train: 2 epochs, 10 steps
        spy = _StepSpy(10)
        _launch_counts(reset=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with spy.patched(), mock.patch.object(loop, "train", keep_final):
            cli.main(argv("train", "--num_epochs", "2"))
        wall = time.perf_counter() - t0
        counts = _launch_counts(reset=True)
        want = {k: 10 * n for k, n in step_launches(torch.bfloat16).items()}
        if counts != want:
            raise AssertionError(f"--mode train launched {counts}, expected {want}")
        ms = spy.step_ms()
        med, b = float(np.median(ms)), 8
        say(f"--mode train, bf16: 10 loop steps in {wall:.2f} s of cli.main (tree decode, "
            f"models, checkpoints at steps 5 and 10 included); loop step ms "
            f"{[round(x, 2) for x in ms]}; median {med:.2f} ms ({b / med * 1e3:.2f} images/s) "
            f"against the bare step's median {bare['median_ms']:.2f} ms "
            f"({bare['images_per_s']:.2f} images/s) in train_bf16; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        ckpt = CheckpointManager(d["ckpt"])
        if ckpt.all_steps() != [5, 10] or finals[0].step != 10:
            raise AssertionError(f"checkpoints {ckpt.all_steps()}, final step {finals[0].step}")
        saved = step_file(10)
        _leaves_equal(saved, state_payload(finals[0]), "checkpoint 10 vs the final state")

        # 2. resume: epoch 3 of 3
        restored = []
        real_restore = CheckpointManager.restore

        def snapshot(self, template, *a, **k):
            t = time.perf_counter()
            out = real_restore(self, template, *a, **k)
            restored.append((time.perf_counter() - t, out and state_payload(out)))
            return out

        t0 = time.perf_counter()
        with mock.patch.object(CheckpointManager, "restore", snapshot), \
                mock.patch.object(loop, "train", keep_final):
            cli.main(argv("train", "--num_epochs", "3"))
        say(f"resume to epoch 3: {time.perf_counter() - t0:.2f} s of cli.main, the restore "
            f"{restored[0][0] * 1e3:.1f} ms")
        _leaves_equal(restored[0][1], saved, "restored state vs checkpoint 10")
        if finals[1].step != 15 or ckpt.all_steps() != [5, 10, 15]:
            raise AssertionError(f"resume ended at {finals[1].step}, {ckpt.all_steps()}")
        resumed = _launch_counts(reset=True)
        want5 = {k: 5 * n for k, n in step_launches(torch.bfloat16).items()}
        if resumed != want5:
            raise AssertionError(f"the resumed epoch launched {resumed}, expected {want5}")
        counts = _sum_counts(counts, resumed)

        # 3. SIGTERM to a training subprocess after its first metrics row
        rows_path = os.path.join(d["logs"], "metrics.jsonl")
        n_rows = len(_rows(d["logs"]))
        log_path = os.path.join(root, "sigterm.log")
        # the card is shared with the subprocess: give back what this
        # process's allocator keeps cached
        torch.cuda.empty_cache()
        say(f"device memory before the subprocess: {torch.cuda.memory_reserved() / 2**30:.2f} "
            f"GiB reserved here, {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free")
        with open(log_path, "w") as log:
            proc = subprocess.Popen([sys.executable, "-m", "shmgan_tpu_torch.cli",
                                     *argv("train", "--num_epochs", "50")], cwd=ROOT,
                                    stdout=log, stderr=subprocess.STDOUT)
            try:
                _wait_for_rows(rows_path, n_rows, proc, time.monotonic() + SIGTERM_DEADLINE_S,
                               log_path)
                t0 = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=SIGTERM_DEADLINE_S)
                stop_s = time.perf_counter() - t0
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        with open(log_path) as f:
            out = f.read()
        saves = [int(m) for m in re.findall(r"\[ckpt\] saved step (\d+)", out)]
        if rc != 0 or "[preempt] signal received" not in out or not saves:
            raise AssertionError(f"SIGTERM: exit {rc}, log tail {out[-2000:]}")
        reached = saves[-1]
        steps = ckpt.all_steps()
        say(f"SIGTERM after the first metrics row: exit {rc} {stop_s:.2f} s later, checkpoint "
            f"at step {reached}; kept {steps}")
        if reached <= 15 or steps != [10, 15, reached]:
            raise AssertionError(f"after SIGTERM: saved {saves}, kept {steps}")

        # 4. --mode export: the bundle against the checkpoint (no EMA: raw G)
        t0 = time.perf_counter()
        cli.main(argv("export"))
        export_s = time.perf_counter() - t0
        g_params, specseg_vars, header = load_inference_bundle(
            os.path.join(d["models"], "shmgan_infer.msgpack"))
        latest = step_file(reached)
        say(f"--mode export: {export_s:.2f} s of cli.main, bundle step {header['step']}")
        if header["step"] != reached:
            raise AssertionError(f"bundle of step {header['step']}, expected {reached}")
        _leaves_equal(g_params, latest["g_params"], "bundle G vs checkpoint")
        _leaves_equal(specseg_vars, latest["specseg_vars"], "bundle SpecSeg vs checkpoint")

        # 5. --mode test with metrics: the tree's first 8 scenes as a camera
        # sees them, against their diffuse truth
        inputs, truth, _ = synth_eval_set(8, 128, seed=1)
        for name, images in (("test", inputs), ("diffuse", truth)):
            os.makedirs(os.path.join(root, name))
            for i, img in enumerate(images):
                with open(os.path.join(root, name, f"img_{i:05d}.png"), "wb") as f:
                    f.write(encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8)))
        t0 = time.perf_counter()
        cli.main(argv("test", "--test_dir", os.path.join(root, "test"), "--diffuse_dir",
                      os.path.join(root, "diffuse"), "--calc_metrics", "true"))
        test_s = time.perf_counter() - t0
        tested = _launch_counts(reset=True)
        if tested["fused_standardize_yuv"] != 1 or tested[_in_name(torch.bfloat16)] != 18:
            raise AssertionError(f"--mode test on one batch launched {tested}")
        pngs = sorted(f for f in os.listdir(d["results"]) if f.endswith(".png"))
        with open(os.path.join(d["results"], "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        values = [v for r in rows for k, v in r.get("mean", r).items() if k != "image"]
        shapes = {decode(_read(os.path.join(d["results"], p))).shape for p in pngs}
        say(f"--mode test: {test_s:.2f} s of cli.main, {len(pngs)} PNGs of shapes {shapes}, "
            f"{len(rows)} metrics rows, mean {rows[-1]['mean']}; launches {tested}")
        if len(pngs) != 24 or len(rows) != 9 or not np.isfinite(values).all():
            raise AssertionError(f"--mode test wrote {len(pngs)} PNGs and {len(rows)} rows")
        counts = _sum_counts(counts, tested)

        # 5b. --mode test on a folder of every JPEG and GIF fixture, without metrics
        photos = os.path.join(root, "photos")
        os.makedirs(photos)
        fixtures = [n for n in codec_fixtures() if n.endswith((".jpg", ".gif"))]
        for n in fixtures:
            with open(os.path.join(photos, n), "wb") as f:
                f.write(_read(os.path.join(CODEC_DIR, n)))
        out_dir = os.path.join(root, "results_photos")
        t0 = time.perf_counter()
        cli.main(argv("test", "--test_dir", photos, "--result_dir", out_dir))
        photo_s = time.perf_counter() - t0
        on_photos = _launch_counts(reset=True)
        calls = -(-len(fixtures) // 8)
        want = {**{k: 0 for k in on_photos}, _in_name(torch.bfloat16): 18 * calls,
                "fused_standardize_yuv": calls}
        written = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        expected = sorted(f"result_{i:05d}{suffix}.png" for i in range(len(fixtures))
                          for suffix in ("", "_mask", "_composited"))
        shapes = {decode(_read(os.path.join(out_dir, p))).shape[:2] for p in written}
        say(f"--mode test on {len(fixtures)} JPEG and GIF fixtures: {photo_s:.2f} s of cli.main, "
            f"{len(written)} PNGs of shapes {shapes}, launches {on_photos}")
        if written != expected or on_photos != want or shapes != {(128, 128)}:
            raise AssertionError(f"--mode test on the JPEG folder: {len(written)} PNGs "
                                 f"(expected {len(expected)}), shapes {shapes}, launches "
                                 f"{on_photos}")
        counts = _sum_counts(counts, on_photos)

        # 6. serving without a bundle restores the checkpoint
        cfg = Config.from_args(argv("serve"))
        gen, specseg = cli.serving_models(cfg)
        want_g = from_flax(gen, latest["g_params"])
        if not all(np.array_equal(p.detach().cpu().numpy(), want_g[n])
                   for n, p in gen.named_parameters()):
            raise AssertionError("serving_models' G differs from the checkpoint's")
        out = BatchInferenceEngine(cfg, gen, specseg, batch_size=8,
                                   device="cuda").process_images(inputs)
        served = _launch_counts(reset=True)
        cal = out["gen_rgb_calibrated"]
        say(f"serving_models without a bundle: step {reached}'s G; one request of 8, "
            f"{cal.shape}, launches {served}")
        if cal.shape != (8, 128, 128, 3) or not np.isfinite(cal).all() \
                or served["fused_standardize_yuv"] != 1:
            raise AssertionError("the request on the restored weights failed")
        return _sum_counts(counts, served)


# specseg_train: the flagship trainer's phase A at its full width
SS_SIZE, SS_BATCH, SS_BASE, SS_CHUNK, SS_LR = 128, 32, 16, 100, 2e-4
# (curriculum, in_channels, steps): the shipped 256-px bundle's recipe first;
# steps in whole chunks, about 30 s each at the rates an H100 80GB HBM3 (700 W)
# read, 39.7 steps/s (dr2) and 46.2 (base)
SS_RECIPES = (("dr2", 2, 1200), ("base", 1, 1400))
SS_GAN_SCENES = 16        # cli --mode train at batch 8: 2 steps
# one step, card vs CPU, from the same weights, batch and keep masks: the
# optimizer's first moment after it, (1 - b1) clip(g), by the train step's
# gradient rule (GRAD_NORM_RTOL as a whole, GRAD_LEAF_RTOL a leaf). Each
# BatchNorm's backward subtracts the batch means of its gradient, and a leaf
# below it keeps the residue's rounding: an H100 read 3.6e-5 as a whole but
# 8.4e-2 of its largest at bottom.conv0.weight, where the CPU test's 1e-4 a
# leaf was the first choice. The parameters add nothing: Adam's first step
# moves each element by about lr whatever its gradient's size. The running
# statistics (a 0.01 share of the batch's) within SS_STATS_RTOL of their
# leaf's scale; dice, focal and the loss within SS_LOSS_RTOL; the IoU within
# SS_IOU_ATOL, as a pixel at the 0.5 threshold may fall either way (an H100
# read 2.9e-7, 1.1e-7 and an equal IoU).
SS_STATS_RTOL, SS_LOSS_RTOL, SS_IOU_ATOL = 1e-4, 1e-4, 1e-3
# renders, card vs CPU on the same draws: within SS_RENDER_ATOL at all but
# SS_EDGE_PIXELS pixels a batch, where a hard edge (a Voronoi tie, a stripe's
# sign, the mask's 0.25 threshold) may fall either way (an H100 read 0 such
# pixels in every render); the standardised Y within SS_STD_RTOL of its
# image's scale, two float32 means over h*w values summed in another order
# (an H100 read 8.1e-6 on the base Y, 1.93e-5 on dr3's, whose spectrum
# texture's FFT rounds otherwise too).
SS_RENDER_ATOL, SS_EDGE_PIXELS, SS_STD_RTOL = 1e-5, 4, 4e-5


def _ss_cfg(in_channels):
    from shmgan_tpu_torch import Config

    cfg = Config()
    cfg.model.image_size, cfg.model.specseg_base_filters = SS_SIZE, SS_BASE
    cfg.model.specseg_in_channels = in_channels
    cfg.train.g_lr = SS_LR
    return cfg


def _ss_step_check(what="dr2, 2 channels", img=None, msk=None):
    """One make_specseg_train_step on the card against one on the CPU, from
    the same weights, batch and keep masks (by default the dr2 recipe at 2
    channels, its batch drawn on the CPU; else the CPU batch `img`, `msk` at
    its channel count): the optimizer's first moment (the step's
    gradients), the new running statistics and the metrics."""
    from shmgan_tpu_torch.data.synthetic_dr import synth_specseg_batch_dr_chroma
    from shmgan_tpu_torch.train.specseg_train import (create_specseg_state,
                                                      make_specseg_train_step,
                                                      specseg_vars_from_state)

    if img is None:
        g = torch.Generator().manual_seed(3)
        img, msk = synth_specseg_batch_dr_chroma(g, SS_BATCH, SS_SIZE, SS_SIZE, glints=True)
    cfg = _ss_cfg(img.shape[-1])
    out = {}
    for dev in ("cpu", "cuda"):
        state = create_specseg_state(cfg, torch.Generator().manual_seed(4), dev)
        keep = state.net.sample_keep(torch.Generator().manual_seed(5), SS_BATCH, SS_SIZE,
                                     SS_SIZE)
        t0 = time.perf_counter()
        state, m = make_specseg_train_step(cfg)(state, img.to(dev), msk.to(dev),
                                                [k.to(dev) for k in keep])
        secs = time.perf_counter() - t0
        mu = {k: v.cpu() for k, v in state.opt.moments()[0].items()}
        stats = dict(_paths(specseg_vars_from_state(state)["batch_stats"]))
        out[dev] = (mu, stats, {k: float(v) for k, v in m.items()}, secs)
    (g_mu, g_st, gm, gs), (c_mu, c_st, cm, cs) = out["cuda"], out["cpu"]
    label = (f"one SpecSeg step ({what}, b{SS_BATCH}, {SS_SIZE} px, base {SS_BASE}), "
             f"card vs CPU: first moment")
    mu_ok = _compare_grads(g_mu, c_mu, label)
    s_err = max(float(np.abs(g_st[k] - c_st[k]).max() / np.abs(c_st[k]).max()) for k in c_st)
    m_err = {k: abs(gm[k] - cm[k]) / (1.0 if k == "iou" else max(abs(cm[k]), 1e-30))
             for k in cm}
    say(f"  the same step: batch_stats max|diff|/scale {s_err:.3e} (tol {SS_STATS_RTOL}); "
        f"metrics card {gm} CPU {cm}, relative differences "
        f"{ {k: f'{v:.2e}' for k, v in m_err.items()} } (tol {SS_LOSS_RTOL}, IoU "
        f"{SS_IOU_ATOL} absolute); card {gs * 1e3:.1f} ms (first call), CPU {cs:.2f} s")
    if not mu_ok or s_err > SS_STATS_RTOL or any(
            m_err[k] > (SS_IOU_ATOL if k == "iou" else SS_LOSS_RTOL) for k in m_err):
        raise AssertionError("the SpecSeg step on the card differs from the CPU's")


def _ss_render_check():
    """Both curricula's renders on the card against the CPU on the same
    draws (DR: dr3's, every texture family, the photo composite and its FFT,
    glints)."""
    from shmgan_tpu_torch.data import synthetic_device as sd
    from shmgan_tpu_torch.data import synthetic_dr as sdr

    g = torch.Generator().manual_seed(6)
    base = sd.synth_specseg_rgb_batch_draws(g, SS_BATCH, SS_SIZE, SS_SIZE)
    dr = sdr.synth_specseg_batch_dr_draws(g, SS_BATCH, SS_SIZE, SS_SIZE, base_mix=0.5,
                                          glints=True, photo=True)
    views = sd.synth_views_batch_draws(g, 8, SS_SIZE, SS_SIZE)
    renders = [
        ("base rgb, mask", lambda d: sd.synth_specseg_rgb_batch_render(d, SS_SIZE, SS_SIZE),
         base, (False, False)),
        ("base Y, mask", lambda d: sd.synth_specseg_batch_render(d, SS_SIZE, SS_SIZE), base,
         (True, False)),
        ("views (5, 8), swap 0.5", lambda d: (sd.synth_views_batch_render(
            d, SS_SIZE, SS_SIZE, "min", 0.5),), views, (False,)),
        ("dr3 chroma [Y | prior], mask",
         lambda d: sdr.synth_specseg_batch_dr_chroma_render(d, SS_SIZE, SS_SIZE), dr,
         (True, False)),
    ]
    worst = {}
    for label, render, draws, standardized in renders:
        cpu = render(draws)
        card = render(sd.map_draws(lambda x: x.cuda(), draws))
        for i, (c, k, std) in enumerate(zip(cpu, card, standardized)):
            c, k = c.numpy(), k.cpu().numpy()
            if std:  # the standardised Y plane: relative to its image's scale
                scale = np.abs(c[..., :1]).max(axis=(1, 2, 3), keepdims=True)
                err = np.abs(k[..., :1] - c[..., :1]) / scale
                bad = (err > SS_STD_RTOL).reshape(-1).sum()
                rest = np.abs(k[..., 1:] - c[..., 1:])
                bad += (rest > SS_RENDER_ATOL).reshape(-1).sum() if rest.size else 0
                e = max(float(err.max()), float(rest.max()) if rest.size else 0.0)
            else:
                diff = np.abs(k - c).reshape(-1, c.shape[-1])
                bad, e = int((diff > SS_RENDER_ATOL).any(axis=1).sum()), float(diff.max())
            worst[f"{label} [{i}]"] = e
            say(f"  render {label} [{i}] {c.shape}: card vs CPU max|diff| {e:.3e}, "
                f"{int(bad)} pixels past the tolerance (at most {SS_EDGE_PIXELS})")
            if bad > SS_EDGE_PIXELS:
                raise AssertionError(f"render {label} [{i}] on the card differs from the CPU")
    return worst


class _SpecSegSpy:
    """Stands in for quality_train's make_specseg_train_step: keeps each
    step's loss (a device scalar, no synchronisation) and, at each chunk's
    first step, the host time after a synchronisation (the loop waits for the
    device at each chunk's end anyway)."""

    def __init__(self, chunk: int):
        from shmgan_tpu_torch.train.specseg_train import make_specseg_train_step

        self._make, self.chunk = make_specseg_train_step, chunk
        self.losses, self.stamps = [], []

    def _wrapped(self, cfg):
        inner = self._make(cfg)

        def step(*args):
            if len(self.losses) % self.chunk == 0:
                torch.cuda.synchronize()
                self.stamps.append(time.perf_counter())
            out = inner(*args)
            self.losses.append(out[1]["loss"])
            return out

        return step

    def patched(self):
        return mock.patch("shmgan_tpu_torch.quality_train.make_specseg_train_step",
                          self._wrapped)

    def chunk_losses(self):
        loss = torch.stack(self.losses).view(-1, self.chunk).mean(dim=1)
        return loss.cpu().tolist()


def _ss_train(root, curriculum, in_channels, steps):
    """quality_train.main --phase specseg for `steps`; returns the exported
    file and the numbers."""
    from shmgan_tpu_torch import quality_train as qt
    from shmgan_tpu_torch.train.specseg_train import create_specseg_state

    out = os.path.join(root, f"specseg_{curriculum}_{in_channels}")
    argv = ["--phase", "specseg", "--image_size", str(SS_SIZE), "--specseg_batch",
            str(SS_BATCH), "--specseg_base_filters", str(SS_BASE), "--chunk", str(SS_CHUNK),
            "--specseg_lr", str(SS_LR), "--specseg_curriculum", curriculum,
            "--specseg_in_channels", str(in_channels), "--specseg_steps", str(steps),
            "--out", out]
    a = qt.parse_args(argv)
    untrained = create_specseg_state(_ss_cfg(in_channels), torch.Generator().manual_seed(a.seed),
                                     "cuda").net.eval()
    score0, base0, dr0 = qt.make_probe(a, "cuda")(untrained)
    del untrained

    spy = _SpecSegSpy(SS_CHUNK)
    _launch_counts(reset=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with spy.patched():
        summary = qt.main(argv)["specseg"]
    wall = time.perf_counter() - t0
    launched = _launch_counts(reset=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunk_s = np.diff(spy.stamps)
    med = float(np.median(chunk_s))
    losses = spy.chunk_losses()
    sel = summary["selected"]
    say(f"quality_train --phase specseg {curriculum} at {in_channels} channel(s): {steps} steps, "
        f"{wall:.2f} s of main; chunk of {SS_CHUNK} steps median {med:.3f} s: "
        f"{SS_CHUNK / med:.2f} steps/s, {SS_CHUNK * SS_BATCH / med:.1f} images/s; peak device "
        f"memory {peak:.3f} GiB; loss of the first chunk {losses[0]:.4f}, of the last "
        f"{losses[-1]:.4f}; selected {sel['kind']}@{sel['step']} probe score "
        f"{sel['score']:.4f} (base IoU "
        f"{summary['heldout_iou']:.4f}, DR IoU {sel['heldout_dr_iou']}) against the untrained "
        f"net's {score0:.4f} (base {base0:.4f}, DR {dr0}) on the same probe; kernel launches "
        f"{launched}")
    if any(launched.values()):
        raise AssertionError(f"SpecSeg training launched kernels: {launched}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not sel["score"] > score0:
        raise AssertionError(f"selected score {sel['score']} <= untrained {score0}")
    return summary["weights"], dict(
        curriculum=curriculum, in_channels=in_channels, steps=steps, steps_per_s=SS_CHUNK / med,
        images_per_s=SS_CHUNK * SS_BATCH / med, peak_gib=peak, first_loss=losses[0],
        last_loss=losses[-1], selected=sel, untrained_score=score0)


def specseg_train_phase():
    """The flagship trainer's phase A on the card: one step and the
    curricula's renders against the CPU; quality_train at full width for the
    shipped bundle's recipe (dr2, 2 channels) and the base one; the export
    reloaded and served (one preprocess launch); two GAN steps of cli --mode
    train on it."""
    from shmgan_tpu_torch import cli
    from shmgan_tpu_torch.checkpoint import load_specseg_weights, specseg_in_channels_of
    from shmgan_tpu_torch.convert import load_flax
    from shmgan_tpu_torch.data.synthetic import synth_eval_set, write_fixture_tree
    from shmgan_tpu_torch.infer import make_mask_fn
    from shmgan_tpu_torch.models.specseg import SpecSeg

    _ss_step_check()
    _ss_render_check()
    with tempfile.TemporaryDirectory() as root:
        runs = [_ss_train(root, *recipe) for recipe in SS_RECIPES]
        path = runs[0][0]

        # reload the shipped recipe's export, channels from the file; serve b8
        variables = load_specseg_weights(path)
        in_ch = specseg_in_channels_of(variables)
        cfg = _ss_cfg(in_ch)
        net = SpecSeg(base_filters=SS_BASE, in_channels=in_ch)
        load_flax(net, variables["params"], variables["batch_stats"])
        net = net.cuda().eval()
        rgb = torch.from_numpy(synth_eval_set(8, SS_SIZE, seed=2)[0]).cuda()
        _launch_counts(reset=True)
        mask = make_mask_fn(cfg)(net, rgb)
        torch.cuda.synchronize()
        served = _launch_counts(reset=True)
        m = mask.cpu().numpy()
        say(f"{path} reloaded ({in_ch} input channels detected) and served through "
            f"make_mask_fn: mask {m.shape}, coverage {float((m > 0.5).mean()):.4f}; "
            f"launches {served}")
        if in_ch != 2 or m.shape != (8, SS_SIZE, SS_SIZE, 1) or not np.isfinite(m).all() \
                or served["fused_standardize_yuv"] != 1 or sum(served.values()) != 1:
            raise AssertionError("serving the exported SpecSeg failed")

        # two GAN steps of cli --mode train on the exported SpecSeg
        tree = os.path.join(root, "tree")
        write_fixture_tree(tree, SS_GAN_SCENES, SS_SIZE, seed=3)
        argv = ["--mode", "train", "--data_dir", tree, "--batch_size", "8", "--num_epochs", "1",
                "--image_size", str(SS_SIZE), "--specseg_weights", path,
                "--specseg_in_channels", str(in_ch),
                "--checkpoint_save_dir", os.path.join(root, "ckpt"), "--log_dir",
                os.path.join(root, "logs"), "--model_save_dir", os.path.join(root, "models"),
                "--result_dir", os.path.join(root, "results")]
        t0 = time.perf_counter()
        cli.main(argv)
        gan_s = time.perf_counter() - t0
        gan = _launch_counts(reset=True)
        want = {k: 2 * n for k, n in step_launches(torch.bfloat16).items()}
        rows = _rows(os.path.join(root, "logs"))
        say(f"cli --mode train on the exported SpecSeg: {gan_s:.2f} s of cli.main, "
            f"{len(rows)} metrics rows; launches {gan}")
        if gan != want or not rows:
            raise AssertionError(f"the GAN steps launched {gan}, expected {want}")
    return _sum_counts(served, gan)


# quality_gan: phase B at the trained 256-px bundle's recipe
# (benchmarks/quality_r5_dr256/quality_summary.json's args)
QG_SIZE, QG_BATCH, QG_CHUNK = 256, 10, 50
# about 30 s of training at the 192.4 ms a step an H100 80GB HBM3 (700 W)
# read; evals at half of it (the first after 100 steps) and at the end
QG_STEPS, QG_EVAL_EVERY = 150, 75
QG_EVAL_N, QG_FID_DRAWS, QG_SMALL_BATCH = 64, 3, 2
QG_RECIPE = ("--phase", "gan", "--image_size", str(QG_SIZE), "--batch", str(QG_BATCH),
             "--gan_curriculum", "dr", "--upsample_mode", "resize_conv", "--g_ema", "0.999",
             "--specseg_in_channels", "2")
# the f32 step at b2, kernels vs plain: each leaf by GRAD_LEAF_RTOL, each
# net by LOOP_MOMENT_RTOL, as train_loop's tree batch: the DR views hold
# near-constant IN planes, where the kernel's one-pass moments (the TPU
# kernel's arithmetic) part from the plain version's two-pass ones (an H100
# read D 2.007e-3 here against the train step's 2e-3, and 2.95e-3 on the
# tree's batch with cuDNN's choice fixed: profile_train.py --loop-gap)
# one oracle chunk, card vs CPU, f32 on the bundle's weights: each image's
# PSNR within QG_PSNR_ATOL dB and SSIM within QG_SSIM_ATOL, the calibrated
# output and the mask within SERVE_ATOL, the features within QG_FEAT_RTOL of
# their largest (convolutions and means summed in another order)
QG_PSNR_ATOL, QG_SSIM_ATOL, QG_FEAT_RTOL = 1e-2, 1e-4, 1e-4


def gan_step_launches(dtype):
    """Launches of one phase-B step: G1 is live (live_g1), so all 46 IN
    sites have a backward."""
    return {**step_launches(dtype), _in_name(dtype, "backward"): 46}


class _BwdVariants:
    """Counts the IN backward's launches by (variant, activation dtype)."""

    def __init__(self):
        self.counts = {}

    def patched(self):
        from shmgan_tpu_torch.ops.kernels import instance_norm as ink

        real = ink._launch_backward

        def launch(x, gamma, mean, rstd, g, plan):
            key = f"{plan.variant}/{'bf16' if x.dtype == torch.bfloat16 else 'f32'}"
            self.counts[key] = self.counts.get(key, 0) + 1
            return real(x, gamma, mean, rstd, g, plan)

        return mock.patch.object(ink, "_launch_backward", launch)


def _qg_cfg(dtype):
    from shmgan_tpu_torch import quality_train as qt

    return qt.build_cfg(qt.parse_args(list(QG_RECIPE) + ["--dtype", dtype]))


def _qg_step(cfg, bundle, views, draws, plain):
    """One phase-B step (debug_grads) from the bundle's G and SpecSeg and a
    seeded D: its metrics on the host, its launches, its backward variants."""
    from shmgan_tpu_torch.convert import load_inference_weights
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_serve import plain_versions
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import make_train_step

    gen, disc, specseg = build_models(cfg, device="cpu", seed=0)
    load_inference_weights(gen, specseg, bundle[0], bundle[1])
    state = create_train_state(cfg, (gen.cuda(), disc.cuda(), specseg.cuda()))
    variants = _BwdVariants()
    _launch_counts(reset=True)
    with plain_versions() if plain else nullcontext(), variants.patched():
        _, m = make_train_step(cfg, debug_grads=True)(state, views, draws, 1)
    torch.cuda.synchronize()
    counts = _launch_counts(reset=True)
    host = {k: {net: {n: g.cpu() for n, g in grads.items()} for net, grads in v.items()}
            if k == "_grads" else v.cpu() for k, v in m.items()}
    del state, m
    torch.cuda.empty_cache()
    return host, counts, variants.counts


def _qg_step_checks(bundle):
    """Phase B's step at 256 px through the kernels against the plain
    versions: bf16 at b10 by the gap rule (the f32 step on the same weights,
    views and draws as the yardstick), f32 at b2 by the train step's rule.
    Returns one bf16 step's backward variants."""
    from shmgan_tpu_torch import quality_train as qt
    from shmgan_tpu_torch.train.step import sample_draws

    s, v = QG_SIZE, 5
    out = {}
    # (batch, dtypes, the dtype held kernels vs plain): the f32 step at b10 is
    # the bf16 gap rule's yardstick, run once
    for b, dtypes, held in ((QG_BATCH, ("float32", "bfloat16"), "bfloat16"),
                            (QG_SMALL_BATCH, ("float32",), "float32")):
        gen = qt.stream(25, qt.GAN_STREAM + b, "cuda")
        views = qt.sdr.synth_views_batch_dr(gen, b, s, s, ed_mode="diffuse",
                                            camera_swap_prob=0.25)
        draws = sample_draws(_qg_cfg("float32"), gen, v, b, s, s)
        runs = {}
        for dtype in dtypes:
            cfg = _qg_cfg(dtype)
            torch.cuda.reset_peak_memory_stats()
            for path in ("kernels", "plain") if dtype == held else ("kernels",):
                runs[dtype, path] = _qg_step(cfg, bundle, views, draws, path == "plain")
                m, counts, variants = runs[dtype, path]
                want = gan_step_launches(getattr(torch, dtype)) if path == "kernels" else {
                    k: 0 for k in counts}
                say(f"phase-B step {dtype}, b{b}, {s} px, {path}: launches {counts}, backward "
                    f"variants {variants}; peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
                if counts != want:
                    raise AssertionError(f"phase-B step {dtype} b{b} {path}: launches {counts}, "
                                         f"expected {want}")
        if held == "bfloat16":
            _compare_step_gap([(runs["bfloat16", "kernels"][0], runs["bfloat16", "plain"][0],
                                runs["float32", "kernels"][0])],
                              f"phase-B step kernels vs plain, bf16, b{b}, {s} px:")
            out["bf16_variants"] = runs["bfloat16", "kernels"][2]
        else:
            _compare_step(runs["float32", "kernels"][0], runs["float32", "plain"][0],
                          f"phase-B step kernels vs plain, f32, b{b}, {s} px:",
                          LOOP_MOMENT_RTOL)
            out["f32_variants"] = runs["float32", "kernels"][2]
        del runs
        torch.cuda.empty_cache()
    for key, dtype in (("bf16_variants", "bf16"), ("f32_variants", "f32")):
        if not out[key].get(f"streaming/{dtype}"):
            raise AssertionError(f"no streaming IN backward in the {dtype} step: {out[key]}")
    return out["bf16_variants"]


def _qg_oracle_check(bundle):
    """One oracle chunk (draw 0, 8 images, f32) on the card against the CPU."""
    from shmgan_tpu_torch import Config
    from shmgan_tpu_torch import quality_train as qt
    from shmgan_tpu_torch.data.synthetic import synth_eval_set
    from shmgan_tpu_torch.infer import make_infer_fn

    ins, gts, _ = synth_eval_set(8, QG_SIZE, seed=qt.EVAL_DRAW_SEEDS[0])
    res = {}
    for dev in ("cpu", "cuda"):
        cfg = Config()
        cfg.model.compute_dtype = "float32"
        gen, specseg = bundle_models(cfg, bundle, dev)
        infer = make_infer_fn(cfg, outputs=("gen_rgb_calibrated", "mask"))
        t0 = time.perf_counter()
        out = qt.oracle_chunk(infer, gen, specseg, torch.from_numpy(ins).to(dev),
                              torch.from_numpy(gts).to(dev))
        out = [[x.cpu().numpy() for x in o] if isinstance(o, tuple) else o.cpu().numpy()
               for o in out]
        res[dev] = (out, time.perf_counter() - t0)
        del gen, specseg
    (card, card_s), (cpu, cpu_s) = res["cuda"], res["cpu"]
    _launch_counts(reset=True)
    errs = {"psnr": max(np.abs(card[i][0] - cpu[i][0]).max() for i in (0, 1)),
            "ssim": max(np.abs(card[i][1] - cpu[i][1]).max() for i in (0, 1)),
            "features": max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in
                            ((card[0][2], cpu[0][2]), (card[1][2], cpu[1][2]),
                             (card[2], cpu[2]))),
            "calibrated": float(np.abs(card[3] - cpu[3]).max()),
            "mask": float(np.abs(card[4] - cpu[4]).max())}
    say(f"one oracle chunk (8 images, {QG_SIZE} px, f32), card vs CPU: max|diff| PSNR "
        f"{errs['psnr']:.3e} dB (tol {QG_PSNR_ATOL}), SSIM {errs['ssim']:.3e} (tol "
        f"{QG_SSIM_ATOL}), features {errs['features']:.3e} of scale (tol {QG_FEAT_RTOL}), "
        f"calibrated {errs['calibrated']:.3e}, mask {errs['mask']:.3e} (tol {SERVE_ATOL}); "
        f"gen PSNR card {card[0][0].mean():.3f} dB, input {card[1][0].mean():.3f}; card "
        f"{card_s * 1e3:.1f} ms (first call), CPU {cpu_s:.2f} s")
    if errs["psnr"] > QG_PSNR_ATOL or errs["ssim"] > QG_SSIM_ATOL \
            or errs["features"] > QG_FEAT_RTOL or errs["calibrated"] > SERVE_ATOL \
            or errs["mask"] > SERVE_ATOL:
        raise AssertionError(f"the oracle chunk on the card differs from the CPU's: {errs}")


class _GanSpy:
    """Stands in for quality_train's make_train_step, make_oracle and
    frechet_distance: a synchronisation and a host time at each chunk's
    first step and at each eval's start and end, the launches of each eval,
    the seconds in its FIDs."""

    def __init__(self, chunk: int):
        from shmgan_tpu_torch import quality_train as qt

        self._qt, self.chunk = qt, chunk
        self._real = {"make_train_step": qt.make_train_step, "make_oracle": qt.make_oracle,
                      "frechet_distance": qt.frechet_distance}
        self.steps, self.chunk_starts, self.evals = 0, [], []
        self._fid_s = 0.0

    def _make_step(self, cfg, debug_grads=False):
        inner = self._real["make_train_step"](cfg, debug_grads)

        def step(*args):
            if self.steps % self.chunk == 0:
                torch.cuda.synchronize()
                self.chunk_starts.append(time.perf_counter())
            self.steps += 1
            return inner(*args)

        return step

    def _make_oracle(self, *args):
        oracle = self._real["make_oracle"](*args)

        def timed():
            torch.cuda.synchronize()
            before, t0, self._fid_s = _launch_counts(), time.perf_counter(), 0.0
            out = oracle()
            torch.cuda.synchronize()
            after = _launch_counts()
            self.evals.append(dict(start=t0, secs=time.perf_counter() - t0, fid_s=self._fid_s,
                                   at_step=self.steps,
                                   launches={k: after[k] - before[k] for k in after}))
            return out

        timed.gallery_inputs = oracle.gallery_inputs
        timed.eval_gen, timed.eval_specseg = oracle.eval_gen, oracle.eval_specseg
        return timed

    def _fid(self, a, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._real["frechet_distance"](a, b)
        float(out)
        self._fid_s += time.perf_counter() - t0
        return out

    def patched(self):
        from contextlib import ExitStack

        stack = ExitStack()
        for name, fn in (("make_train_step", self._make_step), ("make_oracle", self._make_oracle),
                         ("frechet_distance", self._fid)):
            stack.enter_context(mock.patch.object(self._qt, name, fn))
        return stack

    def chunk_secs(self):
        """Each chunk's seconds: from its first step to the next chunk's, or
        to the eval that follows it."""
        marks = sorted(self.chunk_starts[1:] + [e["start"] for e in self.evals])
        return [min(m for m in marks if m > t) - t for t in self.chunk_starts]


def quality_gan_phase():
    """Phase B on the card at the 256-px recipe: the step and an oracle chunk
    checked, then quality_train.main warm-started from the trained bundle."""
    from shmgan_tpu_torch import Config
    from shmgan_tpu_torch import quality_train as qt
    from shmgan_tpu_torch.checkpoint import load_inference_bundle, save_specseg_msgpack
    from shmgan_tpu_torch.data.synthetic import synth_eval_set
    from shmgan_tpu_torch.serve import BatchInferenceEngine

    bundle = load_inference_bundle(os.path.join(ROOT, BUNDLE))
    per_step_variants = _qg_step_checks(bundle)
    _qg_oracle_check(bundle)
    with tempfile.TemporaryDirectory() as root:
        ss_path = os.path.join(root, "specseg.msgpack")
        save_specseg_msgpack(bundle[1], ss_path)
        out = os.path.join(root, "gan")
        argv = list(QG_RECIPE) + [
            "--dtype", "bfloat16", "--chunk", str(QG_CHUNK), "--gan_steps", str(QG_STEPS),
            "--eval_every", str(QG_EVAL_EVERY), "--eval_n", str(QG_EVAL_N), "--fid_draws",
            str(QG_FID_DRAWS), "--init_from_bundle", os.path.join(ROOT, BUNDLE),
            "--specseg_out", ss_path, "--out", out]
        del bundle
        torch.cuda.empty_cache()
        spy, variants = _GanSpy(QG_CHUNK), _BwdVariants()
        _launch_counts(reset=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with spy.patched(), variants.patched():
            summary = qt.main(argv)["gan"]
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = _launch_counts(reset=True)

        chunk_s = spy.chunk_secs()
        steady = float(np.median(chunk_s[1:] if len(chunk_s) > 1 else chunk_s))
        step_ms = steady / QG_CHUNK * 1e3
        hist = summary["history"]
        say(f"quality_train --phase gan ({QG_SIZE} px, b{QG_BATCH}, bf16, dr, resize_conv, "
            f"g_ema 0.999, from {BUNDLE}): {QG_STEPS} steps, {wall:.2f} s of main; chunks of "
            f"{QG_CHUNK} steps {[round(c, 3) for c in chunk_s]} s; step {step_ms:.2f} ms "
            f"(chunks after the first), {QG_BATCH / step_ms * 1e3:.1f} images/s; peak device "
            f"memory {peak:.3f} GiB")
        for e, row in zip(spy.evals, hist):
            say(f"  eval @{row['step']}: {e['secs']:.3f} s ({QG_FID_DRAWS} draws x "
                f"{QG_EVAL_N} images), of which FID {e['fid_s']:.3f} s; gen PSNR "
                f"{row['gen_psnr']} SSIM {row['gen_ssim']} FID {row['gen_fid']} (draws "
                f"{row.get('gen_fid_draws')}); input PSNR {row['input_psnr']} SSIM "
                f"{row['input_ssim']} FID {row['input_fid']}; beats identity "
                f"{row['beats_identity']}; launches {e['launches']}")
        oracle_total = _sum_counts(*(e["launches"] for e in spy.evals))
        train = {k: counts[k] - oracle_total[k] for k in counts}
        want_train = {k: QG_STEPS * n for k, n in gan_step_launches(torch.bfloat16).items()}
        chunks = QG_FID_DRAWS * (QG_EVAL_N // 8)
        want_eval = {**{k: 0 for k in counts}, _in_name(torch.float32): 18 * chunks,
                     "fused_standardize_yuv": chunks}
        want_variants = {k: QG_STEPS * n for k, n in per_step_variants.items()}
        say(f"  launches: training {train} (expected {want_train}); each eval expected "
            f"{want_eval}; IN backward by variant {variants.counts} (expected "
            f"{want_variants}: {QG_STEPS} x one step's)")
        if train != want_train or any(e["launches"] != want_eval for e in spy.evals) \
                or variants.counts != want_variants:
            raise AssertionError("phase B launched other kernels than predicted")
        if len(hist) != 2 or len(spy.evals) != 2 or not hist[0]["beats_identity"]:
            raise AssertionError(f"phase B's evals {hist}: the first must beat the identity")

        # the best bundle reloaded and serving one request
        best = load_inference_bundle(os.path.join(out, "best_bundle.msgpack"))
        cfg = Config()
        gen, specseg = bundle_models(cfg, best)
        rgb = synth_eval_set(8, QG_SIZE, seed=4)[0]
        _launch_counts(reset=True)
        served = BatchInferenceEngine(cfg, gen, specseg, batch_size=8,
                                      device="cuda").process_images(rgb)
        served_counts = _launch_counts(reset=True)
        cal = served["gen_rgb_calibrated"]
        say(f"  best_bundle.msgpack (step {best[2]['step']}, {best[2]['store_dtype']}) served "
            f"8 images: {cal.shape}, launches {served_counts}")
        if cal.shape != (8, QG_SIZE, QG_SIZE, 3) or not np.isfinite(cal).all() \
                or served_counts["fused_standardize_yuv"] != 1:
            raise AssertionError("serving the best bundle failed")
    return counts


DP_RANKS = 2          # two ranks of one gloo group, both on the one card
DP_TIMED_STEPS = 3    # timed steps a rank, and of the one-rank step beside them
DP_SEED = 14
DP_SCENES = 16        # cli --mode train at batch 8: 2 steps


def _dp_inputs(cfg):
    """The global batch's views and draws of the data_parallel phase, the
    same on every rank and in the one-rank reference: a seeded generator on
    the card."""
    from shmgan_tpu_torch.train.step import sample_draws

    v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
    gen = torch.Generator(device="cuda").manual_seed(DP_SEED)
    views = torch.rand((v, b, size, size, 3), device="cuda", generator=gen)
    return views, sample_draws(cfg, gen, v, b, size, size), gen


def dp_rank(workdir):
    """One rank of the data_parallel phase (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT from the environment, LOCAL_RANK 0): joins the gloo group,
    broadcasts the seeded state from rank 0, and in f32 and bf16 takes one
    step on its block of the global batch, counted (and with its averaged
    gradients in f32), then DP_TIMED_STEPS timed steps; writes
    <workdir>/rank<r>.pt."""
    from shmgan_tpu_torch.data.pipeline import local_batch
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.parallel.mesh import (maybe_initialize_distributed, rank,
                                                shutdown_distributed, world_size)
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.state import broadcast_state, create_train_state
    from shmgan_tpu_torch.train.step import make_train_step, sample_draws

    if not maybe_initialize_distributed("gloo"):
        raise RuntimeError("dp_rank: no launcher environment")
    r, n = rank(), world_size()
    out = {}
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = training_config(dtype)
            state = broadcast_state(create_train_state(
                cfg, build_models(cfg, device="cuda", seed=0)))
            views, draws, gen = _dp_inputs(cfg)
            local, mine = local_batch(views, r, n), draws.shard(r, n)
            step = make_train_step(cfg, debug_grads=dtype == "float32")
            step(copy.deepcopy(state), local, mine, 0)  # warm-up: cuDNN's choices
            torch.cuda.synchronize()
            _launch_counts(reset=True)
            state, m = step(state, local, mine, 0)
            torch.cuda.synchronize()
            counts = _launch_counts(reset=True)
            fast, times = make_train_step(cfg), []
            v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
            for _ in range(DP_TIMED_STEPS):
                views = torch.rand((v, b, size, size, 3), device="cuda", generator=gen)
                d = sample_draws(cfg, gen, v, b, size, size).shard(r, n)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = fast(state, local_batch(views, r, n), d, 0)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            _launch_counts(reset=True)
            cpu = lambda t: t.detach().cpu()  # noqa: E731
            out[dtype] = {
                "counts": counts, "ms": [t * 1e3 for t in times],
                "metrics": {k: (({net: {name: cpu(g) for name, g in grads.items()}
                                  for net, grads in val.items()}) if k == "_grads" else cpu(val))
                            for k, val in m.items() if k != "_drop"},
                "params": {f"{net}.{k}": cpu(p) for net, mod in (("G", state.gen),
                                                                ("D", state.disc))
                           for k, p in mod.named_parameters()}}
            del state, m
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(workdir, f"rank{r}.pt"))
    finally:
        shutdown_distributed()


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(workdir, target, n, prefix, timeout):
    """n processes of `target` ("module.function", called with `workdir`), one
    gloo group on a free port; each is killed if it outlives `timeout`.
    Raises with a rank's output if it fails; returns each rank's
    <workdir>/<prefix><r>.pt."""
    module = target.rpartition(".")[0]
    env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import {module}; {target}({workdir!r})"],
                              cwd=ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{target} rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return [torch.load(os.path.join(workdir, f"{prefix}{r}.pt"), weights_only=False)
            for r in range(n)]


def _dp_step_checks(tmp):
    """Two ranks against one: launches, rank agreement, the f32 step by
    _compare_step; returns the ranks' step launches."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import make_train_step, sample_draws

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _run_ranks(tmp, "chip_smoke.dp_rank", DP_RANKS, "rank", 300)
    say(f"{DP_RANKS} ranks (gloo, one card, 4 images a rank of the global batch 8) ran in "
        f"{time.perf_counter() - t0:.1f} s")
    totals = {k: 0 for k in _launch_counts()}
    for dtype, torch_dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        want = step_launches(torch_dtype)
        for r, res in enumerate(ranks):
            counts = res[dtype]["counts"]
            say(f"rank {r} {dtype}: one step launched {counts}; step ms "
                f"{[round(t, 2) for t in res[dtype]['ms']]}")
            if counts != want:
                raise AssertionError(f"rank {r} {dtype}: launches {counts}, expected {want}")
            totals = _sum_counts(totals, counts)
        p0, p1 = ranks[0][dtype]["params"], ranks[1][dtype]["params"]
        same = sum(torch.equal(p0[k], p1[k]) for k in p0)
        say(f"{dtype}: ranks hold identical parameters after {1 + DP_TIMED_STEPS} steps: "
            f"{same}/{len(p0)} tensors bit for bit")
        if same != len(p0):
            raise AssertionError(f"{dtype}: the ranks' parameters differ")

        # one rank on the whole global batch, the same weights and draws
        cfg = training_config(dtype)
        state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
        views, draws, gen = _dp_inputs(cfg)
        step = make_train_step(cfg, debug_grads=dtype == "float32")
        step(copy.deepcopy(state), views, draws, 0)
        state, ref = step(state, views, draws, 0)
        if dtype == "float32":
            _compare_step(ranks[0][dtype]["metrics"], ref,
                          f"{DP_RANKS} ranks vs 1 rank, f32, global batch 8:")
        fast, times = make_train_step(cfg), []
        v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
        for _ in range(DP_TIMED_STEPS):
            views = torch.rand((v, b, size, size, 3), device="cuda", generator=gen)
            d = sample_draws(cfg, gen, v, b, size, size)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, _ = fast(state, views, d, 0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        _launch_counts(reset=True)
        two = [float(np.median(res[dtype]["ms"])) for res in ranks]
        say(f"{dtype} step at global batch 8: {DP_RANKS} ranks on one card over gloo "
            f"{two[0]:.2f} / {two[1]:.2f} ms (rank 0 / 1, median of {DP_TIMED_STEPS}) beside "
            f"one rank {np.median(times) * 1e3:.2f} ms (not a scaling number: both ranks "
            f"share the card and gloo copies the gradients through the host)")
        del state, ref
        torch.cuda.empty_cache()
    return totals


def _dp_cli_check(tmp):
    """cli --mode train --data_parallel 1 under a one-rank NCCL group (the
    launcher's environment) for 2 steps, then --mode export in process."""
    from shmgan_tpu_torch import cli
    from shmgan_tpu_torch.checkpoint import CheckpointManager, load_inference_bundle
    from shmgan_tpu_torch.data.synthetic import write_fixture_tree

    tree = os.path.join(tmp, "tree")
    write_fixture_tree(tree, DP_SCENES, 128)
    common = ["--data_dir", tree, "--batch_size", "8", "--data_parallel", "1",
              "--checkpoint_save_dir", os.path.join(tmp, "ckpt"),
              "--log_dir", os.path.join(tmp, "logs"),
              "--model_save_dir", os.path.join(tmp, "models"),
              "--result_dir", os.path.join(tmp, "results")]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "shmgan_tpu_torch.cli", "--mode", "train",
                           "--num_epochs", "1", *common], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0 or "[dist] rank 0 of 1, backend nccl" not in log:
        raise AssertionError(f"cli --mode train under NCCL exited {proc.returncode}:\n"
                             f"{log[-4000:]}")
    steps = CheckpointManager(os.path.join(tmp, "ckpt")).all_steps()
    say(f"cli --mode train --data_parallel 1 under a one-rank NCCL group: "
        f"{time.perf_counter() - t0:.1f} s, checkpoints {steps}")
    if steps != [2]:
        raise AssertionError(f"expected one checkpoint at step 2, got {steps}")
    cli.main(["--mode", "export", *common])
    _launch_counts(reset=True)
    header = load_inference_bundle(os.path.join(tmp, "models", "shmgan_infer.msgpack"))[2]
    say(f"cli --mode export: bundle of step {header['step']}")
    if header["step"] != 2:
        raise AssertionError(f"exported step {header['step']}, expected 2")


def _dp_engine_check(bundle):
    """The bundle's engine with data_parallel=2 on ["cuda:0", "cuda:0"],
    f32 and bf16: each output against the one-device engine at the shard's
    batch (4: the same calls) within SERVE_ATOL, launches 2 x (18, 1) a
    request, and request ms beside the one-device engines at batch 8 and
    at batch 4 (two calls a request, as the shards)."""
    from shmgan_tpu_torch.profile_serve import serving_config
    from shmgan_tpu_torch.serve import BatchInferenceEngine

    totals = {k: 0 for k in _launch_counts()}
    rgb = scenes(8, 256, 256, np.random.default_rng(DP_SEED))
    for dtype, torch_dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = serving_config(dtype)
        gen, specseg = bundle_models(cfg, bundle)
        dp = BatchInferenceEngine(cfg, gen, specseg, batch_size=8, data_parallel=2,
                                  devices=["cuda:0", "cuda:0"])
        shard = BatchInferenceEngine(cfg, gen, specseg, batch_size=4, device="cuda")
        whole = BatchInferenceEngine(cfg, gen, specseg, batch_size=8, device="cuda")
        for eng in (dp, shard, whole):
            eng.process_images(rgb)  # warm-up
        torch.cuda.synchronize()
        _launch_counts(reset=True)
        got = dp.process_images(rgb)
        counts = _launch_counts(reset=True)
        want = {**{k: 0 for k in totals}, _in_name(torch_dtype): 36, "fused_standardize_yuv": 2}
        say(f"data-parallel engine, {dtype}, 2 shards of 4 on cuda:0: launches {counts}")
        if counts != want:
            raise AssertionError(f"data-parallel engine {dtype}: launches {counts}, "
                                 f"expected {want}")
        totals = _sum_counts(totals, counts)
        ref = shard.process_images(rgb)
        _launch_counts(reset=True)
        worst = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
        say(f"  against the one-device engine at batch 4: max |diff| {worst:.3e} over "
            f"{len(ref)} outputs (tol {SERVE_ATOL})")
        if set(got) != set(ref) or worst > SERVE_ATOL:
            raise AssertionError(f"data-parallel engine {dtype} differs by {worst}")
        ms = {}
        for label, eng in (("one device, batch 8", whole), ("data parallel 2 x 4", dp),
                           ("one device, batch 4", shard), ("one device, batch 4", shard),
                           ("data parallel 2 x 4", dp), ("one device, batch 8", whole)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                eng.process_images(rgb)
            torch.cuda.synchronize()
            ms.setdefault(label, []).append((time.perf_counter() - t0) / 3 * 1e3)
        _launch_counts(reset=True)
        say(f"  request of 8 at 256 px, {dtype}: " + ", ".join(
            f"{k} {np.mean(v):.2f} ms" for k, v in ms.items()) + " (same card, in turns)")
        for eng in (dp, shard, whole):
            eng.close()
    return totals


def data_parallel_phase(bundle):
    """Data parallelism on the one card: two gloo ranks' fused step against
    one rank, cli --mode train under a one-rank NCCL group, and the bundle's
    data-parallel engine. Returns the launches of the counted runs."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        steps = _dp_step_checks(tmp)
        _dp_cli_check(tmp)
    return _sum_counts(steps, _dp_engine_check(bundle))


# The bf16 1 x 2 step against the same step computed in one process with
# each block the JAX rule cuts run as its TP_RANKS slices (tp_gap.split_compute:
# the mesh's arithmetic without a collective): G's and D's gradients within
# TP_SPLIT_RTOL (L2, relative) and every loss within it (relative). On an
# H100 they read 0, every part of 16 batches over seeds 15-18, twice, and the
# bf16 step repeats bit for bit (shmgan_tpu_torch/tp_gap.py); every cut
# block's input gradient x 1.01, planted in bf16 only, reads 0.18-0.22 of the
# one-rank step's gap to f32 there (about 5e-3 of G's gradients, 2e-2 of
# D's). Not held in f32: there the split read G 1.5e-4, D 1.8e-6 from the
# mesh, as far as one rank's f32 step (cuDNN's f32 convolutions differ
# between the runs), which _compare_step holds at GRAD_NORM_RTOL.
TP_SPLIT_RTOL = 1e-6
# The bf16 1 x 2 step against the bf16 one-rank step by the gap rule: half-
# width convolutions round apart from whole ones, so this pair differs as
# two correct roundings of the step do. On an H100 (tp_gap.py) the losses
# read 1.433, 0.866, 0.548 and 0.828 over seeds 15-18 (15 is TP_SEED; its
# batch 2, 2.477, repeats bit for bit), and the same step on one rank with
# cuDNN off 1.202 on seed 15; G 0.760-0.779, D 0.713-0.728. Planted in bf16
# only, rank 1's gathered channels x 1.01 read 2.682-3.478 on the losses and
# the backward taking the other rank's slice 7.4-12.0 on the gradients
# (every cut block's input gradient x 1.01 reads G 0.806: the split check
# holds that one). JAX's own 1 x 2 bf16 step against its one-device step
# reads G 0.110, D 0.692, losses 0.505 on the CPU at 128 px, filter 8
# (tests/tp_gap_jax.py).
TP_GAP_C = 2.0
TP_RANKS = 2          # a 1 x 2 mesh: two ranks of one gloo group, both on the one card
TP_TIMED_STEPS = 3    # timed steps a rank, and of the one-rank step beside them
TP_SEED = 15
TP_SCENES = 16        # train.loop.train at batch 8: 2 steps


def _tp_config(dtype):
    """The JAX defaults at batch 8 (training_config) on a 1 x TP_RANKS mesh,
    tp_min_channels 256."""
    from shmgan_tpu_torch.profile_train import training_config

    cfg = training_config(dtype)
    cfg.mesh.data_parallel, cfg.mesh.model_parallel = 1, TP_RANKS
    return cfg


def _tp_batches(cfg, n, seed=TP_SEED):
    """n (views, draws) of the global batch from a seeded generator on the
    card: the same on every rank and in the one-rank reference."""
    from shmgan_tpu_torch.train.step import sample_draws

    v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.rand((v, b, size, size, 3), device="cuda", generator=gen),
             sample_draws(cfg, gen, v, b, size, size)) for _ in range(n)], gen


def _payload_digest(payload):
    """sha256 over a checkpoint tree's leaf paths, dtypes, shapes and bytes."""
    import hashlib

    digest = hashlib.sha256()
    for path, leaf in sorted(_paths(payload)):
        leaf = np.ascontiguousarray(leaf)
        digest.update(f"{path} {leaf.dtype} {leaf.shape}".encode())
        digest.update(leaf.tobytes())
    return digest.hexdigest()


def _tp_steps(cfg, state, batches, layout=None, spied="instance_norm"):
    """One counted step with debug_grads from `state` on each batch (after
    a warm-up step): the launches, the metrics on the host and the (B, C,
    H, W) and dtype of every call of `ink.<spied>`; returns them and the
    last state. With a spatial `layout` each step takes the rank's band of
    the views and its rows of the draws."""
    from shmgan_tpu_torch.data.pipeline import local_band
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink
    from shmgan_tpu_torch.train.step import make_train_step

    def band(views, draws):
        if layout is None or not layout.spatial:
            return views, draws
        j, m = layout.model_index, layout.model_parallel
        return local_band(views, j, m).contiguous(), draws.rows(j, m)

    step = make_train_step(cfg, debug_grads=True)
    step(copy.deepcopy(state), *band(*batches[0]), 0)  # warm-up: cuDNN's choices
    torch.cuda.synchronize()
    _launch_counts(reset=True)
    shapes, plain = set(), getattr(ink, spied)

    def spy(x, *args):
        shapes.add((tuple(x.shape), x.dtype))
        return plain(x, *args)

    counts, metrics, stepped = [], [], None
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    for views, draws in batches:
        setattr(ink, spied, spy)
        try:
            stepped, m = step(copy.deepcopy(state), *band(views, draws), 0)
        finally:
            setattr(ink, spied, plain)
        torch.cuda.synchronize()
        counts.append(_launch_counts(reset=True))
        metrics.append({k: (({net: {name: cpu(g) for name, g in grads.items()}
                              for net, grads in val.items()}) if k == "_grads" else cpu(val))
                        for k, val in m.items() if k != "_drop"})
    return counts, metrics, shapes, stepped


def _timed_steps(cfg, state, gen):
    """TP_TIMED_STEPS steps on fresh global batches: host ms of each."""
    from shmgan_tpu_torch.train.step import make_train_step, sample_draws

    fast, times = make_train_step(cfg), []
    v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
    for _ in range(TP_TIMED_STEPS):
        views = torch.rand((v, b, size, size, 3), device="cuda", generator=gen)
        draws = sample_draws(cfg, gen, v, b, size, size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = fast(state, views, draws, 0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    _launch_counts(reset=True)
    return times


def tp_rank(workdir):
    """One rank of the model_parallel phase (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT from the environment, LOCAL_RANK 0): joins the gloo group;
    in f32 (one batch) and bf16 (STEP_GAP_BATCHES batches, also through the
    plain versions) cuts the seeded state to its slices and takes one
    counted step with debug_grads a batch, then TP_TIMED_STEPS timed steps;
    then train.loop.train for 2 steps on the tree under <workdir>, its
    checkpoint and the digest of its gathered payload; writes
    <workdir>/tp<r>.pt."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.parallel import tp
    from shmgan_tpu_torch.profile_serve import plain_versions
    from shmgan_tpu_torch.parallel.mesh import (maybe_initialize_distributed, rank,
                                                rank_layout, shutdown_distributed,
                                                training_mesh)
    from shmgan_tpu_torch.train.loop import train
    from shmgan_tpu_torch.train.state import create_train_state, shard_state, state_payload

    if not maybe_initialize_distributed("gloo"):
        raise RuntimeError("tp_rank: no launcher environment")
    r, out = rank(), {}
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = _tp_config(dtype)
            layout = rank_layout(training_mesh(cfg))
            state = shard_state(create_train_state(cfg, build_models(cfg, device="cuda", seed=0)),
                                layout, cfg.model.image_size, cfg.mesh.tp_min_channels)
            batches, gen = _tp_batches(cfg, 1 if dtype == "float32" else STEP_GAP_BATCHES)
            plain = []
            if dtype == "bfloat16":
                with plain_versions():
                    plain_counts, plain, _, _ = _tp_steps(cfg, state, batches)
                if any(any(c.values()) for c in plain_counts):
                    raise AssertionError("the plain 1 x 2 step launched a kernel")
            counts, metrics, shapes, state = _tp_steps(cfg, state, batches)
            cut = ({f"G.{k}" for k in tp.sharded_params(state.gen)}
                   | {f"D.{k}" for k in tp.sharded_params(state.disc)})
            out[dtype] = {
                "counts": counts, "ms": _timed_steps(cfg, state, gen), "shapes": shapes,
                "metrics": metrics if r == 0 else [], "plain": plain if r == 0 else [],
                "whole": {f"{net}.{k}": p.detach().cpu() for net, mod in (("G", state.gen),
                                                                         ("D", state.disc))
                          for k, p in mod.named_parameters() if f"{net}.{k}" not in cut},
                "cut": sorted(cut)}
            del state, batches
            torch.cuda.empty_cache()
        cfg = _loop_config(_tp_config("bfloat16"), os.path.join(workdir, "loop"),
                           os.path.join(workdir, "tree"), 1)
        _launch_counts(reset=True)
        t0 = time.perf_counter()
        state = train(cfg, max_steps=2, verbose=False)
        torch.cuda.synchronize()
        out["loop"] = {"counts": _launch_counts(reset=True), "s": time.perf_counter() - t0,
                       "step": state.step, "digest": _payload_digest(state_payload(state))}
        torch.save(out, os.path.join(workdir, f"tp{r}.pt"))
    finally:
        shutdown_distributed()


def _tp_in_checks(shapes):
    """The IN forward (with its stats), backward and autograd against their
    plain versions (_backward_check) at every (shape, dtype) the 1 x 2 step
    called IN with that the kernels phase's train shapes do not hold: the
    channel slices, and G1's batch. Returns the worst error by dtype."""
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    train_shapes = {s for s, _ in TRAIN_IN_SHAPES}
    g = torch.Generator(device="cuda").manual_seed(TP_SEED)
    worst = {}
    for shape, dtype in sorted(shapes, key=lambda s: (str(s[1]), s[0])):
        if shape in train_shapes:
            continue
        tol, ptol = ((IN_TOL, IN_TOL) if dtype == torch.float32
                     else (IN_TOL_BF16, IN_PARAM_TOL_BF16))
        x, gamma, beta, dy = _in_inputs("cuda", g, shape, dtype)
        b, c, h, w = shape
        say(f"{_in_name(dtype, 'backward')} {shape} plan: "
            f"{ink._bwd_plan(b, c, h * w, dtype).variant}")
        err = _backward_check(ink, _in_name(dtype, "backward"), shape, x, gamma, beta, dy,
                              tol, ptol)[0]
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        del x, dy
    _launch_counts(reset=True)
    return worst


def _split_steps(cfg, batches):
    """The counted steps of _tp_steps on one rank with every block the JAX
    rule cuts computed as the TP_RANKS model ranks' slices in this process
    (tp_gap.split_compute): the mesh's arithmetic without a collective."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.tp_gap import mark_cut, split_compute
    from shmgan_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
    for model in (state.gen, state.disc):
        mark_cut(model, TP_RANKS, cfg.model.image_size, cfg.mesh.tp_min_channels)
    with split_compute(TP_RANKS):
        return _tp_steps(cfg, state, batches)[1]


def _compare_split(got, ref, label):
    """The mesh's steps against its split's, batch by batch: G's and D's
    gradients and every loss within TP_SPLIT_RTOL (relative)."""
    worst, same = {}, True
    for m, r in zip(got, ref):
        for net in ("G", "D"):
            a, b = m["_grads"][net], r["_grads"][net]
            diff = sum(((a[k].double() - b[k].double()) ** 2).sum().item() for k in b) ** 0.5
            norm = sum((b[k].double() ** 2).sum().item() for k in b) ** 0.5
            worst[f"{net} gradients"] = max(worst.get(f"{net} gradients", 0.0), diff / norm)
            same &= all(torch.equal(a[k], b[k]) for k in b)
        for k in r:
            if not k.startswith("_"):
                rel = abs(float(m[k]) - float(r[k])) / max(abs(float(r[k])), 1e-30)
                worst["losses"] = max(worst.get("losses", 0.0), rel)
                same &= torch.equal(m[k], r[k])
    say(f"  {label} {len(got)} batches, worst relative L2 " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()) + f" (tol {TP_SPLIT_RTOL}); bit for bit: "
        f"{same}")
    if not all(v <= TP_SPLIT_RTOL for v in worst.values()):
        raise AssertionError(f"{label} {worst} beyond {TP_SPLIT_RTOL}")


def _tp_step_checks(ranks):
    """The ranks' counted steps: launches, whole leaves across ranks; the
    gathered f32 step against one rank's by _compare_step; the bf16 steps
    against their split in one process (_compare_split), through the
    kernels against the same steps through the plain versions by the gap
    rule (GAP_C), and against one rank's bf16 steps at TP_GAP_C; timed
    steps beside one rank's. Returns the ranks' step launches."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.state import create_train_state

    totals = {k: 0 for k in _launch_counts()}
    f32_refs = None
    for dtype, torch_dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        want = step_launches(torch_dtype)
        for r, res in enumerate(ranks):
            for counts in res[dtype]["counts"]:
                if counts != want:
                    raise AssertionError(f"tp rank {r} {dtype}: launches {counts}, "
                                         f"expected {want}")
                totals = _sum_counts(totals, counts)
            say(f"tp rank {r} {dtype}: each of {len(res[dtype]['counts'])} steps launched "
                f"{want}; {len(res[dtype]['cut'])} parameters cut; timed step ms "
                f"{[round(t, 2) for t in res[dtype]['ms']]}")
        w0, w1 = ranks[0][dtype]["whole"], ranks[1][dtype]["whole"]
        same = sum(torch.equal(w0[k], w1[k]) for k in w0)
        say(f"{dtype}: leaves whole on both ranks after {1 + TP_TIMED_STEPS} steps: "
            f"{same}/{len(w0)} bit for bit")
        if same != len(w0) or set(w0) != set(w1):
            raise AssertionError(f"{dtype}: the ranks' whole leaves differ")

        # one rank on the same weights, batches and draws
        cfg = training_config(dtype)
        batches, gen = _tp_batches(cfg, len(ranks[0][dtype]["metrics"]))
        state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
        refs = _tp_steps(cfg, state, batches)[1]
        if dtype == "float32":
            _compare_step(ranks[0][dtype]["metrics"][0], refs[0],
                          f"{TP_RANKS} model ranks vs 1 rank, f32, batch 8:")
            # the gap rule's yardstick: the one-rank f32 step on the bf16 batches
            f32_refs = _tp_steps(cfg, create_train_state(
                cfg, build_models(cfg, device="cuda", seed=0)),
                _tp_batches(cfg, STEP_GAP_BATCHES)[0])[1]
        else:
            tp_steps = ranks[0][dtype]["metrics"]
            _compare_split(tp_steps, _split_steps(cfg, batches),
                           f"1 x {TP_RANKS} mesh vs its split in one process, bf16:")
            _compare_step_gap(list(zip(tp_steps, ranks[0][dtype]["plain"], f32_refs)),
                              f"1 x {TP_RANKS} mesh, bf16, kernels vs plain:")
            _compare_step_gap(list(zip(tp_steps, refs, f32_refs)),
                              f"1 x {TP_RANKS} mesh vs 1 rank, bf16 (kernels vs plain read "
                              f"mesh vs one rank):", limit=TP_GAP_C)
        one = _timed_steps(cfg, state, gen)
        two = [float(np.median(res[dtype]["ms"])) for res in ranks]
        say(f"{dtype} step at batch 8: 1 x {TP_RANKS} mesh on one card over gloo "
            f"{two[0]:.2f} / {two[1]:.2f} ms (rank 0 / 1, median of {TP_TIMED_STEPS}) beside "
            f"one rank {np.median(one):.2f} ms (not a scaling number: both ranks share the "
            f"card and gloo copies every gathered activation through the host)")
        del state, refs
        torch.cuda.empty_cache()
    return totals


def _tp_loop_checks(tmp, ranks, want=None, label="tp"):
    """The ranks' 2 loop steps: launches (`want`, by default 2 x
    step_launches in bf16), one checkpoint at step 2, the ranks' gathered
    payloads alike, and the checkpoint restored on one rank equal to them,
    bit for bit (digests). Returns the launches."""
    from shmgan_tpu_torch.checkpoint import CheckpointManager
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.state import create_train_state, state_payload

    want = want or {k: 2 * n for k, n in step_launches(torch.bfloat16).items()}
    totals = {k: 0 for k in _launch_counts()}
    for r, res in enumerate(ranks):
        loop = res["loop"]
        say(f"{label} rank {r}: train.loop.train, 2 steps in {loop['s']:.1f} s (checkpoint "
            f"included), launches {loop['counts']}")
        if loop["counts"] != want or loop["step"] != 2:
            raise AssertionError(f"{label} rank {r} loop: step {loop['step']}, launches "
                                 f"{loop['counts']}, expected {want}")
        totals = _sum_counts(totals, loop["counts"])
    ckpt = CheckpointManager(os.path.join(tmp, "loop", "checkpoint_save_dir"))
    if ckpt.all_steps() != [2]:
        raise AssertionError(f"expected one checkpoint at step 2, got {ckpt.all_steps()}")
    cfg = training_config("bfloat16")
    state = create_train_state(cfg, build_models(cfg, device="cuda", seed=1))
    ckpt.restore(state)
    digests = [res["loop"]["digest"] for res in ranks] + [_payload_digest(state_payload(state))]
    say(f"{label} 1 x {len(ranks)} checkpoint at step {state.step} restored on one rank: "
        f"payload digests (rank 0, rank 1, restored) {[d[:16] for d in digests]}")
    if len(set(digests)) != 1:
        raise AssertionError("the restored checkpoint differs from the ranks' gathered state")
    return totals


def model_parallel_phase():
    """Tensor parallelism on the one card: a 1 x 2 mesh of two gloo ranks
    (NCCL refuses two ranks on one device) at the JAX defaults, in f32 and
    bf16, against one rank; the IN kernels at the shapes its step gives
    them; 2 steps of train.loop.train with a checkpoint restored on one
    rank. Returns the launches of the counted runs."""
    from shmgan_tpu_torch.data.synthetic import write_fixture_tree

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        write_fixture_tree(os.path.join(tmp, "tree"), TP_SCENES, 128, seed=0)
        t0 = time.perf_counter()
        ranks = _run_ranks(tmp, "chip_smoke.tp_rank", TP_RANKS, "tp", 600)
        say(f"{TP_RANKS} model ranks (gloo, one card, batch 8 each) ran in "
            f"{time.perf_counter() - t0:.1f} s")
        steps = _tp_step_checks(ranks)
        loop = _tp_loop_checks(tmp, ranks)
    worst = _tp_in_checks(ranks[0]["float32"]["shapes"] | ranks[0]["bfloat16"]["shapes"])
    say(f"IN at the 1 x {TP_RANKS} step's other shapes, worst error by dtype: "
        + ", ".join(f"{str(d).split('.')[-1]} {e:.3e}" for d, e in worst.items()))
    return _sum_counts(steps, loop)


# spatial: a 1 x SP_RANKS spatial mesh (H over the model axis, every parameter
# whole) of two gloo ranks on the one card. The bf16 mesh is held against its
# split (spatial.split_compute: each band computed in one process, the halos
# and moments joined as the mesh joins them) within TP_SPLIT_RTOL; on the CPU
# at 64 px they are one computation, bit for bit (tests/test_torch_spatial_*).
SP_RANKS = 2          # a 1 x 2 mesh: two ranks of one gloo group, both on the one card
SP_TIMED_STEPS = 3    # timed steps a rank, and of the one-rank step beside them
SP_SEED = 17
SP_SCENES = 16        # train.loop.train at batch 8: 2 steps
SP_BIG = 256          # the bf16 step whose peak memory is read at this size too
IN_SRC = "shmgan_tpu_torch/csrc/instance_norm.cu"
PRE_SRC = "shmgan_tpu_torch/csrc/preprocess.cu"


def _sp_config(dtype, size=None):
    """The JAX defaults at batch 8 (training_config) on a 1 x SP_RANKS
    spatial mesh, at `size` px if given. A state without a layout trains on
    one rank whatever the mesh says."""
    from shmgan_tpu_torch.profile_train import training_config

    cfg = training_config(dtype)
    cfg.model.image_size = size or cfg.model.image_size
    cfg.mesh.data_parallel, cfg.mesh.model_parallel = 1, SP_RANKS
    cfg.mesh.spatial_sharding = True
    return cfg


def sp_step_launches(dtype):
    """A spatial rank's kernel launches in one train step: every IN call and
    the preprocess on bands, two launches a call (46 forwards, 28 backwards,
    1 preprocess), nothing whole."""
    return {**{k: 0 for k in _launch_counts()}, _in_name(dtype, "band_forward"): 2 * 46,
            _in_name(dtype, "band_backward"): 2 * 28, "fused_standardize_yuv_band": 2}


def _peak_step(cfg, state, views, draws):
    """Peak device memory (GiB) of one train step from `state` in this
    process, above what it held before."""
    from shmgan_tpu_torch.train.step import make_train_step

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    make_train_step(cfg)(state, views, draws, 0)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def sp_rank(workdir):
    """One rank of the spatial phase (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT from the environment, LOCAL_RANK 0): joins the gloo group; in
    f32 (one batch) and bf16 (STEP_GAP_BATCHES batches, also through the plain
    versions) takes one counted step with debug_grads a batch on its band,
    then SP_TIMED_STEPS timed steps and one whose peak memory it reads; one
    bf16 step at SP_BIG px for its peak memory; then train.loop.train for 2
    steps on the tree under <workdir> and the digest of its payload; writes
    <workdir>/sp<r>.pt."""
    from shmgan_tpu_torch.data.pipeline import local_band
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.parallel.mesh import (maybe_initialize_distributed, rank,
                                                rank_layout, shutdown_distributed,
                                                training_mesh)
    from shmgan_tpu_torch.profile_serve import plain_versions
    from shmgan_tpu_torch.train.loop import train
    from shmgan_tpu_torch.train.state import create_train_state, shard_state, state_payload
    from shmgan_tpu_torch.train.step import make_train_step, sample_draws

    if not maybe_initialize_distributed("gloo"):
        raise RuntimeError("sp_rank: no launcher environment")
    r, out = rank(), {}
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = _sp_config(dtype)
            layout = rank_layout(training_mesh(cfg))
            state = shard_state(create_train_state(cfg, build_models(cfg, device="cuda", seed=0)),
                                layout, cfg.model.image_size, cfg.mesh.tp_min_channels)
            batches, gen = _tp_batches(cfg, 1 if dtype == "float32" else STEP_GAP_BATCHES,
                                       seed=SP_SEED)
            plain = []
            if dtype == "bfloat16":
                with plain_versions():
                    plain_counts, plain, _, _ = _tp_steps(cfg, state, batches, layout,
                                                          "instance_norm_band")
                if any(any(c.values()) for c in plain_counts):
                    raise AssertionError("the plain 1 x 2 spatial step launched a kernel")
            counts, metrics, shapes, state = _tp_steps(cfg, state, batches, layout,
                                                       "instance_norm_band")
            fast, times = make_train_step(cfg), []
            v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
            j, m = layout.model_index, layout.model_parallel
            for _ in range(SP_TIMED_STEPS + 1):
                views = torch.rand((v, b, size, size, 3), device="cuda", generator=gen)
                draws = sample_draws(cfg, gen, v, b, size, size)
                args = (local_band(views, j, m).contiguous(), draws.rows(j, m))
                if len(times) == SP_TIMED_STEPS:
                    peak = _peak_step(cfg, state, *args)
                    break
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = fast(state, *args, 0)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            _launch_counts(reset=True)
            out[dtype] = {"counts": counts, "ms": times, "shapes": shapes, "peak_gib": peak,
                          "metrics": metrics if r == 0 else [], "plain": plain if r == 0 else [],
                          "params": {f"{net}.{k}": p.detach().cpu()
                                     for net, mod in (("G", state.gen), ("D", state.disc))
                                     for k, p in mod.named_parameters()}}
            del state, batches
            torch.cuda.empty_cache()
        cfg = _sp_config("bfloat16", SP_BIG)
        layout = rank_layout(training_mesh(cfg))
        state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
        state.layout = layout
        (views, draws), = _tp_batches(cfg, 1, seed=SP_SEED)[0]
        args = (local_band(views, layout.model_index, SP_RANKS).contiguous(),
                draws.rows(layout.model_index, SP_RANKS))
        del views
        make_train_step(cfg)(copy.deepcopy(state), *args, 0)  # warm-up
        out["big_peak_gib"] = _peak_step(cfg, state, *args)
        _launch_counts(reset=True)
        del state, args
        torch.cuda.empty_cache()
        cfg = _loop_config(_sp_config("bfloat16"), os.path.join(workdir, "loop"),
                           os.path.join(workdir, "tree"), 1)
        _launch_counts(reset=True)
        t0 = time.perf_counter()
        state = train(cfg, max_steps=2, verbose=False)
        torch.cuda.synchronize()
        out["loop"] = {"counts": _launch_counts(reset=True), "s": time.perf_counter() - t0,
                       "step": state.step, "digest": _payload_digest(state_payload(state))}
        torch.save(out, os.path.join(workdir, f"sp{r}.pt"))
    finally:
        shutdown_distributed()


def _flat_planes(x):
    """x with the planes of channel 0 flat: mean 50, spread 0.1 (a flat image
    region, where E[x^2] - E[x]^2 in f32 loses the variance)."""
    x = x.clone()
    flat = 50.0 + 0.1 * torch.randn(x[:, 0].shape, device=x.device,
                                    generator=torch.Generator(device=x.device).manual_seed(3))
    x[:, 0] = flat.to(x.dtype)
    return x


def _sp_in_checks(shapes):
    """The band IN entry points against their plain versions at every (band
    shape, dtype) the spatial step gave them: the whole map of SP_RANKS bands
    computed band by band in one process (instance_norm_split), through the
    kernels and through the plain steps, forward and autograd, with the
    planes of channel 0 flat. y and dbeta are held over every plane, dx and
    dgamma over the other channels. On the flat channel each side's dx and
    dgamma is held against float64 (in_reference_f64) within its tolerance
    plus the error of its rounded mean: a flat plane's backward carries each
    forward's rounding of the mean (one f32 ulp of 50 is 3.8e-6, times its
    rstd 10 in xhat), amplified by rstd again in dx and by |sum(g)| in
    dgamma (kernels against plain on an H100: dx 3.2e-4 at a 64-element
    plane, dgamma 1.6e-2 at (16, 64, 64, 64)). Returns the worst error by
    dtype and kind."""
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    g = torch.Generator(device="cuda").manual_seed(SP_SEED)
    worst = {}
    for (b, c, h, w), dtype in sorted(shapes, key=lambda s: (str(s[1]), s[0])):
        shape = (b, c, h * SP_RANKS, w)
        tol, ptol = ((IN_TOL, IN_TOL) if dtype == torch.float32
                     else (IN_TOL_BF16, IN_PARAM_TOL_BF16))
        x, gamma, beta, dy = _in_inputs("cuda", g, shape, dtype)
        x = _flat_planes(x)
        got, ref = [], []
        for fn, res in ((ink.instance_norm_split, got), (ink.instance_norm_split_plain, ref)):
            leaves = [t.detach().clone().requires_grad_(True) for t in (x, gamma, beta)]
            y = fn(*leaves, 1e-6, SP_RANKS)
            res.extend([y.detach(), *torch.autograd.grad(y, leaves, dy)])
        torch.cuda.synchronize()
        (_, dx64, dgamma64, _), (dx_err, dgamma_err) = in_reference_f64(
            x[:, :1], gamma[:1], beta[:1], dy[:, :1])
        flat, flat_ok = [], True
        for side in (got, ref):
            dx_gap = (side[1][:, :1].double() - dx64).abs()
            dx_lim = tol["atol"] + tol["rtol"] * dx64.abs() + dx_err
            dg_gap = (side[2][:1].double() - dgamma64).abs()
            dg_lim = ptol["atol"] + ptol["rtol"] * dgamma64.abs() + dgamma_err
            flat.append(((dx_gap / dx_lim).max().item(), (dg_gap / dg_lim).max().item()))
            flat_ok &= bool((dx_gap <= dx_lim).all() and (dg_gap <= dg_lim).all())
        got[1], ref[1] = got[1][:, 1:], ref[1][:, 1:]
        got[2], ref[2] = got[2][1:], ref[2][1:]
        errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(got, ref)]
        ok = flat_ok and all(torch.allclose(a.float(), r.float(), **t)
                             for a, r, t in zip(got, ref, (tol, tol, ptol, ptol)))
        say(f"{_in_name(dtype, 'band_forward')} / {_in_name(dtype, 'band_backward')} band "
            f"{(b, c, h, w)} of {shape}: max_abs_err y {errs[0]:.3e}, dx {errs[1]:.3e}, dgamma "
            f"{errs[2]:.3e}, dbeta {errs[3]:.3e}; the flat channel against float64, gap over "
            f"limit: kernels dx {flat[0][0]:.3f}, dgamma {flat[0][1]:.3f}, plain dx "
            f"{flat[1][0]:.3f}, dgamma {flat[1][1]:.3f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"band IN disagrees with its plain version or with float64 "
                                 f"at {shape} {dtype}")
        for kind, e in (("band_forward", errs[0]), ("band_backward", max(errs[1:]))):
            worst[kind, dtype] = max(worst.get((kind, dtype), 0.0), e)
        del x, dy, got, ref
    _launch_counts(reset=True)
    return worst


def _sp_pre_check():
    """The band preprocess against its plain version and against the whole-
    image plain version at the step's (40, 128, 128, 3), split in SP_RANKS
    bands in one process. Returns the worst error."""
    from shmgan_tpu_torch.ops.kernels import preprocess as pre

    g = torch.Generator(device="cuda").manual_seed(SP_SEED)
    rgb = torch.rand(PRE_TRAIN_SHAPE, device="cuda", generator=g)
    rgb[0] = 0.0
    yuv, scale = pre.fused_standardize_yuv_split(rgb, SP_RANKS)
    bands = [rgb.narrow(1, k * rgb.shape[1] // SP_RANKS, rgb.shape[1] // SP_RANKS)
             for k in range(SP_RANKS)]
    totals = sum(pre.band_moments_plain(x) for x in bands)
    ref = [pre.band_apply_plain(x, totals, 3 * rgb.shape[1] * rgb.shape[2]) for x in bands]
    ryuv, rscale = torch.cat([r[0] for r in ref], 1), ref[0][1]
    wyuv, wscale = pre.fused_standardize_yuv_plain(rgb)
    torch.cuda.synchronize()
    err = max((yuv - ryuv).abs().max().item(), (scale - rscale).abs().max().item())
    werr = max((yuv - wyuv).abs().max().item(), (scale - wscale).abs().max().item())
    ok = all(torch.allclose(a, r, **PRE_TOL) for a, r in ((yuv, ryuv), (scale, rscale),
                                                          (yuv, wyuv), (scale, wscale)))
    say(f"fused_standardize_yuv_band {PRE_TRAIN_SHAPE} in {SP_RANKS} bands: max_abs_err "
        f"{err:.3e} against its plain version, {werr:.3e} against the whole-image plain "
        f"version (tol {PRE_TOL}) {'ok' if ok else 'FAIL'}; a black image's scale "
        f"{scale[0].item()}")
    if not ok or scale[0].item() != 1.0 / 256.0:
        raise AssertionError("the band preprocess disagrees with its plain version")
    _launch_counts(reset=True)
    return max(err, werr)


def _sp_rows(in_shapes, in_worst, pre_worst):
    """The kernels line's rows of the band entry points, timed through a
    model row of one rank (spatial.LocalRow: the band is the whole map) at
    the step's largest band (IN) and the train step's preprocess shape:
    `ms` host-inclusive, `device_ms` from CUDA-graph replays, `device_cold_ms`
    after an L2 flush; the plain steps' ms; the bytes bound."""
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink
    from shmgan_tpu_torch.ops.kernels import preprocess as pre
    from shmgan_tpu_torch.parallel.spatial import LocalRow

    g = torch.Generator(device="cuda").manual_seed(SP_SEED)
    row, rows = LocalRow(), []
    for dtype in (torch.float32, torch.bfloat16):
        shape = max((s for s, d in in_shapes if d == dtype), key=lambda s: int(np.prod(s)))
        x, gamma, beta, dy = _in_inputs("cuda", g, shape, dtype)
        _, mean, rstd = ink.instance_norm_band_forward(x, gamma, beta, 1e-6, row)
        calls = {
            "band_forward": (lambda: ink.instance_norm_band_forward(x, gamma, beta, 1e-6, row),
                             lambda: ink.instance_norm_band_forward(x, gamma, beta, 1e-6, row,
                                                                    plain=True), 2),
            "band_backward": (lambda: ink.instance_norm_band_backward(x, dy, gamma, mean, rstd,
                                                                      row),
                              lambda: ink.instance_norm_band_backward(x, dy, gamma, mean, rstd,
                                                                      row, plain=True), 3)}
        for kind, (kernel, plain, tensors) in calls.items():
            nbytes = tensors * x.numel() * x.element_size()
            bound_ms, bound_by = bound(nbytes, 10.0 * x.numel())
            ms, dev_ms, cold = time_ms(kernel, 50), device_ms(kernel), device_cold_ms(kernel)
            plain_ms = time_ms(plain, 10)
            rows.append({"name": _in_name(dtype, kind), "route": "cuda", "source": IN_SRC,
                         "replaces": ("shmgan_tpu/ops/pallas/instance_norm.py:197" if kind ==
                                      "band_forward" else
                                      "shmgan_tpu/ops/pallas/instance_norm.py:225"),
                         "shape": list(shape), "max_abs_err": in_worst.get((kind, dtype), 0.0),
                         "ms": ms, "device_ms": dev_ms, "device_cold_ms": cold,
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None})
            say(f"{_in_name(dtype, kind)} {shape} (one-rank row): {ms:.4f} ms, device "
                f"{dev_ms:.4f} ms, cold {cold:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), {share(bound_ms, dev_ms)} (device)")
        del x, dy, mean, rstd
    rgb = torch.rand(PRE_TRAIN_SHAPE, device="cuda", generator=g)
    kernel = lambda: pre.fused_standardize_yuv_band(rgb, row)  # noqa: E731
    plain = lambda: pre.fused_standardize_yuv_band_plain(rgb, row)  # noqa: E731
    bound_ms, bound_by = bound(2 * rgb.numel() * 4, 25.0 * rgb.numel() / 3)
    ms, dev_ms, cold = time_ms(kernel, 50), device_ms(kernel), device_cold_ms(kernel)
    plain_ms = time_ms(plain, 10)
    rows.append({"name": "fused_standardize_yuv_band", "route": "cuda", "source": PRE_SRC,
                 "replaces": "shmgan_tpu/ops/pallas/preprocess.py:75",
                 "shape": list(PRE_TRAIN_SHAPE), "max_abs_err": pre_worst, "ms": ms,
                 "device_ms": dev_ms, "device_cold_ms": cold, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    say(f"fused_standardize_yuv_band {PRE_TRAIN_SHAPE} (one-rank row): {ms:.4f} ms, device "
        f"{dev_ms:.4f} ms, cold {cold:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {share(bound_ms, dev_ms)} (device); no library call computes the "
        f"band's function")
    _launch_counts(reset=True)
    return rows


def _sp_step_checks(ranks, smi):
    """The ranks' counted steps: launches, parameters alike on both ranks;
    the f32 step against one rank's whole step by _compare_step; the bf16
    steps against their split in one process (_compare_split), through the
    kernels against themselves through the plain versions (GAP_C), and
    against one rank's bf16 steps as a reading; peak memory and step times
    beside one rank's. Returns the ranks' step launches."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.parallel.spatial import split_compute
    from shmgan_tpu_torch.train.state import create_train_state

    totals = {k: 0 for k in _launch_counts()}
    f32_refs = None
    for dtype, torch_dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        want = sp_step_launches(torch_dtype)
        for r, res in enumerate(ranks):
            for counts in res[dtype]["counts"]:
                if counts != want:
                    raise AssertionError(f"spatial rank {r} {dtype}: launches {counts}, "
                                         f"expected {want}")
                totals = _sum_counts(totals, counts)
            say(f"spatial rank {r} {dtype}: each of {len(res[dtype]['counts'])} steps launched "
                f"{ {k: n for k, n in want.items() if n} }; timed step ms "
                f"{[round(t, 2) for t in res[dtype]['ms']]}")
        p0, p1 = ranks[0][dtype]["params"], ranks[1][dtype]["params"]
        same = sum(torch.equal(p0[k], p1[k]) for k in p0)
        say(f"{dtype}: parameters on both ranks after {1 + SP_TIMED_STEPS} steps: "
            f"{same}/{len(p0)} bit for bit")
        if same != len(p0) or set(p0) != set(p1):
            raise AssertionError(f"{dtype}: the spatial ranks' parameters differ")

        cfg = _sp_config(dtype)
        batches, gen = _tp_batches(cfg, len(ranks[0][dtype]["metrics"]), seed=SP_SEED)
        fresh = lambda: create_train_state(cfg, build_models(cfg, device="cuda", seed=0))  # noqa
        refs = _tp_steps(cfg, fresh(), batches)[1]
        mesh = ranks[0][dtype]["metrics"]
        if dtype == "float32":
            _compare_step(mesh[0], refs[0], f"1 x {SP_RANKS} spatial mesh vs 1 rank, f32, "
                                            f"batch 8:")
            f32_refs = _tp_steps(cfg, fresh(), _tp_batches(cfg, STEP_GAP_BATCHES,
                                                           seed=SP_SEED)[0])[1]
        else:
            with split_compute(SP_RANKS):
                split = _tp_steps(cfg, fresh(), batches)[1]
            _compare_split(mesh, split, f"1 x {SP_RANKS} spatial mesh vs its split in one "
                                        f"process, bf16:")
            _compare_step_gap(list(zip(mesh, ranks[0][dtype]["plain"], f32_refs)),
                              f"1 x {SP_RANKS} spatial mesh, bf16, kernels vs plain:")
            _sp_gap_reading(mesh, refs, f32_refs)
        state = fresh()
        one = _timed_steps(cfg, state, gen)
        (views, draws), = _tp_batches(cfg, 1, seed=SP_SEED)[0]
        one_peak = _peak_step(cfg, state, views, draws)
        two = [float(np.median(res[dtype]["ms"])) for res in ranks]
        say(f"{dtype} step at batch 8, 128 px on {smi}: 1 x {SP_RANKS} spatial mesh on one card "
            f"over gloo {two[0]:.2f} / {two[1]:.2f} ms (rank 0 / 1, median of {SP_TIMED_STEPS}) "
            f"beside one rank {np.median(one):.2f} ms (not a scaling number: both ranks share "
            f"the card and gloo copies every halo and sum through the host)")
        say(f"{dtype} peak memory of a step, 128 px, batch 8: rank 0 / 1 "
            f"{ranks[0][dtype]['peak_gib']:.3f} / {ranks[1][dtype]['peak_gib']:.3f} GiB beside "
            f"one rank's whole step {one_peak:.3f} GiB")
        del state, refs
        torch.cuda.empty_cache()
    return totals


def _sp_gap_reading(mesh, refs, f32_refs):
    """The bf16 mesh against one rank's bf16 steps by the gap measure, as a
    reading (no limit): half-height convolutions round apart from whole ones."""
    for name in ("G gradients", "D gradients", LOSSES):
        k, p, f = (np.concatenate([_gap_vectors(m, f32)[name] for m, f32 in zip(side, f32_refs)])
                   for side in (mesh, refs, f32_refs))
        say(f"  1 x {SP_RANKS} spatial mesh vs 1 rank, bf16, {name} over {len(mesh)} batches "
            f"(read): ||mesh - one|| / ||one - f32|| = "
            f"{np.linalg.norm(k - p) / max(np.linalg.norm(p - f), 1e-300):.3f}")


def _sp_big_peak(ranks, smi):
    """One rank's whole bf16 step at SP_BIG px beside the ranks' peaks."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import make_train_step

    cfg = _sp_config("bfloat16", SP_BIG)
    state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
    (views, draws), = _tp_batches(cfg, 1, seed=SP_SEED)[0]
    make_train_step(cfg)(copy.deepcopy(state), views, draws, 0)  # warm-up
    one = _peak_step(cfg, state, views, draws)
    _launch_counts(reset=True)
    say(f"bf16 peak memory of a step, {SP_BIG} px, batch 8, on {smi}: rank 0 / 1 "
        f"{ranks[0]['big_peak_gib']:.3f} / {ranks[1]['big_peak_gib']:.3f} GiB beside one rank's "
        f"whole step {one:.3f} GiB")
    del state, views
    torch.cuda.empty_cache()


def spatial_phase(smi):
    """Spatial sharding on the one card: a 1 x 2 spatial mesh of two gloo
    ranks at the JAX defaults in f32 and bf16, against one rank and (bf16)
    its split in one process; the band kernels at the shapes its step gives
    them; peak memory a rank; 2 steps of train.loop.train with a checkpoint
    restored on one rank. Returns (the launches of the counted runs, the
    kernels line's rows of the band entry points)."""
    from shmgan_tpu_torch.data.synthetic import write_fixture_tree

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        write_fixture_tree(os.path.join(tmp, "tree"), SP_SCENES, 128, seed=0)
        t0 = time.perf_counter()
        ranks = _run_ranks(tmp, "chip_smoke.sp_rank", SP_RANKS, "sp", 600)
        say(f"{SP_RANKS} spatial ranks (gloo, one card, 64 of 128 rows each) ran in "
            f"{time.perf_counter() - t0:.1f} s")
        steps = _sp_step_checks(ranks, smi)
        _sp_big_peak(ranks, smi)
        loop = _tp_loop_checks(tmp, ranks, {k: 2 * n for k, n in
                                            sp_step_launches(torch.bfloat16).items()},
                               "spatial")
    shapes = ranks[0]["float32"]["shapes"] | ranks[0]["bfloat16"]["shapes"]
    in_worst = _sp_in_checks(shapes)
    pre_worst = _sp_pre_check()
    return _sum_counts(steps, loop), _sp_rows(shapes, in_worst, pre_worst)


# keras_h5: the reference's Keras SpecSeg (tests/data/torch_h5/, its README
# holds the file's sha256 and each leaf's shape and exactly rounded sums) on
# the command line's train, export and serve paths; KERAS_H5_SCENES scenes
# make 2 steps at batch 8
KERAS_H5 = os.path.join(ROOT, "tests", "data", "torch_h5", "specseg_keras2.h5")
KERAS_H5_SCENES = 16
KERAS_H5_REGION = "keras_h5/train_step"


def _keras_h5_readme():
    """(sha256, {leaf: (shape, sum, sum of squares)}) from the fixture's README."""
    with open(os.path.join(os.path.dirname(KERAS_H5), "README.md")) as f:
        text = f.read()
    sha = re.search(r"sha256 `([0-9a-f]{64})`", text).group(1)
    rows = {}
    for m in re.finditer(r"^\| (\S+) \| \(([\d, ]*)\) \| (\S+) \| (\S+) \|$", text, re.M):
        shape = tuple(int(d) for d in m.group(2).split(",") if d.strip())
        rows[m.group(1)] = (shape, float(m.group(3)), float(m.group(4)))
    return sha, rows


def _keras_h5_read():
    """The fixture through load_specseg_weights, held against its README
    exactly; (the tree, read seconds)."""
    import hashlib
    import math

    from shmgan_tpu_torch.checkpoint import load_specseg_weights

    sha, rows = _keras_h5_readme()
    t0 = time.perf_counter()
    specseg_vars = load_specseg_weights(KERAS_H5)
    read_s = time.perf_counter() - t0
    digest = hashlib.sha256(_read(KERAS_H5)).hexdigest()
    leaves = dict(_paths(specseg_vars))
    if digest != sha or sorted(leaves) != sorted(rows):
        raise AssertionError(f"{KERAS_H5}: sha256 {digest} (README {sha}), leaves "
                             f"{sorted(set(leaves) ^ set(rows))} differ")
    for path, want in rows.items():
        x = np.asarray(leaves[path], np.float64).ravel()
        got = (tuple(leaves[path].shape), math.fsum(x), math.fsum(x * x))
        if got != want or leaves[path].dtype != np.float32:
            raise AssertionError(f"{path}: (shape, sum, sum of squares) {got} "
                                 f"{leaves[path].dtype}, README {want}")
    n = sum(v.size for v in leaves.values())
    say(f"read {os.path.relpath(KERAS_H5, ROOT)} ({os.path.getsize(KERAS_H5)} bytes) in "
        f"{read_s:.4f} s: {len(leaves)} leaves, {n} float32 values, sha256, shapes, sums and "
        "sums of squares as its README states, exactly")
    return specseg_vars, read_s


def _keras_h5_profile(root):
    """One bf16 train step at the JAX defaults inside trace() and
    annotate(); the trace's CUDA kernel events by kernel; memory stats;
    debug_mode on a CUDA NaN. Returns the step's launches."""
    from shmgan_tpu_torch.models import build_models
    from shmgan_tpu_torch.profile_train import training_config
    from shmgan_tpu_torch.train.state import create_train_state
    from shmgan_tpu_torch.train.step import make_train_step, sample_draws
    from shmgan_tpu_torch.utils import profiling

    cfg = training_config("bfloat16")
    v, b, size = cfg.model.c_dim, cfg.train.batch_size, cfg.model.image_size
    state = create_train_state(cfg, build_models(cfg, device="cuda", seed=0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    views = torch.rand((v, b, size, size, 3), device="cuda", generator=gen)
    draws = sample_draws(cfg, gen, v, b, size, size)
    step = make_train_step(cfg)
    state, _ = step(state, views, draws, 0)              # warm-up
    torch.cuda.synchronize()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    with profiling.trace(os.path.join(root, "trace")) as prof:
        with profiling.annotate(KERAS_H5_REGION):
            state, metrics = step(state, views, draws, 0)
    trace_s = time.perf_counter() - t0
    counts = _launch_counts(reset=True)
    if counts != step_launches(torch.bfloat16):
        raise AssertionError(f"the traced step launched {counts}")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {label: sum(part in n for n in names) for label, part in (
        ("IN forward", "instance_norm_kernel"), ("IN backward", "instance_norm_bwd_"),
        ("preprocess", "standardize_yuv"))}
    regions = sum(e.get("name") == KERAS_H5_REGION for e in events)
    say(f"trace of one bf16 train step: {os.path.getsize(prof.trace_path)} bytes, "
        f"{len(names)} CUDA kernel events, of them {found}; the annotate region "
        f"{regions} time(s); traced step {trace_s:.3f} s (trace write included)")
    if not all(found.values()) or not regions:
        raise AssertionError(f"the trace lacks kernel events {found} or the region ({regions})")

    stats = profiling.device_memory_stats()
    say(f"device_memory_stats: {stats}")
    if not 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"]:
        raise AssertionError(f"device_memory_stats: {stats}")
    try:
        with profiling.debug_mode(nans=True):
            torch.log(torch.zeros(4, device="cuda")) * 0
    except FloatingPointError as e:
        say(f"debug_mode(nans=True) raised on a CUDA NaN: {e}")
    else:
        raise AssertionError("debug_mode(nans=True) let a CUDA NaN through")
    return counts


def keras_h5_phase(smi):
    """The reference's Keras SpecSeg on the card: the committed fixture read
    through load_specseg_weights against its README; cli --mode train (bf16,
    the JAX defaults, 2 steps, a subprocess) with --specseg_weights on it:
    launches, the checkpoint's SpecSeg bit for bit the file's (loaded as
    is, unchanged by the steps: it is frozen); --mode export, and the bundle
    served at b8, 256 px in f32 through the kernels against the plain
    versions; trace() around a bf16 train step, device_memory_stats(),
    debug_mode() and save_dataset_hdf5 of the served gen_rgb read back."""
    from shmgan_tpu_torch import Config, cli
    from shmgan_tpu_torch.checkpoint import load_inference_bundle
    from shmgan_tpu_torch.data.synthetic import write_fixture_tree
    from shmgan_tpu_torch.profile_serve import plain_versions
    from shmgan_tpu_torch.runtime import flax_msgpack, hdf5
    from shmgan_tpu_torch.serve import BatchInferenceEngine
    from shmgan_tpu_torch.utils.viz import save_dataset_hdf5

    specseg_vars, read_s = _keras_h5_read()
    with tempfile.TemporaryDirectory() as root:
        tree = os.path.join(root, "tree")
        write_fixture_tree(tree, KERAS_H5_SCENES, 128, seed=2)
        d = {k: os.path.join(root, k) for k in ("ckpt", "logs", "models", "results")}

        def argv(mode, *extra):
            return ["--mode", mode, "--data_dir", tree, "--batch_size", "8",
                    "--specseg_weights", KERAS_H5, "--checkpoint_save_step", "1",
                    "--checkpoint_save_dir", d["ckpt"], "--log_dir", d["logs"],
                    "--model_save_dir", d["models"], "--result_dir", d["results"], *extra]

        # cli --mode train in a subprocess, which prints its launches last
        script = ("import json, sys, chip_smoke; from shmgan_tpu_torch import cli; "
                  "cli.main(sys.argv[1:]); print(json.dumps(chip_smoke._launch_counts()))")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", script, *argv("train", "--num_epochs", "1")],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        train_s = time.perf_counter() - t0
        if proc.returncode != 0 or f"loaded frozen weights from {KERAS_H5}" not in proc.stdout:
            raise AssertionError(f"cli --mode train: exit {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        counts = json.loads(proc.stdout.strip().splitlines()[-1])
        want = {k: 2 * n for k, n in step_launches(torch.bfloat16).items()}
        say(f"cli --mode train --specseg_weights {os.path.basename(KERAS_H5)}, bf16, b8, 128 "
            f"px, filter 64: 2 steps in {train_s:.2f} s of subprocess; launches {counts}")
        if counts != want:
            raise AssertionError(f"--mode train launched {counts}, expected {want}")
        with open(os.path.join(d["ckpt"], "2", "state.msgpack"), "rb") as f:
            saved = flax_msgpack.loads(f.read())
        _leaves_equal(saved["specseg_vars"], specseg_vars,
                      "checkpoint 2's SpecSeg (after 2 steps) vs the h5")

        # --mode export, and the bundle served at b8, 256 px, f32
        t0 = time.perf_counter()
        cli.main(argv("export"))
        export_s = time.perf_counter() - t0
        bundle = load_inference_bundle(os.path.join(d["models"], "shmgan_infer.msgpack"))
        _leaves_equal(bundle[1], specseg_vars, "the bundle's SpecSeg vs the h5")
        cfg = Config.from_args(argv("serve", "--compute_dtype", "float32"))
        gen, specseg = bundle_models(cfg, bundle)
        cfg.model.image_size = 256
        engine = BatchInferenceEngine(cfg, gen, specseg, batch_size=8, device="cuda")
        rgb = scenes(8, 256, 256, np.random.default_rng(3))
        engine.process_images(rgb)                       # warm-up
        _launch_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.process_images(rgb)
        request_ms = (time.perf_counter() - t0) * 1e3
        served = _launch_counts(reset=True)
        want = {**{k: 0 for k in served}, _in_name(torch.float32): 18, "fused_standardize_yuv": 1}
        if served != want:
            raise AssertionError(f"the request launched {served}, expected {want}")
        with plain_versions():
            plain = engine.process_images(rgb)
        if any(_launch_counts(reset=True).values()):
            raise AssertionError("plain run launched a kernel")
        _compare(out, plain, "keras_h5 bundle, kernels vs plain, f32 b8 256 px:")
        say(f"--mode export {export_s:.2f} s; one f32 request of 8 at 256 px on the h5 "
            f"SpecSeg {request_ms:.2f} ms, launches {served}")

        # profiling and the hdf5 dump on the card
        traced = _keras_h5_profile(root)
        dump = os.path.join(root, "estimated_diffuse_images.hdf5")
        t0 = time.perf_counter()
        size = save_dataset_hdf5(out["gen_rgb"], dump)
        dump_s = time.perf_counter() - t0
        back = hdf5.File(dump)["default"][()]
        if back.dtype != out["gen_rgb"].dtype or not np.array_equal(back, out["gen_rgb"]):
            raise AssertionError(f"save_dataset_hdf5: read back {back.dtype} {back.shape}")
        say(f"save_dataset_hdf5 of gen_rgb {out['gen_rgb'].shape} {out['gen_rgb'].dtype}: "
            f"{size} bytes in {dump_s:.3f} s, read back bit for bit")
    say(f"keras_h5 on {smi}: h5 read {read_s:.4f} s, cli --mode train (2 steps) "
        f"{train_s:.2f} s, export {export_s:.2f} s, request {request_ms:.2f} ms, dump "
        f"{dump_s:.3f} s")
    return _sum_counts(counts, served, traced)


def main() -> int:
    current = "device"
    try:
        smi = phase("device", device_phase)
        current = "build"
        phase("build", build_phase)
        current = "kernels"
        rows = phase("kernels", kernels_phase)
        current = "serve"
        by_path = {}
        by_path["serve"], f32_outputs = phase("serve", serve_phase)
        current = "serve_bf16"
        by_path["serve_bf16"], _ = phase("serve_bf16", serve_phase, "bfloat16", f32_outputs)
        del f32_outputs
        current = "bundle"
        by_path["bundle"], bundle = phase("bundle", bundle_phase)
        current = "serve_native"
        by_path["serve_native"] = phase("serve_native", serve_native_phase, bundle)
        current = "formats"
        by_path["formats"] = phase("formats", formats_phase, bundle)
        current = "serve_http"
        by_path["serve_http"] = phase("serve_http", serve_http_phase)
        current = "serve_folder"
        by_path["serve_folder"] = phase("serve_folder", serve_folder_phase, bundle)
        current = "data_parallel"
        by_path["data_parallel"] = phase("data_parallel", data_parallel_phase, bundle)
        del bundle
        current = "model_parallel"
        by_path["model_parallel"] = phase("model_parallel", model_parallel_phase)
        current = "spatial"
        by_path["spatial"], band_rows = phase("spatial", spatial_phase, smi)
        rows += band_rows
        current = "train"
        by_path["train"] = phase("train", train_phase)
        current = "train_bf16"
        by_path["train_bf16"], bare_bf16 = phase("train_bf16", train_bf16_phase)
        current = "triplets"
        by_path["triplets"] = phase("triplets", triplets_phase)
        current = "train_loop"
        by_path["train_loop"] = phase("train_loop", train_loop_phase)
        current = "train_cli"
        by_path["train_cli"] = phase("train_cli", train_cli_phase, bare_bf16)
        current = "specseg_train"
        by_path["specseg_train"] = phase("specseg_train", specseg_train_phase)
        current = "quality_gan"
        by_path["quality_gan"] = phase("quality_gan", quality_gan_phase)
        current = "keras_h5"
        by_path["keras_h5"] = phase("keras_h5", keras_h5_phase, smi)
    except Exception:
        traceback.print_exc()
        say(f"chip_smoke FAILED in phase {current}")
        return 1
    for row in rows:
        row["launches_by_path"] = {p: n.get(row["name"], 0) for p, n in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    say(smi)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
