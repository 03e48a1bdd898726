"""The flagship trainer on the port: the counterpart of
examples/quality_train.py. Two phases:

  Phase A  (`--phase specseg`) trains the SpecSeg mask U-Net on a curriculum
           made on the device (data/synthetic_device.py, data/synthetic_dr.py),
           keeps the best of {live, EMA} by a held-out probe, and exports it as
           a `.msgpack` (checkpoint.save_specseg_msgpack) that
           `cli --specseg_weights`, `load_specseg_weights` and `make_mask_fn`
           read.
  Phase B  (`--phase gan`) trains the GAN with that frozen mask net and the
           quality flags (live G1, G1 reconstruction, single-input draws,
           consistent domains; build_cfg), on the base or the DR polarimetric
           curriculum made on the device, and evaluates every `--eval_every`
           steps on held-out camera/diffuse pairs of the host's numpy
           curriculum (data/synthetic.synth_eval_set, another code path and
           other seeds): PSNR/SSIM of the calibrated output and of the input
           against the diffuse truth, and the SpecSeg-feature FID of each
           (eval/fid.py), per draw. It keeps the best checkpoint by PSNR
           under an FID gate (is_better_checkpoint), exports it as
           `best_bundle.msgpack` (float16), and writes galleries.
`--phase both` (the default) runs A, then B on A's net.

    python -m shmgan_tpu_torch.quality_train --phase specseg \\
        --specseg_curriculum dr2 --specseg_in_channels 2 --specseg_steps 8000 \\
        --out runs/specseg                   # the card
    python -m shmgan_tpu_torch.quality_train --phase gan --image_size 256 \\
        --batch 10 --gan_curriculum dr --upsample_mode resize_conv --g_ema 0.999 \\
        --specseg_in_channels 2 --specseg_out runs/specseg/specseg_synth.msgpack \\
        --out runs/gan                       # the card
    ... --cpu                                # the CPU

Flags keep the JAX script's names, choices and defaults. `--pallas_in` has
no effect: the port always takes its CUDA instance-norm kernel on the card.

`--data_parallel N` runs phase B on N ranks, one process a card, under a
launcher (`torchrun --nproc_per_node N -m shmgan_tpu_torch.quality_train
--data_parallel N ...`; above 1 without one it raises). Every rank renders
the global batch of each step from the same stream, takes its contiguous
block of it and of the step's draws, and the step averages the gradients
across the ranks, so N ranks compute what one does. Phase A, not data
parallel in the JAX script either, runs whole on every rank (the same
seeds) and rank 0's state is broadcast when phase B starts. Rank 0 logs,
evaluates, and writes the checkpoints, the bundle, the galleries and the
summaries; the ranks agree on the deadline and on a plateau stop.

Random streams: stream i of run `seed` is a generator seeded from
seed * 2^32 + i (`stream`), on the run's device.
  i = s                        phase A's step s: its batch and dropout masks
  i = GAN_STREAM + s           phase B's step s: its views, then its Draws
                               (flip, label, channel drop, D noise, D dropout)
  i = 2_000_000_000, ..001     phase A's base and DR probes
GAN_STREAM is 10^9, so the streams stay apart while phase A runs fewer than
10^9 steps and phase B fewer than 10^9; a resumed phase B draws what an
uninterrupted one would. The oracle's draws are numpy's, seeds 1234, 5678,
9012, 13141, 17181 (the first `--fid_draws`); the probes' OOD set seed 777.

Phase A: `--chunk` steps run between host synchronisations; the probe runs
every max(5 chunk, 500) steps and after the last. Writes
`<out>/specseg_synth.msgpack` (or `--specseg_out`).
Phase B: `--chunk` steps between synchronisations, a log line every 10
chunks, the oracle when a chunk crosses a multiple of `--eval_every` and
after the last step (unless that step was just evaluated). Writes
`quality_live.json` after every eval, the checkpoints (`--ckpt_dir`, default
`<out>/ckpt`, the newest 3), `best_bundle.msgpack`, and
`sample_{best,final}_{i}.png`. Both write `<out>/quality_summary.json`.
Phase B splits each chunk into segments as JAX's `--max_segment` does: N
steps each (`segment_plan`; -1 is 50 at 256 px and above, 0 the whole
chunk), or `auto`, segments sized to `--segment_budget_s` from their
measured time (train/segmenter.py). Each segment ends with a value fetch,
and the deadline (`--max_hours`) is read there, so a run stops at most one
segment past it. The steps and the final state are the same under any
setting.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from shmgan_tpu_torch.checkpoint import (CheckpointManager, export_inference_bundle,
                                         load_inference_bundle, load_specseg_weights,
                                         save_specseg_msgpack, transfer_matching_params)
from shmgan_tpu_torch.config import Config, torch_device
from shmgan_tpu_torch.convert import flax_tree, load_flax
from shmgan_tpu_torch.data import synthetic_device as sd
from shmgan_tpu_torch.data import synthetic_dr as sdr
from shmgan_tpu_torch.data.ood import synth_ood_set
from shmgan_tpu_torch.data.pipeline import local_batch
from shmgan_tpu_torch.data.synthetic import synth_eval_set
from shmgan_tpu_torch.eval.fid import frechet_distance, specseg_features
from shmgan_tpu_torch.infer import ieee_f32, make_infer_fn
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.models.specseg import SpecSeg
from shmgan_tpu_torch.ops.specprior import specseg_net_input
from shmgan_tpu_torch.ops.ssim import ssim as ssim_fn
from shmgan_tpu_torch.parallel.mesh import (agree_any, agree_max, is_main, local_device,
                                            maybe_initialize_distributed, rank,
                                            shutdown_distributed, training_mesh, world_size)
from shmgan_tpu_torch.train.specseg_train import (create_specseg_state, iou,
                                                  make_specseg_train_step)
from shmgan_tpu_torch.train.segmenter import AdaptiveSegmenter, run_segments, segment_plan
from shmgan_tpu_torch.train.state import TrainState, broadcast_state, create_train_state
from shmgan_tpu_torch.train.step import make_train_step, sample_draws
from shmgan_tpu_torch.utils.viz import image_grid

PROBE_SCENES = 64
BASE_PROBE_STREAM = 2_000_000_000
DR_PROBE_STREAM = 2_000_000_001
OOD_PROBE_SEED = 777
GAN_STREAM = 1_000_000_000
EVAL_DRAW_SEEDS = (1234, 5678, 9012, 13141, 17181)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="SpecSeg -> GAN quality training on the port")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--filter_size", type=int, default=64)
    p.add_argument("--specseg_base_filters", type=int, default=16)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--chunk", type=int, default=100,
                   help="train steps between host synchronisations (log and probe cadence)")
    p.add_argument("--max_segment", type=str, default="-1",
                   help="phase B: split each chunk into segments of at most this many "
                        "steps: an int, -1 (50 at image_size >= 256, off below), 0 (off), "
                        "or 'auto', segments sized from the measured step time to fit "
                        "--segment_budget_s; each segment ends with a host "
                        "synchronisation and a read of the --max_hours deadline")
    p.add_argument("--segment_budget_s", type=float, default=25.0,
                   help="with --max_segment auto: target wall-clock seconds a segment "
                        "(shrinks at once above 40 s)")
    p.add_argument("--phase", choices=["both", "specseg", "gan"], default="both")
    # Phase A
    p.add_argument("--specseg_steps", type=int, default=4000)
    p.add_argument("--specseg_batch", type=int, default=32)
    p.add_argument("--specseg_lr", type=float, default=2e-4)
    p.add_argument("--specseg_out", type=str, default="")
    p.add_argument("--specseg_curriculum", choices=["base", "dr", "dr2", "dr3"],
                   default="base",
                   help="base; dr = domain-randomised scenes mixed with base ones; dr2 = dr "
                        "with micro-glints; dr3 = dr2 with photo-statistics textures")
    p.add_argument("--specseg_in_channels", type=int, default=1, choices=[1, 2],
                   help="2: the chroma prior is a second input channel")
    p.add_argument("--specseg_base_mix", type=float, default=0.5,
                   help="share of each dr* batch from the base curriculum")
    p.add_argument("--specseg_probe", choices=["mix", "ood"], default="mix",
                   help="selection probe: the curriculum's held-out scenes, or the "
                        "out-of-distribution family (data/ood.py)")
    p.add_argument("--specseg_ema", type=float, default=0.999,
                   help="EMA decay of the params (0 = off); the export is the best of "
                        "{live, EMA} by the probe")
    # Phase B
    p.add_argument("--gan_steps", type=int, default=200000)
    p.add_argument("--gan_curriculum", choices=["base", "dr"], default="base",
                   help="dr mixes domain-randomised polarimetric stacks "
                        "(synthetic_dr.synth_views_batch_dr) into the GAN's batches")
    p.add_argument("--gan_base_mix", type=float, default=0.5,
                   help="share of each dr batch from the base curriculum")
    p.add_argument("--g_lr", type=float, default=2e-4)
    p.add_argument("--d_lr", type=float, default=1e-4)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--remat", choices=["none", "models", "disc", "gen"], default="none")
    p.add_argument("--pallas_in", choices=["auto", "on", "off"], default="auto",
                   help="JAX's Pallas instance norm; the port always takes its CUDA kernel")
    p.add_argument("--upsample_mode", choices=["conv_transpose", "resize_conv"],
                   default="conv_transpose")
    p.add_argument("--g_ema", type=float, default=0.0,
                   help="EMA decay of G's params (0 = off); the oracle, the galleries and "
                        "the best bundle take the EMA")
    p.add_argument("--g1_recon_weight", type=float, default=10.0)
    p.add_argument("--single_input_prob", type=float, default=0.5)
    p.add_argument("--camera_swap_prob", type=float, default=0.25)
    p.add_argument("--ed_mode", choices=["diffuse", "min"], default="diffuse")
    p.add_argument("--eval_every", type=int, default=5000)
    p.add_argument("--eval_n", type=int, default=64)
    p.add_argument("--fid_draws", type=int, default=3,
                   help="held-out scene draws an eval; FID is their mean")
    p.add_argument("--fid_tol_rel", type=float, default=4.0,
                   help="best-checkpoint gate: FID within rel x the lowest seen + abs")
    p.add_argument("--fid_tol_abs", type=float, default=2.0)
    p.add_argument("--plateau_evals", type=int, default=0,
                   help="stop after this many evals without a new best (0 = off)")
    p.add_argument("--max_hours", type=float, default=6.0,
                   help="wall-clock budget from the start; phase B stops at it")
    p.add_argument("--out", type=str, default="benchmarks/quality_r2")
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--init_from", type=str, default="",
                   help="a checkpoint directory of this trainer to warm-start G and D "
                        "from (leaves of matching path, shape and dtype)")
    p.add_argument("--init_from_image_size", type=int, default=128,
                   help="the image size --init_from was trained at")
    p.add_argument("--init_from_bundle", type=str, default="",
                   help="an inference bundle to warm-start G from; D and the optimizers "
                        "start fresh")
    p.add_argument("--seed", type=int, default=25)
    p.add_argument("--data_parallel", type=int, default=1)
    return p.parse_args(argv)


def log(msg: str) -> None:
    """A time-stamped line, from rank 0 only."""
    if is_main():
        print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def resolve_segment(max_segment: int, image_size: int) -> int:
    """The segment length of a chunk (0 = the whole chunk): -1 is 50 steps at
    image_size >= 256 and off below, as in the JAX script; `--max_segment
    auto` replaces this table with the AdaptiveSegmenter."""
    if max_segment < 0:
        return 50 if image_size >= 256 else 0
    return max_segment


def is_better_checkpoint(best: Dict, psnr: float, fid: float, min_fid: float,
                         fid_tol_rel: float = 4.0, fid_tol_abs: float = 2.0) -> bool:
    """The best-checkpoint gate: PSNR above the best so far, and FID within
    min_fid * fid_tol_rel + fid_tol_abs of the lowest FID of the earlier
    evals (min_fid inf before the first eval, which passes the FID gate)."""
    if psnr <= best.get("psnr", -1.0):
        return False
    if min_fid == float("inf"):
        return True
    return fid <= min_fid * fid_tol_rel + fid_tol_abs


def seed_gate_from_live(live_path: str, resume_step: int, history: List, best: Dict,
                        min_fid: float) -> Tuple[List, Dict, float]:
    """The gate's state (history, best, min_fid) from an earlier run's
    quality_live.json on resume, so the first eval after a resume is held
    to the earlier evals. Entries past the restored step are dropped; an
    unreadable file leaves the state as it is."""
    if not os.path.exists(live_path):
        return history, best, min_fid
    try:
        with open(live_path) as f:
            prior = json.load(f)
        history = [e for e in prior.get("history", []) if e.get("step", 0) <= resume_step]
        for e in history:
            if "gen_fid" in e:
                min_fid = min(min_fid, float(e["gen_fid"]))
        pb = prior.get("best") or {}
        if pb.get("psnr", -1.0) > 0 and pb.get("step", 0) <= resume_step:
            best = dict(pb)
        log(f"[gan] resume: seeded gate from {live_path} ({len(history)} prior evals, best "
            f"PSNR {best.get('psnr', -1.0):.2f} @ {best.get('step', '-')}, min FID "
            f"{min_fid:.3f})")
    except (ValueError, KeyError, OSError) as e:
        log(f"[gan] resume: could not seed gate from {live_path}: {e}")
    return history, best, min_fid


def build_cfg(a: argparse.Namespace) -> Config:
    """The JAX script's configuration: the model's widths and the quality
    flags of phase B."""
    cfg = Config()
    cfg.model = dataclasses.replace(
        cfg.model, image_size=a.image_size, filter_size=a.filter_size,
        specseg_base_filters=a.specseg_base_filters, compute_dtype=a.dtype,
        specseg_in_channels=a.specseg_in_channels, upsample_mode=a.upsample_mode)
    cfg.train = dataclasses.replace(
        cfg.train, batch_size=a.batch, g_lr=a.g_lr, d_lr=a.d_lr, seed=a.seed,
        scalar_channel_dropout=False, live_g1=True, g1_recon_weight=a.g1_recon_weight,
        single_input_prob=a.single_input_prob, consistent_domains=True, remat=a.remat,
        g_ema=a.g_ema)
    cfg.mesh = dataclasses.replace(cfg.mesh, data_parallel=a.data_parallel)
    return cfg


def stream(seed: int, index: int, device) -> torch.Generator:
    """The generator of draw stream `index` of run `seed`, on `device`."""
    return torch.Generator(device=device).manual_seed(seed * (1 << 32) + index)


def specseg_batch_fn(a: argparse.Namespace) -> Callable:
    """fn(gen, batch, h, w) -> (net inputs, masks) of the run's curriculum."""
    chroma = a.specseg_in_channels == 2
    if a.specseg_curriculum in ("dr", "dr2", "dr3"):
        fn = sdr.synth_specseg_batch_dr_chroma if chroma else sdr.synth_specseg_batch_dr
        return functools.partial(fn, base_mix=a.specseg_base_mix,
                                 glints=a.specseg_curriculum in ("dr2", "dr3"),
                                 photo=a.specseg_curriculum == "dr3")
    if chroma:
        return functools.partial(sdr.synth_specseg_batch_dr_chroma, base_mix=1.0, glints=False)
    return sd.synth_specseg_batch


def make_probe(a: argparse.Namespace, device) -> Callable:
    """probe(net) -> (score, base IoU, DR IoU or None) of an eval-mode net on
    the held-out scenes (IoU at 0.5 over the whole set, no empty-union
    fallback). The score is the OOD IoU with --specseg_probe ood, else the
    base IoU, or the mean of base and DR for a dr* curriculum."""
    h = w = a.image_size
    draws = sd.synth_specseg_rgb_batch_draws(stream(a.seed, BASE_PROBE_STREAM, device),
                                             PROBE_SCENES, h, w)
    rgb, base_msk = sd.synth_specseg_rgb_batch_render(draws, h, w)
    base_img = specseg_net_input(sd.standardized_luma(rgb), rgb, a.specseg_in_channels)
    dr = None
    if a.specseg_curriculum in ("dr", "dr2", "dr3"):
        dr = specseg_batch_fn(a)(stream(a.seed, DR_PROBE_STREAM, device), PROBE_SCENES, h, w)
    ood = None
    if a.specseg_probe == "ood":
        cam_np, _, msk_np = synth_ood_set(PROBE_SCENES, a.image_size, seed=OOD_PROBE_SEED)
        cam = torch.from_numpy(cam_np).to(device)
        ood = (specseg_net_input(sd.standardized_luma(cam), cam, a.specseg_in_channels),
               torch.from_numpy(msk_np).to(device))

    @torch.no_grad()
    def score_of(net: SpecSeg, img: torch.Tensor, msk: torch.Tensor) -> float:
        with ieee_f32():
            return float(iou(net(img), msk, empty=None))

    def probe(net: SpecSeg) -> Tuple[float, float, Optional[float]]:
        base = score_of(net, base_img, base_msk)
        dr_iou = score_of(net, *dr) if dr is not None else None
        if ood is not None:
            score = score_of(net, *ood)
        else:
            score = base if dr_iou is None else 0.5 * (base + dr_iou)
        return score, base, dr_iou

    return probe


def run_specseg_phase(a: argparse.Namespace, cfg: Config, device="cuda") -> Tuple[Dict, Dict]:
    """Train, probe, export: -> (the exported variables {"params",
    "batch_stats"} as numpy, the summary)."""
    device = torch_device(device)
    h = w = a.image_size
    b = a.specseg_batch
    cfg_ss = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, g_lr=a.specseg_lr))
    state = create_specseg_state(cfg_ss, torch.Generator().manual_seed(a.seed), device)
    step = make_specseg_train_step(cfg_ss)
    batch_fn = specseg_batch_fn(a)
    probe = make_probe(a, device)
    ema_decay = a.specseg_ema
    params = state.opt.params
    ema = [p.detach().clone() for p in params]
    probe_net = SpecSeg(base_filters=cfg.model.specseg_base_filters,
                        in_channels=a.specseg_in_channels).to(device).eval()
    best = {"score": -1.0}

    def consider(tag: str, weights, done: int) -> Tuple[float, float, Optional[float]]:
        """Probe the live net's statistics with `weights` as its params, and
        keep host copies of the best so far."""
        nonlocal best
        with torch.no_grad():
            for dst, src in zip(probe_net.parameters(), weights):
                dst.copy_(src)
            for dst, src in zip(probe_net.buffers(), state.net.buffers()):
                dst.copy_(src)
        score, base_iou, dr_iou = probe(probe_net)
        if score > best["score"]:
            p, bs = flax_tree(probe_net)
            best = {"score": score, "heldout_iou": base_iou, "heldout_dr_iou": dr_iou,
                    "step": done, "kind": tag, "vars": {"params": p, "batch_stats": bs}}
        return score, base_iou, dr_iou

    done = 0
    t0 = time.perf_counter()
    while done < a.specseg_steps:
        k = min(a.chunk, a.specseg_steps - done)
        for s in range(done, done + k):
            gen = stream(a.seed, s, device)
            img, msk = batch_fn(gen, b, h, w)
            keep = state.net.sample_keep(gen, b, h, w)
            state, metrics = step(state, img, msk, keep)
            if ema_decay > 0:
                with torch.no_grad():
                    torch._foreach_mul_(ema, ema_decay)
                    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - ema_decay))
        done += k
        loss_now = float(metrics["loss"])  # the chunk's synchronisation
        if done % max(a.chunk * 5, 500) < a.chunk or done >= a.specseg_steps:
            _, base_iou, dr_iou = consider("live", params, done)
            ema_txt = ""
            if ema_decay > 0:
                ema_score, _, _ = consider("ema", ema, done)
                ema_txt = f" ema_score={ema_score:.3f}"
            dr_txt = f" dr_iou={dr_iou:.3f}" if dr_iou is not None else ""
            secs = time.perf_counter() - t0
            log(f"[specseg {done}/{a.specseg_steps}] loss={loss_now:.4f} "
                f"train_iou={float(metrics['iou']):.3f} heldout_iou={base_iou:.3f}"
                f"{dr_txt}{ema_txt} ({done / secs:.2f} steps/s, {done * b / secs:.0f} img/s)")

    path = a.specseg_out or os.path.join(a.out, "specseg_synth.msgpack")
    if is_main():
        save_specseg_msgpack(best["vars"], path)
    log(f"[specseg] done: exported {best['kind']}@{best['step']} (heldout IoU "
        f"{best['heldout_iou']:.3f}, score {best['score']:.3f}) -> {path}")
    summary = {"heldout_iou": best["heldout_iou"], "steps": a.specseg_steps, "weights": path,
               "curriculum": a.specseg_curriculum, "in_channels": a.specseg_in_channels,
               "selected": {k: best[k] for k in ("score", "step", "kind", "heldout_dr_iou")}}
    return best["vars"], summary


# -- phase B: the GAN ---------------------------------------------------------------

def check_warm_start(a: argparse.Namespace) -> None:
    """Refuse, before any work, what phase B would refuse when it starts:
    both warm starts at once, an --init_from without a checkpoint, and a
    bundle trained with another upsample_mode (both modes share one
    parameter tree, so it would load and then run through the wrong op)."""
    if a.phase not in ("gan", "both"):
        return
    if a.init_from and a.init_from_bundle:
        raise SystemExit("phase B: --init_from and --init_from_bundle are mutually exclusive")
    if a.init_from and (not os.path.isdir(a.init_from)
                        or CheckpointManager(a.init_from).latest_step() is None):
        raise SystemExit(f"phase B: --init_from {a.init_from}: no checkpoint found")
    if a.init_from_bundle:
        with open(a.init_from_bundle + ".json") as f:
            mode = json.load(f).get("upsample_mode", "conv_transpose")
        if mode != a.upsample_mode:
            raise SystemExit(f"phase B: --init_from_bundle was trained with upsample_mode="
                             f"{mode}; pass --upsample_mode to match")


def _ema_from_gen(state: TrainState) -> None:
    """The EMA (when on) restarts from G's current parameters."""
    if state.ema_g is not None:
        state.ema_g = {k: p.detach().clone() for k, p in state.gen.named_parameters()}


def _warm_start(a: argparse.Namespace, cfg: Config, state: TrainState,
                specseg_vars: Optional[Dict], device) -> None:
    """--init_from: G and D from a checkpoint of a run at
    --init_from_image_size, leaf by leaf where path, shape and dtype match
    (transfer_matching_params); --init_from_bundle: G from an inference
    bundle. The optimizers start fresh, the EMA from the merged G."""
    if a.init_from:
        cfg_src = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, image_size=a.init_from_image_size))
        models = build_models(cfg_src, device=device, seed=a.seed)
        if specseg_vars is not None:
            load_flax(models[2], specseg_vars["params"], specseg_vars.get("batch_stats"))
        src = CheckpointManager(a.init_from, max_to_keep=3).restore(
            create_train_state(cfg_src, models))
        if src is None:
            raise SystemExit(f"phase B: --init_from {a.init_from}: no checkpoint found")
        kept = fresh = 0
        for name in ("gen", "disc"):
            merged, k, f = transfer_matching_params(flax_tree(getattr(state, name))[0],
                                                    flax_tree(getattr(src, name))[0])
            load_flax(getattr(state, name), merged)
            kept, fresh = kept + k, fresh + f
        _ema_from_gen(state)
        log(f"[gan] init_from {a.init_from} (step {src.step}, {a.init_from_image_size}px): "
            f"{kept} leaves transferred, {fresh} fresh")
        del src, models  # a whole state at the source size: free it for the run
    if a.init_from_bundle:
        bundle_g, _, hdr = load_inference_bundle(a.init_from_bundle)
        merged, kept, fresh = transfer_matching_params(flax_tree(state.gen)[0], bundle_g)
        load_flax(state.gen, merged)
        _ema_from_gen(state)
        log(f"[gan] init_from_bundle {a.init_from_bundle} (step {hdr.get('step')}, "
            f"{hdr.get('image_size')}px, store_dtype={hdr.get('store_dtype', 'float32')}): "
            f"{kept} G leaves transferred, {fresh} fresh")


def oracle_chunk(infer: Callable, gen, specseg: SpecSeg, ins: torch.Tensor,
                 gts: torch.Tensor) -> Tuple:
    """One chunk of the held-out eval: -> (the output's (PSNR, SSIM,
    features), the input's (PSNR, SSIM, features), the truth's features,
    the calibrated output, the mask), per image. PSNR and SSIM against the
    diffuse truth `gts`; `infer` is make_infer_fn's with
    `gen_rgb_calibrated` and `mask`."""
    out = infer(gen, specseg, ins)
    calibrated = out["gen_rgb_calibrated"]

    def per_image(x: torch.Tensor):
        mse = ((x - gts) ** 2).mean(dim=(1, 2, 3))
        psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
        return psnr, ssim_fn(x, gts, max_val=1.0), specseg_features(specseg, x)

    return (per_image(calibrated), per_image(ins), specseg_features(specseg, gts), calibrated,
            out["mask"])


def make_oracle(a: argparse.Namespace, cfg: Config, state: TrainState, device) -> Callable:
    """oracle() -> (gen PSNR, gen SSIM, gen FID, input PSNR, input SSIM,
    input FID, 4 generated images, their 4 masks, gen FID per draw): the
    held-out eval of the state's G (its EMA when on) in float32.

    The draws stay numpy on the host; the oracle moves min(8, eval_n)
    images at a time to the device, runs inference (`gen_rgb_calibrated`,
    `mask`), and keeps each image's PSNR and SSIM against the diffuse truth
    and the SpecSeg features of the output, the input and the truth. Means
    run over every draw's images; FID is computed per draw, of the output's
    and of the input's features against the truth's, and averaged."""
    draws = [synth_eval_set(a.eval_n, a.image_size, seed=ds)[:2]
             for ds in EVAL_DRAW_SEEDS[:max(1, a.fid_draws)]]
    eval_bs = min(8, a.eval_n)
    if a.eval_n % eval_bs != 0:
        raise ValueError("eval_n must be a multiple of 8 (or < 8)")
    eval_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    eval_gen, _, eval_ss = build_models(eval_cfg, device=device)
    eval_ss.load_state_dict(state.specseg.state_dict())
    infer = make_infer_fn(eval_cfg, outputs=("gen_rgb_calibrated", "mask"))

    def oracle():
        eval_params = state.ema_g if state.ema_g is not None else dict(
            state.gen.named_parameters())
        with torch.no_grad():
            for name, p in eval_gen.named_parameters():
                p.copy_(eval_params[name])
        gen4 = mask4 = None
        sums = {k: [] for k in ("g_psnr", "g_ssim", "i_psnr", "i_ssim")}
        g_fids, i_fids = [], []
        for d_ins, d_gts in draws:
            feats = {"g": [], "i": [], "gt": []}
            for i in range(0, a.eval_n, eval_bs):
                g_m, i_m, f_gt, gen, mask = oracle_chunk(
                    infer, eval_gen, eval_ss, torch.from_numpy(d_ins[i:i + eval_bs]).to(device),
                    torch.from_numpy(d_gts[i:i + eval_bs]).to(device))
                for tag, (psnr, ssim, feat) in (("g", g_m), ("i", i_m)):
                    sums[f"{tag}_psnr"].append(psnr.cpu().numpy())
                    sums[f"{tag}_ssim"].append(ssim.cpu().numpy())
                    feats[tag].append(feat)
                feats["gt"].append(f_gt)
                if gen4 is None:
                    gen4, mask4 = gen[:4].cpu().numpy(), mask[:4].cpu().numpy()
            gt = torch.cat(feats["gt"])
            g_fids.append(float(frechet_distance(torch.cat(feats["g"]), gt)))
            i_fids.append(float(frechet_distance(torch.cat(feats["i"]), gt)))
        gp, gs, ip, is_ = (float(np.mean(np.concatenate(sums[k])))
                           for k in ("g_psnr", "g_ssim", "i_psnr", "i_ssim"))
        return (gp, gs, float(np.mean(g_fids)), ip, is_, float(np.mean(i_fids)), gen4, mask4,
                g_fids)

    oracle.gallery_inputs = draws[0]
    oracle.eval_gen, oracle.eval_specseg = eval_gen, eval_ss
    return oracle


def run_gan_phase(a: argparse.Namespace, cfg: Config, specseg_vars: Optional[Dict],
                  deadline: float, device="cuda") -> Dict:
    """Train the GAN for --gan_steps (or until the deadline or a plateau),
    evaluating every --eval_every steps: -> {"final", "best", "history",
    "train_steps", "wall_s"}, as the JAX script returns."""
    device = torch_device(device)
    h = w = a.image_size
    b, v = a.batch, cfg.model.c_dim
    if a.gan_curriculum == "dr":
        views_fn = functools.partial(sdr.synth_views_batch_dr, base_mix=a.gan_base_mix)
        log(f"[gan] DR curriculum (base_mix={a.gan_base_mix})")
    else:
        views_fn = sd.synth_views_batch

    models = build_models(cfg, device=device, seed=a.seed)
    if specseg_vars is not None:
        load_flax(models[2], specseg_vars["params"], specseg_vars.get("batch_stats"))
    state = create_train_state(cfg, models)
    _warm_start(a, cfg, state, specseg_vars, device)

    ckpt = CheckpointManager(a.ckpt_dir or os.path.join(a.out, "ckpt"), max_to_keep=3)
    if ckpt.restore(state) is not None:
        log(f"[gan] resumed from step {state.step}")
    broadcast_state(state)
    step_fn = make_train_step(cfg)
    main, rank_index, world = is_main(), rank(), world_size()
    if world > 1:
        log(f"[gan] data parallel over {world} ranks, {b // world} images a rank")
    oracle = make_oracle(a, cfg, state, device) if main else None

    os.makedirs(a.out, exist_ok=True)
    live_path = os.path.join(a.out, "quality_live.json")
    history: List[Dict] = []
    best: Dict = {"psnr": -1.0}
    min_fid = float("inf")   # the lowest FID of the evals so far: the gate's anchor
    last_eval_step = -1      # the final eval is skipped when the last chunk ran one
    if state.step > 0:
        history, best, min_fid = seed_gate_from_live(live_path, state.step, history, best,
                                                     min_fid)

    def record(step_i, gp, gs, gf, ip, is_, if_, rate, g_fids=None) -> Dict:
        entry = {"step": step_i, "gen_psnr": round(gp, 4), "gen_ssim": round(gs, 4),
                 "gen_fid": round(gf, 5), "input_psnr": round(ip, 4),
                 "input_ssim": round(is_, 4), "input_fid": round(if_, 5),
                 "beats_identity": bool(gp > ip and gs > is_),
                 "images_per_sec": round(rate, 1)}
        if g_fids is not None and len(g_fids) > 1:
            entry["gen_fid_draws"] = [round(x, 5) for x in g_fids]
        history.append(entry)
        with open(live_path, "w") as f:
            json.dump({"config": dict(vars(a)), "history": history, "best": best}, f, indent=1)
        log(f"[gan eval @{step_i}] gen PSNR {gp:.2f} SSIM {gs:.4f} FID {gf:.4f} | input PSNR "
            f"{ip:.2f} SSIM {is_:.4f} FID {if_:.4f} | "
            f"{'BEATS' if entry['beats_identity'] else 'trails'} identity | {rate:.0f} img/s")
        return entry

    def save_gallery(gen4, mask4, tag: str) -> None:
        """A row of: the camera input, the mask, the generated image, the diffuse truth."""
        ins_np, gts_np = oracle.gallery_inputs
        for i in range(gen4.shape[0]):
            image_grid([ins_np[i], mask4[i][..., 0], gen4[i], gts_np[i]],
                       path=os.path.join(a.out, f"sample_{tag}_{i}.png"))

    # evals since the best checkpoint, from the resumed history
    evals_since_best = sum(1 for e in history if e.get("step", 0) > best.get("step", 0)) \
        if best.get("psnr", -1.0) > 0 else 0
    seg_arg = str(a.max_segment).strip().lower()
    segmenter = None
    if seg_arg == "auto":
        segmenter = AdaptiveSegmenter(
            budget_s=a.segment_budget_s,
            init_steps=resolve_segment(-1, a.image_size) or min(a.chunk, 100))
        seg = 0
        log(f"[gan] adaptive segmenting: {segmenter.summary()}")
    else:
        seg = resolve_segment(int(seg_arg), a.image_size)
        if seg and seg < a.chunk:
            log(f"[gan] chunk {a.chunk} run as segments of <= {seg} steps")

    def program(s0: int, kk: int):
        nonlocal state
        for s in range(s0, s0 + kk):
            # the global batch and its draws, cut to this rank's block
            gen = stream(a.seed, GAN_STREAM + s, device)
            views = views_fn(gen, b, h, w, ed_mode=a.ed_mode,
                             camera_swap_prob=a.camera_swap_prob)
            draws = sample_draws(cfg, gen, v, b, h, w).shard(rank_index, world)
            state, metrics = step_fn(state, local_batch(views, rank_index, world), draws, 1)
        return metrics

    def observe(kk: int, wall: float) -> None:
        # the slowest rank's time, so that every rank plans the same segments
        segmenter.observe(kk, agree_max(wall))

    def past_deadline() -> bool:
        return agree_any(time.time() >= deadline)

    done = state.step
    t0 = chunk_t0 = time.perf_counter()
    last_rate = 0.0
    while done < a.gan_steps and not past_deadline():
        k = min(a.chunk, a.gan_steps - done)
        segments = segmenter.plan(done, k) if segmenter else segment_plan(done, k, seg)
        # each segment ends with a synchronisation; the deadline is read at each end
        metrics, k = run_segments(segments, program, lambda m: float(m["total_G"]),
                                  observe if segmenter else None, past_deadline)
        # the last segment's metrics feed the log line: the newest step's
        tg = float(metrics["total_G"])  # synchronised at the last segment's end
        now = time.perf_counter()
        last_rate = k * b / (now - chunk_t0)
        chunk_t0 = now
        prev_done, done = done, done + k
        if done % (a.chunk * 10) < a.chunk:
            g1 = float(metrics["G1_L1"]) if "G1_L1" in metrics else float("nan")
            seg_note = f" | {segmenter.summary()}" if segmenter else ""
            log(f"[gan {done}/{a.gan_steps}] total_G={tg:.2f} G1_L1={g1:.4f} "
                f"({last_rate:.0f} img/s){seg_note}")
        if done // a.eval_every > prev_done // a.eval_every:
            plateau = False
            if main:
                gp, gs, gf, ip, is_, if_, gen4, mask4, g_fids = oracle()
                is_best = is_better_checkpoint(best, gp, gf, min_fid, a.fid_tol_rel,
                                               a.fid_tol_abs)
                if is_best:  # before record(), so the live file's best is current
                    best.update({"psnr": gp, "ssim": gs, "fid": gf, "step": done})
                min_fid = min(min_fid, gf)
                record(done, gp, gs, gf, ip, is_, if_, last_rate, g_fids)
            ckpt.save(state, step=done)
            if main:
                if is_best:
                    save_gallery(gen4, mask4, "best")
                    evals_since_best = 0
                    # the eval tree (the EMA when on) survives the checkpoints' rotation
                    export_inference_bundle(oracle.eval_gen, oracle.eval_specseg, cfg,
                                            os.path.join(a.out, "best_bundle.msgpack"),
                                            step=state.step, store_dtype="float16")
                else:
                    evals_since_best += 1
                plateau = a.plateau_evals > 0 and evals_since_best >= a.plateau_evals
                if plateau:
                    log(f"[gan] plateau stop: {evals_since_best} consecutive evals without "
                        f"a new best (best PSNR {best['psnr']:.2f} @ step "
                        f"{best.get('step', '-')})")
            last_eval_step = done
            if agree_any(plateau):
                break

    entry = None
    if last_eval_step == done:
        if main:
            entry = history[-1]
            save_gallery(gen4, mask4, "final")
    else:
        if main:
            gp, gs, gf, ip, is_, if_, gen4, mask4, g_fids = oracle()
            if is_better_checkpoint(best, gp, gf, min_fid, a.fid_tol_rel, a.fid_tol_abs):
                best.update({"psnr": gp, "ssim": gs, "fid": gf, "step": done})
            min_fid = min(min_fid, gf)
            entry = record(done, gp, gs, gf, ip, is_, if_, last_rate, g_fids)
        ckpt.save(state, step=done)
        if main:
            save_gallery(gen4, mask4, "final")
    wall = time.perf_counter() - t0
    log(f"[gan] finished at step {done} ({wall:.0f}s this run); best PSNR "
        f"{best['psnr']:.2f} @ step {best.get('step', done)}")
    return {"final": entry, "best": best, "history": history, "train_steps": done,
            "wall_s": round(wall, 1)}


def main(argv=None) -> Dict:
    a = parse_args(argv)
    joined = not dist.is_initialized() and maybe_initialize_distributed(
        "gloo" if a.cpu else "nccl")
    try:
        return _main(a)
    finally:
        if joined:
            shutdown_distributed()


def _main(a: argparse.Namespace) -> Dict:
    cfg = build_cfg(a)
    training_mesh(cfg)
    if a.phase in ("gan", "both") and a.batch % world_size():
        raise ValueError(f"global batch {a.batch} not divisible by {world_size()} processes")
    check_warm_start(a)
    device = local_device(torch_device("cpu" if a.cpu else "cuda"))
    if is_main():
        os.makedirs(a.out, exist_ok=True)
    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    deadline = time.time() + a.max_hours * 3600.0
    specseg_vars = None
    summary = {"args": dict(vars(a))}
    if a.phase in ("both", "specseg"):
        specseg_vars, summary["specseg"] = run_specseg_phase(a, cfg, device)
    elif a.specseg_out and os.path.exists(a.specseg_out):
        specseg_vars = load_specseg_weights(a.specseg_out,
                                            base_filters=cfg.model.specseg_base_filters,
                                            image_size=a.image_size)
        log(f"[gan] loaded frozen SpecSeg from {a.specseg_out}")
    if a.phase in ("both", "gan"):
        summary["gan"] = run_gan_phase(a, cfg, specseg_vars, deadline, device)
    if is_main():
        out_path = os.path.join(a.out, "quality_summary.json")
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=1)
        log(f"summary -> {out_path}")
    return summary


if __name__ == "__main__":
    main()
