"""The flagship trainer's phase A on the port: the counterpart of
examples/quality_train.py's SpecSeg phase. It trains the SpecSeg mask U-Net
on a curriculum made on the device (data/synthetic_device.py,
data/synthetic_dr.py), keeps the best of {live, EMA} by a held-out probe,
and exports it as a `.msgpack` (checkpoint.save_specseg_msgpack) that
`cli --specseg_weights`, `load_specseg_weights` and `make_mask_fn` read.

    python -m shmgan_tpu_torch.quality_train --phase specseg \\
        --specseg_curriculum dr2 --specseg_in_channels 2 --specseg_steps 8000 \\
        --out runs/specseg                   # the card
    ... --cpu                                # the CPU

Flags keep the JAX script's names, choices and defaults. Phase B (the GAN,
`--phase gan`, and `--phase both`, the default) is not ported yet and raises
before any work, as does `--data_parallel` above 1.

Step s draws its batch and its dropout masks from a generator seeded from
(seed, s), as the JAX script keys step s by `fold_in(k_data, s)`; the probes
come from the streams 2_000_000_000 (the base curriculum, 64 scenes; a
2-channel net's base probe shows it the same scenes) and 2_000_000_001 (the
DR curriculum's own mix), which no training step reaches. `--chunk` steps
run between host synchronisations; the probe runs every max(5 chunk, 500)
steps and after the last. Writes `<out>/specseg_synth.msgpack` (or
`--specseg_out`) and `<out>/quality_summary.json`.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from shmgan_tpu_torch.checkpoint import save_specseg_msgpack
from shmgan_tpu_torch.config import Config, MeshConfig, torch_device
from shmgan_tpu_torch.convert import flax_tree
from shmgan_tpu_torch.data import synthetic_device as sd
from shmgan_tpu_torch.data import synthetic_dr as sdr
from shmgan_tpu_torch.data.ood import synth_ood_set
from shmgan_tpu_torch.infer import ieee_f32
from shmgan_tpu_torch.models.specseg import SpecSeg
from shmgan_tpu_torch.ops.specprior import specseg_net_input
from shmgan_tpu_torch.train.specseg_train import (create_specseg_state, iou,
                                                  make_specseg_train_step)

PROBE_SCENES = 64
BASE_PROBE_STREAM = 2_000_000_000
DR_PROBE_STREAM = 2_000_000_001
OOD_PROBE_SEED = 777
_PHASE_B = ("phase B (the GAN) of the flagship trainer is not ported yet: ROADMAP Queue 1 "
            "item 12; run --phase specseg")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="SpecSeg -> GAN quality training (phase A on "
                                            "the port)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--filter_size", type=int, default=64)
    p.add_argument("--specseg_base_filters", type=int, default=16)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--chunk", type=int, default=100,
                   help="train steps between host synchronisations (log and probe cadence)")
    p.add_argument("--max_segment", type=str, default="-1",
                   help="JAX: device-program length of a chunk; no effect here")
    p.add_argument("--segment_budget_s", type=float, default=25.0,
                   help="JAX: with --max_segment auto; no effect here")
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
    # Phase B (not ported yet: parsed so the command lines stay JAX's)
    p.add_argument("--gan_steps", type=int, default=200000)
    p.add_argument("--gan_curriculum", choices=["base", "dr"], default="base")
    p.add_argument("--gan_base_mix", type=float, default=0.5)
    p.add_argument("--g_lr", type=float, default=2e-4)
    p.add_argument("--d_lr", type=float, default=1e-4)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--remat", choices=["none", "models", "disc", "gen"], default="none")
    p.add_argument("--pallas_in", choices=["auto", "on", "off"], default="auto",
                   help="JAX's Pallas instance norm; the port always takes its CUDA kernel")
    p.add_argument("--upsample_mode", choices=["conv_transpose", "resize_conv"],
                   default="conv_transpose")
    p.add_argument("--g_ema", type=float, default=0.0)
    p.add_argument("--g1_recon_weight", type=float, default=10.0)
    p.add_argument("--single_input_prob", type=float, default=0.5)
    p.add_argument("--camera_swap_prob", type=float, default=0.25)
    p.add_argument("--ed_mode", choices=["diffuse", "min"], default="diffuse")
    p.add_argument("--eval_every", type=int, default=5000)
    p.add_argument("--eval_n", type=int, default=64)
    p.add_argument("--fid_draws", type=int, default=3)
    p.add_argument("--fid_tol_rel", type=float, default=4.0)
    p.add_argument("--fid_tol_abs", type=float, default=2.0)
    p.add_argument("--plateau_evals", type=int, default=0)
    p.add_argument("--max_hours", type=float, default=6.0)
    p.add_argument("--out", type=str, default="benchmarks/quality_r2")
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--init_from", type=str, default="")
    p.add_argument("--init_from_image_size", type=int, default=128)
    p.add_argument("--init_from_bundle", type=str, default="")
    p.add_argument("--seed", type=int, default=25)
    p.add_argument("--data_parallel", type=int, default=1)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


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
    save_specseg_msgpack(best["vars"], path)
    log(f"[specseg] done: exported {best['kind']}@{best['step']} (heldout IoU "
        f"{best['heldout_iou']:.3f}, score {best['score']:.3f}) -> {path}")
    summary = {"heldout_iou": best["heldout_iou"], "steps": a.specseg_steps, "weights": path,
               "curriculum": a.specseg_curriculum, "in_channels": a.specseg_in_channels,
               "selected": {k: best[k] for k in ("score", "step", "kind", "heldout_dr_iou")}}
    return best["vars"], summary


def main(argv=None) -> Dict:
    a = parse_args(argv)
    if a.phase != "specseg":
        raise NotImplementedError(f"--phase {a.phase}: {_PHASE_B}")
    MeshConfig(data_parallel=a.data_parallel).check_single_device()
    device = torch_device("cpu" if a.cpu else "cuda")
    os.makedirs(a.out, exist_ok=True)
    log(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    cfg = build_cfg(a)
    summary = {"args": dict(vars(a))}
    _, summary["specseg"] = run_specseg_phase(a, cfg, device)
    out_path = os.path.join(a.out, "quality_summary.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    log(f"summary -> {out_path}")
    return summary


if __name__ == "__main__":
    main()
