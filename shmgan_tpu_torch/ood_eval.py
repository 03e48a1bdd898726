"""Out-of-distribution evaluation of a trained generator and its mask net:
the counterpart of examples/ood_eval.py.

  A. the second synthetic scene family (data/ood.synth_ood_set: piecewise
     flat backgrounds, super-Gaussian plateaus and arc glints) with its
     ground truth: quality_eval's table (PSNR, SSIM, FID, evaluate_pair's),
     baselined by the identity, and galleries ood_synth_grid_<i>.png;
  B. the real photographs of the reference's results figure
     (data/ood.reference_photo_crops; skipped when it returns None). No
     ground truth exists: the mask's IoU, precision and recall against the
     reference SpecSeg's masks at 0.5 and the predicted and reference mask
     fractions; inside the mask, the luma drop of each output (the
     calibrated and composited outputs, and the reference's own output);
     outside it, each one's PSNR against the input; galleries
     ood_photo_grid_<i>.png beside the reference's outputs.

The weights come from a port checkpoint (--ckpt_dir, restored as
quality_eval.py restores it; --use_ema applies here only) or an inference
bundle (--bundle), whose header sets the image size, G's width, SpecSeg's
base and input channels and the upsample mode. --specseg_weights replaces
the frozen SpecSeg with another (its input channels read from the file).
Writes <out>/quality_ood.json with the JAX script's keys. The models
compute in float32.

    python -m shmgan_tpu_torch.ood_eval --bundle artifacts/shmgan_infer_256.msgpack \\
        --out runs/ood                        # the card
    ... --cpu                                 # the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from shmgan_tpu_torch.checkpoint import (CheckpointManager, load_inference_bundle,
                                         load_specseg_weights, specseg_in_channels_of)
from shmgan_tpu_torch.config import Config, torch_device
from shmgan_tpu_torch.convert import load_flax
from shmgan_tpu_torch.data import ood
from shmgan_tpu_torch.eval.quality import (Evaluator, device_name, log, mark_beats_identity,
                                           specseg_module)
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.ops.color import rgb_to_yuv
from shmgan_tpu_torch.train.state import create_train_state
from shmgan_tpu_torch.utils.viz import image_grid

PHOTO_NOTE = ("no ground truth exists for these photographs; specular_luma_drop should be "
              "positive (highlights dimmed) and outside-mask PSNR high (scene preserved). "
              "reference_output row measures the reference's own published result crops the "
              "same way.")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--bundle", type=str, default="",
                   help="inference bundle (checkpoint.load_inference_bundle), the "
                        "alternative to --ckpt_dir; its header overrides image_size, "
                        "filter_size, specseg_base_filters and upsample_mode")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--out", type=str, default="benchmarks/quality_ood")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--filter_size", type=int, default=64)
    p.add_argument("--specseg_base_filters", type=int, default=16)
    p.add_argument("--specseg_weights", type=str, default="",
                   help="frozen SpecSeg msgpack (default: the checkpoint's)")
    p.add_argument("--specseg_in_channels", type=int, default=1, choices=[1, 2],
                   help="input channels of the CHECKPOINT's frozen SpecSeg (--ckpt_dir "
                        "only; bundles and --specseg_weights read theirs)")
    p.add_argument("--upsample_mode", choices=["conv_transpose", "resize_conv"],
                   default="conv_transpose")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--mask_tta", action="store_true",
                   help="dihedral mask TTA in the inference graph")
    p.add_argument("--mask_chroma_prior", action="store_true",
                   help="fuse the dichromatic chroma prior into the inference-path mask "
                        "(ops/specprior.py)")
    p.add_argument("--eval_n", type=int, default=128)
    p.add_argument("--seed", type=int, default=4242)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def _luma(x: np.ndarray) -> np.ndarray:
    return rgb_to_yuv(torch.from_numpy(np.ascontiguousarray(x, np.float32)))[..., 0].numpy()


def _photo_part(ev: Evaluator, crops: Dict, out_dir: str) -> Dict:
    """Part B on the crops: the mask against the reference's, the luma drop
    inside our mask, the PSNR against the input outside it."""
    n = crops["inputs"].shape[0]
    log(f"[B] {n} real photo crops from the reference results figure")
    rb = ev.infer(crops["inputs"])
    ref_mask_bin = (crops["ref_masks"] > 0.5).astype(np.float32)
    our_mask_bin = (rb["mask"] > 0.5).astype(np.float32)
    inter = (ref_mask_bin * our_mask_bin).sum()
    union = np.maximum(ref_mask_bin, our_mask_bin).sum()
    mask_iou = float(inter / max(union, 1.0))
    # low precision: the net fires on bright diffuse regions; low recall: it
    # misses true glints
    mask_precision = float(inter / max(our_mask_bin.sum(), 1.0))
    mask_recall = float(inter / max(ref_mask_bin.sum(), 1.0))
    mask_pred_frac = float(our_mask_bin.mean())
    mask_ref_frac = float(ref_mask_bin.mean())

    inside = our_mask_bin[..., 0] > 0.5
    outside = ~inside
    y_in = _luma(crops["inputs"])
    stats = {}
    for name, img in (("calibrated", rb["gen_rgb_calibrated"]),
                      ("composited", rb["gen_rgb_composited"]),
                      ("reference_output", crops["ref_outputs"])):
        y_o = _luma(img)
        drop = float((y_in[inside] - y_o[inside]).mean()) if inside.any() else 0.0
        mse_out = (float(((img - crops["inputs"]) ** 2)[outside].mean())
                   if outside.any() else 0.0)
        psnr_out = float(-10.0 * np.log10(max(mse_out, 1e-12)))
        stats[name] = {"specular_luma_drop": round(drop, 4),
                       "outside_mask_psnr_vs_input": round(psnr_out, 2)}
        log(f"  {name}: luma drop in specular {drop:+.3f}, outside-mask PSNR vs input "
            f"{psnr_out:.1f} dB")
    log(f"  mask IoU vs reference SpecSeg masks: {mask_iou:.3f} (precision "
        f"{mask_precision:.3f}, recall {mask_recall:.3f}; predicted frac "
        f"{mask_pred_frac:.3f} vs ref {mask_ref_frac:.3f})")
    for i in range(n):
        image_grid([crops["inputs"][i], rb["mask"][i][..., 0], crops["ref_masks"][i][..., 0],
                    rb["gen_rgb_calibrated"][i], rb["gen_rgb_composited"][i],
                    crops["ref_outputs"][i]],
                   titles=["photo", "our mask", "ref mask", "calibrated", "composited",
                           "ref output"],
                   path=os.path.join(out_dir, f"ood_photo_grid_{i}.png"))
    return {"n": n, "mask_iou_vs_reference": round(mask_iou, 4),
            "mask_precision_vs_reference": round(mask_precision, 4),
            "mask_recall_vs_reference": round(mask_recall, 4),
            "mask_predicted_fraction": round(mask_pred_frac, 4),
            "mask_reference_fraction": round(mask_ref_frac, 4),
            "per_output": stats, "note": PHOTO_NOTE}


def main(argv=None) -> Dict:
    a = parse_args(argv)
    if not a.ckpt_dir and not a.bundle:
        raise SystemExit("one of --ckpt_dir / --bundle is required")
    device = torch_device("cpu" if a.cpu else "cuda")

    bundle = None
    if a.bundle:
        bundle = load_inference_bundle(a.bundle)
        hdr = bundle[2]
        a.image_size = hdr["image_size"]
        a.filter_size = hdr["filter_size"]
        a.specseg_base_filters = hdr["specseg_base_filters"]
        a.upsample_mode = hdr.get("upsample_mode", "conv_transpose")
        log(f"bundle {a.bundle}: step {hdr.get('step')} @{a.image_size}px {a.upsample_mode}")

    cfg = Config()
    cfg.model = dataclasses.replace(
        cfg.model, image_size=a.image_size, filter_size=a.filter_size,
        specseg_base_filters=a.specseg_base_filters, compute_dtype="float32",
        upsample_mode=a.upsample_mode,
        specseg_in_channels=(bundle[2].get("specseg_in_channels", 1) if bundle is not None
                             else a.specseg_in_channels))
    if a.use_ema:
        cfg.train = dataclasses.replace(cfg.train, g_ema=0.999)
    cfg.eval = dataclasses.replace(cfg.eval, mask_tta=a.mask_tta,
                                   mask_chroma_prior=a.mask_chroma_prior)
    log(f"device: {device_name(device)}")

    specseg_vars = None
    if a.specseg_weights and os.path.exists(a.specseg_weights):
        specseg_vars = load_specseg_weights(a.specseg_weights,
                                            base_filters=a.specseg_base_filters,
                                            image_size=a.image_size)
        in_ch = specseg_in_channels_of(specseg_vars)
        if in_ch != cfg.model.specseg_in_channels:
            log(f"specseg in_channels={in_ch} (auto-detected)")
        cfg.model = dataclasses.replace(cfg.model, specseg_in_channels=in_ch)

    if bundle is not None:
        gen, _, specseg = build_models(cfg, device=device)
        load_flax(gen, bundle[0])
        if specseg_vars is None:
            load_flax(specseg, bundle[1]["params"], bundle[1].get("batch_stats"))
        step = int(bundle[2].get("step", 0))
    else:
        # the template is the checkpoint's: its SpecSeg at --specseg_in_channels
        ckpt_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, specseg_in_channels=a.specseg_in_channels))
        state = create_train_state(ckpt_cfg, build_models(ckpt_cfg, device=device))
        restored = CheckpointManager(a.ckpt_dir).restore(state, step=a.step)
        if restored is None:
            raise SystemExit(f"no checkpoint under {a.ckpt_dir}")
        gen, specseg, step = restored.gen, restored.specseg, int(restored.step)
        # bundles hold the deployed tree already (the EMA, when the run kept one)
        if a.use_ema and restored.ema_g is not None:
            with torch.no_grad():
                for name, p in gen.named_parameters():
                    p.copy_(restored.ema_g[name])
    if specseg_vars is not None:
        # the point of --specseg_weights: another mask net under the same G
        specseg = specseg_module(specseg_vars, a.specseg_base_filters, device)
        log(f"specseg override: {a.specseg_weights}")
    log(f"restored checkpoint step {step}")

    ev = Evaluator(cfg, gen, specseg, a.batch, device)
    os.makedirs(a.out, exist_ok=True)

    log(f"[A] synthetic OOD family: {a.eval_n} scenes @ {a.image_size}px")
    ins, gts, _ = ood.synth_ood_set(a.eval_n, a.image_size, seed=a.seed)
    out = ev.infer(ins)
    gt_feats = ev.features(gts)
    part_a = {
        "eval_n": a.eval_n, "seed": a.seed,
        "identity_baseline": ev.metrics(ins, gts, gt_feats, "identity (input)"),
        "gen_calibrated": ev.metrics(out["gen_rgb_calibrated"], gts, gt_feats, "calibrated"),
        "gen_composited": ev.metrics(out["gen_rgb_composited"], gts, gt_feats, "composited"),
    }
    mark_beats_identity(part_a)
    for i in range(min(4, a.eval_n)):
        image_grid([ins[i], out["mask"][i][..., 0], out["gen_rgb_calibrated"][i],
                    out["gen_rgb_composited"][i], gts[i]],
                   titles=["OOD input", "mask", "calibrated", "composited", "GT"],
                   path=os.path.join(a.out, f"ood_synth_grid_{i}.png"))

    crops = ood.reference_photo_crops(a.image_size)
    if crops is None:
        log("[B] reference results.png not available: skipping real-photo OOD")
        part_b = None
    else:
        part_b = _photo_part(ev, crops, a.out)

    result = {"checkpoint_step": step, "image_size": a.image_size,
              "synthetic_ood": part_a, "reference_photos": part_b}
    path = os.path.join(a.out, "quality_ood.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    log(f"wrote {path}")
    return result


if __name__ == "__main__":
    main()
