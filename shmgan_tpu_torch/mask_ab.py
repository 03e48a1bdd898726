"""A/B of frozen SpecSeg nets on the synthetic OOD family and the reference
figure's real photographs: the counterpart of examples/mask_ab.py. SpecSeg
alone (infer.make_mask_fn), no generator.

Each net (`--nets name=path.msgpack`; 1-channel and 2-channel chroma-input
nets alike, the channels read from the file) gets a row per variant: as
is, and with `--tta` (dihedral mask TTA, '<name>+tta') and `--prior` (the
chroma prior fused, '<name>+prior', and '+tta+prior' with both). A row
holds the IoU, precision, recall and predicted fraction against the OOD
set's ground-truth masks at 0.5 and the IoU at each threshold of a 9-step
grid, the threshold that grid's best IoU selects and, where
data/ood.reference_photo_crops returns the photos, the same figures against
the reference SpecSeg's masks at 0.5 and at the selected threshold, the
photo IoU by threshold, and the IoU of the 0.5 mask dilated by 1-3 pixels.
`--arms name=p1,p2,...` evaluates each seed's net as its own row
('name#i') and adds each variant's mean, sd (ddof 1) and seeds of every
figure; `--ensembles name=a+b` rows threshold the mean of the members'
probabilities. Writes the JSON at --out with the JAX script's keys.

    python -m shmgan_tpu_torch.mask_ab --nets dr=<dr.msgpack> \\
        --arms chroma=<seed 25 .msgpack>,<seed 26 .msgpack> \\
        --ensembles both=dr+chroma#0 --tta --prior --out runs/mask_ab.json   # the card
    ... --cpu                                                                # the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from shmgan_tpu_torch.checkpoint import load_specseg_weights, specseg_in_channels_of
from shmgan_tpu_torch.config import Config, torch_device
from shmgan_tpu_torch.data import ood
from shmgan_tpu_torch.eval.quality import device_name, log, specseg_module
from shmgan_tpu_torch.infer import make_mask_fn

THRESH_GRID = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
OOD_SEED = 4242
ARM_SECTIONS = ("synthetic_ood_vs_gt", "real_photos_vs_reference_masks",
                "real_photos_at_ood_threshold")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--nets", nargs="*", default=[], help="name=path.msgpack pairs")
    p.add_argument("--arms", nargs="*", default=[],
                   help="name=path1,path2,... multi-seed arms: each path is one seed's "
                        "weights, evaluated as its own row (name#i); the artifact adds "
                        "each arm's mean and sd over the seeds of every figure")
    p.add_argument("--ensembles", nargs="*", default=[],
                   help="name=netA+netB[+netC...] rows: the mean of the named nets' "
                        "probabilities (names from --nets)")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--specseg_base_filters", type=int, default=16)
    p.add_argument("--ood_n", type=int, default=64,
                   help="synthetic-OOD scenes for the GT-mask IoU column")
    p.add_argument("--out", type=str, default="benchmarks/quality_r3_dr/mask_ab.json")
    p.add_argument("--tta", action="store_true",
                   help="also report each net with dihedral mask TTA (rows '<name>+tta')")
    p.add_argument("--prior", action="store_true",
                   help="also report each net fused with the dichromatic chroma prior "
                        "(ops/specprior.py; rows '<name>+prior')")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def iou_pr(pred: np.ndarray, ref: np.ndarray, thresh: float = 0.5) -> Dict:
    """IoU, precision, recall and predicted fraction of pred > thresh
    against ref > 0.5."""
    pb = (pred > thresh).astype(np.float32)
    rb = (ref > 0.5).astype(np.float32)
    inter = float((pb * rb).sum())
    union = float(np.maximum(pb, rb).sum())
    return {"iou": round(inter / max(union, 1.0), 4),
            "precision": round(inter / float(max(pb.sum(), 1.0)), 4),
            "recall": round(inter / float(max(rb.sum(), 1.0)), 4),
            "pred_fraction": round(float(pb.mean()), 4)}


def make_row(ood_pred: np.ndarray, ood_mask: np.ndarray, ph_pred: Optional[np.ndarray],
             ref_masks: Optional[np.ndarray], meta: Dict) -> Dict:
    row = dict(meta)
    row["synthetic_ood_vs_gt"] = iou_pr(ood_pred, ood_mask)
    # the operating point comes from the synthetic OOD probe (ground-truth
    # masks, no real photo), and the photos are scored at it
    ood_by_t = {str(t): iou_pr(ood_pred, ood_mask, t)["iou"] for t in THRESH_GRID}
    best_t = float(max(ood_by_t, key=ood_by_t.get))
    row["ood_iou_by_threshold"] = ood_by_t
    row["ood_selected_threshold"] = best_t
    if ph_pred is not None:
        row["real_photos_vs_reference_masks"] = iou_pr(ph_pred, ref_masks)
        row["real_photos_at_ood_threshold"] = iou_pr(ph_pred, ref_masks, best_t)
        row["photo_iou_by_threshold"] = {str(t): iou_pr(ph_pred, ref_masks, t)["iou"]
                                         for t in THRESH_GRID}
        # hits inside the reference regions (too tight) recover IoU when
        # grown; whole missed components (blind) do not
        row["photo_iou_by_dilation"] = {}
        pb = (ph_pred > 0.5).astype(np.float32)
        for rad in (1, 2, 3):
            k = 2 * rad + 1
            pad = np.pad(pb, ((0, 0), (rad, rad), (rad, rad), (0, 0)))
            dil = np.max(np.stack([pad[:, dy:dy + pb.shape[1], dx:dx + pb.shape[2]]
                                   for dy in range(k) for dx in range(k)]), axis=0)
            row["photo_iou_by_dilation"][str(rad)] = iou_pr(dil, ref_masks)["iou"]
    return row


def arm_stats(seed_rows, variant: str) -> Dict:
    """Mean, sd (ddof 1; 0.0 for one seed) and the seeds of every figure of
    an arm's rows."""
    agg = {"n_seeds": len(seed_rows), "tta": "tta" in variant, "prior": "prior" in variant}
    for section in ARM_SECTIONS:
        if section not in seed_rows[0]:
            continue
        agg[section] = {}
        for metric in seed_rows[0][section]:
            vals = np.array([r[section][metric] for r in seed_rows], dtype=np.float64)
            agg[section][metric] = {
                "mean": round(float(vals.mean()), 4),
                "sd": round(float(vals.std(ddof=1)), 4) if len(vals) > 1 else 0.0,
                "seeds": [round(float(v), 4) for v in vals]}
    return agg


def main(argv=None) -> Dict:
    a = parse_args(argv)
    device = torch_device("cpu" if a.cpu else "cuda")
    variants = {"": {}}
    if a.tta:
        variants["+tta"] = {"tta": True}
    if a.prior:
        variants["+prior"] = {"prior": True}
        if a.tta:
            variants["+tta+prior"] = {"tta": True, "prior": True}

    # one mask function per (variant, input channels): 1-channel nets and
    # 2-channel chroma-input nets share the rows
    fns = {}

    def mask_fn_for(variant: str, in_ch: int):
        if (variant, in_ch) not in fns:
            cfg = Config()
            cfg.model = dataclasses.replace(
                cfg.model, image_size=a.image_size,
                specseg_base_filters=a.specseg_base_filters, specseg_in_channels=in_ch,
                compute_dtype="float32")
            fns[variant, in_ch] = make_mask_fn(cfg, **variants[variant])
        return fns[variant, in_ch]

    log(f"device: {device_name(device)}")
    crops = ood.reference_photo_crops(a.image_size)
    ood_in, _, ood_mask = ood.synth_ood_set(a.ood_n, a.image_size, seed=OOD_SEED)
    ref_masks = crops["ref_masks"] if crops is not None else None
    if not a.nets and not a.arms:
        raise SystemExit("at least one of --nets / --arms is required")

    def probabilities(mask_fn, net, rgb: np.ndarray) -> np.ndarray:
        return mask_fn(net, torch.from_numpy(rgb).to(device)).float().cpu().numpy()

    results, preds = {}, {}   # preds: (net name, variant) -> (OOD, photo) probabilities

    def eval_net(base_name: str, path: str) -> None:
        vars_ = load_specseg_weights(path, base_filters=a.specseg_base_filters,
                                     image_size=a.image_size)
        in_ch = specseg_in_channels_of(vars_)
        net = specseg_module(vars_, a.specseg_base_filters, device)
        for variant in variants:
            mask_fn = mask_fn_for(variant, in_ch)
            ood_pred = probabilities(mask_fn, net, ood_in)
            ph_pred = (probabilities(mask_fn, net, crops["inputs"])
                       if crops is not None else None)
            preds[base_name, variant] = (ood_pred, ph_pred)
            row = make_row(ood_pred, ood_mask, ph_pred, ref_masks,
                           {"weights": path, "tta": "tta" in variant,
                            "prior": "prior" in variant, "in_channels": in_ch})
            results[base_name + variant] = row
            log(f"{base_name + variant}: ood_iou={row['synthetic_ood_vs_gt']['iou']} "
                f"photo={row.get('real_photos_vs_reference_masks')}")

    for spec in a.nets:
        base_name, path = spec.split("=", 1)
        eval_net(base_name, path)

    arms = {}
    for spec in a.arms:
        arm_name, paths_s = spec.split("=", 1)
        paths = paths_s.split(",")
        for i, path in enumerate(paths):
            eval_net(f"{arm_name}#{i}", path)
        for variant in variants:
            agg = arm_stats([results[f"{arm_name}#{i}{variant}"] for i in range(len(paths))],
                            variant)
            arms[arm_name + variant] = agg
            if "real_photos_vs_reference_masks" in agg:
                m = agg["real_photos_vs_reference_masks"]["iou"]
                log(f"ARM {arm_name}{variant}: photo IoU {m['mean']} +- {m['sd']} "
                    f"(n={agg['n_seeds']})")

    for spec in a.ensembles:
        ens_name, members_s = spec.split("=", 1)
        members = members_s.split("+")
        for variant in variants:
            name = ens_name + variant
            missing = [m for m in members if (m, variant) not in preds]
            if missing:
                log(f"skip ensemble {name}: unknown nets {missing}")
                continue
            ood_pred = np.mean([preds[m, variant][0] for m in members], axis=0)
            ph_pred = (np.mean([preds[m, variant][1] for m in members], axis=0)
                       if crops is not None else None)
            row = make_row(ood_pred, ood_mask, ph_pred, ref_masks,
                           {"ensemble_of": members, "tta": "tta" in variant,
                            "prior": "prior" in variant})
            results[name] = row
            log(f"{name}: ood_iou={row['synthetic_ood_vs_gt']['iou']} "
                f"photo={row.get('real_photos_vs_reference_masks')}")

    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"image_size": a.image_size,
                   "ref_mask_fraction": (round(float((ref_masks > 0.5).mean()), 4)
                                         if crops is not None else None),
                   "nets": results, "arms": arms}, f, indent=1)
    log(f"wrote {a.out}")
    return results


if __name__ == "__main__":
    main()
