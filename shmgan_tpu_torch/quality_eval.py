"""The final quality evaluation of a trained checkpoint against the identity
baseline: the counterpart of examples/quality_eval.py.

Restores a train checkpoint of the port (checkpoint.CheckpointManager: the
runs of quality_train.py or `cli --mode train`; a JAX Orbax directory raises
with the command of orbax_to_torch.py, which converts it) and evaluates, on
a held-out set that training never saw (data/synthetic.synth_eval_set at
--seed):

  gen_rgb_calibrated   the reconstruction in the input's [0, 1] RGB domain
  gen_rgb_composited   the input outside the dilated mask, the
                       reconstruction inside it
  identity baseline    the input itself

each against the diffuse truth: PSNR, SSIM (max_val 1), the SpecSeg-feature
FID, and evaluate_pair's table (SSIM of rescaled images at max_val 5, the
deltaE76/94 colour differences, MSE, PSNR). Writes <out>/quality_<tag>.json
with the JAX script's keys, and <tag>_grid_<i>.png for the first 4 images
(input, mask, calibrated, composited, diffuse truth; no title text). The
models compute in float32.

    python -m shmgan_tpu_torch.quality_eval --ckpt_dir runs/gan/ckpt \\
        --image_size 256 --upsample_mode resize_conv --specseg_in_channels 2 \\
        --use_ema --out runs/eval             # the card
    ... --cpu                                 # the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict

import torch

from shmgan_tpu_torch.checkpoint import CheckpointManager
from shmgan_tpu_torch.config import Config, torch_device
from shmgan_tpu_torch.data.synthetic import synth_eval_set
from shmgan_tpu_torch.eval.quality import Evaluator, device_name, log, mark_beats_identity
from shmgan_tpu_torch.models import build_models
from shmgan_tpu_torch.train.state import create_train_state
from shmgan_tpu_torch.utils.viz import image_grid


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--out", type=str, default="benchmarks/quality_r2")
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--filter_size", type=int, default=64)
    p.add_argument("--specseg_base_filters", type=int, default=16)
    p.add_argument("--upsample_mode", choices=["conv_transpose", "resize_conv"],
                   default="conv_transpose",
                   help="must match the mode the checkpoint was trained with (both modes "
                        "share one parameter tree, so a mismatch restores and then runs "
                        "the wrong op)")
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the EMA generator a --g_ema run saved (the raw "
                        "parameters when the checkpoint has none)")
    p.add_argument("--mask_tta", action="store_true",
                   help="dihedral mask TTA in the inference graph")
    p.add_argument("--eval_n", type=int, default=128)
    p.add_argument("--specseg_in_channels", type=int, default=1, choices=[1, 2],
                   help="2 when the checkpoint's SpecSeg is chroma-input "
                        "(ops/specprior.py): the restore template must match")
    p.add_argument("--seed", type=int, default=999,
                   help="held-out scene seed (never used in training)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--tag", type=str, default="final")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    a = parse_args(argv)
    device = torch_device("cpu" if a.cpu else "cuda")
    cfg = Config()
    cfg.model = dataclasses.replace(
        cfg.model, image_size=a.image_size, filter_size=a.filter_size,
        specseg_base_filters=a.specseg_base_filters, compute_dtype="float32",
        specseg_in_channels=a.specseg_in_channels, upsample_mode=a.upsample_mode)
    if a.use_ema:
        # the template's EMA slot makes restore read the checkpoint's (or
        # start it from G when the checkpoint has none)
        cfg.train = dataclasses.replace(cfg.train, g_ema=0.999)
    if a.mask_tta:
        cfg.eval = dataclasses.replace(cfg.eval, mask_tta=True)
    log(f"device: {device_name(device)}")

    state = create_train_state(cfg, build_models(cfg, device=device))
    restored = CheckpointManager(a.ckpt_dir).restore(state, step=a.step)
    if restored is None:
        raise SystemExit(f"no checkpoint under {a.ckpt_dir}")
    state = restored
    if a.use_ema and state.ema_g is not None:
        with torch.no_grad():
            for name, p in state.gen.named_parameters():
                p.copy_(state.ema_g[name])
    log(f"restored checkpoint step {state.step}" + (" (EMA generator)" if a.use_ema else ""))

    ins, gts, _ = synth_eval_set(a.eval_n, a.image_size, seed=a.seed)
    ev = Evaluator(cfg, state.gen, state.specseg, a.batch, device)
    out = ev.infer(ins)
    gt_feats = ev.features(gts)
    result = {
        "checkpoint_step": int(state.step),
        "eval_n": a.eval_n,
        "heldout_seed": a.seed,
        "identity_baseline": ev.metrics(ins, gts, gt_feats, "identity (input)"),
        "gen_calibrated": ev.metrics(out["gen_rgb_calibrated"], gts, gt_feats, "calibrated"),
        "gen_composited": ev.metrics(out["gen_rgb_composited"], gts, gt_feats, "composited"),
    }
    mark_beats_identity(result)

    os.makedirs(a.out, exist_ok=True)
    path = os.path.join(a.out, f"quality_{a.tag}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    log(f"wrote {path}")
    for i in range(min(4, a.eval_n)):
        image_grid([ins[i], out["mask"][i][..., 0], out["gen_rgb_calibrated"][i],
                    out["gen_rgb_composited"][i], gts[i]],
                   titles=["input", "mask", "calibrated", "composited", "diffuse GT"],
                   path=os.path.join(a.out, f"{a.tag}_grid_{i}.png"))
    log("galleries written")
    return result


if __name__ == "__main__":
    main()
