"""Shows that chip_smoke.py's checks fail a wrong instance-norm path.

    python3 shmgan_tpu_torch/plant_faults.py                # bf16 checks
    python3 shmgan_tpu_torch/plant_faults.py --train-loop   # f32 train_loop

In one process on the card it builds the kernels, then plants each fault in
turn by patching the wrapper in memory (no file changes) and runs chip_smoke
checks with it in place. By default the faults touch bf16 activations only,
and the checks are three of chip_smoke's bf16 ones (after its f32 serve
phase, whose outputs the bf16 gate compares against): autograd through the
kernels against autograd through the plain version at the train step's 15 IN
shapes, the serve_bf16 phase and the train_bf16 phase. With --train-loop the
faults touch f32 activations only, and the check is chip_smoke's train_loop
phase (the loop through the kernels against the plain loop). The faults:
  none                  the code as it is: every check must pass;
  dx x 1.01             the backward's dx scaled by 1.01 in `_InstanceNormFn`;
  dgamma, dbeta zeroed  the backward's parameter gradients dropped;
  y x 1.01              the forward kernel's output scaled by 1.01.
Prints one RESULT line per fault and check, then one JSON line
{fault: {check: "passed" | "failed"}}. Exits non-zero if the unfaulted code
fails a check or a planted fault passes every check. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BF16 = torch.bfloat16


def _faults(ink, dtype):
    """The faults, each touching activations of `dtype` only."""
    fwd, bwd = ink._forward, ink._InstanceNormFn.backward

    def dx_scaled(ctx, g):
        dx, dgamma, dbeta, eps = bwd(ctx, g)
        return (dx.float() * 1.01).to(dx.dtype) if dx.dtype == dtype else dx, dgamma, dbeta, eps

    def params_zeroed(ctx, g):
        dx, dgamma, dbeta, eps = bwd(ctx, g)
        if dx.dtype == dtype:
            dgamma, dbeta = torch.zeros_like(dgamma), torch.zeros_like(dbeta)
        return dx, dgamma, dbeta, eps

    def y_scaled(x, gamma, beta, eps, with_stats):
        y, mean, rstd = fwd(x, gamma, beta, eps, with_stats)
        return (y.float() * 1.01).to(y.dtype) if y.dtype == dtype else y, mean, rstd

    def restore():
        ink._forward, ink._InstanceNormFn.backward = fwd, staticmethod(bwd)

    def patch(name, fn):
        restore()
        if name == "_forward":
            ink._forward = fn
        elif fn is not None:
            ink._InstanceNormFn.backward = staticmethod(fn)

    return {"none": (None, None), "dx x 1.01": ("backward", dx_scaled),
            "dgamma, dbeta zeroed": ("backward", params_zeroed),
            "y x 1.01": ("_forward", y_scaled)}, patch, restore


def autograd_checks(cs, ink):
    """chip_smoke's autograd check at the 15 IN shapes of the train step, bf16."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    tols = (cs.IN_TOL_BF16, cs.IN_TOL_BF16, cs.IN_PARAM_TOL_BF16, cs.IN_PARAM_TOL_BF16)
    for shape, _ in cs.TRAIN_IN_SHAPES:
        c = shape[1]
        x = F.leaky_relu(torch.randn(shape, device=dev, generator=g) + 0.5, 0.2).to(BF16)
        gamma = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
        beta = 0.02 * torch.randn(c, device=dev, generator=g)
        dy = torch.randn(shape, device=dev, generator=g).to(BF16)
        cs._autograd_check(ink, ink.kernel_name("backward", BF16), shape, x, gamma, beta, dy,
                           tols)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train-loop", action="store_true",
                    help="f32 faults against chip_smoke's train_loop phase")
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from shmgan_tpu_torch.ops.kernels import instance_norm as ink

    cs.device_phase()
    cs.build_phase()
    if args.train_loop:
        faults, patch, restore = _faults(ink, torch.float32)
        checks = {"train_loop": cs.train_loop_phase}
    else:
        _, f32_outputs = cs.serve_phase()
        faults, patch, restore = _faults(ink, BF16)
        checks = {"autograd": lambda: autograd_checks(cs, ink),
                  "serve_bf16": lambda: cs.serve_phase("bfloat16", f32_outputs),
                  "train_bf16": cs.train_bf16_phase}
    results = {}
    try:
        for name, (where, fn) in faults.items():
            patch(where, fn)
            results[name] = {}
            for check, run in checks.items():
                cs.say(f"=== fault '{name}': {check}")
                try:
                    run()
                    results[name][check] = "passed"
                except AssertionError as e:
                    results[name][check] = "failed"
                    cs.say(f"  {str(e)[:300]}")
                cs.say(f"RESULT fault '{name}': {check} {results[name][check]}")
    finally:
        restore()
    cs.say(json.dumps(results))
    clean = all(r == "passed" for r in results["none"].values())
    caught = all("failed" in results[name].values() for name in faults if name != "none")
    return 0 if clean and caught else 1


if __name__ == "__main__":
    sys.exit(main())
