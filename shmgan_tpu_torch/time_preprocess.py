"""Times the preprocess kernel of one checkout on the card, to compare commits.

    python3 shmgan_tpu_torch/time_preprocess.py [--tree DIR]

Imports `shmgan_tpu_torch` from DIR (default: the checkout this file is in),
so the same timings can run against an older commit unpacked elsewhere; run
each checkout in its own process, in turns (old, new, new, old), in one
session on one card. At (8, 256, 256, 3) and (1, 256, 256, 3) it times that
checkout's `fused_standardize_yuv` with `chip_smoke.py`'s timers (from the
checkout this file is in): `ms` back to back with the wrapper's host cost,
`device_ms` from CUDA-graph replays, `device_cold_ms` after an L2 flush.
Prints one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SHAPES = [(8, 256, 256, 3), (1, 256, 256, 3)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE), help="checkout whose package is timed")
    tree = Path(ap.parse_args().tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    timers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timers)

    import torch
    from shmgan_tpu_torch.ops.kernels import preprocess as pre

    if not torch.cuda.is_available():
        raise SystemExit("time_preprocess needs a CUDA card")
    if not Path(pre.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {pre.__file__}, not the package under {tree}")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in SHAPES:
        x = torch.rand(shape, device="cuda", generator=g)
        call = lambda: pre.fused_standardize_yuv(x)  # noqa: E731
        rows.append(dict(shape=list(shape), ms=timers.time_ms(call, 200),
                         device_ms=timers.device_ms(call),
                         device_cold_ms=timers.device_cold_ms(call)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(json.dumps({"tree": str(tree), "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "rows": rows}))


if __name__ == "__main__":
    main()
