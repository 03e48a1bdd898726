"""Metric logging and console progress: the counterpart of
shmgan_tpu/utils/logging.py. One jsonl row per log event and a progress bar
without dependencies. (The JAX writer's optional TensorBoard mirror is left
out: nothing in the loop turns it on.)

`MetricsWriter.write` converts each value with `float()`, which for a CUDA
tensor waits for the device: callers write at a cadence (the train loop: the
first step of each epoch and every 50th), never every step.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        """One row: the step, the wall time and every value `float()` takes
        (others, such as nested dicts, are left out)."""
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()


def progress_bar(iteration: int, total: int, prefix: str = "", length: int = 50,
                 stream=sys.stdout) -> None:
    """A terminal progress bar, redrawn in place; a newline when full."""
    total = max(total, 1)
    frac = min(iteration / total, 1.0)
    filled = int(length * frac)
    bar = "#" * filled + "-" * (length - filled)
    stream.write(f"\r {prefix}|{bar}| {100 * frac:.2f}%")
    if iteration >= total:
        stream.write("\n")
    stream.flush()


class StepTimer:
    """Steps and images a second since the last reset, on the host clock."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._images = 0

    def tick(self, images: int = 1) -> None:
        self._steps += 1
        self._images += images

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self._steps / max(self.elapsed, 1e-9)

    @property
    def images_per_sec(self) -> float:
        return self._images / max(self.elapsed, 1e-9)
