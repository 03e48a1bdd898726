"""Segments of a training chunk sized to a wall-clock budget: the port's copy
of shmgan_tpu/train/segmenter.py, with its behaviour.

On the card a "program" is the run of steps queued between two host
synchronisations (a value fetch). Python queues the steps' kernels ahead of
the device, so the host learns how far the device has got only at a
synchronisation, and nothing kills a long run of steps. What the budget
bounds is the time between two such points: `run_segments` ends each
segment with a synchronisation and then asks its caller whether to stop, so
a deadline read there is read at most one segment late.
`quality_train.py`'s phase B splits each chunk this way under
`--max_segment` (a fixed length, or `auto` for this class) and reads its
deadline at every segment end; segmenting never changes the steps it runs.

Sizing rules, as in the JAX package:

* Lengths come from a fixed ladder (DEFAULT_LADDER). `plan` cuts a chunk
  greedily into rungs no longer than the current length, with at most one
  tail shorter than the smallest rung.
* The first run at each length is discarded: it pays the first use of that
  length (a compile in JAX; on the card, allocations and cuDNN's choice of
  algorithms at the first steps) inside its wall time.
* The per-step estimate is the minimum seconds a step seen so far, which
  comes down to the steady rate from above.
* Growth is one rung an observation, and only when the predicted time fits
  the budget; shrinking is immediate. A run longer than `hard_cap_s` pins a
  ceiling below its length for good.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

DEFAULT_LADDER: Tuple[int, ...] = (5, 10, 25, 50, 100, 200, 400)


def run_segments(segments: Sequence[Tuple[int, int]], program: Callable, sync: Callable,
                 observe: Optional[Callable[[int, float], None]] = None,
                 stop: Optional[Callable[[], bool]] = None,
                 clock: Callable[[], float] = time.perf_counter):
    """Run each (step0, length) of `segments` through `program(step0, length)`,
    then `sync(result)` (a value fetch) and `observe(length, seconds)`. Before
    each segment after the first, `stop()` is asked, and a true answer ends
    the run there. -> (the last segment's result, the steps run)."""
    result, ran = None, 0
    for i, (s0, kk) in enumerate(segments):
        if i and stop is not None and stop():
            break
        t0 = clock()
        result = program(s0, kk)
        sync(result)
        ran += kk
        if observe is not None:
            observe(kk, clock() - t0)
    return result, ran


def segment_plan(start: int, k: int, seg: int) -> List[Tuple[int, int]]:
    """Split the chunk [start, start + k) into runs of at most `seg` steps:
    [(step0, length), ...], contiguous. seg <= 0 leaves it whole."""
    if seg <= 0 or k <= seg:
        return [(start, k)]
    return [(s0, min(seg, start + k - s0)) for s0 in range(start, start + k, seg)]


class AdaptiveSegmenter:
    """Sizes runs of steps to a wall-clock budget from their measured time.

        seg = AdaptiveSegmenter(budget_s=25.0, init_steps=50)
        for s0, kk in seg.plan(done, chunk):
            t0 = time.perf_counter()
            ... run steps s0 .. s0 + kk - 1, then fetch a value (a synchronisation)
            seg.observe(kk, time.perf_counter() - t0)
    """

    def __init__(self, budget_s: float = 25.0, hard_cap_s: float = 40.0,
                 init_steps: int = 50, ladder: Sequence[int] = DEFAULT_LADDER,
                 clock: Callable[[], float] = time.perf_counter):
        if budget_s <= 0 or hard_cap_s < budget_s:
            raise ValueError("need 0 < budget_s <= hard_cap_s")
        self.budget_s = float(budget_s)
        self.hard_cap_s = float(hard_cap_s)
        self.ladder = tuple(sorted(set(int(x) for x in ladder)))
        if not self.ladder or self.ladder[0] < 1:
            raise ValueError("ladder must contain positive ints")
        self._clock = clock
        self._per_step: Optional[float] = None  # the least seconds a step seen
        self._ceiling: Optional[int] = None     # pinned below a run that went hot
        self._seen: set = set()                 # lengths that have run once
        self._current = self._snap_down(max(1, int(init_steps)))
        self.observations = 0

    def _snap_down(self, n: int) -> int:
        """The largest rung <= n (the smallest rung if n is below them all)."""
        best = self.ladder[0]
        for rung in self.ladder:
            if rung <= n:
                best = rung
        return best

    @property
    def current(self) -> int:
        return self._current

    @property
    def per_step_s(self) -> Optional[float]:
        return self._per_step

    def plan(self, start: int, k: int) -> List[Tuple[int, int]]:
        """Contiguous (step0, length) runs for [start, start + k): rungs no
        longer than `current`, and at most one last run shorter than the
        smallest rung."""
        out: List[Tuple[int, int]] = []
        pos, end = start, start + k
        while pos < end:
            remaining = end - pos
            if remaining < self.ladder[0]:
                out.append((pos, remaining))
                break
            out.append((pos, self._snap_down(min(self._current, remaining))))
            pos += out[-1][1]
        return out

    def observe(self, length: int, wall_s: float) -> None:
        """Record one synchronised run of `length` steps that took `wall_s`."""
        if length <= 0 or wall_s <= 0:
            return
        self.observations += 1
        if length not in self._seen:  # its first run pays the length's first use
            self._seen.add(length)
            return
        rate = wall_s / length
        if self._per_step is None or rate < self._per_step:
            self._per_step = rate
        if wall_s > self.hard_cap_s:  # never this length, or a longer one, again
            below = [r for r in self.ladder if r < length]
            pinned = below[-1] if below else self.ladder[0]
            self._ceiling = pinned if self._ceiling is None else min(self._ceiling, pinned)
        fit = self.ladder[0]  # the largest rung whose predicted time fits the budget
        for rung in self.ladder:
            if rung * self._per_step <= self.budget_s:
                fit = rung
        if self._ceiling is not None:
            fit = min(fit, self._ceiling)
        if fit > self._current:  # grow one rung at a time; shrink at once
            idx = self.ladder.index(self._current)
            fit = min(fit, self.ladder[min(idx + 1, len(self.ladder) - 1)])
        self._current = fit

    def run(self, start: int, k: int, program, sync):
        """Run [start, start + k) through `program(step0, length)`, calling
        `sync(result)` (a value fetch) after each run and timing it. Returns
        the last run's result: the newest step's metrics, as unsegmented."""
        return run_segments(self.plan(start, k), program, sync, self.observe,
                            clock=self._clock)[0]

    def summary(self) -> str:
        est = (f"{self._per_step * 1e3:.1f} ms/step" if self._per_step is not None
               else "unmeasured")
        cap = f", ceiling {self._ceiling}" if self._ceiling is not None else ""
        return f"segment={self._current} ({est}, budget {self.budget_s:.0f}s{cap})"
