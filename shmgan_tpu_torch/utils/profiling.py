"""Profiling and debugging hooks: the counterpart of
shmgan_tpu/utils/profiling.py.

  trace(log_dir)         torch.profiler over the CPU, and CUDA when a card is
                         present, for the enclosed region; writes a Chrome
                         trace, `<log_dir>/trace_<pid>_<n>.json` (open it in
                         Perfetto or chrome://tracing). JAX writes an XPlane
                         protobuf under `plugins/profile/<run>/` instead.
  annotate(name)         a named region on that timeline
                         (torch.profiler.record_function)
  debug_mode(nans=True)  raises FloatingPointError at the first op whose
                         floating output holds a NaN, forward (a
                         TorchFunctionMode) and backward (autograd's anomaly
                         check), as jax_debug_nans raises; `disable_jit` is
                         accepted and does nothing: the port compiles no graph
  device_memory_stats()  device 0's allocator bytes under JAX's keys, {} without
                         a card (as JAX gives for a device without stats)
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Dict, Iterator

import torch
from torch.overrides import TorchFunctionMode

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region and write its Chrome trace under
    `log_dir`; the profile's path is `prof.trace_path` afterwards."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """A named region that shows on the trace's timeline."""
    return torch.profiler.record_function(name)


def _has_nan(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point() and bool(torch.isnan(x).any())


class _RaiseOnNan(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if any(_has_nan(o) for o in outs):
            raise FloatingPointError(f"NaN in the output of {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """Raise FloatingPointError on the first NaN an op makes, in the
    forward and, through autograd's anomaly check, in the backward.
    disable_jit is the JAX signature's: the port runs op by op already.
    Each op's output is read on the host: slow, for debugging only."""
    del disable_jit
    with contextlib.ExitStack() as stack:
        if nans:
            stack.enter_context(torch.autograd.detect_anomaly(check_nan=True))
            stack.enter_context(_RaiseOnNan())
        try:
            yield
        except RuntimeError as e:
            if nans and "nan" in str(e).lower():    # autograd's check in a backward
                raise FloatingPointError(str(e)) from e
            raise


def device_memory_stats() -> Dict[str, int]:
    """Device 0's memory under JAX's keys: bytes_in_use, peak_bytes_in_use,
    num_allocs, bytes_reserved, peak_bytes_reserved,
    bytes_limit (the card's total) and bytes_free (the driver's free bytes);
    {} without a card."""
    if not torch.cuda.is_available():
        return {}
    s = torch.cuda.memory_stats(0)
    free, total = torch.cuda.mem_get_info(0)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "num_allocs": int(s.get("allocation.all.allocated", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(s.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(total), "bytes_free": int(free)}
