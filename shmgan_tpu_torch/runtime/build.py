"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` becomes its own `_build/lib<name>-<hash>.so`, compiled by
`nvcc` for `sm_90a` with a plain C interface and loaded with `ctypes`. No
PyTorch header is included, so a build takes seconds. The hash covers the
source and the flags, so a stale library is never loaded. All missing
libraries are compiled at once, one `nvcc` process for each source.

`load(name)` builds on first use; `build_all()` builds every source up front
and returns, for each, the seconds it took and what `ptxas -v` reported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda/bin or $PATH, in that order."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME, or put the CUDA toolkit's nvcc under "
        "/usr/local/cuda/bin or on PATH. The port's kernels are compiled from "
        f"{CSRC} at first use.")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(names: List[str]) -> Dict[str, Tuple[float, str]]:
    """Run one nvcc per source, all at once; raise if any fails."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def build_all() -> Dict[str, Tuple[float, str]]:
    """Compile every csrc/*.cu whose library is missing.

    Returns {name: (seconds, nvcc output)}; a library that was already built
    reports (0.0, "up to date")."""
    with _lock:
        missing = [n for n in sources() if not library_path(n).exists()]
        report = _compile(missing) if missing else {}
    return {n: report.get(n, (0.0, "up to date")) for n in sources()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _compile([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
    return lib
