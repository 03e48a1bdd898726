"""Build the port's native sources into shared libraries and load them.

Each `csrc/<name>.cu` and `csrc/<name>.cc` becomes its own
`_build/lib<name>-<hash>.so`, loaded with `ctypes`, each with a plain C
interface and no PyTorch header, so a build takes seconds:

  .cu  the card's kernels, compiled by `nvcc` for `sm_90a`;
  .cc  host code (the batch decoder), compiled by the host C++ compiler,
       `$CXX` or else `g++`, with floating-point contraction off so that it
       repeats its plain numpy version bit for bit, and no `-march=native`.

The hash covers the source and the flags, and for host code the compiler
(its resolved path and `--version`), so a stale library, or one that another
compiler built, is never loaded. All missing libraries are compiled at once, one compiler process for
each source. A failed build raises with the compiler's output.

`load(name)` builds on first use; `build_all()` builds every source up front
and returns, for each, the seconds it took and what the compiler reported
(`ptxas -v` for a kernel).
"""

from __future__ import annotations

import ctypes
import functools
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
# a host call to a __device__ function is an error, not a warning: nvcc's
# default lets it build, and the process dies silently at the launch
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-Werror", "cross-execution-space-call"]
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off"]

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


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else g++, found on $PATH."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found: set CXX or put g++ on "
                           f"PATH. The port's host code is compiled from {CSRC} at first use.")
    return found


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.c[cu]"))


def source_path(name: str) -> Path:
    """csrc/<name>.cu or csrc/<name>.cc."""
    for suffix in (".cu", ".cc"):
        path = CSRC / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no source {name}.cu or {name}.cc under {CSRC}")


def _flags(src: Path) -> List[str]:
    return NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS


@functools.lru_cache(maxsize=None)
def _compiler_identity(compiler: str) -> str:
    """The compiler's path and what `--version` prints."""
    out = subprocess.run([compiler, "--version"], capture_output=True, text=True)
    return f"{compiler}\n{out.stdout}"


def library_path(name: str) -> Path:
    src = source_path(name)
    key = " ".join(_flags(src))
    if src.suffix == ".cc":  # bit-for-bit parity rests on what the compiler does
        key += "\n" + _compiler_identity(find_cxx())
    digest = hashlib.sha256(src.read_bytes() + key.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(names: List[str]) -> Dict[str, Tuple[float, str]]:
    """Run one compiler process per source, all at once; raise if any fails."""
    jobs = []  # every compiler is found before any process starts
    for name in names:
        src, out = source_path(name), library_path(name)
        compiler = find_nvcc() if src.suffix == ".cu" else find_cxx()
        jobs.append((name, src, out, compiler))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, src, out, compiler in jobs:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *_flags(src), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, f"{os.path.basename(compiler)} {src.name}")
    report, failed = {}, []
    for name, (proc, tmp, out, what) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {what} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return report


def build_all() -> Dict[str, Tuple[float, str]]:
    """Compile every csrc/*.cu and csrc/*.cc whose library is missing.

    Returns {name: (seconds, compiler output)}; a library that was already built
    reports (0.0, "up to date")."""
    with _lock:
        missing = [n for n in sources() if not library_path(n).exists()]
        report = _compile(missing) if missing else {}
    return {n: report.get(n, (0.0, "up to date")) for n in sources()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu or .cc, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _compile([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
    return lib
