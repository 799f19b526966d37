"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, inside the call that needs the kernel (never at
import: the CPU tests import every module on a machine without
``nvcc``), and its output lands in the checkout's ``build/`` directory,
named by a hash of the source, the ``csrc/*.cuh`` headers the sources
share and the flags, so an edited source or header never loads a stale
library. Several sources build in parallel through
:func:`build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build_library",
           "load_library", "build_all", "build_seconds"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: the checkout's build directory (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: source name -> seconds its nvcc run took in this process (0.0 = cached)
build_seconds: Dict[str, float] = {}
#: source name -> nvcc's stderr (register / shared-memory report)
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    ``nvcc`` on PATH. Raises when none exists."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists;
    returns the library path. Raises RuntimeError with nvcc's output
    when the build fails."""
    out = _target(name)
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stderr
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and ``ctypes``-load ``csrc/<name>.cu``, once per
    process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name)))
            _libs[name] = lib
        return lib


def build_all() -> Dict[str, float]:
    """Build every ``csrc/*.cu``, one ``nvcc`` per source, all started
    together. Returns the build seconds per source."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        for fut in [ex.submit(build_library, n) for n in names]:
            fut.result()
    return {n: build_seconds.get(n, 0.0) for n in names}
