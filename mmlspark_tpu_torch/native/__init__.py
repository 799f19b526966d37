"""Native host loops of the port (counterpart of ``mmlspark_tpu/native/``).

``fastpath.cpp`` (the port's own copy of the JAX package's binning loop,
with a plain C entry point) is compiled with ``g++ -O3`` at first use into
the checkout's ``build/native/`` directory, named by a hash of the source
and the flags, published atomically (built under a temporary name, then
renamed) and loaded with ``ctypes``. There is no fallback: a failed build
raises, and :func:`available` says whether the build succeeds. The numpy
loop that computes the same bins is ``models/gbdt/binning.py``'s
``bin_columns_plain``.

API:
    available() -> bool
    bin_columns(X, bounds, lengths, want_u16) -> np.uint8/uint16[n, F]
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "bin_columns", "build", "SOURCE", "BUILD_DIR"]

#: the port's own copy of the loop (never the JAX package's file)
SOURCE = Path(__file__).resolve().with_name("fastpath.cpp")
#: the checkout's build directory (listed in .gitignore through ``build/``)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libfastpath-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``fastpath.cpp`` unless its hashed library exists; returns
    the library's path. Raises RuntimeError with g++'s output when the
    build fails."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.mmlspark_bin_columns.argtypes = [vp, i, vp, vp, vp, i, i64,
                                                 i64, i64]
            lib.mmlspark_bin_columns.restype = i
            _lib = lib
        return _lib


def available() -> bool:
    """True when the native library builds (or is built) and loads."""
    try:
        _library()
    except (RuntimeError, OSError):
        return False
    return True


def bin_columns(X: np.ndarray, bounds: np.ndarray, lengths: np.ndarray,
                want_u16: bool) -> np.ndarray:
    """Quantile-bin a float32/float64 matrix in the native loop:
    ``searchsorted(bounds_j[:lengths_j], x, "left") + 1`` per element,
    NaN -> bin 0. ``bounds`` is the (F, L) padded table, ``lengths`` the
    per-feature bound counts, each in [1, L]. Builds the library at
    first use; raises when it cannot be built."""
    X = np.ascontiguousarray(X)
    if X.ndim != 2 or X.dtype not in (np.float32, np.float64):
        raise TypeError(f"bin_columns expects a 2-D float32/float64 matrix, "
                        f"got {X.dtype} with shape {X.shape}")
    n, F = X.shape
    bounds = np.ascontiguousarray(bounds, dtype=np.float64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    if bounds.ndim != 2 or bounds.shape[0] != F or lengths.shape != (F,):
        raise ValueError(f"bounds {bounds.shape} must be (F, L) and lengths "
                         f"{lengths.shape} (F,) for F = {F}")
    out = np.empty((n, F), dtype=np.uint16 if want_u16 else np.uint8)
    err = _library().mmlspark_bin_columns(
        X.ctypes.data, int(X.dtype == np.float64), bounds.ctypes.data,
        lengths.ctypes.data, out.ctypes.data, int(bool(want_u16)), n, F,
        bounds.shape[1])
    if err:
        raise ValueError(f"lengths must lie in [1, {bounds.shape[1]}]")
    return out
