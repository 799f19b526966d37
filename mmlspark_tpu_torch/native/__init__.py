"""Native host loops of the port (counterpart of ``mmlspark_tpu/native/``).

``fastpath.cpp`` (the port's own copy of the JAX package's binning,
murmur3 and sparse-padding loops, with plain C entry points) is compiled
with ``g++ -O3`` at first use into the checkout's ``build/native/``
directory, named by a hash of the source and the flags, published
atomically (built under a temporary name, then renamed) and loaded with
``ctypes``. There is no fallback: a failed build raises, and
:func:`available` says whether the build succeeds. The plain loops that
compute the same outputs are ``models/gbdt/binning.py``'s
``bin_columns_plain``, ``vw/murmur.py``'s ``_murmur3_32_py`` and
``vw/learners.py``'s ``pad_sparse_plain``.

API:
    available() -> bool
    bin_columns(X, bounds, lengths, want_u16) -> np.uint8/uint16[n, F]
    murmur3(data: bytes, seed) -> int
    murmur3_batch(seq_of_bytes, seed, mask) -> np.uint32[n]
    pad_sparse(rows, K) -> (np.int32[n, K], np.float32[n, K])
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "bin_columns", "build", "murmur3", "murmur3_batch",
           "pad_sparse", "SOURCE", "BUILD_DIR"]

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
            lib.mmlspark_murmur3.argtypes = [ctypes.c_char_p, i64,
                                             ctypes.c_uint32]
            lib.mmlspark_murmur3.restype = ctypes.c_uint32
            lib.mmlspark_murmur3_batch.argtypes = [vp, vp, i64,
                                                   ctypes.c_uint32,
                                                   ctypes.c_uint32, vp]
            lib.mmlspark_murmur3_batch.restype = None
            lib.mmlspark_pad_sparse.argtypes = [vp, vp, vp, vp, i64, i64, vp,
                                                vp]
            lib.mmlspark_pad_sparse.restype = None
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


def murmur3(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 of ``data`` with ``seed`` (uint32)."""
    data = bytes(data)
    return int(_library().mmlspark_murmur3(data, len(data),
                                           int(seed) & 0xFFFFFFFF))


def _offsets(lengths, n: int) -> np.ndarray:
    off = np.zeros(n + 1, dtype=np.int64)
    if n:
        np.cumsum(np.fromiter(lengths, dtype=np.int64, count=n), out=off[1:])
    return off


def murmur3_batch(items, seed: int, mask: int) -> np.ndarray:
    """``murmur3(item, seed) & mask`` of every byte string in ``items``,
    in one native call over the items joined with their offsets."""
    items = list(items)
    n = len(items)
    flat = b"".join(items)
    off = _offsets(map(len, items), n)
    out = np.empty(n, dtype=np.uint32)
    _library().mmlspark_murmur3_batch(
        ctypes.c_char_p(flat), off.ctypes.data, n, int(seed) & 0xFFFFFFFF,
        int(mask) & 0xFFFFFFFF, out.ctypes.data)
    return out


def pad_sparse(rows, K: int):
    """(indices, values) rows -> (idx [n, K] int32, val [n, K] float32):
    each row's first min(len, K) features, padding slots index 0 with
    value 0. The rows are flattened into int64 indices and float32 values
    with their offsets, and padded in one native call."""
    rows = list(rows)
    n, K = len(rows), int(K)
    idx_parts = [np.asarray(r[0]).ravel() for r in rows]
    val_parts = [np.asarray(r[1]).ravel() for r in rows]
    ioff = _offsets((p.size for p in idx_parts), n)
    voff = _offsets((p.size for p in val_parts), n)
    flat_i = (np.concatenate(idx_parts).astype(np.int64) if n
              else np.zeros(0, np.int64))
    flat_v = (np.concatenate(val_parts).astype(np.float32) if n
              else np.zeros(0, np.float32))
    flat_i = np.ascontiguousarray(flat_i)
    flat_v = np.ascontiguousarray(flat_v)
    idx = np.zeros((n, K), dtype=np.int32)
    val = np.zeros((n, K), dtype=np.float32)
    _library().mmlspark_pad_sparse(
        flat_i.ctypes.data, ioff.ctypes.data, flat_v.ctypes.data,
        voff.ctypes.data, n, K, idx.ctypes.data, val.ctypes.data)
    return idx, val
