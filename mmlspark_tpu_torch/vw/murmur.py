"""MurmurHash3 (x86 32-bit) for VW-style feature hashing (the port's copy
of ``mmlspark_tpu/vw/murmur.py``).

Role of ``VowpalWabbitMurmurWithPrefix`` in the reference
(``vw/.../VowpalWabbitMurmurWithPrefix.scala``): hash feature names into a
2^num_bits index space, with the column/namespace name folded in as a seed or
prefix so identical feature names in different namespaces don't collide.

:func:`murmur3_32` runs the port's native loop (``native/fastpath.cpp``),
which raises when it cannot be built: unlike the JAX package there is no
silent fallback. :func:`_murmur3_32_py` is the plain version, kept for the
tests.
"""

from __future__ import annotations

import numpy as np

__all__ = ["murmur3_32", "namespace_seed", "hash_feature", "combine_hashes",
           "FNV_PRIME"]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF

#: FNV-1a prime, used (as VW does) to combine hashes for feature interactions.
FNV_PRIME = 0x01000193


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 of ``data`` with ``seed``; returns uint32, from
    the native loop (built at first use; a failed build raises)."""
    from .. import native
    return native.murmur3(data, seed & _M32)


def _murmur3_32_py(data: bytes, seed: int = 0) -> int:
    h = seed & _M32
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k = (k * _C1) & _M32
        k = _rotl(k, 15)
        k = (k * _C2) & _M32
        h ^= k
        h = _rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & _M32
    # tail
    k = 0
    tail = data[nblocks * 4:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _M32
        k = _rotl(k, 15)
        k = (k * _C2) & _M32
        h ^= k
    # finalization
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def namespace_seed(namespace: str, seed: int = 0) -> int:
    """Hash of the namespace (column) name — the per-namespace seed, as VW
    seeds feature hashes with the namespace hash."""
    return murmur3_32(namespace.encode("utf-8"), seed)


def hash_feature(name: str, ns_seed: int, mask: int) -> int:
    """Hash a feature name inside a namespace into [0, mask]."""
    return murmur3_32(name.encode("utf-8"), ns_seed) & mask


def combine_hashes(h1: np.ndarray, h2: np.ndarray, mask: int) -> np.ndarray:
    """FNV-style interaction combine (VW's quadratic feature hash):
    ``(h1 * FNV_PRIME) XOR h2``, masked into the weight space. Works on
    scalars or numpy arrays."""
    a = (np.asarray(h1, dtype=np.uint64) * np.uint64(FNV_PRIME)) & np.uint64(_M32)
    out = (a ^ np.asarray(h2, dtype=np.uint64)) & np.uint64(mask)
    return out.astype(np.uint32)
