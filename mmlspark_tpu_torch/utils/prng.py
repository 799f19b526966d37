"""Counter-based threefry draws, bit for bit ``jax.random``'s.

The JAX package draws its per-node randomness (``extra_trees``'
candidate bins, ``feature_fraction_bynode``'s feature subsets) and its
LoRA adapters' starting values from ``jax.random`` with the default
``threefry2x32`` implementation, with ``jax_threefry_partitionable`` on.
This module is the port's copy of the four rules it uses, so both
packages grow the same trees and start from the same adapters:

* ``PRNGKey(seed)`` is the pair ``(0, seed mod 2^32)`` (64-bit seeds are
  truncated, as JAX does with x64 off);
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``;
* ``uniform(key, shape)`` hashes each element's flat index as (hi, lo)
  32-bit counters, XORs the two output words, and keeps the top 23 bits
  as the mantissa of a float32 in [1, 2), minus 1.

``normal`` follows ``jax.random.normal``'s formula, ``sqrt(2) *
erfinv(u)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)``; torch's
``erfinv`` is not XLA's, so normals agree to a few ulps, not bitwise.

Keys are int64 tensors of shape ``(..., 2)`` holding the two uint32
words; a batch of keys draws a batch of arrays. The arithmetic runs on
int64 masked to 32 bits (PyTorch's uint32 has too few ops), on the keys'
device: the card draws the same bits as the CPU.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

__all__ = ["PRNGKey", "fold_in", "split", "uniform", "normal",
           "threefry2x32", "random_bits"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under ``key`` (..., 2): int64 tensors of uint32 values, broadcast
    against the key's batch shape. Returns the two output words."""
    k1, k2 = key[..., 0], key[..., 1]
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + k1) & _M32, (x2 + k2) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the (2,) key ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def _pair(key: torch.Tensor, lo) -> torch.Tensor:
    """threefry2x32(key, (0, lo)) stacked as a key (..., 2)."""
    lo = torch.as_tensor(lo, dtype=torch.int64, device=key.device)
    zero = torch.zeros_like(lo)
    b1, b2 = threefry2x32(key, zero, lo & _M32)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` (..., 2) and an
    integer; ``data`` may also be an int64 tensor of integers, broadcast
    against the key's batch shape (one fold a element, in one hash)."""
    if isinstance(data, torch.Tensor):
        return _pair(key, data)
    return _pair(key, int(data) & _M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one key (2,) into (num, 2) keys."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return _pair(key[None, :], idx)


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)): each element's
    flat index hashed as the (hi, lo) counter pair, the two output words
    XORed. A key batch (..., 2) gives (..., *shape)."""
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    batch = key.shape[:-1]
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    kb = key.reshape(batch + (1, 2)) if batch else key
    b1, b2 = threefry2x32(kb, idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(batch + shape)


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits of each draw as
    the mantissa of a float in [1, 2), minus 1, then scaled to [minval,
    maxval) as JAX scales it (in float32, floored at minval)."""
    bits = random_bits(key, shape)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    if minval == 0.0 and maxval == 1.0:
        return f
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with u
    uniform in [nextafter(-1, 0), 1)."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, lo, 1.0)
    return torch.erfinv(u) * torch.tensor(2.0 ** 0.5, dtype=torch.float32)
