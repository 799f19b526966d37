"""Shape bucketing and padding (counterpart of ``ops/padding.py``).

The engine pads prompts and chunk windows, and the batch runner pads
batches, to a bounded set of lengths so that the set of shapes it runs
stays small (the JAX package needed this to bound its compile count; the
port keeps the same policy so the two packages run the same shapes and
stay comparable, and so that cuDNN's per-shape algorithm choice and the
allocator's blocks are reused):

* ``bucket_size(n)`` — smallest allowed batch size ≥ n (powers of two by
  default);
* ``pad_batch`` / ``unpad`` — pad rows with zeros + boolean validity mask;
* ``pad_axis`` (host) / ``pad_axis_device`` (a tensor, on its device).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["bucket_size", "default_buckets", "pad_batch", "pad_axis",
           "pad_axis_device", "unpad", "PaddedBatch"]


def default_buckets(max_size: int = 1 << 20) -> List[int]:
    out, b = [], 1
    while b < max_size:
        out.append(b)
        b <<= 1
    out.append(max_size)
    return out


def bucket_size(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest bucket ≥ n. Default: next power of two."""
    if n <= 0:
        return 1
    if buckets is None:
        return 1 << (n - 1).bit_length()
    for b in buckets:
        if b >= n:
            return int(b)
    raise ValueError(f"batch of {n} rows exceeds largest bucket {buckets[-1]}")


class PaddedBatch:
    """A dict of equal-leading-dim arrays padded to a common bucket + mask."""

    def __init__(self, arrays: Dict[str, np.ndarray], mask: np.ndarray,
                 n_valid: int):
        self.arrays = arrays
        self.mask = mask
        self.n_valid = int(n_valid)

    def __getitem__(self, k):
        return self.arrays[k]

    @property
    def padded_size(self) -> int:
        return len(self.mask)


def pad_axis(arr: np.ndarray, size: int, axis: int = 0,
             fill=0) -> np.ndarray:
    cur = arr.shape[axis]
    if cur == size:
        return arr
    if cur > size:
        raise ValueError(f"array dim {cur} exceeds pad target {size}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - cur)
    return np.pad(arr, widths, mode="constant", constant_values=fill)


def pad_axis_device(arr: torch.Tensor, size: int, axis: int = 0,
                    fill=0) -> torch.Tensor:
    """``pad_axis`` for a tensor: pads on the tensor's own device, so a
    device-resident feed reaches its shape bucket *without* a host
    round-trip (the device-feed path of ``BatchRunner``)."""
    cur = arr.shape[axis]
    if cur == size:
        return arr
    if cur > size:
        raise ValueError(f"array dim {cur} exceeds pad target {size}")
    axis = axis % arr.ndim
    # F.pad lists (before, after) pairs from the last dim backwards
    widths = [0, 0] * (arr.ndim - axis)
    widths[-1] = size - cur
    return F.pad(arr, widths, mode="constant", value=fill)


def _coerce_host(v) -> np.ndarray:
    """Host coercion with the same dtype policy as the model feed paths:
    float64 payloads are halved to float32 before they cross the link
    (ints and other dtypes pass through)."""
    arr = np.asarray(v)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def pad_batch(arrays: Dict[str, np.ndarray],
              buckets: Optional[Sequence[int]] = None,
              pad_to: Optional[int] = None) -> PaddedBatch:
    """Pad every array's leading dim to a shared bucket; returns mask."""
    sizes = {k: len(v) for k, v in arrays.items()}
    ns = set(sizes.values())
    if len(ns) > 1:
        raise ValueError(f"inconsistent batch sizes: {sizes}")
    n = ns.pop() if ns else 0
    target = pad_to if pad_to is not None else bucket_size(n, buckets)
    padded = {k: pad_axis(_coerce_host(v), target) for k, v in arrays.items()}
    mask = np.zeros(target, dtype=bool)
    mask[:n] = True
    return PaddedBatch(padded, mask, n)


def unpad(arr: np.ndarray, n_valid: int) -> np.ndarray:
    return np.asarray(arr)[:n_valid]
