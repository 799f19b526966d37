"""Shape bucketing (counterpart of ``ops/padding.py:25-44``).

The engine pads prompts and chunk windows to a bounded set of lengths so
that the set of shapes it runs stays small (the JAX package needed this
to bound its compile count; the port keeps the same policy so the two
engines run the same windows and stay token-comparable).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["bucket_size", "default_buckets"]


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
