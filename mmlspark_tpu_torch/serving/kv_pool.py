"""Paged KV pool — page-granular cache management for serving
(counterpart of ``serving/kv_pool.py:98-563``).

* **pages** — the physical cache is ``(num_pages, H, page_size, hd)`` per
  layer (``models/zoo/transformer.init_paged_cache``); requests are sized
  in pages for the tokens they can actually produce. With ``kv_dtype``
  ("int8"/"fp8") pages hold quantized codes and each layer carries
  ``(num_pages, H, page_size)`` bf16 ``k_scale``/``v_scale`` pools that
  move with their pages (CoW copy, ``compact()``, ``reset()``);
* **block tables** — each slot owns a row of physical page ids; attention
  reads through it;
* **copy-on-write prefix sharing** — whole pages of a cached prompt prefix
  are shared across requests by bumping a refcount; only the boundary
  page is copied, and shared pages are never written;
* **defrag on retire** — frees go back to a min-heap (lowest index first);
  :meth:`compact` returns a permutation the engine applies with one
  gather.

Physical page 0 is the **trash page**: never allocated, the redirect
target for inactive-row writes and for block-table entries past a row's
allocation. The pool is host bookkeeping plus a handle to the device
buffers; the caller serializes access.

**Tensor parallelism** (``tp > 1``, the JAX ``sharding=`` argument): a
rank's pool holds its ``heads / tp`` heads of every page, ``(num_pages,
heads / tp, page_size, hd)``. The page dimension stays a shared arena:
every rank runs the same allocations, so alloc/free, block tables, CoW
and ``compact()`` are the same host bookkeeping on every rank.
``device_bytes`` and ``bytes_per_position`` report this shard;
``device_bytes_global`` and ``bytes_per_position_global`` all ``tp``
shards together.
"""

from __future__ import annotations

import hashlib
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kv_quant import (SCALE_DTYPE, kv_bytes_per_position,
                            kv_store_dtype, resolve_kv_dtype)
from ..utils.device import resolve_device

__all__ = ["PagedKVPool", "PoolExhausted", "prefix_hash"]


def prefix_hash(tokens: Sequence[int]) -> str:
    """Stable content hash for a prompt prefix (the prefix-registry key) —
    the same bytes the reference hashes, so both give the same key."""
    h = hashlib.sha1()
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.hexdigest()


class PoolExhausted(RuntimeError):
    """No free pages left — the engine requeues or evicts prefixes."""


class PagedKVPool:
    """Page allocator + device buffer handle for one model's KV cache.

    ``buffers`` is the per-layer list of ``{"k","v"}`` page tensors (plus
    ``{"k_scale","v_scale"}`` when quantized), zeroed at construction and
    updated in place by the engine's steps (``compact`` and ``reset``
    rebind them). Everything else is host bookkeeping: a free min-heap
    over pages ``[1, num_pages)``, per-page refcounts, and the
    shared-prefix registry."""

    def __init__(self, cfg, *, num_pages: int, page_size: int,
                 kv_dtype: Optional[str] = None, device=None, tp: int = 1):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if tp < 1 or cfg.heads % tp:
            raise ValueError(f"heads {cfg.heads} not divisible by tp={tp}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        #: head shards the pool's heads are split into (1 = all heads)
        self.tp = int(tp)
        #: heads this pool holds: its shard of cfg.heads
        self.heads = cfg.heads // self.tp
        hd = cfg.d_model // cfg.heads
        self._shape = (self.num_pages, self.heads, self.page_size, hd)
        self._scale_shape = self._shape[:3]
        #: canonical quantized-page dtype name ("int8"/"fp8") or None
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        store = kv_store_dtype(self.kv_dtype)
        #: the dtype K/V values are stored in
        self.value_dtype = cfg.dtype if store is None else store
        self.scale_dtype = None if store is None else SCALE_DTYPE
        self.buffers = self._make_buffers()
        self._free: List[int] = list(range(1, self.num_pages))
        heapq.heapify(self._free)
        self._refs = np.zeros(self.num_pages, np.int32)
        # phash -> (pages tuple, prefix length in tokens)
        self._prefixes: Dict[str, Tuple[Tuple[int, ...], int]] = {}
        # phash -> registration count: token-identical prefixes under two
        # engine keys share one entry, which lives until both release it
        self._prefix_regs: Dict[str, int] = {}
        self.high_water = 0
        self.stats = {"prefix_share_hits": 0, "defrag_moves": 0,
                      "prefill_chunks": 0, "alloc_failures": 0,
                      "gather_bytes": 0, "attn_ticks_kernel": 0,
                      "attn_ticks_gather": 0, "quant_error_probes": 0,
                      "quant_error_last": None, "quant_error_sum": 0.0,
                      "quant_error_max": 0.0}

    def _make_buffers(self):
        """Fresh zeroed per-layer buffers: ``{"k","v"}`` in the value dtype,
        plus ``{"k_scale","v_scale"}`` when quantized."""
        layers = []
        for _ in range(self.cfg.layers):
            c = {kk: torch.zeros(self._shape, dtype=self.value_dtype,
                                 device=self.device) for kk in ("k", "v")}
            if self.scale_dtype is not None:
                for kk in ("k_scale", "v_scale"):
                    c[kk] = torch.zeros(self._scale_shape,
                                        dtype=self.scale_dtype,
                                        device=self.device)
            layers.append(c)
        return layers

    def device_bytes(self) -> int:
        """Exact device bytes of this shard's buffers: K+V values in the
        (possibly quantized) value dtype plus the scale pools."""
        nbytes = (2 * self.cfg.layers * int(np.prod(self._shape))
                  * torch.empty((), dtype=self.value_dtype).element_size())
        if self.scale_dtype is not None:
            nbytes += (2 * self.cfg.layers * int(np.prod(self._scale_shape))
                       * torch.empty((), dtype=self.scale_dtype).element_size())
        return nbytes

    def device_bytes_global(self) -> int:
        """Device bytes of all ``tp`` shards' buffers together."""
        return self.tp * self.device_bytes()

    def bytes_per_position(self) -> int:
        """Device bytes one cached position costs this shard across K+V
        and all layers, values and scales."""
        hd = self.cfg.d_model // self.cfg.heads
        return self.cfg.layers * kv_bytes_per_position(
            self.heads, hd, self.value_dtype, self.scale_dtype is not None)

    def bytes_per_position_global(self) -> int:
        """Device bytes one cached position costs all ``tp`` shards
        together (the single-device pool's figure)."""
        return self.tp * self.bytes_per_position()

    def note_quant_error(self, rms: float) -> None:
        """Record one sampled write-time round-trip error: the relative RMS
        of ``dequantize(quantize(rows))`` against the rows a quantized
        insert wrote."""
        rms = float(rms)
        self.stats["quant_error_probes"] += 1
        self.stats["quant_error_last"] = rms
        self.stats["quant_error_sum"] += rms
        self.stats["quant_error_max"] = max(self.stats["quant_error_max"],
                                            rms)

    # -- allocation ----------------------------------------------------------

    def pages_per_slot(self, length: int) -> int:
        """Pages needed to hold ``length`` cache positions."""
        return -(-int(length) // self.page_size)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def alloc(self, n: int, *, count_failure: bool = True) -> List[int]:
        """Take ``n`` free pages, lowest physical index first. Raises
        :class:`PoolExhausted` without partial effects;
        ``count_failure=False`` leaves the failure stat to a caller that
        retries after evicting prefixes."""
        if n < 0:
            raise ValueError("alloc() needs n >= 0")
        if n > len(self._free):
            if count_failure:
                self.note_alloc_failure()
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"({self.pages_in_use}/{self.num_pages - 1} in use)")
        pages = [heapq.heappop(self._free) for _ in range(n)]
        self._refs[pages] += 1
        self.high_water = max(self.high_water, self.pages_in_use)
        return pages

    def note_alloc_failure(self) -> None:
        """Record a terminal allocation failure."""
        self.stats["alloc_failures"] += 1

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError(f"incref of free page {p}")
        self._refs[list(pages)] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; refcount-0 pages return to the
        free heap. Freeing an already-free page raises."""
        for p in pages:
            p = int(p)
            if p <= 0 or p >= self.num_pages or self._refs[p] <= 0:
                raise ValueError(f"free of unallocated page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                heapq.heappush(self._free, p)

    # -- prefix sharing ------------------------------------------------------

    def register_prefix(self, phash: str, pages: Sequence[int],
                        plen: int) -> None:
        """Retain ``pages`` as the cached content of a ``plen``-token
        prompt prefix; a re-registration adds one release obligation."""
        if phash in self._prefixes:
            self._prefix_regs[phash] += 1
            return
        pages = tuple(int(p) for p in pages)
        self.incref(pages)
        self._prefixes[phash] = (pages, int(plen))
        self._prefix_regs[phash] = 1

    def lookup_prefix(self, phash: str):
        """``(pages, plen)`` or None."""
        return self._prefixes.get(phash)

    def acquire_prefix(self, phash: str,
                       n_shared: int) -> Tuple[Tuple[int, ...], int]:
        """Share the first ``n_shared`` pages of a registered prefix into
        a request (incref — copy-on-write). Returns the full entry."""
        pages, plen = self._prefixes[phash]
        shared = pages[:n_shared]
        self.incref(shared)
        self.stats["prefix_share_hits"] += len(shared)
        return pages, plen

    def release_prefix(self, phash: str) -> None:
        """Drop one registration; the pages fall with the last one."""
        regs = self._prefix_regs.get(phash)
        if regs is None:
            return
        if regs > 1:
            self._prefix_regs[phash] = regs - 1
            return
        del self._prefix_regs[phash]
        pages, _ = self._prefixes.pop(phash)
        self.free(pages)

    # -- defrag --------------------------------------------------------------

    def fragmentation(self) -> int:
        """Pages of dead space inside the live span."""
        live = np.nonzero(self._refs[1:] > 0)[0]
        if live.size == 0:
            return 0
        return int(live[-1] + 1) - int(live.size)

    def should_compact(self, threshold: int) -> bool:
        return self.fragmentation() >= max(1, int(threshold))

    def compact(self) -> Optional[np.ndarray]:
        """Pack live pages down to ``[1, n_live]``. Returns ``remap`` (old
        physical id -> new, a full permutation with ``remap[0] == 0``) for
        the engine to gather the buffers with and rewrite its page lists —
        or None when nothing would move. Refcounts, the free heap and the
        prefix registry are rewritten here."""
        live = np.nonzero(self._refs > 0)[0].astype(np.int64)
        remap = np.zeros(self.num_pages, np.int64)
        nxt = 1
        moved = 0
        for old in live:
            if old == 0:
                continue
            remap[old] = nxt
            if old != nxt:
                moved += 1
            nxt += 1
        if moved == 0:
            return None
        dead = [p for p in range(1, self.num_pages) if self._refs[p] == 0]
        for old in dead:
            remap[old] = nxt
            nxt += 1
        new_refs = np.zeros_like(self._refs)
        new_refs[remap] = self._refs
        self._refs = new_refs
        self._free = [int(remap[p]) for p in dead]
        heapq.heapify(self._free)
        self._prefixes = {
            h: (tuple(int(remap[p]) for p in pages), plen)
            for h, (pages, plen) in self._prefixes.items()}
        self.stats["defrag_moves"] += moved
        return remap

    # -- misc ----------------------------------------------------------------

    def note_prefill_chunk(self, ntok: int) -> None:
        self.stats["prefill_chunks"] += 1

    def note_attn_tick(self, impl: str, *, calls: int = 1,
                       gather_bytes: int = 0) -> None:
        """Account ``calls`` paged-attention invocations under ``impl``
        ("kernel" or "gather") and the bytes the gather impl moved
        materializing contiguous K/V (0 under the kernel)."""
        self.stats[f"attn_ticks_{impl}"] += calls
        self.stats["gather_bytes"] += gather_bytes

    @staticmethod
    def kernel_aligned_page_size(page_size: int) -> int:
        """The page size the Hopper kernel runs at: any size >= 1, as
        given — the kernel looks every key's page up on its own, so the
        TPU's sublane rounding has no counterpart (ops/paged_attention)."""
        return max(1, int(page_size))

    def reset(self) -> None:
        """Forget every allocation and re-zero the device buffers (scale
        pools included)."""
        self.buffers = self._make_buffers()
        self._free = list(range(1, self.num_pages))
        heapq.heapify(self._free)
        self._refs[:] = 0
        self._prefixes.clear()
        self._prefix_regs.clear()
