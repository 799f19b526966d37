"""Paged KV pool — page-granular cache management for serving
(counterpart of ``serving/kv_pool.py:98-673``), and the closed-loop
:class:`KVAutotuner` the engine runs with ``autotune=True``.

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
  gather;
* **session export / adopt** — :meth:`export_session` writes one
  session's pages (values and scales) into the reference's portable blob,
  byte for byte, and :meth:`adopt_session` scatters such a blob into
  freshly allocated pages, so either package adopts the other's blobs;
* **accounting** — the pool reserves its buffers' bytes with the
  residency manager (``residency=True``, released by :meth:`close` or at
  GC), and a page whose last reference drops charges its hold to the
  cost ledger as ``kv_page_seconds``, under the owning request's class
  and trace when the caller names them.

Physical page 0 is the **trash page**: never allocated, the redirect
target for inactive-row writes and for block-table entries past a row's
allocation. The pool is host bookkeeping plus a handle to the device
buffers; the caller serializes access.

**Tensor parallelism** (``mesh=`` with a ``tp`` axis of size ``tp > 1``,
the JAX ``sharding=`` argument): a rank's pool holds its ``heads / tp`` heads of every page, ``(num_pages,
heads / tp, page_size, hd)``. The page dimension stays a shared arena:
every rank runs the same allocations, so alloc/free, block tables, CoW
and ``compact()`` are the same host bookkeeping on every rank.
``device_bytes`` and ``bytes_per_position`` report this shard;
``device_bytes_global`` and ``bytes_per_position_global`` all ``tp``
shards together. Such a pool moves sessions whole: :meth:`PagedKVPool.export_session` gathers the heads of
every ``tp`` rank into the reference's head-complete blob (its pages are
the ranks' shards concatenated by head, byte for byte), and
:meth:`PagedKVPool.adopt_session` keeps this rank's heads of such a
blob. Over a ``dp`` axis the pool replicates: every replica runs the
same allocations and writes.
"""

from __future__ import annotations

import base64
import hashlib
import heapq
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.residency import get_residency_manager
from ..observability import charge as _ledger_charge
from ..observability import gauge as _metric_gauge
from ..parallel.mesh import axis_rank, axis_size, gather_rows
from ..ops.kv_quant import (SCALE_DTYPE, kv_bytes_per_position,
                            kv_store_dtype, resolve_kv_dtype)
from ..utils.device import resolve_device

__all__ = ["PagedKVPool", "PoolExhausted", "KVAutotuner", "prefix_hash",
           "AFFINITY_HEADER", "affinity_headers"]

#: numpy's names for the pool dtypes: the session blob's ``value_dtype``
#: and ``scale_dtype`` strings, as the reference writes them
_NP_NAMES = {torch.float32: "float32", torch.float16: "float16",
             torch.bfloat16: "bfloat16", torch.int8: "int8",
             torch.float8_e4m3fn: "float8_e4m3fn"}

M_AUTOTUNE_GAMMA = _metric_gauge(
    "mmlspark_kvpool_autotune_gamma",
    "Current speculative draft length chosen by the KV autotuner")
M_AUTOTUNE_CHUNK = _metric_gauge(
    "mmlspark_kvpool_autotune_chunk_budget",
    "Current prefill chunk budget (tokens) chosen by the KV autotuner")
M_AUTOTUNE_DEPTH = _metric_gauge(
    "mmlspark_kvpool_autotune_pipeline_depth",
    "Current decode pipeline depth (in-flight steps) chosen by the KV "
    "autotuner")


def prefix_hash(tokens: Sequence[int]) -> str:
    """Stable content hash for a prompt prefix (the prefix-registry key) —
    the same bytes the reference hashes, so both give the same key."""
    h = hashlib.sha1()
    h.update(np.asarray(tokens, np.int64).tobytes())
    return h.hexdigest()


#: request header carrying a prefix-affinity key: clients stamp it with
#: :func:`prefix_hash` of their shared prompt prefix and the distributed
#: forwarder (serving/distributed.py) consistent-hashes it to the worker
#: whose pool already holds those pages
AFFINITY_HEADER = "X-Mmlspark-Prefix"


def affinity_headers(tokens: Sequence[int]) -> List[Tuple[str, str]]:
    """The routing header a session should attach so its requests land on
    the worker owning its shared-prefix pages — same hash the pool keys
    the prefix registry by, so routing affinity and page sharing agree."""
    return [(AFFINITY_HEADER, prefix_hash(tokens))]


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
                 kv_dtype: Optional[str] = None, device=None,
                 residency: bool = True, mesh=None):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        tp = axis_size(mesh, "tp")
        if cfg.heads % tp:
            raise ValueError(f"heads {cfg.heads} not divisible by tp={tp}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        #: head shards the pool's heads are split into: the size of the
        #: mesh's "tp" axis (1 = all heads; None or no such axis)
        self.tp = tp
        #: the mesh whose "tp" axis the session calls gather heads over,
        #: and this rank's index on that axis
        self._mesh = mesh
        self.tp_rank = axis_rank(mesh, "tp")
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
        # page -> monotonic time it left the free heap: the cost ledger's
        # kv_page_seconds charge when its last reference drops
        self._alloc_t: Dict[int, float] = {}
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
        self._reservation = None
        if residency:
            mgr = get_residency_manager()
            token = mgr.reserve(self.device_bytes(), label="kv_pool")
            self._reservation = token
            self._finalizer = weakref.finalize(self, mgr.release, token)

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
        insert wrote. The engine forwards the same sample to the SLO
        tracker under its model label."""
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
        now = time.monotonic()
        for p in pages:
            self._alloc_t[p] = now
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

    def free(self, pages: Sequence[int], *, cost_cls=None,
             cost_trace=None) -> None:
        """Drop one reference per page; refcount-0 pages return to the
        free heap. Freeing an already-free page raises.

        Pages whose last reference drops here charge their whole hold
        (pages x seconds since they left the free heap) to the cost
        ledger as ``kv_page_seconds``: under ``cost_cls``/``cost_trace``
        when the caller knows the owning request (the decoder's slot
        release does), else the ambient trace context."""
        held = 0.0
        now = time.monotonic()
        for p in pages:
            p = int(p)
            if p <= 0 or p >= self.num_pages or self._refs[p] <= 0:
                raise ValueError(f"free of unallocated page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                heapq.heappush(self._free, p)
                held += now - self._alloc_t.pop(p, now)
        if held > 0.0:
            _ledger_charge("kv_page_seconds", held, cls=cost_cls,
                           trace_id=cost_trace)

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
        self._alloc_t = {int(remap[p]): t
                         for p, t in self._alloc_t.items()}
        self.stats["defrag_moves"] += moved
        return remap

    # -- session export / adopt ----------------------------------------------

    def _layout(self) -> dict:
        """The blob fields an adopting pool must match: the head-complete
        page shape, whatever shard this pool holds."""
        return {
            "page_size": self.page_size,
            "kv_dtype": self.kv_dtype,
            "value_dtype": _NP_NAMES[self.value_dtype],
            "scale_dtype": (_NP_NAMES[self.scale_dtype]
                            if self.scale_dtype is not None else None),
            "layers": int(self.cfg.layers),
            "page_shape": [self.cfg.heads] + [int(x)
                                              for x in self._shape[2:]],
        }

    def _head_complete(self, raw: torch.Tensor) -> torch.Tensor:
        """This rank's (n, H / tp, ...) uint8 page bytes of one buffer →
        every rank's, (n, H, ...) concatenated by head in rank order: ONE
        all-gather over the ``tp`` group (the identity at tp = 1)."""
        if self.tp == 1:
            return raw
        parts = gather_rows(raw[None], self._mesh, "tp")
        return parts.transpose(0, 1).reshape(
            (raw.shape[0], self.tp * raw.shape[1]) + tuple(raw.shape[2:]))

    def export_session(self, pages: Sequence[int], *, length: int) -> dict:
        """Serialize one session's KV pages into the reference's portable,
        JSON-able blob (``serving/kv_pool.py:425-460``).

        ``pages`` is the session's page list in logical (block-table)
        order, after any ``compact()`` remap; quantized pools' scale pages
        ride along per layer under the same indices. ``length`` is the
        number of positions the pages hold. Each buffer's pages are
        gathered as raw bytes (one gather per buffer), and all of them
        cross to the host in ONE copy.

        A head-sharded pool (``tp > 1``) exports on every rank of its
        ``tp`` group together: the buffers' page bytes cross the group in
        one all-gather and every rank returns the same head-complete blob,
        whose pages are the ranks' shards concatenated by head, bitwise
        (not bitwise a single-device export: the tp all-reduce orders the
        sums of later layers differently)."""
        pages = [int(p) for p in pages]
        idx = torch.as_tensor(pages, dtype=torch.int64).to(self.device)
        shards = [buf.view(torch.uint8)[idx] for c in self.buffers
                  for buf in c.values()]
        if self.tp > 1 and shards:
            # one collective: every buffer's (n, H / tp, row) bytes side
            # by side under the head axis
            n, h = shards[0].shape[:2]
            cat = torch.cat([b.reshape(n, h, -1) for b in shards], dim=2)
            whole = self._head_complete(cat)
            cuts = np.cumsum([0] + [b[0, 0].numel() for b in shards])
            shards = [whole[:, :, cuts[i]:cuts[i + 1]]
                      for i in range(len(shards))]
        flat = [b.reshape(-1) for b in shards]
        sizes = [b.numel() for b in flat]
        host = torch.cat(flat).cpu().numpy() if flat else np.zeros(0, np.uint8)
        data, off, i = [], 0, 0
        for c in self.buffers:
            entry = {}
            for key in c:
                entry[key] = base64.b64encode(
                    host[off:off + sizes[i]].tobytes()).decode("ascii")
                off += sizes[i]
                i += 1
            data.append(entry)
        self.stats["sessions_exported"] = \
            self.stats.get("sessions_exported", 0) + 1
        return {"v": 1, "n_pages": len(pages), "length": int(length),
                **self._layout(), "data": data}

    def adopt_session(self, blob: dict) -> List[int]:
        """Allocate pages on THIS pool and scatter ``blob``'s contents into
        them (``serving/kv_pool.py:462-509``). Returns the new page list in
        the blob's logical order. Raises ``ValueError`` on a layout
        mismatch (page size, layer count, head geometry, dtypes and
        quantization mode must agree) before it allocates, and
        ``PoolExhausted`` — with nothing leaked — when the pool lacks the
        pages; any later failure frees what it allocated. The blob's bytes
        cross to the device in one copy. A head-sharded pool keeps this
        rank's heads of the head-complete blob (heads ``[r * H / tp, (r +
        1) * H / tp)`` for ``tp`` rank ``r``); no collective runs."""
        if blob.get("v") != 1:
            raise ValueError(f"unknown session blob version {blob.get('v')}")
        want = self._layout()
        got = {k: blob.get(k) for k in want}
        if got != want:
            raise ValueError(
                f"session blob layout mismatch: blob {got} != pool {want}")
        n = int(blob["n_pages"])
        pages = self.alloc(n)
        try:
            chunks, shapes = [], []
            h0 = self.tp_rank * self.heads
            for c, entry in zip(self.buffers, blob["data"]):
                for key, buf in c.items():
                    raw = np.frombuffer(base64.b64decode(entry[key]), np.uint8)
                    row = tuple(buf.view(torch.uint8).shape[2:])
                    whole = (n, self.cfg.heads) + row
                    if raw.size != int(np.prod(whole)):
                        raise ValueError(
                            f"session blob {key!r}: {raw.size} bytes, want "
                            f"{int(np.prod(whole))}")
                    shape = (n, self.heads) + row
                    chunks.append(raw.reshape(whole)[
                        :, h0:h0 + self.heads].reshape(-1))
                    shapes.append(shape)
            if len(shapes) != sum(len(c) for c in self.buffers):
                raise ValueError("session blob: missing layers or buffers")
            dev = torch.from_numpy(np.concatenate(chunks))
            if self.device.type != "cpu":
                dev = dev.pin_memory().to(self.device, non_blocking=True)
            idx = torch.as_tensor(pages, dtype=torch.int64).to(self.device)
            off, i = 0, 0
            for c in self.buffers:
                for buf in c.values():
                    size = int(np.prod(shapes[i]))
                    buf.view(torch.uint8)[idx] = \
                        dev[off:off + size].reshape(shapes[i])
                    off += size
                    i += 1
        except Exception:
            self.free(pages)
            raise
        self.stats["sessions_adopted"] = \
            self.stats.get("sessions_adopted", 0) + 1
        return pages

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
        self._alloc_t.clear()
        self._prefixes.clear()
        self._prefix_regs.clear()

    def close(self) -> None:
        """Release the residency reservation early (also runs at GC)."""
        if self._reservation is not None:
            self._finalizer()
            self._reservation = None


class KVAutotuner:
    """Closed-loop tuner for speculative gamma, the prefill chunk budget
    and the pipeline depth (host logic only; the reference's thresholds
    and ``history`` records).

    Observations arrive once per engine tick; every ``interval`` ticks the
    batch turns into decisions:

    * **gamma** follows the measured acceptance. A verify round emits
      ``accepted + 1`` tokens per live slot, so ``acc = (emitted /
      round_slots - 1) / gamma``: ``acc >= acc_hi`` raises gamma by one
      (up to ``gamma_max``), ``acc <= acc_lo`` lowers it (floor 1).
      Greedy output stays token-identical whatever gamma runs.
    * **chunk budget** follows slot occupancy: a mostly idle pool
      (``<= occ_lo``) doubles it (cap ``chunk_max``), a saturated one
      (``>= occ_hi``) halves it (floor ``chunk_min``).
    * **pipeline depth** follows occupancy the same way, one step at a
      time within ``[depth_min, depth_max]``; ``depth=None`` leaves the
      engine's static depth alone.
    """

    def __init__(self, *, gamma: int, gamma_max: int, chunk: int,
                 chunk_min: int = 32, chunk_max: int = 1024,
                 interval: int = 32, acc_lo: float = 0.55,
                 acc_hi: float = 0.85, occ_lo: float = 0.25,
                 occ_hi: float = 0.75, depth: Optional[int] = None,
                 depth_min: int = 1, depth_max: int = 4):
        self.gamma = int(gamma)
        self.gamma_max = int(gamma_max)
        self.chunk = int(chunk)
        self.chunk_min = int(chunk_min)
        self.chunk_max = int(chunk_max)
        self.interval = max(1, int(interval))
        self.acc_lo, self.acc_hi = float(acc_lo), float(acc_hi)
        self.occ_lo, self.occ_hi = float(occ_lo), float(occ_hi)
        self.depth = None if depth is None else int(depth)
        self.depth_min = max(0, int(depth_min))
        self.depth_max = max(self.depth_min, int(depth_max))
        self.history: List[Dict] = []
        self._ticks = 0
        self._occ_sum = 0.0
        self._emitted0 = 0
        self._rounds0 = 0
        M_AUTOTUNE_GAMMA.set(self.gamma)
        M_AUTOTUNE_CHUNK.set(self.chunk)
        if self.depth is not None:
            M_AUTOTUNE_DEPTH.set(self.depth)

    def observe(self, live: int, slots: int,
                spec_emitted: Optional[int] = None,
                spec_round_slots: Optional[int] = None) -> None:
        """One engine tick: ``live`` occupied of ``slots``, plus the
        engine's cumulative speculative counters (deltas taken here)."""
        self._ticks += 1
        self._occ_sum += live / max(1, slots)
        if self._ticks < self.interval:
            return
        occ = self._occ_sum / self._ticks
        self._ticks = 0
        self._occ_sum = 0.0
        if spec_emitted is not None and spec_round_slots is not None:
            d_emit = spec_emitted - self._emitted0
            d_rounds = spec_round_slots - self._rounds0
            self._emitted0, self._rounds0 = spec_emitted, spec_round_slots
            if d_rounds > 0 and self.gamma > 0:
                acc = (d_emit / d_rounds - 1.0) / self.gamma
                if acc >= self.acc_hi and self.gamma < self.gamma_max:
                    self._set_gamma(self.gamma + 1, acc)
                elif acc <= self.acc_lo and self.gamma > 1:
                    self._set_gamma(self.gamma - 1, acc)
        if occ <= self.occ_lo and self.chunk * 2 <= self.chunk_max:
            self._set_chunk(self.chunk * 2, occ)
        elif occ >= self.occ_hi and self.chunk // 2 >= self.chunk_min:
            self._set_chunk(self.chunk // 2, occ)
        if self.depth is not None:
            if occ <= self.occ_lo and self.depth + 1 <= self.depth_max:
                self._set_depth(self.depth + 1, occ)
            elif occ >= self.occ_hi and self.depth - 1 >= self.depth_min:
                self._set_depth(self.depth - 1, occ)

    def _set_gamma(self, g: int, acc: float) -> None:
        self.history.append({"knob": "gamma", "from": self.gamma, "to": g,
                             "acceptance": round(acc, 4)})
        self.gamma = g
        M_AUTOTUNE_GAMMA.set(g)

    def _set_chunk(self, c: int, occ: float) -> None:
        self.history.append({"knob": "chunk", "from": self.chunk, "to": c,
                             "occupancy": round(occ, 4)})
        self.chunk = c
        M_AUTOTUNE_CHUNK.set(c)

    def _set_depth(self, d: int, occ: float) -> None:
        self.history.append({"knob": "depth", "from": self.depth, "to": d,
                             "occupancy": round(occ, 4)})
        self.depth = d
        M_AUTOTUNE_DEPTH.set(d)
