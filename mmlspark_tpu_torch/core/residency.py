"""Device residency — columns that *live on device* across pipeline stages
(counterpart of ``mmlspark_tpu/core/residency.py``, over ``torch.Tensor``).

A :class:`~.dataframe.DataFrame` column can be *host* (a plain ndarray),
*device* (a ``torch.Tensor`` per partition), or *spilled* (was device,
evicted back to host under memory pressure), so that a ``Pipeline`` of
stages pays **one** h2d at ingest and **one** d2h at the sink.

Three moving parts, as in the JAX package:

* :class:`DeviceColumn` — an ordered list of device-tensor chunks (one per
  DataFrame partition at ingest); slicing walks the chunks, so it survives
  ``repartition`` untouched.
* :class:`ResidencyManager` — process-global LRU over every resident
  chunk, spilling least-recently-used chunks when a device-memory budget
  (``MMLSPARK_TPU_DEVICE_BUDGET_BYTES``) is exceeded. Ingest-staged chunks
  keep a host view, so their spill is free; device-born chunks pay one
  counted d2h to spill.
* :class:`HostMirror` — the lazy host facade a device-born column presents
  inside ``DataFrame._columns``; the first host access materializes it with
  a counted d2h.

Every transfer is counted in the ``mmlspark_residency_*`` counters of the
port's metrics registry; ``h2d``/``d2h`` count *transfer operations
issued* (a batched multi-chunk put or get is one operation), with byte
totals alongside. A "device" here is whatever device the put targets:
the CUDA card by default, the CPU when a caller asks for it by name
(:func:`make_put`).
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability.registry import counter as _counter
from ..observability.registry import gauge as _gauge

__all__ = [
    "DeviceColumn", "HostMirror", "ResidencyManager",
    "get_residency_manager", "configure_residency", "residency_stats",
    "is_device_array", "record_hit", "record_miss", "make_put",
    "device_get", "host_dtype", "BUDGET_ENV",
]

BUDGET_ENV = "MMLSPARK_TPU_DEVICE_BUDGET_BYTES"

M_H2D = _counter("mmlspark_residency_h2d_total",
                 "host-to-device transfer operations, by site "
                 "(ingest = first staging, restage = reload after spill)",
                 ("site",))
M_H2D_BYTES = _counter("mmlspark_residency_h2d_bytes_total",
                       "bytes moved host-to-device, by site", ("site",))
M_D2H = _counter("mmlspark_residency_d2h_total",
                 "device-to-host transfer operations, by site "
                 "(sink = explicit to_host, materialize = lazy host access "
                 "of a device-born column, spill = eviction writeback)",
                 ("site",))
M_D2H_BYTES = _counter("mmlspark_residency_d2h_bytes_total",
                       "bytes moved device-to-host, by site", ("site",))
M_HITS = _counter("mmlspark_residency_hits_total",
                  "device_put requests served by an already-resident column")
M_MISSES = _counter("mmlspark_residency_misses_total",
                    "device_put requests that had to stage a column")
M_SPILLS = _counter("mmlspark_residency_spills_total",
                    "partition chunks evicted from device under the budget")
M_MATERIALIZE = _counter("mmlspark_residency_host_materializations_total",
                         "device-born columns pulled to host, by op",
                         ("op",))
M_RESIDENT = _gauge("mmlspark_residency_resident_bytes",
                    "bytes currently resident on device under the manager")
M_RESIDENT_CHUNKS = _gauge("mmlspark_residency_resident_chunks",
                           "partition chunks currently resident on device")
M_RESERVED = _gauge("mmlspark_residency_reserved_bytes",
                    "bytes pinned by fixed reservations — counted against "
                    "the budget, never spilled")


def is_device_array(value) -> bool:
    """True iff ``value`` is a ``torch.Tensor`` (the port's device array)."""
    return isinstance(value, torch.Tensor)


def record_hit(n: int = 1) -> None:
    M_HITS.inc(n)


def record_miss(n: int = 1) -> None:
    M_MISSES.inc(n)


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a device dtype comes back to the host as: bfloat16
    widens to float32 (numpy has no bfloat16), the rest map one to one."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype == torch.bfloat16 else t


def make_put(device=None) -> Callable:
    """A put for :meth:`DataFrame.device_put` / :meth:`DeviceColumn.
    from_host`: host ndarray (or a list of them) → tensor(s) on ``device``
    (resolved by :func:`~..utils.device.resolve_device`, so ``None`` is
    the CUDA card and raises without one). On the card each array goes
    through a pinned host copy with ``non_blocking``; the pinned buffer
    stays reserved by PyTorch's host allocator until its copy completes.
    On the CPU the tensor is a copy, so the device chunk never aliases the
    host column."""
    def put(x):
        from ..utils.device import resolve_device
        dev = resolve_device(device)
        if isinstance(x, (list, tuple)):
            return [_put_one(a, dev) for a in x]
        return _put_one(x, dev)
    return put


def _put_one(a, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


_default_put = make_put(None)


def device_get(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """One batched device→host fetch: CUDA tensors copy into pinned host
    buffers with ``non_blocking`` and the host waits once, at the end.
    bfloat16 comes back as float32."""
    outs, waits = [], set()
    for t in tensors:
        t = _to_host(t)
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            waits.add(t.device)
            outs.append(buf)
        else:
            outs.append(t.detach())
    for dev in waits:
        torch.cuda.current_stream(dev).synchronize()
    return [o.numpy() for o in outs]


class _Chunk:
    """One partition-sized chunk of one resident column — the LRU/spill unit.

    ``state`` is "device" or "spilled". ``host`` is the host copy when one
    exists (always for ingest-staged chunks — a zero-copy view of the source
    column — and after a spill writeback for device-born ones); a chunk with
    a host copy spills for free by dropping its device tensor. ``device``
    is where the chunk lives while resident, kept across a spill.
    """

    __slots__ = ("state", "dev", "host", "nbytes", "put", "device",
                 "__weakref__")

    def __init__(self, dev, host: Optional[np.ndarray],
                 put: Optional[Callable] = None):
        self.state = "device"
        self.dev = dev
        self.host = host
        self.nbytes = int(dev.nbytes) if dev is not None else 0
        self.put = put
        self.device = dev.device if dev is not None else None


class ResidencyManager:
    """Process-global LRU of resident chunks under a device-memory budget.

    ``budget_bytes`` <= 0 means unlimited (the default). The budget is a
    target, not a hard cap: the chunk being admitted is never evicted to
    make room for itself, so a single chunk larger than the budget stays
    resident (and everything else spills).
    """

    def __init__(self, budget_bytes: Optional[int] = None):
        if budget_bytes is None:
            budget_bytes = int(os.environ.get(BUDGET_ENV, "0") or 0)
        self.budget_bytes = int(budget_bytes)
        # gc of a resident chunk can fire the weakref callback mid-admit on
        # the same thread — the lock must be reentrant
        self._lock = threading.RLock()
        self._lru: "OrderedDict[int, object]" = OrderedDict()  # id -> weakref
        self._accounted: Dict[int, int] = {}                   # id -> bytes
        self._resident_bytes = 0
        self._reservations: Dict[int, Tuple[int, str]] = {}
        self._next_reservation = 0

    # -- bookkeeping --------------------------------------------------------
    def _publish(self) -> None:
        M_RESIDENT.set(self._resident_bytes)
        M_RESIDENT_CHUNKS.set(len(self._lru))

    def _forget(self, key: int) -> None:
        with self._lock:
            self._lru.pop(key, None)
            self._resident_bytes -= self._accounted.pop(key, 0)
            self._publish()

    def admit(self, chunk: _Chunk) -> None:
        """Register a device-resident chunk and evict LRU peers over budget."""
        key = id(chunk)
        with self._lock:
            if key not in self._lru:
                self._lru[key] = weakref.ref(
                    chunk, lambda _ref, k=key: self._forget(k))
                self._accounted[key] = chunk.nbytes
                self._resident_bytes += chunk.nbytes
            self._lru.move_to_end(key)
            self._evict_over_budget(exclude=key)
            self._publish()

    def touch(self, chunk: _Chunk) -> None:
        with self._lock:
            key = id(chunk)
            if key in self._lru:
                self._lru.move_to_end(key)

    # -- fixed reservations --------------------------------------------------
    def reserve(self, nbytes: int, label: str = "reserved") -> int:
        """Pin ``nbytes`` of device memory against the budget without a
        spillable chunk behind it. Returns a token for :meth:`release`."""
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError("reserve() needs nbytes >= 0")
        with self._lock:
            token = self._next_reservation
            self._next_reservation += 1
            self._reservations[token] = (nbytes, str(label))
            self._resident_bytes += nbytes
            M_RESERVED.set(self.reserved_bytes())
            self._evict_over_budget()
            self._publish()
        return token

    def release(self, token: int) -> None:
        """Drop a :meth:`reserve` pin (idempotent for unknown tokens)."""
        with self._lock:
            nbytes, _ = self._reservations.pop(token, (0, ""))
            self._resident_bytes -= nbytes
            M_RESERVED.set(self.reserved_bytes())
            self._publish()

    def reserved_bytes(self) -> int:
        return sum(n for n, _ in self._reservations.values())

    def _evict_over_budget(self, exclude: Optional[int] = None) -> None:
        if self.budget_bytes <= 0:
            return
        for key in list(self._lru):
            if self._resident_bytes <= self.budget_bytes:
                break
            if key == exclude:
                continue
            chunk = self._lru[key]()
            if chunk is not None:
                self._spill(chunk)
            else:
                self._forget(key)

    def _spill(self, chunk: _Chunk) -> None:
        """Evict one chunk: free the device tensor, keeping/making a host
        copy. Host-backed chunks spill for free; device-born ones pay one
        counted d2h writeback, under the lock so that the state flip is
        atomic with it."""
        key = id(chunk)
        if chunk.state != "device":
            self._forget(key)
            return
        if chunk.host is None:
            chunk.host = device_get([chunk.dev])[0]
            M_D2H.inc(1, site="spill")
            M_D2H_BYTES.inc(chunk.nbytes, site="spill")
        chunk.dev = None
        chunk.state = "spilled"
        M_SPILLS.inc()
        self._forget(key)

    def ensure_device(self, chunk: _Chunk):
        """Return the chunk's device tensor, restaging (counted) if spilled."""
        with self._lock:
            if chunk.state == "spilled":
                put = chunk.put or _default_put
                chunk.dev = put(chunk.host)
                chunk.device = chunk.dev.device
                chunk.state = "device"
                M_H2D.inc(1, site="restage")
                M_H2D_BYTES.inc(chunk.nbytes, site="restage")
                self.admit(chunk)
            else:
                self.touch(chunk)
            return chunk.dev

    def spill_all(self) -> None:
        """Evict everything resident (test/debug hook)."""
        with self._lock:
            for key in list(self._lru):
                chunk = self._lru[key]()
                if chunk is not None:
                    self._spill(chunk)
                else:
                    self._forget(key)
            self._publish()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"resident_bytes": self._resident_bytes,
                    "resident_chunks": len(self._lru),
                    "reserved_bytes": self.reserved_bytes(),
                    "budget_bytes": self.budget_bytes}


_MANAGER = ResidencyManager()


def get_residency_manager() -> ResidencyManager:
    return _MANAGER


def configure_residency(budget_bytes: Optional[int] = None
                        ) -> ResidencyManager:
    """Set (or re-read from ``MMLSPARK_TPU_DEVICE_BUDGET_BYTES``) the device
    memory budget and immediately enforce it on what is already resident."""
    if budget_bytes is None:
        budget_bytes = int(os.environ.get(BUDGET_ENV, "0") or 0)
    with _MANAGER._lock:
        _MANAGER.budget_bytes = int(budget_bytes)
        _MANAGER._evict_over_budget()
        _MANAGER._publish()
    return _MANAGER


def residency_stats() -> Dict[str, object]:
    """One JSON-safe dict of the residency counters."""
    hits = M_HITS.labels().get()
    misses = M_MISSES.labels().get()
    total = hits + misses
    out: Dict[str, object] = dict(_MANAGER.stats())
    out.update({
        "hits": hits, "misses": misses,
        "residency_hit_rate": (hits / total) if total else None,
        "spills": M_SPILLS.labels().get(),
        "h2d_ops": {s: M_H2D.labels(site=s).get()
                    for s in ("ingest", "restage")},
        "h2d_bytes": {s: M_H2D_BYTES.labels(site=s).get()
                      for s in ("ingest", "restage")},
        "d2h_ops": {s: M_D2H.labels(site=s).get()
                    for s in ("sink", "materialize", "spill")},
        "d2h_bytes": {s: M_D2H_BYTES.labels(site=s).get()
                      for s in ("sink", "materialize", "spill")},
    })
    return out


class DeviceColumn:
    """A column resident on device, chunked for spill granularity.

    Chunks are created per DataFrame partition at ingest but consumers never
    assume alignment — :meth:`slice_rows` walks the chunk list, so the same
    DeviceColumn survives ``repartition`` untouched. Chunk objects may be
    *shared* between DeviceColumns (slicing on exact chunk boundaries, and
    ``concatenate``, reuse them), which keeps the LRU honest: one physical
    buffer, one entry.
    """

    def __init__(self, chunks: List[_Chunk], sizes: List[int],
                 dtype, row_shape: Tuple[int, ...]):
        self._chunks = chunks
        self._sizes = sizes
        self._dtype = dtype
        self._row_shape = tuple(row_shape)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_host(cls, arr: np.ndarray, bounds: Sequence[Tuple[int, int]],
                  put: Optional[Callable] = None) -> "DeviceColumn":
        """Stage a host column: ONE batched put for all chunks, counted as a
        single ``site="ingest"`` h2d operation (and one residency miss).

        Each chunk keeps its host slice (a zero-copy view of ``arr``), so a
        later spill of ingest-staged data is free.
        """
        if arr.dtype == object:
            raise TypeError("object columns cannot be device-resident")
        bounds = [(lo, hi) for lo, hi in bounds] or [(0, len(arr))]
        hosts = [arr[lo:hi] for lo, hi in bounds]
        put_fn = put or _default_put
        devs = put_fn(hosts)  # one transfer op over every chunk
        record_miss()
        M_H2D.inc(1, site="ingest")
        M_H2D_BYTES.inc(int(arr.nbytes), site="ingest")
        chunks = [_Chunk(d, h, put) for d, h in zip(devs, hosts)]
        mgr = get_residency_manager()
        for c in chunks:
            mgr.admit(c)
        return cls(chunks, [hi - lo for lo, hi in bounds], devs[0].dtype,
                   arr.shape[1:])

    @classmethod
    def from_device(cls, arrays: Sequence, put: Optional[Callable] = None,
                    ) -> "DeviceColumn":
        """Wrap device-born tensors (stage outputs) — no transfer, no count."""
        arrays = list(arrays)
        if not arrays:
            raise ValueError("from_device needs at least one array")
        chunks = [_Chunk(a, None, put) for a in arrays]
        mgr = get_residency_manager()
        for c in chunks:
            mgr.admit(c)
        return cls(chunks, [int(a.shape[0]) for a in arrays],
                   arrays[0].dtype, tuple(arrays[0].shape[1:]))

    @classmethod
    def concatenate(cls, cols: Sequence["DeviceColumn"]) -> "DeviceColumn":
        """Stack columns end-to-end, sharing their chunks (no transfer)."""
        cols = list(cols)
        chunks: List[_Chunk] = []
        sizes: List[int] = []
        for c in cols:
            chunks.extend(c._chunks)
            sizes.extend(c._sizes)
        return cls(chunks, sizes, cols[0]._dtype, cols[0]._row_shape)

    # -- properties ---------------------------------------------------------
    @property
    def nrows(self) -> int:
        return sum(self._sizes)

    def __len__(self) -> int:
        return self.nrows

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.nrows,) + self._row_shape

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self._chunks)

    def chunk_states(self) -> List[str]:
        return [c.state for c in self._chunks]

    # -- device access ------------------------------------------------------
    def device_chunks(self) -> List[torch.Tensor]:
        """The chunk tensors, restaging any spilled ones (counted)."""
        mgr = get_residency_manager()
        return [mgr.ensure_device(c) for c in self._chunks]

    def device_array(self) -> torch.Tensor:
        """One device tensor for the whole column (concat on device)."""
        parts = self.device_chunks()
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=0)

    # -- device-side ops (no host round-trip) -------------------------------
    def slice_rows(self, lo: int, hi: int) -> "DeviceColumn":
        """Rows ``[lo, hi)`` as a new column. Chunks covered exactly are
        shared (no copy, no LRU churn); partial overlaps slice — on host if
        the chunk is host-backed (spill-state preserved, no transfer), else
        on device."""
        lo, hi = max(0, int(lo)), min(self.nrows, int(hi))
        chunks: List[_Chunk] = []
        sizes: List[int] = []
        off = 0
        mgr = get_residency_manager()
        for chunk, size in zip(self._chunks, self._sizes):
            a, b = max(lo, off), min(hi, off + size)
            if a < b:
                if a == off and b == off + size:
                    chunks.append(chunk)  # exact cover: share the buffer
                elif chunk.host is not None:
                    host = chunk.host[a - off:b - off]
                    if chunk.state == "device":
                        sub = _Chunk(chunk.dev[a - off:b - off], host,
                                     chunk.put)
                        mgr.admit(sub)
                    else:  # stay spilled: host view only, no transfer
                        sub = _Chunk(None, host, chunk.put)
                        sub.nbytes = int(host.nbytes)
                        sub.device = chunk.device
                        sub.state = "spilled"
                    chunks.append(sub)
                else:
                    dev = mgr.ensure_device(chunk)
                    sub = _Chunk(dev[a - off:b - off], None, chunk.put)
                    mgr.admit(sub)
                    chunks.append(sub)
                sizes.append(b - a)
            off += size
        if not chunks:
            empty = torch.empty((0,) + self._row_shape, dtype=self._dtype,
                                device=self._chunks[0].device)
            return DeviceColumn.from_device([empty])
        return DeviceColumn(chunks, sizes, self._dtype, self._row_shape)

    def take(self, indices) -> "DeviceColumn":
        """Device gather — the index vector rides along uncounted (it is
        addressing, not column payload)."""
        arr = self.device_array()
        idx = torch.as_tensor(np.array(indices, dtype=np.int64),
                              device=arr.device)
        return DeviceColumn.from_device([arr[idx]])

    def compress(self, mask: np.ndarray) -> "DeviceColumn":
        """Boolean-mask filter on device."""
        arr = self.device_array()
        m = torch.as_tensor(np.array(mask, dtype=bool), device=arr.device)
        return DeviceColumn.from_device([arr[m]])

    # -- host exit ----------------------------------------------------------
    def to_host(self, site: str = "sink") -> np.ndarray:
        """Materialize the whole column on host.

        Chunks with a host copy are free; the rest come back in ONE batched
        :func:`device_get` counted as a single d2h operation at ``site``.
        bf16 widens to f32 for host consumers.
        """
        need = [(i, c.dev) for i, c in enumerate(self._chunks)
                if c.host is None]
        fetched: Dict[int, np.ndarray] = {}
        if need:
            got = device_get([d for _, d in need])
            nbytes = sum(int(d.nbytes) for _, d in need)
            M_D2H.inc(1, site=site)
            M_D2H_BYTES.inc(nbytes, site=site)
            fetched = {i: a for (i, _), a in zip(need, got)}
        parts = [fetched.get(i, c.host) for i, c in enumerate(self._chunks)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


class HostMirror:
    """Lazy host facade of a device-born :class:`DeviceColumn`.

    Lives in ``DataFrame._columns`` where a plain ndarray would. Shape/dtype
    queries are free; the first *data* access (indexing, ``np.asarray``,
    iteration) pulls the column to host exactly once, counted as a
    ``site="materialize"`` d2h plus a ``host_materializations`` increment —
    so a stage that quietly round-trips shows up in the metrics.
    """

    __slots__ = ("_dcol", "_arr")

    def __init__(self, dcol: DeviceColumn):
        self._dcol = dcol
        self._arr: Optional[np.ndarray] = None

    @property
    def source(self) -> DeviceColumn:
        return self._dcol

    def fetch(self, site: str = "materialize") -> np.ndarray:
        if self._arr is None:
            M_MATERIALIZE.inc(1, op=site)
            self._arr = self._dcol.to_host(site=site)
        return self._arr

    def materialize(self) -> np.ndarray:
        return self.fetch("materialize")

    # -- array-protocol surface (free) --------------------------------------
    def __len__(self) -> int:
        return self._dcol.nrows

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._dcol.shape

    @property
    def ndim(self) -> int:
        return len(self._dcol.shape)

    @property
    def dtype(self) -> np.dtype:
        return host_dtype(self._dcol.dtype)

    @property
    def nbytes(self) -> int:
        return self._dcol.nbytes

    # -- data access (counted, materializes once) ---------------------------
    def __getitem__(self, key):
        return self.materialize()[key]

    def __iter__(self):
        return iter(self.materialize())

    def __array__(self, dtype=None, copy=None):
        arr = self.materialize()
        return np.asarray(arr, dtype=dtype) if dtype is not None else arr

    def __repr__(self) -> str:
        state = "materialized" if self._arr is not None else "device"
        return (f"HostMirror({self._dcol.shape}, {self._dcol.dtype}, "
                f"{state})")
