"""BatchRunner — the device feed/drain pipeline of the graph runners
(counterpart of ``mmlspark_tpu/models/runner.py``).

One partition's rows go through a graph in padded batches:

* **prefetch** — coerce/pad of batch k+1 runs on a background worker
  (:class:`~..stages.batching.PrefetchIterator`), bounded by
  ``prefetch_depth`` prepared batches of host memory, into pinned staging
  slabs (:class:`StagingSlabPool`);
* **async feed** — on the card each slab is copied to the device with
  ``non_blocking`` on a side stream, which the compute stream waits for
  by event, so the copy of batch k overlaps the compute of batch k-1; a
  slab returns to its pool only once its copy has completed;
* **one drain** — each batch's outputs are copied into pinned host
  buffers with ``non_blocking`` as soon as the batch is issued, and the
  host waits once, at the partition's end (the JAX package's
  ``copy_to_host_async`` plus one ``device_get``).

A resident input (a ``torch.Tensor`` feed: a slice of a device column)
is padded on its device and moves no bytes. Every stage is counted in
:class:`~..ops.compile_cache.StageCounters` (coerce / pad / h2d /
dispatch / d2h).

Tuning: every batch is noted per padded bucket (rows, batches, seconds,
prep seconds) and the drain harvests the samples into the observation
store under ``model_sig`` (:func:`~..tuning.observations.harvest_samples`);
with ``tuning="auto"`` the first run consults the store through
:func:`~..tuning.cost_model.resolve_tuning` and applies its pick. The
port runs no compile step, so a sample's ``compiles`` is always 0.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.residency import is_device_array, record_hit
from ..observability import tracing as _tracing
from ..observability.registry import counter as _metric_counter
from ..ops.compile_cache import StageCounters
from ..ops.padding import bucket_size, pad_axis, pad_axis_device
from ..stages.batching import PrefetchIterator, batch_slices

__all__ = ["BatchRunner", "StagingSlabPool"]

M_SLAB_ALLOCS = _metric_counter(
    "mmlspark_staging_slab_allocs_total",
    "host staging slabs allocated (first touch of a shape/dtype signature)")
M_SLAB_REUSE = _metric_counter(
    "mmlspark_staging_slab_reuse_total",
    "host staging slab acquisitions served from the pool")


class StagingSlabPool:
    """Reusable pinned host staging buffers for the coerce/pad worker.

    A slab is a pinned (page-locked) CPU tensor, filled through its numpy
    view, so the device copy out of it runs asynchronously at the link's
    rate. At most ``depth`` free slabs per (shape, dtype) signature are
    retained; shape bucketing keeps the signature set tiny, so steady
    state allocates nothing. ``pin=False`` makes plain slabs (the CPU
    device needs no pinning).
    """

    def __init__(self, depth: int = 2, pin: bool = True):
        self.depth = max(1, int(depth))
        self.pin = bool(pin)
        self._lock = threading.Lock()
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._issued: set = set()
        self.allocs = 0
        self.reuses = 0

    def acquire(self, shape, dtype) -> torch.Tensor:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            free = self._free.get(key)
            if free:
                buf = free.pop()
                self.reuses += 1
                M_SLAB_REUSE.inc()
            else:
                buf = torch.empty(key[0], dtype=torch.from_numpy(
                    np.zeros(0, dtype)).dtype, pin_memory=self.pin)
                self.allocs += 1
                M_SLAB_ALLOCS.inc()
            self._issued.add(id(buf))
        return buf

    def release(self, buf) -> bool:
        """Return a slab to the pool; silently ignores foreign buffers, so
        callers can release every feed they dispatched."""
        if not isinstance(buf, torch.Tensor):
            return False
        with self._lock:
            if id(buf) not in self._issued:
                return False
            self._issued.discard(id(buf))
            key = (tuple(buf.shape), buf.numpy().dtype.str)
            free = self._free.setdefault(key, [])
            if len(free) < self.depth:
                free.append(buf)
            return True

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.allocs + self.reuses
            return {"allocs": self.allocs, "reuses": self.reuses,
                    "reuse_rate": (self.reuses / total) if total else None}


class BatchRunner:
    """Run one partition's rows through a graph in padded batches.

    ``coerce(sl) -> {feed name: host ndarray or device tensor}`` is the
    model-specific part (column lookup, dtype coercion, reshape);
    everything downstream — padding, transfer, dispatch, drain,
    instrumentation — is shared. ``fn(params, feeds) -> {col: tensor}``
    runs on ``device``.
    """

    def __init__(self, fn: Callable, params,
                 coerce: Callable[[slice], Dict[str, object]],
                 device: torch.device, shards: int = 1,
                 mini_batch_size: int = 64, prefetch_depth: int = 2,
                 counters: Optional[StageCounters] = None,
                 staging: Optional[StagingSlabPool] = None,
                 buckets: Optional[Tuple[int, ...]] = None,
                 tuning: str = "", model_sig: Optional[str] = None,
                 placement_key: str = "default"):
        self.fn = fn
        self.params = params
        self.coerce = coerce
        self.device = device
        self.shards = max(1, int(shards))
        self.mini_batch_size = max(1, int(mini_batch_size))
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.counters = counters if counters is not None else StageCounters()
        # model-owned so slabs amortize across transform calls, not just
        # batches of one partition
        self.staging = staging
        # custom padding-bucket ladder (None = power-of-two default); the
        # ladder must cover the largest batch the runner can produce
        self.buckets = (None if not buckets
                        else tuple(sorted({int(b) for b in buckets})))
        if self.buckets and self.mini_batch_size > self.buckets[-1]:
            raise ValueError(
                f"mini_batch_size={self.mini_batch_size} exceeds the "
                f"largest bucket {self.buckets[-1]} of the ladder")
        if tuning not in ("", "auto"):
            raise ValueError(f"tuning must be '' or 'auto', got {tuning!r}")
        self.tuning = tuning
        self.model_sig = model_sig
        self.placement_key = str(placement_key)
        self._tuned = False           # "auto" resolved the store already
        self.decision = None          # the applied TuningDecision, if any
        self._samples: Dict[int, Dict[str, float]] = {}

    # -- tuning: consult the observation store, harvest samples back ---------
    def _resolve_auto(self, n_rows: int) -> None:
        """``tuning="auto"``: on the first run, fit the observation store
        for this model signature and apply the picked config. A cold store
        is not an error: the defaults stand and this run's harvest becomes
        the data a later process decides from."""
        self._tuned = True
        from ..tuning.cost_model import resolve_tuning
        decision = resolve_tuning(
            self.model_sig or "anonymous", self.placement_key,
            {int(n_rows): 1},
            defaults=(self.mini_batch_size, self.prefetch_depth))
        if decision is None:
            return
        self.decision = decision
        self.mini_batch_size = max(1, decision.mini_batch_size)
        self.prefetch_depth = max(0, decision.prefetch_depth)
        self.buckets = decision.buckets

    def _note_sample(self, padded: int, b: int, *, seconds: float,
                     prep_seconds: float) -> None:
        s = self._samples.setdefault(
            int(padded), {"rows": 0, "batches": 0, "seconds": 0.0,
                          "prep_seconds": 0.0, "compile_seconds": 0.0,
                          "compiles": 0})
        s["rows"] += int(b)
        s["batches"] += 1
        s["seconds"] += float(seconds)
        s["prep_seconds"] += float(prep_seconds)

    def _flush_samples(self) -> None:
        """Emit the accumulated per-bucket samples as observations (at
        drain time, as the JAX package's runner does)."""
        if not self._samples or self.model_sig is None:
            self._samples.clear()
            return
        from ..tuning.observations import harvest_samples
        samples = [dict(bucket=k, **v)
                   for k, v in sorted(self._samples.items())]
        self._samples.clear()
        harvest_samples(
            self.model_sig, self.placement_key,
            {"mini_batch_size": self.mini_batch_size,
             "prefetch_depth": self.prefetch_depth,
             "buckets": None if self.buckets is None else list(self.buckets)},
            samples)

    # -- host side: coerce + pad (runs on the prefetch worker) ---------------
    def _prepare(self, sl: slice):
        """``(padded feeds, names fed from device tensors, rows, padded
        rows, prep seconds)`` of one batch."""
        c = self.counters
        t_prep = time.perf_counter()
        with c.timer("coerce"):
            feeds = self.coerce(sl)
        b = padded = 0
        resident = set()
        with c.timer("pad"):
            padded_feeds = {}
            for name, arr in feeds.items():
                b = len(arr)
                padded = bucket_size(b, self.buckets)
                padded = -(-padded // self.shards) * self.shards
                if is_device_array(arr):
                    # device feed (resident column slice): pad on device,
                    # nothing crosses the link
                    padded_feeds[name] = pad_axis_device(arr, padded)
                    resident.add(name)
                elif self.staging is not None:
                    buf = self.staging.acquire((padded,) + arr.shape[1:],
                                               arr.dtype)
                    view = buf.numpy()
                    view[:b] = arr
                    if padded > b:
                        view[b:] = 0
                    padded_feeds[name] = buf
                else:
                    padded_feeds[name] = pad_axis(arr, padded)
        return (padded_feeds, resident, b, padded,
                time.perf_counter() - t_prep)

    def _prepared_batches(self, n_rows: int):
        slices = batch_slices(n_rows, self.mini_batch_size)
        if self.prefetch_depth > 0 and len(slices) > 1:
            # batch k+1's coerce/pad overlaps batch k's h2d + dispatch; the
            # depth bound caps host memory at that many prepared batches.
            # The worker thread starts with an empty context: propagate()
            # carries the active trace and SpanTracer across
            prepare = _tracing.propagate(self._prepare)
            return PrefetchIterator((prepare(sl) for sl in slices),
                                    depth=self.prefetch_depth)
        return (self._prepare(sl) for sl in slices)

    # -- device side: feed, dispatch, overlapped drain -----------------------
    def run(self, n_rows: int, to_host: bool = False
            ) -> List[Tuple[dict, int]]:
        """Issue every minibatch; returns [(outputs, valid rows)].

        CUDA launches return before the device finishes, so the loop does
        not wait for compute. With ``to_host`` each batch's outputs start
        their copy into pinned host buffers right after the batch is
        issued (bfloat16 widened to float32 first); :meth:`drain` waits for
        them once. Without it the outputs stay on the device.
        """
        c = self.counters
        if self.tuning == "auto" and not self._tuned:
            self._resolve_auto(n_rows)
        cuda = self.device.type == "cuda"
        compute = torch.cuda.current_stream(self.device) if cuda else None
        copier = torch.cuda.Stream(self.device) if cuda else None
        pending: List[Tuple[dict, int]] = []
        batches = self._prepared_batches(n_rows)
        # prefetch_wait: time the dispatch thread blocks on the coerce/pad
        # worker — zero when host prep fully overlaps device work
        prefetching = isinstance(batches, PrefetchIterator)
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            try:
                feeds_host, device_fed, b, padded, prep_s = next(it)
            except StopIteration:
                break
            if prefetching:
                c.add("prefetch_wait", time.perf_counter() - t0)
            if device_fed:
                record_hit(len(device_fed))
            host_fed = {k: v for k, v in feeds_host.items()
                        if k not in device_fed}
            nbytes = sum(int(v.nbytes) for v in host_fed.values())
            copied = None
            with c.timer("h2d", nbytes):
                feeds = {k: feeds_host[k] for k in device_fed}
                for k, v in host_fed.items():
                    t = v if isinstance(v, torch.Tensor) \
                        else torch.from_numpy(np.ascontiguousarray(v))
                    if cuda:
                        with torch.cuda.stream(copier):
                            feeds[k] = t.to(self.device, non_blocking=True)
                    else:
                        # a copy, so that no output aliases a slab that is
                        # about to be reused
                        feeds[k] = t.clone()
                if cuda and host_fed:
                    copied = torch.cuda.Event()
                    copied.record(copier)
                    compute.wait_event(copied)
                    for k in host_fed:
                        feeds[k].record_stream(compute)
            t0 = time.perf_counter()
            outs = self.fn(self.params, feeds)
            elapsed = time.perf_counter() - t0
            c.add("dispatch", elapsed)
            self._note_sample(padded, b, seconds=elapsed, prep_seconds=prep_s)
            if self.staging is not None:
                # a slab may only circulate once its copy has finished
                # reading it: wait on the copy (not the compute)
                if copied is not None:
                    copied.synchronize()
                for v in host_fed.values():
                    self.staging.release(v)
            if to_host:
                outs = {k: _start_d2h(v) for k, v in outs.items()}
            pending.append((outs, b))
        return pending

    def drain(self, pending: List[Tuple[dict, int]]
              ) -> List[Tuple[Dict[str, np.ndarray], int]]:
        """Wait once for every pending output copy; returns host arrays.
        The wait includes whatever compute is still running, so ``d2h``
        seconds are where the device time of a host-fed run settles; they
        are spread over the buckets' samples by row share before the
        samples are harvested."""
        if not pending:
            self._flush_samples()
            return []
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        host = [{k: v.numpy() for k, v in outs.items()} for outs, _ in pending]
        nbytes = sum(a.nbytes for outs in host for a in outs.values())
        elapsed = time.perf_counter() - t0
        self.counters.add("d2h", elapsed, nbytes)
        total_rows = sum(s["rows"] for s in self._samples.values()) or 1
        for s in self._samples.values():
            s["seconds"] += elapsed * (s["rows"] / total_rows)
        self._flush_samples()
        return [(outs, b) for outs, (_, b) in zip(host, pending)]

    def run_and_drain(self, n_rows: int
                      ) -> List[Tuple[Dict[str, np.ndarray], int]]:
        return self.drain(self.run(n_rows, to_host=True))


def _start_d2h(t: torch.Tensor) -> torch.Tensor:
    """Start ``t``'s copy to the host: into a pinned buffer with
    ``non_blocking`` on the card (completed by the drain's one wait), a
    detached view on the CPU. bfloat16 widens to float32 first."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.device.type != "cuda":
        return t.detach()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    return buf
