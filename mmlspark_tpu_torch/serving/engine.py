"""The serving loop: drain requests → transform → route replies.

Parity: the continuous-mode request lifecycle of the reference
(SURVEY.md §3.3): requests park in the worker server, a reader turns them
into rows, the user pipeline computes a reply column, the sink routes
replies back, and each drained batch closes an epoch. The reference spreads
this across Spark's continuous-processing engine; here it is an explicit
background loop per host — the pipeline's ``transform`` still executes on
the card through the normal batching layer, so served traffic gets the same
large static-shape device batches as offline scoring.

The port's copy of ``mmlspark_tpu/serving/engine.py``.
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from ..core.dataframe import DataFrame
from ..observability import (counter as _metric_counter,
                             histogram as _metric_histogram)
from ..observability import tracing as _tracing
from ..reliability import get_injector as _get_injector
from ..reliability import record_retry as _record_retry
from .registry import get_registry as _get_registry
from .server import WorkerServer
from .source import HTTPSink, HTTPSource, parse_request

__all__ = ["ServingEngine"]

_log = logging.getLogger("mmlspark_tpu_torch.serving")

_M_BATCH_ROWS = _metric_histogram(
    "mmlspark_serving_batch_rows",
    "Rows per drained serving batch (how well traffic coalesces)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
_M_BATCH_SECONDS = _metric_histogram(
    "mmlspark_serving_batch_seconds",
    "Wall-clock per drained batch: parse + transform + reply routing")
_M_BATCH_ERRORS = _metric_counter(
    "mmlspark_serving_batch_errors_total",
    "Serving batches whose transform raised (every row answered 500)")


class ServingEngine:
    """Run ``transform_fn`` (typically ``pipeline_model.transform``) over
    incoming HTTP requests.

    ``schema`` maps JSON body fields to column types; ``reply_col`` names the
    column whose values are JSON-encoded back to the caller.

    ``warm_up`` is the pre-serve compile hook: a zero-arg callable (typically
    ``model.warm_up`` or a ``functools.partial`` over it) invoked in
    :meth:`start` before any dispatcher thread begins draining requests, so
    the first request of each padding bucket never eats an XLA compile stall.
    A warm-up failure is logged, not fatal — serving starts cold rather than
    not at all.

    Multi-model dispatch: ``transform_fn`` may also be a dict mapping model
    NAME → transform. Requests carrying ``X-Mmlspark-Model`` resolve to a
    ``name@version`` through the :class:`~.registry.ModelRegistry` at
    ingest; each drained batch is then grouped by resolved version and each
    group dispatched to that version's registered handle (so a canary or
    shadow version actually exercises its own code), falling back to the
    dict entry for the name, then to ``"default"``. Versions are registered
    via :meth:`register_model` (which delegates to the process-global
    registry and runs the version's warm-up before it becomes routable).
    """

    def __init__(self, transform_fn: Callable[[DataFrame], DataFrame],
                 schema: Optional[Dict[str, type]] = None,
                 reply_col: str = "reply",
                 host: str = "127.0.0.1", port: int = 0, api_path: str = "/",
                 max_batch: int = 1024, poll_timeout: float = 0.05,
                 reply_timeout: float = 60.0, n_dispatchers: int = 1,
                 journal_path: Optional[str] = None,
                 transport: str = "threaded",
                 warm_up: Optional[Callable[[], object]] = None,
                 device_ingest: Optional[list] = None,
                 tuning: str = "", tuned_models: Optional[list] = None):
        self.transform_fn = transform_fn
        self.warm_up = warm_up
        if tuning not in ("", "auto"):
            raise ValueError(f"tuning must be '' or 'auto', got {tuning!r}")
        #: "auto" switches every model in ``tuned_models`` to store-driven
        #: tuning before warm-up, so the served pipeline runs (and its
        #: warm-up runs) the measured config, not the param defaults
        self.tuning = tuning
        self.tuned_models = list(tuned_models or [])
        self.schema = schema
        self.reply_col = reply_col
        #: columns staged device-resident right after parse, so every stage
        #: of the served pipeline reads them on device and the batch pays
        #: one ingest h2d total. DataFrame.device_put is idempotent: a batch
        #: whose inputs are already resident counts residency hits and is
        #: NOT re-staged.
        self.device_ingest = list(device_ingest or [])
        self.max_batch = max_batch
        self.poll_timeout = poll_timeout
        #: >1 overlaps batch formation/parse of one batch with the
        #: transform of another — the single-loop engine serialized them
        #: (the concurrency the reference gets from parallel Spark tasks)
        self.n_dispatchers = max(1, int(n_dispatchers))
        self.server = WorkerServer(host, port, api_path,
                                   reply_timeout=reply_timeout,
                                   journal_path=journal_path,
                                   transport=transport)
        self.source = HTTPSource(self.server)
        self.sink = HTTPSink(self.server, reply_col=self.reply_col)
        self._stop = threading.Event()
        self._threads: list = []

    @property
    def address(self) -> str:
        return self.server.address

    def register_model(self, name: str, version: str,
                       transform_fn: Callable[[DataFrame], DataFrame],
                       warm_up: Optional[Callable[[], object]] = None,
                       **kwargs):
        """Register ``name@version`` with the process-global registry,
        using ``transform_fn`` as the version's handle — the per-version
        dispatch target for batches this engine drains. Keyword args
        (``canary_percent``, ``shadow_percent``, ``block``, ...) pass
        through to :meth:`~.registry.ModelRegistry.load`."""
        return _get_registry().load(name, version, handle=transform_fn,
                                    warm_up=warm_up, **kwargs)

    def _dispatch_groups(self, parsed: DataFrame, ids):
        """Split a drained batch by resolved model version. Returns
        ``[(fn, sub_parsed, sub_ids), ...]``; ``fn`` is None for rows
        naming a model nothing serves (answered 404 by the caller). The
        single-model fast path (plain callable, no versioned rows) is a
        single zero-copy group."""
        labels = [self.server.model_label(r) for r in ids]
        if not isinstance(self.transform_fn, dict) \
                and not any(labels):
            return [(self.transform_fn, parsed, ids)]
        registry = _get_registry()
        fns: Dict[int, object] = {}
        rows: Dict[int, list] = {}
        for i, label in enumerate(labels):
            fn = None
            if label:
                handle = registry.handle_for(label)
                if callable(handle):
                    fn = handle
            if fn is None:
                name = (label or "default").partition("@")[0]
                if isinstance(self.transform_fn, dict):
                    fn = (self.transform_fn.get(name)
                          or self.transform_fn.get("default"))
                else:
                    fn = self.transform_fn
            key = id(fn)
            fns[key] = fn
            rows.setdefault(key, []).append(i)
        return [(fns[key],
                 parsed.take(idxs),
                 [ids[i] for i in idxs])
                for key, idxs in rows.items()]

    def start(self) -> "ServingEngine":
        if self.tuning == "auto":
            for m in self.tuned_models:
                try:
                    m.set(tuning="auto")
                except Exception:
                    _log.error("model %r rejected tuning='auto':\n%s",
                               getattr(m, "uid", m), traceback.format_exc())
        if self.warm_up is not None:
            try:
                self.warm_up()
            except Exception:
                _log.error("pre-serve warm-up failed (serving starts cold):"
                           "\n%s", traceback.format_exc())
        for i in range(self.n_dispatchers):
            t = threading.Thread(
                target=self._loop, daemon=True,
                name=f"serving-engine-{self.server.port}-{i}")
            t.start()
            self._threads.append(t)
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            df = self.source.read_batch(self.max_batch, self.poll_timeout)
            if len(df) == 0:
                continue
            ids = df["id"]
            _M_BATCH_ROWS.observe(len(df))
            # a drained batch coalesces many requests; the batch's spans
            # attach under the FIRST traced request's root (one concrete
            # trace showing the whole batch beats N duplicated subtrees),
            # with the co-batched count recorded as an attribute
            root = next((s for s in (self.server.trace_span(r) for r in ids)
                         if s is not None), None)
            t0 = time.perf_counter()
            with _tracing.activate(root), \
                    _tracing.start_span("engine.batch", rows=len(df)):
                try:
                    parsed = parse_request(df, self.schema)
                except Exception:
                    _M_BATCH_ERRORS.inc()
                    _tracing.add_event("batch_error", stage="parse")
                    _log.error("serving batch parse failed:\n%s",
                               traceback.format_exc())
                    for rid in ids:
                        self.server.reply_json(
                            rid, {"error": "internal error"}, status=500)
                    _M_BATCH_SECONDS.observe(time.perf_counter() - t0)
                    self.server.commit_epoch()
                    continue
                parsed = self._stage_ingest(parsed)
                for fn, sub, sub_ids in self._dispatch_groups(parsed, ids):
                    if fn is None:
                        for rid in sub_ids:
                            self.server.reply_json(
                                rid, {"error": "unknown model"},
                                status=404)
                        continue
                    if not self._run_batch(sub, sub_ids, fn):
                        # graceful degradation: a whole-batch failure is
                        # often OOM-shaped (too many rows in one device
                        # batch) — retry ONCE at half size before failing
                        # rows individually
                        if len(sub_ids) > 1:
                            mid = (len(sub_ids) + 1) // 2
                            splits = ((range(0, mid), sub_ids[:mid]),
                                      (range(mid, len(sub_ids)),
                                       sub_ids[mid:]))
                            for rows, half_ids in splits:
                                _record_retry("engine_batch", 1, 0.0,
                                              "batch_error")
                                if not self._run_batch(sub.take(rows),
                                                       half_ids, fn):
                                    self._fail_rows(half_ids)
                        else:
                            self._fail_rows(sub_ids)
                _M_BATCH_SECONDS.observe(time.perf_counter() - t0)
            self.server.commit_epoch()

    def _stage_ingest(self, parsed: DataFrame) -> DataFrame:
        """Stage ``device_ingest`` columns once per batch (idempotent:
        already-resident inputs count hits and move no bytes); a staging
        failure degrades to host-fed serving rather than failing the
        batch."""
        names = [c for c in self.device_ingest if c in parsed]
        if not names:
            return parsed
        try:
            return parsed.device_put(names)
        except Exception:
            _log.error("device ingest staging failed (host-fed batch):\n%s",
                       traceback.format_exc())
            return parsed

    def _fail_rows(self, ids) -> None:
        for rid in ids:
            self.server.reply_json(rid, {"error": "internal error"},
                                   status=500)

    def _run_batch(self, parsed: DataFrame, ids,
                   transform_fn: Optional[Callable] = None) -> bool:
        """Transform + route one (sub-)batch; False when the transform or
        sink raised (rows unanswered — the caller decides retry vs 500).
        ``transform_fn`` overrides the engine default (per-version
        dispatch)."""
        try:
            injector = _get_injector()
            if injector.enabled:
                injector.fire("device_run")
            fn = transform_fn if transform_fn is not None \
                else self.transform_fn
            out = fn(parsed)
            self.sink.write_batch(out)
            # rows the transform dropped (filters etc.) must still be
            # answered, or their CachedRequests leak in the routing table
            surviving = set(out["id"]) if "id" in out else set()
            for rid in ids:
                if rid not in surviving:
                    self.server.reply_json(
                        rid, {"error": "row dropped by pipeline"},
                        status=400)
            return True
        except Exception:
            _M_BATCH_ERRORS.inc()
            _tracing.add_event("batch_error", rows=len(ids))
            _log.error("serving batch failed:\n%s", traceback.format_exc())
            return False

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self.server.close()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
