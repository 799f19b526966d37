"""Profiling: torch.profiler traces, stage annotations, and a host-side
span tracer exporting Chrome trace format.

The reference has no tracer — only ad-hoc ``StopWatch``/``Timer`` timings
(SURVEY.md §5). Two replacements:

* device side — ``torch.profiler``: :func:`trace` captures a Chrome
  trace of host and CUDA activity (the hand-written kernels appear by
  their symbols) and :func:`annotate` scopes host work as a
  ``record_function`` range so stage names appear on the timeline.
* host side — :class:`SpanTracer`: nested spans (pipeline → stage →
  partition) recorded per thread and exported as ``chrome://tracing`` /
  Perfetto JSON, so a whole pipeline run is inspectable without
  TensorBoard. :func:`span` writes to the installed tracer (no-op when
  none), so library code can annotate unconditionally.

Installation is **contextvars-based** (observability/tracing.py): the
active tracer rides the context, so worker threads entered through
``tracing.propagate`` inherit it, and :func:`span` additionally records
into the active request trace when one exists — the Chrome-trace,
Prometheus, and /debug/traces views of the same run agree.

The port's copy of ``mmlspark_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch
from torch._C._profiler import _ExperimentalConfig

__all__ = ["trace", "annotate", "StopWatch", "SpanTracer", "span",
           "TRACE_FILE"]

from ..observability import histogram as _metric_histogram
from ..observability import tracing as _tracing
from .shared import StopWatch  # re-export: the reference-style wall timer

#: the Chrome-trace file :func:`trace` writes inside its ``log_dir``
TRACE_FILE = "trace.json"


_M_SPANS = _metric_histogram(
    "mmlspark_span_seconds",
    "Closed SpanTracer spans, mirrored from the Chrome-trace view when the "
    "tracer is built with mirror_metrics=True", ("name",))


class SpanTracer:
    """Collect nested host-side spans; export Chrome trace JSON.

    >>> with SpanTracer() as t:
    ...     with span("fit"):
    ...         with span("stage:LightGBMClassifier"):
    ...             ...
    >>> t.export("run.trace.json")   # open in chrome://tracing / Perfetto

    ``mirror_metrics=True`` additionally observes every closed span into
    the ``mmlspark_span_seconds{name=...}`` histogram, so the Chrome-trace
    and Prometheus views of a run agree.
    """

    def __init__(self, mirror_metrics: bool = False):
        self._events = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._tids: dict = {}  # thread ident → small sequential track id
        self._mirror = bool(mirror_metrics)

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    # -- recording ----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **args):
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                # bounded by the tracer's `with` block, not process
                # lifetime: events are exported/discarded on exit — not a
                # live history (that's observability.timeseries)
                # tpulint: disable=TPU024
                self._events.append({
                    "name": name, "ph": "X", "pid": 0,
                    "tid": self._tid(),
                    "ts": (start - self._t0) * 1e6,
                    "dur": (end - start) * 1e6,
                    **({"args": args} if args else {})})
            if self._mirror:
                _M_SPANS.observe(end - start, name=name)

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "SpanTracer":
        # contextvars install (was threading.local): child contexts — and
        # workers entered via tracing.propagate — see this tracer; a
        # concurrent tracer in an unrelated context still can't cross-record
        self._token = _tracing.install_tracer(self)
        return self

    def __exit__(self, *exc) -> None:
        _tracing.uninstall_tracer(self._token)

    # -- inspection / export -------------------------------------------------
    @property
    def events(self):
        with self._lock:
            return list(self._events)

    def total(self, name: str) -> float:
        """Total seconds spent in spans with this name."""
        return sum(e["dur"] for e in self.events
                   if e["name"] == name) / 1e6

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events,
                       "displayTimeUnit": "ms"}, f)
        return path


def span(name: str, **args):
    """Span on the context's active :class:`SpanTracer` AND the active
    request trace (observability/tracing.py), plus a device-timeline
    annotation; cheap no-op when neither is installed.

    Worker threads spawned inside a traced region inherit both through
    ``tracing.propagate`` — wrap the worker's callable at submission time
    (models/runner.py does this for the prefetch worker, core/dataframe.py
    for the partition pool) and spans opened there land in the parent
    trace. The old ``threading.local`` dead-end (workers recording into
    the void) is gone."""
    tracer = _tracing.installed_tracer()
    in_trace = _tracing.current_span() is not None
    if tracer is None and not in_trace:
        return annotate(name)
    stack = contextlib.ExitStack()
    if tracer is not None:
        stack.enter_context(tracer.span(name, **args))
    if in_trace:
        stack.enter_context(_tracing.start_span(name, **args))
    stack.enter_context(annotate(name))
    return stack


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of host and CUDA activity into
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing,
    Perfetto). Yields the profiler; the file is written on exit.

    Every thread's operators and :func:`annotate` ranges are recorded, not
    only the caller's: ``/debug/profile`` captures from its own thread
    while the engine's thread does the work."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=every_thread) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named ``record_function`` range on the profiler timeline. Costs one
    flag check when no profiler runs (the decode tick calls it per chunk):
    a shared no-op context then."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
