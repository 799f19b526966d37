"""Request-scoped tracing: contextvars span trees, W3C traceparent, and a
bounded in-memory flight recorder.

Aggregate metrics (registry.py) answer "how slow is the p99?"; this module
answers "why was *this* request slow?" — the Dapper-style question. One
request = one trace: the serving transport opens a root span (ingesting an
inbound ``traceparent`` header so external callers correlate), every layer
underneath attaches child spans and span events (cache hit/miss, recompile,
pad-bucket chosen), and the completed tree lands in the flight recorder,
browsable at ``GET /debug/traces``.

Design constraints, matching the rest of observability/:

- **pure stdlib** — importable before torch; no I/O on the hot path.
- **contextvars, not threading.local** — the serving plane hops threads
  constantly (transport → dispatcher → prefetch worker → partition pool);
  a context is captured once with :func:`propagate` and re-installed in the
  worker, so spans opened there land in the right trace. The same
  ContextVar carries the installed ``SpanTracer`` (utils/profiling.py).
- **cheap when idle** — with no active trace, ``start_span`` returns an
  inert context manager and ``add_event`` is a dict lookup + None check;
  traces are only ever minted explicitly (:func:`start_trace`).
- **bounded** — traces cap their span/event counts, and the flight
  recorder keeps a ring of the last N traces plus an always-keep set for
  requests over the slow threshold, so memory is finite by construction.

Exemplars: :func:`set_exemplars` installs :func:`current_trace_id` as the
registry's exemplar provider, so latency histogram observations made under
an active span carry the trace_id into the OpenMetrics exposition
(``# {trace_id="..."}``). Default OFF — the rendered /metrics text stays
byte-identical to plain Prometheus 0.0.4 unless explicitly enabled.

The port's copy of ``mmlspark_tpu/observability/tracing.py``.
"""

from __future__ import annotations

import contextvars
import functools
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

from . import registry as _registry

__all__ = [
    "Span",
    "Trace",
    "FlightRecorder",
    "new_trace_id",
    "new_span_id",
    "new_request_id",
    "parse_traceparent",
    "format_traceparent",
    "start_trace",
    "start_span",
    "activate",
    "add_event",
    "propagate",
    "current_span",
    "current_trace_id",
    "current_request_id",
    "install_tracer",
    "uninstall_tracer",
    "installed_tracer",
    "set_exemplars",
    "exemplars_enabled",
    "get_flight_recorder",
    "configure_recorder",
]

#: Hard cap on spans (and events per span) recorded into one trace — a
#: runaway loop attaching spans must degrade to a truncated trace, never
#: to unbounded memory. Drops are counted on the trace.
MAX_SPANS_PER_TRACE = 512
MAX_EVENTS_PER_SPAN = 64

#: The active span (one per logical request flow) and the installed
#: SpanTracer. contextvars so that ``contextvars.copy_context()`` captures
#: both in one shot for propagate(), and nested activations unwind
#: correctly on the same thread.
_SPAN: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "mmlspark_active_span", default=None)
_TRACER: "contextvars.ContextVar[Optional[object]]" = contextvars.ContextVar(
    "mmlspark_span_tracer", default=None)


# -- id minting (THE place request/trace/span ids come from: tpulint TPU008
# -- flags ad-hoc uuid4().hex minting elsewhere) ------------------------------
def new_trace_id() -> str:
    """128-bit lowercase-hex trace id (W3C trace-context format)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit lowercase-hex span id (W3C trace-context format)."""
    return os.urandom(8).hex()


def new_request_id() -> str:
    """Serving-plane request id — same 32-hex shape the routing table and
    journal always used, minted here so tracing and routing stay joined."""
    return os.urandom(16).hex()


# -- W3C traceparent ----------------------------------------------------------
def _is_hex(s: str) -> bool:
    return bool(s) and all(c in "0123456789abcdef" for c in s)


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a ``traceparent`` header, or
    None when absent/malformed (per spec: a bad header starts a new trace,
    it never errors the request)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) \
            or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or span_id == "0" * 16:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return trace_id, span_id


def format_traceparent(span: "Span") -> str:
    """``00-{trace_id}-{span_id}-01`` for outbound hops / response echo."""
    return f"00-{span.trace_id}-{span.span_id}-01"


# -- span / trace data model --------------------------------------------------
class Span:
    """One timed operation inside a trace. End is idempotent — the first
    ``end()`` wins (a timed-out request later answered must not re-close
    its root), and ending the root hands the trace to the flight
    recorder."""

    __slots__ = ("trace", "name", "span_id", "parent_id", "attrs", "events",
                 "start_ts", "thread", "_start", "_dur")

    def __init__(self, name: str, trace: "Trace",
                 parent_id: Optional[str] = None,
                 attrs: Optional[dict] = None):
        self.trace = trace
        self.name = name
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.events: List[dict] = []
        self.start_ts = time.time()
        self.thread = threading.current_thread().name
        self._start = time.perf_counter()
        self._dur: Optional[float] = None

    @property
    def trace_id(self) -> str:
        return self.trace.trace_id

    @property
    def duration(self) -> Optional[float]:
        return self._dur

    @property
    def ended(self) -> bool:
        return self._dur is not None

    def event(self, name: str, **fields: object) -> None:
        """Attach a timestamped point event (cache miss, pad bucket, ...)."""
        with self.trace._lock:
            if len(self.events) >= MAX_EVENTS_PER_SPAN:
                self.trace.dropped += 1
                return
            self.events.append({
                "name": name, "ts": time.time(),
                **({"fields": fields} if fields else {})})

    def end(self, **attrs: object) -> bool:
        """Close the span; False when it was already closed (exactly-once).
        Ending the root span records the whole trace."""
        with self.trace._lock:
            if self._dur is not None:
                return False
            self._dur = time.perf_counter() - self._start
            if attrs:
                self.attrs.update(attrs)
        if self is self.trace.root:
            get_flight_recorder().record(self.trace)
        return True

    def to_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "trace_id": self.trace_id,
                "start_ts": self.start_ts, "duration_s": self._dur,
                "thread": self.thread, "attrs": dict(self.attrs),
                "events": list(self.events)}


class Trace:
    """All spans of one request, keyed by a W3C trace id."""

    def __init__(self, trace_id: str,
                 remote_parent_id: Optional[str] = None):
        self.trace_id = trace_id
        #: span id of the caller's span when the trace was ingested from an
        #: inbound traceparent — the upstream half lives in *their* tracer
        self.remote_parent_id = remote_parent_id
        self.root: Optional[Span] = None
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans: List[Span] = []

    def _add(self, span: Span) -> bool:
        with self._lock:
            if len(self._spans) >= MAX_SPANS_PER_TRACE:
                self.dropped += 1
                return False
            self._spans.append(span)
            return True

    @property
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    @property
    def duration(self) -> Optional[float]:
        return self.root.duration if self.root is not None else None

    def summary(self) -> dict:
        root = self.root
        return {"trace_id": self.trace_id,
                "name": root.name if root else None,
                "request_id": root.attrs.get("request_id") if root else None,
                "start_ts": root.start_ts if root else None,
                "duration_s": self.duration,
                "spans": len(self.spans),
                "dropped": self.dropped}

    def to_dict(self) -> dict:
        """Span TREE (children nested under parents) + the summary."""
        spans = self.spans
        nodes = {s.span_id: dict(s.to_dict(), children=[]) for s in spans}
        top: List[dict] = []
        for s in spans:
            parent = nodes.get(s.parent_id or "")
            (parent["children"] if parent is not None else top).append(
                nodes[s.span_id])
        return dict(self.summary(), roots=top)

    def to_chrome(self) -> dict:
        """Chrome-trace JSON — same shape ``SpanTracer.export`` writes, so
        one tooling path (chrome://tracing / Perfetto) reads both."""
        spans = self.spans
        t0 = min((s.start_ts for s in spans), default=0.0)
        threads: Dict[str, int] = {}
        events = []
        for s in spans:
            tid = threads.setdefault(s.thread, len(threads))
            events.append({
                "name": s.name, "ph": "X", "pid": 0, "tid": tid,
                "ts": (s.start_ts - t0) * 1e6,
                "dur": (s.duration or 0.0) * 1e6,
                "args": {**s.attrs, "span_id": s.span_id,
                         "trace_id": self.trace_id}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- context management -------------------------------------------------------
def start_trace(name: str, traceparent: Optional[str] = None,
                **attrs: object) -> Span:
    """Mint a root span (a new trace, or a continuation of the caller's
    trace when ``traceparent`` parses). NOT activated — pair with
    :func:`activate`, and close it explicitly with ``span.end()``."""
    parent = parse_traceparent(traceparent)
    if parent is not None:
        trace = Trace(parent[0], remote_parent_id=parent[1])
        root = Span(name, trace, parent_id=parent[1], attrs=attrs)
    else:
        trace = Trace(new_trace_id())
        root = Span(name, trace, attrs=attrs)
    trace.root = root
    trace._add(root)
    return root


class _Activation:
    """``with activate(span):`` — install without owning: the span is NOT
    ended on exit (roots end at reply time, on another thread)."""

    __slots__ = ("_span", "_token")

    def __init__(self, span: Optional[Span]):
        self._span = span
        self._token = None

    def __enter__(self) -> Optional[Span]:
        if self._span is not None:
            self._token = _SPAN.set(self._span)
        return self._span

    def __exit__(self, *exc: object) -> None:
        if self._token is not None:
            _SPAN.reset(self._token)


def activate(span: Optional[Span]) -> _Activation:
    """Make ``span`` the current span for the with-block (no-op on None)."""
    return _Activation(span)


class _SpanScope:
    """``with start_span(...):`` — child span owned by the block: activated
    on enter, ended (and deactivated) on exit."""

    __slots__ = ("_span", "_token")

    def __init__(self, span: Optional[Span]):
        self._span = span
        self._token = None

    def __enter__(self) -> Optional[Span]:
        if self._span is not None:
            self._token = _SPAN.set(self._span)
        return self._span

    def __exit__(self, *exc: object) -> None:
        if self._token is not None:
            _SPAN.reset(self._token)
        if self._span is not None:
            self._span.end()


def start_span(name: str, **attrs: object) -> _SpanScope:
    """Open a child of the current span for the with-block. Inert (yields
    None) when no trace is active — library code can call this
    unconditionally; cost outside a trace is one ContextVar read."""
    parent = _SPAN.get()
    if parent is None:
        return _SpanScope(None)
    child = Span(name, parent.trace, parent_id=parent.span_id, attrs=attrs)
    if not parent.trace._add(child):
        return _SpanScope(None)
    return _SpanScope(child)


def add_event(name: str, **fields: object) -> None:
    """Attach a point event to the current span; no-op outside a trace."""
    span = _SPAN.get()
    if span is not None:
        span.event(name, **fields)


def current_span() -> Optional[Span]:
    return _SPAN.get()


def current_trace_id() -> Optional[str]:
    span = _SPAN.get()
    return span.trace_id if span is not None else None


def current_request_id() -> Optional[str]:
    """The request id of the active trace (stamped on the root span by the
    serving transport), falling back to the active span's own attr."""
    span = _SPAN.get()
    if span is None:
        return None
    root = span.trace.root
    rid = root.attrs.get("request_id") if root is not None else None
    return rid if rid is not None else span.attrs.get("request_id")


def propagate(fn: Callable) -> Callable:
    """Capture the CURRENT context (active span + installed tracer + any
    other ContextVars) and re-install it around every call of ``fn``.

    The explicit bridge across thread hops: plain ``threading.Thread`` /
    pool workers start with an EMPTY context, so spans opened there would
    silently fall outside the trace. Wrap the worker's callable at
    submission time::

        prepare = propagate(self._prepare)      # dispatch thread, in-trace
        PrefetchIterator((prepare(sl) for sl in slices), depth=2)

    Unlike ``Context.run`` the captured context is re-entered by value
    (set/reset per call), so one wrapped fn is safe to call concurrently
    from many workers."""
    captured = contextvars.copy_context()

    @functools.wraps(fn)
    def wrapped(*args: object, **kwargs: object):
        tokens = [(var, var.set(value)) for var, value in captured.items()]
        try:
            return fn(*args, **kwargs)
        finally:
            for var, token in reversed(tokens):
                var.reset(token)

    return wrapped


# -- SpanTracer installation (utils/profiling.py) -----------------------------
def install_tracer(tracer: object) -> "contextvars.Token":
    """Install a ``SpanTracer``-shaped object (has a ``span(name, **args)``
    context manager) as the context's active tracer."""
    return _TRACER.set(tracer)


def uninstall_tracer(token: "contextvars.Token") -> None:
    try:
        _TRACER.reset(token)
    except ValueError:
        # token minted in another context (enter/exit crossed threads) —
        # clearing beats leaving a dead tracer installed forever
        _TRACER.set(None)


def installed_tracer() -> Optional[object]:
    return _TRACER.get()


# -- exemplars ----------------------------------------------------------------
def set_exemplars(enabled: bool) -> None:
    """Toggle OpenMetrics exemplars: when on, histogram observations made
    under an active span capture the trace_id, and the exposition appends
    ``# {trace_id="..."} value`` to their bucket lines. Default off —
    /metrics stays byte-identical to plain Prometheus 0.0.4 text."""
    _registry.set_exemplar_provider(current_trace_id if enabled else None)


def exemplars_enabled() -> bool:
    return _registry.exemplar_provider() is not None


# -- flight recorder ----------------------------------------------------------
class FlightRecorder:
    """Bounded store of completed request traces.

    Two tiers: a ring of the last ``capacity`` traces (anything), plus an
    always-keep set (capped at ``slow_keep``, oldest evicted) for traces
    whose root duration meets ``slow_threshold`` — so the one slow request
    from an hour ago is still there after the ring wrapped ten thousand
    fast ones."""

    def __init__(self, capacity: int = 64, slow_threshold: float = 1.0,
                 slow_keep: int = 32):
        self._lock = threading.Lock()
        self.configure(capacity=capacity, slow_threshold=slow_threshold,
                       slow_keep=slow_keep)

    def configure(self, capacity: Optional[int] = None,
                  slow_threshold: Optional[float] = None,
                  slow_keep: Optional[int] = None) -> "FlightRecorder":
        with self._lock:
            if capacity is not None:
                self._ring: "deque[Trace]" = deque(
                    getattr(self, "_ring", ()), maxlen=max(1, int(capacity)))
            if slow_threshold is not None:
                self._slow_threshold = float(slow_threshold)
            if slow_keep is not None:
                self._slow_keep = max(1, int(slow_keep))
                if not hasattr(self, "_slow"):
                    self._slow: "OrderedDict[str, Trace]" = OrderedDict()
        return self

    @property
    def slow_threshold(self) -> float:
        return self._slow_threshold

    def record(self, trace: Trace) -> None:
        dur = trace.duration
        with self._lock:
            if dur is not None and dur >= self._slow_threshold:
                self._slow[trace.trace_id] = trace
                self._slow.move_to_end(trace.trace_id)
                while len(self._slow) > self._slow_keep:
                    self._slow.popitem(last=False)
            else:
                self._ring.append(trace)

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            trace = self._slow.get(trace_id)
            if trace is not None:
                return trace
            for t in self._ring:
                if t.trace_id == trace_id:
                    return t
        return None

    def traces(self) -> List[Trace]:
        """Newest first; slow-kept traces listed ahead of the ring."""
        with self._lock:
            slow = list(self._slow.values())
            ring = [t for t in self._ring if t.trace_id not in self._slow]
        return list(reversed(slow)) + list(reversed(ring))

    def summaries(self) -> List[dict]:
        return [t.summary() for t in self.traces()]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slow.clear()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


_RECORDER = FlightRecorder(
    capacity=_env_int("MMLSPARK_TPU_TRACE_RING", 64),
    slow_threshold=_env_float("MMLSPARK_TPU_TRACE_SLOW_SECONDS", 1.0),
    slow_keep=_env_int("MMLSPARK_TPU_TRACE_SLOW_KEEP", 32))


def get_flight_recorder() -> FlightRecorder:
    return _RECORDER


def configure_recorder(capacity: Optional[int] = None,
                       slow_threshold: Optional[float] = None,
                       slow_keep: Optional[int] = None) -> FlightRecorder:
    """Adjust the process-global recorder's knobs (tests, ops tuning)."""
    return _RECORDER.configure(capacity=capacity,
                               slow_threshold=slow_threshold,
                               slow_keep=slow_keep)
