"""Process-global metrics registry: Counter, Gauge, Histogram with labels
(the port's copy of ``mmlspark_tpu/observability/registry.py``).

The unified telemetry substrate for the whole package — `StageCounters`
(ops/compile_cache.py), `_PhaseProf` (models/gbdt/train.py) and
`SpanTracer` (utils/profiling.py) all mirror into it, and the serving
plane scrapes it at ``GET /metrics`` (see serving/server.py). Design
constraints, in order:

- **pure stdlib** — no prometheus_client; the container has no network.
- **default-on** — an update on a cached series is one small lock plus a
  float add (~100 ns); nothing here may touch torch, numpy or I/O.
- **process-global** — one registry per process (`get_registry()`), so a
  metric registered at import time in ops/ is visible to a scrape served
  from serving/ without any plumbing.
- **resettable** — tests call `reset_all()`; metric *objects* held by
  modules stay valid (only their series are cleared), so import-time
  registration and per-test isolation coexist.
- **snapshot-able** — `snapshot()` returns a plain JSON-safe dict for
  bench.py's one-shot reporter; `render()` returns Prometheus text.
"""

from __future__ import annotations

import bisect
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS",
    "get_registry",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "render",
    "reset_all",
    "set_exemplar_provider",
    "exemplar_provider",
    "build_info",
    "process_uptime_seconds",
]

#: Wall-clock at first observability import — the process-uptime epoch
#: reported by /healthz (observability is imported at package import, so
#: this tracks process age for any consumer of the package).
_PROCESS_START = time.time()

#: When set (tracing.set_exemplars), histogram observations call this to
#: capture the active trace_id as an OpenMetrics exemplar. None (the
#: default) keeps observe() exemplar-free and the exposition byte-identical
#: to plain Prometheus 0.0.4 text.
_EXEMPLAR_PROVIDER: Optional[Callable[[], Optional[str]]] = None


def set_exemplar_provider(
        fn: Optional[Callable[[], Optional[str]]]) -> None:
    global _EXEMPLAR_PROVIDER
    _EXEMPLAR_PROVIDER = fn


def exemplar_provider() -> Optional[Callable[[], Optional[str]]]:
    return _EXEMPLAR_PROVIDER


def process_uptime_seconds() -> float:
    return time.time() - _PROCESS_START

#: Default histogram boundaries, tuned for batch-inference latencies: the
#: sub-millisecond region resolves per-stage host work (coerce/pad), the
#: 1 ms – 1 s region resolves dispatch + drain, and the long tail covers
#: inline XLA compiles (multi-second for real models).
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_INF = float("inf")


def _validate_name(name: str) -> None:
    if not name or not all(c.isalnum() or c in "_:" for c in name) \
            or name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}")


class _CounterSeries:
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    def get(self) -> float:
        with self._lock:
            return self._value


class _GaugeSeries:
    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    def get(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return 0.0


class _HistogramSeries:
    __slots__ = ("_lock", "_uppers", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, uppers: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._uppers = uppers
        self._counts = [0] * (len(uppers) + 1)  # last slot is +Inf
        self._sum = 0.0
        self._count = 0
        #: bucket index → (trace_id, observed value); lazily allocated so
        #: the exemplar-free hot path stays two attribute reads
        self._exemplars: Optional[Dict[int, Tuple[str, float]]] = None

    def observe(self, value: float) -> None:
        # le is inclusive: a value equal to a boundary lands in that bucket
        i = bisect.bisect_left(self._uppers, value)
        provider = _EXEMPLAR_PROVIDER
        trace_id = provider() if provider is not None else None
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if trace_id is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[i] = (trace_id, value)

    def get(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def exemplars(self) -> Dict[int, Tuple[str, float]]:
        """Last-observed exemplar per bucket index (+Inf = len(uppers))."""
        with self._lock:
            return dict(self._exemplars) if self._exemplars else {}


class _Metric:
    """Shared label-set machinery; subclasses define the series type."""

    kind = ""

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        _validate_name(name)
        for ln in labelnames:
            _validate_name(ln)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            # unlabeled metrics expose their single series immediately (at
            # zero), matching prometheus_client — so e.g. cache-miss
            # counters appear in /metrics before the first miss
            self._series[()] = self._new_series()

    def _new_series(self):
        raise NotImplementedError

    def labels(self, **labels: object):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = self._new_series()
        return series

    def remove(self, **labels: object) -> None:
        """Drop one labeled series (e.g. a closed server's gauges)."""
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            self._series.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            if not self.labelnames:
                self._series[()] = self._new_series()

    def series(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels-dict, series)] in insertion order, snapshotted."""
        with self._lock:
            items = list(self._series.items())
        return [(dict(zip(self.labelnames, key)), s) for key, s in items]


class Counter(_Metric):
    kind = "counter"

    def _new_series(self) -> _CounterSeries:
        return _CounterSeries()

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        self.labels(**labels).inc(amount)


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self) -> _GaugeSeries:
        return _GaugeSeries()

    def set(self, value: float, **labels: object) -> None:
        self.labels(**labels).set(value)

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        self.labels(**labels).inc(amount)

    def dec(self, amount: float = 1.0, **labels: object) -> None:
        self.labels(**labels).dec(amount)

    def set_function(self, fn: Callable[[], float],
                     **labels: object) -> None:
        """Sample ``fn()`` at collection time (queue depths, pool sizes)."""
        self.labels(**labels).set_function(fn)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> None:
        uppers = tuple(float(b) for b in buckets if b != _INF)
        if not uppers or list(uppers) != sorted(set(uppers)):
            raise ValueError(
                f"{name}: buckets must be sorted, unique and non-empty")
        self.buckets = uppers  # +Inf is implicit
        super().__init__(name, help, labelnames)

    def _new_series(self) -> _HistogramSeries:
        return _HistogramSeries(self.buckets)

    def observe(self, value: float, **labels: object) -> None:
        self.labels(**labels).observe(value)

    def time(self, **labels: object) -> "_HistogramTimer":
        return _HistogramTimer(self.labels(**labels))


class _HistogramTimer:
    """``with hist.time(): ...`` — observes elapsed wall-clock on exit."""

    __slots__ = ("_series", "_t0")

    def __init__(self, series: _HistogramSeries) -> None:
        self._series = series
        self._t0 = 0.0

    def __enter__(self) -> "_HistogramTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        self._series.observe(time.perf_counter() - self._t0)


class MetricsRegistry:
    """Name → metric map; get-or-create with type/label-set checking."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames,
                                              **kwargs)
                return m
        if type(m) is not cls:
            raise ValueError(
                f"{name} already registered as {m.kind}, not {cls.kind}")
        if m.labelnames != tuple(labelnames):
            raise ValueError(
                f"{name} already registered with labels {m.labelnames}, "
                f"not {tuple(labelnames)}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, dict]:
        """JSON-safe dict of every series — bench.py embeds this verbatim.

        Histogram ``buckets`` are cumulative (same le semantics as the
        Prometheus exposition); the key of the overflow bucket is "+Inf".
        """
        out: Dict[str, dict] = {}
        for m in self.metrics():
            series = []
            for labels, s in m.series():
                if isinstance(s, _HistogramSeries):
                    counts, total, count = s.get()
                    acc, buckets = 0, {}
                    for upper, c in zip(m.buckets, counts):
                        acc += c
                        buckets[repr(upper)] = acc
                    buckets["+Inf"] = count
                    series.append({"labels": labels, "sum": total,
                                   "count": count, "buckets": buckets})
                else:
                    series.append({"labels": labels, "value": s.get()})
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def render(self) -> str:
        from .exposition import render_prometheus
        return render_prometheus(self)

    def reset(self) -> None:
        """Zero every series; registered metric objects stay valid."""
        for m in self.metrics():
            m.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
              ) -> Histogram:
    return _REGISTRY.histogram(name, help, labelnames, buckets)


def snapshot() -> Dict[str, dict]:
    return _REGISTRY.snapshot()


def render() -> str:
    return _REGISTRY.render()


def reset_all() -> None:
    _REGISTRY.reset()


def build_info() -> Gauge:
    """Register/refresh the ``mmlspark_build_info`` identity gauge.

    The standard *_build_info idiom: value 1, identity in the labels
    (package version, torch version, device backend), so a scrape tells
    which build and runtime it hit. torch is reported only if something
    else already imported it (``sys.modules`` probe), and the backend is
    ``cuda`` only once CUDA is initialized: this function never imports
    torch or initializes CUDA itself.
    """
    version = torch_version = backend = "unknown"
    try:
        from .. import __version__ as version
    except Exception:
        pass
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        torch_version = str(getattr(torch_mod, "__version__", "unknown"))
        try:
            backend = ("cuda" if torch_mod.cuda.is_initialized()
                       else "cpu")
        except Exception:
            pass
    g = gauge("mmlspark_build_info",
              "Build/runtime identity (value is always 1; the labels carry "
              "the information)", ("version", "torch", "backend"))
    g.set(1, version=version, torch=torch_version, backend=backend)
    return g
