"""Time-series plane: fixed-memory metric history, trend queries, alerts.

Every measurement surface built so far (``/debug/slo``, ``/debug/costs``,
``/debug/cluster``, the scenario scorecards) is an instantaneous snapshot
or an end-of-run aggregate; nothing records how a signal *moved*. This
module is the missing history plane — the sensor half of ROADMAP item 4's
``FleetController`` (a control loop over "sustained burn-rate/queue-depth
pressure" needs trajectories, not point samples):

- :class:`TimeSeriesStore` — process-global, **fixed-memory** history.
  Each named series holds one preallocated ring (``array`` columns, no
  per-sample allocation) per downsample tier — default
  ``1s×120 → 10s×180 → 60s×120`` (:data:`DEFAULT_TIERS`, overridable via
  ``MMLSPARK_TPU_TS_TIERS="1x120,10x180,60x120"``). Every tier ingests
  every sample, so a coarse bucket carries exact min/max/mean/last for its
  span — a 100 ms latency spike survives into the 60 s tier instead of
  being averaged away. Series count is capped (``max_series``, drops
  counted in ``mmlspark_timeseries_dropped_total``), which makes the
  store's memory bound a compile-time product:
  ``max_series × Σ slots × 6 doubles`` (:meth:`TimeSeriesStore.byte_budget`).
- :class:`RegistrySampler` — background thread that scrapes the
  ``MetricsRegistry`` every ``MMLSPARK_TPU_TS_INTERVAL`` seconds
  (default 1.0; ``<= 0`` disables the thread, ``tick()`` stays callable
  for tests). Counters become per-second **rates** with the federation
  plane's reset protection (``_CounterState``), gauges are sampled
  directly, histograms are reduced to per-interval ``:p50``/``:p99``
  via the registry sketch's linear-interpolation quantile (slo.py's
  ``_quantile`` shape). Extra callables can be attached with
  :meth:`RegistrySampler.add_source` (the serving plane feeds per-port
  queue saturation and drain rate this way). The worker-side sampler is
  refcounted — every :class:`~mmlspark_tpu_torch.serving.server.WorkerServer`
  acquires it on construction and releases it on ``close()``.
- :class:`ClusterSampler` — the driver-side variant: no thread, fed from
  federation heartbeats at ``DriverRegistry.heartbeat``'s observation
  point, so cluster-level series (per-worker queue depth / in-flight /
  HBM in use from the health digest, merged goodput and error-budget
  burn rate from the aggregator scorecard) accrue where ``/debug/cluster``
  is served.
- Query API — :meth:`~TimeSeriesStore.range`,
  :meth:`~TimeSeriesStore.rate` (counter-reset tolerant),
  :meth:`~TimeSeriesStore.ewma`, and
  :meth:`~TimeSeriesStore.sustained` (predicate held across the whole
  window — the primitive the alert engine evaluates). Served at
  ``GET /debug/timeseries`` on both transports as JSON, or as a terminal
  sparkline view with ``?format=text`` (:func:`render_sparklines`).
- :class:`AlertEngine` — :class:`AlertRule` predicates with hysteresis:
  a rule **fires** only after its predicate holds for ``for_seconds``
  (sustained, not instantaneous — one bad sample never pages) and
  **resolves** only after the latest bucket has been good continuously
  for ``keep_firing_seconds`` — so a signal oscillating at the threshold
  cannot flap the rule. Transitions bump
  ``mmlspark_alerts_firing{rule}`` / ``mmlspark_alert_transitions_total
  {rule,to}``, land in the event log, and run ``on_fire`` hooks; the
  default hook drops a watchdog-style atomic JSON bundle (tmp +
  ``os.replace`` under the watchdog diag dir) with the offending series'
  recent window embedded. :func:`default_alert_rules` covers burn-rate,
  queue saturation, breaker flapping, and KV quantization error;
  ``MMLSPARK_TPU_ALERT_RULES`` adds or overrides rules with a
  ``name:series:op:threshold[:for=S][:keep=S][:field=F]`` grammar.

Pure stdlib, importable before torch, resettable for tests
(``reset_store()`` / ``reset_alert_engine()``) — same design constraints
as registry.py. Clocks are injectable everywhere (``time.monotonic``
default), which is what makes the hysteresis tests deterministic.

The port's copy of ``mmlspark_tpu/observability/timeseries.py``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from array import array
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

from ..reliability.lock_sanitizer import new_lock as _new_lock
from .events import log_event
from .federation import _CounterState
from .registry import counter as _metric_counter
from .registry import gauge as _metric_gauge
from .registry import snapshot as _registry_snapshot

__all__ = [
    "AlertEngine",
    "AlertRule",
    "ClusterSampler",
    "DEFAULT_TIERS",
    "INTERVAL_ENV",
    "RULES_ENV",
    "TIERS_ENV",
    "RegistrySampler",
    "TimeSeriesStore",
    "acquire_sampler",
    "default_alert_rules",
    "get_alert_engine",
    "get_sampler",
    "get_store",
    "parse_alert_rules",
    "parse_tiers",
    "release_sampler",
    "render_sparklines",
    "reset_alert_engine",
    "reset_store",
    "sample_interval",
    "set_alert_engine",
    "set_store",
]

INTERVAL_ENV = "MMLSPARK_TPU_TS_INTERVAL"
TIERS_ENV = "MMLSPARK_TPU_TS_TIERS"
RULES_ENV = "MMLSPARK_TPU_ALERT_RULES"

# finest-first; each tier ingests every sample, so coarse buckets carry
# exact min/max/sum/count/last for their span (spikes survive downsampling)
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = (
    (1.0, 120), (10.0, 180), (60.0, 120))
DEFAULT_MAX_SERIES = 256
_STATS_PER_BUCKET = 6  # epoch, min, max, sum, count, last

_M_ALERTS_FIRING = _metric_gauge(
    "mmlspark_alerts_firing",
    "1 while the named alert rule is in its firing state", ("rule",))
_M_ALERT_TRANSITIONS = _metric_counter(
    "mmlspark_alert_transitions_total",
    "Alert rule lifecycle transitions", ("rule", "to"))
_M_TS_SERIES = _metric_gauge(
    "mmlspark_timeseries_series",
    "Live series held by the process-global time-series store")
_M_TS_SAMPLES = _metric_counter(
    "mmlspark_timeseries_samples_total",
    "Samples recorded into the process-global time-series store")
_M_TS_DROPPED = _metric_counter(
    "mmlspark_timeseries_dropped_total",
    "Samples dropped because the store's series cap was reached")


def sample_interval() -> float:
    """Registry-sampler period in seconds; ``<= 0`` disables the thread."""
    raw = os.environ.get(INTERVAL_ENV, "").strip()
    if not raw:
        return 1.0
    try:
        return float(raw)
    except ValueError:
        return 1.0


def parse_tiers(spec: Optional[str] = None) -> Tuple[Tuple[float, int], ...]:
    """Parse a ``"1x120,10x180,60x120"`` tier spec (width_s × slots).

    Falls back to :data:`DEFAULT_TIERS` on any malformed input — a bad
    env var degrades to the default shape rather than crashing a server.
    """
    if spec is None:
        spec = os.environ.get(TIERS_ENV, "")
    tiers: List[Tuple[float, int]] = []
    for part in spec.split(","):
        part = part.strip().lower()
        if not part:
            continue
        width, _, slots = part.partition("x")
        try:
            w, n = float(width), int(slots)
        except ValueError:
            return DEFAULT_TIERS
        if w <= 0 or n <= 0:
            return DEFAULT_TIERS
        tiers.append((w, n))
    if not tiers:
        return DEFAULT_TIERS
    tiers.sort()
    return tuple(tiers)


def _quantile_from_counts(uppers: Sequence[float], counts: Sequence[float],
                          total: float, q: float) -> float:
    """Interpolated quantile from per-bucket (non-cumulative) counts.

    Same shape as slo.py's ``_quantile``: linear interpolation inside the
    bucket that crosses the target rank; the +Inf bucket answers with the
    last finite boundary (the sketch cannot see past it).
    """
    if total <= 0:
        return 0.0
    target = q * total
    acc = 0.0
    lo = 0.0
    for upper, c in zip(uppers, counts):
        if c > 0:
            if acc + c >= target:
                if math.isinf(upper):
                    return lo
                return lo + (upper - lo) * ((target - acc) / c)
            acc += c
        if not math.isinf(upper):
            lo = upper
    return lo


class _Ring:
    """One downsample tier: a preallocated epoch-indexed stat ring.

    Bucket ``i = epoch % slots`` is lazily recycled when a newer epoch
    lands on it (same idiom as slo.py's window ring) — feeding is O(1)
    and the ring never allocates after construction.
    """

    __slots__ = ("width", "slots", "_epoch", "_min", "_max", "_sum",
                 "_count", "_last")

    def __init__(self, width: float, slots: int):
        self.width = float(width)
        self.slots = int(slots)
        self._epoch = array("q", [-(2 ** 62)] * self.slots)
        self._min = array("d", bytes(8 * self.slots))
        self._max = array("d", bytes(8 * self.slots))
        self._sum = array("d", bytes(8 * self.slots))
        self._count = array("d", bytes(8 * self.slots))
        self._last = array("d", bytes(8 * self.slots))

    def feed(self, t: float, value: float) -> None:
        e = int(t // self.width)
        i = e % self.slots
        if self._epoch[i] != e:
            self._epoch[i] = e
            self._min[i] = self._max[i] = self._last[i] = value
            self._sum[i] = value
            self._count[i] = 1.0
            return
        if value < self._min[i]:
            self._min[i] = value
        if value > self._max[i]:
            self._max[i] = value
        self._sum[i] += value
        self._count[i] += 1.0
        self._last[i] = value

    def buckets(self, now: float, seconds: float,
                ) -> List[Tuple[int, float, float, float, float, float]]:
        """``(epoch, min, max, sum, count, last)`` rows covering the
        trailing window, oldest first; empty epochs are omitted. The
        range starts at the epoch *containing* ``now - seconds`` (clamped
        to the ring span), so window-start coverage is answerable."""
        e_hi = int(now // self.width)
        e_lo = max(int((now - seconds) // self.width),
                   e_hi - self.slots + 1)
        out = []
        for e in range(e_lo, e_hi + 1):
            i = e % self.slots
            if self._epoch[i] == e and self._count[i] > 0:
                out.append((e, self._min[i], self._max[i], self._sum[i],
                            self._count[i], self._last[i]))
        return out


class _Series:
    __slots__ = ("name", "labels", "kind", "rings", "first_t", "last_t",
                 "last_value")

    def __init__(self, name: str, labels: Dict[str, str], kind: str,
                 tiers: Sequence[Tuple[float, int]]):
        self.name = name
        self.labels = labels
        self.kind = kind
        self.rings = [_Ring(w, n) for w, n in tiers]
        self.first_t: Optional[float] = None
        self.last_t: Optional[float] = None
        self.last_value = 0.0

    def feed(self, t: float, value: float) -> None:
        for ring in self.rings:
            ring.feed(t, value)
        if self.first_t is None:
            self.first_t = t
        self.last_t = t
        self.last_value = value


def _label_key(labels: Optional[Dict[str, object]],
               ) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class TimeSeriesStore:
    """Fixed-memory history of named (optionally labeled) series.

    Memory is bounded by construction: at most ``max_series`` series,
    each a fixed set of preallocated rings — no per-sample allocation,
    no growth with run length. ``byte_budget()`` is the provable upper
    bound; ``approx_bytes()`` the current estimate (tests assert the
    latter stays flat under a long synthetic run).
    """

    def __init__(self, tiers: Optional[Sequence[Tuple[float, int]]] = None,
                 *, clock: Callable[[], float] = time.monotonic,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.tiers = parse_tiers() if tiers is None else tuple(
            (float(w), int(n)) for w, n in tiers)
        self.clock = clock
        self.max_series = int(max_series)
        self._lock = _new_lock("observability.timeseries.TimeSeriesStore")
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           _Series] = {}
        self._samples = 0
        self._dropped = 0

    # -- ingest ---------------------------------------------------------------

    def record(self, name: str, value: object,
               labels: Optional[Dict[str, object]] = None, *,
               t: Optional[float] = None, kind: str = "gauge") -> bool:
        """Feed one sample; False when dropped (cap or non-finite)."""
        try:
            v = float(value)  # type: ignore[arg-type]
        except (TypeError, ValueError):
            return False
        if not math.isfinite(v):
            return False
        if t is None:
            t = self.clock()
        key = (str(name), _label_key(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    self._dropped += 1
                    dropped = True
                else:
                    series = _Series(key[0], dict(key[1]), kind, self.tiers)
                    self._series[key] = series
                    dropped = False
            else:
                dropped = False
            if not dropped:
                series.feed(t, v)
                self._samples += 1
        if dropped:
            _M_TS_DROPPED.inc()
            return False
        _M_TS_SAMPLES.inc()
        return True

    # -- queries --------------------------------------------------------------

    def _match(self, name: str, labels: Optional[Dict[str, object]],
               ) -> List[_Series]:
        if labels is None:
            return [s for (n, _), s in self._series.items() if n == name]
        s = self._series.get((name, _label_key(labels)))
        return [s] if s is not None else []

    def _pick_tier(self, seconds: float) -> int:
        for i, (w, n) in enumerate(self.tiers):
            if w * n >= seconds:
                return i
        return len(self.tiers) - 1

    def range(self, name: str, seconds: float = 60.0,
              labels: Optional[Dict[str, object]] = None, *,
              at: Optional[float] = None,
              tier: Optional[int] = None) -> List[Dict[str, float]]:
        """Trailing-window buckets, oldest first.

        Reads the finest tier whose full span covers ``seconds``.
        ``labels=None`` merges every label-set of the name per epoch:
        min of mins, max of maxes, sum/count summed (so ``mean`` is the
        cross-series mean) and ``last`` the **max** of the member lasts —
        the worst-case convention alert predicates want (e.g. queue
        saturation across ports).
        """
        now = self.clock() if at is None else at
        ti = self._pick_tier(seconds) if tier is None else int(tier)
        merged: Dict[int, List[float]] = {}
        with self._lock:
            for series in self._match(name, labels):
                for (e, mn, mx, total, count, last
                     ) in series.rings[ti].buckets(now, seconds):
                    b = merged.get(e)
                    if b is None:
                        merged[e] = [mn, mx, total, count, last]
                    else:
                        if mn < b[0]:
                            b[0] = mn
                        if mx > b[1]:
                            b[1] = mx
                        b[2] += total
                        b[3] += count
                        if last > b[4]:
                            b[4] = last
        width = self.tiers[ti][0]
        return [{"t": e * width, "width": width, "min": b[0], "max": b[1],
                 "mean": b[2] / b[3], "count": int(b[3]), "last": b[4]}
                for e, b in sorted(merged.items())]

    def latest(self, name: str,
               labels: Optional[Dict[str, object]] = None,
               ) -> Optional[Tuple[float, float]]:
        """Most recent ``(t, value)`` across matching series, or None."""
        best: Optional[Tuple[float, float]] = None
        with self._lock:
            for series in self._match(name, labels):
                if series.last_t is None:
                    continue
                if best is None or series.last_t > best[0]:
                    best = (series.last_t, series.last_value)
        return best

    def rate(self, name: str, seconds: float = 60.0,
             labels: Optional[Dict[str, object]] = None, *,
             at: Optional[float] = None) -> Optional[float]:
        """Per-second increase of a cumulative series over the window.

        Counter-reset tolerant: bucket ``last`` values run through the
        federation plane's ``_CounterState`` delta, so a process restart
        mid-window contributes the post-reset value instead of a huge
        negative step. None with fewer than two buckets of evidence.
        """
        buckets = self.range(name, seconds, labels, at=at)
        if len(buckets) < 2:
            return None
        state = _CounterState()
        state.feed(buckets[0]["last"])
        for b in buckets[1:]:
            state.feed(b["last"])
        span = buckets[-1]["t"] - buckets[0]["t"]
        if span <= 0:
            return None
        return (state.acc - buckets[0]["last"]) / span

    def ewma(self, name: str, seconds: float = 60.0,
             labels: Optional[Dict[str, object]] = None, *,
             alpha: float = 0.3,
             at: Optional[float] = None) -> Optional[float]:
        """Exponentially weighted mean of bucket means, oldest→newest."""
        buckets = self.range(name, seconds, labels, at=at)
        if not buckets:
            return None
        value = buckets[0]["mean"]
        for b in buckets[1:]:
            value = alpha * b["mean"] + (1.0 - alpha) * value
        return value

    def sustained(self, name: str, predicate: Callable[[float], bool],
                  for_seconds: float,
                  labels: Optional[Dict[str, object]] = None, *,
                  field: str = "mean",
                  at: Optional[float] = None) -> bool:
        """True when ``predicate(bucket[field])`` held across the whole
        trailing window — evidence must reach back to the window start
        (a series younger than ``for_seconds`` is never "sustained"),
        and every observed bucket must satisfy the predicate."""
        now = self.clock() if at is None else at
        buckets = self.range(name, for_seconds, labels, at=now)
        if not buckets:
            return False
        # the bucket covering the window start has t <= now - for_seconds;
        # if the oldest evidence is younger, the signal hasn't been bad
        # (or even observed) long enough
        if buckets[0]["t"] > now - for_seconds:
            return False
        return all(predicate(b[field]) for b in buckets)

    # -- accounting / introspection -------------------------------------------

    def _bytes_per_series(self) -> int:
        slots = sum(n for _, n in self.tiers)
        # array columns dominate; the +512 is slack for the per-series
        # object, dict key, and label dict
        return slots * _STATS_PER_BUCKET * 8 + 512

    def byte_budget(self) -> int:
        """Provable upper bound on ring memory: cap × per-series cost."""
        return self.max_series * self._bytes_per_series()

    def approx_bytes(self) -> int:
        with self._lock:
            n = len(self._series)
        return n * self._bytes_per_series()

    def names(self) -> List[str]:
        with self._lock:
            return sorted({n for n, _ in self._series})

    def series_keys(self) -> List[Tuple[str, Dict[str, str]]]:
        with self._lock:
            return [(n, dict(lk)) for n, lk in sorted(self._series)]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            n, samples, dropped = (len(self._series), self._samples,
                                   self._dropped)
        return {"series": n, "max_series": self.max_series,
                "samples": samples, "dropped": dropped,
                "tiers": [[w, s] for w, s in self.tiers],
                "approx_bytes": n * self._bytes_per_series(),
                "byte_budget": self.byte_budget()}

    def snapshot(self, seconds: float = 120.0, *,
                 names: Optional[Iterable[str]] = None,
                 at: Optional[float] = None) -> Dict[str, object]:
        """JSON-safe dump served at ``/debug/timeseries`` and embedded in
        bench phase records. Points are compact rows
        ``[t, mean, min, max, last, count]``."""
        now = self.clock() if at is None else at
        wanted = set(names) if names is not None else None
        out: List[Dict[str, object]] = []
        for name, labels in self.series_keys():
            if wanted is not None and name not in wanted:
                continue
            points = [[round(b["t"], 3), b["mean"], b["min"], b["max"],
                       b["last"], b["count"]]
                      for b in self.range(name, seconds, labels, at=now)]
            out.append({"name": name, "labels": labels, "points": points})
        return {"seconds": seconds, "point_fields":
                ["t", "mean", "min", "max", "last", "count"],
                "stats": self.stats(), "series": out}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._samples = 0
            self._dropped = 0


# -- sparkline rendering ------------------------------------------------------

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values: Sequence[Optional[float]]) -> str:
    present = [v for v in values if v is not None]
    if not present:
        return ""
    lo, hi = min(present), max(present)
    span = hi - lo
    chars = []
    for v in values:
        if v is None:
            chars.append(" ")
        elif span <= 0:
            chars.append(_SPARK_BLOCKS[0])
        else:
            idx = int((v - lo) / span * (len(_SPARK_BLOCKS) - 1) + 0.5)
            chars.append(_SPARK_BLOCKS[idx])
    return "".join(chars)


def render_sparklines(store: TimeSeriesStore, seconds: float = 120.0, *,
                      names: Optional[Iterable[str]] = None,
                      width: int = 60,
                      at: Optional[float] = None) -> str:
    """Terminal triage view: one ``name{labels} ▁▃▅▇ min/max/last`` line
    per series (gaps render as spaces; long windows chunk-mean to fit)."""
    now = store.clock() if at is None else at
    wanted = set(names) if names is not None else None
    lines = []
    for name, labels in store.series_keys():
        if wanted is not None and name not in wanted:
            continue
        buckets = store.range(name, seconds, labels, at=now)
        if not buckets:
            continue
        tier_w = buckets[0]["width"]
        e_hi = int(now // tier_w)
        e_lo = min(int((now - seconds) // tier_w),
                   int(buckets[0]["t"] / tier_w))
        by_epoch = {int(b["t"] / tier_w): b["mean"] for b in buckets}
        values: List[Optional[float]] = [
            by_epoch.get(e) for e in range(e_lo, e_hi + 1)]
        if len(values) > width:
            chunk = math.ceil(len(values) / width)
            packed: List[Optional[float]] = []
            for i in range(0, len(values), chunk):
                window = [v for v in values[i:i + chunk] if v is not None]
                packed.append(sum(window) / len(window) if window else None)
            values = packed
        label = name + ("{%s}" % ",".join(
            f"{k}={v}" for k, v in sorted(labels.items())) if labels else "")
        lo = min(b["min"] for b in buckets)
        hi = max(b["max"] for b in buckets)
        lines.append(f"{label:<48} {_sparkline(values)}  "
                     f"min={lo:.4g} max={hi:.4g} "
                     f"last={buckets[-1]['last']:.4g}")
    return "\n".join(lines) + ("\n" if lines else "")


# -- alert rules and engine ---------------------------------------------------

_OPS: Dict[str, Callable[[float, float], bool]] = {
    "gt": lambda v, t: v > t, ">": lambda v, t: v > t,
    "lt": lambda v, t: v < t, "<": lambda v, t: v < t,
    "ge": lambda v, t: v >= t, ">=": lambda v, t: v >= t,
    "le": lambda v, t: v <= t, "<=": lambda v, t: v <= t,
}
_OP_CANON = {">": "gt", "<": "lt", ">=": "ge", "<=": "le"}


class AlertRule:
    """A sustained-threshold predicate over one store series.

    ``field`` picks the bucket statistic the predicate reads (``"max"``
    for spiky signals like queue saturation, ``"mean"`` for levels).
    """

    def __init__(self, name: str, series: str, op: str = "gt",
                 threshold: float = 0.0, *,
                 for_seconds: float = 2.0,
                 keep_firing_seconds: Optional[float] = None,
                 labels: Optional[Dict[str, object]] = None,
                 field: str = "mean", description: str = ""):
        if op not in _OPS:
            raise ValueError(f"unknown alert op {op!r}")
        self.name = str(name)
        self.series = str(series)
        self.op = _OP_CANON.get(op, op)
        self.threshold = float(threshold)
        self.for_seconds = float(for_seconds)
        self.keep_firing_seconds = (self.for_seconds
                                    if keep_firing_seconds is None
                                    else float(keep_firing_seconds))
        self.labels = dict(labels) if labels else None
        self.field = str(field)
        self.description = description
        self._cmp = _OPS[op]

    def predicate(self, value: float) -> bool:
        return self._cmp(value, self.threshold)

    def describe(self) -> Dict[str, object]:
        return {"name": self.name, "series": self.series, "op": self.op,
                "threshold": self.threshold,
                "for_seconds": self.for_seconds,
                "keep_firing_seconds": self.keep_firing_seconds,
                "labels": self.labels, "field": self.field,
                "description": self.description}


_BUNDLE_SEQ_LOCK = threading.Lock()
_BUNDLE_SEQ = 0


def _write_alert_bundle(rule: AlertRule,
                        record: Dict[str, object]) -> Optional[str]:
    """Default ``on_fire`` hook: watchdog-style atomic diagnostic bundle
    (tmp file + ``os.replace`` under the watchdog diag dir) embedding the
    offending series' recent window."""
    global _BUNDLE_SEQ
    try:
        from .watchdog import _SITE_SANITIZE_RE, get_watchdog
        diag_dir = get_watchdog().diag_dir()
    except Exception:
        return None
    with _BUNDLE_SEQ_LOCK:
        _BUNDLE_SEQ += 1
        seq = _BUNDLE_SEQ
    name = _SITE_SANITIZE_RE.sub("_", rule.name)[:64] or "rule"
    path = os.path.join(diag_dir,
                        f"alert_{name}_{os.getpid()}_{seq}.json")
    bundle = {"kind": "alert", **record}
    try:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(bundle, fh, indent=2, sort_keys=True, default=str)
        os.replace(tmp, path)
    except OSError:
        return None
    return path


class AlertEngine:
    """Evaluates :class:`AlertRule` predicates with hysteresis.

    Lifecycle per rule: not-firing → (predicate sustained for
    ``for_seconds``) → firing → (latest bucket good continuously for
    ``keep_firing_seconds``) → resolved. Both edges emit an event-log
    entry, a ``mmlspark_alert_transitions_total{rule,to}`` bump, and
    set/clear ``mmlspark_alerts_firing{rule}``; the firing edge also
    runs the ``on_fire`` hooks (default: :func:`_write_alert_bundle`).
    """

    def __init__(self, store: TimeSeriesStore, *,
                 clock: Optional[Callable[[], float]] = None,
                 on_fire: Optional[Sequence[Callable[
                     [AlertRule, Dict[str, object]], object]]] = None):
        self.store = store
        self.clock = clock if clock is not None else store.clock
        self.on_fire: List[Callable[[AlertRule, Dict[str, object]],
                                    object]] = (
            [_write_alert_bundle] if on_fire is None else list(on_fire))
        self._lock = _new_lock("observability.timeseries.AlertEngine")
        self._rules: Dict[str, AlertRule] = {}
        # rule -> {"firing", "since", "last_bad", "value"}
        self._state: Dict[str, Dict[str, object]] = {}

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            self._rules[rule.name] = rule
            self._state.pop(rule.name, None)
        _M_ALERTS_FIRING.set(0.0, rule=rule.name)

    def remove_rule(self, name: str) -> None:
        with self._lock:
            self._rules.pop(name, None)
            self._state.pop(name, None)
        _M_ALERTS_FIRING.remove(rule=name)

    def rules(self) -> List[AlertRule]:
        with self._lock:
            return [self._rules[n] for n in sorted(self._rules)]

    def clear(self) -> None:
        for rule in self.rules():
            self.remove_rule(rule.name)

    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, st in self._state.items()
                          if st.get("firing"))

    def state(self) -> Dict[str, object]:
        out = {}
        with self._lock:
            for name in sorted(self._rules):
                rule = self._rules[name]
                st = self._state.get(name, {})
                out[name] = {**rule.describe(),
                             "firing": bool(st.get("firing")),
                             "since": st.get("since"),
                             "value": st.get("value")}
        return out

    def evaluate(self, at: Optional[float] = None,
                 ) -> List[Dict[str, object]]:
        """Run every rule once; returns the transitions that happened."""
        now = self.clock() if at is None else at
        transitions: List[Dict[str, object]] = []
        for rule in self.rules():
            latest = self.store.latest(rule.series, rule.labels)
            with self._lock:
                st = self._state.setdefault(
                    rule.name, {"firing": False, "since": None,
                                "last_bad": None, "value": None})
                firing = bool(st["firing"])
            value = latest[1] if latest is not None else None
            if not firing:
                if self.store.sustained(rule.series, rule.predicate,
                                        rule.for_seconds, rule.labels,
                                        field=rule.field, at=now):
                    record = self._transition(rule, st, now, value,
                                              to="firing")
                    transitions.append(record)
                    for hook in self.on_fire:
                        try:
                            hook(rule, record)
                        except Exception:
                            pass
                continue
            # firing: refresh the bad-mark while the latest bucket still
            # trips the predicate; resolve only after keep_firing_seconds
            # of continuously good evidence (hysteresis — no flapping)
            recent = self.store.range(
                rule.series, max(rule.for_seconds, rule.keep_firing_seconds),
                rule.labels, at=now)
            bad_now = bool(recent) and rule.predicate(
                recent[-1][rule.field])
            with self._lock:
                if bad_now:
                    st["last_bad"] = now
                last_bad = st["last_bad"]
            if (not bad_now and last_bad is not None
                    and now - float(last_bad) >= rule.keep_firing_seconds):
                transitions.append(self._transition(rule, st, now, value,
                                                    to="resolved"))
        return transitions

    def _transition(self, rule: AlertRule, st: Dict[str, object],
                    now: float, value: Optional[float], *,
                    to: str) -> Dict[str, object]:
        firing = to == "firing"
        with self._lock:
            st["firing"] = firing
            st["since"] = now if firing else None
            st["last_bad"] = now if firing else None
            st["value"] = value
        _M_ALERTS_FIRING.set(1.0 if firing else 0.0, rule=rule.name)
        _M_ALERT_TRANSITIONS.inc(rule=rule.name, to=to)
        record: Dict[str, object] = {
            "rule": rule.name, "to": to, "at": now, "value": value,
            **rule.describe()}
        if firing:
            record["window"] = self.store.range(
                rule.series,
                max(2.0 * rule.for_seconds, 10.0), rule.labels, at=now)
        log_event("alert_" + to, rule=rule.name, series=rule.series,
                  value=value, threshold=rule.threshold)
        return record


def default_alert_rules(*, for_seconds: float = 2.0,
                        keep_firing_seconds: float = 3.0,
                        ) -> List[AlertRule]:
    """The stock rule set wired to signals the repo already exports."""
    kw = {"for_seconds": for_seconds,
          "keep_firing_seconds": keep_firing_seconds}
    return [
        AlertRule("burn-rate", "mmlspark_slo_error_budget_burn",
                  "gt", 1.0, field="mean",
                  description="error-budget burn above 1x sustained", **kw),
        AlertRule("queue-saturation", "mmlspark_queue_saturation",
                  "gt", 0.8, field="max",
                  description="admission queue above 80% of capacity", **kw),
        AlertRule("breaker-flap",
                  "mmlspark_breaker_transitions_total:rate",
                  "gt", 0.5, field="mean",
                  description="circuit breakers transitioning faster than "
                              "0.5/s", **kw),
        AlertRule("kv-quant-error", "mmlspark_kv_quant_error",
                  "gt", 0.25, field="max",
                  description="quantized-KV reconstruction error above "
                              "tolerance", **kw),
    ]


def parse_alert_rules(spec: Optional[str] = None) -> List[AlertRule]:
    """Parse the ``MMLSPARK_TPU_ALERT_RULES`` grammar: ``;``-separated
    ``name:series:op:threshold[:for=S][:keep=S][:field=F]`` clauses.
    Malformed clauses are skipped (a bad env var must not kill a server).
    """
    if spec is None:
        spec = os.environ.get(RULES_ENV, "")
    rules: List[AlertRule] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) < 4:
            continue
        name, series, op = parts[0], parts[1], parts[2]
        extras: Dict[str, object] = {}
        try:
            threshold = float(parts[3])
            for part in parts[4:]:
                k, _, v = part.partition("=")
                if k == "for":
                    extras["for_seconds"] = float(v)
                elif k == "keep":
                    extras["keep_firing_seconds"] = float(v)
                elif k == "field":
                    extras["field"] = v
            rules.append(AlertRule(name, series, op, threshold, **extras))
        except ValueError:
            continue
    return rules


# -- registry sampler (worker side) -------------------------------------------

class RegistrySampler:
    """Scrapes the metrics registry into a store on a fixed interval.

    Counters → ``name:rate`` (per-second, reset-protected), gauges →
    sampled directly, histograms → ``name:p50`` / ``name:p99`` over each
    interval's *new* observations. Extra callables attach via
    :meth:`add_source`. ``tick()`` is the synchronous unit of work (tests
    drive it directly with a fake clock); ``start()`` runs it on a daemon
    thread unless the interval is ``<= 0``.
    """

    def __init__(self, store: TimeSeriesStore, *,
                 interval: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 engine: Optional[AlertEngine] = None):
        self.store = store
        self.interval = sample_interval() if interval is None else interval
        self.clock = clock
        self.engine = engine
        self._counters: Dict[Tuple[str, tuple], _CounterState] = {}
        self._hists: Dict[Tuple[str, tuple],
                          Tuple[Dict[float, float], float]] = {}
        self._last_t: Optional[float] = None
        self._sources: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            Callable[[], object]] = {}
        self._lock = _new_lock("observability.timeseries.RegistrySampler")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_source(self, name: str, fn: Callable[[], object],
                   **labels: object) -> None:
        """Attach a gauge-style callable sampled once per tick."""
        with self._lock:
            self._sources[(name, _label_key(labels))] = fn

    def remove_source(self, name: str, **labels: object) -> None:
        with self._lock:
            self._sources.pop((name, _label_key(labels)), None)

    def tick(self, now: Optional[float] = None) -> None:
        """One scrape: registry + extra sources, then alert evaluation."""
        if now is None:
            now = self.clock()
        dt = (now - self._last_t) if self._last_t is not None else None
        self._last_t = now
        try:
            snap = _registry_snapshot()
        except Exception:
            snap = {}
        for mname, metric in snap.items():
            if mname.startswith("mmlspark_timeseries_"):
                continue  # the store's own telemetry would self-amplify
            mtype = metric.get("type")
            for row in metric.get("series", ()):
                labels = row.get("labels") or {}
                key = (mname, _label_key(labels))
                if mtype == "counter":
                    state = self._counters.setdefault(key, _CounterState())
                    before = state.acc
                    state.feed(float(row.get("value", 0.0)))
                    if dt is not None and dt > 0:
                        self.store.record(mname + ":rate",
                                          (state.acc - before) / dt,
                                          labels, t=now, kind="rate")
                elif mtype == "gauge":
                    self.store.record(mname, row.get("value", 0.0),
                                      labels, t=now, kind="gauge")
                elif mtype == "histogram":
                    self._sample_histogram(key, row, now)
        with self._lock:
            sources = list(self._sources.items())
        for (name, lkey), fn in sources:
            try:
                value = fn()
            except Exception:
                continue
            if value is not None:
                self.store.record(name, value, dict(lkey), t=now)
        if self.engine is not None:
            try:
                self.engine.evaluate(at=now)
            except Exception:
                pass

    def _sample_histogram(self, key: Tuple[str, tuple],
                          row: Dict[str, object], now: float) -> None:
        raw = row.get("buckets") or {}
        cums: Dict[float, float] = {}
        for k, v in raw.items():  # cumulative, keyed repr(upper) / "+Inf"
            upper = math.inf if k == "+Inf" else float(k)
            cums[upper] = float(v)
        count = float(row.get("count", 0.0))
        prev = self._hists.get(key)
        if prev is None or count < prev[1]:  # first scrape or reset
            base, base_count = {}, 0.0
        else:
            base, base_count = prev
        self._hists[key] = (cums, count)
        d_count = count - base_count
        if d_count <= 0:
            return  # no new observations this interval
        uppers = sorted(cums)
        deltas_cum = [cums[u] - base.get(u, 0.0) for u in uppers]
        counts = [deltas_cum[0]] + [deltas_cum[i] - deltas_cum[i - 1]
                                    for i in range(1, len(deltas_cum))]
        labels = row.get("labels") or {}
        mname = key[0]
        for q, suffix in ((0.5, ":p50"), (0.99, ":p99")):
            self.store.record(
                mname + suffix,
                _quantile_from_counts(uppers, counts, d_count, q),
                labels, t=now, kind="quantile")

    def start(self) -> None:
        if self.interval <= 0 or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="mmlspark-ts-sampler", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                pass

    def stop(self) -> None:
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout=2.0)
        self._thread = None


# -- cluster sampler (driver side) --------------------------------------------

class ClusterSampler:
    """Driver-side store fed from federation heartbeats — no thread.

    ``DriverRegistry.heartbeat`` calls :meth:`observe` after ingesting a
    worker's digest/telemetry, so cluster series accrue exactly where
    ``/debug/cluster`` observes the fleet: per-worker ``queue_depth`` /
    ``in_flight`` / ``hbm_bytes_in_use`` from the health digest, merged
    ``cluster_goodput_rps`` and ``cluster_burn_rate`` from the
    aggregator scorecard's monotone totals. Series are keyed by worker
    id, so a restarted worker (same id, fresh process) continues its
    series — counter resets are absorbed by the aggregator's own
    reset-safe merge before we ever see the totals.
    """

    _DIGEST_SERIES = (("cluster_queue_depth", "queue_depth"),
                      ("cluster_in_flight", "in_flight"),
                      ("cluster_hbm_bytes_in_use", "hbm_bytes_in_use"))

    def __init__(self, store: Optional[TimeSeriesStore] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 error_budget: float = 0.001):
        self.store = store if store is not None else TimeSeriesStore(
            clock=clock)
        self.clock = clock
        self.error_budget = float(error_budget)
        self._total = _CounterState()
        self._errors = _CounterState()
        self._last_t: Optional[float] = None

    def observe(self, worker_id: str,
                digest: Optional[Dict[str, object]] = None,
                scorecard: Optional[Dict[str, object]] = None) -> None:
        now = self.clock()
        if isinstance(digest, dict):
            for series, field in self._DIGEST_SERIES:
                value = digest.get(field)
                if isinstance(value, (int, float)):
                    self.store.record(series, float(value),
                                      {"worker": str(worker_id)}, t=now)
        if isinstance(scorecard, dict):
            total = errors = 0.0
            for cls in scorecard.get("classes", ()):
                total += float(cls.get("total", 0))
                errors += float(cls.get("errors_total", 0))
            before_t, before_e = self._total.acc, self._errors.acc
            self._total.feed(total)
            self._errors.feed(errors)
            dt = (now - self._last_t) if self._last_t is not None else None
            self._last_t = now
            if dt is not None and dt > 0:
                d_total = self._total.acc - before_t
                d_errors = self._errors.acc - before_e
                goodput = max(0.0, d_total - d_errors) / dt
                self.store.record("cluster_goodput_rps", goodput, t=now,
                                  kind="rate")
                burn = ((d_errors / d_total) / self.error_budget
                        if d_total > 0 else 0.0)
                self.store.record("cluster_burn_rate", burn, t=now,
                                  kind="rate")

    def snapshot(self, seconds: float = 300.0) -> Dict[str, object]:
        return self.store.snapshot(seconds)


# -- process-global wiring ----------------------------------------------------

_GLOBAL_LOCK = threading.RLock()
_STORE: Optional[TimeSeriesStore] = None
_ENGINE: Optional[AlertEngine] = None
_SAMPLER: Optional[RegistrySampler] = None
_SAMPLER_REFS = 0


def get_store() -> TimeSeriesStore:
    """The process-global store (worker side); created on first use."""
    global _STORE
    with _GLOBAL_LOCK:
        if _STORE is None:
            _STORE = TimeSeriesStore()
            _M_TS_SERIES.set_function(
                lambda: float(len(_STORE._series)) if _STORE else 0.0)
        return _STORE


def set_store(store: Optional[TimeSeriesStore],
              ) -> Optional[TimeSeriesStore]:
    global _STORE
    with _GLOBAL_LOCK:
        old, _STORE = _STORE, store
    return old


def reset_store() -> None:
    set_store(None)


def get_alert_engine() -> AlertEngine:
    """The global engine over :func:`get_store`, loaded with the default
    rules plus any ``MMLSPARK_TPU_ALERT_RULES`` overrides (same-name env
    rules replace the stock ones)."""
    global _ENGINE
    with _GLOBAL_LOCK:
        if _ENGINE is None:
            engine = AlertEngine(get_store())
            for rule in default_alert_rules():
                engine.add_rule(rule)
            for rule in parse_alert_rules():
                engine.add_rule(rule)
            _ENGINE = engine
        return _ENGINE


def set_alert_engine(engine: Optional[AlertEngine],
                     ) -> Optional[AlertEngine]:
    global _ENGINE
    with _GLOBAL_LOCK:
        old, _ENGINE = _ENGINE, engine
    return old


def reset_alert_engine() -> None:
    old = set_alert_engine(None)
    if old is not None:
        old.clear()


def acquire_sampler() -> RegistrySampler:
    """Refcounted acquisition of the global registry sampler.

    Every WorkerServer acquires on construction and releases on close;
    the scrape thread starts with the first holder and stops with the
    last (many in-process servers share one registry, so one sampler).
    """
    global _SAMPLER, _SAMPLER_REFS
    with _GLOBAL_LOCK:
        if _SAMPLER is None:
            _SAMPLER = RegistrySampler(get_store(),
                                       engine=get_alert_engine())
        _SAMPLER_REFS += 1
        sampler = _SAMPLER
    sampler.start()
    return sampler


def release_sampler() -> None:
    global _SAMPLER, _SAMPLER_REFS
    with _GLOBAL_LOCK:
        if _SAMPLER is None:
            return
        _SAMPLER_REFS = max(0, _SAMPLER_REFS - 1)
        sampler = _SAMPLER if _SAMPLER_REFS == 0 else None
        if sampler is not None:
            _SAMPLER = None
    if sampler is not None:
        sampler.stop()


def get_sampler() -> Optional[RegistrySampler]:
    return _SAMPLER
