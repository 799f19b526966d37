"""SLO engine: rolling per-class scorecards over the serving plane.

ROADMAP item 5 asks for BENCH-style SLO scorecards (goodput, p50/p99/p999,
shed rate, error-budget burn) that feed the tuning ``ObservationStore`` so
the ``CostModel`` optimizes against traffic-shaped load. This module is
the measurement half: a process-global :class:`SloTracker` that every
request funnel (``WorkerServer._observe_request``, bench phases) reports
into, bucketed by **workload class** — the ``{transport, route, model,
tenant}`` label tuple (``tenant`` arrives via the optional
``X-Mmlspark-Tenant`` request header and defaults to ``"default"``).

Design constraints mirror the registry's (registry.py): pure stdlib,
default-on (one dict lookup + a few adds per request), process-global
(``get_tracker()``), resettable (``reset_tracker()``), and snapshot-able
(:meth:`SloTracker.scorecard` returns plain JSON served at
``GET /debug/slo`` and harvested by
``tuning.observations.harvest_scorecard`` as ``source="slo_scorecard"``
rows).

Two time scales per class, on purpose:

- **cumulative totals** (``total`` / ``errors_total`` / ``shed_total``)
  never decay — they reconcile exactly against
  ``mmlspark_serving_requests_total`` at ``/metrics``;
- a **rolling window** (``window_seconds``, default 60 s, split into
  ``num_buckets`` ring buckets) carries the live rate/latency view the
  burn-rate math runs on — stale buckets are recycled lazily on write,
  so an idle tracker costs nothing.

The latency sketch is the registry's fixed-bucket histogram shape
(``DEFAULT_LATENCY_BUCKETS`` uppers, quantiles interpolated within a
bucket) — no per-request list is ever kept, which is exactly why
hand-rolled ``sorted()[int(0.99*len)]`` windows elsewhere are a lint
finding (tpulint TPU011).

The port's copy of ``mmlspark_tpu/observability/slo.py``.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .registry import DEFAULT_LATENCY_BUCKETS
from .registry import counter as _metric_counter
from .registry import gauge as _metric_gauge

__all__ = ["DEFAULT_TENANT", "SloPolicy", "SloTracker", "classify_route",
           "get_tracker", "set_tracker", "reset_tracker"]

# the serving-plane SLO mirror: the same per-class counts the scorecard
# reports, visible to a plain /metrics scrape (docs/observability.md)
_M_SLO_REQUESTS = _metric_counter(
    "mmlspark_slo_requests_total",
    "Requests observed by the SLO tracker, by workload class",
    ("transport", "route", "model", "tenant"))
_M_SLO_ERRORS = _metric_counter(
    "mmlspark_slo_errors_total",
    "Observed requests that counted against the error budget (5xx)",
    ("transport", "route", "model", "tenant"))
_M_SLO_SHED = _metric_counter(
    "mmlspark_slo_shed_total",
    "Requests shed (429) per workload class — tracked apart from errors "
    "because shedding is load policy, not failure",
    ("transport", "route", "model", "tenant"))
_M_SLO_BURN = _metric_gauge(
    "mmlspark_slo_error_budget_burn",
    "Rolling-window error-budget burn rate per class (1.0 = burning "
    "exactly the budget; refreshed at scorecard time)",
    ("transport", "route", "model", "tenant"))
_M_SLO_P99 = _metric_gauge(
    "mmlspark_slo_p99_seconds",
    "Rolling-window p99 latency per class (refreshed at scorecard time)",
    ("transport", "route", "model", "tenant"))
_M_KV_QUANT = _metric_gauge(
    "mmlspark_kv_quant_error",
    "Latest sampled KV quantization error per model: relative RMS of "
    "dequantize(quantize(rows)) vs the bf16 oracle rows at write time "
    "(0 on unquantized engines; feeds the registry's canary check)",
    ("model",))

#: classes beyond this cap collapse into ("other", "other", "other",
#: "other") — a label-cardinality bound, same motivation as Prometheus
#: practice. The tenant dimension rides inside the same cap: a burst of
#: novel tenant strings lands in the overflow class, not the label space.
MAX_CLASSES = 64
_OVERFLOW_KEY = ("other", "other", "other", "other")
DEFAULT_TENANT = "default"


class SloPolicy:
    """Service objectives the scorecard judges each class against.

    ``target_p99`` — seconds; the window p99 at or under this passes.
    ``availability`` — success-ratio objective in (0, 1); its complement
    is the error budget the burn rate is normalized by (burn 1.0 = errors
    arriving at exactly the budgeted rate; >1 exhausts the budget early).
    """

    __slots__ = ("target_p99", "availability")

    def __init__(self, target_p99: float = 0.5,
                 availability: float = 0.999):
        if not 0.0 < availability < 1.0:
            raise ValueError("availability must be in (0, 1)")
        if target_p99 <= 0.0:
            raise ValueError("target_p99 must be positive")
        self.target_p99 = float(target_p99)
        self.availability = float(availability)

    def as_dict(self) -> Dict[str, float]:
        return {"target_p99": self.target_p99,
                "availability": self.availability}


def classify_route(path: Optional[str]) -> str:
    """Collapse a request path to a bounded route class.

    The scorecard is per *workload class*, not per URL — unbounded label
    sets would blow up both the tracker and the mirrored metrics."""
    if not path:
        return "api"
    path = path.partition("?")[0]
    if path.startswith("/healthz"):
        return "healthz"
    if path.startswith("/metrics"):
        return "metrics"
    if path.startswith("/debug"):
        return "debug"
    return "api"


class _WinBucket:
    """One ring slot: counts + a fixed-bucket latency sketch."""

    __slots__ = ("epoch", "count", "errors", "shed", "lat_counts",
                 "lat_sum")

    def __init__(self, n_lat: int):
        self.epoch = -1
        self.count = 0
        self.errors = 0
        self.shed = 0
        self.lat_counts = [0] * n_lat
        self.lat_sum = 0.0

    def reset(self, epoch: int) -> None:
        self.epoch = epoch
        self.count = self.errors = self.shed = 0
        for i in range(len(self.lat_counts)):
            self.lat_counts[i] = 0
        self.lat_sum = 0.0


class _Class:
    """Per-workload-class state: cumulative totals + the bucket ring."""

    __slots__ = ("total", "errors_total", "shed_total", "ring")

    def __init__(self, num_buckets: int, n_lat: int):
        self.total = 0
        self.errors_total = 0
        self.shed_total = 0
        self.ring = [_WinBucket(n_lat) for _ in range(num_buckets)]


class SloTracker:
    """Time-bucketed rolling SLO windows per ``{transport, route, model,
    tenant}``.

    ``clock`` is injectable (monotonic seconds) so tests drive window
    rotation deterministically. All mutation is under one lock — the
    per-request cost is a dict lookup plus a handful of integer adds.
    """

    def __init__(self, policy: Optional[SloPolicy] = None,
                 window_seconds: float = 60.0, num_buckets: int = 12,
                 clock: Callable[[], float] = time.monotonic,
                 max_classes: int = MAX_CLASSES):
        if window_seconds <= 0 or num_buckets < 1:
            raise ValueError("window_seconds and num_buckets must be "
                             "positive")
        self.policy = policy or SloPolicy()
        self.window_seconds = float(window_seconds)
        self.num_buckets = int(num_buckets)
        self._width = self.window_seconds / self.num_buckets
        self._clock = clock
        self._max_classes = int(max_classes)
        self._uppers: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS
        self._lock = threading.Lock()
        self._classes: Dict[Tuple[str, str, str, str], _Class] = {}
        # model -> ring of [epoch, sum, count, max] KV quant-error
        # samples (same epoch math as the request ring; bounded by
        # max_classes like everything else label-shaped)
        self._quant: Dict[str, List[List[float]]] = {}

    # -- recording -----------------------------------------------------------
    def _class(self, transport: str, route: str, model: str,
               tenant: str) -> _Class:
        key = (str(transport), str(route), str(model), str(tenant))
        cls = self._classes.get(key)
        if cls is None:
            if len(self._classes) >= self._max_classes:
                key = _OVERFLOW_KEY
                cls = self._classes.get(key)
                if cls is not None:
                    return cls
            cls = self._classes[key] = _Class(self.num_buckets,
                                              len(self._uppers) + 1)
        return cls

    def _bucket(self, cls: _Class) -> _WinBucket:
        epoch = int(self._clock() / self._width)
        b = cls.ring[epoch % self.num_buckets]
        if b.epoch != epoch:
            b.reset(epoch)
        return b

    def observe(self, transport: str = "api", route: str = "api",
                model: str = "default",
                seconds: Optional[float] = None,
                error: bool = False,
                tenant: str = DEFAULT_TENANT) -> None:
        """One answered request. ``seconds`` feeds the latency sketch when
        known; ``error=True`` charges the class's error budget (5xx —
        sheds go through :meth:`shed` instead)."""
        with self._lock:
            cls = self._class(transport, route, model, tenant)
            b = self._bucket(cls)
            cls.total += 1
            b.count += 1
            if error:
                cls.errors_total += 1
                b.errors += 1
            if seconds is not None:
                i = bisect.bisect_left(self._uppers, seconds)
                b.lat_counts[i] += 1
                b.lat_sum += seconds
        _M_SLO_REQUESTS.inc(transport=transport, route=route, model=model,
                            tenant=tenant)
        if error:
            _M_SLO_ERRORS.inc(transport=transport, route=route,
                              model=model, tenant=tenant)

    def shed(self, transport: str = "api", route: str = "api",
             model: str = "default", tenant: str = DEFAULT_TENANT) -> None:
        """One request refused by admission control (429)."""
        with self._lock:
            cls = self._class(transport, route, model, tenant)
            b = self._bucket(cls)
            cls.shed_total += 1
            b.shed += 1
        _M_SLO_SHED.inc(transport=transport, route=route, model=model,
                        tenant=tenant)

    def note_kv_quant_error(self, model: str, rms: float) -> None:
        """One sampled KV quantization-error observation for ``model``
        (the engine's write-time oracle probe — relative RMS of the
        quantize/dequantize roundtrip vs the bf16 rows). Rolls through
        the same window ring as request stats so
        :meth:`model_window`'s ``kv_quant_error`` and a canary's
        latency/error view cover the same period."""
        model = str(model)
        rms = float(rms)
        with self._lock:
            ring = self._quant.get(model)
            if ring is None:
                if len(self._quant) >= self._max_classes:
                    model = "other"
                    ring = self._quant.get(model)
                if ring is None:
                    ring = self._quant[model] = [
                        [-1, 0.0, 0, 0.0] for _ in range(self.num_buckets)]
            epoch = int(self._clock() / self._width)
            b = ring[epoch % self.num_buckets]
            if b[0] != epoch:
                b[0], b[1], b[2], b[3] = epoch, 0.0, 0, 0.0
            b[1] += rms
            b[2] += 1
            b[3] = max(b[3], rms)
        _M_KV_QUANT.set(rms, model=model)

    def _quant_window(self, model: str) -> Dict[str, object]:
        """Merged live-window quant-error stats for ``model`` (caller
        holds the lock). ``mean`` is None when nothing was sampled."""
        ring = self._quant.get(str(model))
        out = {"count": 0, "mean": None, "max": None}
        if ring is None:
            return out
        now_epoch = int(self._clock() / self._width)
        total, n, mx = 0.0, 0, 0.0
        for b in ring:
            if b[0] < 0 or now_epoch - b[0] >= self.num_buckets:
                continue
            total += b[1]
            n += b[2]
            mx = max(mx, b[3])
        if n:
            out = {"count": n, "mean": total / n, "max": mx}
        return out

    # -- reading -------------------------------------------------------------
    def _window_view(self, cls: _Class) -> Tuple[int, int, int, List[int],
                                                 float]:
        """Merge the ring's LIVE buckets (epoch within the window)."""
        now_epoch = int(self._clock() / self._width)
        count = errors = shed = 0
        lat = [0] * (len(self._uppers) + 1)
        lat_sum = 0.0
        for b in cls.ring:
            if b.epoch < 0 or now_epoch - b.epoch >= self.num_buckets:
                continue
            count += b.count
            errors += b.errors
            shed += b.shed
            lat_sum += b.lat_sum
            for i, c in enumerate(b.lat_counts):
                lat[i] += c
        return count, errors, shed, lat, lat_sum

    def _quantile(self, lat: List[int], q: float) -> Optional[float]:
        total = sum(lat)
        if total == 0:
            return None
        rank = q * total
        acc = 0
        for i, c in enumerate(lat):
            if c == 0:
                continue
            prev_acc = acc
            acc += c
            if acc >= rank:
                if i >= len(self._uppers):
                    # +Inf bucket: the last finite boundary is the best
                    # honest answer a fixed sketch can give
                    return self._uppers[-1]
                lo = self._uppers[i - 1] if i > 0 else 0.0
                hi = self._uppers[i]
                frac = (rank - prev_acc) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
        return self._uppers[-1]

    def burn_rate(self, transport: str, route: str,
                  model: str = "default",
                  tenant: str = DEFAULT_TENANT) -> float:
        """Window error rate over the policy's error budget: 1.0 means
        errors arrive at exactly the budgeted rate, >1 exhausts the
        budget early. 0.0 on an idle window."""
        with self._lock:
            cls = self._classes.get((str(transport), str(route),
                                     str(model), str(tenant)))
            if cls is None:
                return 0.0
            count, errors, _, _, _ = self._window_view(cls)
        if count == 0:
            return 0.0
        budget = 1.0 - self.policy.availability
        return (errors / count) / budget

    def model_window(self, model: str) -> Dict[str, object]:
        """Rolling-window stats aggregated across every class whose
        ``model`` dimension matches — the canary-governance read: the
        model registry compares a candidate version's window (model =
        ``name@candidate``) against its incumbent's, regardless of which
        transports/routes/tenants the traffic arrived on."""
        with self._lock:
            views = [self._window_view(cls)
                     for key, cls in self._classes.items()
                     if key[2] == str(model)]
            quant = self._quant_window(model)
        count = sum(v[0] for v in views)
        errors = sum(v[1] for v in views)
        lat = [0] * (len(self._uppers) + 1)
        for v in views:
            for i, c in enumerate(v[3]):
                lat[i] += c
        return {"model": str(model), "count": count, "errors": errors,
                "error_rate": (errors / count) if count else 0.0,
                "p99": self._quantile(lat, 0.99),
                "kv_quant_error": quant["mean"],
                "kv_quant_samples": quant["count"]}

    def scorecard(self) -> Dict[str, object]:
        """JSON-safe rolling scorecard over every workload class.

        Per class: cumulative ``total``/``errors_total``/``shed_total``
        (reconcile against ``mmlspark_serving_requests_total``), the live
        ``window`` rates, interpolated p50/p99/p999 from the latency
        sketch, availability, burn rate, and the pass/fail verdicts
        against :class:`SloPolicy`. Also refreshes the
        ``mmlspark_slo_error_budget_burn`` / ``mmlspark_slo_p99_seconds``
        gauges so scrapes and scorecards agree."""
        with self._lock:
            items = sorted(self._classes.items())
            views = [(key, cls.total, cls.errors_total, cls.shed_total,
                      self._window_view(cls)) for key, cls in items]
            kv_quant = {m: self._quant_window(m)
                        for m in sorted(self._quant)}
        budget = 1.0 - self.policy.availability
        classes: List[Dict[str, object]] = []
        for (transport, route, model, tenant), total, errors_total, \
                shed_total, (count, errors, shed, lat, lat_sum) in views:
            p50 = self._quantile(lat, 0.50)
            p99 = self._quantile(lat, 0.99)
            p999 = self._quantile(lat, 0.999)
            availability = (1.0 - errors / count) if count else None
            burn = (errors / count) / budget if count else 0.0
            labels = dict(transport=transport, route=route, model=model,
                          tenant=tenant)
            _M_SLO_BURN.set(burn, **labels)
            _M_SLO_P99.set(p99 if p99 is not None else 0.0, **labels)
            classes.append({
                "transport": transport, "route": route, "model": model,
                "tenant": tenant,
                "total": total, "errors_total": errors_total,
                "shed_total": shed_total,
                "window": {
                    "count": count, "errors": errors, "shed": shed,
                    "rps": round(count / self.window_seconds, 4),
                    "latency_sum": round(lat_sum, 6)},
                "p50": p50, "p99": p99, "p999": p999,
                "availability": availability,
                "error_budget_burn": round(burn, 4),
                "p99_ok": (None if p99 is None
                           else bool(p99 <= self.policy.target_p99)),
                "availability_ok": (None if availability is None
                                    else bool(availability
                                              >= self.policy.availability)),
            })
        return {"t": time.time(),
                "window_seconds": self.window_seconds,
                "num_buckets": self.num_buckets,
                "policy": self.policy.as_dict(),
                "classes": classes,
                "kv_quant": kv_quant}

    def reset(self) -> None:
        with self._lock:
            self._classes.clear()
            self._quant.clear()


# -- the process-global tracker ----------------------------------------------

_tracker_lock = threading.Lock()
_tracker: Optional[SloTracker] = None


def get_tracker() -> SloTracker:
    """The process-global tracker, created on first use (default policy,
    60 s window) — the one ``WorkerServer`` and bench.py report into."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = SloTracker()
        return _tracker


def set_tracker(tracker: Optional[SloTracker]) -> None:
    """Install a specific tracker (tests, custom policies)."""
    global _tracker
    with _tracker_lock:
        _tracker = tracker


def reset_tracker() -> None:
    """Drop the global tracker (test hook — pair with
    ``observability.reset_all`` to zero the mirrored metric series)."""
    set_tracker(None)
