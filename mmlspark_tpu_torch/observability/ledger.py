"""Per-request cost attribution: who consumed that device time?

Every telemetry layer so far answers "how much" (metrics), "what
happened" (tracing), and "is it good enough" (SLO); none answers "which
request/tenant PAID for it". ROADMAP item 2 (multi-tenant serving with
weighted-fair queuing) needs exactly that truth, and the tuning
``CostModel`` wants attributed per-class cost rows next to its
throughput facts. This module is the measurement half: a process-global
:class:`CostLedger` the data plane charges as requests flow through it —

- **queue_wait_seconds** — time spent parked in the worker queue
  (``WorkerServer.get_batch`` charges on dequeue);
- **device_seconds** — dispatch+d2h wall time from ``BatchRunner`` runs
  and ``ContinuousDecoder`` prefill/decode ticks, apportioned per
  row/token across the requests sharing the batch;
- **compile_seconds** — XLA compiles triggered under the request;
- **h2d_bytes** / **d2h_bytes** — transfer volume from the residency/
  staging plane;
- **kv_page_seconds** — ``PagedKVPool`` page-holds (pages × held
  seconds, charged at free time);
- **padding_waste_rows** — rows of bucket padding the request's batch
  carried (capacity burned without useful work).

Charges resolve their **workload class** ``{transport, route, model,
tenant}`` from the active trace context: ``WorkerServer._enqueue`` stamps
the class onto the root span's attrs, so any code running under that
trace (directly or via ``tracing.propagate``) charges the right class
with zero plumbing. Code running outside any trace charges the bounded
``untraced`` class — the ledger never drops a cost on the floor.

Design constraints mirror the SLO tracker's (slo.py): pure stdlib,
default-on (a dict lookup and a few float adds per charge), process
global (:func:`get_ledger`), resettable, cardinality-bounded by the same
``MAX_CLASSES`` overflow-to-"other" discipline, and snapshot-able
(:meth:`CostLedger.snapshot` returns plain JSON served at
``GET /debug/costs`` and harvested by
``tuning.observations.harvest_costs`` as ``source="cost_ledger"`` rows).

The **heavy-hitter table** is a SpaceSaving sketch over trace ids: the
top-K most expensive requests by weighted scalar cost, each entry
carrying the maximum overestimation error its slot inherited. Entries
join back to the flight recorder by trace id
(``GET /debug/traces/<trace_id>``), so "what did the most expensive
request actually do" is one click, not a log dig.

The port's copy of ``mmlspark_tpu/observability/ledger.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from .registry import counter as _metric_counter
from .registry import gauge as _metric_gauge
from .slo import DEFAULT_TENANT, MAX_CLASSES, classify_route
from .tracing import current_span

__all__ = ["RESOURCES", "COST_WEIGHTS", "CostLedger", "get_ledger",
           "set_ledger", "reset_ledger", "charge", "resolve_context"]

#: every resource the ledger accounts; charges to other names raise
RESOURCES = ("queue_wait_seconds", "device_seconds", "compile_seconds",
             "h2d_bytes", "d2h_bytes", "kv_page_seconds",
             "padding_waste_rows")

#: scalarization weights for the heavy-hitter ranking — device time is
#: the unit (1.0); bytes and pages are scaled so a typical request's
#: transfer volume lands in the same order of magnitude as its compute
COST_WEIGHTS: Dict[str, float] = {
    "queue_wait_seconds": 0.1,       # waiting burns latency, not devices
    "device_seconds": 1.0,
    "compile_seconds": 1.0,
    "h2d_bytes": 1e-9,               # ~1 GB ≈ 1 device-second
    "d2h_bytes": 1e-9,
    "kv_page_seconds": 0.01,         # holding HBM is cheaper than using it
    "padding_waste_rows": 1e-4,
}

#: env knob: heavy-hitter table capacity (docs/performance.md)
TOPK_ENV = "MMLSPARK_TPU_COST_TOPK"
DEFAULT_TOP_K = 32

_M_COST = _metric_counter(
    "mmlspark_cost_total",
    "Attributed resource consumption by workload class; units are per "
    "resource (seconds, bytes, page-seconds, rows)",
    ("transport", "route", "model", "tenant", "resource"))
_M_COST_CHARGES = _metric_counter(
    "mmlspark_cost_charges_total",
    "Individual ledger charges by workload class",
    ("transport", "route", "model", "tenant"))
_M_COST_HH = _metric_gauge(
    "mmlspark_cost_heavy_hitters",
    "Entries currently held by the ledger's top-K heavy-hitter table")

_UNTRACED = ("untraced", "untraced", "default", DEFAULT_TENANT)
_OVERFLOW = ("other", "other", "other", "other")

ClassKey = Tuple[str, str, str, str]


def resolve_context() -> Tuple[ClassKey, Optional[str]]:
    """``(workload class, trace id)`` for the active trace context.

    The class comes from the root span's attrs (stamped by
    ``WorkerServer._enqueue``): ``transport``, ``route`` (falling back to
    :func:`classify_route` over the stamped ``url``), ``model``,
    ``tenant``. Outside any trace: the ``untraced`` class and no id."""
    span = current_span()
    if span is None:
        return _UNTRACED, None
    root = span.trace.root
    attrs = root.attrs if root is not None else span.attrs
    route = attrs.get("route")
    if route is None:
        route = classify_route(attrs.get("url"))
    key = (str(attrs.get("transport", "untraced")), str(route),
           str(attrs.get("model", "default")),
           str(attrs.get("tenant", DEFAULT_TENANT)))
    return key, span.trace.trace_id


class _HeavyHitters:
    """SpaceSaving top-K over trace ids, keyed by weighted scalar cost.

    A full table evicts its cheapest entry; the newcomer inherits the
    victim's cost as its overestimation floor (``error``), the classic
    Metwally et al. guarantee: true cost ∈ [cost - error, cost]."""

    __slots__ = ("k", "_items")

    def __init__(self, k: int):
        self.k = max(1, int(k))
        # trace_id -> [cost, error, class_key]
        self._items: Dict[str, list] = {}

    def add(self, trace_id: str, weighted: float, key: ClassKey) -> None:
        e = self._items.get(trace_id)
        if e is not None:
            e[0] += weighted
            e[2] = key
            return
        if len(self._items) < self.k:
            self._items[trace_id] = [weighted, 0.0, key]
            return
        victim = min(self._items, key=lambda t: self._items[t][0])
        floor = self._items.pop(victim)[0]
        self._items[trace_id] = [floor + weighted, floor, key]

    def top(self) -> List[dict]:
        rows = sorted(self._items.items(), key=lambda kv: -kv[1][0])
        return [{"trace_id": tid, "cost": round(cost, 9),
                 "error": round(err, 9),
                 "transport": key[0], "route": key[1], "model": key[2],
                 "tenant": key[3]}
                for tid, (cost, err, key) in rows]

    def __len__(self) -> int:
        return len(self._items)


class _ClassCosts:
    __slots__ = ("resources", "charges")

    def __init__(self):
        self.resources: Dict[str, float] = {r: 0.0 for r in RESOURCES}
        self.charges = 0


class CostLedger:
    """Process-global per-class resource accounting + top-K heavy hitters.

    All mutation is under one lock; the per-charge cost is a dict lookup
    plus a few float adds (the mirrored counter increments outside the
    lock, same ordering discipline as the SLO tracker's)."""

    def __init__(self, max_classes: int = MAX_CLASSES,
                 top_k: Optional[int] = None):
        if top_k is None:
            try:
                top_k = int(os.environ.get(TOPK_ENV, DEFAULT_TOP_K))
            except ValueError:
                top_k = DEFAULT_TOP_K
        self._max_classes = int(max_classes)
        self._lock = threading.Lock()
        self._classes: Dict[ClassKey, _ClassCosts] = {}
        self._hh = _HeavyHitters(top_k)

    # -- charging ------------------------------------------------------------
    def _class(self, key: ClassKey) -> _ClassCosts:
        cls = self._classes.get(key)
        if cls is None:
            if len(self._classes) >= self._max_classes:
                key = _OVERFLOW
                cls = self._classes.get(key)
                if cls is not None:
                    return cls
            cls = self._classes[key] = _ClassCosts()
        return cls

    def charge(self, resource: str, amount: float,
               cls: Optional[ClassKey] = None,
               trace_id: Optional[str] = None) -> None:
        """Charge ``amount`` of ``resource`` to a workload class.

        With no explicit ``cls``/``trace_id`` both resolve from the
        active trace context (:func:`resolve_context`) — the common path
        for code already running under the request's span. Explicit
        arguments serve deferred charges (KV page frees, decoder tick
        apportionment) where the consuming context is long gone."""
        if resource not in COST_WEIGHTS:
            raise ValueError(f"unknown ledger resource: {resource!r}")
        amount = float(amount)
        if amount <= 0.0:
            return
        if cls is None:
            cls, ambient_tid = resolve_context()
            if trace_id is None:
                trace_id = ambient_tid
        weighted = amount * COST_WEIGHTS[resource]
        with self._lock:
            c = self._class(cls)
            c.resources[resource] += amount
            c.charges += 1
            if trace_id:
                self._hh.add(trace_id, weighted, cls)
            hh_len = len(self._hh)
        _M_COST.inc(amount, transport=cls[0], route=cls[1], model=cls[2],
                    tenant=cls[3], resource=resource)
        _M_COST_CHARGES.inc(transport=cls[0], route=cls[1], model=cls[2],
                            tenant=cls[3])
        _M_COST_HH.set(hh_len)

    def charge_shares(self, resource: str, amount: float,
                      shares: Iterable[Tuple[ClassKey, Optional[str],
                                             float]]) -> None:
        """Apportion ``amount`` across ``(cls, trace_id, weight)`` shares.

        The decoder's per-tick device time is one measurement covering
        many live slots: each slot gets ``amount * weight / sum(weights)``
        charged to its own class and trace. Zero/negative weights drop
        out; an empty share list charges nothing.

        The decoder calls this twice a tick over every live slot, on the
        thread that issues the device work, so the whole list takes the
        lock once and looks each class's counters up once; the ledger, the
        counters and the heavy hitters end as :meth:`charge` called once a
        share, in order, would leave them."""
        shares = [(cls, tid, float(w)) for cls, tid, w in shares
                  if float(w) > 0.0]
        total = sum(w for _, _, w in shares)
        if total <= 0.0:
            return
        if resource not in COST_WEIGHTS:
            raise ValueError(f"unknown ledger resource: {resource!r}")
        weight = COST_WEIGHTS[resource]
        ambient = None
        charged = []
        with self._lock:
            for cls, tid, w in shares:
                part = float(amount * (w / total))
                if part <= 0.0:
                    continue
                if cls is None:
                    if ambient is None:
                        ambient = resolve_context()
                    cls = ambient[0]
                    if tid is None:
                        tid = ambient[1]
                c = self._class(cls)
                c.resources[resource] += part
                c.charges += 1
                if tid:
                    self._hh.add(tid, part * weight, cls)
                charged.append((cls, part))
            hh_len = len(self._hh)
        series = {}
        for cls, part in charged:
            pair = series.get(cls)
            if pair is None:
                labels = dict(transport=cls[0], route=cls[1], model=cls[2],
                              tenant=cls[3])
                pair = series[cls] = (
                    _M_COST.labels(resource=resource, **labels),
                    _M_COST_CHARGES.labels(**labels))
            pair[0].inc(part)
            pair[1].inc()
        if charged:
            _M_COST_HH.set(hh_len)

    # -- reading -------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """JSON-safe ledger view: per-class resource totals + weighted
        scalar cost, the heavy-hitter table (descending cost), and the
        weights the scalarization used."""
        with self._lock:
            items = sorted(self._classes.items())
            views = [(key, dict(c.resources), c.charges)
                     for key, c in items]
            hh = self._hh.top()
            top_k = self._hh.k
        classes: List[Dict[str, object]] = []
        for (transport, route, model, tenant), res, charges in views:
            weighted = sum(res[r] * COST_WEIGHTS[r] for r in RESOURCES)
            classes.append({
                "transport": transport, "route": route, "model": model,
                "tenant": tenant, "charges": charges,
                "resources": {r: round(v, 9) for r, v in res.items()},
                "weighted_cost": round(weighted, 9)})
        return {"t": time.time(), "top_k": top_k,
                "weights": dict(COST_WEIGHTS),
                "classes": classes, "heavy_hitters": hh}

    def class_totals(self, resource: str) -> Dict[ClassKey, float]:
        """``{class: total}`` for one resource (test/reconciliation aid)."""
        with self._lock:
            return {key: c.resources.get(resource, 0.0)
                    for key, c in self._classes.items()}

    def reset(self) -> None:
        with self._lock:
            self._classes.clear()
            self._hh = _HeavyHitters(self._hh.k)


# -- the process-global ledger ------------------------------------------------

_ledger_lock = threading.Lock()
_ledger: Optional[CostLedger] = None


def get_ledger() -> CostLedger:
    """The process-global ledger, created on first use — the one every
    charge site (server, runner, decoder, pools, residency) reports to."""
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = CostLedger()
        return _ledger


def set_ledger(ledger: Optional[CostLedger]) -> None:
    """Install a specific ledger (tests, custom top-K)."""
    global _ledger
    with _ledger_lock:
        _ledger = ledger


def reset_ledger() -> None:
    """Drop the global ledger (test hook — pair with
    ``observability.reset_all`` to zero the mirrored metric series)."""
    set_ledger(None)


def charge(resource: str, amount: float,
           cls: Optional[ClassKey] = None,
           trace_id: Optional[str] = None) -> None:
    """Module-level convenience: ``get_ledger().charge(...)`` — the
    one-liner charge sites import."""
    get_ledger().charge(resource, amount, cls=cls, trace_id=trace_id)
