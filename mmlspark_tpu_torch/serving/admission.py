"""Tenant-fair admission and prefix-affine placement primitives (the
port's copy of ``mmlspark_tpu/serving/admission.py``).

Two pieces of the multi-tenant traffic plane live here, deliberately
transport-free so they unit-test without sockets:

- :class:`AdmissionQueue` — a drop-in for the ``queue.Queue`` surface
  :class:`~mmlspark_tpu_torch.serving.server.WorkerServer` uses (``full`` /
  ``put_nowait`` / ``put`` / ``get`` / ``get_nowait`` / ``qsize`` /
  ``maxsize``), but internally deficit-round-robin over per-tenant FIFOs:
  each tenant's share of dequeues tracks its configured weight, a burst
  from one tenant cannot starve the rest, and admission sheds the
  over-budget tenant FIRST (``TenantOverBudget``, a ``queue.Full``
  subclass so existing shed paths keep working). The queue also measures
  its own drain rate (EWMA of dequeue intervals) so 429 ``Retry-After``
  hints can reflect the live backlog instead of a static knob.

- :class:`ConsistentHashRing` — virtual-node consistent hashing with
  bounded-load fallback, the placement structure behind prefix-affine
  request routing in the reference's ``serving/distributed.py``: keys
  (KV-prefix hashes from ``PagedKVPool.prefix_hash``) map to the same
  worker across membership changes except for the 1/n of keyspace a
  joined/left node actually owns — unlike ``hash(key) % len(peers)``,
  which reshuffles every key on any membership change.

Within a single tenant FIFO order is preserved, so the epoch/replay
semantics of the worker server are unchanged; with one active tenant the
whole structure degenerates to the old single FIFO.
"""

from __future__ import annotations

import bisect
import hashlib
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Mapping, Optional

from ..observability import counter as _metric_counter
from ..observability import gauge as _metric_gauge

__all__ = ["AdmissionQueue", "TenantOverBudget", "ConsistentHashRing"]

_M_WFQ_ENQ = _metric_counter(
    "mmlspark_wfq_enqueued_total",
    "Requests admitted into the weighted-fair admission queue",
    ("tenant",))
_M_WFQ_DEQ = _metric_counter(
    "mmlspark_wfq_dequeued_total",
    "Requests dequeued from the weighted-fair admission queue (DRR order)",
    ("tenant",))
_M_WFQ_SHED = _metric_counter(
    "mmlspark_wfq_shed_total",
    "Requests refused by tenant-aware admission control",
    ("tenant", "reason"))
_M_RING_REBUILDS = _metric_counter(
    "mmlspark_ring_rebuilds_total",
    "Consistent-hash ring rebuilds (worker join/leave/restart)")
_M_RING_ROUTES = _metric_counter(
    "mmlspark_ring_routes_total",
    "Keyed routing decisions by outcome: affine (first ring choice), "
    "fallback (bounded-load walked past an overloaded owner)",
    ("outcome",))
_M_RING_WORKERS = _metric_gauge(
    "mmlspark_ring_workers",
    "Live workers currently on the consistent-hash ring")

#: tenants beyond this many distinct metric labels collapse to "other" —
#: same cardinality discipline as the SLO tracker's MAX_CLASSES
MAX_TENANT_LABELS = 32

_tenant_labels: set = set()
_tenant_labels_lock = threading.Lock()


def _tenant_label(tenant: str) -> str:
    """Cardinality-bounded metric label for a free-form tenant string."""
    t = str(tenant)
    with _tenant_labels_lock:
        if t in _tenant_labels:
            return t
        if len(_tenant_labels) < MAX_TENANT_LABELS:
            _tenant_labels.add(t)
            return t
    return "other"


class TenantOverBudget(queue.Full):
    """One tenant exceeded its weighted share of the queue while capacity
    remains for others — subclasses ``queue.Full`` so every existing
    full-queue handling path (shed, enqueue race-undo) treats it as a
    shed, while carrying enough context to scale ``Retry-After`` to the
    offender's deficit."""

    def __init__(self, tenant: str, depth: int, budget: int):
        super().__init__()
        self.tenant = tenant
        self.depth = depth
        self.budget = budget
        self.reason = "tenant_budget"


class AdmissionQueue:
    """Deficit-round-robin weighted-fair queue over per-tenant FIFOs.

    ``weight_fn(tenant) -> float`` supplies tenant weights (typically
    ``ModelRegistry.tenant_weight``); unknown tenants weigh 1. Dequeue
    order gives each *backlogged* tenant a per-round quantum proportional
    to its weight, so under contention goodput shares track weights.

    ``maxsize`` bounds total depth exactly like ``queue.Queue``. On top
    of that, each tenant's standing backlog is budgeted at its weighted
    share of ``maxsize`` times ``burst`` (headroom so a lone tenant can
    still use the whole queue): :meth:`check_admit` / :meth:`put_nowait`
    raise :class:`TenantOverBudget` for the over-budget tenant before
    the global ``queue.Full``. :meth:`put` bypasses budgets — it is the
    replay path, and already-admitted requests must never be dropped.
    """

    #: floor for configured weights, so a zero/negative weight cannot
    #: stall the DRR scan or zero a tenant's budget entirely
    MIN_WEIGHT = 1e-3
    #: EWMA smoothing for the dequeue-interval estimate
    DRAIN_ALPHA = 0.2
    #: ceiling for suggested Retry-After hints (seconds)
    MAX_RETRY_AFTER = 30.0
    #: a dequeue gap beyond this is an idle period, not a drain interval:
    #: it neither feeds the EWMA nor lets a stale estimate answer
    #: suggest_retry_after (the time-series history answers instead)
    IDLE_GAP_SECONDS = 5.0

    def __init__(self, maxsize: int = 0,
                 weight_fn: Optional[Callable[[str], float]] = None,
                 burst: float = 2.0):
        self.maxsize = int(maxsize)
        self.burst = float(burst)
        self._weight_fn = weight_fn
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        #: tenant → FIFO of parked items (only backlogged tenants present)
        self._queues: Dict[str, deque] = {}
        #: active-tenant round order + DRR scan position
        self._order: List[str] = []
        self._cursor = 0
        self._deficits: Dict[str, float] = {}
        self._size = 0
        # drain-rate EWMA state (seconds between dequeues)
        self._last_dequeue: Optional[float] = None
        self._ewma_interval: Optional[float] = None
        #: label value tying this queue to its ``mmlspark_queue_drain_rate``
        #: series in the time-series store (WorkerServer sets the port);
        #: None means no history — suggest_retry_after falls back to the
        #: live EWMA alone
        self.history_key: Optional[str] = None

    # -- weights / budgets --------------------------------------------------
    def _weight(self, tenant: str) -> float:
        if self._weight_fn is None:
            return 1.0
        try:
            w = float(self._weight_fn(tenant))
        except Exception:
            w = 1.0
        return max(w, self.MIN_WEIGHT)

    def _budget_locked(self, tenant: str) -> int:
        """Tenant backlog budget: weighted share of maxsize with ``burst``
        headroom, computed over the tenants currently backlogged plus the
        arriving one. A lone tenant's budget is >= maxsize (the global
        bound is the only limit — old FIFO behavior)."""
        if self.maxsize <= 0:
            return 1 << 30
        active = set(self._order)
        active.add(tenant)
        total_w = sum(self._weight(t) for t in active)
        share = self._weight(tenant) / total_w if total_w > 0 else 1.0
        return max(1, int(self.maxsize * share * self.burst))

    # -- queue.Queue surface ------------------------------------------------
    def qsize(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0

    def full(self) -> bool:
        return 0 < self.maxsize <= self._size

    def depth(self, tenant: str) -> int:
        with self._lock:
            q = self._queues.get(str(tenant))
            return len(q) if q is not None else 0

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items()}

    def check_admit(self, tenant: str) -> None:
        """Raise ``queue.Full`` (global) or :class:`TenantOverBudget`
        (tenant over its weighted share) if admitting one more request
        for ``tenant`` should shed instead. Advisory — the authoritative
        check re-runs inside :meth:`put_nowait` (admission race)."""
        tenant = str(tenant)
        with self._lock:
            self._check_admit_locked(tenant)

    def _check_admit_locked(self, tenant: str) -> None:
        if 0 < self.maxsize <= self._size:
            _M_WFQ_SHED.inc(tenant=_tenant_label(tenant),
                            reason="queue_full")
            raise queue.Full
        q = self._queues.get(tenant)
        depth = len(q) if q is not None else 0
        budget = self._budget_locked(tenant)
        if depth >= budget:
            _M_WFQ_SHED.inc(tenant=_tenant_label(tenant),
                            reason="tenant_budget")
            raise TenantOverBudget(tenant, depth, budget)

    def put_nowait(self, item) -> None:
        tenant = str(getattr(item, "tenant", "default"))
        with self._lock:
            self._check_admit_locked(tenant)
            self._append_locked(item, tenant)
        _M_WFQ_ENQ.inc(tenant=_tenant_label(tenant))

    def put(self, item) -> None:
        """Unconditional append — the replay/rehydration path. Requests
        that were already admitted once must survive an engine restart
        even when budgets have tightened in between."""
        tenant = str(getattr(item, "tenant", "default"))
        with self._lock:
            self._append_locked(item, tenant)
        _M_WFQ_ENQ.inc(tenant=_tenant_label(tenant))

    def _append_locked(self, item, tenant: str) -> None:
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._order.append(tenant)
            # a newly-backlogged tenant starts its round with zero banked
            # deficit — idle time earns no credit
            self._deficits[tenant] = 0.0
        q.append(item)
        self._size += 1
        self._not_empty.notify()

    def get(self, block: bool = True, timeout: Optional[float] = None):
        with self._not_empty:
            if not block:
                if self._size == 0:
                    raise queue.Empty
                return self._pop_locked()
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while self._size == 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._not_empty.wait(remaining)
            return self._pop_locked()

    def get_nowait(self):
        return self.get(block=False)

    # -- DRR core -----------------------------------------------------------
    def _retire_locked(self, tenant: str) -> None:
        idx = self._order.index(tenant)
        self._order.pop(idx)
        if idx < self._cursor:
            self._cursor -= 1
        self._deficits.pop(tenant, None)
        self._queues.pop(tenant, None)

    def _pop_locked(self):
        """One DRR dequeue. Each visit tops a tenant's deficit up by its
        weight once per round; the tenant then serves consecutive items
        while deficit >= 1, so per-round quanta (and hence drain shares)
        are proportional to weights. Guaranteed to terminate: size > 0
        means some FIFO is non-empty and every full scan cycle adds at
        least MIN_WEIGHT to its deficit."""
        while True:
            if self._cursor >= len(self._order):
                self._cursor = 0
            tenant = self._order[self._cursor]
            q = self._queues.get(tenant)
            if not q:
                self._retire_locked(tenant)
                continue
            if self._deficits[tenant] < 1.0:
                self._deficits[tenant] += self._weight(tenant)
            if self._deficits[tenant] >= 1.0:
                self._deficits[tenant] -= 1.0
                item = q.popleft()
                self._size -= 1
                if not q:
                    self._retire_locked(tenant)
                elif self._deficits[tenant] < 1.0:
                    self._cursor += 1   # quantum spent — next tenant
                self._note_dequeue_locked()
                _M_WFQ_DEQ.inc(tenant=_tenant_label(tenant))
                return item
            self._cursor += 1

    # -- drain rate / Retry-After -------------------------------------------
    def _note_dequeue_locked(self) -> None:
        now = time.monotonic()
        if self._last_dequeue is not None:
            dt = max(now - self._last_dequeue, 1e-6)
            # an idle gap is not a drain interval: folding it in used to
            # wreck the estimate for many EWMA steps after a lull (the
            # first post-idle 429 then suggested a near-ceiling
            # Retry-After). Re-anchor and keep the pre-idle estimate.
            if dt <= self.IDLE_GAP_SECONDS:
                if self._ewma_interval is None:
                    self._ewma_interval = dt
                else:
                    self._ewma_interval = (self.DRAIN_ALPHA * dt
                                           + (1 - self.DRAIN_ALPHA)
                                           * self._ewma_interval)
        self._last_dequeue = now

    def drain_rate(self) -> float:
        """Estimated dequeues/second (EWMA over recent intervals); 0.0
        until two dequeues have been observed."""
        with self._lock:
            iv = self._ewma_interval
        if iv is None or iv <= 0:
            return 0.0
        return 1.0 / iv

    def suggest_retry_after(self, floor: float = 1.0,
                            tenant: Optional[str] = None) -> float:
        """Load-aware 429 ``Retry-After``: current backlog over the
        measured drain rate, clamped to ``[floor, MAX_RETRY_AFTER]``.
        For a tenant shed over budget, scaled up by how far over budget
        that tenant is (its deficit), so the worst offender backs off
        hardest. ``floor`` keeps the configured static knob as a lower
        bound.

        After an idle gap (or before two dequeues have ever happened)
        the live EWMA knows nothing — the estimate is seeded from the
        time-series store's measured ``mmlspark_queue_drain_rate``
        history for this queue's ``history_key``, so the first 429 after
        a lull carries a realistic hint instead of the floor. Falls back
        to the live EWMA when the store is cold."""
        rate = self.drain_rate()
        with self._lock:
            last = self._last_dequeue
        stale = (last is None
                 or time.monotonic() - last > self.IDLE_GAP_SECONDS)
        if rate <= 0 or stale:
            seeded = self._history_drain_rate()
            if seeded is not None:
                rate = seeded
                # adopt the seed so drain_rate()/snapshot() agree with
                # the hint until live dequeues take over again
                with self._lock:
                    self._ewma_interval = 1.0 / seeded
        hint = (self._size / rate) if rate > 0 else floor
        if tenant is not None:
            with self._lock:
                q = self._queues.get(str(tenant))
                depth = len(q) if q is not None else 0
                budget = self._budget_locked(str(tenant))
            if budget > 0 and depth > budget:
                hint *= depth / budget
        return round(min(max(hint, floor), self.MAX_RETRY_AFTER), 3)

    def _history_drain_rate(self) -> Optional[float]:
        """Recent measured drain rate from the time-series store (the
        sampler records ``mmlspark_queue_drain_rate{port}`` every tick),
        or None when unkeyed / cold / unavailable. Queried outside the
        queue lock — the store takes its own."""
        key = self.history_key
        if key is None:
            return None
        try:
            # lazy: observability.timeseries must stay importable without
            # the serving plane and vice versa
            from ..observability.timeseries import get_store
            rate = get_store().ewma("mmlspark_queue_drain_rate",
                                    seconds=120.0, labels={"port": key})
        except Exception:
            return None
        if rate is None or rate <= 0:
            return None
        return float(rate)

    def snapshot(self) -> Dict[str, object]:
        """JSON-safe admission state for debug routes and heartbeats."""
        with self._lock:
            depths = {t: len(q) for t, q in self._queues.items()}
            deficits = {t: round(d, 4) for t, d in self._deficits.items()}
        return {"size": self._size, "maxsize": self.maxsize,
                "tenants": depths, "deficits": deficits,
                "drain_rate": round(self.drain_rate(), 4)}


def _ring_hash(data: str) -> int:
    """Stable 64-bit ring position (sha1 — same family as
    ``PagedKVPool.prefix_hash``, and NOT Python's salted ``hash()``)."""
    return int.from_bytes(
        hashlib.sha1(data.encode("utf-8")).digest()[:8], "big")


class ConsistentHashRing:
    """Consistent hashing with virtual nodes and bounded-load fallback.

    ``rebuild(nodes)`` replaces the membership (idempotent — same set is
    a no-op); ``route(key, load)`` returns the owning node for a key,
    walking to the next distinct ring position when the owner's current
    ``load`` exceeds ``load_factor`` times the mean (the bounded-load
    variant of consistent hashing), so a hot prefix cannot pin-down an
    overloaded worker. With ``replicas`` virtual nodes per member, a
    membership change moves only ~1/n of the keyspace.
    """

    def __init__(self, replicas: int = 64, load_factor: float = 1.25):
        self.replicas = max(1, int(replicas))
        self.load_factor = float(load_factor)
        self._lock = threading.Lock()
        self._nodes: tuple = ()
        self._hashes: List[int] = []
        self._owners: List[str] = []

    def rebuild(self, nodes: Iterable[str]) -> bool:
        """Set ring membership; True when the membership actually changed
        (counted in ``mmlspark_ring_rebuilds_total``)."""
        members = tuple(sorted({str(n) for n in nodes}))
        with self._lock:
            if members == self._nodes:
                return False
            points = []
            for node in members:
                for i in range(self.replicas):
                    points.append((_ring_hash(f"{node}#{i}"), node))
            points.sort()
            self._nodes = members
            self._hashes = [h for h, _ in points]
            self._owners = [n for _, n in points]
        _M_RING_REBUILDS.inc()
        _M_RING_WORKERS.set(len(members))
        return True

    def nodes(self) -> tuple:
        with self._lock:
            return self._nodes

    def __len__(self) -> int:
        return len(self.nodes())

    def preferred(self, key: str, n: Optional[int] = None) -> List[str]:
        """Distinct nodes in ring order starting at ``key``'s position —
        the affinity owner first, then each bounded-load fallback."""
        with self._lock:
            if not self._nodes:
                return []
            want = len(self._nodes) if n is None else min(n, len(self._nodes))
            start = bisect.bisect_left(self._hashes, _ring_hash(str(key)))
            out: List[str] = []
            for i in range(len(self._owners)):
                node = self._owners[(start + i) % len(self._owners)]
                if node not in out:
                    out.append(node)
                    if len(out) >= want:
                        break
            return out

    def route(self, key: str,
              load: Optional[Mapping[str, float]] = None) -> Optional[str]:
        """Owning node for ``key``; with a ``load`` map (node → in-flight
        count), falls back along the ring past nodes above
        ``load_factor`` x mean load. None on an empty ring."""
        order = self.preferred(key)
        if not order:
            return None
        if not load:
            _M_RING_ROUTES.inc(outcome="affine")
            return order[0]
        total = sum(float(load.get(n, 0)) for n in order)
        cap = self.load_factor * (total + 1) / len(order)
        for i, node in enumerate(order):
            if float(load.get(node, 0)) < cap:
                _M_RING_ROUTES.inc(outcome="affine" if i == 0
                                   else "fallback")
                return node
        # every node above cap (uniformly overloaded): the affinity owner
        # is still the best choice — its pool holds the prefix pages
        _M_RING_ROUTES.inc(outcome="affine")
        return order[0]
