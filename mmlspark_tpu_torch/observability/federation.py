"""Cluster-wide metrics federation over the heartbeat plane.

Every observability surface so far is per-process: each worker's
registry, SLO tracker, and cost ledger know only their own traffic. The
driver registry (``serving/distributed.py``) already hears from every
worker a few times a second — this module is the aggregation half that
turns those heartbeats into one cluster view:

- workers build a **compact telemetry snapshot** (:func:`worker_snapshot`
  — counters + histograms from the global registry plus the SLO class
  totals; gauges are deliberately excluded, summing a p99 gauge across
  workers is a lie) and piggyback it on the heartbeat at an env-gated
  interval (``MMLSPARK_TPU_FEDERATION_INTERVAL``), size-bounded by
  ``MMLSPARK_TPU_FEDERATION_MAX_BYTES``;
- the driver feeds them to a :class:`ClusterAggregator`, which merges
  per-series with **counter-reset detection**: per ``(worker, series)``
  it keeps the last reported value and an accumulated total, so a
  restarted worker (value drops below last) contributes its full new
  value instead of a negative delta — a merged counter **never goes
  backwards**;
- ``GET /debug/cluster`` on the driver serves the merged Prometheus
  text (:meth:`ClusterAggregator.render`), the cluster SLO scorecard
  (:meth:`ClusterAggregator.scorecard`), and the per-worker health
  digests the heartbeat carries.

The aggregator also maintains driver-local ``mmlspark_cluster_*``
metrics (worker count, snapshots ingested, resets detected) so the
federation plane is itself observable.

The port's copy of ``mmlspark_tpu/observability/federation.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .exposition import _escape_help, _escape_label, _fmt_value
from .registry import counter as _metric_counter
from .registry import gauge as _metric_gauge
from .registry import snapshot as _registry_snapshot
from .slo import get_tracker

__all__ = ["FEDERATION_INTERVAL_ENV", "FEDERATION_MAX_BYTES_ENV",
           "ClusterAggregator", "worker_snapshot", "snapshot_interval"]

#: seconds between telemetry snapshots attached to heartbeats; 0 attaches
#: on every heartbeat, negative disables federation entirely
FEDERATION_INTERVAL_ENV = "MMLSPARK_TPU_FEDERATION_INTERVAL"
#: upper bound on the serialized telemetry payload; oversized snapshots
#: shed histograms first, then metrics, keeping the SLO totals
FEDERATION_MAX_BYTES_ENV = "MMLSPARK_TPU_FEDERATION_MAX_BYTES"
DEFAULT_MAX_BYTES = 262144

_M_SNAPSHOTS = _metric_counter(
    "mmlspark_cluster_snapshots_total",
    "Worker telemetry snapshots ingested by the cluster aggregator")
_M_RESETS = _metric_counter(
    "mmlspark_cluster_counter_resets_total",
    "Counter resets detected while merging worker telemetry (worker "
    "restarts); merged counters absorb these without going backwards")
_M_WORKERS = _metric_gauge(
    "mmlspark_cluster_workers",
    "Workers the cluster aggregator has heard telemetry from")


def snapshot_interval() -> float:
    """The env-gated federation interval: seconds between snapshots
    (0 = every heartbeat), negative = disabled."""
    try:
        return float(os.environ.get(FEDERATION_INTERVAL_ENV, "0") or 0)
    except ValueError:
        return 0.0


def _slo_totals() -> List[dict]:
    """The SLO tracker's cumulative per-class totals — the only part of
    the scorecard that federates exactly (window views don't sum across
    skewed clocks)."""
    card = get_tracker().scorecard()
    return [{"transport": c["transport"], "route": c["route"],
             "model": c["model"], "tenant": c.get("tenant", "default"),
             "total": c["total"], "errors_total": c["errors_total"],
             "shed_total": c["shed_total"]}
            for c in card.get("classes", [])]


def worker_snapshot(max_bytes: Optional[int] = None) -> dict:
    """The compact telemetry payload a worker piggybacks on a heartbeat.

    ``{"metrics": {...}, "slo": {"classes": [...]}}`` — counters and
    histograms only (monotone series merge honestly; gauges don't).
    When the serialized payload exceeds the bound, histograms are shed
    first, then all metrics; the SLO totals always fit."""
    if max_bytes is None:
        try:
            max_bytes = int(os.environ.get(FEDERATION_MAX_BYTES_ENV,
                                           DEFAULT_MAX_BYTES))
        except ValueError:
            max_bytes = DEFAULT_MAX_BYTES
    full = _registry_snapshot()
    metrics = {name: m for name, m in full.items()
               if m.get("type") in ("counter", "histogram")}
    payload = {"metrics": metrics, "slo": {"classes": _slo_totals()}}
    if len(json.dumps(payload)) <= max_bytes:
        return payload
    payload["metrics"] = {name: m for name, m in metrics.items()
                          if m.get("type") == "counter"}
    if len(json.dumps(payload)) <= max_bytes:
        return payload
    return {"metrics": {}, "slo": {"slo_classes_only": True,
                                   "classes": _slo_totals()}}


def _series_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _CounterState:
    __slots__ = ("last", "acc")

    def __init__(self):
        self.last = 0.0
        self.acc = 0.0

    def feed(self, value: float) -> bool:
        """Accumulate a new cumulative reading; True on detected reset."""
        reset = value < self.last
        self.acc += value if reset else value - self.last
        self.last = value
        return reset


class _HistState:
    __slots__ = ("last_sum", "last_count", "last_buckets",
                 "acc_sum", "acc_count", "acc_buckets")

    def __init__(self):
        self.last_sum = self.last_count = 0.0
        self.last_buckets: Dict[str, float] = {}
        self.acc_sum = self.acc_count = 0.0
        self.acc_buckets: Dict[str, float] = {}

    def feed(self, s: dict) -> bool:
        count = float(s.get("count", 0.0))
        total = float(s.get("sum", 0.0))
        buckets = {str(k): float(v)
                   for k, v in (s.get("buckets") or {}).items()}
        # the count is the reset sentinel: a restarted worker's histogram
        # starts from zero in every field at once
        reset = count < self.last_count
        if reset:
            self.last_sum = self.last_count = 0.0
            self.last_buckets = {}
        self.acc_sum += total - self.last_sum
        self.acc_count += count - self.last_count
        for k, v in buckets.items():
            self.acc_buckets[k] = (self.acc_buckets.get(k, 0.0)
                                   + v - self.last_buckets.get(k, 0.0))
        self.last_sum, self.last_count = total, count
        self.last_buckets = buckets
        return reset


class _SloState:
    __slots__ = ("last", "acc")

    def __init__(self):
        self.last = {"total": 0.0, "errors_total": 0.0, "shed_total": 0.0}
        self.acc = {"total": 0.0, "errors_total": 0.0, "shed_total": 0.0}

    def feed(self, row: dict) -> bool:
        reset = float(row.get("total", 0.0)) < self.last["total"]
        if reset:
            self.last = {k: 0.0 for k in self.last}
        for k in self.acc:
            v = float(row.get(k, 0.0))
            self.acc[k] += v - self.last[k]
            self.last[k] = v
        return reset


class ClusterAggregator:
    """Merges per-worker telemetry into one monotone cluster view.

    Per ``(worker, series)`` state survives worker restarts and
    deregistrations on purpose: the merged counter is the sum of each
    worker's *accumulated* total, so a worker leaving (or resetting)
    never subtracts history from the cluster."""

    def __init__(self):
        self._lock = threading.Lock()
        # worker -> series-key -> state
        self._counters: Dict[str, Dict[tuple, _CounterState]] = {}
        self._hists: Dict[str, Dict[tuple, _HistState]] = {}
        self._slo: Dict[str, Dict[tuple, _SloState]] = {}
        # metric metadata (help/type/bucket keys) from the last snapshot
        # that carried each name
        self._meta: Dict[str, Dict[str, str]] = {}
        self._last_seen: Dict[str, float] = {}
        self.snapshots = 0
        self.resets = 0

    # -- ingest --------------------------------------------------------------
    def ingest(self, worker_id: str, telemetry: dict) -> None:
        """Feed one worker snapshot (:func:`worker_snapshot` shape).

        Malformed sub-structures are skipped series-by-series — one bad
        worker must not poison the cluster view."""
        if not isinstance(telemetry, dict):
            return
        worker_id = str(worker_id)
        resets = 0
        with self._lock:
            self.snapshots += 1
            self._last_seen[worker_id] = time.time()
            metrics = telemetry.get("metrics")
            if isinstance(metrics, dict):
                resets += self._ingest_metrics(worker_id, metrics)
            slo = telemetry.get("slo")
            if isinstance(slo, dict):
                resets += self._ingest_slo(worker_id, slo)
            self.resets += resets
            n_workers = len(self._last_seen)
        _M_SNAPSHOTS.inc()
        if resets:
            _M_RESETS.inc(resets)
        _M_WORKERS.set(n_workers)

    def _ingest_metrics(self, worker_id: str, metrics: dict) -> int:
        counters = self._counters.setdefault(worker_id, {})
        hists = self._hists.setdefault(worker_id, {})
        resets = 0
        for name, m in metrics.items():
            if not isinstance(m, dict):
                continue
            kind = m.get("type")
            if kind not in ("counter", "histogram"):
                continue
            self._meta[str(name)] = {"type": kind,
                                     "help": str(m.get("help", ""))}
            for s in m.get("series") or []:
                if not isinstance(s, dict):
                    continue
                labels = s.get("labels")
                if not isinstance(labels, dict):
                    continue
                key = (str(name), _series_key(labels))
                try:
                    if kind == "counter":
                        st = counters.get(key)
                        if st is None:
                            st = counters[key] = _CounterState()
                        resets += st.feed(float(s.get("value", 0.0)))
                    else:
                        st = hists.get(key)
                        if st is None:
                            st = hists[key] = _HistState()
                        resets += st.feed(s)
                except (TypeError, ValueError):
                    continue
        return resets

    def _ingest_slo(self, worker_id: str, slo: dict) -> int:
        states = self._slo.setdefault(worker_id, {})
        resets = 0
        for row in slo.get("classes") or []:
            if not isinstance(row, dict):
                continue
            key = (str(row.get("transport", "?")),
                   str(row.get("route", "?")),
                   str(row.get("model", "?")),
                   str(row.get("tenant", "default")))
            st = states.get(key)
            if st is None:
                st = states[key] = _SloState()
            try:
                resets += st.feed(row)
            except (TypeError, ValueError):
                continue
        return resets

    def forget(self, worker_id: str) -> None:
        """Stop counting ``worker_id`` toward the live-worker gauge. Its
        accumulated series stay in the merge — history is not deducted."""
        with self._lock:
            self._last_seen.pop(str(worker_id), None)
            n = len(self._last_seen)
        _M_WORKERS.set(n)

    # -- reading -------------------------------------------------------------
    def merged_snapshot(self) -> Dict[str, dict]:
        """Registry-``snapshot()``-shaped merge across all workers."""
        with self._lock:
            merged_c: Dict[str, Dict[tuple, float]] = {}
            for series in self._counters.values():
                for (name, labels), st in series.items():
                    merged_c.setdefault(name, {})
                    merged_c[name][labels] = (
                        merged_c[name].get(labels, 0.0) + st.acc)
            merged_h: Dict[str, Dict[tuple, list]] = {}
            for series in self._hists.values():
                for (name, labels), st in series.items():
                    acc = merged_h.setdefault(name, {}).get(labels)
                    if acc is None:
                        acc = merged_h[name][labels] = [0.0, 0.0, {}]
                    acc[0] += st.acc_sum
                    acc[1] += st.acc_count
                    for k, v in st.acc_buckets.items():
                        acc[2][k] = acc[2].get(k, 0.0) + v
            meta = dict(self._meta)
        out: Dict[str, dict] = {}
        for name in sorted(set(merged_c) | set(merged_h)):
            m = meta.get(name, {"type": "counter", "help": ""})
            series = []
            if name in merged_c:
                for labels, value in sorted(merged_c[name].items()):
                    series.append({"labels": dict(labels), "value": value})
            if name in merged_h:
                for labels, (total, count, buckets) in \
                        sorted(merged_h[name].items()):
                    series.append({"labels": dict(labels), "sum": total,
                                   "count": count,
                                   "buckets": dict(buckets)})
            out[name] = {"type": m["type"], "help": m["help"],
                         "series": series}
        return out

    def render(self) -> str:
        """Merged Prometheus text (exposition 0.0.4) — same line shapes
        as the per-worker ``/metrics``, values summed cluster-wide."""
        lines: List[str] = []
        for name, m in self.merged_snapshot().items():
            lines.append(f"# HELP {name} {_escape_help(m['help'])}")
            lines.append(f"# TYPE {name} {m['type']}")
            for s in m["series"]:
                labelstr = ",".join(
                    f'{k}="{_escape_label(str(v))}"'
                    for k, v in sorted(s["labels"].items()))
                if "buckets" in s:
                    for bk in sorted(s["buckets"],
                                     key=lambda k: (k == "+Inf",
                                                    _bucket_sort(k))):
                        le = f'le="{_le_value(bk)}"'
                        full = ",".join(x for x in (labelstr, le) if x)
                        lines.append(f"{name}_bucket{{{full}}} "
                                     f"{_fmt_value(s['buckets'][bk])}")
                    br = f"{{{labelstr}}}" if labelstr else ""
                    lines.append(f"{name}_sum{br} "
                                 f"{_fmt_value(s['sum'])}")
                    lines.append(f"{name}_count{br} "
                                 f"{_fmt_value(s['count'])}")
                else:
                    br = f"{{{labelstr}}}" if labelstr else ""
                    lines.append(f"{name}{br} {_fmt_value(s['value'])}")
        return "\n".join(lines) + "\n" if lines else ""

    def scorecard(self) -> Dict[str, object]:
        """Cluster SLO scorecard: cumulative per-class totals merged
        monotone across every worker ever heard from."""
        with self._lock:
            merged: Dict[tuple, Dict[str, float]] = {}
            for states in self._slo.values():
                for key, st in states.items():
                    acc = merged.setdefault(
                        key, {"total": 0.0, "errors_total": 0.0,
                              "shed_total": 0.0})
                    for k, v in st.acc.items():
                        acc[k] += v
            workers = len(self._last_seen)
            snapshots = self.snapshots
            resets = self.resets
        classes = []
        for (transport, route, model, tenant) in sorted(merged):
            acc = merged[(transport, route, model, tenant)]
            total = acc["total"]
            availability = ((total - acc["errors_total"]) / total
                            if total else None)
            classes.append({
                "transport": transport, "route": route, "model": model,
                "tenant": tenant, "total": int(acc["total"]),
                "errors_total": int(acc["errors_total"]),
                "shed_total": int(acc["shed_total"]),
                "availability": availability})
        return {"t": time.time(), "workers": workers,
                "snapshots": snapshots, "counter_resets": resets,
                "classes": classes}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()
            self._slo.clear()
            self._meta.clear()
            self._last_seen.clear()
            self.snapshots = 0
            self.resets = 0
        _M_WORKERS.set(0)


def _bucket_sort(key: str) -> float:
    try:
        return float(key)
    except ValueError:
        return float("inf")


def _le_value(key: str) -> str:
    if key == "+Inf":
        return "+Inf"
    try:
        return _fmt_value(float(key))
    except ValueError:
        return key
