"""Per-scenario SLO scorecards: BENCH-style JSON the tuner can learn from.

One scenario run produces one scorecard: goodput, coordinated-omission-
corrected latency quantiles (measured from each request's *scheduled*
send time — the open-loop number a closed-loop bench structurally cannot
see), shed rate, retry amplification, breaker flap count, DRR fairness
error against the configured tenant weights, and per-tenant cost joined
from the serving plane's ``/debug/costs`` payload. The same numbers are
mirrored to ``mmlspark_scenario_*`` metrics and harvested into the
``ObservationStore`` through the existing ``slo_scorecard`` source, so
``resolve_tuning`` sees traffic-shaped truth next to bench throughput.

Scorecard quantiles are ONE-SHOT batch statistics over a completed run's
sample list — not a rolling window (the serving plane's live windows stay
in ``observability.slo``); that is why this module computes them directly
instead of growing another tracker.

The port's copy of ``mmlspark_tpu/loadgen/scorecard.py``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

from ..observability import counter as _metric_counter
from ..observability import gauge as _metric_gauge
from ..observability import snapshot as _registry_snapshot
from ..tuning.observations import harvest_scorecard as _harvest_scorecard

__all__ = ["build_scorecard", "build_timeline", "counters_delta",
           "counters_snapshot", "fairness_error", "harvest_slo",
           "merged_requests_total", "quantiles_ms"]

_M_SCN_REQUESTS = _metric_counter(
    "mmlspark_scenario_requests_total",
    "Scenario-harness requests by final outcome (ok/shed/error/lost)",
    ("scenario", "outcome"))
_M_SCN_RETRIES = _metric_counter(
    "mmlspark_scenario_retries_total",
    "Scenario-harness retry sends (beyond each request's first attempt)",
    ("scenario",))
_M_SCN_GOODPUT = _metric_gauge(
    "mmlspark_scenario_goodput_rps",
    "Completed-OK request rate of the last run of each scenario",
    ("scenario",))
_M_SCN_P99 = _metric_gauge(
    "mmlspark_scenario_p99_ms",
    "Coordinated-omission-corrected open-loop p99 of the last run",
    ("scenario",))
_M_SCN_FAIRNESS = _metric_gauge(
    "mmlspark_scenario_fairness_error",
    "DRR fairness error (0 = per-tenant goodput shares match weights)",
    ("scenario",))
_M_SCN_SESSIONS = _metric_counter(
    "mmlspark_scenario_sessions_total",
    "Session-drill decode sessions by final outcome "
    "(completed/recovered/lost)", ("scenario", "outcome"))
_M_SCN_RECOVERY_P99 = _metric_gauge(
    "mmlspark_scenario_session_recovery_p99_ms",
    "p99 session failover latency (journal scan -> /_adopt accepted) of "
    "the last run", ("scenario",))


def _quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted sample list."""
    n = len(sorted_vals)
    k = int(round(q * (n - 1)))
    return float(sorted_vals[min(max(k, 0), n - 1)])


def quantiles_ms(latencies_s: Sequence[float]) -> Optional[Dict[str, float]]:
    """p50/p99/p999/max in milliseconds, None for an empty sample."""
    if not latencies_s:
        return None
    s = sorted(latencies_s)
    qs = {"p50_ms": 0.50, "p99_ms": 0.99, "p999_ms": 0.999}
    out = {name: round(_quantile(s, q) * 1e3, 3) for name, q in qs.items()}
    out["max_ms"] = round(s[-1] * 1e3, 3)
    out["n"] = len(s)
    return out


def fairness_error(goodput: Dict[str, float],
                   weights: Dict[str, float]) -> float:
    """Total-variation distance between achieved per-tenant goodput
    shares and the configured weight shares, over the tenants that sent
    traffic: 0.0 means DRR delivered exactly weight-proportional goodput,
    1.0 means one tenant got everything another was owed."""
    tenants = [t for t in weights if t in goodput]
    if not tenants:
        tenants = sorted(set(goodput) | set(weights))
    if not tenants:
        return 0.0
    g_total = sum(max(goodput.get(t, 0.0), 0.0) for t in tenants)
    w_total = sum(max(float(weights.get(t, 0.0)), 0.0) for t in tenants)
    if g_total <= 0 or w_total <= 0:
        return 0.0 if g_total == w_total else 1.0
    err = 0.0
    for t in tenants:
        g_share = max(goodput.get(t, 0.0), 0.0) / g_total
        w_share = max(float(weights.get(t, 0.0)), 0.0) / w_total
        err += abs(g_share - w_share)
    return round(err / 2.0, 6)


def build_timeline(samples: Sequence[Optional[dict]], *,
                   duration_s: float,
                   weights: Optional[Dict[str, float]] = None,
                   bucket_s: Optional[float] = None) -> Dict[str, object]:
    """Time-resolved scorecard sub-record: the run as fixed-width buckets.

    Each landed sample is assigned to the bucket of its *scheduled*
    arrival offset (``at``), so the timeline shows the offered-load shape
    the scenario planned (diurnal waves, bursts) with the outcomes that
    befell it — a mid-run worker restart reads as a goodput dip and a
    p99 spike in the buckets it hit, then recovery. Per bucket: arrival/
    ok/shed/error counts, goodput_rps, coordinated-omission-corrected
    p99 over scheduled-send latency, and the DRR fairness error of that
    bucket's goodput against the configured tenant ``weights``.
    """
    landed = [s for s in samples
              if s is not None and s.get("at") is not None]
    if bucket_s is None:
        # ~12 buckets per run, floored so sub-second runs still resolve
        bucket_s = max(round(float(duration_s) / 12.0, 3), 0.1)
    bucket_s = float(bucket_s)
    if not landed:
        return {"bucket_s": bucket_s, "buckets": []}
    count = int(math.floor(max(float(s["at"]) for s in landed)
                           / bucket_s)) + 1
    rows: List[dict] = [
        {"t0": round(i * bucket_s, 3), "arrivals": 0, "ok": 0,
         "shed": 0, "errors": 0} for i in range(count)]
    lats: List[List[float]] = [[] for _ in range(count)]
    tenant_ok: List[Dict[str, float]] = [{} for _ in range(count)]
    for s in landed:
        i = min(int(float(s["at"]) // bucket_s), count - 1)
        row = rows[i]
        row["arrivals"] += 1
        outcome = s.get("outcome")
        key = {"ok": "ok", "shed": "shed"}.get(outcome, "errors")
        row[key] += 1
        if outcome == "ok":
            tenant = str(s.get("tenant", "default"))
            tenant_ok[i][tenant] = tenant_ok[i].get(tenant, 0.0) + 1.0
            if s.get("sched_lat_s") is not None:
                lats[i].append(float(s["sched_lat_s"]))
    for i, row in enumerate(rows):
        row["goodput_rps"] = round(row["ok"] / bucket_s, 3)
        row["p99_ms"] = (round(_quantile(sorted(lats[i]), 0.99) * 1e3, 3)
                         if lats[i] else None)
        row["fairness_error"] = fairness_error(tenant_ok[i], weights or {})
    return {"bucket_s": bucket_s, "buckets": rows}


# -- counter snapshots (breaker flaps, sheds, faults) -------------------------

def _series_sum(snap: dict, name: str, **labels) -> float:
    metric = snap.get(name) or {}
    total = 0.0
    for s in metric.get("series", ()):  # type: ignore[union-attr]
        row = s.get("labels", {})
        if all(row.get(k) == v for k, v in labels.items()):
            total += float(s.get("value", 0.0))
    return total


def counters_snapshot() -> Dict[str, float]:
    """The cumulative counters the scorecard reports as run deltas:
    breaker transitions (total and into-open = flaps), shed totals, and
    injected-fault count. Take one before the run and one after."""
    snap = _registry_snapshot()
    return {
        "breaker_transitions": _series_sum(
            snap, "mmlspark_breaker_transitions_total"),
        "breaker_opens": _series_sum(
            snap, "mmlspark_breaker_transitions_total", to="open"),
        "requests_shed": _series_sum(snap, "mmlspark_requests_shed_total"),
        "wfq_shed": _series_sum(snap, "mmlspark_wfq_shed_total"),
        "faults_injected": _series_sum(snap,
                                       "mmlspark_faults_injected_total"),
        "serving_requests": _series_sum(snap,
                                        "mmlspark_serving_requests_total"),
    }


def counters_delta(before: Dict[str, float],
                   after: Dict[str, float]) -> Dict[str, float]:
    return {k: round(after.get(k, 0.0) - before.get(k, 0.0), 6)
            for k in after}


def merged_requests_total(prom_text: str) -> float:
    """Sum every ``mmlspark_serving_requests_total`` series in a
    Prometheus exposition (the driver's federated ``/debug/cluster``
    ``metrics`` field) — the cluster-merged request counter the scorecard
    reconciles against."""
    total = 0.0
    for line in prom_text.splitlines():
        if line.startswith("mmlspark_serving_requests_total{"):
            total += float(line.rsplit(" ", 1)[1])
    return total


# -- the scorecard ------------------------------------------------------------

def build_scorecard(scenario, samples: List[dict], *,
                    window_s: float,
                    counters_before: Optional[Dict[str, float]] = None,
                    counters_after: Optional[Dict[str, float]] = None,
                    costs: Optional[dict] = None,
                    cluster_view: Optional[dict] = None,
                    closed_loop: Optional[dict] = None,
                    mesh_shape: Optional[str] = None,
                    kv_dtype: Optional[str] = None,
                    sessions: Optional[dict] = None) -> dict:
    """Assemble the per-scenario scorecard and mirror it to metrics.

    ``samples`` is the runner's per-arrival outcome list (one dict per
    planned arrival — a missing entry is a LOST request and the headline
    failure); ``costs`` is the raw ``/debug/costs`` JSON payload;
    ``cluster_view`` carries the federated reconciliation block the
    runner fills from ``/debug/cluster``.
    """
    arrivals = len(samples)
    landed = [s for s in samples if s is not None]
    by_outcome = {"ok": 0, "shed": 0, "error": 0}
    attempts = retries = honored = 0
    sched_lats: List[float] = []
    send_lats: List[float] = []
    send_lags: List[float] = []
    for s in landed:
        by_outcome[s.get("outcome", "error")] = \
            by_outcome.get(s.get("outcome", "error"), 0) + 1
        attempts += int(s.get("attempts", 1))
        retries += max(int(s.get("attempts", 1)) - 1, 0)
        honored += int(s.get("honored_retries", 0))
        lag = s.get("send_lag_s")
        if lag is not None:
            send_lags.append(float(lag))
        if s.get("outcome") == "ok":
            if s.get("sched_lat_s") is not None:
                sched_lats.append(float(s["sched_lat_s"]))
            if s.get("send_lat_s") is not None:
                send_lats.append(float(s["send_lat_s"]))
    lost = arrivals - len(landed)
    ok = by_outcome.get("ok", 0)
    window_s = max(float(window_s), 1e-9)

    weights = dict(getattr(scenario, "tenants", None) or {})
    tenant_rows: Dict[str, dict] = {}
    goodput_by_tenant: Dict[str, float] = {}
    for s in landed:
        t = str(s.get("tenant", "default"))
        row = tenant_rows.setdefault(
            t, {"weight": float(weights.get(t, 1.0)), "arrivals": 0,
                "ok": 0, "shed": 0, "errors": 0})
        row["arrivals"] += 1
        key = {"ok": "ok", "shed": "shed"}.get(s.get("outcome"), "errors")
        row[key] += 1
    for t, row in tenant_rows.items():
        row["goodput_rps"] = round(row["ok"] / window_s, 3)
        goodput_by_tenant[t] = float(row["ok"])
    total_ok = sum(goodput_by_tenant.values())
    for t, row in tenant_rows.items():
        row["goodput_share"] = (round(row["ok"] / total_ok, 4)
                                if total_ok else 0.0)

    # join cost-per-request by tenant from the /debug/costs payload: the
    # weighted scalar cost of that tenant's api-route classes over its
    # completed requests
    if costs:
        cost_by_tenant: Dict[str, float] = {}
        for cls in costs.get("classes", ()):
            if cls.get("route") not in (None, "api"):
                continue
            t = str(cls.get("tenant", "default"))
            cost_by_tenant[t] = cost_by_tenant.get(t, 0.0) \
                + float(cls.get("weighted_cost", 0.0))
        for t, row in tenant_rows.items():
            spent = cost_by_tenant.get(t)
            row["weighted_cost"] = (round(spent, 9)
                                    if spent is not None else None)
            row["cost_per_request"] = (
                round(spent / row["ok"], 9)
                if spent is not None and row["ok"] else None)

    fair_err = fairness_error(goodput_by_tenant, weights)
    deltas = (counters_delta(counters_before, counters_after)
              if counters_before is not None and counters_after is not None
              else {})

    card: Dict[str, object] = {
        "scenario": getattr(scenario, "name", "?"),
        "seed": getattr(scenario, "seed", None),
        "loop_mode": "open",
        "t": time.time(),
        "duration_s": getattr(scenario, "duration_s", None),
        "window_s": round(window_s, 3),
        "mesh_shape": mesh_shape,
        "kv_dtype": kv_dtype,
        "arrivals": arrivals,
        "ok": ok,
        "shed": by_outcome.get("shed", 0),
        "errors": by_outcome.get("error", 0),
        "lost": lost,
        "goodput_rps": round(ok / window_s, 3),
        "shed_rate": round(by_outcome.get("shed", 0) / arrivals, 4)
        if arrivals else 0.0,
        # coordinated-omission-corrected: measured from each request's
        # SCHEDULED send instant, so time spent queued behind a saturated
        # server (or a backed-up sender) counts against the server
        "latency_ms": quantiles_ms(sched_lats),
        # from the actual send instant — the closed-loop-comparable view
        "service_latency_ms": quantiles_ms(send_lats),
        "send_lag_ms": quantiles_ms(send_lags),
        "client_saturated": bool(
            send_lags and _quantile(sorted(send_lags), 0.99) > 0.25),
        "retry": {
            "attempts_total": attempts,
            "retries": retries,
            "honored_retry_after": honored,
            # sends per planned arrival: 1.0 = no retries at all
            "amplification": round(attempts / arrivals, 4)
            if arrivals else 0.0,
        },
        "breaker": {
            "transitions": deltas.get("breaker_transitions"),
            "flaps": deltas.get("breaker_opens"),
        },
        "shed_counters": {
            "requests_shed": deltas.get("requests_shed"),
            "wfq_shed": deltas.get("wfq_shed"),
        },
        "faults_injected": deltas.get("faults_injected"),
        "tenants": tenant_rows,
        "fairness_error": fair_err,
        # time-resolved view of the same run (see build_timeline): the
        # scenario's load shape and how each slice of it fared
        "timeline": build_timeline(
            samples,
            duration_s=float(getattr(scenario, "duration_s", 0.0)
                             or window_s),
            weights=weights),
        "cluster": dict(cluster_view) if cluster_view else None,
        "closed_loop": dict(closed_loop) if closed_loop else None,
        # session-drill block (loadgen.sessions): decode sessions that
        # rode the run, how many survived the chaos script, and the
        # failover latency tail — sessions_lost == 0 is the CI gate
        "sessions": dict(sessions) if sessions else None,
    }

    name = str(card["scenario"])
    for outcome, n in (("ok", ok), ("shed", by_outcome.get("shed", 0)),
                       ("error", by_outcome.get("error", 0)),
                       ("lost", lost)):
        if n:
            _M_SCN_REQUESTS.inc(n, scenario=name, outcome=outcome)
    if retries:
        _M_SCN_RETRIES.inc(retries, scenario=name)
    _M_SCN_GOODPUT.set(float(card["goodput_rps"]), scenario=name)
    lat = card["latency_ms"]
    if isinstance(lat, dict):
        _M_SCN_P99.set(float(lat["p99_ms"]), scenario=name)
    _M_SCN_FAIRNESS.set(fair_err, scenario=name)
    if sessions:
        n_lost = int(sessions.get("lost", 0))
        n_rec = int(sessions.get("recovered", 0))
        n_done = int(sessions.get("sessions", 0)) - n_lost - n_rec
        for outcome, n in (("completed", max(n_done, 0)),
                           ("recovered", n_rec), ("lost", n_lost)):
            if n:
                _M_SCN_SESSIONS.inc(n, scenario=name, outcome=outcome)
        if sessions.get("recovery_p99_ms") is not None:
            _M_SCN_RECOVERY_P99.set(float(sessions["recovery_p99_ms"]),
                                    scenario=name)
    return card


def harvest_slo(slo_scorecard: dict, store=None,
                placement: str = "scenario") -> int:
    """Land the run's SLO scorecard (``SloTracker.scorecard()`` — the
    same tracker the serving plane observed this scenario's traffic into)
    in the ObservationStore under the existing ``source="slo_scorecard"``
    rows, so the tuner's cost model reads traffic-shaped truth through
    the exact schema it already joins. (Cost rows land server-side: the
    runner's ``/debug/costs`` fetch harvests ``source="cost_ledger"``
    rows in the serving process.)"""
    return _harvest_scorecard(slo_scorecard, store=store,
                              placement=placement)
