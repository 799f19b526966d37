"""Declarative scenarios: workload mix × tenant weights × arrival shape ×
chaos script, run open-loop against a ``ServingCluster``.

A :class:`Scenario` is pure data — everything needed to regenerate the
identical traffic plan from its seed. :func:`run_scenario` executes it:
senders fire at each arrival's *scheduled* instant regardless of how the
last reply went (open loop), the chaos script composes the existing
``MMLSPARK_TPU_FAULTS`` grammar with a mid-run
``ServingCluster.restart_worker``, and the run ends in one scorecard
(``loadgen.scorecard``) reconciled against the federated
``/debug/cluster`` counters.

Serving-plane imports live inside functions on purpose: the
plan/describe half of this module must stay importable with nothing but
the stdlib.

The port's copy of ``mmlspark_tpu/loadgen/scenarios.py``.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional

from .arrivals import (Arrival, TenantMix, diurnal_offsets, heavy_tail_rows,
                       poisson_offsets, weighted_choice)
from .progress import get_progress
from .scorecard import (build_scorecard, counters_snapshot,
                        merged_requests_total, quantiles_ms)

__all__ = ["SCENARIOS", "Scenario", "closed_loop_probe",
           "cluster_echo_engine", "get_scenario", "plan", "run_scenario"]

#: workload name → X-Mmlspark-Model header value (the three serving
#: archetypes the bench exercises: ONNX vision, text generation, GBDT)
WORKLOAD_MODELS: Dict[str, str] = {
    "vision": "onnx-vision",
    "generation": "textgen",
    "gbdt": "gbdt-scorer",
}


@dataclass(frozen=True)
class Scenario:
    """One named, seeded traffic + chaos recipe."""

    name: str
    description: str = ""
    duration_s: float = 2.0
    #: mean arrival rate (requests/second) across all tenants
    rate: float = 40.0
    arrival: str = "poisson"            # "poisson" | "diurnal"
    diurnal_depth: float = 0.5
    diurnal_period_s: Optional[float] = None
    seed: int = 20260808
    #: tenant → DRR weight; also pushed into the model registry so the
    #: serving plane's weighted-fair admission uses the same shares
    tenants: Dict[str, float] = field(
        default_factory=lambda: {"acme": 3.0, "beta": 1.0})
    workloads: Dict[str, float] = field(
        default_factory=lambda: {"vision": 0.5, "generation": 0.3,
                                 "gbdt": 0.2})
    size_median_rows: int = 8
    size_alpha: float = 1.6
    size_cap_rows: int = 512
    prefix_pool: int = 4
    prefix_skew: float = 1.1
    keyed_fraction: float = 0.75
    #: chaos script in the MMLSPARK_TPU_FAULTS grammar ("" = no faults)
    faults: str = ""
    #: seconds into the run to kill-and-replace one worker (None = never)
    restart_at_s: Optional[float] = None
    restart_worker: Optional[str] = None
    #: per-request deadline propagated as X-Mmlspark-Deadline; spans the
    #: whole retry envelope of one arrival
    deadline_s: float = 5.0
    max_retries: int = 3
    #: long-decode sessions riding the run (``loadgen.sessions``): 0 = no
    #: session drill; with a chaos restart these exercise journal-replay
    #: failover over the real ``/_adopt`` hop
    decode_sessions: int = 0
    decode_tokens: int = 24
    decode_tick_s: float = 0.02


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    Scenario(
        name="smoke",
        description="CI-sized deterministic mix: two tenants, Poisson "
                    "arrivals, a light seeded enqueue-fault drizzle, no "
                    "restart — bounded wall-clock, CPU-only.",
        duration_s=2.0, rate=40.0, arrival="poisson",
        faults="enqueue:error:every=7:times=6",
    ),
    Scenario(
        name="mixed-tenant-chaos",
        description="Overload drill: diurnal arrivals above capacity, "
                    "heavy early enqueue faults to trip client breakers, "
                    "and a mid-run ungraceful worker restart.",
        duration_s=4.0, rate=120.0, arrival="diurnal", diurnal_depth=0.6,
        faults="enqueue:error:every=2:times=40",
        restart_at_s=1.5, restart_worker="worker-1",
    ),
    Scenario(
        name="decode-kill",
        description="Session survivability drill: long-decode sessions "
                    "ride the traffic, one owning worker is killed "
                    "mid-decode, and every session must finish "
                    "token-identical via journal-replay failover over "
                    "/_adopt (scorecard: sessions_lost == 0).",
        duration_s=2.5, rate=30.0, arrival="poisson",
        restart_at_s=1.0, restart_worker="worker-1",
        # 40 tokens x 50ms = ~2s of decoding: the 1.0s restart lands
        # mid-stream, so worker-1's sessions MUST take the failover path
        decode_sessions=6, decode_tokens=40, decode_tick_s=0.05,
    ),
)}


def get_scenario(name: str, **overrides) -> Scenario:
    """Look up a registered scenario, optionally overriding fields
    (``get_scenario("smoke", duration_s=1.0, rate=20)``)."""
    try:
        base = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(have: {', '.join(sorted(SCENARIOS))})") from None
    return replace(base, **overrides) if overrides else base


def plan(scenario: Scenario) -> List[Arrival]:
    """Expand a scenario into its full arrival plan — every request's
    scheduled send offset, tenant, workload, size, and prefix key. Pure
    and seeded: the same scenario always yields the identical plan."""
    rng = random.Random(scenario.seed)
    if scenario.arrival == "diurnal":
        offsets = diurnal_offsets(scenario.rate, scenario.duration_s, rng,
                                  period_s=scenario.diurnal_period_s,
                                  depth=scenario.diurnal_depth)
    else:
        offsets = poisson_offsets(scenario.rate, scenario.duration_s, rng)
    mix = TenantMix(scenario.tenants, prefix_pool=scenario.prefix_pool,
                    prefix_skew=scenario.prefix_skew,
                    keyed_fraction=scenario.keyed_fraction)
    wl_items = sorted(scenario.workloads.items())
    out: List[Arrival] = []
    for i, at in enumerate(offsets):
        tenant, prefix = mix.pick(rng)
        out.append(Arrival(
            index=i, at=at, tenant=tenant,
            workload=weighted_choice(rng, wl_items),
            rows=heavy_tail_rows(rng, median=scenario.size_median_rows,
                                 alpha=scenario.size_alpha,
                                 cap=scenario.size_cap_rows),
            prefix=prefix))
    return out


# -- serving-side helpers -----------------------------------------------------

def cluster_echo_engine(cluster, stop: threading.Event, *,
                        service_s: float = 0.0,
                        batch: int = 16) -> threading.Thread:
    """Start a model-engine stand-in: drain the cluster's request queue
    and answer 200 with a small JSON echo, optionally holding each batch
    for ``service_s`` (the knob that turns an open-loop scenario into a
    saturation drill). Returns the started daemon thread."""
    from ..io.http.schema import (EntityData, HTTPResponseData,
                                  StatusLineData)

    def loop() -> None:
        while not stop.is_set():
            got = cluster.get_batch(batch, timeout=0.02)
            if not got:
                continue
            if service_s > 0:
                time.sleep(service_s)
            for owner_id, cached in got:
                body = json.dumps({"ok": True, "rid": cached.request_id})
                resp = HTTPResponseData(
                    entity=EntityData.from_string(body),
                    status_line=StatusLineData(status_code=200))
                try:
                    cluster.reply(owner_id, cached.request_id, resp)
                except Exception:
                    # the owner died mid-flight (chaos restart): the
                    # client's retry loop owns recovery, not the engine
                    pass

    t = threading.Thread(target=loop, name="scenario-echo-engine",
                         daemon=True)
    t.start()
    return t


def _arrival_headers(scenario: Scenario, a: Arrival, deadline) -> dict:
    from ..reliability import DEADLINE_HEADER
    from ..serving.kv_pool import AFFINITY_HEADER
    headers = {
        "Content-Type": "application/json",
        "X-Mmlspark-Tenant": a.tenant,
        "X-Mmlspark-Model": WORKLOAD_MODELS.get(a.workload, a.workload),
        DEADLINE_HEADER: deadline.header_value(),
    }
    if a.prefix:
        headers[AFFINITY_HEADER] = a.prefix
    return headers


def _send_once(url: str, body: bytes, headers: dict, timeout: float):
    """One HTTP attempt. Returns ``("ok"|"shed"|"error", retry_after)``
    where ``retry_after`` is the parsed 429 Retry-After hint (None when
    absent — e.g. a 429 relayed through a forwarder, which drops
    headers)."""
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            resp.read()
        return "ok", None
    except urllib.error.HTTPError as e:
        try:
            e.read()
        except Exception:
            pass
        if e.code == 429:
            ra = e.headers.get("Retry-After") if e.headers else None
            try:
                return "shed", (float(ra) if ra is not None else None)
            except (TypeError, ValueError):
                return "shed", None
        return "error", None
    except Exception:
        return "error", None


def _drive_arrival(scenario: Scenario, a: Arrival, t0: float,
                   targets: List[str], breakers: Dict[str, object]) -> dict:
    """Send one planned arrival to completion: scheduled-time pacing,
    Retry-After-honoring retries, deadline propagation, client-side
    breaker accounting. Always returns a sample dict — a planned arrival
    can end ok/shed/error but never vanish."""
    from ..reliability import Deadline

    scheduled = t0 + a.at
    now = time.monotonic()
    if scheduled > now:
        time.sleep(scheduled - now)
    send_lag = max(time.monotonic() - scheduled, 0.0)
    get_progress().note_sent()

    deadline = Deadline.after(scenario.deadline_s)
    body = json.dumps({"workload": a.workload, "rows": a.rows,
                       "tenant": a.tenant, "index": a.index}).encode()
    attempts = 0
    honored = 0
    outcome = "error"
    first_send = time.monotonic()
    while True:
        # prefer a target whose breaker admits the call; if every breaker
        # is open, send anyway — an open-loop generator sheds accuracy,
        # never requests (zero-lost invariant)
        pick = None
        for off in range(len(targets)):
            cand = targets[(a.index + attempts + off) % len(targets)]
            if breakers[cand].allow():
                pick = cand
                break
        if pick is None:
            pick = targets[(a.index + attempts) % len(targets)]
        attempts += 1
        timeout = max(deadline.cap(2.0), 0.05)
        outcome, retry_after = _send_once(
            pick, body, _arrival_headers(scenario, a, deadline), timeout)
        br = breakers[pick]
        if outcome == "error":
            br.record_failure()
        else:
            # a 429 is the server doing its job, not a broken peer
            br.record_success()
        if outcome == "ok" or attempts > scenario.max_retries \
                or deadline.expired:
            break
        if outcome == "shed":
            if retry_after is not None:
                honored += 1
                time.sleep(max(min(retry_after, deadline.remaining(),
                                   1.0), 0.0))
            else:
                time.sleep(min(0.02 * attempts, 0.1))
        else:
            time.sleep(min(0.01 * attempts, 0.05))
    done = time.monotonic()
    get_progress().note_done(outcome, retries=attempts - 1,
                             at_s=done - t0,
                             lat_s=done - scheduled)
    return {
        "index": a.index, "tenant": a.tenant, "workload": a.workload,
        "rows": a.rows, "outcome": outcome, "attempts": attempts,
        # scheduled arrival offset from scenario start — the timeline
        # sub-record buckets by this (scorecard.build_timeline)
        "at": round(a.at, 6),
        "honored_retries": honored, "send_lag_s": round(send_lag, 6),
        "sched_lat_s": round(done - scheduled, 6),
        "send_lat_s": round(done - first_send, 6),
    }


def closed_loop_probe(scenario: Scenario, targets: List[str],
                      n: int = 40) -> dict:
    """The regime the scorecard exists to dethrone: send → wait → send,
    latency measured from the actual send. Its p99 structurally cannot
    see queueing delay (each reply throttles the next request), which is
    exactly what the open/closed comparison in the scorecard shows.
    Runs with chaos disabled so both numbers share a workload, not a
    fault schedule."""
    from ..reliability import Deadline

    rng = random.Random(scenario.seed + 1)
    mix = TenantMix(scenario.tenants, prefix_pool=scenario.prefix_pool,
                    prefix_skew=scenario.prefix_skew,
                    keyed_fraction=scenario.keyed_fraction)
    wl_items = sorted(scenario.workloads.items())
    lats: List[float] = []
    ok = 0
    for i in range(n):
        tenant, prefix = mix.pick(rng)
        a = Arrival(index=i, at=0.0, tenant=tenant,
                    workload=weighted_choice(rng, wl_items),
                    rows=heavy_tail_rows(
                        rng, median=scenario.size_median_rows,
                        alpha=scenario.size_alpha,
                        cap=scenario.size_cap_rows),
                    prefix=prefix)
        deadline = Deadline.after(scenario.deadline_s)
        body = json.dumps({"workload": a.workload, "rows": a.rows,
                           "tenant": a.tenant, "index": i}).encode()
        start = time.monotonic()
        outcome, _ = _send_once(
            targets[i % len(targets)], body,
            _arrival_headers(scenario, a, deadline),
            max(deadline.cap(2.0), 0.05))
        lats.append(time.monotonic() - start)
        if outcome == "ok":
            ok += 1
    return {"loop_mode": "closed", "n": n, "ok": ok,
            "latency_ms": quantiles_ms(lats)}


def _fetch_json(url: str, timeout: float = 5.0) -> Optional[dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except Exception:
        return None


def run_scenario(scenario: Scenario, cluster, *,
                 closed_loop_n: int = 40,
                 senders: int = 16,
                 mesh_shape: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 store=None, harvest: bool = True,
                 log: Optional[Callable[[str], None]] = None) -> dict:
    """Run one scenario end-to-end against a live ``ServingCluster`` and
    return its scorecard.

    Order of operations: push tenant weights into the model registry →
    closed-loop probe (chaos off — the comparison baseline) → snapshot
    counters → arm the fault script → open-loop drive with the chaos
    timer running → clear faults → fetch ``/debug/costs`` (harvests
    ``cost_ledger`` rows server-side) → quiesce, heartbeat every worker,
    and read the driver's federated ``/debug/cluster`` for the exact
    reconciliation → build + harvest the scorecard.
    """
    from ..observability.slo import get_tracker
    from ..reliability import get_injector
    from ..serving.registry import get_registry
    from .scorecard import harvest_slo

    say = log or (lambda _msg: None)
    registry = get_registry()
    for tenant, weight in scenario.tenants.items():
        registry.set_tenant(tenant, weight)

    targets = [w.server.address.rstrip("/") + "/" for w in cluster.workers]
    arrivals = plan(scenario)
    progress = get_progress()
    progress.begin(scenario.name, len(arrivals),
                   duration_s=scenario.duration_s)

    say(f"closed-loop probe ({closed_loop_n} requests)")
    closed = closed_loop_probe(scenario, targets, n=closed_loop_n)

    from ..reliability import CircuitBreaker
    breakers = {t: CircuitBreaker(peer=f"loadgen:{t}", window=8,
                                  min_calls=3, failure_ratio=0.5,
                                  open_seconds=0.25) for t in targets}
    before = counters_snapshot()
    injector = get_injector()
    if scenario.faults:
        injector.configure(scenario.faults)

    chaos_timer: Optional[threading.Timer] = None
    if scenario.restart_at_s is not None and scenario.restart_worker:
        def _restart() -> None:
            say(f"chaos: restarting {scenario.restart_worker}")
            try:
                cluster.restart_worker(scenario.restart_worker)
            except Exception:
                pass
        chaos_timer = threading.Timer(scenario.restart_at_s, _restart)
        chaos_timer.daemon = True
        chaos_timer.start()

    drill = None
    if scenario.decode_sessions > 0:
        from .sessions import SessionDrill
        say(f"session drill: {scenario.decode_sessions} decode sessions "
            f"x {scenario.decode_tokens} tokens")
        drill = SessionDrill(
            cluster, n_sessions=scenario.decode_sessions,
            tokens_per_session=scenario.decode_tokens,
            tick_s=scenario.decode_tick_s).start()

    say(f"open-loop drive: {len(arrivals)} arrivals over "
        f"{scenario.duration_s:.1f}s")
    samples: List[Optional[dict]] = [None] * len(arrivals)
    next_idx = [0]
    idx_lock = threading.Lock()
    t0 = time.monotonic() + 0.05

    def sender() -> None:
        while True:
            with idx_lock:
                i = next_idx[0]
                if i >= len(arrivals):
                    return
                next_idx[0] = i + 1
            # worker addresses can change under chaos: refresh per send
            live = [w.server.address.rstrip("/") + "/"
                    for w in cluster.workers]
            for t in live:
                if t not in breakers:
                    breakers[t] = CircuitBreaker(
                        peer=f"loadgen:{t}", window=8, min_calls=3,
                        failure_ratio=0.5, open_seconds=0.25)
            samples[i] = _drive_arrival(scenario, arrivals[i], t0, live,
                                        breakers)

    # a bounded sender pool, joined before the scenario returns (not
    # supervised): a crash surfaces as missing samples in the
    # reconciliation counters, and supervisor backoff/restart would
    # distort the open-loop arrival schedule the scenario measures
    threads = [threading.Thread(target=sender, name=f"scenario-send-{k}",
                                daemon=True)
               for k in range(max(1, min(senders, len(arrivals) or 1)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    window_s = max(time.monotonic() - t0,
                   arrivals[-1].at if arrivals else 0.0, 1e-9)
    if chaos_timer is not None:
        chaos_timer.cancel()
    injector.clear()

    sessions = None
    if drill is not None:
        sessions = drill.finish(
            timeout=max(scenario.duration_s * 2.0,
                        scenario.decode_tokens * scenario.decode_tick_s
                        * 4.0, 5.0))
        say(f"session drill: lost={sessions['lost']} "
            f"recovered={sessions['recovered']} "
            f"recovery_p99={sessions['recovery_p99_ms']}ms")

    # server-side harvest of cost_ledger rows + tenant cost join
    costs = _fetch_json(targets[0].rstrip("/") + "/debug/costs")

    # quiesce, then heartbeat every worker so the driver's federated
    # counters all describe the same instant — the exact-reconciliation
    # contract the federation tests pin down
    time.sleep(0.25)
    for w in cluster.workers:
        try:
            w.heartbeat()
        except Exception:
            pass
    after = counters_snapshot()
    cluster_view: Optional[dict] = None
    merged = None
    debug = _fetch_json(cluster.driver.url.rstrip("/") + "/debug/cluster")
    if debug is not None:
        merged = merged_requests_total(str(debug.get("metrics", "")))
        n_workers = len(cluster.workers)
        cluster_view = {
            "workers": n_workers,
            "merged_requests_total": merged,
            "global_requests_total": after.get("serving_requests"),
            "reconciled": merged == n_workers
            * float(after.get("serving_requests", -1.0)),
        }

    card = build_scorecard(
        scenario, samples, window_s=window_s,
        counters_before=before, counters_after=after, costs=costs,
        cluster_view=cluster_view, closed_loop=closed,
        mesh_shape=mesh_shape, kv_dtype=kv_dtype, sessions=sessions)

    if harvest:
        harvested = harvest_slo(get_tracker().scorecard(), store=store)
        card["harvested"] = {"slo_rows": harvested,
                             "cost_rows_via": "/debug/costs"}
    progress.finish({"ok": card["ok"], "shed": card["shed"],
                     "errors": card["errors"], "lost": card["lost"],
                     "goodput_rps": card["goodput_rps"]})
    say(f"scorecard: ok={card['ok']} shed={card['shed']} "
        f"errors={card['errors']} lost={card['lost']}")
    return card
