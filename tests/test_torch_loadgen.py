"""Port parity: open-loop load generation (``mmlspark_tpu_torch.loadgen``)
against the reference's ``tests/test_loadgen.py``, one counterpart a
test, plus the reference's ``tests/test_timeseries.py:493-515`` drill:
seeded arrival statistics, tenant mix skew, scorecard math, the
``/debug/scenario`` route on both transports, and the 3-worker chaos
scenario reconciled exactly against the driver's federated counters.

Two of those drills assert that the open-loop burst is shed
(``card["shed"] > 0``). Here the overload is made by construction
rather than by the host's speed: the echo engine is held stopped from
the chaos restart until the scenario has recorded a shed arrival
(:func:`_held_echo_engine`), with a deadline.

Then the parity with the JAX package on the CPU: ``plan()`` of every
registered scenario and of two overrides gives the same arrivals (offsets
bitwise), the samplers and the scorecard math agree on seeded inputs,
and ``build_scorecard`` builds the same dict from the same samples and
counters.
"""

import http.client
import json
import random
import statistics
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.loadgen import (Arrival, TenantMix,
                                        cluster_echo_engine,
                                        diurnal_offsets, fairness_error,
                                        get_progress, get_scenario,
                                        heavy_tail_rows, interarrivals,
                                        merged_requests_total, plan,
                                        poisson_offsets, quantiles_ms,
                                        reset_progress, run_scenario)
from mmlspark_tpu_torch.observability import reset_all
from mmlspark_tpu_torch.observability.federation import FEDERATION_INTERVAL_ENV
from mmlspark_tpu_torch.observability.ledger import reset_ledger
from mmlspark_tpu_torch.observability.slo import reset_tracker
from mmlspark_tpu_torch.observability.watchdog import reset_watchdog
from mmlspark_tpu_torch.reliability import get_injector, reset_breakers
from mmlspark_tpu_torch.serving.distributed import ServingCluster
from mmlspark_tpu_torch.tuning.observations import (ObservationStore,
                                                    reset_store)

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


@pytest.fixture(autouse=True)
def _clean_slate():
    for reset in (reset_ledger, reset_tracker, reset_watchdog,
                  reset_breakers, reset_store, reset_progress, reset_all):
        reset()
    get_injector().clear()
    yield
    for reset in (reset_ledger, reset_tracker, reset_watchdog,
                  reset_breakers, reset_store, reset_progress, reset_all):
        reset()
    get_injector().clear()


# ---------------------------------------------------------------------------
# arrival processes


def test_poisson_interarrival_mean_and_variance():
    rate = 50.0
    offs = poisson_offsets(rate, 40.0, random.Random(42))
    gaps = interarrivals(offs)
    assert len(gaps) > 1500
    mean = statistics.fmean(gaps)
    var = statistics.variance(gaps)
    # Exponential(rate): mean 1/rate, variance 1/rate^2
    assert mean == pytest.approx(1.0 / rate, rel=0.10)
    assert var == pytest.approx(1.0 / rate ** 2, rel=0.30)
    assert all(g > 0 for g in gaps)
    assert all(0 <= t < 40.0 for t in offs)


def test_poisson_seeded_determinism():
    assert poisson_offsets(20.0, 5.0, random.Random(7)) == \
        poisson_offsets(20.0, 5.0, random.Random(7))


def test_diurnal_modulation_shape():
    # period == duration: first half is the "day" (rate * (1+depth*sin)
    # above mean), second half the "night" — counts must separate hard
    duration = 20.0
    offs = diurnal_offsets(50.0, duration, random.Random(3), depth=0.8)
    first = sum(1 for t in offs if t < duration / 2)
    second = len(offs) - first
    assert first > second * 1.5
    # total volume stays near the base rate (the envelope integrates to
    # rate * duration over a full period)
    assert len(offs) == pytest.approx(50.0 * duration, rel=0.15)


def test_diurnal_zero_depth_is_plain_poisson_rate():
    offs = diurnal_offsets(40.0, 10.0, random.Random(5), depth=0.0)
    assert len(offs) == pytest.approx(400, rel=0.15)


def test_heavy_tail_rows_quantiles():
    rng = random.Random(11)
    xs = sorted(heavy_tail_rows(rng, median=8, alpha=1.6, cap=4096)
                for _ in range(20_000))
    med = xs[len(xs) // 2]
    p99 = xs[int(0.99 * len(xs))]
    assert 6 <= med <= 10                       # median lands where asked
    assert p99 >= 3 * med                       # the tail is actually heavy
    assert xs[-1] <= 4096 and xs[0] >= 1        # cap and floor hold


def test_tenant_mix_weights_and_prefix_skew():
    rng = random.Random(9)
    mix = TenantMix({"acme": 3.0, "beta": 1.0}, prefix_pool=4,
                    prefix_skew=1.1, keyed_fraction=0.75)
    picks = [mix.pick(rng) for _ in range(8000)]
    acme = sum(1 for t, _ in picks if t == "acme")
    assert acme / len(picks) == pytest.approx(0.75, abs=0.03)
    keyed = [p for _, p in picks if p is not None]
    assert len(keyed) / len(picks) == pytest.approx(0.75, abs=0.03)
    # Zipf skew: rank-1 prefixes are the hottest; keys are deterministic
    # "{tenant}-p{rank}" so affinity routing sees stable hot keys
    assert all(p.split("-p")[1].isdigit() for p in keyed)
    r1 = sum(1 for p in keyed if p.endswith("-p1"))
    r4 = sum(1 for p in keyed if p.endswith("-p4"))
    assert r1 > r4


def test_plan_is_deterministic_and_complete():
    sc = get_scenario("smoke")
    a, b = plan(sc), plan(sc)
    assert a == b and len(a) > 0
    assert [x.index for x in a] == list(range(len(a)))
    assert all(isinstance(x, Arrival) and x.rows >= 1 for x in a)
    assert {x.tenant for x in a} <= set(sc.tenants)
    assert {x.workload for x in a} <= set(sc.workloads)


# ---------------------------------------------------------------------------
# scorecard math


def test_fairness_error_known_shares():
    # achieved shares exactly proportional to weights → zero error
    assert fairness_error({"a": 30, "b": 10}, {"a": 3.0, "b": 1.0}) == 0.0
    # equal weights, one tenant starved: TV distance = 0.5
    assert fairness_error({"a": 40, "b": 0}, {"a": 1.0, "b": 1.0}) == \
        pytest.approx(0.5)
    # 60/40 against 50/50 → |0.6-0.5|/2 + |0.4-0.5|/2 = 0.1
    assert fairness_error({"a": 60, "b": 40}, {"a": 1.0, "b": 1.0}) == \
        pytest.approx(0.1)
    assert fairness_error({}, {}) == 0.0


def test_quantiles_ms_nearest_rank():
    assert quantiles_ms([]) is None
    q = quantiles_ms([i / 1000.0 for i in range(1, 101)])
    assert q["p50_ms"] == pytest.approx(51.0)
    assert q["p99_ms"] == pytest.approx(99.0)
    assert q["max_ms"] == pytest.approx(100.0)
    assert q["n"] == 100


def test_merged_requests_total_parses_federated_metrics():
    text = ("# HELP mmlspark_serving_requests_total h\n"
            'mmlspark_serving_requests_total{transport="threaded"} 12\n'
            'mmlspark_serving_requests_total{transport="async"} 30\n'
            'mmlspark_other_total{x="y"} 99\n')
    assert merged_requests_total(text) == 42.0


# ---------------------------------------------------------------------------
# /debug/scenario on both transports


def _get_json(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _get_json_port(port, path):
    # http.client, not urlopen: the async transport's keep-alive framing
    # and urllib don't get along (same convention as test_serving_async)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read().decode("utf-8"))
    finally:
        conn.close()


@pytest.mark.parametrize("transport", ["threaded", "async"])
def test_debug_scenario_route_both_transports(transport):
    from mmlspark_tpu_torch.serving.server import WorkerServer
    server = WorkerServer(transport=transport)
    try:
        assert _get_json_port(server.port, "/debug/scenario")["state"] == \
            "idle"
        progress = get_progress()
        progress.begin("drill", 10)
        progress.note_sent(3)
        progress.note_done("ok")
        live = _get_json_port(server.port, "/debug/scenario")
        assert live["scenario"] == "drill" and live["state"] == "running"
        assert live["sent"] == 3 and live["ok"] == 1
        progress.finish({"ok": 1})
        done = _get_json_port(server.port, "/debug/scenario")
        assert done["state"] == "done" and done["summary"] == {"ok": 1}
    finally:
        server.close()


# ---------------------------------------------------------------------------
# acceptance: chaos scenario against a 3-worker cluster


def _held_echo_engine(cluster, stop, *, service_s, batch, hold_s=15.0):
    """``cluster_echo_engine``'s twin, held stopped from the scenario's
    chaos restart until the scenario has recorded a shed arrival (or
    ``hold_s`` passes, and the drill's ``shed > 0`` then fails): with
    every admission queue full and nothing draining, an arrival's retries
    all meet 429s, so the run sheds whatever the host's speed."""
    from mmlspark_tpu_torch.io.http.schema import (EntityData,
                                                   HTTPResponseData,
                                                   StatusLineData)
    held = threading.Event()
    restart = cluster.restart_worker

    def restart_and_hold(worker_id, *args, **kwargs):
        held.set()
        return restart(worker_id, *args, **kwargs)

    cluster.restart_worker = restart_and_hold

    def loop():
        released = False
        while not stop.is_set():
            if held.is_set() and not released:
                deadline = time.monotonic() + hold_s
                while get_progress().snapshot()["shed"] < 1 and \
                        time.monotonic() < deadline and not stop.is_set():
                    time.sleep(0.01)
                released = True
            got = cluster.get_batch(batch, timeout=0.02)
            if not got:
                continue
            time.sleep(service_s)
            for owner_id, cached in got:
                resp = HTTPResponseData(
                    entity=EntityData.from_string(json.dumps(
                        {"ok": True, "rid": cached.request_id})),
                    status_line=StatusLineData(status_code=200))
                try:
                    cluster.reply(owner_id, cached.request_id, resp)
                except Exception:
                    pass

    t = threading.Thread(target=loop, name="held-echo-engine", daemon=True)
    t.start()
    return t


def test_scenario_e2e_chaos_scorecard(monkeypatch):
    # federate telemetry on every heartbeat so the final quiesced
    # heartbeat sweep gives the driver an exact same-instant view
    monkeypatch.setenv(FEDERATION_INTERVAL_ENV, "0")
    store = ObservationStore()
    # tiny admission queues + a slow engine put the offered rate well
    # above capacity: 429s (shed), honored Retry-After retries, and —
    # with the seeded enqueue faults and the mid-run ungraceful restart —
    # client-side breaker flaps, all deterministic in kind (not count)
    scenario = get_scenario(
        "mixed-tenant-chaos", duration_s=1.5, rate=150.0,
        faults="enqueue:error:every=3:times=24",
        restart_at_s=0.7, restart_worker="worker-1",
        deadline_s=3.0, max_retries=2)
    # queue depth (3 workers x 4) below the sender concurrency (32), so
    # the open-loop burst MUST overflow admission into 429s
    cluster = ServingCluster(3, reply_timeout=5.0, max_queue=4)
    stop = threading.Event()
    engine = _held_echo_engine(cluster, stop, service_s=0.04, batch=4)
    try:
        card = run_scenario(scenario, cluster, closed_loop_n=25,
                            senders=32, store=store, mesh_shape="single",
                            kv_dtype="int8")
        live = _get_json(cluster.workers[0].server.address
                         + "/debug/scenario")
    finally:
        stop.set()
        engine.join(timeout=2.0)
        cluster.close()

    # complete scorecard: every planned arrival ended somewhere
    assert card["arrivals"] > 100
    assert card["lost"] == 0
    assert card["ok"] + card["shed"] + card["errors"] == card["arrivals"]
    assert card["ok"] > 0

    # chaos left fingerprints: shed, retries (incl. honored Retry-After),
    # breaker transitions, injected faults
    assert card["shed"] > 0
    assert card["retry"]["retries"] > 0
    assert card["retry"]["amplification"] > 1.0
    assert card["retry"]["honored_retry_after"] > 0
    assert card["breaker"]["transitions"] > 0
    assert card["faults_injected"] > 0

    # the merged federated counter reconciles EXACTLY: every worker
    # heartbeat at the same quiesced instant, and the in-process cluster
    # shares one metrics registry, so merged == n_workers * global
    cl = card["cluster"]
    assert cl["reconciled"] is True
    assert cl["merged_requests_total"] == \
        cl["workers"] * cl["global_requests_total"]

    # coordinated omission is visible: the open-loop (scheduled-send)
    # p99 exceeds the closed-loop p99 on the same workload
    assert card["loop_mode"] == "open"
    assert card["closed_loop"]["loop_mode"] == "closed"
    assert card["latency_ms"]["p99_ms"] > \
        card["closed_loop"]["latency_ms"]["p99_ms"]

    # scorecard rows landed in the ObservationStore via the existing
    # slo_scorecard source (cost rows harvest server-side via /debug/costs)
    rows = store.rows(source="slo_scorecard")
    assert rows
    assert all(r["sig"].startswith("slo:") for r in rows)

    # bench stamps + tenant accounting rode along
    assert card["mesh_shape"] == "single" and card["kv_dtype"] == "int8"
    assert set(card["tenants"]) <= set(scenario.tenants)
    assert 0.0 <= card["fairness_error"] <= 1.0
    for row in card["tenants"].values():
        assert row["arrivals"] == row["ok"] + row["shed"] + row["errors"]

    # the live route saw the run finish
    assert live["state"] == "done" and live["scenario"] == scenario.name
    assert live["summary"]["lost"] == 0


def test_smoke_scenario_clean_run(monkeypatch):
    # the CI-facing path: no restart, light faults, ample capacity —
    # everything lands, mostly ok, reconciliation still exact
    monkeypatch.setenv(FEDERATION_INTERVAL_ENV, "0")
    scenario = get_scenario("smoke", duration_s=1.0, rate=25.0)
    cluster = ServingCluster(3, reply_timeout=5.0, max_queue=256)
    stop = threading.Event()
    engine = cluster_echo_engine(cluster, stop, batch=16)
    try:
        card = run_scenario(scenario, cluster, closed_loop_n=8)
    finally:
        stop.set()
        engine.join(timeout=2.0)
        cluster.close()
    assert card["lost"] == 0
    assert card["ok"] + card["shed"] + card["errors"] == card["arrivals"]
    assert card["ok"] >= card["arrivals"] * 0.8
    assert card["cluster"]["reconciled"] is True
    assert card["harvested"]["slo_rows"] > 0


# ---------------------------------------------------------------------------
# the reference's tests/test_timeseries.py:493-515: timeline dip and
# recovery, and the queue-saturation alert's lifecycle, under the chaos


def test_chaos_timeline_and_queue_saturation_alert_e2e(monkeypatch):
    from mmlspark_tpu_torch.observability import snapshot
    from mmlspark_tpu_torch.observability.timeseries import (
        INTERVAL_ENV, AlertEngine, default_alert_rules, get_store,
        reset_alert_engine, reset_store as reset_ts_store, set_alert_engine)

    reset_ts_store()
    reset_alert_engine()
    monkeypatch.setenv(FEDERATION_INTERVAL_ENV, "0")
    # fast real-time sampling so queue saturation accrues evidence at
    # sub-run granularity; short alert windows so the default-rule-shaped
    # queue-saturation alert can fire AND resolve inside one test
    monkeypatch.setenv(INTERVAL_ENV, "0.05")
    engine = AlertEngine(get_store(), on_fire=())
    for rule in default_alert_rules(for_seconds=0.3,
                                    keep_firing_seconds=0.5):
        engine.add_rule(rule)
    set_alert_engine(engine)

    restart_at = 0.7
    scenario = get_scenario(
        "mixed-tenant-chaos", duration_s=1.5, rate=150.0,
        faults="enqueue:error:every=3:times=24",
        restart_at_s=restart_at, restart_worker="worker-1",
        deadline_s=3.0, max_retries=2)
    # queue depth (3 x 4) far below sender concurrency, and the engine
    # held from the restart until an arrival is shed: a guaranteed backlog
    cluster = ServingCluster(3, reply_timeout=5.0, max_queue=4)
    stop = threading.Event()
    echo = _held_echo_engine(cluster, stop, service_s=0.04, batch=4)
    try:
        card = run_scenario(scenario, cluster, senders=32)
        # quiesce: traffic over, echo engine still draining; the global
        # sampler keeps scraping an emptying queue until the alert's
        # keep-firing window of good evidence elapses
        deadline = time.monotonic() + 6.0
        while "queue-saturation" in engine.firing() and \
                time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        stop.set()
        echo.join(timeout=2.0)
        cluster.close()
        set_alert_engine(None)

    try:
        assert card["lost"] == 0 and card["shed"] > 0

        # -- timeline: complete, consistent, dip visible, recovery after
        tl = card["timeline"]
        buckets = tl["buckets"]
        assert buckets, "scorecard timeline must not be empty"
        assert sum(b["ok"] + b["shed"] + b["errors"] for b in buckets) == \
            card["ok"] + card["shed"] + card["errors"]
        assert sum(b["arrivals"] for b in buckets) == card["arrivals"]
        assert card["shed"] + card["errors"] > 0
        # the mid-run restart stalls senders: goodput dips visibly in the
        # buckets right after restart_at, then recovers
        bw = tl["bucket_s"]
        pre = [b for b in buckets if b["t0"] < restart_at]
        post = [b for b in buckets
                if restart_at <= b["t0"] < restart_at + 4 * bw]
        tail = [b for b in buckets if b["t0"] >= restart_at + 4 * bw]
        assert pre and post and tail
        dip = min(b["goodput_rps"] for b in post)
        assert dip < 0.6 * max(b["goodput_rps"] for b in pre), \
            "no visible goodput dip after the worker restart"
        assert max(b["goodput_rps"] for b in tail) > dip, \
            "no goodput recovery after the restart dip"
        assert any(b["ok"] > 0 for b in tail)

        # -- alert lifecycle: fired during backlog, resolved after quiesce
        snap = snapshot()
        trans = {}
        for row in snap["mmlspark_alert_transitions_total"]["series"]:
            labels = row["labels"]
            trans[(labels["rule"], labels["to"])] = row["value"]
        assert trans.get(("queue-saturation", "firing"), 0) >= 1, \
            "queue-saturation alert never fired under a guaranteed backlog"
        assert trans.get(("queue-saturation", "resolved"), 0) >= 1, \
            "queue-saturation alert never resolved after quiesce"
        assert "queue-saturation" not in engine.firing()
        firing_gauge = {
            row["labels"]["rule"]: row["value"]
            for row in snap["mmlspark_alerts_firing"]["series"]}
        assert firing_gauge["queue-saturation"] == 0.0

        # the global store accrued sampled history across the run
        names = set(get_store().names())
        assert "mmlspark_queue_saturation" in names
    finally:
        reset_ts_store()
        reset_alert_engine()


# ---------------------------------------------------------------------------
# parity with the JAX package on the CPU


def _ref():
    from mmlspark_tpu import loadgen
    return loadgen


@pytest.mark.parametrize("name,overrides", [
    ("smoke", {}), ("mixed-tenant-chaos", {}), ("decode-kill", {}),
    ("smoke", {"duration_s": 1.0, "rate": 25.0, "seed": 7}),
    ("mixed-tenant-chaos", {"arrival": "diurnal", "diurnal_depth": 0.3,
                            "tenants": {"a": 2.0, "b": 1.0, "c": 1.0},
                            "prefix_pool": 8, "keyed_fraction": 0.5})])
def test_plan_matches_the_reference_bitwise(name, overrides):
    ref = _ref()
    got = plan(get_scenario(name, **overrides))
    want = ref.plan(ref.get_scenario(name, **overrides))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.index, a.tenant, a.workload, a.rows, a.prefix) == \
            (b.index, b.tenant, b.workload, b.rows, b.prefix)
        assert np.float64(a.at).tobytes() == np.float64(b.at).tobytes()


def test_samplers_match_the_reference():
    ref = _ref()
    assert poisson_offsets(37.0, 6.0, random.Random(3)) == \
        ref.poisson_offsets(37.0, 6.0, random.Random(3))
    for depth, period in ((0.0, None), (0.6, 2.5), (0.9, None)):
        assert diurnal_offsets(50.0, 5.0, random.Random(4), depth=depth,
                               period_s=period) == \
            ref.diurnal_offsets(50.0, 5.0, random.Random(4), depth=depth,
                                period_s=period)
    r1, r2 = random.Random(5), random.Random(5)
    assert [heavy_tail_rows(r1, median=8, alpha=1.6, cap=512)
            for _ in range(500)] == \
        [ref.heavy_tail_rows(r2, median=8, alpha=1.6, cap=512)
         for _ in range(500)]
    offs = poisson_offsets(20.0, 3.0, random.Random(6))
    assert interarrivals(offs) == ref.interarrivals(offs)
    kw = dict(prefix_pool=6, prefix_skew=1.3, keyed_fraction=0.6)
    mix = TenantMix({"acme": 3.0, "beta": 2.0, "gamma": 1.0}, **kw)
    ref_mix = ref.TenantMix({"acme": 3.0, "beta": 2.0, "gamma": 1.0}, **kw)
    r1, r2 = random.Random(8), random.Random(8)
    assert [mix.pick(r1) for _ in range(2000)] == \
        [ref_mix.pick(r2) for _ in range(2000)]


def test_scorecard_math_matches_the_reference():
    ref = _ref()
    rng = np.random.default_rng(9)
    for _ in range(20):
        goodput = {f"t{i}": float(v) for i, v in
                   enumerate(rng.integers(0, 50, rng.integers(1, 5)))}
        weights = {k: float(rng.uniform(0.5, 4.0)) for k in goodput}
        assert fairness_error(goodput, weights) == \
            ref.fairness_error(goodput, weights)
        lats = [float(x) for x in rng.exponential(0.05, rng.integers(1, 300))]
        assert quantiles_ms(lats) == ref.quantiles_ms(lats)
    text = "".join(
        f'mmlspark_serving_requests_total{{transport="t{i}"}} {v}\n'
        for i, v in enumerate(rng.integers(0, 1000, 6))) + \
        'mmlspark_other_total{x="y"} 5\n'
    assert merged_requests_total(text) == ref.merged_requests_total(text)


def _samples(scenario, seed):
    rng = random.Random(seed)
    out = []
    for a in plan(scenario):
        if rng.random() < 0.05:
            out.append(None)          # a lost arrival
            continue
        attempts = rng.choice((1, 1, 1, 2, 3))
        out.append({
            "index": a.index, "tenant": a.tenant, "workload": a.workload,
            "rows": a.rows, "attempts": attempts,
            "outcome": rng.choice(("ok", "ok", "ok", "shed", "error")),
            "at": round(a.at, 6), "honored_retries": rng.randint(0, 1),
            "send_lag_s": round(rng.uniform(0, 0.01), 6),
            "sched_lat_s": round(rng.uniform(0.001, 0.3), 6),
            "send_lat_s": round(rng.uniform(0.001, 0.2), 6)})
    return out


def test_build_scorecard_matches_the_reference():
    """The same samples, counters, costs and cluster view give the same
    scorecard dict (its wall-clock stamp ``t`` aside)."""
    from mmlspark_tpu_torch.loadgen import build_scorecard
    ref = _ref()
    for name in ("smoke", "mixed-tenant-chaos", "decode-kill"):
        sc, ref_sc = get_scenario(name), ref.get_scenario(name)
        samples = _samples(sc, 11)
        before = {"breaker_transitions": 2.0, "breaker_opens": 1.0,
                  "requests_shed": 3.0, "wfq_shed": 0.0,
                  "faults_injected": 4.0, "serving_requests": 10.0}
        after = {k: v * 3 + 1 for k, v in before.items()}
        costs = {"classes": [{"tenant": "acme", "device_seconds": 0.5,
                              "requests": 40}]}
        cluster = {"workers": 3, "merged_requests_total": 93.0,
                   "global_requests_total": 31.0, "reconciled": True}
        closed = {"loop_mode": "closed", "n": 8, "ok": 8,
                  "latency_ms": ref.quantiles_ms([0.01, 0.02, 0.03])}
        sessions = ({"sessions": 6, "lost": 0, "recovered": 2,
                     "recovery_p99_ms": 120.0}
                    if name == "decode-kill" else None)
        kw = dict(window_s=sc.duration_s, counters_before=before,
                  counters_after=after, costs=costs, cluster_view=cluster,
                  closed_loop=closed, mesh_shape="single", kv_dtype="int8",
                  sessions=sessions)
        got = build_scorecard(sc, [dict(x) if x else None for x in samples],
                              **kw)
        want = ref.build_scorecard(ref_sc, [dict(x) if x else None
                                            for x in samples], **kw)
        assert "t" in got and "t" in want
        got.pop("t")
        want.pop("t")
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)
