"""Port parity: request tracing, the SLO tracker, the cost ledger, the lock
sanitizer, the profiling helpers and the tuning observations
(``mmlspark_tpu_torch/observability/{tracing,slo,ledger}.py``,
``reliability/lock_sanitizer.py``, ``utils/profiling.py``,
``tuning/observations.py``) against the JAX package's copies.

The cases follow the reference's ``tests/test_tracing.py``,
``tests/test_slo.py``, ``tests/test_cost_ledger.py`` and
``tests/test_lock_sanitizer.py``: the same inputs, with injected clocks
where time matters, go to both packages and the outputs must be EQUAL
(these modules are stdlib-only; nothing numeric differs): traceparent
strings, span trees (ids and timestamps aside), flight-recorder
retention, SLO windows, burn rates and scorecards, ledger snapshots and
heavy hitters, harvested observation rows, lock-order cycle reports.
The profiling cases are the port's own (``torch.profiler`` in place of
``jax.profiler``).

:func:`reset_plane` resets the eight process-global singletons of the
plane (SLO tracker, cost ledger, time-series store, alert engine,
watchdog, model registry, flight recorder, observation store) and the
metrics registry in BOTH packages; the other plane tests import it.
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import mmlspark_tpu.observability as r_obs
import mmlspark_tpu.observability.ledger as r_ledger
import mmlspark_tpu.observability.slo as r_slo
import mmlspark_tpu.observability.timeseries as r_ts
import mmlspark_tpu.observability.tracing as r_tracing
import mmlspark_tpu.reliability.lock_sanitizer as r_locks
import mmlspark_tpu.serving.registry as r_registry
import mmlspark_tpu.tuning.observations as r_tobs
import mmlspark_tpu_torch.observability as p_obs
import mmlspark_tpu_torch.observability.ledger as p_ledger
import mmlspark_tpu_torch.observability.slo as p_slo
import mmlspark_tpu_torch.observability.timeseries as p_ts
import mmlspark_tpu_torch.observability.tracing as p_tracing
import mmlspark_tpu_torch.reliability.lock_sanitizer as p_locks
import mmlspark_tpu_torch.serving.registry as p_registry
import mmlspark_tpu_torch.tuning.observations as p_tobs
from mmlspark_tpu_torch.utils import profiling

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

PKGS = {
    "jax": SimpleNamespace(obs=r_obs, tracing=r_tracing, slo=r_slo,
                           ledger=r_ledger, ts=r_ts, locks=r_locks,
                           registry=r_registry, tobs=r_tobs),
    "port": SimpleNamespace(obs=p_obs, tracing=p_tracing, slo=p_slo,
                            ledger=p_ledger, ts=p_ts, locks=p_locks,
                            registry=p_registry, tobs=p_tobs),
}

TID = "4bf92f3577b34da6a3ce929d0e0e4736"
SID = "00f067aa0ba902b7"


def reset_plane() -> None:
    """Reset every process-global singleton of the plane in both packages
    (and both metrics registries), so no test sees another's state."""
    for pkg in PKGS.values():
        pkg.obs.reset_tracker()
        pkg.obs.reset_ledger()
        pkg.ts.reset_alert_engine()
        pkg.ts.reset_store()
        pkg.obs.reset_watchdog()
        pkg.registry.reset_registry()
        pkg.tracing.get_flight_recorder().clear()
        pkg.tobs.reset_store()
        pkg.tracing.set_exemplars(False)
        pkg.obs.reset_all()


@pytest.fixture(autouse=True)
def _clean_plane():
    reset_plane()
    yield
    reset_plane()


def both(fn):
    """``fn(pkg)`` for each package; returns {"jax": ..., "port": ...}."""
    return {name: fn(pkg) for name, pkg in PKGS.items()}


def assert_same(fn):
    out = both(fn)
    assert out["port"] == out["jax"]
    return out["port"]


# ---------------------------------------------------------------------------
# tracing

HEADERS = [
    f"00-{TID}-{SID}-01", f" 00-{TID.upper()}-{SID}-00 ",
    f"cc-{TID}-{SID}-01-extra", None, "", "garbage", f"00-{TID}-{SID}",
    f"00-{'0' * 32}-{SID}-01", f"00-{TID}-{'0' * 16}-01",
    f"ff-{TID}-{SID}-01", f"00-{TID}-{SID}-01-extra",
    f"00-{TID[:-2]}-{SID}-01",
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_and_echo_equal(header):
    def run(pkg):
        parsed = pkg.tracing.parse_traceparent(header)
        root = pkg.tracing.start_trace("server.request", traceparent=header)
        root.span_id = SID[::-1]          # the one random part of the echo
        echo = pkg.tracing.format_traceparent(root)
        continued = root.trace_id == TID
        return parsed, echo if continued else echo.split("-")[2], continued
    assert_same(run)


def _tree(doc):
    """A span tree without its ids, timestamps, durations and threads."""
    return {"name": doc["name"], "attrs": doc["attrs"],
            "events": [{"name": e["name"], "fields": e.get("fields")}
                       for e in doc["events"]],
            "children": [_tree(c) for c in doc["children"]]}


def test_span_tree_events_and_propagation_equal():
    def run(pkg):
        tr = pkg.tracing
        root = tr.start_trace("req", traceparent=f"00-{TID}-{SID}-01",
                              request_id="rid-1", tenant="a")
        with tr.activate(root):
            with tr.start_span("outer", k="v"):
                tr.add_event("milestone", n=1)
                with tr.start_span("inner"):
                    pass
            seen = {}

            def work():
                seen["trace"] = tr.current_trace_id()
                with tr.start_span("in_thread", i=3):
                    tr.add_event("worker", ok=True)
            t = threading.Thread(target=tr.propagate(work))
            t.start()
            t.join(5)
        assert root.end(status=200) and not root.end(status=500)
        doc = root.trace.to_dict()
        chrome = root.trace.to_chrome()
        return (seen["trace"], doc["name"], doc["request_id"],
                doc["trace_id"], [_tree(r) for r in doc["roots"]],
                sorted(e["name"] for e in chrome["traceEvents"]),
                root.attrs)
    out = assert_same(run)
    assert out[0] == TID


def test_span_cap_and_inert_outside_a_trace_equal():
    def run(pkg):
        tr = pkg.tracing
        with tr.start_span("orphan") as s:
            tr.add_event("nothing")
        root = tr.start_trace("req")
        with tr.activate(root):
            for i in range(tr.MAX_SPANS_PER_TRACE + 10):
                with tr.start_span(f"s{i}"):
                    pass
        root.end()
        return s, len(root.trace.spans), root.trace.dropped
    assert_same(run)


def test_flight_recorder_ring_and_slow_retention_equal():
    def run(pkg):
        rec = pkg.tracing.FlightRecorder(capacity=4, slow_threshold=0.5,
                                         slow_keep=2)
        kept = []
        for i in range(9):
            root = pkg.tracing.start_trace(
                "req", traceparent=f"00-{i + 1:032x}-{SID}-01")
            root._start -= 1.0 if i in (1, 5, 6) else 0.0   # 1 s: slow
            root.end()
            rec.record(root.trace)
            kept.append([s["trace_id"] for s in rec.summaries()])
        return kept, rec.get(f"{2:032x}") is None
    assert_same(run)


def test_event_log_stamps_trace_and_request_id():
    def run(pkg):
        recs = []
        log = pkg.obs.EventLog(SimpleNamespace(
            isEnabledFor=lambda lvl: True,
            log=lambda lvl, fmt, *a: recs.append(json.loads(fmt % a))))
        root = pkg.tracing.start_trace("req", traceparent=f"00-{TID}-{SID}-01",
                                       request_id="rid-9")
        with pkg.tracing.activate(root):
            log.emit("thing", x=1)
        log.emit("bare", x=2)
        return [{k: v for k, v in r.items() if k != "ts"} for r in recs]
    out = assert_same(run)
    assert out[0]["trace_id"] == TID and "trace_id" not in out[1]


def test_exemplars_render_equal():
    def run(pkg):
        h = pkg.obs.histogram("t_plane_exemplar_seconds", "test", ("k",),
                              buckets=(0.1, 1.0))
        pkg.tracing.set_exemplars(True)
        root = pkg.tracing.start_trace("req",
                                       traceparent=f"00-{TID}-{SID}-01")
        with pkg.tracing.activate(root):
            h.observe(0.05, k="a")
        h.observe(2.0, k="a")
        text = pkg.obs.render()
        return [ln for ln in text.splitlines() if "t_plane_exemplar" in ln]
    out = assert_same(run)
    assert any(f'trace_id="{TID}"' in ln for ln in out)


def test_build_info_names_torch_and_never_initializes_cuda():
    g = p_obs.build_info()
    (labels, _series), = g.series()
    assert labels["torch"] == torch.__version__
    assert labels["backend"] in ("cpu", "cuda")
    assert "jax" not in labels
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# SLO tracker


def _slo_script(pkg):
    now = [0.0]
    tr = pkg.slo.SloTracker(policy=pkg.slo.SloPolicy(availability=0.99,
                                                     target_p99=0.05),
                            window_seconds=12.0, num_buckets=4,
                            clock=lambda: now[0], max_classes=4)
    out = []
    for step in range(30):
        now[0] = step * 0.75
        for i in range(step % 4 + 1):
            tr.observe(transport="threaded", route="api",
                       model="m@1" if i % 2 else "m@2",
                       seconds=0.001 * (step + i), error=(step + i) % 7 == 0,
                       tenant=f"t{i % 2}")
        if step % 5 == 0:
            tr.shed(transport="threaded", route="api", tenant="t1")
            tr.note_kv_quant_error("m@2", 0.01 * step)
        out.append((tr.burn_rate("threaded", "api"),
                    tr.model_window("m@1"), tr.model_window("m@2")))
    for i in range(6):    # past max_classes: the overflow lands in "other"
        tr.observe(transport=f"x{i}", route="api", seconds=0.002)
    card = tr.scorecard()
    card.pop("t")                 # wall-clock stamp
    out.append(card)
    return out


def test_slo_windows_burn_rates_and_scorecards_equal():
    out = assert_same(_slo_script)
    card = out[-1]
    assert any(c["transport"] == "other" for c in card["classes"])


@pytest.mark.parametrize("path", ["/", "/api", "/generate", "/healthz",
                                  "/metrics", "/debug/traces/abc",
                                  "/models?x=1", "/_reply/7", None])
def test_classify_route_equal(path):
    assert_same(lambda pkg: pkg.slo.classify_route(path))


def test_global_tracker_idiom():
    def run(pkg):
        a = pkg.obs.get_tracker()
        t = pkg.slo.SloTracker()
        pkg.obs.set_tracker(t)
        same = pkg.obs.get_tracker() is t
        pkg.obs.reset_tracker()
        return same, pkg.obs.get_tracker() is not t, a is not None
    assert assert_same(run) == (True, True, True)


# ---------------------------------------------------------------------------
# cost ledger


def _ledger_script(pkg):
    led = pkg.ledger.CostLedger(max_classes=3, top_k=3)
    cls = [("threaded", "api", "m@1", "t0"), ("async", "api", "m@2", "t1"),
           ("threaded", "generate", "default", "default"),
           ("async", "api", "m@3", "t2")]
    for i in range(20):
        led.charge("device_seconds", 0.01 * (i + 1), cls=cls[i % 4],
                   trace_id=f"{i % 6:032x}")
        led.charge("kv_page_seconds", 0.5 * i, cls=cls[(i + 1) % 4],
                   trace_id=f"{i % 5:032x}")
        led.charge("queue_wait_seconds", 0.001 * i, cls=cls[i % 2])
    led.charge_shares("device_seconds", 0.3,
                      [(cls[0], "a" * 32, 1.0), (cls[1], "b" * 32, 2.0)])
    led.charge_shares("device_seconds", 0.3, [])
    led.charge("device_seconds", 0.0, cls=cls[0])
    led.charge("device_seconds", -1.0, cls=cls[0])
    try:
        led.charge("nope", 1.0)
        raised = False
    except (KeyError, ValueError):
        raised = True
    snap = led.snapshot()
    snap.pop("t", None)
    return snap, led.class_totals("device_seconds"), raised


def test_ledger_snapshots_and_heavy_hitters_equal():
    snap, _totals, raised = assert_same(_ledger_script)
    assert raised and snap["classes"]


def test_ledger_charge_shares_equal():
    """The decoder's per-tick apportionment over many slots: overflowing
    classes, heavy-hitter evictions, dropped weights, ambient-context
    shares, one slot's trace unknown; snapshot and counters as the JAX
    ledger's, which charges share by share."""
    def run(pkg):
        led = pkg.ledger.CostLedger(max_classes=3, top_k=4)
        classes = [("threaded", "generate", f"gen@{k % 2}", f"t{k}")
                   for k in range(5)]
        root = pkg.tracing.start_trace(
            "server.request", traceparent=f"00-{TID}-{SID}-01",
            transport="async", url="/generate", model="gen@1", tenant="t9")
        for tick in range(12):
            shares = [(classes[(tick + s) % 5],
                       None if s == 3 else f"{(tick * 3 + s) % 11:032x}",
                       float(s % 4)) for s in range(16)]
            shares.append((None, None, 2.0))
            with pkg.tracing.activate(root):
                led.charge_shares("device_seconds", 0.004 * (tick + 1),
                                  shares)
            led.charge_shares("kv_page_seconds", 1.5, shares[:5])
        led.charge_shares("device_seconds", 1.0, [(classes[0], "x", 0.0)])
        try:
            led.charge_shares("nope", 1.0, [(classes[0], "x", 1.0)])
            raised = False
        except ValueError:
            raised = True
        snap = led.snapshot()
        snap.pop("t", None)
        counters = [ln for ln in pkg.obs.render().splitlines()
                    if ln.startswith("mmlspark_cost_")]
        return snap, counters, raised
    snap, counters, raised = assert_same(run)
    assert raised and len(snap["heavy_hitters"]) == 4
    assert any(c["tenant"] == "other" for c in snap["classes"])
    assert any("mmlspark_cost_charges_total{" in ln for ln in counters)


def test_ledger_resolves_class_from_root_span_equal():
    def run(pkg):
        root = pkg.tracing.start_trace(
            "server.request", traceparent=f"00-{TID}-{SID}-01",
            transport="async", url="/generate", model="gen@1", tenant="t")
        untraced = pkg.ledger.resolve_context()
        with pkg.tracing.activate(root):
            with pkg.tracing.start_span("child"):
                ctx = pkg.ledger.resolve_context()
                pkg.obs.charge("device_seconds", 0.25)
        snap = pkg.obs.get_ledger().snapshot()
        snap.pop("t", None)
        return untraced, ctx, snap
    untraced, ctx, _ = assert_same(run)
    assert untraced[1] is None
    assert ctx[0][2:] == ("gen@1", "t") and ctx[1] == TID


def test_harvested_cost_and_slo_rows_equal():
    def run(pkg):
        store = pkg.tobs.ObservationStore()
        led = pkg.ledger.CostLedger()
        led.charge("device_seconds", 0.5, cls=("threaded", "api", "bert@2",
                                               "t1"), trace_id="c" * 32)
        led.charge("kv_page_seconds", 2.0, cls=("threaded", "api",
                                                "default", "default"))
        snap = led.snapshot()
        n_cost = pkg.tobs.harvest_costs(snap, store=store)
        now = [100.0]
        tr = pkg.slo.SloTracker(clock=lambda: now[0])
        for i in range(10):
            tr.observe(transport="threaded", route="api", model="bert@1",
                       seconds=0.01 * i, tenant="t0")
        n_slo = pkg.tobs.harvest_scorecard(tr.scorecard(), store=store)
        rows = [{k: v for k, v in r.items() if k not in ("t", "ts")}
                for r in store.rows()]
        return n_cost, n_slo, rows
    n_cost, n_slo, rows = assert_same(run)
    assert n_cost == 2 and n_slo >= 1 and len(rows) == n_cost + n_slo


# ---------------------------------------------------------------------------
# lock sanitizer


def test_lock_order_cycle_reports_equal():
    def run(pkg):
        locks = pkg.locks
        locks.configure(enabled=True)
        try:
            a = locks.new_lock("plane.A")
            b = locks.new_lock("plane.B")
            with a:
                with b:
                    held = {k: sorted(s for s, _ in v) if isinstance(v, list)
                            else v for k, v in locks.held_by_thread().items()}
            with b:
                with a:
                    pass
            reports = locks.cycle_reports()
            return (type(a).__name__, len(reports),
                    sorted({tuple(sorted(r.get("cycle", r.get("sites", []))))
                            for r in reports}), bool(held))
        finally:
            locks.configure(enabled=False)
            locks.reset()
    out = assert_same(run)
    assert out[1] >= 1


def test_disabled_sanitizer_hands_out_plain_locks():
    def run(pkg):
        pkg.locks.configure(enabled=False)
        lk = pkg.locks.new_lock("plane.plain")
        return type(lk) is type(threading.Lock())
    assert assert_same(run) == True    # noqa: E712


# ---------------------------------------------------------------------------
# profiling (the port's torch.profiler counterparts)


def test_annotate_is_a_shared_noop_without_a_profiler():
    a, b = profiling.annotate("x"), profiling.annotate("y")
    assert type(a).__name__ == "nullcontext" and type(b) is type(a)


def test_span_tracer_and_request_trace_agree(tmp_path):
    root = p_tracing.start_trace("req", traceparent=f"00-{TID}-{SID}-01")
    with profiling.SpanTracer(mirror_metrics=True) as t:
        with p_tracing.activate(root):
            with profiling.span("outer", n=1):
                with profiling.span("inner"):
                    pass

            def work():
                with profiling.span("worker"):
                    pass
            th = threading.Thread(target=p_tracing.propagate(work))
            th.start()
            th.join(5)
    root.end()
    assert sorted(e["name"] for e in t.events) == ["inner", "outer",
                                                   "worker"]
    names = sorted(s.name for s in root.trace.spans)
    assert names == ["inner", "outer", "req", "worker"]
    path = t.export(str(tmp_path / "spans.json"))
    assert json.load(open(path))["traceEvents"]
    snap = p_obs.snapshot()["mmlspark_span_seconds"]
    assert {s["labels"]["name"] for s in snap["series"]} == \
        {"inner", "outer", "worker"}


def test_trace_capture_writes_a_chrome_trace_with_annotations(tmp_path):
    log_dir = str(tmp_path / "prof")
    with profiling.trace(log_dir):
        with profiling.annotate("continuous.prefill"):
            torch.ones(8).add_(1)
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    doc = json.load(open(path))
    assert any(e.get("name") == "continuous.prefill"
               for e in doc["traceEvents"])
    assert type(profiling.annotate("after")).__name__ == "nullcontext"


def test_stopwatch_accumulates():
    sw = profiling.StopWatch()
    with sw:
        time.sleep(0.001)
    first = sw.elapsed_ns
    assert sw.measure(lambda: 7) == 7
    assert sw.elapsed_ns >= first > 0 and sw.elapsed_s > 0


def test_trace_capture_records_the_other_threads(tmp_path):
    """``/debug/profile`` captures from its own thread while the engine's
    thread does the work: that thread's ranges must be in the trace."""
    stop, ran = threading.Event(), threading.Event()

    def engine():
        while not stop.is_set():
            with profiling.annotate("continuous.drain"):
                torch.ones(4).add_(1)
                if type(profiling.annotate("x")).__name__ != "nullcontext":
                    ran.set()
            time.sleep(0.002)
    t = threading.Thread(target=engine)
    t.start()
    log_dir = str(tmp_path / "prof")
    try:
        cap = threading.Thread(target=lambda: _capture(log_dir, ran))
        cap.start()
        cap.join(30)
    finally:
        stop.set()
        t.join(5)
    doc = json.load(open(os.path.join(log_dir, profiling.TRACE_FILE)))
    assert any(e.get("name") == "continuous.drain"
               for e in doc["traceEvents"])


def _capture(log_dir, ran):
    with profiling.trace(log_dir):
        ran.wait(5)
        time.sleep(0.05)
