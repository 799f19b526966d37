"""Port parity: the time-series store with its sampler and alert engine,
cross-worker federation, the stall watchdog, the journal's ``trace``
field and watchdog bundle, and the admission queue's time-series seed
(``mmlspark_tpu_torch/observability/{timeseries,federation,watchdog}.py``,
``serving/journal.py``, ``serving/admission.py``) against the JAX
package's copies.

The cases follow the reference's ``tests/test_timeseries.py``,
``tests/test_federation.py``, ``tests/test_watchdog.py`` and
``tests/test_serving_journal.py``. Clocks are injected (a list the test
advances), and the outputs must be EQUAL across packages: range, rate,
EWMA and sustained queries, snapshots and sparklines, alert transition
sequences, federated merges of one package's ``worker_snapshot`` by the
other's ``ClusterAggregator`` (both directions), stall records and the
bundle's blocks, journal bytes with the ``trace`` field, and the
``Retry-After`` a queue seeds from the store after an idle gap.
"""

import json
import threading
import time

import pytest
import torch

import mmlspark_tpu.observability.federation as r_fed
import mmlspark_tpu.observability.watchdog as r_wd
import mmlspark_tpu.serving.admission as r_adm
import mmlspark_tpu.serving.journal as r_journal
import mmlspark_tpu_torch.observability.federation as p_fed
import mmlspark_tpu_torch.observability.watchdog as p_wd
import mmlspark_tpu_torch.serving.admission as p_adm
import mmlspark_tpu_torch.serving.journal as p_journal
from mmlspark_tpu.io.http import schema as r_schema
from mmlspark_tpu_torch.io.http import schema as p_schema
from test_torch_tracing_slo import PKGS, assert_same, reset_plane

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

for _name, _mods in {"jax": (r_fed, r_wd, r_adm, r_journal, r_schema),
                     "port": (p_fed, p_wd, p_adm, p_journal,
                              p_schema)}.items():
    (PKGS[_name].fed, PKGS[_name].wd, PKGS[_name].adm, PKGS[_name].journal,
     PKGS[_name].schema) = _mods

TID = "4bf92f3577b34da6a3ce929d0e0e4736"
TIERS = ((1.0, 30), (5.0, 24), (30.0, 10))


@pytest.fixture(autouse=True)
def _clean_plane():
    reset_plane()
    yield
    reset_plane()


def _store(pkg, now, max_series=16):
    return pkg.ts.TimeSeriesStore(TIERS, clock=lambda: now[0],
                                  max_series=max_series)


# ---------------------------------------------------------------------------
# the store


def _store_script(pkg):
    now = [1000.0]
    st = _store(pkg, now)
    for i in range(120):
        now[0] = 1000.0 + i * 0.5
        st.record("q_depth", (i % 17) * 1.5, {"port": "1"})
        st.record("q_depth", i * 0.25, {"port": "2"})
        st.record("tok:rate", 40.0 + (i % 5), kind="rate")
        if i % 3 == 0:
            st.record("lat_p99", 0.01 * (i % 11), {"route": "api"})
    st.record("bad", float("nan"))
    for j in range(20):                          # past max_series: dropped
        st.record(f"extra{j}", 1.0)
    out = {"range": [st.range("q_depth", s, labels={"port": "1"})
                     for s in (10.0, 60.0, 200.0)],
           "latest": st.latest("q_depth", {"port": "2"}),
           "rate": st.rate("q_depth", 30.0, labels={"port": "2"}),
           "ewma": st.ewma("tok:rate", 30.0),
           "sustained": st.sustained("q_depth", lambda v: v > 5.0, 3.0,
                                     labels={"port": "2"}),
           "names": st.names(), "stats": st.stats(),
           "snapshot": st.snapshot(60.0, names=["q_depth", "lat_p99"])}
    out["snapshot"].pop("t", None)
    return out


def test_store_queries_and_snapshots_equal():
    out = assert_same(_store_script)
    assert out["stats"]["series"] == 16 and out["latest"] is not None


@pytest.mark.parametrize("seconds", [15.0, 60.0, 240.0])
def test_sparklines_equal(seconds):
    def run(pkg):
        now = [50.0]
        st = _store(pkg, now)
        for i in range(90):
            now[0] = 50.0 + i
            st.record("mmlspark_queue_saturation", (i % 9) / 9.0,
                      {"port": "8"})
            st.record("goodput", 100.0 + 3 * (i % 4))
        return pkg.ts.render_sparklines(st, seconds)
    text = assert_same(run)
    assert "goodput" in text


@pytest.mark.parametrize("spec", [
    None, "", "hot:q_depth>0.5:3",
    "slow:lat_p99>=0.2:for=1:keep=4;low:goodput<10:2",
    "bogus", "x:y~3:1",
])
def test_parse_alert_rules_equal(spec):
    def run(pkg):
        try:
            return [r.describe() for r in pkg.ts.parse_alert_rules(spec)]
        except ValueError as e:
            return f"ValueError: {e}"
    assert_same(run)


def test_default_alert_rules_equal():
    assert_same(lambda pkg: [r.describe() for r in
                             pkg.ts.default_alert_rules(for_seconds=2.0)])


def test_alert_firing_sequences_equal():
    def run(pkg):
        now = [0.0]
        st = _store(pkg, now)
        eng = pkg.ts.AlertEngine(st, on_fire=[])
        eng.add_rule(pkg.ts.AlertRule("hot", "q_sat", "gt", 0.8,
                                      for_seconds=3.0,
                                      keep_firing_seconds=2.0))
        eng.add_rule(pkg.ts.AlertRule("low", "goodput", "lt", 10.0,
                                      for_seconds=1.0))
        seq = []
        for i in range(40):
            now[0] = float(i)
            st.record("q_sat", 0.9 if 5 <= i < 15 or 25 <= i < 27 else 0.1)
            st.record("goodput", 5.0 if i in (30, 31, 32) else 50.0)
            seq.append((i, eng.evaluate(at=now[0]), eng.firing()))
        state = eng.state()
        return seq, state
    seq, _ = assert_same(run)
    assert any(f for _, _, f in seq) and not seq[-1][2]


def test_sampler_tick_feeds_counters_gauges_histograms_and_sources():
    def run(pkg):
        now = [0.0]
        # room for every series of the package's registry, not just ours
        st = _store(pkg, now, max_series=100_000)
        sampler = pkg.ts.RegistrySampler(st, interval=3600.0,
                                         clock=lambda: now[0])
        c = pkg.obs.counter("t_plane_total", "test", ("k",))
        g = pkg.obs.gauge("t_plane_gauge", "test")
        h = pkg.obs.histogram("t_plane_seconds", "test",
                              buckets=(0.01, 0.1, 1.0))
        sampler.add_source("t_plane_source", lambda: now[0] * 2, port="3")
        for i in range(12):
            now[0] = float(i)
            c.inc(i % 3 + 1, k="a")
            g.set(i * 1.5)
            h.observe(0.005 * (i + 1))
            sampler.tick(now[0])
        names = [n for n in st.names() if n.startswith("t_plane")]
        return sorted(names), {n: st.range(n, 20.0) for n in names}
    names, _ = assert_same(run)
    assert "t_plane_total:rate" in names and "t_plane_source" in names


def test_acquire_release_sampler_is_refcounted():
    def run(pkg):
        a = pkg.ts.acquire_sampler()
        b = pkg.ts.acquire_sampler()
        same = a is b and pkg.ts.get_sampler() is a
        pkg.ts.release_sampler()
        alive = pkg.ts.get_sampler() is a
        pkg.ts.release_sampler()
        return same, alive, pkg.ts.get_sampler() is None
    assert assert_same(run) == (True, True, True)


# ---------------------------------------------------------------------------
# federation


def _feed_worker(pkg, scale):
    c = pkg.obs.counter("t_fed_requests_total", "test", ("code",))
    h = pkg.obs.histogram("t_fed_seconds", "test", buckets=(0.01, 0.1))
    for i in range(5 * scale):
        c.inc(code="200" if i % 4 else "500")
        h.observe(0.003 * i)
    tr = pkg.obs.get_tracker()
    for i in range(7 * scale):
        tr.observe(transport="threaded", route="api", model="m@1",
                   seconds=0.002 * i, error=i % 5 == 0, tenant="t0")


def _ours(snap):
    snap = dict(snap)
    snap["metrics"] = {k: v for k, v in snap["metrics"].items()
                       if k.startswith("t_fed")}
    return snap


def test_worker_snapshot_merges_across_packages_both_ways():
    payloads = {}
    for name, pkg in PKGS.items():
        _feed_worker(pkg, 1)
        payloads[name] = _ours(pkg.fed.worker_snapshot())
    assert payloads["port"] == payloads["jax"]
    merged = {}
    for name, pkg in PKGS.items():
        other = "port" if name == "jax" else "jax"
        agg = pkg.fed.ClusterAggregator()
        agg.ingest("w0", payloads[name])
        agg.ingest("w1", payloads[other])
        agg.ingest("w1", payloads[other])      # a repeat adds nothing
        card = agg.scorecard()
        card.pop("t", None)
        merged[name] = ({k: v for k, v in agg.merged_snapshot().items()
                         if k.startswith("t_fed")},
                        [ln for ln in agg.render().splitlines()
                         if "t_fed" in ln], card)
    assert merged["port"] == merged["jax"]
    assert merged["port"][0]["t_fed_requests_total"]


def test_worker_snapshot_size_bound_sheds_the_same_way():
    def run(pkg):
        _feed_worker(pkg, 2)
        small = pkg.fed.worker_snapshot(max_bytes=64)
        return small["metrics"], small["slo"].get("slo_classes_only")
    assert assert_same(run) == ({}, True)


def test_cluster_sampler_equal():
    def run(pkg):
        now = [0.0]
        st = _store(pkg, now)
        cs = pkg.ts.ClusterSampler(st)
        for i in range(6):
            now[0] = float(i)
            for w in ("w0", "w1"):
                cs.observe(w, {"queue_depth": i, "in_flight": 2 * i,
                               "hbm_bytes_in_use": 1000.0 * i})
        snap = cs.snapshot(60.0)
        snap.pop("t", None)
        return snap
    assert_same(run)


# ---------------------------------------------------------------------------
# the watchdog


def _stall(pkg, tmp_path):
    now = [0.0]
    wd = pkg.wd.Watchdog(enabled=True, interval=3600.0, default_budget=1.0,
                         diag_dir=str(tmp_path / "diag"),
                         clock=lambda: now[0])
    fired = []
    wd.on_stall(fired.append)
    try:
        with wd.watch("decoder_drain", 2.0) as w:
            now[0] = 1.5
            first = wd.scan_once()
            w.beat()
            now[0] = 3.0
            second = wd.scan_once()
            now[0] = 6.0
            third = wd.scan_once()
            again = wd.scan_once()
        with wd.watch("runner_drain"):
            now[0] = 6.5
            clean = wd.scan_once()
    finally:
        wd.stop()
    rec = third[0]
    bundle = json.load(open(rec["bundle"]))
    return ([len(first), len(second), len(third), len(again), len(clean)],
            rec["site"], rec["stalled_seconds"], rec["budget_seconds"],
            sorted(bundle), len(fired),
            [{k: v for k, v in d.items() if k != "path"}
             for d in bundle["journal"]])


def test_stall_fires_once_with_the_same_bundle_blocks(tmp_path):
    def run(pkg):
        j = pkg.journal.ServingJournal(str(tmp_path / f"{id(pkg)}.jnl"),
                                       fsync=False)
        try:
            out = _stall(pkg, tmp_path / str(id(pkg)))
        finally:
            j.close()
        return out
    counts, site, stalled, budget, keys, fired, journal = assert_same(run)
    assert counts == [0, 0, 1, 0, 0] and site == "decoder_drain"
    assert {"stacks", "metrics", "traces", "residency", "locks_held",
            "journal"} <= set(keys) and fired == 1 and len(journal) == 1


def test_disabled_watch_is_the_shared_noop_in_both():
    def run(pkg):
        wd = pkg.wd.Watchdog(enabled=False)
        a, b = wd.watch("x"), pkg.wd.watch("y")
        return a is b, a is pkg.wd._NULL_WATCH
    assert assert_same(run) == (True, True)


def test_stop_while_a_watch_starts_the_scan_thread(monkeypatch):
    """``stop()`` racing the first watch: a thread that enters a watch
    makes the scan thread and starts it; a ``stop()`` (``reset_watchdog``)
    in between must not join a thread that is not started yet. The
    start is held open until ``stop()`` has been called, then delayed,
    so the race lands every time."""
    made, go = threading.Event(), threading.Event()
    real = threading.Thread

    class SlowStart(real):
        def start(self):
            made.set()
            go.wait(5)
            time.sleep(0.2)
            super().start()

    monkeypatch.setattr(p_wd.threading, "Thread", SlowStart)
    wd = p_wd.Watchdog(enabled=True, interval=3600.0)
    entered = real(target=lambda: wd.watch("decoder_drain").__enter__())
    entered.start()
    assert made.wait(5)
    go.set()
    wd.stop()                       # joins the started scan thread
    entered.join(5)
    assert wd._thread is None and not entered.is_alive()


def _memory_series():
    from mmlspark_tpu_torch.observability import snapshot
    return {k: v for k, v in snapshot().items()
            if "hbm" in k and v.get("series")}


def test_hbm_gauges_need_an_initialized_card():
    was = torch.cuda.is_initialized()
    assert p_wd.register_hbm_gauges() == 0 or torch.cuda.is_available()
    assert torch.cuda.is_initialized() == was
    assert "cuda" not in json.dumps(_memory_series())


@pytest.mark.cuda
def test_hbm_gauges_read_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 20, device="cuda")
    assert p_wd.register_hbm_gauges() >= 1
    snap = _memory_series()
    used = snap["mmlspark_device_hbm_bytes_in_use"]["series"][0]["value"]
    total = snap["mmlspark_device_hbm_bytes_limit"]["series"][0]["value"]
    assert 0 < used <= total and x.numel()


# ---------------------------------------------------------------------------
# journal trace field and the admission seed


def _request(schema, body):
    return schema.HTTPRequestData(
        url="/generate", method="POST",
        headers=[schema.HeaderData("traceparent", f"00-{TID}-{'1' * 16}-01")],
        entity=schema.EntityData.from_string(body))


def test_journal_records_with_trace_are_byte_equal(tmp_path):
    def run(pkg):
        path = str(tmp_path / f"{id(pkg)}.jnl")
        j = pkg.journal.ServingJournal(path, fsync=False)
        j.record_request("r1", 0, _request(pkg.schema, '{"tokens": [1]}'),
                         trace_id=TID)
        j.record_request("r2", 0, _request(pkg.schema, '{"tokens": [2]}'))
        j.record_reply("r1")
        j.record_epoch(1)
        j.maybe_compact(1)
        j.close()
        j2 = pkg.journal.ServingJournal(path, fsync=False)
        epoch, pending = j2.replay()
        j2.close()
        return open(path, "rb").read(), epoch, sorted(pending)
    raw, epoch, pending = assert_same(run)
    assert TID.encode() in raw or pending == ["r2"]


def test_retry_after_seeds_from_the_store_after_an_idle_gap():
    def run(pkg):
        now = [500.0]
        st = _store(pkg, now)
        pkg.ts.set_store(st)
        for i in range(30):
            now[0] = 500.0 + i
            st.record("mmlspark_queue_drain_rate", 4.0 + (i % 3),
                      {"port": "77"})
        q = pkg.adm.AdmissionQueue(100)
        cold = q.suggest_retry_after(floor=0.5)
        q.history_key = "77"
        for i in range(12):
            q.put_nowait(i)
        seeded = q.suggest_retry_after(floor=0.5)
        return cold, seeded, q.drain_rate()
    cold, seeded, rate = assert_same(run)
    assert seeded > cold and rate is not None
