"""Port parity: the distributed serving plane
(``mmlspark_tpu_torch.serving.distributed``), its breakers and
supervised loops, and the decoders behind it.

One counterpart for each test of the reference's
``tests/test_serving_distributed.py`` (registry, cross-worker reply
routing, forwarding, kill-and-replay, deadlines, the chaos drill),
``tests/test_session_failover.py`` (the journal's session records, page
blobs, decoder failover, cluster kill and drain over ``/_adopt``),
``tests/test_distributed_rendezvous.py``, and the cluster drills at
``tests/test_federation.py:257``, ``tests/test_registry.py:374-386`` and
``tests/test_timeseries.py:458``.

Then the parity with the JAX package on the CPU: a ``CircuitBreaker``
in each package goes through the same states on one seeded sequence
under one fake clock; a JAX worker registers, heartbeats and is
answered through ``/_reply`` on the port's driver and a port worker on
the JAX driver, forwarding across packages, with equal ``/routing`` and
``/workers`` bodies from both drivers; and port decoders on the CPU
behind ``adopt_handler`` / ``session_exporter`` give the JAX decoder's
uninterrupted tokens after a warm drain and a cold kill. The chaos drill
reruns under the lock sanitizer with no cycle, and
``python -m mmlspark_tpu_torch.serving`` starts a driver and a worker.
Every wait has a deadline.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu.serving.continuous import ContinuousDecoder as RefDecoder
from mmlspark_tpu_torch.models.zoo import transformer as port_tf
from mmlspark_tpu_torch.observability import reset_all
from mmlspark_tpu_torch.observability.federation import (
    FEDERATION_INTERVAL_ENV, worker_snapshot)
from mmlspark_tpu_torch.observability.ledger import reset_ledger
from mmlspark_tpu_torch.observability.slo import reset_tracker
from mmlspark_tpu_torch.observability.timeseries import (INTERVAL_ENV,
                                                       reset_alert_engine)
from mmlspark_tpu_torch.observability.timeseries import \
    reset_store as reset_ts_store
from mmlspark_tpu_torch.observability.watchdog import reset_watchdog
from mmlspark_tpu_torch.parallel.distributed import (coordinator_rendezvous,
                                                     find_open_port)
from mmlspark_tpu_torch.reliability import get_injector, reset_breakers
from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
from mmlspark_tpu_torch.serving.distributed import (DistributedWorker,
                                                    DriverRegistry,
                                                    ServingCluster)
from mmlspark_tpu_torch.serving.journal import ServingJournal
from mmlspark_tpu_torch.serving.kv_pool import AFFINITY_HEADER, PagedKVPool
from mmlspark_tpu_torch.serving.registry import (ModelRegistry, get_registry,
                                                 reset_registry, set_registry)

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

ROOT = Path(__file__).resolve().parents[1]


def _reset_plane():
    reset_ts_store()
    reset_alert_engine()
    reset_registry()
    reset_ledger()
    reset_tracker()
    reset_watchdog()
    reset_breakers()
    reset_all()
    get_injector().clear()


@pytest.fixture(autouse=True)
def _clean_slate():
    """Every test starts and ends with no breaker open, no fault armed,
    no alert firing and empty metrics: any of them would leave a later
    test's ``/healthz`` degraded."""
    _reset_plane()
    yield
    _reset_plane()




def _post(url, payload, headers=None, timeout=20.0):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=hdrs)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read().decode() or "{}")


def _get_json(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _client(url, payload, out, idx):
    try:
        out[idx] = _post(url, payload)
    except Exception as e:  # pragma: no cover - surfaced via assert
        out[idx] = e


def test_registry_register_recover_liveness():
    reg = DriverRegistry(liveness_timeout=0.5)
    try:
        info = reg.register("w0", "http://127.0.0.1:1")
        assert not info["recovered"]
        info2 = reg.register("w0", "http://127.0.0.1:2")  # restart, same id
        assert info2["recovered"]
        assert reg.routing_table()["w0"] == "http://127.0.0.1:2"
        assert info2["generation"] > info["generation"]
        time.sleep(0.6)  # no heartbeat → drops from the routing table
        assert "w0" not in reg.routing_table()
        assert not reg.heartbeat("nobody")
    finally:
        reg.close()


def test_cross_worker_reply_routing():
    """Request parked on worker A; the reply is issued *through worker B*
    (the engine ran on B's host) and must route back over HTTP to A."""
    cluster = ServingCluster(2, reply_timeout=15.0)
    try:
        wa, wb = cluster.workers
        out = [None]
        t = threading.Thread(target=_client,
                             args=(wa.server.address, {"x": 1}, out, 0))
        t.start()
        batch = []
        deadline = time.time() + 10
        while not batch and time.time() < deadline:
            batch = wa.get_batch(4, timeout=0.2)
        assert batch, "request never reached worker A's queue"
        owner_id, cached = batch[0]
        assert owner_id == wa.worker_id
        from mmlspark_tpu_torch.io.http.schema import (EntityData,
                                                 HTTPResponseData,
                                                 StatusLineData)
        resp = HTTPResponseData(
            entity=EntityData.from_string(json.dumps({"answered_by": "B"})),
            status_line=StatusLineData(status_code=200))
        ok = wb.reply(owner_id, cached.request_id, resp)  # remote route
        assert ok
        t.join(timeout=15)
        status, payload = out[0]
        assert status == 200 and payload == {"answered_by": "B"}
    finally:
        cluster.close()


def test_forwarding_round_robin():
    """Worker A has no engine: public requests forward to peers and the
    client still gets the answer through A (load-balancer parity)."""
    cluster = ServingCluster(3, reply_timeout=15.0)
    try:
        wa = cluster.workers[0]
        wa.enable_forwarding()
        for w in cluster.workers:
            w.refresh_peers()

        stop = threading.Event()
        seen_urls = []

        def engine():
            while not stop.is_set():
                for owner, cached in cluster.get_batch(8, timeout=0.05):
                    seen_urls.append((cached.request.url,
                                      cached.request.method))
                    cluster.reply(owner, cached.request_id, _json_resp(
                        {"served": owner}))

        eng = threading.Thread(target=engine, daemon=True)
        eng.start()
        outs = [None, None, None, None]
        threads = [threading.Thread(target=_client,
                                    args=(wa.server.address.rstrip("/")
                                          + f"/score?i={i}", {"i": i},
                                          outs, i))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        stop.set()
        eng.join(timeout=5)
        served = set()
        for o in outs:
            assert isinstance(o, tuple), f"client failed: {o!r}"
            status, payload = o
            assert status == 200
            served.add(payload["served"])
        # A forwards round-robin → both B and C served something
        assert served == {"worker-1", "worker-2"}
        # the client's original path/query and method survive the hop
        assert all(u.startswith("/score?i=") and m == "POST"
                   for u, m in seen_urls), seen_urls
    finally:
        cluster.close()


def _json_resp(payload, status=200):
    from mmlspark_tpu_torch.io.http.schema import (EntityData, HTTPResponseData,
                                             StatusLineData)
    return HTTPResponseData(
        entity=EntityData.from_string(json.dumps(payload)),
        status_line=StatusLineData(status_code=status))


def test_kill_and_replay():
    """An engine takes a batch and dies without replying; after the worker
    re-registers and replays, a second engine answers the SAME parked client
    connection (parity: registerPartition rehydration :489-506)."""
    reg = DriverRegistry()
    try:
        w = DistributedWorker(reg.url, "w0", reply_timeout=20.0)
        out = [None]
        t = threading.Thread(target=_client,
                             args=(w.server.address, {"q": 42}, out, 0))
        t.start()
        batch = []
        deadline = time.time() + 10
        while not batch and time.time() < deadline:
            batch = w.get_batch(4, timeout=0.2)
        assert batch
        # engine 1 crashes here — no reply. Simulate task retry:
        w2_info_recovered = DistributedWorker(reg.url, "w0",
                                              reply_timeout=20.0)
        assert w2_info_recovered.recovered  # driver saw the same worker id
        w2_info_recovered.close(deregister=False)
        n = w.server.replay_unanswered()
        assert n == 1
        batch2 = w.get_batch(4, timeout=1.0)
        assert len(batch2) == 1
        owner, cached = batch2[0]
        assert cached.request_id == batch[0][1].request_id
        assert w.reply(owner, cached.request_id, _json_resp({"ok": True}))
        t.join(timeout=20)
        status, payload = out[0]
        assert status == 200 and payload == {"ok": True}
        w.close()
    finally:
        reg.close()


def test_remote_reply_closes_root_span_exactly_once():
    """The forwarded reply path (engine on B, connection parked on A) must
    end A's root span at the first reply and leave it untouched on a
    late duplicate — a double-close would corrupt the recorded duration
    and re-record the trace in the flight recorder."""
    from mmlspark_tpu_torch.observability import tracing as tr
    cluster = ServingCluster(2, reply_timeout=15.0)
    try:
        wa, wb = cluster.workers
        out = [None]
        t = threading.Thread(target=_client,
                             args=(wa.server.address, {"x": 1}, out, 0))
        t.start()
        batch = []
        deadline = time.time() + 10
        while not batch and time.time() < deadline:
            batch = wa.get_batch(4, timeout=0.2)
        assert batch
        owner_id, cached = batch[0]
        root = wa.server.trace_span(cached.request_id)
        assert root is not None and not root.ended
        assert wb.reply(owner_id, cached.request_id, _json_resp({"n": 1}))
        t.join(timeout=15)
        assert out[0][0] == 200
        assert root.ended
        dur = root.duration
        # duplicate reply: dropped (routing entry gone), span untouched
        assert not wb.reply(owner_id, cached.request_id, _json_resp({"n": 2}))
        assert root.duration == dur
        assert tr.get_flight_recorder().get(root.trace_id) is not None
    finally:
        cluster.close()


def test_request_counted_on_owning_worker_only():
    """One logical request crossing workers bills ONE increment of
    mmlspark_serving_requests_total: the /_reply (and /_forward) internal
    hops are skipped, so per-worker counters still sum to true traffic."""
    from mmlspark_tpu_torch import observability as obs
    obs.reset_all()
    cluster = ServingCluster(2, reply_timeout=15.0)
    try:
        wa, wb = cluster.workers
        out = [None]
        t = threading.Thread(target=_client,
                             args=(wa.server.address, {"x": 1}, out, 0))
        t.start()
        batch = []
        deadline = time.time() + 10
        while not batch and time.time() < deadline:
            batch = wa.get_batch(4, timeout=0.2)
        assert batch
        owner_id, cached = batch[0]
        assert wb.reply(owner_id, cached.request_id, _json_resp({"ok": 1}))
        t.join(timeout=15)
        assert out[0][0] == 200
        snap = obs.snapshot()
        series = snap["mmlspark_serving_requests_total"]["series"]
        total = sum(s["value"] for s in series)
        assert total == 1, series          # the /_reply hop is not billed
    finally:
        cluster.close()
        obs.reset_all()


# ---------------------------------------------------------------------------
# reliability layer (PR 5): chaos, failover, deadlines, heartbeat visibility


def _reliability_sandbox():
    """Fresh metrics/breakers/faults for tests that assert on them."""
    from mmlspark_tpu_torch import observability as obs
    from mmlspark_tpu_torch.reliability import get_injector, reset_breakers
    obs.reset_all()
    reset_breakers()
    get_injector().clear()


def test_cluster_reply_skips_closed_workers():
    """Satellite fix: an unknown owner must be routed through the first
    OPEN worker — the old hardcoded workers[0] fallback dead-ends when
    that worker happens to be the closed one."""
    _reliability_sandbox()
    cluster = ServingCluster(3, reply_timeout=15.0)
    try:
        w0, w1, w2 = cluster.workers
        out = [None]
        t = threading.Thread(target=_client,
                             args=(w2.server.address, {"q": 1}, out, 0))
        t.start()
        batch = []
        deadline = time.time() + 10
        while not batch and time.time() < deadline:
            batch = w2.get_batch(4, timeout=0.2)
        assert batch
        owner, cached = batch[0]
        # registry drift: the cluster record of worker-2 is gone, and the
        # old fallback (workers[0]) is closed
        cluster.workers.remove(w2)
        w0.close(deregister=False)
        ok = cluster.reply(owner, cached.request_id,
                           _json_resp({"via": "fallback"}))
        assert ok, "reply must route via the first open worker (w1)"
        t.join(timeout=15)
        status, payload = out[0]
        assert status == 200 and payload == {"via": "fallback"}
        w2.close()
    finally:
        cluster.close()


def test_cluster_reply_all_closed_returns_false():
    _reliability_sandbox()
    cluster = ServingCluster(2, reply_timeout=5.0)
    try:
        for w in cluster.workers:
            w.close(deregister=False)
        assert cluster.reply("ghost", "nope", _json_resp({})) is False
    finally:
        cluster.close()


def test_heartbeat_reregister_failure_is_visible():
    """Satellite fix: the heartbeat loop used to swallow re-register
    failures with a bare except/pass — now it retries under RetryPolicy
    and, once exhausted, bumps mmlspark_heartbeat_failures_total."""
    from mmlspark_tpu_torch import observability as obs

    def _failures():
        snap = obs.snapshot().get("mmlspark_heartbeat_failures_total", {})
        return sum(s["value"] for s in snap.get("series", []))

    _reliability_sandbox()
    reg = DriverRegistry()
    w = DistributedWorker(reg.url, "w0", heartbeat_interval=0.05)
    try:
        before = _failures()
        reg.close()  # driver gone: heartbeat fails → re-register fails
        deadline = time.time() + 15
        while _failures() <= before and time.time() < deadline:
            time.sleep(0.05)
        assert _failures() > before, "exhausted re-register never surfaced"
    finally:
        w.close(deregister=False)


def test_forward_fails_over_and_opens_circuit():
    """A forwarding worker must fail over past a dead peer (no 502 while
    another peer can answer) and, after enough failures, skip it via an
    OPEN circuit without re-dialing."""
    from mmlspark_tpu_torch.reliability import breaker_for
    _reliability_sandbox()
    cluster = ServingCluster(3, reply_timeout=15.0)
    try:
        wa, wb, wc = cluster.workers
        wa.enable_forwarding()
        dead_addr = wb.advertised_address
        wb.close(deregister=False)  # crash: still in wa's peer table

        def engine():
            deadline = time.time() + 20
            answered = 0
            while answered < 6 and time.time() < deadline:
                for owner, cached in wc.get_batch(8, timeout=0.1):
                    wc.reply(owner, cached.request_id,
                             _json_resp({"served": "worker-2"}))
                    answered += 1

        eng = threading.Thread(target=engine, daemon=True)
        eng.start()
        outs = [None] * 6
        for i in range(6):
            wa._rr = 0  # always try the dead peer (worker-1) first
            _client(wa.server.address, {"i": i}, outs, i)
        eng.join(timeout=20)
        for o in outs:
            assert isinstance(o, tuple), f"client failed: {o!r}"
            status, payload = o
            assert status == 200 and payload == {"served": "worker-2"}
        # five consecutive dial failures opened worker-1's circuit
        assert breaker_for(dead_addr).state == "open"
    finally:
        cluster.close()


def test_forwarded_request_honors_propagated_deadline():
    """X-Mmlspark-Deadline must cap the wait on the peer that parks the
    forwarded request — nobody waits out the 15s reply_timeout."""
    _reliability_sandbox()
    cluster = ServingCluster(2, reply_timeout=15.0)
    try:
        wa, wb = cluster.workers
        wa.enable_forwarding()   # no engine draining: parked until budget
        req = urllib.request.Request(
            wa.server.address, data=json.dumps({"q": 1}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Mmlspark-Deadline": "0.5"})
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=12.0) as r:
                status = r.status
        except urllib.error.HTTPError as e:
            status = e.code
        elapsed = time.monotonic() - t0
        assert status == 504
        assert elapsed < 8.0, f"deadline not propagated ({elapsed:.1f}s)"
    finally:
        cluster.close()


def test_chaos_faults_and_worker_restart_complete_every_request():
    """Acceptance chaos drill: 200 requests over a 3-worker cluster while
    the injector drops 30% of peer_http hops and worker-1 is killed and
    re-registered mid-run. Every request must RESOLVE (200 normally, 504
    for requests orphaned by the kill, 429 if shed) — zero client hangs —
    and /metrics must show nonzero retry and breaker-transition counters."""
    import re as _re
    from mmlspark_tpu_torch import observability as obs
    from mmlspark_tpu_torch.reliability import (RetryPolicy, breaker_for,
                                          get_injector)
    from mmlspark_tpu_torch.serving.distributed import _http_json

    _reliability_sandbox()
    cluster = ServingCluster(3, reply_timeout=6.0)
    stop = threading.Event()
    injector = get_injector()
    try:
        # engine: drain everywhere, reply THROUGH a non-owner worker so
        # every answer crosses a faultable peer_http hop; a hop the faults
        # ate falls back to the cluster aggregate (open-worker routing)
        def engine():
            while not stop.is_set():
                for owner, cached in cluster.get_batch(64, timeout=0.05):
                    body = json.loads(cached.request.entity.content
                                      if cached.request.entity else b"{}")
                    resp = _json_resp({"n": body.get("n")})
                    sender = next(
                        (w for w in cluster.workers
                         if w.worker_id != owner and not w.server.closed),
                        None)
                    ok = (sender.reply(owner, cached.request_id, resp)
                          if sender is not None else False)
                    if not ok:
                        cluster.reply(owner, cached.request_id, resp)

        eng = threading.Thread(target=engine, daemon=True)
        eng.start()
        injector.add("peer_http", "error", p=0.3, seed=42)

        n_clients, per_client = 8, 25
        results = [[None] * per_client for _ in range(n_clients)]
        done = threading.Semaphore(0)

        def client(tid):
            for i in range(per_client):
                target = cluster.workers[(tid + i) % len(cluster.workers)]
                url = target.server.address
                status = None
                for _ in range(5):   # ride out the restart window
                    try:
                        status, _ = _post(url, {"n": tid * 100 + i},
                                          timeout=20.0)
                        break
                    except urllib.error.HTTPError as e:
                        status = e.code
                        break
                    except Exception:
                        time.sleep(0.2)
                        url = cluster.workers[
                            (tid + i) % len(cluster.workers)].server.address
                results[tid][i] = status
                done.release()

        threads = [threading.Thread(target=client, args=(tid,), daemon=True)
                   for tid in range(n_clients)]
        for t in threads:
            t.start()
        # kill worker-1 ungracefully mid-run and bring it back same-id
        for _ in range(60):
            done.acquire()
        old_addr = cluster.worker("worker-1").advertised_address
        cluster.restart_worker("worker-1")
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "client hang"

        statuses = [s for row in results for s in row]
        assert len(statuses) == n_clients * per_client
        assert all(s in (200, 429, 504) for s in statuses), (
            sorted({s for s in statuses if s not in (200, 429, 504)}))
        assert statuses.count(200) >= 150, statuses.count(200)

        # deterministically exercise the breaker against the dead
        # incarnation's address (stale-route shape): refused dials push the
        # sliding window past the failure ratio — it may already hold
        # successes from replies routed there before the kill
        injector.clear()
        brk = breaker_for(old_addr)
        one_shot = RetryPolicy(max_attempts=1)
        for _ in range(25):
            if brk.state == "open":
                break
            try:
                _http_json(old_addr + "/_reply",
                           {"request_id": "stale", "response": {}},
                           timeout=1.0, retry=one_shot, breaker=brk)
            except Exception:
                pass
        assert brk.state == "open"

        snap = obs.snapshot()

        def total(name):
            return sum(s["value"]
                       for s in snap.get(name, {}).get("series", []))

        assert total("mmlspark_retry_attempts_total") > 0
        assert total("mmlspark_faults_injected_total") > 0
        assert total("mmlspark_breaker_transitions_total") > 0
        # and the same series are visible on the wire at /metrics
        live = next(w for w in cluster.workers if not w.server.closed)
        with urllib.request.urlopen(live.server.address + "metrics",
                                    timeout=5) as r:
            text = r.read().decode()
        for name in ("mmlspark_retry_attempts_total",
                     "mmlspark_breaker_transitions_total"):
            values = [float(m.group(1)) for m in _re.finditer(
                _re.escape(name) + r"\{[^}]*\} ([0-9.e+-]+)", text)]
            assert sum(values) > 0, f"{name} not on /metrics"
    finally:
        injector.clear()
        stop.set()
        cluster.close()


# ---------------------------------------------------------------------------
# the reference's tests/test_session_failover.py

WIDTHS = dict(vocab=128, layers=2, d_model=64, heads=4, d_ff=128,
              max_len=64, causal=True, norm="rmsnorm", position="rope")
REF_CFG = ref_tf.TransformerConfig(dtype=jnp.float32, **WIDTHS)
CFG = port_tf.TransformerConfig(dtype=torch.float32, **WIDTHS)


@pytest.fixture(scope="module")
def params():
    return ref_tf.init_transformer(REF_CFG, seed=0)


class TestJournalSessions:
    def test_session_round_trip(self, tmp_path):
        path = str(tmp_path / "w.journal")
        j = ServingJournal(path, fsync=False)
        j.record_session("s1", [5, 6, 7], {"max_new": 8, "temperature": 0.0,
                                           "seed": 3}, phash="abc")
        j.record_session_tokens("s1", [10])
        j.record_session_tokens("s1", [11, 12])
        j.record_session("s2", [1], {"max_new": 4})
        j.record_session_end("s2")
        j.close()
        got = ServingJournal.scan_sessions(path)
        # s2 completed (sess_end) so only s1 is live
        assert set(got) == {"s1"}
        assert got["s1"]["prompt"] == [5, 6, 7]
        assert got["s1"]["params"]["max_new"] == 8
        assert got["s1"]["phash"] == "abc"
        assert got["s1"]["emitted"] == [10, 11, 12]

    def test_torn_tail_keeps_prefix(self, tmp_path):
        """A crash mid-append leaves a half-written last line; every record
        before it must still scan."""
        path = str(tmp_path / "w.journal")
        j = ServingJournal(path, fsync=False)
        j.record_session("s1", [2], {"max_new": 6})
        j.record_session_tokens("s1", [20, 21])
        j.close()
        with open(path, "a") as fh:
            fh.write('{"t": "tail", "sid": "s1", "toks": [99')  # torn
        got = ServingJournal.scan_sessions(path)
        assert got["s1"]["emitted"] == [20, 21]
        # reopening repairs the tear so later appends stay parseable
        j2 = ServingJournal(path, fsync=False)
        j2.record_session_tokens("s1", [22])
        j2.close()
        assert ServingJournal.scan_sessions(path)["s1"]["emitted"] == \
            [20, 21, 22]

    def test_compaction_merges_tails(self, tmp_path):
        path = str(tmp_path / "w.journal")
        j = ServingJournal(path, fsync=False)
        j.record_session("s1", [3], {"max_new": 600})
        for k in range(400):
            j.record_session_tokens("s1", [k])
        assert j.maybe_compact(epoch=0, min_lines=64)
        # one sess + one merged tail, nothing lost
        with open(path) as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
        kinds = [r["t"] for r in recs if r["t"] in ("sess", "tail")]
        assert kinds == ["sess", "tail"]
        j.close()
        assert ServingJournal.scan_sessions(path)["s1"]["emitted"] == \
            list(range(400))

    def test_replay_sessions_counts_metric(self, tmp_path):
        path = str(tmp_path / "w.journal")
        j = ServingJournal(path, fsync=False)
        j.record_session("s1", [4], {"max_new": 2})
        j.record_session_tokens("s1", [7])
        j.close()
        j2 = ServingJournal(path, fsync=False)
        live = j2.replay_sessions()
        assert live["s1"]["emitted"] == [7]
        d = j2.digest()
        assert d["live_sessions"] == 1 and not d["closed"]
        j2.close()
        assert j2.closed


def _fill(pool, pages, seed):
    """Recognizable content in the given pages: values and, on a
    quantized pool, the scale pools."""
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(pages)
    for c in pool.buffers:
        for buf in c.values():
            fill = torch.from_numpy(rng.standard_normal(
                (len(pages),) + tuple(buf.shape[1:])).astype(np.float32))
            if buf.dtype == torch.int8:
                fill = (fill * 40).round().clamp(-127, 127)
            buf.view(torch.uint8)[idx] = fill.to(buf.dtype).view(torch.uint8)


class TestPageExportAdopt:
    @pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
    def test_blob_round_trip_is_bitwise(self, kv_dtype):
        src = PagedKVPool(CFG, num_pages=8, page_size=4, kv_dtype=kv_dtype,
                          device="cpu")
        dst = PagedKVPool(CFG, num_pages=8, page_size=4, kv_dtype=kv_dtype,
                          device="cpu")
        pages = src.alloc(3)
        _fill(src, pages, 0)
        blob = src.export_session(pages, length=10)
        assert blob["length"] == 10 and blob["n_pages"] == 3
        assert blob["kv_dtype"] == src.kv_dtype
        got = dst.adopt_session(blob)
        assert len(got) == 3
        for sc, dc in zip(src.buffers, dst.buffers):
            for key in sc:
                a = sc[key].view(torch.uint8)[torch.as_tensor(pages)]
                b = dc[key].view(torch.uint8)[torch.as_tensor(got)]
                assert a.numpy().tobytes() == b.numpy().tobytes(), key
        assert src.stats["sessions_exported"] == 1
        assert dst.stats["sessions_adopted"] == 1

    def test_adopt_rejects_layout_mismatch(self):
        src = PagedKVPool(CFG, num_pages=4, page_size=4, device="cpu")
        dst = PagedKVPool(CFG, num_pages=4, page_size=8, device="cpu")
        blob = src.export_session(src.alloc(1), length=2)
        with pytest.raises(ValueError, match="layout mismatch"):
            dst.adopt_session(blob)

    def test_adopt_quant_mode_must_agree(self):
        src = PagedKVPool(CFG, num_pages=4, page_size=4, kv_dtype="int8",
                          device="cpu")
        dst = PagedKVPool(CFG, num_pages=4, page_size=4, device="cpu")
        blob = src.export_session(src.alloc(2), length=5)
        with pytest.raises(ValueError, match="layout mismatch"):
            dst.adopt_session(blob)


def _finish(eng, req, max_steps=400):
    for _ in range(max_steps):
        if req.done:
            break
        eng.step()
    assert req.done
    return eng.session_result(req)


def _engine(params, **kw):
    return ContinuousDecoder(params, CFG, device="cpu", max_slots=2,
                             max_len=64, **kw)


_WANT = {}


def _ref_tokens(params, prompt, max_new):
    """The JAX engine's uninterrupted greedy tokens (cached per case)."""
    key = (tuple(int(t) for t in prompt), max_new)
    if key not in _WANT:
        eng = RefDecoder(params, REF_CFG, max_slots=2, max_len=64)
        _WANT[key] = _finish(eng, eng.submit(prompt, max_new))
    return _WANT[key]


class TestDecoderFailover:
    def test_cold_restore_matches_uninterrupted(self, params, tmp_path):
        """Kill mid-decode: the survivor re-prefills from the journal alone
        and the full session is the JAX engine's uninterrupted run."""
        prompt = np.arange(5, 12, dtype=np.int32)
        want = _ref_tokens(params, prompt, 12)
        jpath = str(tmp_path / "a.journal")
        ja = ServingJournal(jpath, fsync=False)
        ea = _engine(params, journal=ja)
        ra = ea.submit(prompt, 12, session_id="sess-X")
        for _ in range(5):
            ea.step()
        assert ra.tokens and not ra.done   # genuinely mid-decode
        ja.close()                         # SIGKILL: journal is all that's left
        sessions = ServingJournal.scan_sessions(jpath)
        sess = dict(sessions["sess-X"], id="sess-X")
        assert sess["emitted"] == ra.tokens[:len(sess["emitted"])]
        eb = _engine(params)
        rb = eb.restore_session(sess)
        assert rb.pre_emitted == sess["emitted"]
        assert _finish(eb, rb) == want

    def test_warm_adopt_zero_reprefill(self, params):
        prompt = np.arange(3, 10, dtype=np.int32)
        want = _ref_tokens(params, prompt, 10)
        ea = _engine(params)
        ra = ea.submit(prompt, 10)
        for _ in range(4):
            ea.step()
        assert ra.tokens and not ra.done
        ckpt = ea.checkpoint_session(ra)
        assert ckpt["kv"] is not None
        assert ckpt["session"]["emitted"] == ra.tokens
        eb = _engine(params)
        rb = eb.restore_session(ckpt["session"], kv_blob=ckpt["kv"])
        assert _finish(eb, rb) == want
        assert eb.stats["prefills"] == 0   # warm: no re-prefilled tokens

    def test_double_failover_round_trips(self, params):
        prompt = np.arange(2, 8, dtype=np.int32)
        want = _ref_tokens(params, prompt, 12)
        ea = _engine(params)
        ra = ea.submit(prompt, 12)
        for _ in range(4):
            ea.step()
        c1 = ea.checkpoint_session(ra)
        eb = _engine(params)
        rb = eb.restore_session(c1["session"], kv_blob=c1["kv"])
        for _ in range(3):
            eb.step()
        c2 = eb.checkpoint_session(rb)
        # canonical: ORIGINAL prompt and budget, merged emitted tail
        assert c2["session"]["prompt"] == [int(t) for t in prompt]
        assert c2["session"]["params"]["max_new"] == 12
        ec = _engine(params)
        rc = ec.restore_session(c2["session"], kv_blob=c2["kv"])
        assert _finish(ec, rc) == want

    def test_spent_session_restores_completed(self, params):
        eng = _engine(params)
        req = eng.restore_session({"id": "done", "prompt": [1, 2],
                                   "params": {"max_new": 3},
                                   "emitted": [4, 5, 6]})
        assert req.done and eng.session_result(req) == [4, 5, 6]


class TestClusterFailover:
    def test_kill_reassigns_journaled_sessions(self, tmp_path):
        from mmlspark_tpu_torch.serving.distributed import ServingCluster
        cluster = ServingCluster(3, reply_timeout=5.0,
                                 journal_dir=str(tmp_path))
        try:
            w1 = cluster.worker("worker-1")
            w1.server._journal.record_session(
                "sess-A", [1, 2, 3], {"max_new": 8, "temperature": 0.0,
                                      "seed": 0})
            w1.server._journal.record_session_tokens("sess-A", [10, 11])
            out = cluster.reassign_sessions("worker-1")
            assert out and out.get("adopted") == 1
            adopter = cluster.worker(out["worker"])
            assert adopter.worker_id != "worker-1"
            entry = adopter.adopted_sessions[0]
            assert entry["session"]["id"] == "sess-A"
            assert entry["session"]["emitted"] == [10, 11]
            assert entry["kv"] is None     # kill path is cold
            # write-ahead on the adopter: a second failure replays from its
            # own journal
            got = adopter.server._journal.replay_sessions()
            assert got["sess-A"]["emitted"] == [10, 11]
        finally:
            cluster.close()

    def test_restart_rehydrates_sessions_from_journal(self, tmp_path):
        from mmlspark_tpu_torch.serving.distributed import ServingCluster
        cluster = ServingCluster(2, reply_timeout=5.0,
                                 journal_dir=str(tmp_path))
        try:
            w1 = cluster.worker("worker-1")
            w1.server._journal.record_session(
                "sess-R", [7], {"max_new": 5, "temperature": 0.0})
            w1.server._journal.record_session_tokens("sess-R", [70])
            cluster.restart_worker("worker-1")
            # the replacement reopened the same journal and rehydrated the
            # live session for its engine to restore cold
            w1b = cluster.worker("worker-1")
            assert w1b.server.replayed_sessions["sess-R"]["emitted"] == [70]
        finally:
            cluster.close()

    def test_drain_ships_warm_blobs(self, tmp_path):
        from mmlspark_tpu_torch.serving.distributed import ServingCluster
        cluster = ServingCluster(2, reply_timeout=5.0,
                                 journal_dir=str(tmp_path))
        try:
            w0 = cluster.worker("worker-0")
            blob = {"v": 1, "n_pages": 1, "length": 4, "data": []}
            w0.session_exporter = lambda: [{
                "session": {"id": "sess-W", "prompt": [9],
                            "params": {"max_new": 6}, "emitted": [3]},
                "kv": blob}]
            out = cluster.drain_worker("worker-0")
            assert out.get("adopted") == 1 and out.get("mode") == "warm"
            w1 = cluster.worker("worker-1")
            assert w1.adopted_sessions[0]["kv"] == blob
            # the drained worker is gone from the cluster AND the routing
            ids = [w.worker_id for w in cluster.workers]
            assert "worker-0" not in ids
            assert "worker-0" not in cluster.driver.routing_table()
        finally:
            cluster.close()

    def test_liveness_sweeper_evicts_dead_worker(self, tmp_path):
        import time
        from mmlspark_tpu_torch.serving.distributed import ServingCluster
        cluster = ServingCluster(2, reply_timeout=5.0,
                                 liveness_interval=0.15,
                                 heartbeat_interval=0.05,
                                 journal_dir=str(tmp_path))
        try:
            assert "worker-1" in cluster.driver.routing_table()
            # stop worker-1's heartbeats without deregistering — a SIGKILL
            # as the driver sees it
            w1 = cluster.worker("worker-1")
            w1._hb_stop.set()
            w1._hb_thread.join(timeout=2.0)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if "worker-1" not in cluster.driver.routing_table():
                    break
                time.sleep(0.05)
            assert "worker-1" not in cluster.driver.routing_table()
            assert "worker-0" in cluster.driver.routing_table()
        finally:
            cluster.close()

    def test_session_drill_survives_worker_restart(self, tmp_path):
        """The decode-kill drill in miniature: live journal-backed decode
        sessions, one owning worker replaced mid-stream, every session
        finishes with the exact deterministic token stream."""
        import time
        from mmlspark_tpu_torch.loadgen import SessionDrill
        from mmlspark_tpu_torch.serving.distributed import ServingCluster
        cluster = ServingCluster(3, reply_timeout=5.0)
        try:
            drill = SessionDrill(cluster, n_sessions=4,
                                 tokens_per_session=30, tick_s=0.02,
                                 journal_dir=str(tmp_path)).start()
            time.sleep(0.2)
            cluster.restart_worker("worker-1")
            card = drill.finish(timeout=15.0)
            assert card["lost"] == 0
            assert card["recovered"] >= 1
            assert card["recovery_p99_ms"] is not None
        finally:
            cluster.close()


# ---------------------------------------------------------------------------
# the reference's tests/test_distributed_rendezvous.py (the control-plane
# bootstrap of the process group)


def test_driver_and_workers_agree_on_coordinator():
    port = find_open_port()
    results = {}

    def worker(i):
        results[i] = coordinator_rendezvous(
            "worker", "127.0.0.1", port, num_workers=3, timeout_s=15)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    coord = coordinator_rendezvous("driver", "127.0.0.1", port,
                                   num_workers=3, timeout_s=15)
    for t in threads:
        t.join(15)
    assert len(results) == 3
    assert set(results.values()) == {coord}
    host, p = coord.rsplit(":", 1)
    assert host == "127.0.0.1" and int(p) > 0


def test_worker_times_out_without_driver():
    with pytest.raises(TimeoutError, match="rendezvous"):
        coordinator_rendezvous("worker", "127.0.0.1", find_open_port(),
                               num_workers=1, timeout_s=1.0)


def test_workers_can_connect_before_driver_listens():
    """Workers retry until the driver's listener appears (task start order
    is arbitrary under gang scheduling)."""
    port = find_open_port()
    results = {}

    def late_worker():
        results["w"] = coordinator_rendezvous(
            "worker", "127.0.0.1", port, num_workers=1, timeout_s=15)

    t = threading.Thread(target=late_worker)
    t.start()
    import time
    time.sleep(0.5)  # worker is already retrying
    coord = coordinator_rendezvous("driver", "127.0.0.1", port,
                                   num_workers=1, timeout_s=15)
    t.join(15)
    assert results["w"] == coord


def test_driver_bind_conflict_surfaces():
    """A raced-away listen port must error in the driver, not strand the
    workers (the serve loop used to swallow EADDRINUSE in a thread)."""
    import socket
    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    try:
        with pytest.raises(OSError):
            coordinator_rendezvous("driver", "127.0.0.1", port,
                                   num_workers=1, timeout_s=2)
    finally:
        blocker.close()


# ---------------------------------------------------------------------------
# the cluster drills of tests/test_federation.py:257,
# tests/test_registry.py:374-386 and tests/test_timeseries.py:458


def test_three_worker_cluster_federation_e2e(monkeypatch):
    """Acceptance drill: requests over a 3-worker cluster under seeded
    enqueue faults plus one restart_worker. /debug/cluster's merged
    requests_total must equal the sum of the per-worker reported counters
    and never decrease; /workers carries live health digests; the
    scorecard sees every request."""
    from mmlspark_tpu_torch.io.http.schema import (EntityData, HTTPResponseData,
                                             StatusLineData)

    monkeypatch.setenv(FEDERATION_INTERVAL_ENV, "0")
    get_injector().configure("enqueue:error:every=5")
    cluster = ServingCluster(3, reply_timeout=15.0)
    stop = threading.Event()
    try:
        def engine():
            while not stop.is_set():
                for owner, cached in cluster.get_batch(16, timeout=0.05):
                    resp = HTTPResponseData(
                        entity=EntityData.from_string(
                            json.dumps({"ok": True})),
                        status_line=StatusLineData(status_code=200))
                    cluster.reply(owner, cached.request_id, resp)

        eng = threading.Thread(target=engine, daemon=True)
        eng.start()

        def drive(n):
            ok = faulted = 0
            for i in range(n):
                w = cluster.workers[i % 3]
                try:
                    status, _ = _post(w.server.address, {"i": i},
                                      headers={"X-Mmlspark-Tenant": "acme"})
                    ok += status == 200
                except urllib.error.HTTPError as e:
                    assert e.code in (500, 503)
                    faulted += 1
            return ok, faulted

        ok1, faulted1 = drive(30)
        assert ok1 and faulted1, "chaos spec must actually bite"
        time.sleep(0.2)          # let post-reply counter bumps land
        for w in cluster.workers:
            assert w.heartbeat()
        url = cluster.driver.url
        view1 = _get_json(url + "/debug/cluster")
        merged1 = _merged_requests(view1["metrics"])
        assert merged1 > 0

        # kill worker-1 ungracefully, bring it back under the same id
        cluster.restart_worker("worker-1")
        ok2, _ = drive(30)
        assert ok2
        time.sleep(0.2)
        for w in cluster.workers:
            assert w.heartbeat()
        view2 = _get_json(url + "/debug/cluster")
        merged2 = _merged_requests(view2["metrics"])
        assert merged2 >= merged1, "merged counter went backwards"

        # each worker heartbeated at the same quiesced instant, so the
        # merged value must equal the sum of the per-worker reported
        # cumulative counters — federation loses nothing
        reported = sum(
            sum(s["value"] for s in
                worker_snapshot()["metrics"]
                ["mmlspark_serving_requests_total"]["series"])
            for _ in cluster.workers)
        assert merged2 == pytest.approx(reported)

        # scorecard saw every accepted request under the tenant class
        card = view2["scorecard"]
        acme = [c for c in card["classes"] if c["tenant"] == "acme"]
        assert acme and acme[0]["total"] >= (ok1 + ok2) * len(
            cluster.workers)
        assert card["workers"] == 3
        assert card["counter_resets"] >= 0

        # /workers: live health digests from the piggybacked heartbeat
        workers = _get_json(url + "/workers")
        assert set(workers) == {"worker-0", "worker-1", "worker-2"}
        for info in workers.values():
            digest = info["digest"]
            assert set(digest) >= {"queue_depth", "in_flight",
                                   "open_breakers", "stall_age_seconds",
                                   "degraded"}
            assert digest["degraded"] is False

        # the in-process twin mirrors the HTTP view
        card2 = cluster.scorecard()
        assert card2["worker_health"].keys() == workers.keys()
        assert card2["snapshots"] >= card["snapshots"]
    finally:
        stop.set()
        get_injector().clear()
        cluster.close()


def _merged_requests(prom_text):
    total = 0.0
    hits = 0
    for line in prom_text.splitlines():
        if line.startswith("mmlspark_serving_requests_total{"):
            total += float(line.rsplit(" ", 1)[1])
            hits += 1
    assert hits, "merged exposition lacks requests_total"
    return total


def test_multi_model_multi_tenant_cluster_chaos_drill():
    """2 models x 2 versions over a 3-worker cluster, tenants weighted
    3/2/1, seeded enqueue faults and a mid-rollout worker restart.
    Asserts: canary auto-rollback fires from real traffic, weighted-fair
    goodput shares track 3/2/1 within 15%, prefix-affine routing beats
    the round-robin baseline on placement hits, shadow pairs join, and
    every request receives a definitive response (zero loss)."""
    from mmlspark_tpu_torch.io.http.schema import (EntityData, HTTPResponseData,
                                             StatusLineData)
    from mmlspark_tpu_torch.serving.distributed import ServingCluster

    set_registry(ModelRegistry(min_requests=5, check_every=10_000))
    registry = get_registry()
    registry.set_tenant("acme", 3)
    registry.set_tenant("beta", 2)
    registry.set_tenant("gamma", 1)
    registry.load("alpha", "v1")
    registry.load("alpha", "v2", canary_percent=50)    # the bad canary
    registry.load("bravo", "v1")
    registry.load("bravo", "v2", canary_percent=0, shadow_percent=100)

    cluster = ServingCluster(3, reply_timeout=20.0)
    stop = threading.Event()
    pause = threading.Event()
    lock = threading.Lock()
    drained = []          # (owner_id, tenant, model_label, body_key)

    def engine():
        while not stop.is_set():
            if pause.is_set():
                time.sleep(0.005)
                continue
            for owner, cached in cluster.get_batch(8, timeout=0.02):
                try:
                    body = json.loads(
                        cached.request.entity.content.decode())
                except Exception:
                    body = {}
                with lock:
                    drained.append((owner, cached.tenant,
                                    cached.model_label, body.get("k")))
                status = 500 if cached.model_label == "alpha@v2" else 200
                cluster.reply(owner, cached.request_id, HTTPResponseData(
                    entity=EntityData.from_string('{"ok": true}'),
                    status_line=StatusLineData(status_code=status)))

    # engine starts PAUSED: phase 1 builds a standing backlog first, so
    # the DRR dequeue order is measured over all three tenants at once
    pause.set()
    eng = threading.Thread(target=engine, daemon=True)
    eng.start()

    attempted = [0]
    answered = [0]

    def post(worker, payload, headers=None):
        attempted[0] += 1
        try:
            status, _ = _post(worker.server.address, payload,
                              headers=headers)
        except urllib.error.HTTPError as e:
            status = e.code
            assert status in (429, 500, 503, 504)
        answered[0] += 1
        return status

    try:
        # ---- phase 1: weighted-fair goodput under a standing backlog ----
        statuses = []

        def park(tenant, idx):
            # stagger connects: 36 simultaneous SYNs overflow the HTTP
            # server's small accept backlog; a reset connection was never
            # parked, so retrying it is safe
            time.sleep(idx * 0.01)
            for attempt in range(3):
                try:
                    statuses.append(post(cluster.workers[0], {"x": 1},
                                         headers={"X-Mmlspark-Tenant":
                                                  tenant}))
                    return
                except (ConnectionResetError, urllib.error.URLError):
                    attempted[0] -= 1
                    time.sleep(0.2 * (attempt + 1))
            raise AssertionError(f"park({tenant}) never connected")

        threads = [threading.Thread(target=park, args=(t, i), daemon=True)
                   for i, t in enumerate(
                       t for t in ("acme", "beta", "gamma")
                       for _ in range(12))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 15.0
        while cluster.workers[0].server._queue.qsize() < 36 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cluster.workers[0].server._queue.qsize() == 36
        pause.clear()
        for t in threads:
            t.join(timeout=20.0)
        assert statuses.count(200) == 36
        # while all three tenants stayed backlogged (first 24 dequeues:
        # 4 full DRR rounds of 3+2+1), shares track weights
        first24 = [t for _, t, _, _ in drained[:24]]
        for tenant, want in (("acme", 0.5), ("beta", 1 / 3),
                             ("gamma", 1 / 6)):
            share = first24.count(tenant) / 24
            assert abs(share - want) / want <= 0.15, \
                f"{tenant}: {share} vs {want}"

        # ---- phase 2: prefix-affine routing vs round-robin baseline ----
        with lock:
            drained.clear()
        fwd = cluster.workers[0]
        fwd.enable_forwarding()
        keys = [f"{k:016x}" for k in range(8)]
        for rep in range(4):
            for k in keys:
                post(fwd, {"k": k}, headers={AFFINITY_HEADER: k})
        # pseudo-key group size 3 is coprime with the 2-peer round-robin
        # rotation, so unkeyed placement genuinely alternates per "key"
        for i in range(16):
            post(fwd, {"k": f"rr-{i % 3}"})
        fwd.disable_forwarding()
        deadline = time.monotonic() + 10.0
        while len(drained) < 48 and time.monotonic() < deadline:
            time.sleep(0.01)

        def modal_hit_rate(rows):
            by_key = {}
            for owner, _, _, k in rows:
                by_key.setdefault(k, []).append(owner)
            rates = [max(owners.count(o) for o in set(owners))
                     / len(owners) for owners in by_key.values()]
            return sum(rates) / len(rates)

        with lock:
            affine = [r for r in drained if r[3] in keys]
            baseline = [r for r in drained
                        if r[3] and r[3].startswith("rr-")]
        assert len(affine) == 32 and len(baseline) == 16
        # a prefix-keyed request lands on its ring owner every time; the
        # unkeyed baseline round-robins across both serving peers
        assert modal_hit_rate(affine) > modal_hit_rate(baseline)
        assert modal_hit_rate(affine) == 1.0
        # worker-0 forwards only to its 2 peers (never itself)
        assert {r[0] for r in affine} <= {"worker-1", "worker-2"}

        # ---- phase 3: canary rollout under chaos + worker restart ----
        get_injector().configure("enqueue:error:every=5")
        canary_statuses = []
        for i in range(24):
            canary_statuses.append(
                post(cluster.workers[i % 3], {"i": i},
                     headers={"X-Mmlspark-Model": "alpha",
                              "X-Mmlspark-Tenant": "acme"}))
        # mid-rollout chaos: worker-1 dies ungracefully and comes back
        cluster.restart_worker("worker-1")
        for w in cluster.workers:
            assert len(w._ring) == 2    # ring rebuilt, peers only
        for i in range(24):
            canary_statuses.append(
                post(cluster.workers[i % 3], {"i": i},
                     headers={"X-Mmlspark-Model": "alpha"}))
        assert canary_statuses.count(500) > 0, "chaos/canary must bite"
        # shadow traffic on bravo: incumbent serves, candidate mirrors
        for i in range(8):
            post(cluster.workers[i % 3], {"i": i},
                 headers={"X-Mmlspark-Model": "bravo"})
        time.sleep(0.2)

        # heartbeats run the canary check off the request path AND carry
        # the registry digest to the driver
        for w in cluster.workers:
            assert w.heartbeat()
        states = {v.version: v.state for v in registry.versions("alpha")}
        assert states["v2"] == "retired", "canary auto-rollback must fire"
        assert states["v1"] == "live"
        snap = registry.snapshot()
        assert snap["rollbacks"] and \
            snap["rollbacks"][-1]["reason"] != "manual"
        # shadow pairs joined; identical replies diff as "match"
        diffs = registry.shadow_diffs()
        assert diffs and all(d["verdict"] == "match" for d in diffs)
        # registry state federated: the driver sees every worker's digest
        for info in cluster.driver.workers().values():
            models = info["digest"]["registry"]["models"]
            assert models["alpha"]["live"] == "v1"
            assert models["alpha"]["canary"] is None   # rolled back
            assert models["bravo"]["canary"] == "v2"

        # ---- zero request loss ----
        assert answered[0] == attempted[0]
    finally:
        stop.set()
        get_injector().clear()
        eng.join(timeout=5.0)
        cluster.close()


def test_cluster_sampler_series_survive_worker_restart(monkeypatch):
    from mmlspark_tpu_torch.serving.distributed import ServingCluster
    monkeypatch.setenv(FEDERATION_INTERVAL_ENV, "0")
    monkeypatch.setenv(INTERVAL_ENV, "0")
    cluster = ServingCluster(2, reply_timeout=5.0)
    try:
        for w in cluster.workers:
            assert w.heartbeat()
        ts = cluster.driver.timeseries
        keys = dict(ts.store.series_keys())
        assert "cluster_queue_depth" in keys
        assert "cluster_in_flight" in keys
        before = ts.store.latest("cluster_queue_depth",
                                 {"worker": "worker-0"})
        assert before is not None
        n_series = len(ts.store.series_keys())
        # ungraceful restart: same id, fresh process-side state
        replacement = cluster.restart_worker("worker-0")
        assert replacement.heartbeat()
        after = ts.store.latest("cluster_queue_depth",
                                {"worker": "worker-0"})
        assert after is not None and after[0] > before[0]
        # keyed by worker id: the restarted worker CONTINUED its series
        assert len(ts.store.series_keys()) == n_series
        view = cluster.driver.cluster_view()
        names = {s["name"] for s in view["timeseries"]["series"]}
        assert "cluster_queue_depth" in names
    finally:
        cluster.close()



# ---------------------------------------------------------------------------
# parity with the JAX package: breakers


def test_breaker_states_match_the_reference():
    """One seeded sequence of allow / success / failure / clock ticks
    over two breakers from each package's ``breaker_for``, under one fake
    clock: the same states after every step and the same
    ``open_breakers()``."""
    from mmlspark_tpu.reliability import breaker as ref_breaker
    from mmlspark_tpu_torch.reliability import breaker as port_breaker
    rng = random.Random(29)
    ops = []
    for _ in range(600):
        r = rng.random()
        ops.append(("tick", rng.choice((0.1, 0.4, 1.2))) if r < 0.2 else
                   ("allow",) if r < 0.45 else
                   ("ok",) if r < 0.7 else ("fail",))

    def run(mod):
        mod.reset_breakers()
        now = [0.0]
        a = mod.breaker_for("peer-a", window=6, min_calls=3,
                            failure_ratio=0.5, open_seconds=1.0,
                            clock=lambda: now[0])
        b = mod.breaker_for("peer-b", window=4, min_calls=2,
                            failure_ratio=0.5, open_seconds=2.0,
                            clock=lambda: now[0])
        trace = []
        for k, op in enumerate(ops):
            brk = a if k % 3 else b
            out = None
            if op[0] == "tick":
                now[0] += op[1]
            elif op[0] == "allow":
                out = brk.allow()
            elif op[0] == "ok":
                brk.record_success()
            else:
                brk.record_failure()
            trace.append((out, a.state, b.state, tuple(mod.open_breakers())))
        mod.reset_breakers()
        return trace

    got, want = run(port_breaker), run(ref_breaker)
    assert got == want
    states = {s for _, sa, sb, _ in got for s in (sa, sb)}
    assert states == {"closed", "open", "half_open"}
    assert any(peers for *_, peers in got)


def test_open_breakers_degrade_healthz_and_the_digest():
    from mmlspark_tpu_torch.reliability import breaker_for
    from mmlspark_tpu_torch.serving.server import WorkerServer
    ws = WorkerServer()
    try:
        health = _get_json(ws.address + "healthz")
        assert health["status"] == "ok", health["reasons"]
        brk = breaker_for("http://127.0.0.1:9", min_calls=1)
        brk.record_failure()
        health = _get_json(ws.address + "healthz")
        assert health["status"] == "degraded"
        assert "breaker_open:http://127.0.0.1:9" in health["reasons"]
        assert ws.health_digest()["open_breakers"] == ["http://127.0.0.1:9"]
    finally:
        ws.close()


@pytest.mark.parametrize("transport", ["threaded", "async"])
def test_large_adopt_body_is_read_whole_on_both_transports(transport):
    """A drain POSTs every session's page blob in one JSON body (a
    quarter of a GB at full width): both transports read it whole, and
    ``_http_json`` (the plane's client, with its 10 s budget) gets the
    handler's answer."""
    import zlib
    from mmlspark_tpu_torch.serving.distributed import _http_json
    from mmlspark_tpu_torch.serving.server import WorkerServer
    ws = WorkerServer(transport=transport)
    try:
        def adopt(req):
            body = json.loads(req.entity.content)
            return _json_resp({"n": len(body["blob"]),
                               "crc": zlib.crc32(body["blob"].encode())})
        ws.control_routes["/_adopt"] = adopt
        blob = np.random.default_rng(0).bytes(8 << 20).hex()
        out = _http_json(ws.address.rstrip("/") + "/_adopt", {"blob": blob})
        assert out == {"n": len(blob), "crc": zlib.crc32(blob.encode())}
    finally:
        ws.close()


# ---------------------------------------------------------------------------
# parity with the JAX package: the wire


def _wait_batch(worker, deadline_s=10.0):
    batch = []
    deadline = time.time() + deadline_s
    while not batch and time.time() < deadline:
        batch = worker.get_batch(4, timeout=0.2)
    assert batch, f"request never reached {worker.worker_id}'s queue"
    return batch[0]


def _ref_resp(payload):
    from mmlspark_tpu.io.http.schema import (EntityData, HTTPResponseData,
                                             StatusLineData)
    return HTTPResponseData(
        entity=EntityData.from_string(json.dumps(payload)),
        status_line=StatusLineData(status_code=200))


def _ask(url, payload):
    out = [None]
    t = threading.Thread(target=_client, args=(url, payload, out, 0))
    t.start()
    return t, out


def test_wire_jax_worker_on_the_ports_driver(monkeypatch):
    """A JAX worker and a port worker register and heartbeat with the
    port's driver; a request parked on either is answered through the
    other's ``/_reply`` hop; the driver federates both."""
    from mmlspark_tpu.serving.distributed import DistributedWorker as RefWorker
    monkeypatch.setenv(FEDERATION_INTERVAL_ENV, "0")
    reg = DriverRegistry()
    workers = []
    try:
        jw = RefWorker(reg.url, "jax-0", reply_timeout=15.0)
        workers.append(jw)
        pw = DistributedWorker(reg.url, "port-0", reply_timeout=15.0)
        workers.append(pw)
        for w in workers:
            w.refresh_peers()
            assert w.heartbeat()
        assert _get_json(reg.url + "/routing") == {
            "jax-0": jw.advertised_address, "port-0": pw.advertised_address}
        table = _get_json(reg.url + "/workers")
        assert set(table) == {"jax-0", "port-0"}
        for info in table.values():
            assert info["state"] == "alive"
            assert set(info["digest"]) >= {"queue_depth", "in_flight",
                                           "open_breakers", "degraded"}
        t, out = _ask(jw.server.address, {"x": 1})
        owner, cached = _wait_batch(jw)
        assert owner == "jax-0"
        assert pw.reply(owner, cached.request_id,
                        _json_resp({"answered_by": "port"}))
        t.join(timeout=15)
        assert out[0] == (200, {"answered_by": "port"})
        t, out = _ask(pw.server.address, {"x": 2})
        owner, cached = _wait_batch(pw)
        assert owner == "port-0"
        assert jw.reply(owner, cached.request_id,
                        _ref_resp({"answered_by": "jax"}))
        t.join(timeout=15)
        assert out[0] == (200, {"answered_by": "jax"})
        for w in workers:
            assert w.heartbeat()
        assert reg.cluster_view()["scorecard"]["workers"] == 2
    finally:
        for w in workers:
            w.close()
        reg.close()


def test_wire_port_worker_on_the_jax_driver_forwards_across_packages():
    """A port worker on the JAX driver: with no engine it forwards a
    public request to the JAX worker (path, query and method kept), and
    the JAX worker forwards to it the other way."""
    from mmlspark_tpu.serving.distributed import (
        DistributedWorker as RefWorker, DriverRegistry as RefRegistry)
    reg = RefRegistry()
    workers = []
    try:
        pw = DistributedWorker(reg.url, "port-0", reply_timeout=15.0)
        workers.append(pw)
        jw = RefWorker(reg.url, "jax-0", reply_timeout=15.0)
        workers.append(jw)
        for w in workers:
            w.refresh_peers()
            assert w.heartbeat()
        assert set(reg.routing_table()) == {"port-0", "jax-0"}
        pw.enable_forwarding()
        t, out = _ask(pw.server.address.rstrip("/") + "/score?i=1", {"i": 1})
        owner, cached = _wait_batch(jw)
        assert owner == "jax-0"
        assert (cached.request.url, cached.request.method) == \
            ("/score?i=1", "POST")
        assert jw.reply(owner, cached.request_id, _ref_resp({"by": "jax"}))
        t.join(timeout=15)
        assert out[0] == (200, {"by": "jax"})
        pw.disable_forwarding()
        jw.enable_forwarding()
        t, out = _ask(jw.server.address.rstrip("/") + "/score?i=2", {"i": 2})
        owner, cached = _wait_batch(pw)
        assert owner == "port-0"
        assert (cached.request.url, cached.request.method) == \
            ("/score?i=2", "POST")
        assert pw.reply(owner, cached.request_id, _json_resp({"by": "port"}))
        t.join(timeout=15)
        assert out[0] == (200, {"by": "port"})
    finally:
        for w in workers:
            w.close()
        reg.close()


def test_both_drivers_serve_equal_routing_and_workers_bodies():
    """The same registrations, heartbeats and departures on both drivers:
    equal ``/register`` answers, ``/heartbeat`` codes, ``/routing`` and
    ``/workers`` bodies (the seconds since the last heartbeat aside)."""
    from mmlspark_tpu.serving.distributed import DriverRegistry as RefRegistry
    regs = [DriverRegistry(), RefRegistry()]
    try:
        seen = []
        for reg in regs:
            log = []
            for wid, port in (("w0", 1), ("w1", 2), ("w2", 3), ("w0", 4)):
                log.append(_post(reg.url + "/register",
                                 {"worker_id": wid,
                                  "address": f"http://127.0.0.1:{port}"}))
            log.append(_post(reg.url + "/heartbeat", {
                "worker_id": "w1", "digest": {"queue_depth": 2,
                                              "in_flight": 1,
                                              "open_breakers": [],
                                              "degraded": False}}))
            log.append(_post(reg.url + "/deregister", {"worker_id": "w2"}))
            try:
                _post(reg.url + "/heartbeat", {"worker_id": "w2"})
            except urllib.error.HTTPError as e:
                log.append((e.code, json.loads(e.read().decode())))
            routing = _get_json(reg.url + "/routing")
            table = _get_json(reg.url + "/workers")
            for info in table.values():
                assert 0.0 <= info.pop("last_seen_age") < 30.0
            seen.append((log, routing, table))
        assert seen[0] == seen[1]
        log, routing, table = seen[0]
        assert log[-1] == (410, {"known": False})
        assert routing == {"w0": "http://127.0.0.1:4",
                           "w1": "http://127.0.0.1:2"}
        assert table["w1"]["digest"]["queue_depth"] == 2
    finally:
        for reg in regs:
            reg.close()


# ---------------------------------------------------------------------------
# parity with the JAX package: decoder-backed failover


PROMPTS = (np.arange(5, 12, dtype=np.int32), np.arange(3, 10, dtype=np.int32))
NEW = 12


def _bind_decoder(worker, eng, adopted):
    """The decoder harness the plane's docstring describes: ``/_adopt``
    restores each session on this worker's decoder (warm with a page
    blob, cold without)."""
    def handler(payload):
        entries = payload.get("sessions") or []
        for entry in entries:
            adopted.append(eng.restore_session(entry["session"],
                                               kv_blob=entry.get("kv")))
        return {"ok": True, "adopted": len(entries),
                "mode": payload.get("mode", "cold"),
                "worker": worker.worker_id}
    worker.adopt_handler = handler


@pytest.mark.parametrize("policy", ["warm", "cold"])
def test_decoder_backed_drain_gives_the_reference_tokens(params, tmp_path,
                                                         monkeypatch, policy):
    """``drain_worker`` checkpoints worker-0's live sessions through its
    ``session_exporter`` and ships them over ``/_adopt`` to worker-1's
    decoder: warm (page blobs, nothing re-prefilled) or cold
    (``MMLSPARK_TPU_ADOPT_POLICY=cold``), each session finishes with the
    JAX engine's uninterrupted tokens."""
    monkeypatch.setenv("MMLSPARK_TPU_ADOPT_POLICY", policy)
    wants = [_ref_tokens(params, p, NEW) for p in PROMPTS]
    cluster = ServingCluster(3, reply_timeout=5.0, journal_dir=str(tmp_path))
    try:
        src, dst = _engine(params), _engine(params)
        reqs = [src.submit(p, NEW, session_id=f"d{i}")
                for i, p in enumerate(PROMPTS)]
        for _ in range(5):
            src.step()
        assert all(r.tokens and not r.done for r in reqs)
        cluster.worker("worker-0").session_exporter = \
            lambda: [src.checkpoint_session(r) for r in reqs]
        adopted = []
        _bind_decoder(cluster.worker("worker-1"), dst, adopted)
        out = cluster.drain_worker("worker-0", target_id="worker-1")
        assert out == {"ok": True, "adopted": 2, "mode": policy,
                       "worker": "worker-1"}
        assert "worker-0" not in cluster.driver.routing_table()
        assert [_finish(dst, r) for r in adopted] == wants
        if policy == "warm":
            assert dst.stats["prefills"] == 0
        else:
            assert dst.stats["prefills"] >= 1
    finally:
        cluster.close()


def test_decoder_backed_cold_kill_gives_the_reference_tokens(params,
                                                             tmp_path):
    """worker-1's decoder journals into worker-1's server journal; its
    heartbeats stop without a goodbye; the driver's sweeper declares it
    dead and the cluster replays the journaled sessions onto a
    survivor's decoder, which re-prefills them: the JAX engine's
    uninterrupted tokens."""
    wants = [_ref_tokens(params, p, NEW) for p in PROMPTS]
    cluster = ServingCluster(3, reply_timeout=5.0, liveness_interval=0.15,
                             heartbeat_interval=0.05,
                             journal_dir=str(tmp_path))
    try:
        w1 = cluster.worker("worker-1")
        src = _engine(params, journal=w1.server._journal)
        reqs = [src.submit(p, NEW, session_id=f"k{i}")
                for i, p in enumerate(PROMPTS)]
        for _ in range(5):
            src.step()
        assert all(r.tokens and not r.done for r in reqs)
        adopters = {}
        for wid in ("worker-0", "worker-2"):
            eng, got = _engine(params), []
            _bind_decoder(cluster.worker(wid), eng, got)
            adopters[wid] = (eng, got)
        w1._hb_stop.set()
        w1._hb_thread.join(timeout=2.0)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and \
                not any(len(got) == 2 for _, got in adopters.values()):
            time.sleep(0.05)
        hit = [v for v in adopters.values() if v[1]]
        assert len(hit) == 1 and len(hit[0][1]) == 2, "no cold reassignment"
        eng, got = hit[0]
        assert "worker-1" not in cluster.driver.routing_table()
        results = {r.session_id: _finish(eng, r) for r in got}
        assert [results["k0"], results["k1"]] == wants
        assert eng.stats["prefills"] >= 1
    finally:
        cluster.close()


# ---------------------------------------------------------------------------
# the chaos drill under the lock sanitizer (the reference's
# tests/test_lock_sanitizer.py:230-240)


def test_chaos_drill_under_the_lock_sanitizer_reports_no_cycle(monkeypatch):
    from mmlspark_tpu_torch.reliability import lock_sanitizer as ls
    monkeypatch.setenv(ls.SANITIZER_ENV, "1")
    ls.reset()
    assert ls.enabled()
    try:
        test_chaos_faults_and_worker_restart_complete_every_request()
        assert ls.cycle_reports() == [], (
            "lock-order cycles under chaos:\n" + "\n".join(
                " -> ".join(r["sites"]) for r in ls.cycle_reports()))
    finally:
        monkeypatch.delenv(ls.SANITIZER_ENV, raising=False)
        ls.reset()


# ---------------------------------------------------------------------------
# python -m mmlspark_tpu_torch.serving


def _wait_for(fn, seconds):
    deadline = time.monotonic() + seconds
    last = None
    while time.monotonic() < deadline:
        try:
            out = fn()
            if out:
                return out
        except OSError as e:
            last = e
        time.sleep(0.1)
    raise AssertionError(f"not ready after {seconds}s ({last!r})")


def test_cli_driver_and_worker_register(tmp_path):
    dport, wport = find_open_port(), find_open_port()
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(ROOT),
           "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "mmlspark_tpu_torch.serving",
           "--host", "127.0.0.1"]
    url = f"http://127.0.0.1:{dport}"
    procs = []
    logs = []
    try:
        for name, extra in (("driver", ["--driver", "--port", str(dport)]),
                            ("worker", ["--driver-url", url, "--port",
                                        str(wport), "--worker-id",
                                        "cli-w0"])):
            log = open(tmp_path / f"{name}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(cmd + extra, env=env, cwd=ROOT,
                                          stdout=log,
                                          stderr=subprocess.STDOUT))
            if name == "driver":
                _wait_for(lambda: _get_json(url + "/workers", 2.0) == {}
                          or None, 90)
        table = _wait_for(lambda: (lambda t: t if "cli-w0" in t else None)(
            _get_json(url + "/workers", 2.0)), 90)
        assert table["cli-w0"]["address"] == f"http://127.0.0.1:{wport}"
        health = _get_json(f"http://127.0.0.1:{wport}/healthz")
        assert health["port"] == wport
        # SIGTERM: the worker deregisters and exits
        procs[1].send_signal(signal.SIGTERM)
        assert procs[1].wait(timeout=30) == 0
        assert "cli-w0" not in _get_json(url + "/workers")
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        for log in logs:
            log.close()
