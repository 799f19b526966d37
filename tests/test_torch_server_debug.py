"""Port parity: the serving plane's control routes and per-request hooks on
the generation front (``mmlspark_tpu_torch/serving/server.py`` under
``serving/generation.py``) against the JAX package's, after the
reference's ``tests/test_tracing.py``, ``tests/test_slo.py``,
``tests/test_cost_ledger.py``, ``tests/test_registry.py`` and
``tests/test_observability.py`` server cases.

One request script goes to a JAX ``GenerationEngine`` and to the port's
(``device="cpu"``, a two-layer f32 decoder, 8-token prefill chunks so
the 12-token prompts prefill in two chunks), with ``gen@1`` live in
each package's registry: requests from two tenants carrying their own
``traceparent`` and ``X-Mmlspark-Model: gen``, then every ``/debug/*``
route the port has, ``/healthz``, ``/metrics`` and ``/models`` (GET and
each POST verb). Both must give the same status lines, echo the same
trace ids, return JSON bodies with the same key structure, and the same
greedy tokens. The port's own plane is then checked in depth: the trace
holds the request's ``prefill_chunk`` events, the ledger bills
``device_seconds`` and ``kv_page_seconds`` to each tenant's class, the
SLO windows count each tenant's requests, ``/debug/profile`` writes a
Chrome trace and answers 409 while one runs, and ``/healthz`` turns
degraded on a watchdog stall and on a firing alert.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mmlspark_tpu.serving.generation as r_gen
import mmlspark_tpu_torch.serving.generation as p_gen
from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
from mmlspark_tpu_torch.serving.server import WorkerServer
from mmlspark_tpu_torch.utils import profiling
from test_torch_tracing_slo import PKGS, reset_plane

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

REF_CFG = ref_tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                                   d_ff=128, max_len=64, causal=True,
                                   norm="rmsnorm", position="rope",
                                   dtype=jnp.float32)
CFG = TransformerConfig(vocab=128, layers=2, d_model=64, heads=4, d_ff=128,
                        max_len=64, causal=True, norm="rmsnorm",
                        position="rope", dtype=torch.float32)
ENGINE_KW = dict(max_slots=2, max_len=48, page_size=4, prefill_chunk=8)
SID = "00f067aa0ba902b7"
N_REQ = 6


@pytest.fixture(autouse=True)
def _clean_plane(tmp_path, monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_DIAG_DIR", str(tmp_path / "diag"))
    reset_plane()
    yield
    reset_plane()


@pytest.fixture(scope="module")
def params():
    return ref_tf.init_transformer(REF_CFG, seed=0)


def _call(url, payload=None, headers=None, method=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _shape(v, depth=2):
    """The key structure of a JSON value two levels down: dicts by key,
    lists by the union of their elements' structures, leaves erased.
    (Deeper, span trees differ: the port's trace also holds the engine's
    chunk spans and events, which the reference's front leaves out.)"""
    if depth == 0:
        return None
    if isinstance(v, dict):
        return {k: _shape(x, depth - 1) for k, x in v.items()}
    if isinstance(v, list):
        merged = {}
        for x in v:
            s = _shape(x, depth)
            if isinstance(s, dict):
                merged.update(s)
        return [merged] if merged else []
    return None


def _trace_id(i):
    return f"{i + 1:032x}"


def _prompt(i):
    rng = np.random.default_rng(i)
    return [int(t) for t in rng.integers(0, 128, 12)]


def _script(name, pkg, params):
    """Drive one package's front; returns what the parity test compares
    and, for the port, the engine (still open) for the in-depth checks."""
    mod = r_gen if name == "jax" else p_gen
    kw = dict(ENGINE_KW)
    if name == "port":
        kw["device"] = "cpu"
    eng = mod.GenerationEngine(params, REF_CFG if name == "jax" else CFG,
                               **kw)
    pkg.registry.get_registry().load("gen", "1", handle=eng)
    eng.start()
    base = eng.server.address.rsplit("/generate", 1)[0]
    out = {"replies": []}
    for i in range(N_REQ):
        status, headers, body = _call(
            eng.address, {"tokens": _prompt(i), "max_new": 5},
            {"traceparent": f"00-{_trace_id(i)}-{SID}-01",
             "X-Mmlspark-Model": "gen", "X-Mmlspark-Tenant": f"t{i % 2}"})
        echo = headers.get("traceparent", "")
        out["replies"].append((status, echo.split("-")[1],
                               echo.split("-")[2] != SID,
                               json.loads(body)["tokens"]))
    shapes = {}
    for path in ("/debug/traces", f"/debug/traces/{_trace_id(0)}",
                 f"/debug/traces/{_trace_id(0)}?format=chrome",
                 "/debug/traces/" + "f" * 32, "/debug/slo", "/debug/costs",
                 "/debug/registry", "/models", "/healthz"):
        status, _, body = _call(base + path)
        shapes[path] = (status, _shape(json.loads(body)))
    status, _, body = _call(base + "/debug/timeseries?seconds=60")
    shapes["/debug/timeseries"] = (status, sorted(json.loads(body)))
    status, headers, body = _call(base + "/debug/timeseries?format=text")
    shapes["/debug/timeseries?format=text"] = (status,
                                               headers["Content-Type"])
    status, headers, _ = _call(base + "/metrics")
    shapes["/metrics"] = (status, headers["Content-Type"])
    for payload in ({"action": "tenant", "tenant": "t1", "weight": 2.0},
                    {"action": "load", "name": "gen", "version": "2",
                     "canary_percent": 10}, {"action": "check"},
                    {"action": "rollback", "name": "gen", "version": "2"},
                    {"action": "retire", "name": "gen", "version": "9"},
                    {"action": "promote", "name": "gen"},
                    {"action": "fly"}, "not json"):
        data = payload if isinstance(payload, dict) else None
        req = urllib.request.Request(
            base + "/models", method="POST",
            data=json.dumps(data).encode() if data else b"{not json",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                st, b = r.status, r.read()
        except urllib.error.HTTPError as e:
            st, b = e.code, e.read()
        shapes[f"POST {payload}"] = (st, _shape(json.loads(b)))
    status, _, body = _call(base + "/debug/profile?seconds=0.2")
    second, _, body2 = _call(base + "/debug/profile?seconds=0.2")
    shapes["/debug/profile"] = (status, _shape(json.loads(body)), second,
                                _shape(json.loads(body2)))
    bad, _, _ = _call(base + "/debug/profile?seconds=x")
    shapes["/debug/profile bad"] = bad
    out["shapes"] = shapes
    out["profile_dir"] = json.loads(body)["log_dir"]
    return out, eng, base


def test_same_script_same_answers_as_the_jax_front(params):
    got, engines = {}, {}
    try:
        for name, pkg in PKGS.items():
            got[name], engines[name], _ = _script(name, pkg, params)
    finally:
        for eng in engines.values():
            eng.stop()      # joins a running profile capture first
    j, p = got["jax"], got["port"]
    assert [r[0] for r in p["replies"]] == [200] * N_REQ
    assert [r[1] for r in p["replies"]] == \
        [_trace_id(i) for i in range(N_REQ)] == [r[1] for r in j["replies"]]
    assert all(r[2] for r in p["replies"])           # our own span id
    assert [r[3] for r in p["replies"]] == [r[3] for r in j["replies"]]
    assert set(p["shapes"]) == set(j["shapes"])
    for key, val in j["shapes"].items():
        assert p["shapes"][key] == val, key
    assert p["shapes"]["/debug/profile"][0] == 200
    assert p["shapes"]["/debug/profile"][2] == 409


@pytest.fixture
def port_front(params):
    out, eng, base = _script("port", PKGS["port"], params)
    try:
        yield out, eng, base
    finally:
        eng.stop()


def test_port_trace_holds_the_prefill_chunks(port_front):
    _, _, base = port_front
    _, _, body = _call(base + f"/debug/traces/{_trace_id(0)}")
    doc = json.loads(body)
    (root,) = doc["roots"]
    assert root["name"] == "server.request"
    assert root["attrs"]["model"] == "gen@1" and root["attrs"]["tenant"] == "t0"
    chunks = [e for e in root["events"] if e["name"] == "prefill_chunk"]
    assert [e["fields"]["offset"] for e in chunks] == [0, 8]
    assert {c["name"] for c in root["children"]} == \
        {"continuous.prefill_chunk"}


def test_port_costs_and_slo_windows_per_tenant(port_front):
    _, _, base = port_front
    _, _, body = _call(base + "/debug/costs")
    classes = {c["tenant"]: c for c in json.loads(body)["classes"]
               if c["model"] == "gen@1"}
    assert set(classes) == {"t0", "t1"}
    for c in classes.values():
        assert c["resources"]["device_seconds"] > 0
        assert c["resources"]["kv_page_seconds"] > 0
        assert c["resources"]["queue_wait_seconds"] > 0
    _, _, body = _call(base + "/debug/slo?harvest=0")
    windows = {c["tenant"]: c["window"]["count"]
               for c in json.loads(body)["classes"] if c["model"] == "gen@1"}
    assert windows == {"t0": N_REQ // 2, "t1": N_REQ // 2}


def test_port_profile_capture_writes_a_chrome_trace(port_front):
    out, eng, _ = port_front
    eng.server._profile_thread.join(30)
    path = os.path.join(out["profile_dir"], profiling.TRACE_FILE)
    assert json.load(open(path))["traceEvents"] is not None
    assert out["profile_dir"].startswith(
        PKGS["port"].obs.get_watchdog().diag_dir())


def test_port_healthz_degrades_on_stall_and_firing_alert(port_front):
    _, eng, base = port_front
    assert json.loads(_call(base + "/healthz")[2])["status"] == "ok"
    wd = PKGS["port"].obs.configure_watchdog(enabled=True, interval=3600.0)
    wd.last_stall = {"wall": time.time(), "monotonic": time.monotonic(),
                     "site": "decoder_drain"}
    health = json.loads(_call(base + "/healthz")[2])
    assert health["status"] == "degraded"
    assert health["reasons"][0].startswith("watchdog_stall:")
    PKGS["port"].obs.reset_watchdog()
    ts = PKGS["port"].ts
    store = ts.get_store()
    engine = ts.get_alert_engine()
    engine.add_rule(ts.AlertRule("hot_queue", "t_sat", "gt", 0.5,
                                 for_seconds=0.0))
    store.record("t_sat", 0.9)
    engine.evaluate()
    health = json.loads(_call(base + "/healthz")[2])
    assert "alert_firing:hot_queue" in health["reasons"]
    digest = eng.server.health_digest()
    assert digest["degraded"] and digest["registry"]["models"]["gen"]
    assert digest["hbm_bytes_in_use"] is None   # CUDA never initialized


def test_port_journal_records_the_trace(tmp_path):
    ws = WorkerServer(journal_path=str(tmp_path / "j.jnl"),
                      journal_fsync=False)
    try:
        def answer():
            for c in ws.get_batch(1, timeout=5):
                ws.reply_json(c.request_id, {"ok": True})
        t = threading.Thread(target=answer)
        t.start()
        status, headers, _ = _call(
            ws.address, {"x": 1},
            {"traceparent": f"00-{_trace_id(41)}-{SID}-01"})
        t.join(10)
    finally:
        ws.close()
    assert status == 200 and _trace_id(41) in headers["traceparent"]
    lines = [json.loads(ln) for ln in open(tmp_path / "j.jnl")]
    assert [r.get("trace") for r in lines if r.get("t") == "req"] == \
        [_trace_id(41)]
