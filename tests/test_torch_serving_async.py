"""Port parity: the worker server's two transports (``serving/server.py``)
with admission, shedding and the journal.

The cases of the reference's ``tests/test_serving_async.py``, the server
cases of ``tests/test_admission.py:281`` and
``tests/test_serving_journal.py:95-150``, on both of the port's
transports: keep-alive, chunked bodies, ``Expect: 100-continue``, 400 on
a malformed request, 504 on a reply timeout (and on an
``X-Mmlspark-Deadline``), SSE streams, control routes that bypass the
queue, 429 with ``Retry-After`` at or above the floor, the ``enqueue``
fault site, a restarted server (same process or after SIGKILL)
rehydrating its unanswered requests from the journal, and ``/metrics``
as Prometheus text. Then the same requests go to both packages' servers:
their status lines and bodies must be equal, and so must their header
names (the ``traceparent`` echo included).
"""

import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from mmlspark_tpu.io.http import schema as ref_schema
from mmlspark_tpu.reliability import get_injector as ref_injector
from mmlspark_tpu.serving.server import WorkerServer as RefServer
from mmlspark_tpu_torch.io.http.schema import (EntityData, HTTPResponseData,
                                               StatusLineData)
from mmlspark_tpu_torch.reliability import get_injector
from mmlspark_tpu_torch.serving.server import WorkerServer

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

ROOT = Path(__file__).resolve().parents[1]
TRANSPORTS = ["threaded", "async"]


def _resp(payload, status=200):
    return HTTPResponseData(entity=EntityData.from_string(json.dumps(payload)),
                            status_line=StatusLineData(status_code=status))


class _Echo:
    """A dispatcher thread answering every parked request with a JSON
    description of it (either package's server)."""

    def __init__(self, ws, schema=None):
        self.ws, self.schema = ws, schema
        self.stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while not self.stop.is_set():
            for c in self.ws.get_batch(16, timeout=0.05):
                ent = c.request.entity
                body = ent.content if ent is not None else b""
                payload = {"len": len(body), "url": c.request.url,
                           "method": c.request.method}
                if self.schema is None:
                    self.ws.reply(c.request_id, _resp(payload))
                else:
                    self.ws.reply(c.request_id, self.schema.HTTPResponseData(
                        entity=self.schema.EntityData.from_string(
                            json.dumps(payload)),
                        status_line=self.schema.StatusLineData(
                            status_code=200)))

    def close(self):
        self.stop.set()
        self.t.join(timeout=5)


@pytest.fixture(autouse=True)
def _no_faults():
    get_injector().clear()
    yield
    get_injector().clear()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_roundtrip_keepalive(transport):
    ws = WorkerServer(transport=transport, reply_timeout=10.0)
    echo = _Echo(ws)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
        for i in range(5):
            conn.request("POST", "/", json.dumps({"x": i}).encode(),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            assert r.status == 200 and r.getheader("X-Request-Id")
            assert json.loads(r.read())["len"] == len(json.dumps({"x": i}))
        conn.close()
    finally:
        echo.close()
        ws.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_chunked_request_body(transport):
    ws = WorkerServer(transport=transport, reply_timeout=10.0)
    echo = _Echo(ws)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
        conn.putrequest("POST", "/")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        for chunk in (b"hello ", b"chunked ", b"world"):
            conn.send(b"%x\r\n%s\r\n" % (len(chunk), chunk))
        conn.send(b"0\r\n\r\n")
        r = conn.getresponse()
        assert json.loads(r.read())["len"] == len(b"hello chunked world")
        conn.close()
    finally:
        echo.close()
        ws.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_control_route_bypasses_queue(transport):
    ws = WorkerServer(transport=transport)
    ws.control_routes["/ctrl"] = lambda req: _resp({"ctrl": True})
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
        conn.request("POST", "/ctrl/ping", b"{}")
        assert json.loads(conn.getresponse().read()) == {"ctrl": True}
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["transport"] == transport
        assert ws.pending_count() == 0      # never parked
        conn.close()
    finally:
        ws.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_malformed_request_gets_400(transport):
    ws = WorkerServer(transport=transport)
    try:
        s = socket.create_connection(("127.0.0.1", ws.port), timeout=10)
        s.sendall(b"POST / HTTP/1.1\r\nContent-Length: abc\r\n\r\n")
        data = s.recv(4096)
        assert data.startswith(b"HTTP/1.1 400"), data[:60]
        s.close()
    finally:
        ws.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_reply_timeout_and_deadline_504(transport):
    ws = WorkerServer(transport=transport, reply_timeout=0.3)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
        conn.request("POST", "/", b'{"q": 1}')
        r = conn.getresponse()
        assert r.status == 504 and r.reason == "serving reply timeout"
        r.read()
        conn.close()
    finally:
        ws.close()
    # a propagated deadline caps the park time below reply_timeout
    ws = WorkerServer(transport=transport, reply_timeout=30.0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
        t0 = time.monotonic()
        conn.request("POST", "/", b"{}", {"X-Mmlspark-Deadline": "0.2"})
        r = conn.getresponse()
        assert r.status == 504 and time.monotonic() - t0 < 5.0
        r.read()
        (cached,) = ws.get_batch(1, timeout=1.0)
        assert cached.deadline is not None and ws.wait_budget(cached) == 0.0
        conn.close()
    finally:
        ws.close()


def test_many_connections():
    """64 concurrent keep-alive connections, 5 requests each, on the async
    transport (the regime it exists for, as the reference's own test runs
    it): no error and no thread left hanging."""
    ws = WorkerServer(transport="async", reply_timeout=30.0)
    echo = _Echo(ws)
    errors, lock = [0], threading.Lock()

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=30)
        e = 0
        for i in range(5):
            try:
                conn.request("POST", "/", json.dumps({"x": i}).encode())
                r = conn.getresponse()
                r.read()
                e += r.status != 200
            except Exception:
                e += 1
        conn.close()
        with lock:
            errors[0] += e

    try:
        ts = [threading.Thread(target=client) for _ in range(64)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert errors[0] == 0
    finally:
        echo.close()
        ws.close()


@pytest.mark.parametrize("first,second", [("async", "threaded"),
                                          ("threaded", "async")])
def test_journal_rehydrates_across_transports(tmp_path, first, second):
    jp = str(tmp_path / "a.jsonl")
    ws = WorkerServer(transport=first, journal_path=jp, reply_timeout=0.5,
                      journal_fsync=False)
    conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
    conn.request("POST", "/", b'{"k": 9}')
    r = conn.getresponse()      # times out -> 504; stays in the journal
    assert r.status == 504
    r.read()
    conn.close()
    ws.close()
    ws2 = WorkerServer(transport=second, journal_path=jp)
    try:
        assert ws2.health_digest()["journal"]["records"] == {}
        batch = ws2.get_batch(4, timeout=1.0)
        assert len(batch) == 1 and batch[0].replayed
        assert json.loads(batch[0].request.entity.string_content()) == {"k": 9}
        assert ws2.reply(batch[0].request_id, _resp({"ok": 1}))
        # replay_unanswered re-enqueues only what is still unanswered
        assert ws2.replay_unanswered() == 0
    finally:
        ws2.close()
    ws3 = WorkerServer(transport=second, journal_path=jp)
    try:
        assert ws3.get_batch(4, timeout=0.1) == []
    finally:
        ws3.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_expect_100_continue(transport):
    ws = WorkerServer(transport=transport, reply_timeout=10.0)
    echo = _Echo(ws)
    try:
        body = b"x" * 2048
        s = socket.create_connection(("127.0.0.1", ws.port), timeout=10)
        s.sendall(b"POST / HTTP/1.1\r\nHost: h\r\n"
                  b"Content-Length: %d\r\nExpect: 100-continue\r\n\r\n"
                  % len(body))
        interim = s.recv(64)
        assert b"100 Continue" in interim
        s.sendall(body)
        data = interim.split(b"\r\n\r\n", 1)[1]
        while b"\r\n\r\n" not in data or not data.endswith(b"}"):
            part = s.recv(4096)
            if not part:
                break
            data += part
        assert b"200" in data.split(b"\r\n", 1)[0]
        assert json.loads(data.split(b"\r\n\r\n", 1)[1])["len"] == 2048
        s.close()
    finally:
        echo.close()
        ws.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_stream_roundtrip_and_timeout(transport):
    """reply_stream: the first event is on the wire before the stream
    closes, closing ends the response, and a stream silent past
    reply_timeout ends with an explicit error event."""
    ws = WorkerServer(transport=transport, reply_timeout=30.0)
    try:
        may_close = threading.Event()

        def answer():
            (cached,) = ws.get_batch(1, timeout=5.0)
            h = ws.reply_stream(cached.request_id)
            h.send_event({"tokens": [1, 2]})
            may_close.wait(10)
            h.send_event({"tokens": [3]})
            h.close()

        t = threading.Thread(target=answer)
        t.start()
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
        conn.request("POST", "/", b"{}")
        r = conn.getresponse()
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/event-stream")
        first = b""
        while b"\n\n" not in first:
            first += r.read1(256)
        assert json.loads(first.split(b"\n\n")[0][6:]) == {"tokens": [1, 2]}
        may_close.set()
        rest = r.read().decode()
        t.join(timeout=5)
        events = [json.loads(b[6:]) for b in rest.split("\n\n")
                  if b.startswith("data: ")]
        assert events == [{"tokens": [3]}]
        conn.close()
    finally:
        ws.close()
    ws2 = WorkerServer(transport=transport, reply_timeout=0.5)
    try:
        def answer_silent():
            (cached,) = ws2.get_batch(1, timeout=5.0)
            ws2.reply_stream(cached.request_id)      # never sends
        t2 = threading.Thread(target=answer_silent)
        t2.start()
        conn2 = http.client.HTTPConnection("127.0.0.1", ws2.port, timeout=10)
        conn2.request("POST", "/", b"{}")
        body2 = conn2.getresponse().read().decode()
        t2.join(timeout=5)
        events2 = [json.loads(b[6:]) for b in body2.split("\n\n")
                   if b.startswith("data: ")]
        assert events2 and events2[-1] == {"error": "stream reply timeout"}
        conn2.close()
    finally:
        ws2.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_429_carries_retry_after_at_least_floor(transport):
    server = WorkerServer(max_queue=1, shed_retry_after=2.0,
                          transport=transport)
    try:
        req = urllib.request.Request(
            server.address, data=b"{}",
            headers={"Content-Type": "application/json"})
        parked = {}

        def park():
            try:
                with urllib.request.urlopen(req, timeout=10.0) as r:
                    parked["status"] = r.status
            except urllib.error.HTTPError as e:
                parked["status"] = e.code

        t = threading.Thread(target=park, daemon=True)
        t.start()
        deadline = time.monotonic() + 5.0
        while server._queue.qsize() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert server._queue.qsize() == 1
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10.0)
        assert exc.value.code == 429
        assert float(exc.value.headers["Retry-After"]) >= 2.0
        assert server.health_digest()["admission"]["size"] == 1
        cached = server.get_batch(1, timeout=1.0)[0]
        server.reply(cached.request_id, _resp({}))
        t.join(timeout=5.0)
        assert parked.get("status") == 200
    finally:
        server.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_enqueue_fault_answers_500(transport):
    get_injector().add("enqueue", "error", times=1)
    ws = WorkerServer(transport=transport, reply_timeout=10.0)
    echo = _Echo(ws)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
        conn.request("POST", "/", b"{}")
        r = conn.getresponse()
        assert r.status == 500 and b"injected fault" in r.read()
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
        conn.request("POST", "/", b"{}")
        assert conn.getresponse().status == 200
        conn.close()
    finally:
        echo.close()
        ws.close()


def test_engine_restart_same_process(tmp_path):
    """A journaled server's reply clears the journal entry: a restart
    rehydrates nothing."""
    jp = str(tmp_path / "w.jsonl")
    ws = WorkerServer(journal_path=jp, reply_timeout=10.0)
    out = [None]

    def post():
        r = urllib.request.urlopen(urllib.request.Request(
            ws.address, data=b'{"q": 1}', method="POST"), timeout=10)
        out[0] = r.status

    t = threading.Thread(target=post)
    t.start()
    batch = []
    deadline = time.time() + 5
    while not batch and time.time() < deadline:
        batch = ws.get_batch(4, timeout=0.2)
    assert len(batch) == 1 and not batch[0].replayed
    assert ws.reply(batch[0].request_id, _resp({"ok": 1}))
    t.join(timeout=10)
    assert out[0] == 200
    assert ws.commit_epoch() == 1
    ws.close()
    ws2 = WorkerServer(journal_path=jp)
    assert ws2.pending_count() == 0 and ws2._epoch == 1
    assert ws2.get_batch(4, timeout=0.1) == []
    ws2.close()


def test_kill_process_and_replay(tmp_path):
    """SIGKILL a worker process mid-request; a fresh process on the same
    journal rehydrates the request and answers it."""
    jp = str(tmp_path / "w.jsonl")
    port_file = str(tmp_path / "port")
    script = tmp_path / "child.py"
    script.write_text(
        "import sys, time\n"
        "from mmlspark_tpu_torch.serving.server import WorkerServer\n"
        "ws = WorkerServer(journal_path=sys.argv[1], reply_timeout=60,\n"
        "                  transport=sys.argv[3])\n"
        "open(sys.argv[2], 'w').write(str(ws.port))\n"
        "time.sleep(300)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, str(script), jp, port_file,
                             "async"], env=env)
    try:
        deadline = time.time() + 60
        while not os.path.exists(port_file) and time.time() < deadline:
            time.sleep(0.1)
        assert os.path.exists(port_file), "child never came up"
        time.sleep(0.1)
        port = int(open(port_file).read())
        out = [None]

        def post():
            try:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/", data=b'{"q": 42}',
                    method="POST"), timeout=8)
                out[0] = "ok"
            except Exception as e:
                out[0] = repr(e)

        t = threading.Thread(target=post)
        t.start()
        deadline = time.time() + 10
        while time.time() < deadline:
            if os.path.exists(jp) and '"t":"req"' in open(jp).read():
                break
            time.sleep(0.05)
        else:
            pytest.fail("request never reached the journal")
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
        t.join(timeout=15)
        assert out[0] != "ok"              # the connection died with it
    finally:
        if proc.poll() is None:
            proc.kill()
    ws = WorkerServer(journal_path=jp)
    try:
        (cached,) = ws.get_batch(4, timeout=1.0)
        assert cached.replayed
        assert json.loads(cached.request.entity.string_content()) == {"q": 42}
        assert ws.reply(cached.request_id, _resp({"answered": True}))
        assert ws.pending_count() == 0
    finally:
        ws.close()
    ws3 = WorkerServer(journal_path=jp)
    try:
        assert ws3.get_batch(4, timeout=0.2) == []
    finally:
        ws3.close()


_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? '
    r'(-?[0-9.eE+-]+|[+-]Inf|NaN)$')


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_metrics_are_prometheus_text(tmp_path, transport):
    ws = WorkerServer(transport=transport, journal_path=str(tmp_path / "j"),
                      journal_fsync=False, reply_timeout=10.0)
    echo = _Echo(ws)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ws.port, timeout=10)
        conn.request("POST", "/", b"{}", {"X-Mmlspark-Tenant": "team-a"})
        assert conn.getresponse().read()
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type").startswith("text/plain; version=0.0.4")
        text = r.read().decode()
        conn.close()
    finally:
        echo.close()
        ws.close()
    types = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            assert kind in ("counter", "gauge", "histogram")
            types[name] = kind
            continue
        assert _PROM_LINE.match(line), line
    for name in ("mmlspark_serving_requests_total",
                 "mmlspark_serving_request_seconds",
                 "mmlspark_wfq_enqueued_total", "mmlspark_journal_bytes",
                 "mmlspark_journal_records_total"):
        assert name in types, name
    assert f'mmlspark_wfq_enqueued_total{{tenant="team-a"}}' in text
    assert re.search(r'mmlspark_journal_records_total\{type="req"\} \d', text)


# ---------------------------------------------------------------------------
# the same requests to both packages' servers


def _exchange(port, raw: bytes, expect_100: bool = False):
    """Send ``raw``, read one full response: (status line, header names
    with values, body)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        if expect_100:
            head, body = raw.split(b"\r\n\r\n", 1)
            s.sendall(head + b"\r\n\r\n")
            interim = b""
            while b"\r\n\r\n" not in interim:
                interim += s.recv(1)
            assert interim.startswith(b"HTTP/1.1 100")
            s.sendall(body)
        else:
            s.sendall(raw)
        data = b""
        while b"\r\n\r\n" not in data:
            part = s.recv(4096)
            if not part:
                break
            data += part
        head, _, body = data.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        headers = [tuple(x.strip() for x in h.split(":", 1))
                   for h in lines[1:]]
        length = int(dict((k.lower(), v) for k, v in headers)
                     .get("content-length", 0))
        while len(body) < length:
            part = s.recv(4096)
            if not part:
                break
            body += part
        return lines[0], headers, body
    finally:
        s.close()


_EXCHANGES = {
    "post": b"POST /gen HTTP/1.1\r\nHost: h\r\nContent-Length: 7\r\n"
            b"Content-Type: application/json\r\n\r\n{\"a\":1}",
    "get": b"GET /x?y=1 HTTP/1.1\r\nHost: h\r\nConnection: close\r\n\r\n",
    "chunked": b"POST / HTTP/1.1\r\nHost: h\r\nTransfer-Encoding: chunked"
               b"\r\n\r\n3\r\nabc\r\n4\r\ndefg\r\n0\r\n\r\n",
    "expect": b"POST /e HTTP/1.1\r\nHost: h\r\nContent-Length: 5\r\n"
              b"Expect: 100-continue\r\n\r\nhello",
    "malformed": b"POST / HTTP/1.1\r\nHost: h\r\nContent-Length: abc\r\n\r\n",
    "deadline": b"POST /slow HTTP/1.1\r\nHost: h\r\nContent-Length: 2\r\n"
                b"X-Mmlspark-Deadline: 0.1\r\n\r\n{}",
}

#: header values that differ by construction (a clock, a random id)
#: headers whose values differ run to run: the request id and the trace
#: echo carry freshly minted ids
_VOLATILE = {"date", "x-request-id", "traceparent"}


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_same_requests_same_answers_as_the_jax_server(transport):
    ref_injector().clear()
    servers = {"jax": RefServer(transport=transport, reply_timeout=5.0),
               "port": WorkerServer(transport=transport, reply_timeout=5.0)}
    # the deadline request is never answered: the dispatcher skips it
    echoes = {}
    for name, ws in servers.items():
        real = ws.get_batch

        def get_batch(n, timeout=0.1, real=real):
            return [c for c in real(n, timeout) if c.request.url != "/slow"]

        ws.get_batch = get_batch
        echoes[name] = _Echo(ws, ref_schema if name == "jax" else None)
    try:
        for label, raw in _EXCHANGES.items():
            got = {name: _exchange(ws.port, raw,
                                   expect_100=label == "expect")
                   for name, ws in servers.items()}
            (s_j, h_j, b_j), (s_p, h_p, b_p) = got["jax"], got["port"]
            assert s_p == s_j, label
            assert b_p == b_j, label
            names_j = {k.lower() for k, _ in h_j}
            names_p = {k.lower() for k, _ in h_p}
            assert names_p == names_j, (label, names_p ^ names_j)
            vals_j = {k.lower(): v for k, v in h_j
                      if k.lower() not in _VOLATILE}
            vals_p = {k.lower(): v for k, v in h_p
                      if k.lower() not in _VOLATILE}
            assert vals_p == vals_j, label
    finally:
        for name, ws in servers.items():
            echoes[name].close()
            ws.close()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_same_429_as_the_jax_server(transport):
    raw = b"POST / HTTP/1.1\r\nHost: h\r\nContent-Length: 2\r\n\r\n{}"
    out = {}
    for name, cls in (("jax", RefServer), ("port", WorkerServer)):
        ws = cls(transport=transport, max_queue=1, shed_retry_after=3.0,
                 reply_timeout=5.0)
        try:
            parked = threading.Thread(target=_exchange, args=(ws.port, raw),
                                      daemon=True)
            parked.start()
            deadline = time.monotonic() + 5.0
            while ws._queue.qsize() == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            out[name] = _exchange(ws.port, raw)
            for c in ws.get_batch(1, timeout=1.0):
                ws.reply_json(c.request_id, {})
            parked.join(timeout=5)
        finally:
            ws.close()
    (s_j, h_j, b_j), (s_p, h_p, b_p) = out["jax"], out["port"]
    assert s_p == s_j and b_p == b_j == b""
    assert s_p.startswith("HTTP/1.1 429")
    want = {k.lower(): v for k, v in h_j if k.lower() not in _VOLATILE}
    assert {k.lower(): v for k, v in h_p if k.lower() not in _VOLATILE} \
        == want
    assert float(want["retry-after"]) >= 3.0
