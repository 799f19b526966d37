"""Port parity: ``mmlspark_tpu_torch/io/http`` (clients on the standard
library, parsers, ``HTTPTransformer`` / ``SimpleHTTPTransformer``) and
``utils/async_utils`` against the JAX package, after the reference's
``tests/test_io_http_serving.py``.

Each case runs once through each package against the same local mock
service, which records every request it gets. The two packages must send
the same method, path, query string, body bytes and caller-set headers
(the transport's own ``Host`` / ``User-Agent`` / ``Accept*`` /
``Connection`` / ``Content-Length`` aside), and give equal output and
error columns. The transport cases (merged repeated headers, an absent
reason phrase, redirects, timeouts, refused connections, a kept-alive
connection the server closed while idle) hold the port's ``http.client``
transport to the behaviour of ``requests`` under the JAX package. The
last cases drive the port's client against the port's own
``WorkerServer`` shedding with 429 + ``Retry-After``.

The mock and the package table are imported by ``test_torch_services*``.
"""

import importlib
import json
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

ROOTS = {"jax": "mmlspark_tpu", "port": "mmlspark_tpu_torch"}


def _pkg(name):
    root = ROOTS[name]

    def m(sub):
        return importlib.import_module(f"{root}.{sub}")

    return types.SimpleNamespace(
        name=name, core=m("core"), dataframe=m("core.dataframe"),
        http=m("io.http"), clients=m("io.http.clients"),
        schema=m("io.http.schema"), services=m("services"),
        base=m("services.base"), async_utils=m("utils.async_utils"),
        powerbi=m("io.powerbi"))


PKGS = {name: _pkg(name) for name in ROOTS}

#: the transport's own headers, which the two clients set differently
TRANSPORT = {"host", "user-agent", "accept-encoding", "accept",
             "connection", "content-length"}


class Req:
    """One request as the mock's route sees it."""

    def __init__(self, handler, raw):
        url = urlparse(handler.path)
        self.method = handler.command
        self.path = url.path
        self.query = parse_qs(url.query)
        self.body = raw
        self.headers = handler.headers
        self.host = handler.headers.get("Host")
        self.peer = handler.client_address
        self.handler = handler
        try:
            self.json = json.loads(raw) if raw else None
        except ValueError:
            self.json = None


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True      # headers and body: two writes

    def log_message(self, *a):
        pass

    def _handle(self):
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        mock = self.server.mock
        req = Req(self, raw)
        with mock.lock:
            mock.log.append({
                "method": self.command, "path": req.path,
                "query": urlparse(self.path).query, "body": raw,
                "headers": sorted((k, v) for k, v in self.headers.items()
                                  if k.lower() not in TRANSPORT)})
            mock.raw.append((dict(self.headers.items()), req.peer))
        reply = mock.route(mock, req)
        if reply is None:           # the route wrote its own answer
            return
        status, headers, payload = reply
        if isinstance(payload, bytes):
            out, ctype = payload, "application/octet-stream"
        else:
            out, ctype = json.dumps(payload).encode(), "application/json"
        if isinstance(status, tuple):
            self.send_response(*status)
        else:
            self.send_response(status)
        for k, v in headers:
            self.send_header(k, v)
        if not any(k.lower() == "content-type" for k, _ in headers):
            self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = do_HEAD = _handle


class Mock:
    """A threading HTTP/1.1 server answering with ``route(mock, req) ->
    (status, [(header, value)], JSON value or bytes)`` (None: the route
    answered itself), recording every request in ``log``."""

    def __init__(self, route):
        self.route = route
        self.lock = threading.RLock()
        self.log, self.raw, self.state = [], [], {}
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.mock = self
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._t = threading.Thread(target=self.httpd.serve_forever,
                                   args=(0.05,), daemon=True)
        self._t.start()

    def reset(self):
        with self.lock:
            self.log, self.raw, self.state = [], [], {}

    def bump(self, key):
        """Count one more ``key`` in ``state``; returns the new count."""
        with self.lock:
            self.state[key] = self.state.get(key, 0) + 1
            return self.state[key]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def serve(route):
    """Fixture body: one mock a test."""
    mock = Mock(route)
    try:
        yield mock
    finally:
        mock.close()


def both(mock, fn, ordered=True):
    """``fn(pkg)`` through each package against ``mock``, state reset
    before each; asserts both sent the same requests (sorted when the
    client's order is free) and returns {name: fn's result}."""
    out, logs = {}, {}
    for name, pkg in PKGS.items():
        mock.reset()
        out[name] = fn(pkg)
        with mock.lock:
            log = list(mock.log)
        logs[name] = log if ordered else sorted(log, key=repr)
    assert logs["port"] == logs["jax"]
    return out


def frame(pkg, cols):
    """A package's DataFrame from one dict of columns (object columns for
    lists, so both packages get the same cells)."""
    conv = {}
    for k, v in cols.items():
        if isinstance(v, np.ndarray):
            conv[k] = v.copy()
        else:
            conv[k] = pkg.dataframe.object_col(list(v))
    return pkg.core.DataFrame(conv)


def plain(v):
    """A cell made comparable across packages: schema values by their
    dict form without the mock's ``Date`` header, arrays as lists."""
    if hasattr(v, "to_dict"):
        d = v.to_dict()
        if "headers" in d:
            d["headers"] = [h for h in d["headers"] if h["name"] != "Date"]
        return d
    if isinstance(v, np.ndarray):
        return [plain(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, np.generic):
        return v.item()
    return v


def same_cols(out, *cols):
    """The named columns of both packages' output frames, equal cell by
    cell; returns the port's."""
    for c in cols:
        j = [plain(x) for x in out["jax"][c]]
        p = [plain(x) for x in out["port"][c]]
        assert p == j, c
    return out["port"]


# ---------------------------------------------------------------------------
# the io/http cases


def _echo_route(mock, req):
    if req.path == "/echo":
        return 200, [], {"echo": req.json}
    if req.path == "/flaky":
        if mock.bump("count") % 2 == 1:
            return 503, [], b""
        return 200, [], {"ok": True}
    if req.path == "/ratelimit":
        if mock.bump("count") == 1:
            return 429, [("Retry-After", "0")], b""
        return 200, [], {"ok": True}
    if req.path == "/always503":
        return 503, [], {"busy": True}
    if req.path == "/headers":
        return 200, [("X-Multi", "a"), ("x-multi", "b"), ("X-One", "1")], \
            {"h": True}
    if req.path == "/noreason":
        return (200, ""), [], {"r": ""}
    if req.path.startswith("/redirect/"):
        code = int(req.path.rsplit("/", 1)[1])
        return code, [("Location", "/landing?from=" + str(code))], b""
    if req.path == "/cross_host":
        port = req.host.rsplit(":", 1)[1]
        return 302, [("Location", f"http://localhost:{port}/landing")], b""
    if req.path == "/landing":
        return 200, [], {"method": req.method,
                         "body": req.body.decode("latin-1"),
                         "ctype": req.headers.get("Content-Type"),
                         "auth": req.headers.get("Authorization")}
    if req.path == "/slow":
        time.sleep(1.5)
        return 200, [], {}
    if req.path == "/close_idle":
        # answered as kept-alive (no "Connection: close"), then the
        # socket closes: the client finds a dead connection in its pool
        h = req.handler
        out = json.dumps({"n": mock.bump("closed")}).encode()
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(out)))
        h.end_headers()
        h.wfile.write(out)
        h.wfile.flush()
        h.close_connection = True
        return None
    return 404, [], {}


@pytest.fixture
def svc():
    yield from serve(_echo_route)


def _req_col(pkg, n):
    return frame(pkg, {"input": [{"x": i} for i in range(n)]})


def test_package_surfaces_equal():
    j, p = PKGS["jax"], PKGS["port"]
    assert p.http.__all__ == j.http.__all__ and len(p.http.__all__) == 17
    assert p.services.__all__ == j.services.__all__ and \
        len(p.services.__all__) == 70
    assert p.async_utils.__all__ == j.async_utils.__all__


@pytest.mark.parametrize("concurrency", [1, 3, 8])
def test_buffered_await_order_and_bound(concurrency):
    """Results in input order, at most ``concurrency`` in flight (the
    await comes before the next pull), in both packages alike."""
    def run(pkg):
        live, peak, lock = [0], [0], threading.Lock()

        def fn(x):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.005)
            with lock:
                live[0] -= 1
            return x * x

        out = list(pkg.async_utils.map_buffered(fn, range(20), concurrency))
        return out, peak[0]

    got = {name: run(pkg) for name, pkg in PKGS.items()}
    assert got["port"][0] == got["jax"][0] == [x * x for x in range(20)]
    assert got["port"][1] <= concurrency and got["jax"][1] <= concurrency


def test_json_input_parser(svc):
    def run(pkg):
        return pkg.http.JSONInputParser(url=svc.base + "/echo",
                                        output_col="req",
                                        headers={"X-Key": "k"}
                                        ).transform(_req_col(pkg, 3))

    out = both(svc, run)
    port = same_cols(out, "req")
    req = port["req"][1]
    assert isinstance(req, PKGS["port"].schema.HTTPRequestData)
    assert json.loads(req.entity.string_content()) == {"x": 1}


@pytest.mark.parametrize("concurrency", [1, 8])
def test_http_transformer_roundtrip_and_order(svc, concurrency):
    n = 5 if concurrency == 1 else 20

    def run(pkg):
        df = pkg.http.JSONInputParser(url=svc.base + "/echo",
                                      output_col="req"
                                      ).transform(_req_col(pkg, n))
        out = pkg.http.HTTPTransformer(input_col="req", output_col="resp",
                                       concurrency=concurrency).transform(df)
        return pkg.http.JSONOutputParser(input_col="resp",
                                         output_col="val").transform(out)

    out = both(svc, run, ordered=concurrency == 1)
    port = same_cols(out, "resp", "val")
    assert [v["echo"]["x"] for v in port["val"]] == list(range(n))


@pytest.mark.parametrize("path,ladder,want,sent", [
    ("/flaky", [10, 10, 10], 200, 2),       # a 503 spends one step
    ("/ratelimit", [10], 200, 2),           # a 429 spends none
    ("/always503", [5, 5], 503, 3),         # the ladder runs out
])
def test_send_with_retries_ladder(svc, path, ladder, want, sent):
    def run(pkg):
        req = pkg.schema.HTTPRequestData.from_json(svc.base + path, {})
        return pkg.clients.send_with_retries(pkg.clients.shared_session.get(),
                                             req, ladder)

    out = both(svc, run)
    assert plain(out["port"]) == plain(out["jax"])
    assert out["port"].status_code == want and len(svc.log) == sent


def test_simple_http_transformer(svc):
    def run(pkg):
        t = pkg.http.SimpleHTTPTransformer(
            input_col="input", output_col="val",
            input_parser=pkg.http.JSONInputParser(url=svc.base + "/echo"),
            concurrency=4)
        return t.transform(_req_col(pkg, 4))

    port = same_cols(both(svc, run, ordered=False), "val", "error")
    assert [v["echo"]["x"] for v in port["val"]] == list(range(4))
    assert all(e is None for e in port["error"])


def test_simple_http_transformer_error_split(svc):
    def run(pkg):
        t = pkg.http.SimpleHTTPTransformer(
            input_col="input", output_col="val",
            input_parser=pkg.http.JSONInputParser(url=svc.base + "/nope"))
        return t.transform(_req_col(pkg, 2))

    port = same_cols(both(svc, run), "val", "error")
    assert all(v is None for v in port["val"])
    assert all(e["statusCode"] == 404 for e in port["error"])


def test_custom_and_string_output_parsers(svc):
    def run(pkg):
        df = pkg.http.JSONInputParser(url=svc.base + "/echo",
                                      output_col="req"
                                      ).transform(_req_col(pkg, 2))
        out = pkg.http.HTTPTransformer(input_col="req",
                                       output_col="resp").transform(df)
        s = pkg.http.StringOutputParser(input_col="resp",
                                        output_col="s").transform(out)
        return pkg.http.CustomOutputParser(
            input_col="resp", output_col="code",
            udf=lambda r: r.status_code).transform(s)

    port = same_cols(both(svc, run), "s", "code")
    assert json.loads(port["s"][0]) == {"echo": {"x": 0}}
    assert list(port["code"]) == [200, 200]


def test_simple_http_save_load(tmp_path, svc):
    def run(pkg):
        t = pkg.http.SimpleHTTPTransformer(
            input_col="input", output_col="val",
            input_parser=pkg.http.JSONInputParser(url=svc.base + "/echo"))
        path = str(tmp_path / pkg.name)
        t.save(path)
        return type(t).load(path).transform(_req_col(pkg, 2))

    port = same_cols(both(svc, run), "val", "error")
    assert [v["echo"]["x"] for v in port["val"]] == [0, 1]


# ---------------------------------------------------------------------------
# the transport against requests' behaviour


def _send(pkg, url, method="GET", payload=None, timeout=60.0, ladder=()):
    req = (pkg.schema.HTTPRequestData(url=url, method=method)
           if payload is None else
           pkg.schema.HTTPRequestData.from_json(url, payload, method))
    h = pkg.clients.advanced_handler(*ladder, timeout=timeout)
    return h(pkg.clients.shared_session.get(), req)


def test_repeated_headers_merge_and_lookups_ignore_case(svc):
    out = both(svc, lambda pkg: _send(pkg, svc.base + "/headers"))
    assert plain(out["port"]) == plain(out["jax"])
    names = {h.name.lower(): h.value for h in out["port"].headers}
    assert names["x-multi"] == "a, b" and names["x-one"] == "1"
    s = PKGS["port"].clients.Session()
    r = s.request("GET", svc.base + "/headers", timeout=10)
    assert r.headers["X-MULTI"] == r.headers.get("x-multi") == "a, b"
    assert "content-TYPE" in r.headers and r.reason == "OK"
    s.close()


def test_absent_reason_is_empty(svc):
    out = both(svc, lambda pkg: _send(pkg, svc.base + "/noreason"))
    assert plain(out["port"]) == plain(out["jax"])
    assert out["port"].status_line.reason_phrase == ""


@pytest.mark.parametrize("code", [301, 302, 303, 307, 308])
@pytest.mark.parametrize("method", ["POST", "PUT", "GET"])
def test_redirects_follow_as_requests_does(svc, code, method):
    payload = None if method == "GET" else {"v": code}
    out = both(svc, lambda pkg: _send(pkg, svc.base + f"/redirect/{code}",
                                      method, payload))
    assert plain(out["port"]) == plain(out["jax"])
    assert out["port"].status_code == 200 and len(svc.log) == 2


@pytest.mark.parametrize("tail", ["/echo?q=a b&x=é", "/echo?q=%7Efine%2F",
                                  "/ech%6F?v=[1]", "/echo?a=%zz&b=%41",
                                  "/echo?z=1#frag", "/echo?k=%e9|^"])
def test_urls_go_on_the_wire_as_requests_sends_them(svc, tail):
    """Unsafe characters quoted, escapes of unreserved ones decoded."""
    out = both(svc, lambda pkg: _send(pkg, svc.base + tail, "POST", {}))
    assert plain(out["port"]) == plain(out["jax"])
    assert out["port"].status_code == 200


def test_cross_host_redirect_leaves_authorization_behind(svc):
    def run(pkg):
        req = pkg.schema.HTTPRequestData(
            url=svc.base + "/cross_host", method="GET",
            headers=[pkg.schema.HeaderData("Authorization", "Bearer t"),
                     pkg.schema.HeaderData("X-Key", "k")])
        return pkg.clients.advanced_handler()(
            pkg.clients.shared_session.get(), req)

    out = both(svc, run)
    assert plain(out["port"]) == plain(out["jax"])
    assert out["port"].json_content()["auth"] is None
    assert [h for h in svc.log[1]["headers"] if h[0] == "X-Key"]


@pytest.mark.parametrize("url", ["notaurl", "ftp://127.0.0.1/x",
                                 "http://", "http://127.0.0.1:1/closed"])
def test_bad_urls_and_refused_connections_are_none(url):
    for pkg in PKGS.values():
        assert _send(pkg, url, "POST", {"x": 1}, timeout=2.0) is None


def test_socket_timeout_is_none(svc):
    for pkg in PKGS.values():
        t0 = time.perf_counter()
        assert _send(pkg, svc.base + "/slow", timeout=0.2) is None
        assert time.perf_counter() - t0 < 1.2


def test_idle_connection_closed_by_the_server_is_reopened(svc):
    """The server answers as kept-alive and then closes the socket; the
    next request from the same thread must not fail on the dead pooled
    connection (``requests`` reopens it too)."""
    def run(pkg):
        got = []
        for _ in range(4):
            got.append(_send(pkg, svc.base + "/close_idle"))
            time.sleep(0.05)      # the close lands while idle
        return got

    out = both(svc, run)
    assert [r.status_code for r in out["port"]] == [200] * 4
    assert [plain(r) for r in out["port"]] == [plain(r) for r in out["jax"]]
    # the port sees the dead socket before it sends (not by a failed send)
    clients = PKGS["port"].clients
    sess = clients.Session()
    sess.request("GET", svc.base + "/close_idle", timeout=10)
    conn = next(iter(sess._conns.values()))
    time.sleep(0.1)
    assert conn.sock is not None and clients._dropped(conn)
    assert sess.request("GET", svc.base + "/close_idle",
                        timeout=10).status_code == 200
    assert sess._conns[next(iter(sess._conns))] is not conn
    sess.close()


def test_port_keeps_one_connection_and_asks_no_gzip(svc):
    pkg = PKGS["port"]
    svc.reset()
    for i in range(5):
        assert _send(pkg, svc.base + "/echo", "POST", {"i": i}).status_code \
            == 200
    peers = {peer for _, peer in svc.raw}
    assert len(peers) == 1
    for headers, _ in svc.raw:
        assert "gzip" not in headers.get("Accept-Encoding", "")


# ---------------------------------------------------------------------------
# the port's client against the port's own shedding server


def _answer(ws, stop, delay):
    """A slow engine: one request at a time, echoed back."""
    while not stop.is_set():
        for c in ws.get_batch(1, timeout=0.05):
            time.sleep(delay)
            ws.reply_json(c.request_id,
                          {"echo": json.loads(c.request.entity.content)})


def _served(ws, code):
    from mmlspark_tpu_torch.serving import server as srv
    return sum(s.get() for labels, s in srv._M_REQUESTS.series()
               if labels["code"] == str(code))


@pytest.mark.parametrize("transport", ["threaded", "async"])
def test_client_rides_out_worker_server_shedding(transport):
    from mmlspark_tpu_torch.serving.server import WorkerServer
    http = PKGS["port"].http
    ws = WorkerServer(max_queue=2, shed_retry_after=0.05,
                      transport=transport)
    stop = threading.Event()
    worker = threading.Thread(target=_answer, args=(ws, stop, 0.01))
    worker.start()
    shed0 = _served(ws, 429)
    try:
        t = http.SimpleHTTPTransformer(
            input_col="input", output_col="val", concurrency=8,
            input_parser=http.JSONInputParser(url=ws.address))
        out = t.transform(_req_col(PKGS["port"], 24))
    finally:
        stop.set()
        worker.join(10)
        ws.close()
    assert [v["echo"]["x"] for v in out["val"]] == list(range(24))
    assert all(e is None for e in out["error"])
    assert _served(ws, 429) - shed0 > 0
