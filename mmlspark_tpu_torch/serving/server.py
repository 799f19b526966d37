"""Per-worker HTTP server with an epoch-keyed request queue, a durable
journal and admission control (counterpart of ``serving/server.py``).

Incoming requests park in a queue, are handed to the engine in batches
(:meth:`WorkerServer.get_batch`) and answered later through a routing
table (:meth:`reply`, :meth:`reply_json`, or an incremental
:meth:`reply_stream`). Two transports carry them:

* ``transport="threaded"`` — ``ThreadingHTTPServer``, one thread per
  connection, parked on the request's event until its reply lands;
* ``transport="async"`` — one asyncio IO thread multiplexes every
  connection (keep-alive, chunked bodies, ``Expect: 100-continue``, SSE),
  replies crossing from the engine's threads by
  ``call_soon_threadsafe``: the shape for many concurrent connections.

The queue is the weighted-fair :class:`AdmissionQueue`: admission is
checked before any work is spent on a request (``X-Mmlspark-Tenant``
picks the budget), and a shed request gets ``429`` with a load-aware
``Retry-After`` no lower than ``shed_retry_after``.
``X-Mmlspark-Deadline`` caps how long a request is parked. With
``journal_path`` every request is journaled write-ahead
(:class:`ServingJournal`), answered ones are marked, and a restarted
server rehydrates its unanswered requests and live decode sessions
(``replayed_sessions``). ``/healthz`` and ``/metrics`` (Prometheus text)
are control routes that bypass the queue.

The wire contract is the reference's, byte for byte where a client can
see it (status lines, JSON bodies, ``text/event-stream`` SSE framing,
``/healthz``), so one client drives either package. Left out until
tracing is ported (ROADMAP.md queue item 11): the ``traceparent`` echo,
the SLO tracker, cost ledger, time-series sampler and watchdog hooks;
and, with the model registry (queue item 12), ``X-Mmlspark-Model``,
shadow mirrors, ``/models`` and the ``/debug/*`` routes.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import queue
import socket
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..io.http.schema import (EntityData, HeaderData, HTTPRequestData,
                              HTTPResponseData, StatusLineData)
from ..observability.events import log_event as _log_event
from ..observability.exposition import CONTENT_TYPE as _PROM_CONTENT_TYPE
from ..observability.exposition import render as _render_metrics
from ..observability.registry import counter as _metric_counter
from ..observability.registry import gauge as _metric_gauge
from ..observability.registry import histogram as _metric_histogram
from ..reliability.faults import get_injector as _get_injector
from ..reliability.policy import Deadline
from .admission import AdmissionQueue, TenantOverBudget

__all__ = ["CachedRequest", "Overloaded", "StreamingReply", "WorkerServer"]

_M_REQUESTS = _metric_counter(
    "mmlspark_serving_requests_total",
    "HTTP requests answered by the worker server",
    ("transport", "method", "code"))
_M_REQ_LATENCY = _metric_histogram(
    "mmlspark_serving_request_seconds",
    "End-to-end request latency: body read to reply written (streaming "
    "replies are observed at stream open)", ("transport",))
_M_QUEUE_DEPTH = _metric_gauge(
    "mmlspark_serving_queue_depth",
    "Requests parked in the epoch queue awaiting a dispatcher", ("port",))
_M_INFLIGHT = _metric_gauge(
    "mmlspark_serving_inflight_requests",
    "Requests accepted but not yet answered (routing-table size)",
    ("port",))
_M_SHED = _metric_counter(
    "mmlspark_requests_shed_total",
    "Requests rejected 429 by bounded-queue admission control")

_STREAM_TIMEOUT_EVENT = b'data: {"error": "stream reply timeout"}\n\n'


class Overloaded(RuntimeError):
    """The parked-request queue (or the tenant's share of it) is full:
    the transports answer ``429 Too Many Requests`` + ``Retry-After``."""

    def __init__(self, retry_after: float = 1.0):
        super().__init__("serving queue full")
        self.retry_after = retry_after


def _id_headers(cached: Optional["CachedRequest"]) -> List[Tuple[str, str]]:
    """The request id a queued request's reply carries (the handle
    ``reply`` keys on); the reference adds its ``traceparent`` here."""
    if cached is None:
        return []
    return [("X-Request-Id", cached.request_id)]


class StreamingReply:
    """A reply delivered incrementally (Server-Sent Events by default).

    The transport writes ``200`` + the content type + ``Connection:
    close`` (no content length — the stream ends when the server closes
    it), then the chunks as they arrive. ``send`` and ``close`` are
    callable from any thread; sends after ``close`` are dropped. Stream
    content is not journaled: the request is marked answered when the
    stream opens."""

    _CLOSE = object()

    def __init__(self, content_type: str = "text/event-stream"):
        self.content_type = content_type
        self._q: "queue.Queue" = queue.Queue()
        self._notify = None
        self._lock = threading.Lock()
        self._closed = False

    def send(self, data) -> None:
        if isinstance(data, str):
            data = data.encode("utf-8")
        with self._lock:
            if self._closed:
                return
            self._q.put(bytes(data))   # unbounded: never blocks
            notify = self._notify
        if notify is not None:
            notify()

    def send_event(self, payload) -> None:
        """One SSE ``data:`` event carrying a JSON payload."""
        self.send(f"data: {json.dumps(payload)}\n\n")

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(StreamingReply._CLOSE)
            notify = self._notify
        if notify is not None:
            notify()

    # -- transport side -----------------------------------------------------
    def _register(self, notify) -> None:
        """Async transport: ``notify()`` (thread-safe) fires whenever a
        chunk lands, and at once if chunks are already queued."""
        with self._lock:
            self._notify = notify
            pending = not self._q.empty()
        if pending:
            notify()

    def _get(self, timeout: Optional[float]):
        """Blocking chunk fetch (threaded transport): bytes, the close
        sentinel, or None on timeout."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _drain_nowait(self):
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out


@dataclass
class CachedRequest:
    """A parked exchange + its id."""
    request_id: str
    epoch: int
    request: HTTPRequestData
    #: rehydrated from the journal after a restart: the original
    #: connection is gone, the reply is journaled, not delivered
    replayed: bool = False
    #: remaining budget from ``X-Mmlspark-Deadline``: caps the park time
    deadline: Optional[Deadline] = field(default=None, repr=False)
    #: tenant from ``X-Mmlspark-Tenant`` (the admission budget it draws on)
    tenant: str = "default"
    _done: threading.Event = field(default_factory=threading.Event, repr=False)
    _response: Optional[object] = field(default=None, repr=False)
    _cbs: List[object] = field(default_factory=list, repr=False)
    _cb_lock: threading.Lock = field(default_factory=threading.Lock,
                                     repr=False)

    def respond(self, response) -> None:
        with self._cb_lock:
            self._response = response
            self._done.set()
            cbs = list(self._cbs)
            self._cbs.clear()
        for cb in cbs:
            cb(response)

    def add_done_callback(self, cb) -> None:
        """Fire ``cb(response)`` exactly once when the reply lands (at once
        if it already has): the async transport's bridge out of the
        engine's threads."""
        with self._cb_lock:
            if not self._done.is_set():
                self._cbs.append(cb)
                return
            response = self._response
        cb(response)

    def wait(self, timeout: Optional[float]):
        if self._done.wait(timeout):
            return self._response
        return None


class _Handler(BaseHTTPRequestHandler):
    server_version = "mmlspark-tpu-serving/1.0"
    protocol_version = "HTTP/1.1"
    # headers and body go out as separate sends; without TCP_NODELAY,
    # Nagle holds the body until the client's delayed ACK
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        # access lines and parse errors become DEBUG events
        try:
            line = fmt % args
        except Exception:
            line = fmt
        _log_event("http_access", level=logging.DEBUG,
                   client=self.client_address[0], line=line)

    def _read_body(self) -> bytes:
        te = (self.headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            chunks = []
            while True:
                size_line = self.rfile.readline(65536).strip()
                size = int(size_line.split(b";")[0] or b"0", 16)
                if size == 0:
                    while self.rfile.readline(65536) not in (b"\r\n", b"\n", b""):
                        pass  # trailers
                    break
                chunks.append(self.rfile.read(size))
                self.rfile.read(2)  # CRLF after each chunk
            return b"".join(chunks)
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _plain(self, code: int, reason: str, body: bytes = b"",
               headers=()) -> None:
        self.send_response(code, reason)
        for name, value in headers:
            self.send_header(name, value)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _handle(self):
        ws: "WorkerServer" = self.server.worker_server  # type: ignore[attr-defined]
        t0 = time.perf_counter()
        try:
            body = self._read_body()
        except (ValueError, ConnectionError):
            self._plain(400, "bad request body")
            self.close_connection = True
            ws._observe_request("threaded", self.command, 400,
                                time.perf_counter() - t0, path=self.path)
            return
        req = HTTPRequestData(
            url=self.path, method=self.command,
            headers=[HeaderData(k, v) for k, v in self.headers.items()],
            entity=EntityData(content=body, content_length=len(body)) if body else None)
        cached = None
        ctrl = ws._control_route(self.path)
        if ctrl is not None:
            try:
                resp = ctrl(req)
            except Exception as e:   # a control failure must not park
                resp = HTTPResponseData(
                    entity=EntityData.from_string(str(e)),
                    status_line=StatusLineData(status_code=500))
        else:
            try:
                cached = ws._enqueue(req)
            except Overloaded as e:
                self._plain(429, "overloaded",
                            headers=[("Retry-After", f"{e.retry_after:g}")])
                ws._observe_request("threaded", self.command, 429,
                                    time.perf_counter() - t0, path=self.path)
                return
            except Exception as e:
                # enqueue failure (journal append, injected fault)
                self._plain(500, "enqueue failed", str(e).encode())
                ws._observe_request("threaded", self.command, 500,
                                    time.perf_counter() - t0, path=self.path)
                return
            resp = cached.wait(ws.wait_budget(cached))
        if resp is None:
            self._plain(504, "serving reply timeout",
                        headers=_id_headers(cached))
            ws._observe_request("threaded", self.command, 504,
                                time.perf_counter() - t0, path=self.path)
            return
        if isinstance(resp, StreamingReply):
            ws._observe_request("threaded", self.command, 200,
                                time.perf_counter() - t0, path=self.path)
            self.send_response(200)
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Cache-Control", "no-store")
            for name, value in _id_headers(cached):
                self.send_header(name, value)
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            while True:
                chunk = resp._get(ws.reply_timeout)
                if chunk is StreamingReply._CLOSE:
                    break
                if chunk is None:
                    # a silently truncated 200 would read as a short
                    # successful stream: end with an explicit error event
                    resp.close()
                    chunk = _STREAM_TIMEOUT_EVENT
                try:
                    self.wfile.write(chunk)
                    self.wfile.flush()
                except (ConnectionError, BrokenPipeError):
                    break
                if chunk is _STREAM_TIMEOUT_EVENT:
                    break
            return
        payload = resp.entity.content if resp.entity else b""
        ws._observe_request("threaded", self.command,
                            resp.status_line.status_code,
                            time.perf_counter() - t0, path=self.path)
        self.send_response(resp.status_line.status_code,
                           resp.status_line.reason_phrase or None)
        sent = {h.name.lower() for h in resp.headers}
        for h in resp.headers:
            if h.name.lower() not in ("content-length", "connection"):
                self.send_header(h.name, h.value)
        for name, value in _id_headers(cached):
            if name.lower() not in sent:
                self.send_header(name, value)
        if "content-type" not in sent and payload:
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        if payload:
            self.wfile.write(payload)

    do_GET = do_POST = do_PUT = do_DELETE = _handle


class _AsyncHTTPServer:
    """Event-loop transport: every connection multiplexed on one asyncio
    IO thread; replies cross from the engine's threads via
    ``call_soon_threadsafe``. Control routes and the enqueue (which may
    fsync the journal) run in the loop's executor, never on the IO
    thread."""

    def __init__(self, ws: "WorkerServer", host: str, port: int):
        self._ws = ws
        self._host = host
        self._loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._server = None
        self._error: Optional[BaseException] = None
        self.port: Optional[int] = None
        self._thread = threading.Thread(target=self._run, args=(port,),
                                        name="serving-aio", daemon=True)
        self._thread.start()
        if not self._ready.wait(10):
            raise RuntimeError("async serving transport failed to start")
        if self._error is not None:     # e.g. EADDRINUSE: surface the cause
            raise self._error

    def _run(self, port: int) -> None:
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle_conn, self._host, port)
            self.port = self._server.sockets[0].getsockname()[1]

        try:
            self._loop.run_until_complete(boot())
        except BaseException as e:
            self._error = e
            self._loop.close()
            self._ready.set()
            return
        self._ready.set()
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    async def _read_request(self, reader, writer):
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            return None
        parts = line.decode("latin-1").rstrip("\r\n").split()
        if len(parts) < 2:
            return None
        method, path = parts[0], parts[1]
        headers, hmap = [], {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            if len(headers) >= 100:     # http.client's own header cap
                raise ValueError("got more than 100 headers")
            k, _, v = h.decode("latin-1").partition(":")
            k, v = k.strip(), v.strip()
            headers.append(HeaderData(k, v))
            hmap[k.lower()] = v
        if "100-continue" in hmap.get("expect", "").lower():
            # the client parks its body until the interim response
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        if "chunked" in hmap.get("transfer-encoding", "").lower():
            chunks = []
            while True:
                size_line = (await reader.readline()).strip()
                size = int(size_line.split(b";")[0] or b"0", 16)
                if size == 0:
                    while (await reader.readline()) not in (b"\r\n", b"\n",
                                                            b""):
                        pass    # trailers
                    break
                chunks.append(await reader.readexactly(size))
                await reader.readexactly(2)     # CRLF after each chunk
            body = b"".join(chunks)
        else:
            length = int(hmap.get("content-length") or 0)
            body = await reader.readexactly(length) if length else b""
        req = HTTPRequestData(
            url=path, method=method, headers=headers,
            entity=EntityData(content=body, content_length=len(body))
            if body else None)
        return req, hmap.get("connection", "").lower() == "close"

    @staticmethod
    def _render(resp: HTTPResponseData,
                extra_headers: List[Tuple[str, str]] = ()) -> bytes:
        """Status + headers + body in ONE buffer (a single send)."""
        payload = resp.entity.content if resp.entity else b""
        status = resp.status_line.status_code
        reason = (resp.status_line.reason_phrase or "").replace("\r", "") \
            .replace("\n", "")
        lines = [f"HTTP/1.1 {status} {reason}".rstrip().encode("latin-1")]
        sent = set()
        for h in resp.headers:
            if h.name.lower() not in ("content-length", "connection"):
                lines.append(f"{h.name}: {h.value}".encode("latin-1"))
                sent.add(h.name.lower())
        for name, value in extra_headers:
            if name.lower() not in sent:
                lines.append(f"{name}: {value}".encode("latin-1"))
        if "content-type" not in sent and payload:
            lines.append(b"Content-Type: application/json")
        lines.append(f"Content-Length: {len(payload)}".encode("latin-1"))
        lines.append(b"")
        return b"\r\n".join(lines) + b"\r\n" + payload

    async def _stream(self, writer, resp: StreamingReply,
                      echo: List[Tuple[str, str]]) -> None:
        """Write an SSE reply's preamble, then its chunks as they land;
        a stream silent past ``reply_timeout`` ends with an explicit
        error event (a truncated 200 would read as success)."""
        echo_raw = b"".join(f"{n}: {v}\r\n".encode("latin-1")
                            for n, v in echo)
        writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: "
                     + resp.content_type.encode("ascii")
                     + b"\r\nCache-Control: no-store\r\n" + echo_raw
                     + b"Connection: close\r\n\r\n")
        await writer.drain()
        ev = asyncio.Event()
        resp._register(lambda: self._loop.call_soon_threadsafe(ev.set))
        while True:
            try:
                await asyncio.wait_for(ev.wait(), self._ws.reply_timeout)
            except asyncio.TimeoutError:
                resp.close()
                writer.write(_STREAM_TIMEOUT_EVENT)
                await writer.drain()
                return
            ev.clear()
            for chunk in resp._drain_nowait():
                if chunk is StreamingReply._CLOSE:
                    await writer.drain()
                    return
                writer.write(chunk)
            await writer.drain()

    async def _answer(self, req: HTTPRequestData):
        """(response, the queued request or None) for one parsed
        request: a control route's answer, a shed or failed enqueue, the
        engine's reply, or a 504 once the wait budget runs out."""
        ws = self._ws
        ctrl = ws._control_route(req.url)
        if ctrl is not None:
            try:
                return await self._loop.run_in_executor(None, ctrl,
                                                        req), None
            except Exception as e:
                return HTTPResponseData(
                    entity=EntityData.from_string(str(e)),
                    status_line=StatusLineData(status_code=500)), None
        try:
            cached = await self._loop.run_in_executor(None, ws._enqueue, req)
        except Overloaded as e:
            return HTTPResponseData(
                headers=[HeaderData("Retry-After", f"{e.retry_after:g}")],
                status_line=StatusLineData(status_code=429,
                                           reason_phrase="overloaded")), None
        except Exception as e:
            return HTTPResponseData(
                entity=EntityData.from_string(str(e)),
                status_line=StatusLineData(status_code=500)), None
        fut = self._loop.create_future()

        def _cb(response, fut=fut):
            try:
                self._loop.call_soon_threadsafe(
                    lambda: None if fut.done() else fut.set_result(response))
            except RuntimeError:
                pass    # the loop closed (shutdown race): nowhere to go

        cached.add_done_callback(_cb)
        try:
            resp = await asyncio.wait_for(fut, ws.wait_budget(cached))
        except asyncio.TimeoutError:
            resp = HTTPResponseData(status_line=StatusLineData(
                status_code=504, reason_phrase="serving reply timeout"))
        return resp, cached

    async def _handle_conn(self, reader, writer):
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        ws = self._ws
        try:
            while True:
                try:
                    parsed = await self._read_request(reader, writer)
                except (ValueError, asyncio.LimitOverrunError):
                    # malformed framing: 400, as the threaded transport
                    writer.write(self._render(HTTPResponseData(
                        status_line=StatusLineData(
                            status_code=400,
                            reason_phrase="bad request body"))))
                    await writer.drain()
                    ws._observe_request("async", "?", 400, None)
                    break
                if parsed is None:
                    break
                req, close = parsed
                t0 = time.perf_counter()
                resp, cached = await self._answer(req)
                echo = _id_headers(cached)
                if isinstance(resp, StreamingReply):
                    ws._observe_request("async", req.method, 200,
                                        time.perf_counter() - t0,
                                        path=req.url)
                    await self._stream(writer, resp, echo)
                    break                      # a stream ends the connection
                ws._observe_request("async", req.method,
                                    resp.status_line.status_code,
                                    time.perf_counter() - t0, path=req.url)
                writer.write(self._render(resp, echo))
                await writer.drain()
                if close:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:   # teardown of an already-reset socket
                pass

    def close(self) -> None:
        def _stop():
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        self._loop.call_soon_threadsafe(_stop)
        self._thread.join(timeout=5)


class WorkerServer:
    """HTTP listener + epoch request queue + reply routing table. Binds
    and serves on construction; :meth:`close` stops it.

    ``max_queue`` bounds the parked requests (admission sheds past it, and
    a tenant past its weighted share first); ``shed_retry_after`` is the
    floor of the 429's ``Retry-After``; ``journal_path`` (with
    ``journal_fsync``) makes requests and epochs durable; ``transport``
    is ``"threaded"`` or ``"async"``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/", reply_timeout: float = 60.0,
                 max_queue: int = 10_000,
                 journal_path: Optional[str] = None,
                 journal_fsync: bool = True,
                 transport: str = "threaded",
                 shed_retry_after: float = 1.0):
        if transport not in ("threaded", "async"):
            # before the journal opens: failing after would leak its fd
            raise ValueError(f"unknown transport {transport!r} "
                             "(expected 'threaded' or 'async')")
        self.reply_timeout = reply_timeout
        #: Retry-After floor (seconds) of 429 shed responses
        self.shed_retry_after = shed_retry_after
        self._closed = False
        #: path prefix → fn(HTTPRequestData) -> HTTPResponseData, matched
        #: in insertion order (a later catch-all cannot shadow these)
        self.control_routes: Dict[str, object] = {
            "/healthz": self._healthz_route,
            "/metrics": self._metrics_route}
        #: request_id → CachedRequest
        self._routing: Dict[str, CachedRequest] = {}
        #: epoch → {request_id: CachedRequest}
        self._history: Dict[int, Dict[str, CachedRequest]] = {}
        self._epoch = 0
        self._started = time.monotonic()
        self._lock = threading.Lock()
        #: the durable epoch/request journal, or None
        self._journal = None
        pending = {}
        #: live decode sessions rehydrated from the journal at
        #: construction, for the engine's ``restore_session`` (cold: the
        #: pages died with the previous process)
        self.replayed_sessions: Dict[str, dict] = {}
        if journal_path is not None:
            from .journal import ServingJournal
            self._journal = ServingJournal(journal_path, fsync=journal_fsync)
            self._epoch, pending = self._journal.replay()
            self.replayed_sessions = self._journal.replay_sessions()
        # the queue holds every rehydrated request up front (no consumer
        # exists yet): a journal larger than max_queue must not deadlock
        self._queue = AdmissionQueue(max(max_queue, len(pending)))
        for rid, (epoch, request) in pending.items():
            cached = CachedRequest(rid, epoch, request, replayed=True)
            self._routing[rid] = cached
            self._history.setdefault(epoch, {})[rid] = cached
            # unconditional: already admitted in a previous life
            self._queue.put(cached)
        self.host = host
        self.api_path = api_path
        self._aio: Optional[_AsyncHTTPServer] = None
        self._httpd = None
        try:
            if transport == "async":
                self._aio = _AsyncHTTPServer(self, host, port)
                self.port = self._aio.port
            else:
                self._httpd = ThreadingHTTPServer((host, port), _Handler)
                self._httpd.daemon_threads = True
                self._httpd.worker_server = self  # type: ignore[attr-defined]
                self.port = self._httpd.server_address[1]
                self._thread = threading.Thread(
                    target=self._httpd.serve_forever,
                    name=f"serving-{self.port}", daemon=True)
                self._thread.start()
        except BaseException:
            if self._journal is not None:
                self._journal.close()
            raise
        _M_QUEUE_DEPTH.set_function(self._queue.qsize, port=str(self.port))
        _M_INFLIGHT.set_function(self.pending_count, port=str(self.port))

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"

    @property
    def transport(self) -> str:
        return "async" if self._aio is not None else "threaded"

    def _control_route(self, path: str):
        for prefix, fn in self.control_routes.items():
            if path.startswith(prefix):
                return fn
        return None

    # -- telemetry ----------------------------------------------------------
    def _observe_request(self, transport: str, method: Optional[str],
                         code: int, seconds: Optional[float],
                         path: Optional[str] = None) -> None:
        # "/_"-prefixed paths are internal cross-worker hops: counting
        # them would bill one logical request twice
        if path is not None and path.startswith("/_"):
            return
        _M_REQUESTS.inc(transport=transport, method=method or "?",
                        code=str(code))
        if seconds is not None:
            _M_REQ_LATENCY.observe(seconds, transport=transport)

    def _degraded_reasons(self) -> List[str]:
        """Soft-failure signals for /healthz (advisory: the answer stays
        200): a nearly full admission queue."""
        maxsize = self._queue.maxsize
        if maxsize > 0 and self._queue.qsize() >= 0.8 * maxsize:
            return [f"queue_pressure:{self._queue.qsize()}/{maxsize}"]
        return []

    def health_digest(self) -> Dict[str, object]:
        """Compact health fields: queue depth, in-flight count, the
        admission queue's state and the journal's digest."""
        return {"queue_depth": self._queue.qsize(),
                "in_flight": self.pending_count(),
                "degraded": bool(self._degraded_reasons()),
                "admission": self._queue.snapshot(),
                "journal": (self._journal.digest()
                            if self._journal is not None else None)}

    def _healthz_route(self, request: HTTPRequestData) -> HTTPResponseData:
        with self._lock:
            pending = len(self._routing)
            epoch = self._epoch
        reasons = self._degraded_reasons()
        body = {"status": "degraded" if reasons else "ok",
                "reasons": reasons, "transport": self.transport,
                "port": self.port, "queued": self._queue.qsize(),
                "pending": pending, "epoch": epoch,
                "uptime_seconds": round(time.monotonic() - self._started, 3)}
        return HTTPResponseData(
            headers=[HeaderData("Content-Type", "application/json")],
            entity=EntityData.from_string(json.dumps(body)),
            status_line=StatusLineData(status_code=200))

    def _metrics_route(self, request: HTTPRequestData) -> HTTPResponseData:
        # the Content-Type rides in resp.headers: the transports render
        # those, not the entity's content_type field
        return HTTPResponseData(
            headers=[HeaderData("Content-Type", _PROM_CONTENT_TYPE)],
            entity=EntityData.from_string(_render_metrics(),
                                          content_type=_PROM_CONTENT_TYPE),
            status_line=StatusLineData(status_code=200))

    # -- ingest -------------------------------------------------------------
    def _shed(self, tenant: str, reason: str,
              exc: Optional[BaseException] = None) -> Overloaded:
        _M_SHED.inc()
        # backlog over the measured drain rate, scaled up for a tenant
        # over its weighted budget; shed_retry_after is the floor
        retry_after = self._queue.suggest_retry_after(
            floor=self.shed_retry_after,
            tenant=tenant if isinstance(exc, TenantOverBudget) else None)
        _log_event("request_shed", port=self.port,
                   queued=self._queue.qsize(), tenant=tenant,
                   reason=reason, retry_after=retry_after)
        return Overloaded(retry_after)

    def _enqueue(self, request: HTTPRequestData) -> CachedRequest:
        deadline = None
        tenant = "default"
        for h in request.headers:
            name = h.name.lower()
            if name == "x-mmlspark-deadline":
                deadline = Deadline.from_header(h.value)
            elif name == "x-mmlspark-tenant":
                tenant = h.value.strip() or "default"
        # admission BEFORE any journal or routing work: a full queue sheds
        # everyone, a tenant over its share sheds that tenant first
        try:
            self._queue.check_admit(tenant)
        except TenantOverBudget as exc:
            raise self._shed(tenant, "tenant_budget", exc) from None
        except queue.Full as exc:
            raise self._shed(tenant, "queue_full", exc) from None
        injector = _get_injector()
        if injector.enabled:
            injector.fire("enqueue")
        with self._lock:
            cached = CachedRequest(os.urandom(16).hex(), self._epoch, request,
                                   deadline=deadline, tenant=tenant)
        # write-ahead, before the routing-table insert: a failed append
        # errors this request out without leaking a routing entry
        if self._journal is not None:
            self._journal.record_request(cached.request_id, cached.epoch,
                                         request)
        with self._lock:
            self._routing[cached.request_id] = cached
            self._history.setdefault(cached.epoch, {})[cached.request_id] = \
                cached
        try:
            self._queue.put_nowait(cached)
        except queue.Full as exc:
            # lost the admission race: undo the bookkeeping above
            with self._lock:
                self._routing.pop(cached.request_id, None)
                self._history.get(cached.epoch, {}).pop(cached.request_id,
                                                        None)
            if self._journal is not None:
                self._journal.record_reply(cached.request_id)
            reason = ("tenant_budget" if isinstance(exc, TenantOverBudget)
                      else "queue_full")
            raise self._shed(tenant, reason, exc) from None
        return cached

    def wait_budget(self, cached: CachedRequest) -> float:
        """How long a transport may park this request: ``reply_timeout``,
        clamped to the request's propagated deadline when it has one."""
        if cached.deadline is None:
            return self.reply_timeout
        return max(0.0, cached.deadline.cap(self.reply_timeout))

    # -- engine side --------------------------------------------------------
    def get_batch(self, max_rows: int, timeout: float = 0.1
                  ) -> List[CachedRequest]:
        """Drain up to ``max_rows`` parked requests in weighted-fair order
        (blocks up to ``timeout`` for the first; ``timeout=0`` does not
        block)."""
        out = []
        try:
            out.append(self._queue.get(timeout=timeout) if timeout > 0
                       else self._queue.get_nowait())
        except queue.Empty:
            return out
        while len(out) < max_rows:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return out

    def _take_answered(self, request_id: str) -> Optional[CachedRequest]:
        """Pop a parked request and mark it answered (routing table, epoch
        history, journal reply record) for every reply shape."""
        with self._lock:
            cached = self._routing.pop(request_id, None)
            if cached is not None:
                self._history.get(cached.epoch, {}).pop(request_id, None)
        if cached is not None and self._journal is not None:
            self._journal.record_reply(request_id)
        return cached

    def reply(self, request_id: str, response: HTTPResponseData) -> bool:
        """Route a response to the parked connection."""
        cached = self._take_answered(request_id)
        if cached is None:
            return False
        cached.respond(response)
        return True

    def reply_json(self, request_id: str, payload, status: int = 200) -> bool:
        ent = EntityData.from_string(json.dumps(payload))
        return self.reply(request_id, HTTPResponseData(
            entity=ent, status_line=StatusLineData(status_code=status)))

    def reply_stream(self, request_id: str,
                     content_type: str = "text/event-stream"
                     ) -> Optional[StreamingReply]:
        """Open an incremental (SSE) reply for a parked request; None when
        the request is unknown or already answered."""
        cached = self._take_answered(request_id)
        if cached is None:
            return None
        stream = StreamingReply(content_type)
        cached.respond(stream)
        return stream

    # -- epoch / replay -----------------------------------------------------
    def commit_epoch(self) -> int:
        """Close the current epoch; fully answered epochs drop their
        history, and the journal records the epoch and compacts."""
        with self._lock:
            done = [e for e, reqs in self._history.items()
                    if e < self._epoch and not reqs]
            for e in done:
                del self._history[e]
            self._epoch += 1
            epoch = self._epoch
        if self._journal is not None:
            self._journal.record_epoch(epoch)
            self._journal.maybe_compact(epoch)
        return epoch

    def replay_unanswered(self) -> int:
        """Re-enqueue every routed-but-unanswered request (what a restarted
        reader does). Returns how many were replayed."""
        # drain the live queue BEFORE the snapshot: a request arriving in
        # between would otherwise be drained and missing from it
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        with self._lock:
            pending = [c for c in self._routing.values()
                       if not c._done.is_set()]
        for c in pending:
            self._queue.put(c)
        return len(pending)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._routing)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        _M_QUEUE_DEPTH.remove(port=str(self.port))
        _M_INFLIGHT.remove(port=str(self.port))
        if self._aio is not None:
            self._aio.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
        if self._journal is not None:
            self._journal.close()
