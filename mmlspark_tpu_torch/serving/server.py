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
(``replayed_sessions``).

Every queued request opens one root span (``traceparent`` continues the
caller's trace; the reply echoes it with the root's own span id), and
its class (transport, route, model, tenant) feeds the SLO tracker and
the cost ledger. ``X-Mmlspark-Model`` resolves a ``name@version``
through the model registry at ingest, where the canary split and the
shadow mirror happen. Control routes bypass the queue: ``/healthz``
(degraded by a recent watchdog stall or a firing alert), ``/metrics``
(Prometheus text), ``/debug/traces``, ``/debug/slo``, ``/debug/costs``,
``/debug/scenario`` (the live progress of the load generator's
scenario, ``loadgen.progress``), ``/debug/timeseries``,
``/debug/profile`` (a ``torch.profiler`` capture into the watchdog's
diagnostic directory), ``/debug/registry`` and ``/models``.
``/healthz`` also names every peer whose circuit breaker is open.

The wire contract is the reference's, byte for byte where a client can
see it (status lines, JSON bodies, ``text/event-stream`` SSE framing,
``/healthz``), so one client drives either package.
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
from ..observability import (CONTENT_TYPE as _PROM_CONTENT_TYPE,
                             build_info as _build_info,
                             classify_route as _classify_route,
                             counter as _metric_counter,
                             gauge as _metric_gauge,
                             get_ledger as _get_ledger,
                             get_tracker as _get_tracker,
                             get_watchdog as _get_watchdog,
                             histogram as _metric_histogram,
                             log_event as _log_event,
                             process_uptime_seconds as _process_uptime,
                             register_hbm_gauges as _register_hbm_gauges,
                             render as _render_metrics)
from ..observability import tracing as _tracing
from ..observability.timeseries import (acquire_sampler as _acquire_sampler,
                                        get_alert_engine as _get_alert_engine,
                                        get_store as _get_ts_store,
                                        release_sampler as _release_sampler,
                                        render_sparklines as
                                        _render_sparklines)
from ..reliability.breaker import open_breakers as _open_breakers
from ..reliability.faults import get_injector as _get_injector
from ..reliability.lock_sanitizer import new_lock
from ..reliability.policy import Deadline
from .admission import AdmissionQueue, TenantOverBudget
from .registry import get_registry as _get_model_registry

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
# the object the watchdog registers per-device callbacks on: health_digest
# sums it without touching watchdog internals
_M_HBM_IN_USE = _metric_gauge(
    "mmlspark_device_hbm_bytes_in_use",
    "Device memory in use (memory_stats; backends without it expose "
    "nothing)", ("device",))
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


def _entity_bytes(response) -> Optional[bytes]:
    """Reply body bytes for the shadow diff (None for a streaming reply,
    whose content cannot be joined: the diff records its arrival only)."""
    entity = getattr(response, "entity", None)
    content = getattr(entity, "content", None)
    return content if isinstance(content, bytes) else None


def _trace_headers(cached: Optional["CachedRequest"]
                   ) -> List[Tuple[str, str]]:
    """What a queued request's reply carries: the request id (the handle
    ``reply`` keys on) and the W3C ``traceparent`` of its root span, so
    the caller can fetch the span tree from ``/debug/traces``."""
    if cached is None or cached.trace_span is None:
        return []
    return [("X-Request-Id", cached.request_id),
            ("traceparent", _tracing.format_traceparent(cached.trace_span))]


def _json_response(payload: object, status: int = 200) -> HTTPResponseData:
    """A JSON control-route reply."""
    return HTTPResponseData(
        headers=[HeaderData("Content-Type", "application/json")],
        entity=EntityData.from_string(json.dumps(payload)),
        status_line=StatusLineData(status_code=status))


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
        self._lock = new_lock("serving.server.StreamingReply._lock")
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
    #: root span of the request's trace; None for a replayed request (its
    #: caller's connection is gone) and for a shadow mirror
    trace_span: Optional[object] = field(default=None, repr=False)
    #: remaining budget from ``X-Mmlspark-Deadline``: caps the park time
    deadline: Optional[Deadline] = field(default=None, repr=False)
    #: tenant from ``X-Mmlspark-Tenant`` (the admission budget it draws on,
    #: and the SLO and cost class's tenant)
    tenant: str = "default"
    #: the ``name@version`` the registry resolved ``X-Mmlspark-Model`` to;
    #: None for an unversioned request
    model_label: Optional[str] = None
    #: a synthetic shadow mirror: never journaled; its reply goes to the
    #: registry's shadow join, not to a caller
    shadow: bool = False
    #: monotonic enqueue time: ``get_batch`` charges the ledger's
    #: ``queue_wait_seconds`` from it
    enqueued_at: float = field(default_factory=time.monotonic, repr=False)
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
        tspan = cached.trace_span if cached is not None else None
        if resp is None:
            if tspan is not None:
                tspan.end(status=504)
            self._plain(504, "serving reply timeout",
                        headers=_trace_headers(cached))
            ws._observe_request("threaded", self.command, 504,
                                time.perf_counter() - t0, path=self.path,
                                trace_span=tspan)
            return
        if isinstance(resp, StreamingReply):
            ws._observe_request("threaded", self.command, 200,
                                time.perf_counter() - t0, path=self.path,
                                trace_span=tspan)
            self.send_response(200)
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Cache-Control", "no-store")
            for name, value in _trace_headers(cached):
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
                            time.perf_counter() - t0, path=self.path,
                            trace_span=tspan)
        self.send_response(resp.status_line.status_code,
                           resp.status_line.reason_phrase or None)
        sent = {h.name.lower() for h in resp.headers}
        for h in resp.headers:
            if h.name.lower() not in ("content-length", "connection"):
                self.send_header(h.name, h.value)
        for name, value in _trace_headers(cached):
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
            if cached.trace_span is not None:
                cached.trace_span.end(status=504)
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
                tspan = cached.trace_span if cached is not None else None
                echo = _trace_headers(cached)
                if isinstance(resp, StreamingReply):
                    ws._observe_request("async", req.method, 200,
                                        time.perf_counter() - t0,
                                        path=req.url, trace_span=tspan)
                    await self._stream(writer, resp, echo)
                    break                      # a stream ends the connection
                ws._observe_request("async", req.method,
                                    resp.status_line.status_code,
                                    time.perf_counter() - t0, path=req.url,
                                    trace_span=tspan)
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
    a tenant past its weighted share first; the weights come live from the
    model registry, so a ``/models`` tenant edit applies without a
    restart); ``shed_retry_after`` is the floor of the 429's
    ``Retry-After``; ``journal_path`` (with ``journal_fsync``) makes
    requests and epochs durable; ``transport`` is ``"threaded"`` or
    ``"async"``."""

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
        #: in insertion order: the telemetry routes come first, so a later
        #: catch-all (the distributed forwarder's "/") cannot shadow them
        self.control_routes: Dict[str, object] = {
            "/healthz": self._healthz_route,
            "/metrics": self._metrics_route,
            "/debug/traces": self._debug_traces_route,
            "/debug/slo": self._debug_slo_route,
            "/debug/costs": self._debug_costs_route,
            "/debug/scenario": self._debug_scenario_route,
            "/debug/timeseries": self._debug_timeseries_route,
            "/debug/profile": self._debug_profile_route,
            "/debug/registry": self._debug_registry_route,
            "/models": self._models_route,
        }
        #: guards the single on-demand profiler capture slot
        self._profile_lock = threading.Lock()
        self._profile_active: Optional[dict] = None
        self._profile_thread: Optional[threading.Thread] = None
        #: request_id → CachedRequest
        self._routing: Dict[str, CachedRequest] = {}
        #: epoch → {request_id: CachedRequest}
        self._history: Dict[int, Dict[str, CachedRequest]] = {}
        self._epoch = 0
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
        self._queue = AdmissionQueue(
            max(max_queue, len(pending)),
            weight_fn=lambda t: _get_model_registry().tenant_weight(t))
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
        # idempotent: (re)stamps mmlspark_build_info, and registers the
        # memory gauges once CUDA is initialized (neither initializes it)
        _build_info()
        _register_hbm_gauges()
        # the time-series sampler is process-global and refcounted: one
        # scrape thread feeds one store however many servers run; close()
        # releases it. The per-port sources feed the queue-saturation
        # alert and the drain-rate history suggest_retry_after seeds its
        # EWMA from after an idle gap.
        self._ts_sampler = _acquire_sampler()
        self._ts_sampler.add_source(
            "mmlspark_queue_saturation", self._queue_saturation,
            port=str(self.port))
        self._ts_sampler.add_source(
            "mmlspark_queue_drain_rate",
            lambda: self._queue.drain_rate() or None, port=str(self.port))
        self._queue.history_key = str(self.port)

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
                         path: Optional[str] = None,
                         trace_span: Optional[object] = None) -> None:
        # "/_"-prefixed paths are internal cross-worker hops: counting
        # them would bill one logical request twice
        if path is not None and path.startswith("/_"):
            return
        _M_REQUESTS.inc(transport=transport, method=method or "?",
                        code=str(code))
        attrs = getattr(trace_span, "attrs", {}) if trace_span else {}
        # the same admission rule as requests_total, so the SLO
        # scorecard's totals reconcile against that counter exactly; a
        # registry-resolved request's model is its "name@version"
        _get_tracker().observe(transport=transport,
                               route=_classify_route(path),
                               model=attrs.get("model", "default"),
                               seconds=seconds, error=code >= 500,
                               tenant=attrs.get("tenant", "default"))
        if seconds is not None:
            # under an active span the histogram keeps the trace id as an
            # exemplar (when tracing.set_exemplars is on)
            with _tracing.activate(trace_span):
                _M_REQ_LATENCY.observe(seconds, transport=transport)

    #: a watchdog stall younger than this marks /healthz degraded
    STALL_DEGRADED_SECONDS = 60.0

    def _degraded_reasons(self) -> List[str]:
        """Soft-failure signals for /healthz (advisory: the answer stays
        200): open circuits to peers, a nearly full admission queue, a
        recent watchdog stall, or an alert rule in its firing state."""
        reasons = []
        for peer in _open_breakers():
            reasons.append(f"breaker_open:{peer}")
        maxsize = self._queue.maxsize
        if maxsize > 0 and self._queue.qsize() >= 0.8 * maxsize:
            reasons.append(
                f"queue_pressure:{self._queue.qsize()}/{maxsize}")
        age = _get_watchdog().last_stall_age()
        if age is not None and age <= self.STALL_DEGRADED_SECONDS:
            reasons.append(f"watchdog_stall:{round(age, 1)}s_ago")
        for rule in _get_alert_engine().firing():
            reasons.append(f"alert_firing:{rule}")
        return reasons

    def _queue_saturation(self) -> float:
        """Admission-queue fill fraction, sampled into the store each tick
        (the default queue-saturation alert reads this series)."""
        maxsize = self._queue.maxsize
        return self._queue.qsize() / maxsize if maxsize > 0 else 0.0

    def _hbm_bytes_in_use(self) -> Optional[float]:
        """Summed ``mmlspark_device_hbm_bytes_in_use`` across devices, or
        None before the watchdog's gauges register (CUDA not initialized).
        It rides the health digest because federation carries counters
        and histograms only."""
        rows = _M_HBM_IN_USE.series()
        if not rows:
            return None
        total = 0.0
        for _labels, series in rows:
            try:
                total += float(series.get())
            except Exception:
                return None
        return total

    def health_digest(self) -> Dict[str, object]:
        """Compact health fields the distributed heartbeat carries to the
        driver registry (serving/distributed.py): queue depth, in-flight
        count, the peers whose circuit breakers are open, the age of the
        last watchdog stall, device memory in use, the registry's
        versions, the admission queue's state and the journal's digest."""
        age = _get_watchdog().last_stall_age()
        return {"queue_depth": self._queue.qsize(),
                "in_flight": self.pending_count(),
                "open_breakers": sorted(_open_breakers()),
                "stall_age_seconds": None if age is None else round(age, 3),
                "hbm_bytes_in_use": self._hbm_bytes_in_use(),
                "degraded": bool(self._degraded_reasons()),
                "registry": _get_model_registry().digest(),
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
                "uptime_seconds": round(_process_uptime(), 3)}
        return _json_response(body)

    def _metrics_route(self, request: HTTPRequestData) -> HTTPResponseData:
        # the Content-Type rides in resp.headers: the transports render
        # those, not the entity's content_type field
        return HTTPResponseData(
            headers=[HeaderData("Content-Type", _PROM_CONTENT_TYPE)],
            entity=EntityData.from_string(_render_metrics(),
                                          content_type=_PROM_CONTENT_TYPE),
            status_line=StatusLineData(status_code=200))

    def _debug_traces_route(self, request: HTTPRequestData
                            ) -> HTTPResponseData:
        """``GET /debug/traces`` lists the flight recorder's summaries
        (newest first, slow-kept traces ahead of the ring);
        ``GET /debug/traces/{trace_id}`` returns one span tree, or Chrome
        trace JSON with ``?format=chrome``."""
        recorder = _tracing.get_flight_recorder()
        path, _, query = request.url.partition("?")
        trace_id = path[len("/debug/traces"):].strip("/")
        if not trace_id:
            return _json_response(
                {"slow_threshold_seconds": recorder.slow_threshold,
                 "traces": recorder.summaries()})
        trace = recorder.get(trace_id)
        if trace is None:
            return _json_response({"error": "unknown trace_id",
                                   "trace_id": trace_id}, 404)
        if "format=chrome" in query:
            return _json_response(trace.to_chrome())
        return _json_response(trace.to_dict())

    def _debug_slo_route(self, request: HTTPRequestData) -> HTTPResponseData:
        """``GET /debug/slo``: the rolling SLO scorecard of every workload
        class served, with the policy verdicts. Each render is harvested
        into the tuning observation store (skip with ``?harvest=0``)."""
        _, _, query = request.url.partition("?")
        card = _get_tracker().scorecard()
        if "harvest=0" not in query:
            # lazy: tuning imports observability
            from ..tuning.observations import harvest_scorecard
            card["harvested"] = harvest_scorecard(card)
        return _json_response(card)

    def _debug_timeseries_route(self, request: HTTPRequestData
                                ) -> HTTPResponseData:
        """``GET /debug/timeseries``: the process's metric history (per
        series, downsampled windows) and the alert engine's rule state.
        Query: ``seconds`` (trailing window, default 120), ``series``
        (comma-separated names), ``format=text`` (sparklines)."""
        _, _, query = request.url.partition("?")
        params: Dict[str, str] = {}
        for part in query.split("&"):
            key, _, value = part.partition("=")
            if key:
                params[key] = value
        try:
            seconds = float(params.get("seconds", "120"))
        except ValueError:
            seconds = 120.0
        names = ([n for n in params["series"].split(",") if n]
                 if params.get("series") else None)
        store = _get_ts_store()
        if params.get("format") == "text":
            return HTTPResponseData(
                headers=[HeaderData("Content-Type",
                                    "text/plain; charset=utf-8")],
                entity=EntityData.from_string(
                    _render_sparklines(store, seconds, names=names)),
                status_line=StatusLineData(status_code=200))
        engine = _get_alert_engine()
        payload = store.snapshot(seconds, names=names)
        payload["alerts"] = engine.state()
        payload["firing"] = engine.firing()
        return _json_response(payload)

    def _debug_costs_route(self, request: HTTPRequestData
                           ) -> HTTPResponseData:
        """``GET /debug/costs``: the cost ledger's per-class totals and its
        top-K heavy hitters (each joinable to ``/debug/traces/{id}``).
        Each render is harvested into the tuning observation store (skip
        with ``?harvest=0``)."""
        _, _, query = request.url.partition("?")
        snap = _get_ledger().snapshot()
        if "harvest=0" not in query:
            from ..tuning.observations import harvest_costs
            snap["harvested"] = harvest_costs(snap)
        return _json_response(snap)

    def _debug_scenario_route(self, request: HTTPRequestData
                              ) -> HTTPResponseData:
        """``GET /debug/scenario``: live progress of the scenario the
        loadgen harness is driving (sent/done/ok/shed/error counts and,
        once finished, the scorecard summary); the idle state when no
        scenario has run in this process."""
        # lazy: loadgen is a client of the serving plane, not a part of it
        from ..loadgen.progress import get_progress
        return _json_response(get_progress().snapshot())

    #: on-demand profiler capture length ceiling (seconds)
    MAX_PROFILE_SECONDS = 60.0

    def _debug_profile_route(self, request: HTTPRequestData
                             ) -> HTTPResponseData:
        """``GET /debug/profile?seconds=N``: capture a ``torch.profiler``
        trace of host and CUDA activity for N seconds (default 3, capped at
        :data:`MAX_PROFILE_SECONDS`) into a fresh directory under the
        watchdog's diagnostic dir (``<log_dir>/trace.json``, Chrome trace
        format). The capture runs on a background thread and the reply
        returns at once with ``log_dir``; a second request while one runs
        gets 409."""
        _, _, query = request.url.partition("?")
        seconds = 3.0
        for part in query.split("&"):
            if part.startswith("seconds="):
                try:
                    seconds = float(part[len("seconds="):])
                except ValueError:
                    return _json_response({"error": "bad seconds value"},
                                          400)
        seconds = min(max(seconds, 0.05), self.MAX_PROFILE_SECONDS)
        log_dir = os.path.join(_get_watchdog().diag_dir(),
                               f"profile_{self.port}_{int(time.time())}")
        with self._profile_lock:
            if self._profile_active is not None:
                return _json_response(
                    {"error": "profile capture already active",
                     **self._profile_active}, 409)
            self._profile_active = {"log_dir": log_dir, "seconds": seconds}

        def _capture() -> None:
            # lazy: the profiler imports torch, which a server serving a
            # host-only pipeline need not pay for at construction
            from ..utils import profiling as _profiling
            try:
                with _profiling.trace(log_dir):
                    time.sleep(seconds)
                _log_event("profile_captured", log_dir=log_dir,
                           seconds=seconds, port=self.port)
            except Exception as exc:
                # the endpoint never takes the worker down
                _log_event("profile_failed", level=logging.WARNING,
                           log_dir=log_dir, error=repr(exc))
            finally:
                with self._profile_lock:
                    self._profile_active = None

        os.makedirs(log_dir, exist_ok=True)
        t = threading.Thread(target=_capture, name="mmlspark-profile",
                             daemon=True)
        self._profile_thread = t
        t.start()
        return _json_response({"started": True, "log_dir": log_dir,
                               "seconds": seconds})

    def _models_route(self, request: HTTPRequestData) -> HTTPResponseData:
        """``GET /models``: the registry's snapshot; ``POST /models``: an
        admin action as a JSON body (load, promote, rollback, retire or
        unload, tenant, check). An HTTP load is declarative: an engine
        registers a version's handle and warm-up through
        :meth:`ServingEngine.register_model`."""
        registry = _get_model_registry()
        if (request.method or "GET").upper() != "POST":
            return _json_response(registry.snapshot())
        try:
            req_body = (json.loads(request.entity.string_content())
                        if request.entity else {})
        except ValueError:
            return _json_response({"error": "invalid JSON body"}, 400)
        action = str(req_body.get("action", "")).lower()
        try:
            if action == "load":
                mv = registry.load(
                    req_body["name"], req_body["version"],
                    canary_percent=float(req_body.get("canary_percent",
                                                      0.0)),
                    shadow_percent=float(req_body.get("shadow_percent",
                                                      0.0)),
                    block=bool(req_body.get("block", True)))
                return _json_response({"loaded": mv.snapshot()})
            if action == "promote":
                mv = registry.promote(req_body["name"], req_body["version"])
                return _json_response({"promoted": mv.snapshot()})
            if action == "rollback":
                mv = registry.rollback(req_body["name"],
                                       req_body.get("version"),
                                       reason=str(req_body.get(
                                           "reason", "manual")))
                return _json_response({"rolled_back":
                                       mv.snapshot() if mv else None})
            if action in ("retire", "unload"):
                return _json_response(registry.retire(
                    req_body["name"], req_body["version"],
                    drain_timeout=float(req_body.get("drain_timeout",
                                                     5.0))))
            if action == "tenant":
                registry.set_tenant(req_body["tenant"],
                                    float(req_body["weight"]))
                return _json_response({"tenants": registry.tenants()})
            if action == "check":
                return _json_response({"verdicts":
                                       registry.check_canaries()})
        except KeyError as exc:
            return _json_response({"error": f"missing field: {exc}"}, 400)
        except ValueError as exc:
            return _json_response({"error": str(exc)}, 400)
        return _json_response({"error": f"unknown action {action!r}"}, 400)

    def _debug_registry_route(self, request: HTTPRequestData
                              ) -> HTTPResponseData:
        """``GET /debug/registry``: the rollout state (versions, canary
        verdicts, shadow diffs, tenant weights) and this worker's
        admission snapshot."""
        registry = _get_model_registry()
        return _json_response({"registry": registry.snapshot(),
                               "canary_verdicts": registry.check_canaries(),
                               "admission": self._queue.snapshot()})

    # -- ingest -------------------------------------------------------------
    def _shed(self, tenant: str, reason: str,
              exc: Optional[BaseException] = None) -> Overloaded:
        _M_SHED.inc()
        _get_tracker().shed(transport=self.transport, route="api",
                            tenant=tenant)
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
        # headers first: the tenant picks the admission budget and the
        # model header the registry version that serves
        traceparent = deadline = model_name = None
        tenant = "default"
        for h in request.headers:
            name = h.name.lower()
            if name == "traceparent":
                traceparent = h.value
            elif name == "x-mmlspark-deadline":
                deadline = Deadline.from_header(h.value)
            elif name == "x-mmlspark-tenant":
                # free-form, but the SLO tracker and the cost ledger
                # collapse classes past MAX_CLASSES into "other"
                tenant = h.value.strip() or "default"
            elif name == "x-mmlspark-model":
                model_name = h.value.strip() or None
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
        # one root span per logical request, minted where every ingest
        # shape funnels through; the canary/shadow split happens here too,
        # and the resolved "name@version" rides the root's model attribute
        # so SLO windows and ledger classes tell candidate from incumbent
        request_id = _tracing.new_request_id()
        registry = _get_model_registry()
        resolution = None
        span_extra = {}
        if model_name is not None:
            resolution = registry.resolve(model_name, request_id)
            span_extra["model"] = resolution.label
        root = _tracing.start_trace(
            "server.request", traceparent=traceparent,
            request_id=request_id, method=request.method, url=request.url,
            route=_classify_route(request.url), tenant=tenant,
            transport=self.transport, **span_extra)
        with self._lock:
            cached = CachedRequest(
                request_id, self._epoch, request, trace_span=root,
                deadline=deadline, tenant=tenant,
                model_label=resolution.label if resolution else None)
        # write-ahead, before the routing-table insert: a failed append
        # errors this request out without leaking a routing entry
        if self._journal is not None:
            self._journal.record_request(cached.request_id, cached.epoch,
                                         request, trace_id=root.trace_id)
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
            if resolution is not None:
                registry.note_done(resolution.label)
                if resolution.shadow is not None:
                    registry.note_done(resolution.shadow)
            root.end(status=429)
            reason = ("tenant_budget" if isinstance(exc, TenantOverBudget)
                      else "queue_full")
            raise self._shed(tenant, reason, exc) from None
        if resolution is not None and resolution.shadow is not None:
            self._mirror_shadow(cached, resolution.shadow)
        return cached

    def _mirror_shadow(self, primary: CachedRequest,
                       shadow_label: str) -> None:
        """Mirror an admitted request to the shadow version: a synthetic
        request through the same queue and engine that is never journaled
        and never answers a caller; both replies land in the registry's
        shadow join, which diffs them."""
        registry = _get_model_registry()
        shadow_id = _tracing.new_request_id()
        cached = CachedRequest(shadow_id, primary.epoch, primary.request,
                               tenant=primary.tenant,
                               model_label=shadow_label, shadow=True)
        with self._lock:
            self._routing[shadow_id] = cached
            self._history.setdefault(cached.epoch, {})[shadow_id] = cached
        try:
            # best effort: a full queue drops the mirror, never the primary
            self._queue.put_nowait(cached)
        except queue.Full:
            with self._lock:
                self._routing.pop(shadow_id, None)
                self._history.get(cached.epoch, {}).pop(shadow_id, None)
            registry.note_done(shadow_label)
            return
        trace_id = (primary.trace_span.trace.trace_id
                    if primary.trace_span is not None else None)
        registry.shadow_begin(primary.request_id, shadow_id, shadow_label,
                              trace_id=trace_id)
        primary.add_done_callback(
            lambda resp: registry.shadow_result(
                primary.request_id, _entity_bytes(resp), from_shadow=False))
        cached.add_done_callback(
            lambda resp: registry.shadow_result(
                primary.request_id, _entity_bytes(resp), from_shadow=True))

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
        self._charge_queue_wait(out)
        return out

    def _charge_queue_wait(self, batch) -> None:
        """Bill each dequeued request's park time to its own class: the
        ledger's ``queue_wait_seconds`` charge site."""
        ledger = _get_ledger()
        now = time.monotonic()
        for cached in batch:
            span = cached.trace_span
            cls = tid = None
            if span is not None:
                attrs = span.attrs
                cls = (str(attrs.get("transport", "untraced")),
                       str(attrs.get("route", "api")),
                       str(attrs.get("model", "default")),
                       str(attrs.get("tenant", "default")))
                tid = span.trace.trace_id
            ledger.charge("queue_wait_seconds",
                          now - cached.enqueued_at, cls=cls, trace_id=tid)

    def _take_answered(self, request_id: str) -> Optional[CachedRequest]:
        """Pop a parked request and mark it answered (routing table, epoch
        history, journal reply record) for every reply shape."""
        with self._lock:
            cached = self._routing.pop(request_id, None)
            if cached is not None:
                self._history.get(cached.epoch, {}).pop(request_id, None)
        if cached is not None:
            if cached.model_label is not None:
                # in-flight accounting: retire()'s drain barrier opens once
                # every resolved request of a version has answered
                _get_model_registry().note_done(cached.model_label)
            # a shadow mirror was never journaled: a reply record for it
            # would orphan the journal's pairing
            if self._journal is not None and not cached.shadow:
                self._journal.record_reply(request_id)
        return cached

    def trace_span(self, request_id: str):
        """Root span of a still-parked request (None when unknown, answered
        or untraced): the engine activates it to attach its spans."""
        with self._lock:
            cached = self._routing.get(request_id)
        return cached.trace_span if cached is not None else None

    def model_label(self, request_id: str) -> Optional[str]:
        """The ``name@version`` of a still-parked request (None when
        unknown or unversioned): an engine groups a drained batch by it."""
        with self._lock:
            cached = self._routing.get(request_id)
        return cached.model_label if cached is not None else None

    def reply(self, request_id: str, response: HTTPResponseData) -> bool:
        """Route a response to the parked connection."""
        cached = self._take_answered(request_id)
        if cached is None:
            return False
        if cached.trace_span is not None:
            # idempotent (a 504 may have ended it); ending the root hands
            # the trace to the flight recorder
            cached.trace_span.end(status=response.status_line.status_code)
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
        if cached.trace_span is not None:
            # the trace covers accept to stream open; chunk timing belongs
            # to the stream, which may outlive the span tree
            cached.trace_span.end(status=200, streaming=True)
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
        t = self._profile_thread
        if t is not None and t.is_alive():
            # bounded: a capture is at most MAX_PROFILE_SECONDS of sleep
            # plus the export; tearing down mid-export crashes the profiler
            t.join(timeout=self.MAX_PROFILE_SECONDS + 10.0)
        _M_QUEUE_DEPTH.remove(port=str(self.port))
        _M_INFLIGHT.remove(port=str(self.port))
        # drop this port's sampler sources, then release the refcounted
        # sampler (its thread stops with the last server); None'd so a
        # second close() cannot over-release
        if self._ts_sampler is not None:
            self._ts_sampler.remove_source("mmlspark_queue_saturation",
                                           port=str(self.port))
            self._ts_sampler.remove_source("mmlspark_queue_drain_rate",
                                           port=str(self.port))
            self._ts_sampler = None
            _release_sampler()
        if self._aio is not None:
            self._aio.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
        if self._journal is not None:
            self._journal.close()
