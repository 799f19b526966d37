"""Per-worker HTTP server with an epoch-keyed request queue (counterpart of
the threaded transport of ``serving/server.py:691-1567``).

Incoming requests park in a queue, are handed to the engine in batches
(:meth:`WorkerServer.get_batch`) and answered later through a routing
table (:meth:`reply`, :meth:`reply_json`, or an incremental
:meth:`reply_stream`). ``ThreadingHTTPServer`` runs one thread per
connection, parked on the request's event until its reply lands.

The wire contract is the reference's, byte for byte where a client can
see it (status lines, JSON bodies, ``text/event-stream`` SSE framing,
``/healthz``), so one client drives either package. Left out of this
port for now: the async transport, weighted-fair admission and load
shedding, the request journal, tracing, the model registry and the
debug routes.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..io.http.schema import (EntityData, HeaderData, HTTPRequestData,
                              HTTPResponseData, StatusLineData)

__all__ = ["CachedRequest", "StreamingReply", "WorkerServer"]

_STREAM_TIMEOUT_EVENT = b'data: {"error": "stream reply timeout"}\n\n'


class StreamingReply:
    """A reply delivered incrementally (Server-Sent Events by default).

    The transport writes ``200`` + the content type + ``Connection:
    close`` (no content length — the stream ends when the server closes
    it), then the chunks as they arrive. ``send`` and ``close`` are
    callable from any thread; sends after ``close`` are dropped."""

    _CLOSE = object()

    def __init__(self, content_type: str = "text/event-stream"):
        self.content_type = content_type
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False

    def send(self, data) -> None:
        if isinstance(data, str):
            data = data.encode("utf-8")
        with self._lock:
            if self._closed:
                return
            self._q.put(bytes(data))   # unbounded: never blocks

    def send_event(self, payload) -> None:
        """One SSE ``data:`` event carrying a JSON payload."""
        self.send(f"data: {json.dumps(payload)}\n\n")

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(StreamingReply._CLOSE)

    def _get(self, timeout: Optional[float]):
        """Blocking chunk fetch: bytes, the close sentinel, or None on
        timeout."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


@dataclass
class CachedRequest:
    """A parked exchange + its id."""
    request_id: str
    epoch: int
    request: HTTPRequestData
    _done: threading.Event = field(default_factory=threading.Event, repr=False)
    _response: Optional[object] = field(default=None, repr=False)

    def respond(self, response) -> None:
        self._response = response
        self._done.set()

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
        pass   # access lines are not logged by this port yet

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

    def _handle(self):
        ws: "WorkerServer" = self.server.worker_server  # type: ignore[attr-defined]
        try:
            body = self._read_body()
        except (ValueError, ConnectionError):
            self.send_response(400, "bad request body")
            self.send_header("Content-Length", "0")
            self.end_headers()
            self.close_connection = True
            return
        req = HTTPRequestData(
            url=self.path, method=self.command,
            headers=[HeaderData(k, v) for k, v in self.headers.items()],
            entity=EntityData(content=body, content_length=len(body)) if body else None)
        ctrl = ws._control_route(self.path)
        if ctrl is not None:
            try:
                resp = ctrl(req)
            except Exception as e:   # a control failure must not park
                resp = HTTPResponseData(
                    entity=EntityData.from_string(str(e)),
                    status_line=StatusLineData(status_code=500))
        else:
            resp = ws._enqueue(req).wait(ws.reply_timeout)
        if resp is None:
            self.send_response(504, "serving reply timeout")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if isinstance(resp, StreamingReply):
            self.send_response(200)
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Cache-Control", "no-store")
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
        self.send_response(resp.status_line.status_code,
                           resp.status_line.reason_phrase or None)
        sent = {h.name.lower() for h in resp.headers}
        for h in resp.headers:
            if h.name.lower() not in ("content-length", "connection"):
                self.send_header(h.name, h.value)
        if "content-type" not in sent and payload:
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        if payload:
            self.wfile.write(payload)

    do_GET = do_POST = do_PUT = do_DELETE = _handle


class WorkerServer:
    """HTTP listener + epoch request queue + reply routing table (the
    thread-per-connection transport). Binds and serves on construction;
    :meth:`close` stops it."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/", reply_timeout: float = 60.0):
        self.reply_timeout = reply_timeout
        self._closed = False
        #: path prefix → fn(HTTPRequestData) -> HTTPResponseData
        self.control_routes: Dict[str, object] = {
            "/healthz": self._healthz_route}
        #: request_id → CachedRequest
        self._routing: Dict[str, CachedRequest] = {}
        #: epoch → {request_id: CachedRequest}
        self._history: Dict[int, Dict[str, CachedRequest]] = {}
        self._epoch = 0
        self._next_id = 0
        self._started = time.monotonic()
        self._lock = threading.Lock()
        self._queue: "queue.Queue[CachedRequest]" = queue.Queue()
        self.host = host
        self.api_path = api_path
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.worker_server = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=f"serving-{self.port}",
                                        daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"

    def _control_route(self, path: str):
        for prefix, fn in self.control_routes.items():
            if path.startswith(prefix):
                return fn
        return None

    def _healthz_route(self, request: HTTPRequestData) -> HTTPResponseData:
        with self._lock:
            pending = len(self._routing)
            epoch = self._epoch
        body = {"status": "ok", "reasons": [], "transport": "threaded",
                "port": self.port, "queued": self._queue.qsize(),
                "pending": pending, "epoch": epoch,
                "uptime_seconds": round(time.monotonic() - self._started, 3)}
        return HTTPResponseData(
            headers=[HeaderData("Content-Type", "application/json")],
            entity=EntityData.from_string(json.dumps(body)),
            status_line=StatusLineData(status_code=200))

    def _enqueue(self, request: HTTPRequestData) -> CachedRequest:
        with self._lock:
            self._next_id += 1
            cached = CachedRequest(f"{self.port}-{self._next_id}",
                                   self._epoch, request)
            self._routing[cached.request_id] = cached
            self._history.setdefault(cached.epoch, {})[cached.request_id] = cached
        self._queue.put(cached)
        return cached

    # -- engine side --------------------------------------------------------
    def get_batch(self, max_rows: int, timeout: float = 0.1
                  ) -> List[CachedRequest]:
        """Drain up to ``max_rows`` parked requests (blocks up to
        ``timeout`` for the first; ``timeout=0`` does not block)."""
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
        with self._lock:
            cached = self._routing.pop(request_id, None)
            if cached is not None:
                self._history.get(cached.epoch, {}).pop(request_id, None)
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

    def commit_epoch(self) -> int:
        """Close the current epoch; fully answered epochs drop their
        history."""
        with self._lock:
            done = [e for e, reqs in self._history.items()
                    if e < self._epoch and not reqs]
            for e in done:
                del self._history[e]
            self._epoch += 1
            return self._epoch

    def pending_count(self) -> int:
        with self._lock:
            return len(self._routing)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
