"""Pooled + async HTTP clients with the reference's retry ladder, on the
standard library.

Counterpart of ``mmlspark_tpu/io/http/clients.py``, which sends through
``requests``. The port's transport is ``http.client``: each thread keeps
one keep-alive connection per (scheme, host, port) in place of the
thread-local ``requests.Session``. What callers see is what ``requests``
gives them:

* repeated response headers merge with ", " and header lookups ignore
  case; ``reason`` is "" when the status line has none;
* a reused connection that the server closed while idle is reopened
  before the request is sent;
* redirects are followed as ``requests`` follows them (303, and 301/302
  of anything but HEAD, turn into a body-less GET; ``Authorization``
  stays behind when the host changes);
* no ``Accept-Encoding: gzip`` is sent, so bodies arrive as sent;
* socket timeouts, refused connections and malformed URLs raise
  ``OSError`` / ``http.client.HTTPException`` / ``ValueError``, which
  ``advanced_handler`` turns into ``None`` (a per-row error) as the JAX
  package turns ``requests.RequestException``.

No cookie jar, proxy variables or ``.netrc`` are read (ROADMAP §3).

The ladder of ``send_with_retries`` is the JAX package's
(``HTTPClients.scala:75-125``): 200/201/202/400 return, a 429 sleeps for
``Retry-After`` and spends no retry, anything else spends one entry of
the backoff ladder (default 100/500/1000 ms).
"""

from __future__ import annotations

import http.client
import re
import select
import ssl
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple
from urllib.parse import quote, urljoin, urlsplit

from ...utils.async_utils import map_buffered
from .schema import (EntityData, HeaderData, HTTPRequestData,
                     HTTPResponseData, StatusLineData)

__all__ = ["send_with_retries", "advanced_handler", "basic_handler",
           "SingleThreadedHTTPClient", "AsyncHTTPClient", "shared_session",
           "post_json_batches"]

DEFAULT_BACKOFFS_MS = (100, 500, 1000)

#: what a failed exchange raises (``requests.RequestException``'s place)
TRANSPORT_ERRORS = (http.client.HTTPException, OSError, ValueError)

_MAX_REDIRECTS = 30            # requests.models.DEFAULT_REDIRECT_LIMIT
_REDIRECTS = (301, 302, 303, 307, 308)
_UNRESERVED = frozenset("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
                        "0123456789-._~")


class Headers:
    """Response headers: insertion-ordered, case-insensitive lookups, a
    repeated name merged into one value joined by ", " (the first
    spelling of the name kept), as ``requests``' ``resp.headers``."""

    def __init__(self, pairs: Iterable[Tuple[str, str]] = ()):
        self._items: Dict[str, Tuple[str, str]] = {}
        for k, v in pairs:
            low = k.lower()
            if low in self._items:
                name, old = self._items[low]
                self._items[low] = (name, f"{old}, {v}")
            else:
                self._items[low] = (k, v)

    def get(self, name: str, default=None):
        hit = self._items.get(name.lower())
        return default if hit is None else hit[1]

    def __getitem__(self, name: str) -> str:
        return self._items[name.lower()][1]

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name.lower() in self._items

    def __iter__(self):
        return (k for k, _ in self._items.values())

    def __len__(self) -> int:
        return len(self._items)

    def items(self) -> List[Tuple[str, str]]:
        return list(self._items.values())


class Response:
    """One answered exchange: ``status_code``, ``reason``, ``headers``
    (:class:`Headers`) and ``content`` (the body bytes)."""

    __slots__ = ("status_code", "reason", "headers", "content")

    def __init__(self, status_code: int, reason: str, headers: Headers,
                 content: bytes):
        self.status_code = status_code
        self.reason = reason
        self.headers = headers
        self.content = content


_PATH_OK = _UNRESERVED | frozenset("!$&'()*+,;=:@/")
_QUERY_OK = _PATH_OK | {"?"}
_PERCENT = re.compile(r"%[a-fA-F0-9]{2}")


def _encode_invalid(part: str, allowed: frozenset) -> str:
    """urllib3's ``_encode_invalid_chars`` (what ``requests``' URL parse
    does to the path and the query): existing escapes upper-cased and
    kept when every ``%`` is one, any other byte outside ``allowed``
    percent-encoded from its UTF-8 form."""
    part, n = _PERCENT.subn(lambda m: m.group(0).upper(), part)
    raw = part.encode("utf-8", "surrogatepass")
    keep_percent = n == raw.count(b"%")
    out = bytearray()
    for b in raw:
        if (keep_percent and b == 0x25) or (b < 128 and chr(b) in allowed):
            out.append(b)
        else:
            out += b"%%%02X" % b
    return out.decode("ascii")


def _requote(part: str) -> str:
    """``requests.utils.requote_uri``: decode escapes of unreserved
    characters, then quote whatever is left unsafe."""
    pieces = part.split("%")
    for i in range(1, len(pieces)):
        h = pieces[i][:2]
        if len(h) == 2 and all(c in "0123456789abcdefABCDEF" for c in h) \
                and chr(int(h, 16)) in _UNRESERVED:
            pieces[i] = chr(int(h, 16)) + pieces[i][2:]
        else:
            pieces[i] = "%" + pieces[i]
    return quote("".join(pieces), safe="!#$%&'()*+,/:;=?@[]~")


def _target(url: str) -> Tuple[Tuple[str, str, int], str]:
    """(scheme, host, port) and the request target of an absolute URL,
    its path and query on the wire as ``requests`` sends them (the
    fragment stays behind); raises ``http.client.InvalidURL`` for
    anything else."""
    parts = urlsplit(url)
    scheme = parts.scheme.lower()
    if scheme not in ("http", "https") or not parts.hostname:
        raise http.client.InvalidURL(f"not an absolute http(s) URL: {url!r}")
    port = parts.port or (443 if scheme == "https" else 80)
    path = _requote(_encode_invalid(parts.path or "/", _PATH_OK))
    if parts.query:
        path += "?" + _requote(_encode_invalid(parts.query, _QUERY_OK))
    return (scheme, parts.hostname, port), path


def _dropped(conn: http.client.HTTPConnection) -> bool:
    """True when an idle kept-alive connection's socket is readable: the
    server closed it (EOF) or sent bytes nobody asked for. Either way it
    cannot carry the next request."""
    sock = conn.sock
    if sock is None:
        return False
    try:
        poller = select.poll()
        poller.register(sock, select.POLLIN)
        return bool(poller.poll(0))
    except (OSError, ValueError):
        return True


class Session:
    """The keep-alive connections of one thread, one per (scheme, host,
    port); not thread-safe (``shared_session`` gives each thread its
    own). ``request`` has ``requests.Session.request``'s keywords."""

    def __init__(self):
        self._conns: Dict[Tuple[str, str, int], http.client.HTTPConnection] = {}
        self._ssl: Optional[ssl.SSLContext] = None

    def _connection(self, key, timeout):
        conn = self._conns.get(key)
        if conn is not None and _dropped(conn):
            conn.close()
            conn = None
        if conn is None:
            scheme, host, port = key
            if scheme == "https":
                if self._ssl is None:
                    self._ssl = ssl.create_default_context()
                conn = http.client.HTTPSConnection(host, port, timeout=timeout,
                                                   context=self._ssl)
            else:
                conn = http.client.HTTPConnection(host, port, timeout=timeout)
            self._conns[key] = conn
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    def _drop(self, key) -> None:
        conn = self._conns.pop(key, None)
        if conn is not None:
            conn.close()

    def _exchange(self, method: str, url: str, headers: Dict[str, str],
                  body: Optional[bytes], timeout) -> Response:
        key, path = _target(url)
        conn = self._connection(key, timeout)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            content = resp.read()
        except BaseException:
            # the connection's state is unknown: never reuse it
            self._drop(key)
            raise
        if resp.will_close:
            self._drop(key)
        return Response(resp.status, resp.reason or "",
                        Headers(resp.getheaders()), content)

    def request(self, method: str, url: str, headers=None, data=None,
                timeout: Optional[float] = None) -> Response:
        headers = dict(headers or {})
        body = data.encode("utf-8") if isinstance(data, str) else data
        method = method.upper()
        for _ in range(_MAX_REDIRECTS + 1):
            resp = self._exchange(method, url, headers, body or None, timeout)
            loc = resp.headers.get("Location")
            if resp.status_code not in _REDIRECTS or loc is None:
                return resp
            new = urljoin(url, loc)
            if urlsplit(new).hostname != urlsplit(url).hostname:
                # requests' should_strip_auth: credentials stay behind
                for h in [h for h in headers if h.lower() == "authorization"]:
                    del headers[h]
            url, code = new, resp.status_code
            # requests' rebuild_method, then its purge: only 307/308
            # resend the body
            if (code in (302, 303) and method != "HEAD") or \
                    (code == 301 and method == "POST"):
                method = "GET"
            if code not in (307, 308):
                body = None
                for h in [h for h in headers if h.lower() in (
                        "content-length", "content-type",
                        "transfer-encoding")]:
                    del headers[h]
        raise http.client.HTTPException(
            f"exceeded {_MAX_REDIRECTS} redirects")

    def close(self) -> None:
        for key in list(self._conns):
            self._drop(key)


class _ThreadLocalSession:
    """One :class:`Session` per thread (the JAX package's per-thread
    ``requests.Session``; the reference shares one client per JVM)."""

    def __init__(self):
        self._local = threading.local()

    def get(self) -> Session:
        s = getattr(self._local, "session", None)
        if s is None:
            s = Session()
            self._local.session = s
        return s


#: per-process pooled sessions (reference: SharedVariable[CloseableHttpClient])
shared_session = _ThreadLocalSession()


def _to_response(resp: Response) -> HTTPResponseData:
    headers = [HeaderData(k, v) for k, v in resp.headers.items()]
    ct = resp.headers.get("Content-Type")
    entity = EntityData(
        content=resp.content or b"",
        content_length=len(resp.content or b""),
        content_type=HeaderData("Content-Type", ct) if ct else None)
    return HTTPResponseData(
        headers=headers, entity=entity,
        status_line=StatusLineData("HTTP/1.1", resp.status_code, resp.reason or ""))


def _execute(session: Session, request: HTTPRequestData,
             timeout: float) -> Response:
    body = request.entity.content if request.entity else None
    return session.request(request.method, request.url,
                           headers=request.header_map(), data=body,
                           timeout=timeout)


def send_with_retries(session: Session, request: HTTPRequestData,
                      backoffs_ms: Iterable[int] = DEFAULT_BACKOFFS_MS,
                      timeout: float = 60.0) -> HTTPResponseData:
    """Reference semantics of ``HandlingUtils.sendWithRetries:75-125``."""
    retries: List[int] = list(backoffs_ms)
    # reference-parity retry ladder: fixed backoff list, Retry-After
    # honored, 429 doesn't consume a retry
    while True:
        resp = _execute(session, request, timeout)
        code = resp.status_code
        if code in (200, 201, 202, 400):
            return _to_response(resp)
        if code == 429:
            retry_after = resp.headers.get("Retry-After")
            if retry_after is not None:
                try:
                    time.sleep(float(retry_after))
                except ValueError:
                    pass
            # rate limiting does not consume a retry (reference :115-118)
            if not retries:
                return _to_response(resp)
            time.sleep(retries[0] / 1000.0)
            continue
        if not retries:
            return _to_response(resp)
        time.sleep(retries.pop(0) / 1000.0)


def advanced_handler(*backoffs_ms: int, timeout: float = 60.0
                     ) -> Callable[[Session, HTTPRequestData],
                                   Optional[HTTPResponseData]]:
    """``HandlingUtils.advanced`` — retries; timeout → None (``:126-144``)."""
    ladder = backoffs_ms or DEFAULT_BACKOFFS_MS

    def handle(session, request):
        try:
            return send_with_retries(session, request, ladder, timeout)
        except TRANSPORT_ERRORS:
            # any transport-level failure (timeout, refused connection,
            # malformed URL, ...) becomes a per-row error, never a
            # whole-transform crash
            return None

    return handle


def basic_handler(session: Session,
                  request: HTTPRequestData) -> HTTPResponseData:
    """``HandlingUtils.basic`` — one shot, no retries (``:147-152``)."""
    return _to_response(_execute(session, request, 60.0))


class SingleThreadedHTTPClient:
    """Sequential client (reference ``SingleThreadedHTTPClient``)."""

    def __init__(self, handler=None, timeout: float = 60.0):
        self.handler = handler or advanced_handler(timeout=timeout)

    def send(self, requests_it: Iterable[Optional[HTTPRequestData]]
             ) -> Iterator[Optional[HTTPResponseData]]:
        session = shared_session.get()
        for req in requests_it:
            yield None if req is None else self.handler(session, req)


class AsyncHTTPClient:
    """Bounded-concurrency client: ≤ ``concurrency`` requests in flight,
    results yielded in submission order (reference ``AsyncClient`` +
    ``AsyncUtils.bufferedAwait``, ``Clients.scala:48-62``)."""

    def __init__(self, concurrency: int, handler=None, timeout: float = 60.0):
        if concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        self.concurrency = concurrency
        self.handler = handler or advanced_handler(timeout=timeout)

    def send(self, requests_it: Iterable[Optional[HTTPRequestData]]
             ) -> Iterator[Optional[HTTPResponseData]]:
        def one(req):
            # resolve the session inside the worker thread: sessions are
            # thread-local, not process-global
            return None if req is None else self.handler(shared_session.get(), req)

        yield from map_buffered(one, requests_it, self.concurrency)


def post_json_batches(url: str, rows: Iterable[dict], batch_size: int,
                      wrap, headers=(),
                      backoffs_ms: Iterable[int] = DEFAULT_BACKOFFS_MS,
                      what: str = "batched POST") -> int:
    """Accumulate ``rows`` into batches of ``batch_size``, POST each as
    ``wrap(batch)`` JSON, raise on a terminally-failed batch. Shared by the
    PowerBI and search-index sinks. Returns the number of batches sent."""
    session = shared_session.get()
    batch, sent = [], 0

    def flush():
        req = HTTPRequestData.from_json(url, wrap(batch), headers=list(headers))
        resp = send_with_retries(session, req, list(backoffs_ms))
        if resp.status_code not in (200, 201, 202):
            raise IOError(f"{what} failed: {resp.status_code} "
                          f"{resp.string_content()[:200]}")

    for row in rows:
        batch.append(row)
        if len(batch) >= batch_size:
            flush()
            sent += 1
            batch = []
    if batch:
        flush()
        sent += 1
    return sent
