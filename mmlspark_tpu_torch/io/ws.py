"""Minimal RFC 6455 WebSocket client + server.

The reference's streaming speech path rides the Azure Speech SDK, whose
transport is a websocket pushing audio frames up and recognition events down
(``cognitive/.../SpeechToTextSDK.scala:579``, ``AudioStreams.scala:94``).
This module is the dependency-free transport for that pattern: enough of
RFC 6455 for full-duplex framed messaging between cooperating endpoints —
handshake, text/binary/ping/pong/close frames, client-side masking.
No extensions, no compression.

Used by ``services/speech_streaming.py``; reusable by any
service transformer needing a persistent bidirectional stream.

The port's copy of ``mmlspark_tpu/io/ws.py`` (raw sockets, host only).
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading
from typing import Optional, Tuple

__all__ = ["WebSocketConn", "client_connect", "server_handshake",
           "OP_TEXT", "OP_BINARY", "OP_CLOSE", "OP_PING", "OP_PONG"]

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


def _accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


class WebSocketConn:
    """A connected websocket endpoint (either side).

    ``send(payload, opcode)`` / ``recv() -> (opcode, payload)``. ``recv``
    transparently answers pings and reassembles fragmented messages.
    ``send`` is thread-safe (one writer lock), so a receiver thread's
    automatic pong cannot interleave with a concurrent data frame.
    """

    def __init__(self, sock: socket.socket, mask_outgoing: bool,
                 initial_bytes: bytes = b""):
        self.sock = sock
        self.mask_outgoing = mask_outgoing  # clients mask, servers don't
        self._closed = False
        self._send_lock = threading.Lock()
        self._rbuf = initial_bytes  # bytes read past the handshake

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        if self._rbuf:
            buf, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("websocket peer closed mid-frame")
            buf += chunk
        return buf

    # -- frames -------------------------------------------------------------
    def send(self, payload, opcode: int = OP_TEXT) -> None:
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        head = bytes([0x80 | opcode])
        n = len(payload)
        mask_bit = 0x80 if self.mask_outgoing else 0
        if n < 126:
            head += bytes([mask_bit | n])
        elif n < (1 << 16):
            head += bytes([mask_bit | 126]) + struct.pack(">H", n)
        else:
            head += bytes([mask_bit | 127]) + struct.pack(">Q", n)
        if self.mask_outgoing:
            mask = os.urandom(4)
            masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            frame = head + mask + masked
        else:
            frame = head + payload
        with self._send_lock:
            # the socket write IS the critical section: _send_lock exists
            # to keep concurrently-sent frames from interleaving on the
            # wire (a split frame is a protocol error, not a slow call)
            self.sock.sendall(frame)  # tpulint: disable=TPU014

    def send_text(self, s: str) -> None:
        self.send(s, OP_TEXT)

    def send_binary(self, b: bytes) -> None:
        self.send(b, OP_BINARY)

    def _read_frame(self) -> Tuple[bool, int, bytes]:
        b1, b2 = self._recv_exact(2)
        fin = bool(b1 & 0x80)
        opcode = b1 & 0x0F
        masked = bool(b2 & 0x80)
        n = b2 & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._recv_exact(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._recv_exact(8))[0]
        mask = self._recv_exact(4) if masked else None
        payload = self._recv_exact(n) if n else b""
        if mask:
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        return fin, opcode, payload

    def recv(self) -> Tuple[int, bytes]:
        """Next full message as (opcode, payload); answers pings inline.
        Returns (OP_CLOSE, payload) when the peer closes."""
        message = b""
        msg_op = None
        while True:
            fin, opcode, payload = self._read_frame()
            if opcode == OP_PING:
                self.send(payload, OP_PONG)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                if not self._closed:
                    try:
                        self.send(payload, OP_CLOSE)  # echo close
                    except OSError:
                        pass
                    self._closed = True
                return OP_CLOSE, payload
            if opcode in (OP_TEXT, OP_BINARY):
                msg_op = opcode
            message += payload
            if fin:
                return msg_op if msg_op is not None else opcode, message

    def close(self, code: int = 1000) -> None:
        if not self._closed:
            self._closed = True
            try:
                self.send(struct.pack(">H", code), OP_CLOSE)
            except OSError:
                pass
        try:
            self.sock.close()
        except OSError:
            pass


# -- handshakes -------------------------------------------------------------

def client_connect(host: str, port: int, path: str = "/",
                   headers: Optional[dict] = None,
                   timeout: float = 30.0) -> WebSocketConn:
    """Open a client websocket to ``ws://host:port{path}``."""
    sock = socket.create_connection((host, port), timeout=timeout)
    key = base64.b64encode(os.urandom(16)).decode()
    req = [f"GET {path} HTTP/1.1",
           f"Host: {host}:{port}",
           "Upgrade: websocket",
           "Connection: Upgrade",
           f"Sec-WebSocket-Key: {key}",
           "Sec-WebSocket-Version: 13"]
    for k, v in (headers or {}).items():
        req.append(f"{k}: {v}")
    sock.sendall(("\r\n".join(req) + "\r\n\r\n").encode())
    # read the 101 response head
    head = b""
    while b"\r\n\r\n" not in head:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("websocket handshake: peer closed")
        head += chunk
        if len(head) > 65536:
            raise ConnectionError("websocket handshake: oversized response")
    status = head.split(b"\r\n", 1)[0].decode(errors="replace")
    if " 101 " not in status + " ":
        raise ConnectionError(f"websocket handshake rejected: {status}")
    head, _, leftover = head.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")[1:]
    hdrs = {k.strip().lower(): v.strip() for k, _, v in
            (ln.partition(":") for ln in lines if ":" in ln)}
    if hdrs.get("sec-websocket-accept") != _accept_key(key):
        raise ConnectionError("websocket handshake: bad accept key")
    # frames the server sent right behind the 101 must not be dropped
    return WebSocketConn(sock, mask_outgoing=True, initial_bytes=leftover)


def server_handshake(sock: socket.socket,
                     request_head: bytes) -> Tuple[WebSocketConn, str]:
    """Answer an Upgrade request already read into ``request_head``
    (through the blank line). Returns (conn, request_path)."""
    head, _, leftover = request_head.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    path = lines[0].split(" ")[1] if len(lines[0].split(" ")) > 1 else "/"
    hdrs = {k.strip().lower(): v.strip() for k, _, v in
            (ln.partition(":") for ln in lines[1:] if ":" in ln)}
    key = hdrs.get("sec-websocket-key")
    if not key:
        raise ConnectionError("not a websocket upgrade request")
    resp = ["HTTP/1.1 101 Switching Protocols",
            "Upgrade: websocket",
            "Connection: Upgrade",
            f"Sec-WebSocket-Accept: {_accept_key(key)}"]
    sock.sendall(("\r\n".join(resp) + "\r\n\r\n").encode())
    return WebSocketConn(sock, mask_outgoing=False,
                         initial_bytes=leftover), path
