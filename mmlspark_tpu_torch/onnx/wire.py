"""Protobuf wire-format codec (no protobuf runtime dependency).

The environment ships no ``onnx`` package, and the reference reads ONNX
models through onnxruntime's native session
(``deep-learning/.../onnx/ONNXModel.scala:437-457``). We instead parse the
ONNX protobuf directly: the wire format is tiny — varint tags, four payload
kinds — and decoding it ourselves keeps model metadata reads session-free.

Wire types: 0 = VARINT, 1 = I64, 2 = LEN (length-delimited), 5 = I32.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple, Union

__all__ = ["read_varint", "iter_fields", "decode_zigzag",
           "WireWriter", "encode_varint"]


def read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def decode_zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, payload) for one serialized message.

    LEN payloads are returned as bytes; VARINT as int; I32/I64 as raw bytes.
    """
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = read_varint(data, pos)
        field, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = read_varint(data, pos)
            yield field, wtype, val
        elif wtype == 1:
            yield field, wtype, data[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = read_varint(data, pos)
            if pos + ln > n:
                raise ValueError(f"truncated LEN field {field}")
            yield field, wtype, data[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            yield field, wtype, data[pos:pos + 4]
            pos += 4
        elif wtype in (3, 4):  # group markers: obsolete, skip silently
            continue
        else:
            raise ValueError(f"unknown wire type {wtype} for field {field}")


def encode_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's-complement for negative int64 (proto semantics)
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class WireWriter:
    """Append-only message builder."""

    def __init__(self):
        self._parts: List[bytes] = []

    def _tag(self, field: int, wtype: int) -> None:
        self._parts.append(encode_varint((field << 3) | wtype))

    def varint(self, field: int, value: int) -> "WireWriter":
        self._tag(field, 0)
        self._parts.append(encode_varint(int(value)))
        return self

    def bool(self, field: int, value: bool) -> "WireWriter":
        return self.varint(field, 1 if value else 0)

    def float32(self, field: int, value: float) -> "WireWriter":
        self._tag(field, 5)
        self._parts.append(struct.pack("<f", value))
        return self

    def double(self, field: int, value: float) -> "WireWriter":
        self._tag(field, 1)
        self._parts.append(struct.pack("<d", value))
        return self

    def bytes(self, field: int, value: bytes) -> "WireWriter":
        self._tag(field, 2)
        self._parts.append(encode_varint(len(value)))
        self._parts.append(bytes(value))
        return self

    def string(self, field: int, value: str) -> "WireWriter":
        return self.bytes(field, value.encode("utf-8"))

    def message(self, field: int, sub: "WireWriter") -> "WireWriter":
        return self.bytes(field, sub.to_bytes())

    def packed_varints(self, field: int, values) -> "WireWriter":
        payload = b"".join(encode_varint(int(v)) for v in values)
        return self.bytes(field, payload)

    def packed_floats(self, field: int, values) -> "WireWriter":
        import numpy as np
        return self.bytes(field, np.asarray(values, dtype="<f4").tobytes())

    def packed_doubles(self, field: int, values) -> "WireWriter":
        import numpy as np
        return self.bytes(field, np.asarray(values, dtype="<f8").tobytes())

    def to_bytes(self) -> bytes:
        return b"".join(self._parts)
