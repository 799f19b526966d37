"""Audio stream plumbing for streaming speech.

Parity surface: the reference's ``AudioStreams.scala`` (94 LoC) — the
``PullAudioInputStream``/``PushAudioInputStream`` pair the Speech SDK reads
audio through, plus WAV header handling (the SDK's
``AudioStreamFormat.getWaveFormatPCM``). Pure-Python equivalents:

* :class:`AudioFormat` — PCM wave format (rate / bits / channels), parsed
  from RIFF/WAVE headers or declared directly.
* :class:`PushAudioStream` — thread-safe producer/consumer byte stream
  (caller pushes chunks, the recognizer pulls frames).
* :class:`PullAudioStream` — wraps bytes / file-like objects.
* :func:`parse_wav` — RIFF chunk walk → (AudioFormat, pcm_payload).

The port's copy of ``mmlspark_tpu/services/audio.py`` (host work).
"""

from __future__ import annotations

import io
import struct
import threading
from dataclasses import dataclass
from typing import Optional, Tuple, Union

__all__ = ["AudioFormat", "PushAudioStream", "PullAudioStream", "parse_wav"]


@dataclass(frozen=True)
class AudioFormat:
    sample_rate: int = 16000
    bits_per_sample: int = 16
    channels: int = 1

    @property
    def bytes_per_second(self) -> int:
        return self.sample_rate * (self.bits_per_sample // 8) * self.channels

    def frame_bytes(self, millis: int) -> int:
        """Whole-sample-aligned byte count for a frame of ``millis``."""
        step = (self.bits_per_sample // 8) * self.channels
        n = self.bytes_per_second * millis // 1000
        return max(step, n - n % step)


def parse_wav(data: bytes) -> Tuple[AudioFormat, bytes]:
    """RIFF/WAVE → (format, PCM payload). Non-PCM codecs are rejected the
    way the reference surfaces unsupported formats (fail fast, not noise)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt: Optional[AudioFormat] = None
    payload: Optional[bytes] = None
    off = 12
    while off + 8 <= len(data):
        cid = data[off:off + 4]
        size = struct.unpack("<I", data[off + 4:off + 8])[0]
        body = data[off + 8:off + 8 + size]
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError("truncated fmt chunk")
            codec, channels, rate = struct.unpack("<HHI", body[:8])
            bits = struct.unpack("<H", body[14:16])[0]
            if codec not in (1, 0xFFFE):  # PCM / extensible
                raise ValueError(f"unsupported WAV codec {codec}; only PCM")
            fmt = AudioFormat(rate, bits, channels)
        elif cid == b"data":
            payload = body
        off += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise ValueError("WAV missing fmt or data chunk")
    return fmt, payload


class PushAudioStream:
    """Producer pushes chunks; consumer reads frames. ``close()`` signals
    end-of-audio (reference: ``PushAudioInputStream.close``)."""

    def __init__(self, fmt: AudioFormat = AudioFormat()):
        self.format = fmt
        self._buf = bytearray()
        self._closed = False
        self._cond = threading.Condition()

    def write(self, chunk: bytes) -> None:
        with self._cond:
            if self._closed:
                raise ValueError("push stream already closed")
            self._buf.extend(chunk)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def read(self, n: int, timeout: Optional[float] = None) -> bytes:
        """Up to ``n`` bytes; blocks until data or close. b'' = end of
        audio; a stalled producer raises TimeoutError instead of silently
        truncating the stream."""
        with self._cond:
            while not self._buf and not self._closed:
                if not self._cond.wait(timeout):
                    raise TimeoutError(
                        f"no audio pushed within {timeout}s (close() the "
                        f"stream to signal end-of-audio)")
            take = bytes(self._buf[:n])
            del self._buf[:n]
            return take


class PullAudioStream:
    """Reads from bytes or a binary file-like object."""

    def __init__(self, source: Union[bytes, bytearray, io.IOBase],
                 fmt: AudioFormat = AudioFormat()):
        if isinstance(source, (bytes, bytearray)):
            source = io.BytesIO(bytes(source))
        self._f = source
        self.format = fmt

    @classmethod
    def from_wav(cls, data: bytes) -> "PullAudioStream":
        fmt, payload = parse_wav(data)
        return cls(payload, fmt)

    def read(self, n: int, timeout: Optional[float] = None) -> bytes:
        return self._f.read(n) or b""

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass
