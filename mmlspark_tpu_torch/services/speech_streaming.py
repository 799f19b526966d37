"""True streaming speech-to-text: continuous recognition over a websocket.

Parity surface: ``SpeechToTextSDK`` (``cognitive/.../SpeechToTextSDK.scala:579``)
— the reference streams audio through the Speech SDK (websocket transport
under the hood), fires ``recognizing``/``recognized`` events as hypotheses
firm up, and emits **one output row per recognized utterance**; audio enters
through push/pull streams (``AudioStreams.scala:94``).

TPU-framework equivalents:

* :class:`SpeechRecognitionSession` — a full-duplex session over
  ``io/ws.py``: a sender thread pumps fixed-duration audio
  frames from a push/pull stream up the socket; a receiver thread parses
  JSON events down the socket and fires callbacks. Wire protocol (mirrors
  the Speech SDK's message shapes):

  - client → server: text ``{"type": "speech.config", "format": {...}}``
    then binary PCM frames, then text ``{"type": "audio.end"}``
  - server → client: ``{"type": "speech.hypothesis", "text": ...}``
    (interim), ``{"type": "speech.phrase", "text", "offset", "duration"}``
    (final utterance), ``{"type": "speech.end"}``

* :class:`SpeechToTextStreaming` — the DataFrame stage: each row's audio
  column streams through a session; the output column holds the list of
  final utterances (dicts with text/offset/duration), one element per
  recognized phrase — the row-per-utterance contract, grouped per input row.

The port's copy of ``mmlspark_tpu/services/speech_streaming.py`` (host
work over the port's ``io/ws.py``).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, List, Optional
from urllib.parse import urlparse

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import Param, identity
from ..io.ws import OP_CLOSE, OP_TEXT, client_connect
from .audio import AudioFormat, PullAudioStream
from .base import ServiceParam, ServiceTransformer

__all__ = ["SpeechRecognitionSession", "SpeechToTextStreaming"]


class SpeechRecognitionSession:
    """One continuous-recognition session against a streaming endpoint.

    ``recognizing``/``recognized`` callbacks fire on the receiver thread
    (reference: the SDK's event model, ``SpeechToTextSDK.scala:300-360``).
    ``run(stream)`` pumps the whole stream and returns the final phrases.
    """

    def __init__(self, url: str, headers: Optional[dict] = None,
                 frame_millis: int = 100,
                 recognizing: Optional[Callable[[dict], None]] = None,
                 recognized: Optional[Callable[[dict], None]] = None,
                 timeout: float = 30.0):
        if not url:
            raise ValueError("streaming url must be set (ws://host:port/path)")
        u = urlparse(url)
        if u.scheme != "ws":
            # no TLS layer here; wss endpoints need a terminating proxy
            raise ValueError(
                f"streaming url scheme must be ws:// (got {url!r})")
        self._host = u.hostname
        self._port = u.port or 80
        self._path = u.path or "/"
        self._headers = dict(headers or {})
        self.frame_millis = frame_millis
        self.recognizing = recognizing
        self.recognized = recognized
        self.timeout = timeout
        self.phrases: List[dict] = []
        self._error: Optional[Exception] = None

    # -- session ------------------------------------------------------------
    def run(self, stream) -> List[dict]:
        """Stream ``stream`` (Push/PullAudioStream) to completion; returns
        the list of final phrase events."""
        conn = client_connect(self._host, self._port, self._path,
                              headers=self._headers, timeout=self.timeout)
        try:
            fmt: AudioFormat = stream.format
            conn.send_text(json.dumps({
                "type": "speech.config",
                "format": {"sample_rate": fmt.sample_rate,
                           "bits_per_sample": fmt.bits_per_sample,
                           "channels": fmt.channels}}))
            done = threading.Event()
            # tpulint: disable=TPU025 — session-scoped receiver, joined
            # when the stream ends; a crash tears down this one session
            # (surfaced by the closed connection), and restarting it would
            # replay partial phrase events into the transcript
            receiver = threading.Thread(
                target=self._recv_loop, args=(conn, done), daemon=True)
            receiver.start()

            frame = fmt.frame_bytes(self.frame_millis)
            send_exc = None
            try:
                while not done.is_set():  # a terminal event stops the pump
                    chunk = stream.read(frame, timeout=self.timeout)
                    if not chunk:
                        break
                    conn.send_binary(chunk)
                if not done.is_set():
                    conn.send_text(json.dumps({"type": "audio.end"}))
            except OSError as e:
                # a dead socket usually means the server already sent a
                # terminal event — prefer that error over the pipe error
                send_exc = e
            if not done.wait(self.timeout):
                raise send_exc or TimeoutError("no speech.end from server")
            if self._error is not None:
                raise self._error
            if send_exc is not None:
                raise send_exc
            return list(self.phrases)
        finally:
            conn.close()

    def _recv_loop(self, conn, done: threading.Event) -> None:
        try:
            while True:
                opcode, payload = conn.recv()
                if opcode == OP_CLOSE:
                    break
                if opcode != OP_TEXT:
                    continue
                evt = json.loads(payload.decode("utf-8"))
                kind = evt.get("type")
                if kind == "speech.hypothesis":
                    if self.recognizing:
                        self.recognizing(evt)
                elif kind == "speech.phrase":
                    self.phrases.append(evt)
                    if self.recognized:
                        self.recognized(evt)
                elif kind == "speech.error":
                    # terminal: stop listening so run() reports this error
                    # instead of pumping audio into a dead session until a
                    # timeout masks it
                    self._error = RuntimeError(
                        evt.get("message", "speech service error"))
                    break
                elif kind == "speech.end":
                    break
        except Exception as e:  # surfaced to run()
            self._error = self._error or e
        finally:
            done.set()


class SpeechToTextStreaming(ServiceTransformer):
    """Continuous recognition over each row's audio (wav or raw PCM).

    Output column: list of final utterance dicts (text/offset/duration) per
    row — the reference's one-row-per-utterance, grouped (flatten with
    ``FlattenBatch`` for literal row-per-utterance parity)."""

    audio_data = ServiceParam(bytes, is_required=True,
                              doc="wav (RIFF) or raw 16k/16-bit PCM bytes")
    language = ServiceParam(str, default="en-US", is_url_param=True,
                            doc="spoken language")
    frame_millis = Param(int, default=100, doc="audio frame size streamed "
                                               "per websocket message")
    interim_col = Param(str, default=None, converter=identity,
                        doc="optional column receiving interim hypothesis "
                            "texts (list per row)")

    def _transform(self, df: DataFrame) -> DataFrame:
        tagged = self.get_or_none("audio_data")
        if tagged is None or tagged["kind"] != "col":
            raise ValueError("SpeechToTextStreaming requires audio_data "
                             "bound to a column (set_vector_param)")
        audio = df[tagged["value"]]
        url = self.get("url")
        interim_col = self.get_or_none("interim_col")
        outs = np.empty(len(df), dtype=object)
        interims = np.empty(len(df), dtype=object)
        errs = np.empty(len(df), dtype=object)
        headers = {h.name: h.value for h in self._headers({})}

        def run_row(i):
            a = audio[i]
            if a is None:
                return
            hyp: List[str] = []
            try:
                raw = bytes(a)
                if raw[:4] == b"RIFF":
                    # a real WAV: parse errors (non-PCM codec, truncated
                    # chunks) must surface, not degrade into streaming the
                    # container bytes as PCM noise
                    stream = PullAudioStream.from_wav(raw)
                else:
                    stream = PullAudioStream(raw)  # raw PCM, default format
                sess = SpeechRecognitionSession(
                    url, headers=headers,
                    frame_millis=self.frame_millis,
                    recognizing=lambda e: hyp.append(e.get("text", "")),
                    timeout=self.get("timeout"))
                outs[i] = sess.run(stream)
                interims[i] = hyp
            except Exception as e:
                errs[i] = {"error": str(e)}

        conc = max(1, self.get("concurrency"))
        if conc == 1:
            for i in range(len(df)):
                run_row(i)
        else:
            # each row is an independent websocket session → sessions in
            # flight = concurrency (the contract every ServiceTransformer
            # honors via AsyncHTTPClient)
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(conc) as ex:
                list(ex.map(run_row, range(len(df))))
        out = (df.with_column(self.get("output_col"), outs)
                 .with_column(self.get("error_col"), errs))
        if interim_col:
            out = out.with_column(interim_col, interims)
        return out
