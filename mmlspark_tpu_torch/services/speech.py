"""Speech service transformers.

Parity surface:

* ``SpeechToText`` (``cognitive/.../SpeechToText.scala:22-90``): POST raw
  .wav bytes, URL params ``language``/``format``/``profanity``, JSON
  transcription response.
* ``SpeechToTextSDK`` (``SpeechToTextSDK.scala``, 579 LoC): the reference
  streams audio through the Speech SDK and emits one result per recognized
  utterance. Here the streaming contract is kept — audio is split into
  fixed-duration chunks (``AudioStreams.scala``-style buffering) and each
  chunk is transcribed; the output column holds the list of per-chunk
  results.
* ``TextToSpeech`` (``TextToSpeech.scala:27-140``): synthesize text and
  write the returned audio bytes to ``output_file_col`` paths; errors land
  in the error column.

The port's copy of ``mmlspark_tpu/services/speech.py`` (host work).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..core.params import Param
from ..io.http.schema import EntityData, HeaderData, HTTPRequestData
from .base import ServiceParam, ServiceTransformer

__all__ = ["SpeechToText", "SpeechToTextSDK", "ConversationTranscription",
           "TextToSpeech"]


class SpeechToText(ServiceTransformer):
    """POST audio bytes → transcription JSON."""

    audio_data = ServiceParam(bytes, is_required=True,
                              doc="wav audio bytes (scalar or column)")
    language = ServiceParam(str, default="en-US", is_url_param=True,
                            is_required=True, doc="spoken language")
    format = ServiceParam(str, is_url_param=True,
                          doc="result format: simple or detailed")
    profanity = ServiceParam(str, is_url_param=True,
                             doc="masked / removed / raw")

    def _build_request(self, row: dict) -> Optional[HTTPRequestData]:
        if self.should_skip(row):
            return None
        audio = self.get_value_opt(row, "audio_data")
        headers = [h for h in self._headers(row)
                   if h.name.lower() != "content-type"]
        headers.append(HeaderData("Content-Type",
                                  "audio/wav; codecs=audio/pcm"))
        return HTTPRequestData(
            url=self._full_url(row), method="POST", headers=headers,
            entity=EntityData(content=bytes(audio),
                              content_length=len(audio)))


class SpeechToTextSDK(SpeechToText):
    """Chunked (streaming-style) recognition: one result per audio chunk."""

    chunk_bytes = Param(int, default=32768,
                        doc="bytes per streamed chunk (one request each)")

    #: per-chunk transformer type (ConversationTranscription swaps in a
    #: participants-aware variant)
    _inner_cls = SpeechToText

    def _transform(self, df: DataFrame) -> DataFrame:
        size = self.get("chunk_bytes")
        tagged = self.get_or_none("audio_data")
        if tagged is None or tagged["kind"] != "col":
            raise ValueError("SpeechToTextSDK requires audio_data bound to a "
                             "column (set_vector_param)")
        col = tagged["value"]
        audio = df[col]
        # other column-bound service params must travel with each chunk row
        extra_cols = [t["value"] for n, t in
                      ((n, self.get_or_none(n)) for n in self._service_params())
                      if n != "audio_data" and t is not None
                      and t["kind"] == "col"]
        # explode every row's audio into chunks, transcribe flat, regroup
        flat, owners = [], []
        for i, a in enumerate(audio):
            if a is None:
                continue
            for off in range(0, len(a), size):
                flat.append(a[off:off + size])
                owners.append(i)
        sub = None
        if flat:
            data = {col: object_col(flat)}
            for c in extra_cols:
                data[c] = object_col([df[c][i] for i in owners])
            sub = DataFrame(data)
        outs = np.empty(len(df), dtype=object)
        errs = np.empty(len(df), dtype=object)
        for i in range(len(df)):
            outs[i] = [] if audio[i] is not None else None
        if sub is not None:
            inner = type(self)._inner_cls(
                url=self.get("url"), concurrency=self.get("concurrency"),
                timeout=self.get("timeout"),
                key_header=self.get("key_header"),
                output_col="__out__", error_col="__err__")
            for n in self._service_params():
                if n != "audio_data" and self.get_or_none(n) is not None:
                    inner.set(**{n: self.get(n)})
            inner.set_vector_param("audio_data", col)
            res = inner.transform(sub)
            for j, i in enumerate(owners):
                outs[i].append(res["__out__"][j])
                if res["__err__"][j] is not None:
                    errs[i] = res["__err__"][j]
        return (df.with_column(self.get("output_col"), outs)
                  .with_column(self.get("error_col"), errs))


class _ConversationChunk(SpeechToText):
    """Per-chunk request builder for ConversationTranscription: validates
    and forwards the participants declaration."""

    participants_json = ServiceParam(
        str, is_url_param=True, payload_name="participants",
        doc="JSON array of {name, preferredLanguage, voiceSignature}")

    def _build_request(self, row: dict):
        import json as _json
        if self.should_skip(row):  # null required params skip, not 400
            return None
        pj = self.get_value_opt(row, "participants_json")
        if pj is not None:
            try:
                parsed = _json.loads(pj)
            except _json.JSONDecodeError as e:
                raise ValueError(f"participants_json is not valid JSON: {e}")
            if not isinstance(parsed, list):
                raise ValueError("participants_json must be a JSON array")
        return super()._build_request(row)


class ConversationTranscription(SpeechToTextSDK):
    """Parity: ``ConversationTranscription``
    (``SpeechToTextSDK.scala:491-579``) — multi-speaker transcription over
    the same chunked streaming contract as ``SpeechToTextSDK``;
    ``participants_json`` (``:134-141``) declares speakers (name /
    preferredLanguage / voiceSignature) and rides as a URL param so the
    service can attribute utterances (speaker ids come back in the
    per-chunk results)."""

    participants_json = ServiceParam(
        str, is_url_param=True, payload_name="participants",
        doc="JSON array of {name, preferredLanguage, voiceSignature}")

    _inner_cls = _ConversationChunk


class TextToSpeech(ServiceTransformer):
    """Synthesize speech; audio bytes are written to per-row output files."""

    text = ServiceParam(str, is_required=True, doc="text to speak")
    language = ServiceParam(str, default="en-US", doc="synthesis language")
    voice_name = ServiceParam(str, default="en-US-JennyNeural",
                              doc="voice to use")
    output_format = ServiceParam(str, default="riff-24khz-16bit-mono-pcm",
                                 doc="audio output format header")
    output_file_col = Param(str, default="outputFile",
                            doc="column holding the destination file path")

    def _build_request(self, row: dict) -> Optional[HTTPRequestData]:
        if self.should_skip(row):
            return None
        from xml.sax.saxutils import escape, quoteattr
        text = escape(str(self.get_value_opt(row, "text")))
        lang = quoteattr(str(self.get_value_opt(row, "language")))
        voice = quoteattr(str(self.get_value_opt(row, "voice_name")))
        ssml = (f"<speak version='1.0' xml:lang={lang}>"
                f"<voice xml:lang={lang} name={voice}>"
                f"{text}</voice></speak>")
        headers = [h for h in self._headers(row)
                   if h.name.lower() != "content-type"]
        headers.append(HeaderData("Content-Type", "application/ssml+xml"))
        headers.append(HeaderData("X-Microsoft-OutputFormat",
                                  self.get_value_opt(row, "output_format")))
        body = ssml.encode("utf-8")
        return HTTPRequestData(url=self._full_url(row), method="POST",
                               headers=headers,
                               entity=EntityData(content=body,
                                                 content_length=len(body)))

    def _transform(self, df: DataFrame) -> DataFrame:
        from ..io.http.clients import AsyncHTTPClient, SingleThreadedHTTPClient
        from ..io.http.http_transformer import ErrorUtils
        rows = list(df.iter_rows())
        requests_ = [self._build_request(r) for r in rows]
        c = self.get("concurrency")
        client = (AsyncHTTPClient(c, handler=self._handle) if c > 1
                  else SingleThreadedHTTPClient(handler=self._handle))
        errs = []
        paths = df[self.get("output_file_col")]
        for i, (req, resp) in enumerate(zip(requests_,
                                            client.send(iter(requests_)))):
            if req is None:
                errs.append(None)
                continue
            ok, err = ErrorUtils.split(resp)
            if ok is None:
                errs.append(err)
                continue
            with open(paths[i], "wb") as f:
                f.write(ok.entity.content if ok.entity else b"")
            errs.append(None)
        return df.with_column(self.get("error_col"), object_col(errs))
