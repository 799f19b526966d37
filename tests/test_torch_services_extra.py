"""Port parity: the speech, multivariate-anomaly, geospatial,
document-translation, form and search-sink services, the streaming
speech path over ``io/ws``, the PowerBI sink, and ``SimpleDetectAnomalies``'
local detector, against the JAX package, after the reference's
``tests/test_services_extra.py`` and ``tests/test_speech_streaming.py``.

The HTTP cases run once through each package against one recording mock
(``test_torch_http.Mock``) and must send the same requests and give equal
columns. The streaming cases run both packages' websocket clients against
one fake ASR server that records every frame it receives. The local
detector runs on the CPU here (``device="cpu"``) and must equal the JAX
package's jitted ``jnp.median`` arithmetic bit for bit on odd- and
even-length groups; ``torch.median`` (the lower middle value) must not.
"""

import importlib
import json
import socket
import struct
import threading
from urllib.parse import urlparse

import numpy as np
import pytest
import torch

from test_torch_http import PKGS, both, frame, same_cols, serve

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def _obj(values):
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


def _extra_route(mock, req):
    """The JAX tests' ``_Mock`` (tests/test_services_extra.py)."""
    p, q, raw = req.path, req.query, req.body
    if req.method == "GET":
        if p.startswith("/mvad/models/"):
            n = mock.bump(p)
            return 200, [], {"modelInfo": {"status": "READY" if n >= 2
                                           else "CREATED"}}
        if p.startswith("/mvad/results/"):
            return 200, [], {"summary": {"status": "READY"}, "results": [
                {"timestamp": "t0", "value": {"isAnomaly": False}},
                {"timestamp": "t1", "value": {"isAnomaly": True}}]}
        if p == "/geofence":
            return 200, [], {"result": {"isInside": float(q["lat"][0])
                                        < 50.0}}
        if p.startswith("/docop/"):
            n = mock.bump(p)
            return 200, [], {"status": "Succeeded" if n >= 2 else "Running",
                             "summary": {"success": 1}}
        return 404, [], {"error": "nf"}
    if p == "/stt":
        if not req.headers["Content-Type"].startswith("audio/wav"):
            return 415, [], {"error": "type"}
        return 200, [], {"RecognitionStatus": "Success",
                         "DisplayText": f"heard {len(raw)} bytes in "
                                        f"{q['language'][0]}"}
    if p == "/tts":
        if not req.headers["Content-Type"].startswith("application/ssml") \
                or not req.headers.get("X-Microsoft-OutputFormat"):
            return 415, [], {"error": "type"}
        return 200, [], b"RIFFfakeaudio" + raw[:8]
    if p == "/mvad/models":
        return 201, [("Location", "http://x/mvad/models/m123")], {}
    if p == "/mvad/models/m123/detect":
        return 201, [("Location", "http://x/mvad/results/r99")], {}
    if p == "/geocode":
        return 200, [], {"batchItems": [
            {"response": {"ok": True, "q": it["query"]}}
            for it in req.json["batchItems"]]}
    if p == "/search/index/docs":
        if req.headers.get("api-key") != "sk":
            return 401, [], {"error": "key"}
        return 200, [], {"value": [
            {"key": str(i), "status": True,
             "action_seen": d.get("@search.action"),
             "fields_seen": sorted(d.keys())}
            for i, d in enumerate(req.json["value"])]}
    if p == "/transcribe":
        if not q.get("participants", [""])[0].startswith("["):
            return 400, [], {"error": "participants"}
        return 200, [], {"RecognitionStatus": "Success",
                         "DisplayText": f"speaker0 said {len(raw)} bytes",
                         "SpeakerId": "guest-0"}
    if p == "/docbatches":
        if req.json["inputs"][0]["targets"][0]["language"] != "fr":
            return 400, [], {"error": "language"}
        return 202, [("Operation-Location",
                      f"http://{req.host}/docop/op7")], {}
    if p == "/powerbi":
        return 200, [], {}
    return 404, [], {"error": "nf"}


@pytest.fixture
def svc():
    yield from serve(_extra_route)


def _stt(pkg, base):
    t = pkg.services.SpeechToText(url=base + "/stt", output_col="out",
                                  error_col="err")
    t.set_vector_param("audio_data", "audio")
    return t.transform(frame(pkg, {"audio": [b"\x00" * 100, None]}))


def _stt_sdk(pkg, base):
    t = pkg.services.SpeechToTextSDK(url=base + "/stt", chunk_bytes=32768,
                                     output_col="out", error_col="err")
    t.set_vector_param("audio_data", "audio")
    return t.transform(frame(pkg, {"audio": [b"\x01" * 70000]}))


def _stt_sdk_language(pkg, base):
    t = pkg.services.SpeechToTextSDK(url=base + "/stt", chunk_bytes=32768,
                                     output_col="out", error_col="err")
    t.set_vector_param("audio_data", "audio")
    t.set_vector_param("language", "lang")
    return t.transform(frame(pkg, {"audio": [b"\x02" * 40000],
                                   "lang": ["de-DE"]}))


def _tts(tmp):
    def run(pkg, base):
        paths = [str(tmp / f"{pkg.name}_{n}.wav") for n in ("a", "b", "c")]
        t = pkg.services.TextToSpeech(url=base + "/tts", output_col="out",
                                      error_col="err")
        t.set_vector_param("text", "text")
        out = t.transform(frame(pkg, {"text": ["hello", "world",
                                               "AT&T <rocks>"],
                                      "outputFile": paths}))
        audio = []
        for path in paths:
            with open(path, "rb") as f:
                audio.append(f.read())
        return out.with_column("audio", _obj(audio))
    return run


def _address_geocoder(pkg, base):
    g = pkg.services.AddressGeocoder(url=base + "/geocode", output_col="out",
                                     error_col="err", subscription_key="k")
    g.set_vector_param("address", "addr")
    return g.transform(frame(pkg, {"addr": _obj([["1 Main St",
                                                  "2 High St"]])}))


def _reverse_geocoder(pkg, base):
    g = pkg.services.ReverseAddressGeocoder(
        url=base + "/geocode", output_col="out", error_col="err",
        subscription_key="secret")
    g.set_vector_param("coordinates", "pts")
    return g.transform(frame(pkg, {"pts": _obj([[[47.6, -122.3]]])}))


def _point_in_polygon(pkg, base):
    c = pkg.services.CheckPointInPolygon(url=base + "/geofence",
                                         output_col="out", error_col="err")
    c.set_vector_param("lat", "la")
    c.set_vector_param("lon", "lo")
    return c.transform(frame(pkg, {"la": np.array([47.6, 80.0]),
                                   "lo": np.array([1.0, 2.0])}))


def _document_translator(pkg, base):
    t = pkg.services.DocumentTranslator(
        url=base + "/docbatches", output_col="out", error_col="err",
        polling_delay_ms=5, target_url="http://blob/out",
        target_language="fr")
    t.set_vector_param("source_url", "src")
    return t.transform(frame(pkg, {"src": ["http://blob/in"]}))


def _add_documents(pkg, base):
    t = pkg.services.AddDocuments(url=base + "/search/index/docs",
                                  output_col="out", error_col="err",
                                  batch_size=2)
    t.set_scalar_param("subscription_key", "sk")
    return t.transform(frame(pkg, {"id": ["a", "b", "c"],
                                   "@search.action": ["upload", "merge",
                                                      "upload"]}))


def _add_documents_column_key(pkg, base):
    t = pkg.services.AddDocuments(url=base + "/search/index/docs",
                                  output_col="out", error_col="err")
    t.set_vector_param("subscription_key", "keycol")
    return t.transform(frame(pkg, {"id": ["a"], "keycol": ["sk"]}))


def _conversation(pkg, base):
    wav = bytes(range(256)) * 300          # 76,800 bytes: 3 chunks
    outs, errs = [], []
    for participants in ('[{"name": "ana", "preferredLanguage": "en-US"}]',
                         "{not json"):
        t = pkg.services.ConversationTranscription(
            url=base + "/transcribe", output_col="out", error_col="err")
        t.set_vector_param("audio_data", "audio")
        t.set_scalar_param("participants_json", participants)
        o = t.transform(frame(pkg, {"audio": [wav]}))
        outs.append(o["out"][0])
        errs.append(o["err"][0])
    return pkg.core.DataFrame({"out": _obj(outs), "err": _obj(errs)})


def _dictionary_examples_malformed(pkg, base):
    t = pkg.services.DictionaryExamples(url=base + "/dictionary-unused",
                                        output_col="out", error_col="err")
    t.set_vector_param("text_and_translation", "pair")
    t.set_scalar_param("from_language", "en")
    t.set_scalar_param("to_language", "es")
    return t.transform(frame(pkg, {"pair": _obj([5, ("fly", "volar")])}))


def _find_similar_null(pkg, base):
    t = pkg.services.FindSimilarFace(url=base + "/unused", output_col="out",
                                     error_col="err")
    t.set_vector_param("face_id", "fid")
    return t.transform(frame(pkg, {"fid": [None]}))


CASES = {
    "speech_to_text": (_stt, lambda o: (
        o["out"][0]["DisplayText"] == "heard 100 bytes in en-US"
        and o["out"][1] is None)),
    "speech_to_text_sdk_chunks": (_stt_sdk, lambda o: (
        len(o["out"][0]) == 3
        and o["out"][0][2]["DisplayText"].startswith("heard 4464"))),
    "speech_sdk_column_language": (_stt_sdk_language, lambda o: (
        len(o["out"][0]) == 2
        and o["out"][0][0]["DisplayText"].endswith("de-DE"))),
    "address_geocoder": (_address_geocoder, lambda o: (
        len(o["out"][0]) == 2 and o["out"][0][0]["response"]["ok"])),
    "reverse_geocoder_key_in_url": (_reverse_geocoder, lambda o: (
        o["out"][0][0]["response"]["q"] == "?query=47.6,-122.3")),
    "point_in_polygon": (_point_in_polygon, lambda o: (
        o["out"][0]["result"]["isInside"] is True
        and o["out"][1]["result"]["isInside"] is False)),
    "document_translator_polls": (_document_translator, lambda o: (
        o["err"][0] is None and o["out"][0]["status"] == "Succeeded")),
    "add_documents_batches": (_add_documents, lambda o: (
        o["out"][0]["value"][1]["action_seen"] == "merge"
        and o["out"][0] == o["out"][1] and len(o["out"][2]["value"]) == 1
        and all(e is None for e in o["err"]))),
    "add_documents_column_key": (_add_documents_column_key, lambda o: (
        o["err"][0] is None and o["out"][0]["value"][0]["fields_seen"]
        == ["@search.action", "id"])),
    "conversation_transcription": (_conversation, lambda o: (
        o["err"][0] is None and len(o["out"][0]) == 3
        and all(r["SpeakerId"] == "guest-0" for r in o["out"][0])
        and "not valid JSON" in o["err"][1]["reasonPhrase"])),
    "dictionary_examples_malformed_row": (
        _dictionary_examples_malformed, lambda o: (
            o["out"][0] is None and "pair" in o["err"][0]["reasonPhrase"]
            and o["err"][1] is not None)),
    "find_similar_null_skips": (_find_similar_null, lambda o: (
        o["out"][0] is None and o["err"][0] is None)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_service_family_same_requests_and_columns(svc, name):
    case, check = CASES[name]
    out = both(svc, lambda pkg: case(pkg, svc.base))
    assert check(same_cols(out, "out", "err"))


def test_text_to_speech_writes_the_same_files(svc, tmp_path):
    run = _tts(tmp_path)
    out = both(svc, lambda pkg: run(pkg, svc.base))
    port = same_cols(out, "err", "audio")
    assert all(e is None for e in port["err"])
    assert all(a.startswith(b"RIFF") for a in port["audio"])


def test_mvad_fit_detect_and_roundtrip(svc, tmp_path):
    def run(pkg):
        est = pkg.services.FitMultivariateAnomaly(
            url=svc.base + "/mvad/models", source="http://blob/x.zip",
            start_time="t0", end_time="t9", polling_delay_ms=5)
        df = frame(pkg, {"timestamp": ["t0", "t1"]})
        model = est.fit(df)
        path = str(tmp_path / pkg.name)
        model.save(path)
        again = type(model).load(path)
        return (model.get("model_id"), again.get("model_id"),
                model.transform(df))

    out = both(svc, run)
    assert out["port"][:2] == out["jax"][:2] == ("m123", "m123")
    port = same_cols({k: v[2] for k, v in out.items()}, "result", "error")
    assert port["result"][1] == {"isAnomaly": True}
    assert port["error"][0] is None


def test_powerbi_writer_batches(svc):
    def run(pkg):
        df = frame(pkg, {"id": ["1", "2", "3"],
                         "score": np.asarray([0.1, 0.2, 0.3])})
        return pkg.powerbi.PowerBIWriter(svc.base + "/powerbi",
                                         batch_size=2).write(df)

    out = both(svc, run)
    assert out["port"] == out["jax"] == 2
    assert [len(json.loads(r["body"])["rows"]) for r in svc.log] == [2, 1]


def test_powerbi_terminal_failure_raises(svc):
    for pkg in PKGS.values():
        df = frame(pkg, {"id": ["1"]})
        with pytest.raises(IOError, match="PowerBI push failed: 404"):
            pkg.powerbi.write_to_powerbi(df, svc.base + "/nowhere",
                                         backoffs_ms=(1,))


def test_form_ontology_and_flatteners_equal():
    forms = [
        {"analyzeResult": {"documentResults": [{"fields": {
            "Total": {"type": "number", "valueNumber": 12.5, "text": "12.5"},
            "Vendor": {"type": "string", "valueString": "ACME"}}}]}},
        {"analyzeResult": {"documentResults": [{"fields": {
            "Total": {"type": "number", "valueNumber": 3.0},
            "Date": {"type": "date", "valueDate": "2021-01-01"}}}]}}]
    resp = {"analyzeResult": {
        "readResults": [{"lines": [{"text": "Total"}, {"text": "42"}]}],
        "pageResults": [{"keyValuePairs": [
            {"key": {"text": "Total"}, "value": {"text": "42"}},
            {"key": None, "value": {"text": "x"}}],
            "tables": [{"cells": [{"text": "a"}, {"text": "b"}]}]}],
        "documentResults": [{"fields": {
            "Total": {"type": "number", "valueNumber": 42.0}}}]}}
    models = {"modelList": [{"modelId": "m1"}, {"modelId": "m2"}]}

    def run(pkg):
        s = pkg.services
        model = s.FormOntologyLearner(input_col="form", output_col="onto"
                                      ).fit(frame(pkg, {"form": forms}))
        out = model.transform(frame(pkg, {"form": forms}))
        col = _obj([resp, None])
        a = s.AnalyzeCustomModel(url="http://h/custom/models")
        a.set_scalar_param("model_id", "m-1")
        a.set_scalar_param("include_text_details", True)
        g = s.GetCustomModel(url="http://h/custom/models")
        g.set_scalar_param("model_id", "m-2")
        g.set_scalar_param("include_keys", True)
        form = importlib.import_module(f"{pkg.services.__name__}.form")
        return (sorted(model.get("ontology")), list(out["onto"]),
                list(s.flatten_read_results(col)),
                list(s.flatten_page_results(col)),
                list(s.flatten_document_results(col)),
                list(s.flatten_model_list(_obj([models]))),
                a._full_url({}), g._full_url({}), g.get("method"),
                form._model_url("http://h/models?api-version=2.1", "m 1/x",
                                {"includeKeys": "true"}, suffix="/analyze"))

    got = {name: run(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    onto, rows, read, pages, docs, mlist, a_url, g_url, method, murl = \
        got["port"]
    assert onto == ["Date", "Total", "Vendor"]
    assert rows[0] == {"Total": 12.5, "Vendor": "ACME", "Date": None}
    assert read == ["Total 42", None] and "a | b" in pages[0]
    assert "value: x" in pages[0] and '"valueNumber": 42.0' in docs[0]
    assert mlist == ["m1 m2"] and method == "GET"
    assert a_url == \
        "http://h/custom/models/m-1/analyze?includeTextDetails=true"
    assert g_url == "http://h/custom/models/m-2?includeKeys=true"
    assert murl == ("http://h/models/m%201%2Fx/analyze?api-version=2.1"
                    "&includeKeys=true")


# ---------------------------------------------------------------------------
# streaming speech over io/ws


WS = {name: importlib.import_module(f"{root}.io.ws")
      for name, root in (("jax", "mmlspark_tpu"),
                         ("port", "mmlspark_tpu_torch"))}
AUDIO = {name: importlib.import_module(f"{root}.services.audio")
         for name, root in (("jax", "mmlspark_tpu"),
                            ("port", "mmlspark_tpu_torch"))}
STREAM = {name: importlib.import_module(f"{root}.services.speech_streaming")
          for name, root in (("jax", "mmlspark_tpu"),
                             ("port", "mmlspark_tpu_torch"))}


class _FakeASR:
    """A streaming recognizer on raw sockets (the JAX tests' fake server,
    on the JAX package's ``server_handshake``): a hypothesis a frame, a
    phrase each 4 frames and at the end of audio. Records every frame
    it receives as (opcode, text or binary length)."""

    def __init__(self):
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.url = f"ws://127.0.0.1:{self.srv.getsockname()[1]}/stt"
        self.frames, self.lock = [], threading.Condition()
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                c, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(c,),
                             daemon=True).start()

    def _handle(self, conn):
        ws_mod = WS["jax"]
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = conn.recv(4096)
            if not chunk:
                return
            head += chunk
        ws, path = ws_mod.server_handshake(conn, head)
        frames, utt, offset, cfg, seen = 0, 0, 0, None, []
        while True:
            opcode, payload = ws.recv()
            if opcode == ws_mod.OP_CLOSE:
                break
            if opcode == ws_mod.OP_TEXT:
                msg = json.loads(payload.decode())
                seen.append(("text", msg))
                if msg["type"] == "speech.config":
                    cfg = msg["format"]
                elif msg["type"] == "audio.end":
                    if frames % 4:
                        ws.send_text(json.dumps(
                            {"type": "speech.phrase",
                             "text": f"utterance {utt}", "offset": offset,
                             "duration": frames % 4}))
                    ws.send_text(json.dumps({"type": "speech.end",
                                             "config_seen": cfg is not None}))
                    break
            elif opcode == ws_mod.OP_BINARY:
                seen.append(("binary", len(payload)))
                frames += 1
                ws.send_text(json.dumps({"type": "speech.hypothesis",
                                         "text": f"hyp {frames}"}))
                if frames % 4 == 0:
                    ws.send_text(json.dumps(
                        {"type": "speech.phrase", "text": f"utterance {utt}",
                         "offset": offset, "duration": 4}))
                    utt += 1
                    offset = frames
        with self.lock:
            self.frames.append((path, seen))
            self.lock.notify_all()

    def take(self, sessions):
        """The frames of the next ``sessions`` sessions to end, sorted."""
        with self.lock:
            assert self.lock.wait_for(lambda: len(self.frames) >= sessions,
                                      timeout=15)
            out, self.frames = sorted(self.frames, key=repr), []
        return out

    def close(self):
        self.srv.close()


@pytest.fixture(scope="module")
def asr():
    srv = _FakeASR()
    yield srv
    srv.close()


def _wav(n_samples=32000, rate=16000):  # 2 s at 16 kHz: 20 100 ms frames
    pcm = (np.sin(np.linspace(0, 100, n_samples)) * 3000).astype("<i2")
    body = pcm.tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt \
        + b"data" + struct.pack("<I", len(body)) + body
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _bad_codec():
    bad = _wav()
    i = bad.index(b"fmt ") + 8
    return bad[:i] + struct.pack("<H", 7) + bad[i + 2:]


def test_audio_streams_equal():
    def run(name):
        a = AUDIO[name]
        fmt, payload = a.parse_wav(_wav())
        with pytest.raises(ValueError, match="codec"):
            a.parse_wav(_bad_codec())
        s = a.PushAudioStream()
        got = []
        t = threading.Thread(target=lambda: got.append(s.read(4, timeout=5)))
        t.start()
        s.write(b"abcd")
        t.join(5)
        s.close()
        pull = a.PullAudioStream(payload, fmt)
        reads = [pull.read(fmt.frame_bytes(100)) for _ in range(3)]
        return ((fmt.sample_rate, fmt.bits_per_sample, fmt.channels),
                len(payload), got, s.read(4),
                a.AudioFormat(16000, 16, 2).frame_bytes(100), reads)

    got = {name: run(name) for name in WS}
    assert got["port"] == got["jax"]
    assert got["port"][:4] == ((16000, 16, 1), 64000, [b"abcd"], b"")
    assert got["port"][4] % 4 == 0


def test_websocket_echo_roundtrip(asr):
    def run(name):
        w = WS[name]
        u = urlparse(asr.url)
        ws = w.client_connect(u.hostname, u.port, u.path)
        ws.send_text(json.dumps({"type": "speech.config", "format": {}}))
        ws.send_binary(b"x" * 70000)       # the 64-bit length path
        op, payload = ws.recv()
        ws.close()
        return op == w.OP_TEXT, json.loads(payload)

    got = {name: (run(name), asr.take(1)) for name in WS}
    assert got["port"] == got["jax"]
    assert got["port"][0] == (True, {"type": "speech.hypothesis",
                                     "text": "hyp 1"})


def test_recognition_session_phrases_and_interims(asr):
    def run(name):
        a = AUDIO[name]
        fmt, payload = a.parse_wav(_wav())
        interims = []
        sess = STREAM[name].SpeechRecognitionSession(
            asr.url, frame_millis=100,
            recognizing=lambda e: interims.append(e["text"]))
        phrases = sess.run(a.PullAudioStream(payload, fmt))
        live = a.PushAudioStream(a.AudioFormat())
        out = []
        t = threading.Thread(target=lambda: out.append(
            STREAM[name].SpeechRecognitionSession(
                asr.url, frame_millis=100).run(live)))
        t.start()
        for _ in range(8):
            live.write(b"\0" * a.AudioFormat().frame_bytes(100))
        live.close()
        t.join(15)
        return phrases, interims, out

    got = {name: (run(name), asr.take(2)) for name in WS}
    assert got["port"] == got["jax"]
    phrases, interims, live = got["port"][0]
    assert [p["text"] for p in phrases] == [f"utterance {i}"
                                            for i in range(5)]
    assert len(interims) == 20 and phrases[1]["offset"] == 4
    assert len(live) == 1 and len(live[0]) == 2


@pytest.mark.parametrize("concurrency", [1, 3])
def test_streaming_stage_rows(asr, concurrency):
    wav = _wav()

    def run(name):
        pkg = PKGS[name]
        rows = [wav, None, wav] if concurrency == 1 else [wav] * 6
        t = (STREAM[name].SpeechToTextStreaming(
            url=asr.url, output_col="utts", error_col="err",
            interim_col="hyps", concurrency=concurrency)
            .set_vector_param("audio_data", "audio"))
        return t.transform(frame(pkg, {"audio": rows}))

    out = {}
    for name in WS:
        out[name] = (run(name), asr.take(2 if concurrency == 1 else 6))
    assert out["port"][1] == out["jax"][1]
    port = same_cols({k: v[0] for k, v in out.items()}, "utts", "err",
                     "hyps")
    assert [p["text"] for p in port["utts"][0]] == \
        [f"utterance {i}" for i in range(5)]
    assert port["err"][0] is None
    if concurrency == 1:
        assert port["utts"][1] is None and len(port["hyps"][2]) == 20


def test_streaming_stage_error_column():
    def run(name):
        t = (STREAM[name].SpeechToTextStreaming(
            url="ws://127.0.0.1:9/none", output_col="utts", error_col="err",
            timeout=2).set_vector_param("audio_data", "audio"))
        return t.transform(frame(PKGS[name], {"audio": [_wav()]}))

    out = {name: run(name) for name in WS}
    port = same_cols(out, "utts", "err")
    assert port["utts"][0] is None and "error" in port["err"][0]


# ---------------------------------------------------------------------------
# SimpleDetectAnomalies' local detector


def _anomaly_frame(pkg, lengths, seed):
    rng = np.random.default_rng(seed)
    groups, values = [], []
    for g, n in enumerate(lengths):
        v = rng.standard_normal(n) * rng.uniform(0.5, 50.0)
        v[rng.integers(0, n)] += 40.0 * (g % 3)        # a planted spike
        groups += [f"g{g}"] * n
        values.append(v)
    vals = np.concatenate(values)
    order = rng.permutation(len(vals))                 # groups interleave
    return frame(pkg, {"group": [groups[i] for i in order],
                       "timestamp": np.arange(len(vals)),
                       "value": vals[order]})


def _local(pkg, df, **kw):
    if pkg.name == "port":
        kw["device"] = "cpu"
    t = pkg.services.SimpleDetectAnomalies(output_col="an", error_col="error",
                                           **kw)
    return t.transform(df)


@pytest.mark.parametrize("lengths", [
    (8,),                              # the JAX test's one group
    (7, 5, 3, 1, 9),                   # odd counts: one middle value
    (8, 6, 4, 2, 10, 2016),            # even counts: two middle values
    (12, 13, 1, 2, 40, 41),
], ids=["jax_case", "odd", "even", "mixed"])
def test_local_detector_bitwise_the_jax_function(lengths):
    if lengths == (8,):
        vals = np.asarray([1, 1.1, 0.9, 1, 25.0, 1.05, 0.98, 1.02])
        dfs = {n: frame(p, {"group": ["g"] * 8, "timestamp": np.arange(8),
                            "value": vals}) for n, p in PKGS.items()}
    else:
        dfs = {n: _anomaly_frame(p, lengths, len(lengths))
               for n, p in PKGS.items()}
    out = {n: _local(p, dfs[n]) for n, p in PKGS.items()}
    j = np.asarray([d["score"] for d in out["jax"]["an"]], np.float32)
    p = np.asarray([d["score"] for d in out["port"]["an"]], np.float32)
    assert np.array_equal(j.view(np.int32), p.view(np.int32))
    port = same_cols(out, "an", "error")
    assert all(e is None for e in port["error"])
    if lengths == (8,):
        assert [d["isAnomaly"] for d in port["an"]] == \
            [False, False, False, False, True, False, False, False]


def test_torch_median_would_not_do():
    """``torch.median`` returns the lower middle value of an even count:
    swapped in for the midpoint median, the scores leave the JAX
    function's (so the test above catches the swap)."""
    from mmlspark_tpu_torch.services import anomaly

    def lower_median(v, gid, n_groups):
        v = v.to(torch.float32)
        med = torch.stack([v[gid == g].median() for g in range(n_groups)])
        dev = torch.abs(v - med[gid])
        mad = torch.stack([dev[gid == g].median()
                           for g in range(n_groups)]) + 1e-9
        return 0.6745 * dev / mad[gid]

    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    gid = torch.from_numpy(np.repeat(np.arange(4), 10))
    assert not torch.equal(lower_median(v, gid, 4), anomaly.mad_z(v, gid, 4))
    odd = torch.from_numpy(np.repeat(np.arange(4), [9, 9, 11, 11]))
    v = v[:40]
    assert torch.equal(lower_median(v, odd, 4), anomaly.mad_z(v, odd, 4))


def test_local_detector_nan_group_and_threshold():
    vals = np.asarray([1.0, np.nan, 2.0, 3.0, 1.0, 2.0, 3.0, 50.0])
    out = {n: _local(p, frame(p, {"group": ["a"] * 3 + ["b"] * 5,
                                  "timestamp": np.arange(8),
                                  "value": vals}), local_threshold=2.0)
           for n, p in PKGS.items()}
    j = [d["score"] for d in out["jax"]["an"]]
    p = [d["score"] for d in out["port"]["an"]]
    assert np.array_equal(np.asarray(j), np.asarray(p), equal_nan=True)
    assert [d["isAnomaly"] for d in out["port"]["an"]] == \
        [d["isAnomaly"] for d in out["jax"]["an"]]
    assert np.isnan(p[:3]).all() and out["port"]["an"][7]["isAnomaly"]


def test_local_detector_saves_loads_and_splits_its_seconds(tmp_path):
    s = PKGS["port"].services
    t = s.SimpleDetectAnomalies(device="cpu", output_col="an",
                                local_threshold=3.0)
    df = _anomaly_frame(PKGS["port"], (16, 17), 3)
    a = t.transform(df)
    assert set(t.phase_seconds) == {"host_grouping", "device",
                                    "result_dicts"}
    t.save(str(tmp_path / "sda"))
    b = s.SimpleDetectAnomalies.load(str(tmp_path / "sda"), device="cpu"
                                     ).transform(df)
    assert list(a["an"]) == list(b["an"])
