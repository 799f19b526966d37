"""Port parity: ``mmlspark_tpu_torch/services`` (the service framework and
the text, translation, vision, geospatial, anomaly and search families)
against the JAX package, after the reference's ``tests/test_services.py``
and ``tests/test_services_text.py``.

Every case runs once through each package against one local mock
service that records every request (``test_torch_http.Mock``): both must
send the same method, path, query string, body bytes and caller-set
headers, and give equal output and error columns. The mock answers as
the JAX tests' mocks do (sentiment, languages, translation and
dictionary, vision with 202 + ``Operation-Location`` polling, Azure-Maps
202 + ``Location`` polling, anomaly detection, search index, the text
family's batching, PII, multi-task analyze and healthcare jobs).
"""

import threading

import numpy as np
import pytest
import torch

from test_torch_http import PKGS, both, frame, same_cols, serve

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def _start_op(mock, req, prefix, where, header="Operation-Location",
              extra=None):
    with mock.lock:
        mock.state["op_counter"] = mock.state.get("op_counter", 0) + 1
        op = f"{prefix}{mock.state['op_counter']}"
        mock.state.setdefault("ops", {})[op] = 0
        if extra is not None:
            mock.state[f"result_{op}"] = extra
    return 202, [(header, f"http://{req.host}/{where}/{op}")], {}


def _poll(mock, op):
    with mock.lock:
        ops = mock.state.setdefault("ops", {})
        n = ops.get(op, 0)
        ops[op] = n + 1
    return n


def _svc_route(mock, req):
    """The JAX tests' ``_MockService`` (tests/test_services.py)."""
    q, body, p = req.query, req.json, req.path
    if req.method == "GET":
        if p.startswith("/operations/"):
            if _poll(mock, p.rsplit("/", 1)[1]) < 2:
                return 200, [], {"status": "running"}
            return 200, [], {"status": "succeeded",
                             "analyzeResult": {"lines": ["hello world"]}}
        if p == "/images/search":
            return 200, [], {"value": [{"contentUrl": "http://x/img.png",
                                        "name": q["q"][0]}]}
        if p.startswith("/maps/batch/"):
            op = p.rsplit("/", 1)[1]
            if _poll(mock, op) < 2:
                return 202, [], {}
            return 200, [], mock.state[f"result_{op}"]
        return 404, [], {"error": "not found"}
    if body is None and req.body[:1] not in (b"{", b"["):
        body = req.body
    if p == "/echo_query":
        return 200, [], {"query": q}
    if p == "/text/sentiment":
        if req.headers.get("Ocp-Apim-Subscription-Key") != "secret":
            return 401, [], {"error": "key"}
        doc = body["documents"][0]
        sent = "positive" if "good" in doc["text"] else "negative"
        return 200, [], {"documents": [
            {"id": doc["id"], "sentiment": sent,
             "confidenceScores": {"positive": 0.9}}]}
    if p == "/text/languages":
        return 200, [], {"documents": [
            {"id": "0", "detectedLanguage": {"iso6391Name": "fr"}}]}
    if p == "/translate":
        to = q["to"][0]
        return 200, [], [{"translations": [{"text": f"<{to}>{d['Text']}",
                                            "to": to}]} for d in body]
    if p == "/dictionary/lookup":
        return 200, [], [{"normalizedSource": d["Text"].lower(),
                          "translations": [{"normalizedTarget": "volar"}]}
                         for d in body]
    if p == "/dictionary/examples":
        return 200, [], [{"normalizedSource": d["Text"],
                          "normalizedTarget": d["Translation"],
                          "examples": [{"sourceTerm": d["Text"],
                                        "targetTerm": d["Translation"]}]}
                         for d in body]
    if p == "/vision/analyze":
        return 200, [], {"categories": [{"name": "outdoor", "score": 0.9}],
                         "url_seen": body.get("url")}
    if p in ("/vision/ocr", "/vision/read"):
        return _start_op(mock, req, "op", "operations")
    if p == "/vision/thumb":
        return 200, [("Content-Type", "image/png")], b"\x89PNG-fake-thumb"
    if p.startswith("/vision/models/"):
        model = p.split("/")[3]
        return 200, [], {"result": {"celebrities": [
            {"name": f"famous-{model}", "confidence": 0.99}]}}
    if p == "/maps/geocode":
        items = [{"response": {"results": [
            {"position": {"lat": 47.6, "lon": -122.1},
             "query": it["query"]}]}} for it in body.get("batchItems", [])]
        return _start_op(mock, req, "maps", "maps/batch", "Location",
                         {"batchItems": items})
    if p == "/anomaly/entire":
        vals = [pt["value"] for pt in body["series"]]
        med = sorted(vals)[len(vals) // 2]
        return 200, [], {"isAnomaly": [abs(v - med) > 50 for v in vals]}
    if p == "/search/index":
        if req.headers.get("api-key") != "sk":
            return 401, [], {"error": "key"}
        return 200, [], {"value": []}
    return 404, [], {"error": "not found"}


@pytest.fixture
def svc():
    yield from serve(_svc_route)


def _obj(values):
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        col[i] = v
    return col


def _text_sentiment(pkg, base):
    t = pkg.services.TextSentiment(url=base + "/text/sentiment",
                                   output_col="out", error_col="err",
                                   concurrency=2)
    t.set_scalar_param("subscription_key", "secret")
    t.set_vector_param("text", "txt")
    return t.transform(frame(pkg, {"txt": ["good day", "bad day", None]}))


def _check_text_sentiment(out):
    assert out["out"][0]["sentiment"] == "positive"
    assert out["out"][1]["sentiment"] == "negative"
    assert out["out"][2] is None and out["err"][2] is None


def _language_detector(pkg, base):
    t = pkg.services.LanguageDetector(url=base + "/text/languages",
                                      output_col="out", error_col="err")
    t.set_vector_param("text", "text")
    return t.transform(frame(pkg, {"text": ["bonjour"]}))


def _translate(pkg, base):
    t = pkg.services.Translate(url=base + "/translate", output_col="out",
                               error_col="err")
    t.set_vector_param("text", "text")
    t.set_scalar_param("to_language", "de")
    return t.transform(frame(pkg, {"text": ["hello"]}))


def _translate_multi(pkg, base):
    t = pkg.services.Translate(url=base + "/translate", output_col="out",
                               error_col="err")
    t.set_vector_param("text", "texts")
    t.set_scalar_param("to_language", ["de", "it"])
    return t.transform(frame(pkg, {"texts": [["hello", "bye"]]}))


def _dictionary_lookup(pkg, base):
    t = pkg.services.DictionaryLookup(url=base + "/dictionary/lookup",
                                      output_col="out", error_col="err")
    t.set_vector_param("text", "w")
    t.set_scalar_param("from_language", "en")
    t.set_scalar_param("to_language", "es")
    return t.transform(frame(pkg, {"w": ["Fly"]}))


def _dictionary_examples(pkg, base):
    t = pkg.services.DictionaryExamples(url=base + "/dictionary/examples",
                                        output_col="out", error_col="err")
    t.set_vector_param("text_and_translation", "pair")
    t.set_scalar_param("from_language", "en")
    t.set_scalar_param("to_language", "es")
    one = t.transform(frame(pkg, {"pair": _obj([("fly", "volar")])}))
    two = t.transform(frame(pkg, {"pair": _obj(
        [[("fly", "volar"), ("run", "correr")]])}))
    return pkg.core.DataFrame({
        "out": _obj([one["out"][0], two["out"][0]]),
        "err": _obj([one["err"][0], two["err"][0]])})


def _analyze_image(pkg, base):
    t = pkg.services.AnalyzeImage(url=base + "/vision/analyze",
                                  output_col="out", error_col="err")
    t.set_vector_param("image_url", "url")
    t.set_scalar_param("visual_features", "Categories,Tags")
    return t.transform(frame(pkg, {"url": ["http://images/1.png"]}))


def _ocr(pkg, base):
    t = pkg.services.OCR(url=base + "/vision/ocr", output_col="out",
                         error_col="err", polling_delay_ms=5)
    t.set_vector_param("image_url", "url")
    return t.transform(frame(pkg, {"url": ["http://images/2.png"]}))


def _read_image(pkg, base):
    t = pkg.services.ReadImage(url=base + "/vision/read", output_col="out",
                               error_col="err", polling_delay_ms=5,
                               language="de")
    t.set_vector_param("image_url", "image_url")
    out = t.transform(frame(pkg, {"image_url": ["http://x/a.png"]}))
    payload = {"analyzeResult": {"readResults": [
        {"lines": [{"text": "hello"}, {"text": "world"}]}]}}
    flat = pkg.services.flatten_read(_obj([payload, None]))
    return out.with_column("flat", _obj([list(flat)]))


def _read_language_validated(pkg, base):
    t = pkg.services.ReadImage(url=base + "/vision/read", output_col="out",
                               error_col="err", polling_delay_ms=5)
    t.set_vector_param("image_url", "u")
    t.set_vector_param("language", "lang")
    return t.transform(frame(pkg, {"u": ["http://x/a.png", "http://x/b.png"],
                                   "lang": ["xx", "de"]}))


def _recognize_text(pkg, base):
    cls = pkg.services.RecognizeText
    good = cls(url=base + "/vision/ocr", output_col="out", error_col="err",
               polling_delay_ms=5, mode="Handwritten")
    good.set_vector_param("image_url", "u")
    bad = cls(url=base + "/vision/ocr", output_col="out", error_col="err",
              mode="Cursive")
    bad.set_vector_param("image_url", "u")
    df = frame(pkg, {"u": ["http://x/a.png"]})
    a, b = good.transform(df), bad.transform(df)
    return pkg.core.DataFrame({"out": _obj([a["out"][0], b["out"][0]]),
                               "err": _obj([a["err"][0], b["err"][0]])})


def _thumbnails(pkg, base):
    t = pkg.services.GenerateThumbnails(url=base + "/vision/thumb",
                                        output_col="out", error_col="err",
                                        width=40, height=30,
                                        smart_cropping=True)
    t.set_vector_param("image_url", "u")
    return t.transform(frame(pkg, {"u": ["http://x/a.png"]}))


def _domain_content(pkg, base):
    t = pkg.services.RecognizeDomainSpecificContent(
        url=base + "/vision", output_col="out", error_col="err")
    t.set_vector_param("image_url", "u")
    t.set_vector_param("model", "m")
    return t.transform(frame(pkg, {"u": ["http://x/a.png", "http://x/b.png"],
                                   "m": ["celebrities", "landmarks"]}))


def _maps_geocoder(pkg, base):
    t = pkg.services.AddressGeocoder(url=base + "/maps/geocode",
                                     output_col="out", error_col="err",
                                     polling_delay_ms=5,
                                     subscription_key="mk")
    t.set_vector_param("address", "addrs")
    return t.transform(frame(pkg, {"addrs": _obj([["1 Main St",
                                                   "2 Side Ave"]])}))


def _detect_anomalies(pkg, base):
    series = [{"timestamp": str(i), "value": float(v)}
              for i, v in enumerate([1, 2, 1, 2, 99, 2])]
    t = pkg.services.DetectAnomalies(url=base + "/anomaly/entire",
                                     output_col="out", error_col="err")
    t.set_vector_param("series", "s")
    return t.transform(frame(pkg, {"s": _obj([series])}))


def _simple_detect_grouped(pkg, base):
    n = 6
    df = frame(pkg, {
        "group": ["a"] * n + ["b"] * n, "timestamp": np.arange(2 * n),
        "value": np.asarray([1, 2, 1, 2, 99, 2] + [5, 5, 5, 5, 5, -80],
                            dtype=np.float64)})
    t = pkg.services.SimpleDetectAnomalies(url=base + "/anomaly/entire",
                                           output_col="out", error_col="err",
                                           concurrency=2)
    return t.transform(df)


def _bing(pkg, base):
    t = pkg.services.BingImageSearch(url=base + "/images/search",
                                     output_col="out", error_col="err")
    t.set_vector_param("query", "q")
    return t.transform(frame(pkg, {"q": ["cats"]}))


def _error_endpoint(pkg, base):
    t = pkg.services.TextSentiment(url=base + "/nope", output_col="out",
                                   error_col="err")
    t.set_vector_param("text", "txt")
    return t.transform(frame(pkg, {"txt": ["x"]}))


def _malformed_url(pkg, base):
    t = pkg.services.TextSentiment(url="notaurl", output_col="out",
                                   error_col="err", timeout=2.0)
    t.set_vector_param("text", "txt")
    return t.transform(frame(pkg, {"txt": ["x", "y"]}))


def _bool_url_params(pkg, base):
    SP, ST = pkg.base.ServiceParam, pkg.base.ServiceTransformer

    class _BoolSvc(ST):
        flag = SP(bool, default=True, is_url_param=True,
                  payload_name="returnFaceId")
        text = SP(str, is_required=True)

    a = _BoolSvc(url=base + "/echo_query", output_col="out", error_col="err")
    a.set_vector_param("text", "txt")
    one = a.transform(frame(pkg, {"txt": ["a"]}))
    b = _BoolSvc(url=base + "/echo_query", output_col="out", error_col="err")
    b.set_vector_param("text", "txt")
    b.set_vector_param("flag", "flagcol")
    two = b.transform(frame(pkg, {"txt": ["a"], "flagcol": np.array([False])}))
    return pkg.core.DataFrame({"out": _obj([one["out"][0], two["out"][0]]),
                               "err": _obj([one["err"][0], two["err"][0]])})


def _find_similar_face(pkg, base):
    cls = pkg.services.FindSimilarFace
    df = frame(pkg, {"fid": ["f-1"]})
    outs, errs = [], []
    none = cls(url=base + "/echo_query", output_col="out", error_col="err",
               method="POST")
    none.set_vector_param("face_id", "fid")
    runs = [none.transform(df)]
    none.set_scalar_param("face_list_id", "fl")
    none.set_scalar_param("face_ids", ["a", "b"])
    runs.append(none.transform(df))
    for mode in ("matchFace", "bestMatch"):
        t = cls(url=base + "/echo_query", output_col="out", error_col="err")
        t.set_vector_param("face_id", "fid")
        t.set_scalar_param("face_list_id", "fl")
        t.set_scalar_param("mode", mode)
        runs.append(t.transform(df))
    for r in runs:
        outs.append(r["out"][0])
        errs.append(r["err"][0])
    return pkg.core.DataFrame({"out": _obj(outs), "err": _obj(errs)})


def _check_find_similar(out):
    assert out["out"][0] is None
    assert "exactly one" in out["err"][0]["reasonPhrase"]
    assert "exactly one" in out["err"][1]["reasonPhrase"]
    assert out["err"][2] is None
    assert "matchPerson" in out["err"][3]["reasonPhrase"]


#: name -> (case, ordered requests, the JAX test's own assertions)
CASES = {
    "text_sentiment": (_text_sentiment, False, _check_text_sentiment),
    "language_detector": (_language_detector, True, lambda o: o["out"][0][
        "iso6391Name"] == "fr"),
    "translate": (_translate, True,
                  lambda o: o["out"][0][0]["text"] == "<de>hello"),
    "translate_multi": (_translate_multi, True, lambda o: [
        r[0]["text"] for r in o["out"][0]] == ["<de,it>hello",
                                               "<de,it>bye"]),
    "dictionary_lookup": (_dictionary_lookup, True, lambda o: o["out"][0][
        "translations"][0]["normalizedTarget"] == "volar"),
    "dictionary_examples": (_dictionary_examples, True, lambda o: (
        o["out"][0]["examples"][0]["targetTerm"] == "volar"
        and [r["normalizedTarget"] for r in o["out"][1]]
        == ["volar", "correr"])),
    "analyze_image": (_analyze_image, True, lambda o: o["out"][0][
        "url_seen"] == "http://images/1.png"),
    "ocr_polling": (_ocr, True, lambda o: o["out"][0]["analyzeResult"][
        "lines"] == ["hello world"]),
    "read_image_flatten": (_read_image, True, lambda o: (
        o["out"][0]["status"] == "succeeded"
        and o["flat"][0] == ["hello world", None])),
    "read_language_validated": (_read_language_validated, True, lambda o: (
        o["out"][0] is None and "language" in o["err"][0]["reasonPhrase"]
        and o["out"][1]["status"] == "succeeded")),
    "recognize_text_mode": (_recognize_text, True, lambda o: (
        o["out"][0]["status"] == "succeeded" and o["out"][1] is None
        and "mode" in o["err"][1]["reasonPhrase"])),
    "thumbnails_bytes": (_thumbnails, True,
                         lambda o: o["out"][0] == b"\x89PNG-fake-thumb"),
    "domain_content_url_per_row": (_domain_content, True, lambda o: (
        o["out"][1]["result"]["celebrities"][0]["name"]
        == "famous-landmarks")),
    "maps_geocoder_async": (_maps_geocoder, True, lambda o: (
        len(o["out"][0]) == 2 and o["out"][0][0]["response"]["results"][0][
            "position"]["lat"] == 47.6)),
    "detect_anomalies": (_detect_anomalies, True, lambda o: o["out"][0][
        "isAnomaly"] == [False, False, False, False, True, False]),
    "simple_detect_grouped": (_simple_detect_grouped, False, lambda o: (
        [v["isAnomaly"] for v in o["out"]].count(True) == 2
        and o["out"][4]["isAnomaly"] and o["out"][11]["isAnomaly"])),
    "bing_image_search": (_bing, True,
                          lambda o: o["out"][0][0]["name"] == "cats"),
    "error_endpoint": (_error_endpoint, True, lambda o: (
        o["out"][0] is None and o["err"][0]["statusCode"] == 404)),
    "malformed_url": (_malformed_url, True, lambda o: (
        o["out"][1] is None
        and o["err"][0]["reasonPhrase"] == "request failed")),
    "bool_url_params": (_bool_url_params, True, lambda o: (
        o["out"][0]["query"]["returnFaceId"] == ["true"]
        and o["out"][1]["query"]["returnFaceId"] == ["false"])),
    "find_similar_face": (_find_similar_face, True, _check_find_similar),
}


@pytest.mark.parametrize("name", list(CASES))
def test_service_family_same_requests_and_columns(svc, name):
    case, ordered, check = CASES[name]
    out = both(svc, lambda pkg: case(pkg, svc.base), ordered=ordered)
    port = same_cols(out, *[c for c in ("out", "err", "flat")
                            if c in out["jax"].columns])
    res = check(port)
    assert res is None or res


def test_azure_search_writer(svc):
    def run(pkg):
        df = frame(pkg, {"id": ["1", "2", "3"],
                         "score": np.asarray([0.1, 0.2, 0.3])})
        w = pkg.services.AzureSearchWriter(svc.base + "/search/index",
                                           api_key="sk", batch_size=2)
        return w.write(df)

    out = both(svc, run)
    assert out["port"] == out["jax"] == 2
    import json
    docs = [d for r in svc.log for d in json.loads(r["body"])["value"]]
    assert len(docs) == 3 and docs[0]["@search.action"] == "upload"


def test_service_transformer_save_load(tmp_path, svc):
    def run(pkg):
        t = pkg.services.TextSentiment(url=svc.base + "/text/sentiment",
                                       output_col="out", error_col="err")
        t.set_scalar_param("subscription_key", "secret")
        t.set_vector_param("text", "txt")
        path = str(tmp_path / pkg.name)
        t.save(path)
        return type(t).load(path).transform(frame(pkg, {"txt": ["good"]}))

    port = same_cols(both(svc, run), "out", "err")
    assert port["out"][0]["sentiment"] == "positive"


# ---------------------------------------------------------------------------
# the text family's batching, PII, multi-task analyze and healthcare


def _text_route(mock, req):
    """The JAX tests' ``_TextMock`` (tests/test_services_text.py)."""
    p = req.path
    if req.method == "GET":
        if not p.startswith("/poll/"):
            return 404, [], {"error": "not found"}
        op = p.rsplit("/", 1)[1]
        if _poll(mock, op) < 1:
            return 200, [], {"status": "running"}
        docs = mock.state[f"result_{op}"]
        if op.startswith("analyze"):
            return 200, [], {"status": "succeeded", "tasks": {
                "entityRecognitionTasks": [{"state": "succeeded", "results": {
                    "documents": [{"id": d["id"], "entities": [
                        {"text": d["text"], "category": "Noun"}]}
                        for d in docs], "errors": []}}],
                "sentimentAnalysisTasks": [{"state": "succeeded", "results": {
                    "documents": [{"id": d["id"], "sentiment": "neutral"}
                                  for d in docs[:-1]],
                    "errors": [{"id": docs[-1]["id"],
                                "error": {"code": "boom"}}]
                    if docs else []}}]}}
        return 200, [], {"status": "succeeded", "results": {
            "documents": [{"id": d["id"],
                           "entities": [{"text": "ibuprofen",
                                         "category": "Drug"}],
                           "relations": []} for d in docs], "errors": []}}
    body = req.json
    if p == "/sentiment":
        docs, errs = [], []
        for d in body["documents"]:
            if d["text"] == "ERR":
                errs.append({"id": d["id"],
                             "error": {"code": "InvalidDocument"}})
            else:
                docs.append({"id": d["id"], "sentiment": "positive"
                             if "good" in d["text"] else "negative",
                             "confidenceScores": {"positive": 0.8}})
        return 200, [], {"documents": docs, "errors": errs}
    if p == "/languages":
        return 200, [], {"documents": [
            {"id": d["id"], "detectedLanguage":
                {"iso6391Name": (d.get("language") or "xx")[:2]}}
            for d in body["documents"]]}
    if p == "/pii":
        return 200, [], {"documents": [
            {"id": d["id"], "redactedText": "*" * len(d["text"]),
             "entities": [{"category": "Email"}]}
            for d in body["documents"]]}
    if p == "/analyze":
        return _start_op(mock, req, "analyze", "poll",
                         extra=body["analysisInput"]["documents"])
    if p == "/health/jobs":
        return _start_op(mock, req, "health", "poll",
                         extra=body["documents"])
    return 404, [], {"error": "not found"}


@pytest.fixture
def text_svc():
    yield from serve(_text_route)


def _auto_batching(pkg, base):
    t = pkg.services.TextSentiment(url=base + "/sentiment", output_col="out",
                                   error_col="err", batch_size=2)
    t.set_vector_param("text", "txt")
    return t.transform(frame(pkg, {"txt": ["good a", "bad b", "ERR",
                                           "good c", "bad d"]}))


def _user_batching(pkg, base):
    t = pkg.services.TextSentiment(url=base + "/sentiment", output_col="out",
                                   error_col="err")
    t.set_vector_param("text", "docs")
    return t.transform(frame(pkg, {"docs": _obj([["good x", "ERR",
                                                  "bad y"]])}))


def _language_broadcast(pkg, base):
    t = pkg.services.LanguageDetectorSDK(url=base + "/languages",
                                         output_col="out", error_col="err")
    t.set_vector_param("text", "docs")
    t.set_scalar_param("language", "fr")
    return t.transform(frame(pkg, {"docs": _obj([["salut", "merci"]])}))


def _pii(pkg, base):
    cls = pkg.services.PII
    good = cls(url=base + "/pii", output_col="out", error_col="err")
    good.set_vector_param("text", "txt")
    good.set_scalar_param("domain", "PHI")
    good.set_scalar_param("pii_categories", ["Email", "Address"])
    bad = cls(url=base + "/pii", output_col="out", error_col="err")
    bad.set_vector_param("text", "txt")
    bad.set_scalar_param("domain", "everything")
    df = frame(pkg, {"txt": ["mail me at a@b.c"]})
    a, b = good.transform(df), bad.transform(df)
    return pkg.core.DataFrame({"out": _obj([a["out"][0], b["out"][0]]),
                               "err": _obj([a["err"][0], b["err"][0]])})


def _text_analyze(pkg, base):
    t = pkg.services.TextAnalyze(
        url=base + "/analyze", output_col="out", error_col="err",
        batch_size=25, polling_delay_ms=5,
        entity_recognition_tasks=[{"parameters": {"model-version":
                                                  "latest"}}],
        sentiment_analysis_tasks=[{"parameters": {}}])
    t.set_vector_param("text", "txt")
    return t.transform(frame(pkg, {"txt": ["alpha", "beta"]}))


def _text_analyze_shape(pkg, base):
    t = pkg.services.TextAnalyze(url=base + "/analyze", output_col="out",
                                 error_col="err",
                                 entity_recognition_tasks=[{"nope": 1}])
    t.set_vector_param("text", "txt")
    return t.transform(frame(pkg, {"txt": ["x"]}))


def _healthcare(pkg, base):
    t = pkg.services.Healthcare(url=base + "/health/jobs", output_col="out",
                                error_col="err", polling_delay_ms=5)
    t.set_vector_param("text", "txt")
    return t.transform(frame(pkg, {"txt": ["took 200mg ibuprofen"]}))


def _url_params(pkg, base):
    t = pkg.services.TextSentiment(url=base + "/sentiment", output_col="out",
                                   error_col="err")
    t.set_vector_param("text", "txt")
    t.set_scalar_param("model_version", "2022-01-01")
    t.set_scalar_param("show_stats", True)
    t.set_scalar_param("opinion_mining", True)
    return t.transform(frame(pkg, {"txt": ["good z"]}))


TEXT_CASES = {
    "auto_batching": (_auto_batching, lambda o, log: (
        [len(__import__("json").loads(r["body"])["documents"])
         for r in log] == [2, 2, 1]
        and o["out"][2] is None
        and o["err"][2]["error"]["code"] == "InvalidDocument"
        and o["out"][3]["sentiment"] == "positive")),
    "user_batching": (_user_batching, lambda o, log: (
        len(o["out"][0]) == 3
        and o["out"][0][1] == {"error": {"code": "InvalidDocument"}})),
    "language_broadcast": (_language_broadcast, lambda o, log: [
        d["iso6391Name"] for d in o["out"][0]] == ["fr", "fr"]),
    "pii": (_pii, lambda o, log: (
        "domain=PHI" in log[0]["query"]
        and "piiCategories=Email%2CAddress" in log[0]["query"]
        and o["out"][0]["redactedText"].startswith("*")
        and "domain" in o["err"][1]["reasonPhrase"])),
    "text_analyze_async": (_text_analyze, lambda o, log: (
        any(r["query"].startswith("$top=25") for r in log
            if r["method"] == "GET")
        and o["out"][1]["sentimentAnalysis"][0]["error"]["code"] == "boom"
        and o["out"][1]["entityRecognition"][0]["result"]["entities"][0][
            "text"] == "beta")),
    "text_analyze_shape": (_text_analyze_shape, lambda o, log: (
        o["out"][0] is None and "parameters" in o["err"][0]["reasonPhrase"])),
    "healthcare_async": (_healthcare, lambda o, log: (
        o["out"][0]["entities"][0]["category"] == "Drug"
        and o["out"][0]["relations"] == [])),
    "url_params": (_url_params, lambda o, log: all(
        s in log[0]["query"] for s in ("model-version=2022-01-01",
                                       "showStats=true",
                                       "opinionMining=true"))),
}


@pytest.mark.parametrize("name", list(TEXT_CASES))
def test_text_family_same_requests_and_columns(text_svc, name):
    case, check = TEXT_CASES[name]
    out = both(text_svc, lambda pkg: case(pkg, text_svc.base))
    port = same_cols(out, "out", "err")
    assert check(port, list(text_svc.log))


def test_sdk_alias_batch_defaults():
    for pkg in PKGS.values():
        assert pkg.services.LanguageDetectorSDK(url="http://x/").get(
            "batch_size") == 5
        assert pkg.services.TextSentiment(url="http://x/").get(
            "batch_size") == 1


def test_async_clients_keep_concurrency_in_flight(svc):
    """A service stage at concurrency 4 never has more than 4 requests
    open at the mock, in either package (the await-before-pull order)."""
    live, peak, lock = [0], [0], threading.Lock()
    inner = svc.route

    def route(mock, req):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        try:
            import time
            time.sleep(0.01)
            return inner(mock, req)
        finally:
            with lock:
                live[0] -= 1

    svc.route = route

    def run(pkg):
        t = pkg.services.LanguageDetector(url=svc.base + "/text/languages",
                                          output_col="out", error_col="err",
                                          concurrency=4)
        t.set_vector_param("text", "text")
        return t.transform(frame(pkg, {"text": [f"t{i}" for i in
                                                range(16)]}))

    out = both(svc, run, ordered=False)
    same_cols(out, "out", "err")
    assert 1 < peak[0] <= 4
