"""Text-analytics service transformers — full reference breadth.

Parity: ``cognitive/.../TextAnalytics.scala`` (626 LoC) op-for-op:
``TextSentiment`` (+ ``opinionMining`` URL param, ``:287-310``),
``LanguageDetector``, ``EntityDetector``, ``NER``, ``KeyPhraseExtractor``,
``PII`` (+ ``domain``/``piiCategories`` URL params, ``:338-360``) and the
async multi-task ``TextAnalyze`` (``:414-560``: five task lists, one
``/analyze`` job per document batch, 202 + Operation-Location long-poll
with ``$top=25`` forced onto the poll URL so a full 25-doc batch comes
back in one page, ``modifyPollingURI :490-509``). The v3 mixin params
(``model-version``/``showStats``/``stringIndexType``,
``TextAnalytics.scala:193-216``) ride as URL params.

Parity: ``cognitive/.../TextAnalyticsSDK.scala`` (751 LoC): the SDK
variants batch documents per request — string columns auto-batch through
``FixedMiniBatchTransformer`` (default 5) and unpack per-document results
back onto rows (``shouldAutoBatch``/``transform``,
``TextAnalyticsSDK.scala:139-186``; doc/error matching by integer id as
in ``TextAnalytics.scala:115-134`` ``unpackBatchUDF``). Here the same
behavior lives in :class:`TextAnalyticsBase` directly: a row whose bound
``text`` value is a LIST is one user-batched request (array output); rows
with scalar text are grouped ``batch_size`` docs per request and results
scatter back one per row. ``*SDK`` aliases pin the SDK default
``batchSize=5`` and carry ``HealthcareSDK`` (``:312-341``), which has no
plain-REST sibling in the reference.

The port's copy of ``mmlspark_tpu/services/text.py`` (host work).
"""

from __future__ import annotations

import json as _json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..core.params import Param
from ..io.http.http_transformer import ErrorUtils
from ..io.http.schema import EntityData, HTTPRequestData
from .base import HasAsyncReply, ServiceParam, ServiceTransformer

__all__ = ["TextAnalyticsBase", "TextSentiment", "LanguageDetector",
           "EntityDetector", "NER", "KeyPhraseExtractor", "PII",
           "TextAnalyze", "Healthcare",
           "TextSentimentSDK", "LanguageDetectorSDK", "EntityDetectorSDK",
           "NERSDK", "KeyPhraseExtractorSDK", "PIISDK", "HealthcareSDK"]

#: closed value set of the reference's stringIndexType param
#: (``TextAnalytics.scala:209-216``)
_STRING_INDEX_TYPES = ("TextElements_v8", "UnicodeCodePoint",
                       "Utf16CodeUnit")


class TextAnalyticsBase(ServiceTransformer):
    """Shared documents/errors request-reply shape
    (``TextAnalytics.scala:53-183``): POST
    ``{"documents": [{id, text, language?}]}``, unpack ``documents`` +
    ``errors`` matched by integer id. ``batch_size`` groups scalar-text
    rows into one request (the SDK variant's auto-batching); a list-typed
    text value is one user-batched request whose output is the per-doc
    array."""

    text = ServiceParam(str, is_required=True,
                        doc="document text (str) or document batch (list)")
    language = ServiceParam(str, doc="language hint: str broadcast to the "
                                     "batch, or per-document list")
    model_version = ServiceParam(str, is_url_param=True,
                                 payload_name="model-version",
                                 doc="service model version, e.g. 'latest'")
    show_stats = ServiceParam(bool, is_url_param=True,
                              payload_name="showStats",
                              doc="return per-document statistics")
    batch_size = Param(int, default=1,
                       doc="scalar-text rows grouped per request")

    # -- per-row document spec ----------------------------------------------
    def _doc_spec(self, row: dict
                  ) -> Optional[Tuple[List[Optional[str]],
                                      List[Optional[str]], bool]]:
        """(texts, langs, user_batched) for a row, or None to skip it."""
        if self.should_skip(row):
            return None
        t = self.get_value_opt(row, "text")
        if t is None:
            return None
        lang = self.get_value_opt(row, "language")
        if isinstance(t, (list, tuple, np.ndarray)):
            texts = [None if x is None else str(x) for x in list(t)]
            if isinstance(lang, (list, tuple, np.ndarray)):
                langs = [None if x is None else str(x) for x in list(lang)]
                if len(langs) == 1:  # single hint broadcasts to the batch
                    langs = langs * len(texts)
            elif lang is None:
                langs = [None] * len(texts)
            else:
                langs = [str(lang)] * len(texts)
            if len(langs) != len(texts):
                raise ValueError(
                    f"language batch has {len(langs)} entries for "
                    f"{len(texts)} documents")
            return texts, langs, True
        if isinstance(lang, (list, tuple, np.ndarray)):
            lang = list(lang)[0] if len(lang) else None
        return [str(t)], [None if lang is None else str(lang)], False

    @staticmethod
    def _docs_payload(texts, langs) -> List[Dict[str, Any]]:
        docs = []
        for k, (t, lang) in enumerate(zip(texts, langs)):
            d: Dict[str, Any] = {"id": str(k), "text": t or ""}
            if lang:
                d["language"] = lang
            docs.append(d)
        return docs

    def _group_payload(self, docs: List[Dict[str, Any]]) -> Dict[str, Any]:
        return {"documents": docs}

    def _build_docs_request(self, lead_row: dict,
                            docs: List[Dict[str, Any]]) -> HTTPRequestData:
        """One request for a document group; URL/headers/query params come
        from the group's lead row (the reference's batched row carries one
        value per batch the same way)."""
        return HTTPRequestData(
            url=self._full_url(lead_row), method="POST",
            headers=self._headers(lead_row),
            entity=EntityData.from_string(
                _json.dumps(self._group_payload(docs))))

    # -- response unpacking --------------------------------------------------
    def _doc_maps(self, body) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """id->document and id->error maps from a response body
        (``unpackBatchUDF``, ``TextAnalytics.scala:115-134``)."""
        docs = {str(d.get("id")): d for d in body.get("documents") or []}
        errs = {str(e.get("id")): e.get("error", e)
                for e in body.get("errors") or []}
        return docs, errs

    def _parse_doc(self, doc):
        """Hook: per-document result extraction."""
        return doc

    # -- execution -----------------------------------------------------------
    def _transform(self, df: DataFrame) -> DataFrame:
        if self.get("url") is None:
            raise ValueError(f"{type(self).__name__}: url must be set")
        rows = list(df.iter_rows())
        n = len(rows)
        outs: List[Any] = [None] * n
        errs: List[Any] = [None] * n

        # group rows: user-batched rows are one request each; scalar rows
        # chunk batch_size docs per request
        groups: List[Tuple[List[int], int, bool]] = []  # (indices, ndocs, user)
        group_docs: List[List[Dict[str, Any]]] = []
        bs = max(1, int(self.get("batch_size") or 1))
        pend_idx: List[int] = []
        pend_docs: List[Dict[str, Any]] = []

        def flush():
            if pend_idx:
                # re-id the chunk 0..k-1 so response matching is positional
                docs = [{**d, "id": str(k)} for k, d in enumerate(pend_docs)]
                groups.append((list(pend_idx), len(docs), False))
                group_docs.append(docs)
                pend_idx.clear()
                pend_docs.clear()

        for i, r in enumerate(rows):
            try:
                spec = self._doc_spec(r)
            except ValueError as e:
                errs[i] = {"statusCode": 400,
                           "reasonPhrase": f"request build failed: {e}"}
                continue
            if spec is None:
                continue  # skipped row: both columns stay null
            texts, langs, user_b = spec
            if user_b:
                groups.append(([i], len(texts), True))
                group_docs.append(self._docs_payload(texts, langs))
            else:
                pend_idx.append(i)
                pend_docs.extend(self._docs_payload(texts, langs))
                if len(pend_idx) >= bs:
                    flush()
        flush()

        requests_: List[Optional[HTTPRequestData]] = []
        build_errs: List[Optional[dict]] = []
        for (idxs, _, _), docs in zip(groups, group_docs):
            try:
                requests_.append(self._build_docs_request(rows[idxs[0]], docs))
                build_errs.append(None)
            except ValueError as e:
                requests_.append(None)
                build_errs.append({"statusCode": 400,
                                   "reasonPhrase":
                                       f"request build failed: {e}"})

        from ..io.http.clients import AsyncHTTPClient, \
            SingleThreadedHTTPClient
        c = self.get("concurrency")
        client = (AsyncHTTPClient(c, handler=self._handle) if c > 1
                  else SingleThreadedHTTPClient(handler=self._handle))
        for g, ((idxs, ndocs, user_b), resp) in enumerate(
                zip(groups, client.send(iter(requests_)))):
            if requests_[g] is None:
                for i in idxs:
                    errs[i] = build_errs[g]
                continue
            ok, err = ErrorUtils.split(resp)
            if ok is None:
                for i in idxs:
                    errs[i] = err
                continue
            try:
                docs, derrs = self._doc_maps(ok.json_content())
            except Exception as e:
                perr = {"statusCode": ok.status_code,
                        "reasonPhrase": f"response parse failed: {e}",
                        "entity": ok.string_content()[:2000]}
                for i in idxs:
                    errs[i] = perr
                continue
            if user_b:
                # array output: one slot per submitted document; an errored
                # doc rides in its slot (the reference's per-element
                # error-message field)
                outs[idxs[0]] = [
                    self._parse_doc(docs[str(k)]) if str(k) in docs
                    else {"error": derrs.get(str(k))}
                    for k in range(ndocs)]
            else:
                for k, i in enumerate(idxs):
                    kid = str(k)
                    if kid in docs:
                        outs[i] = self._parse_doc(docs[kid])
                    else:
                        errs[i] = {"statusCode": ok.status_code,
                                   "reasonPhrase": "document error",
                                   "error": derrs.get(kid)}
        return (df.with_column(self.get("output_col"), object_col(outs))
                  .with_column(self.get("error_col"), object_col(errs)))


class _HasStringIndexType(ServiceTransformer):
    """``stringIndexType`` URL param with the reference's closed value set
    (``TextAnalytics.scala:209-216``)."""

    string_index_type = ServiceParam(str, is_url_param=True,
                                     payload_name="stringIndexType",
                                     doc="offset/length unit: "
                                         + "/".join(_STRING_INDEX_TYPES))

    def _build_docs_request(self, lead_row, docs):
        sit = self.get_value_opt(lead_row, "string_index_type")
        if sit is not None and sit not in _STRING_INDEX_TYPES:
            raise ValueError(f"string_index_type must be one of "
                             f"{_STRING_INDEX_TYPES}, got {sit!r}")
        return super()._build_docs_request(lead_row, docs)


class TextSentiment(_HasStringIndexType, TextAnalyticsBase):
    """Parity: ``TextSentiment`` (``TextAnalytics.scala:287-310``) —
    sentiment label + confidence scores per document; ``opinionMining``
    adds aspect-based results to each sentence."""

    opinion_mining = ServiceParam(bool, is_url_param=True,
                                  payload_name="opinionMining",
                                  doc="include aspect-based sentiment "
                                      "(opinion mining) results")

    def _parse_doc(self, doc):
        return {"sentiment": doc.get("sentiment"),
                "confidenceScores": doc.get("confidenceScores"),
                "sentences": doc.get("sentences")}


class LanguageDetector(TextAnalyticsBase):
    """Parity: ``LanguageDetector`` (``TextAnalytics.scala:363-372``)."""

    def _parse_doc(self, doc):
        return doc.get("detectedLanguage", doc)


class EntityDetector(_HasStringIndexType, TextAnalyticsBase):
    """Parity: ``EntityDetector`` (linked entities,
    ``TextAnalytics.scala:376-386``)."""

    def _parse_doc(self, doc):
        return doc.get("entities", doc)


class NER(_HasStringIndexType, TextAnalyticsBase):
    """Parity: ``NER`` (``TextAnalytics.scala:326-337``)."""

    def _parse_doc(self, doc):
        return doc.get("entities", doc)


class KeyPhraseExtractor(TextAnalyticsBase):
    """Parity: ``KeyPhraseExtractor`` (``TextAnalytics.scala:313-322``)."""

    def _parse_doc(self, doc):
        return doc.get("keyPhrases", doc)


class PII(_HasStringIndexType, TextAnalyticsBase):
    """Parity: ``PII`` (``TextAnalytics.scala:340-360``) — PII entity
    recognition; ``domain`` restricts to a category subset ('PHI' or
    'none'), ``piiCategories`` selects explicit categories."""

    domain = ServiceParam(str, is_url_param=True,
                          doc="PII domain filter: 'PHI' or 'none'")
    pii_categories = ServiceParam(list, is_url_param=True,
                                  payload_name="piiCategories",
                                  doc="explicit PII categories to return")

    def _build_docs_request(self, lead_row, docs):
        dom = self.get_value_opt(lead_row, "domain")
        if dom is not None and dom not in ("PHI", "none"):
            raise ValueError(f"domain must be 'PHI' or 'none', got {dom!r}")
        return super()._build_docs_request(lead_row, docs)

    def get_url_params(self, row):
        q = super().get_url_params(row)
        cats = q.get("piiCategories")
        if isinstance(cats, (list, tuple, np.ndarray)):
            q["piiCategories"] = ",".join(str(c) for c in cats)
        return q

    def _parse_doc(self, doc):
        return {"entities": doc.get("entities"),
                "redactedText": doc.get("redactedText")}


#: wire task-list name -> per-document result field
#: (``TAAnalyzeResponseTasks``/``TAAnalyzeResult``,
#: ``TextAnalyticsAnalyzeSchemas.scala:38-70``)
_ANALYZE_TASKS = (("entityRecognitionTasks", "entityRecognition"),
                  ("entityLinkingTasks", "entityLinking"),
                  ("entityRecognitionPiiTasks", "entityRecognitionPii"),
                  ("keyPhraseExtractionTasks", "keyPhraseExtraction"),
                  ("sentimentAnalysisTasks", "sentimentAnalysis"))


def _check_tasks(name: str, tasks) -> List[Dict[str, Any]]:
    """Validate the reference's task shape: each task is exactly
    ``{"parameters": {...}}`` (``TextAnalyzeTaskParam``,
    ``TextAnalytics.scala:388-412``)."""
    out = []
    for t in tasks or []:
        if not isinstance(t, dict) or "parameters" not in t:
            raise ValueError(f"{name}: each task must include 'parameters'")
        if len(t) > 1:
            raise ValueError(f"{name}: task options should only include "
                             f"'parameters'")
        if not isinstance(t["parameters"], dict):
            raise ValueError(f"{name}: 'parameters' must be a mapping")
        out.append({"parameters": {k: str(v)
                                   for k, v in t["parameters"].items()}})
    return out


class TextAnalyze(TextAnalyticsBase, HasAsyncReply):
    """Parity: ``TextAnalyze`` (``TextAnalytics.scala:414-560``) — one
    async ``/analyze`` job per document batch running up to five task
    families; the poll URL gets ``$top=25`` prefixed so the full 25-doc
    batch returns in one page (``modifyPollingURI :490-509``). Output per
    document: the ``TAAnalyzeResult`` shape — one
    ``{"result":..., "error":...}`` entry per task under
    ``entityRecognition`` / ``entityLinking`` / ``entityRecognitionPii`` /
    ``keyPhraseExtraction`` / ``sentimentAnalysis``."""

    entity_recognition_tasks = Param(list, default=(),
                                     doc="entity recognition tasks")
    entity_recognition_pii_tasks = Param(list, default=(),
                                         doc="PII recognition tasks")
    entity_linking_tasks = Param(list, default=(),
                                 doc="entity linking tasks")
    key_phrase_extraction_tasks = Param(list, default=(),
                                        doc="key phrase tasks")
    sentiment_analysis_tasks = Param(list, default=(),
                                     doc="sentiment analysis tasks")
    display_name = Param(str, default="mmlspark-tpu",
                         doc="job display name")

    def _group_payload(self, docs):
        tasks = {
            "entityRecognitionTasks":
                _check_tasks("entity_recognition_tasks",
                             self.get("entity_recognition_tasks")),
            "entityLinkingTasks":
                _check_tasks("entity_linking_tasks",
                             self.get("entity_linking_tasks")),
            "entityRecognitionPiiTasks":
                _check_tasks("entity_recognition_pii_tasks",
                             self.get("entity_recognition_pii_tasks")),
            "keyPhraseExtractionTasks":
                _check_tasks("key_phrase_extraction_tasks",
                             self.get("key_phrase_extraction_tasks")),
            "sentimentAnalysisTasks":
                _check_tasks("sentiment_analysis_tasks",
                             self.get("sentiment_analysis_tasks")),
        }
        return {"displayName": self.get("display_name"),
                "analysisInput": {"documents": docs},
                "tasks": tasks}

    def _poll_url(self, loc: str, request: HTTPRequestData) -> str:
        # the async API pages at 20 results; force the full 25-doc batch
        # (reference prefixes $top so the API's first-value-wins applies)
        base, _, query = loc.partition("?")
        return f"{base}?$top=25" + (f"&{query}" if query else "")

    def _doc_maps(self, body):
        per_doc: Dict[str, Any] = {}
        for wire, field in _ANALYZE_TASKS:
            for task in (body.get("tasks") or {}).get(wire) or []:
                results = (task or {}).get("results") or {}
                rdocs = {str(d.get("id")): d
                         for d in results.get("documents") or []}
                rerrs = {str(e.get("id")): e.get("error", e)
                         for e in results.get("errors") or []}
                for did in set(rdocs) | set(rerrs):
                    slot = per_doc.setdefault(
                        did, {f: [] for _, f in _ANALYZE_TASKS})
                    slot[field].append({"result": rdocs.get(did),
                                        "error": rerrs.get(did)})
        return per_doc, {}


class Healthcare(TextAnalyticsBase, HasAsyncReply):
    """Parity: ``HealthcareSDK`` (``TextAnalyticsSDK.scala:312-341``) —
    healthcare entity/relation extraction. The REST shape is the v3.1
    ``/entities/health/jobs`` async convention: 202 + Operation-Location,
    terminal body carries ``results.documents``/``results.errors``."""

    def _doc_maps(self, body):
        return super()._doc_maps(body.get("results") or body)

    def _parse_doc(self, doc):
        return {"entities": doc.get("entities"),
                "relations": doc.get("relations")}


# -- SDK variants ------------------------------------------------------------
# The reference ships a second, SDK-backed family whose distinguishing
# behaviors are document batching (default 5) and the same per-document
# outputs (``TextAnalyticsSDK.scala:85-196``). Those behaviors live in
# TextAnalyticsBase here; the aliases pin the SDK batch default so a
# reference user finds the exact class names.

class TextSentimentSDK(TextSentiment):
    """Parity: ``TextSentimentSDK`` (``TextAnalyticsSDK.scala:256-282``)."""
    batch_size = Param(int, default=5, doc="documents per request")


class LanguageDetectorSDK(LanguageDetector):
    """Parity: ``LanguageDetectorSDK`` (``TextAnalyticsSDK.scala:198-223``)."""
    batch_size = Param(int, default=5, doc="documents per request")


class EntityDetectorSDK(EntityDetector):
    """Parity: ``EntityDetectorSDK`` (``TextAnalyticsSDK.scala:345-369``)."""
    batch_size = Param(int, default=5, doc="documents per request")


class NERSDK(NER):
    """Parity: ``NERSDK`` (``TextAnalyticsSDK.scala:373-397``)."""
    batch_size = Param(int, default=5, doc="documents per request")


class KeyPhraseExtractorSDK(KeyPhraseExtractor):
    """Parity: ``KeyPhraseExtractorSDK`` (``TextAnalyticsSDK.scala:227-252``)."""
    batch_size = Param(int, default=5, doc="documents per request")


class PIISDK(PII):
    """Parity: ``PIISDK`` (``TextAnalyticsSDK.scala:286-310``)."""
    batch_size = Param(int, default=5, doc="documents per request")


class HealthcareSDK(Healthcare):
    """Parity: ``HealthcareSDK`` (``TextAnalyticsSDK.scala:314-341``)."""
    batch_size = Param(int, default=5, doc="documents per request")
