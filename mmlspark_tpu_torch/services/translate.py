"""Translation service transformers — full reference breadth.

Parity: ``cognitive/.../TextTranslator.scala`` (550 LoC) op-for-op:
``Translate`` (all twelve option params, ``:206-377``), ``Transliterate``,
``Detect``, ``BreakSentence``, ``DictionaryLookup`` (``:456-466``) and
``DictionaryExamples`` (``:487-540``, the text+translation pair body).
Shared translator conventions (``TextTranslatorBase``): every request
carries ``api-version=3.0``, an optional ``Ocp-Apim-Subscription-Region``
header, and a JSON array body ``[{"Text": ...}, ...]`` — one element per
text in the row's (possibly list-valued) text param; responses align
positionally. ``DocumentTranslator`` parity: ``DocumentTranslator.scala``
(167 LoC).

The port's copy of ``mmlspark_tpu/services/translate.py`` (host work).
"""

from __future__ import annotations

import json as _json
from typing import Optional

import numpy as np

from ..io.http.schema import EntityData, HeaderData, HTTPRequestData
from .base import HasAsyncReply, ServiceParam, ServiceTransformer

__all__ = ["TranslatorBase", "Translate", "Transliterate", "DetectLanguage",
           "DocumentTranslator", "BreakSentence", "DictionaryLookup",
           "DictionaryExamples"]


class TranslatorBase(ServiceTransformer):
    """Array-body translator conventions (``TextTranslator.scala:150-200``):
    ``api-version=3.0`` on every URL, optional region header, ``Text``
    array body from a scalar or list text value. A list-valued text row
    returns the whole per-text result array; a scalar returns its single
    element."""

    text = ServiceParam(str, is_required=True,
                        doc="text (str) or texts (list) to process")
    subscription_region = ServiceParam(
        str, doc="Ocp-Apim-Subscription-Region header value")
    api_version = ServiceParam(str, default="3.0", is_url_param=True,
                               payload_name="api-version",
                               doc="service API version")

    def _texts(self, row: dict):
        t = self.get_value_opt(row, "text")
        if t is None:
            return None, False
        if isinstance(t, (list, tuple, np.ndarray)):
            return [None if x is None else str(x) for x in list(t)], True
        return [str(t)], False

    def _headers(self, row: dict):
        hdrs = super()._headers(row)
        region = self.get_value_opt(row, "subscription_region")
        if region:
            hdrs.append(HeaderData("Ocp-Apim-Subscription-Region", region))
        return hdrs

    def _body(self, row: dict):
        texts, _ = self._texts(row)
        return [{"Text": t or ""} for t in texts or []]

    def _is_batch_row(self, row: dict) -> bool:
        _, batched = self._texts(row)
        return batched

    def _build_request(self, row: dict) -> Optional[HTTPRequestData]:
        if self.should_skip(row):
            return None
        body = self._body(row)
        if not body:
            return None
        return HTTPRequestData(
            url=self._full_url(row), method="POST",
            headers=self._headers(row),
            entity=EntityData.from_string(_json.dumps(body)))

    def _parse_one(self, item):
        """Hook: per-text result extraction."""
        return item

    def _parse(self, body):
        if not isinstance(body, list):
            return body
        return [self._parse_one(x) for x in body]

    def _transform(self, df):
        # responses are positional arrays; scalar-text rows unwrap to their
        # single element so the output shape follows the input shape
        out_df = super()._transform(df)
        out_col = self.get("output_col")
        vals = list(out_df[out_col])
        for i, row in enumerate(df.iter_rows()):
            if (vals[i] is not None and isinstance(vals[i], list)
                    and len(vals[i]) == 1 and not self._is_batch_row(row)):
                vals[i] = vals[i][0]
        from ..core.dataframe import object_col
        return out_df.with_column(out_col, object_col(vals))


class Translate(TranslatorBase):
    """Parity: ``Translate`` (``TextTranslator.scala:206-377``) — all
    option params ride as URL params; ``to`` joins a list with commas
    (the reference's ``toValueString = seq.mkString(",")``)."""

    to_language = ServiceParam(list, is_url_param=True, payload_name="to",
                               is_required=True, doc="target language(s)")
    from_language = ServiceParam(str, is_url_param=True, payload_name="from",
                                 doc="source language (auto-detect if unset)")
    text_type = ServiceParam(str, is_url_param=True, payload_name="textType",
                             doc="'plain' or 'html'")
    category = ServiceParam(str, is_url_param=True,
                            doc="translation category/custom system")
    profanity_action = ServiceParam(str, is_url_param=True,
                                    payload_name="profanityAction",
                                    doc="NoAction/Marked/Deleted")
    profanity_marker = ServiceParam(str, is_url_param=True,
                                    payload_name="profanityMarker",
                                    doc="Asterisk/Tag")
    include_alignment = ServiceParam(bool, is_url_param=True,
                                     payload_name="includeAlignment",
                                     doc="include alignment projection")
    include_sentence_length = ServiceParam(
        bool, is_url_param=True, payload_name="includeSentenceLength",
        doc="include sentence boundaries")
    suggested_from = ServiceParam(str, is_url_param=True,
                                  payload_name="suggestedFrom",
                                  doc="fallback source language")
    from_script = ServiceParam(str, is_url_param=True,
                               payload_name="fromScript",
                               doc="script of the input text")
    to_script = ServiceParam(str, is_url_param=True, payload_name="toScript",
                             doc="script of the translated text")
    allow_fallback = ServiceParam(bool, is_url_param=True,
                                  payload_name="allowFallback",
                                  doc="allow general-system fallback")

    def get_url_params(self, row):
        q = super().get_url_params(row)
        to = q.get("to")
        if isinstance(to, (list, tuple, np.ndarray)):
            q["to"] = ",".join(str(x) for x in to)
        return q

    def _parse_one(self, item):
        if isinstance(item, dict):
            return item.get("translations", item)
        return item


class Transliterate(TranslatorBase):
    """Parity: ``Transliterate`` (``TextTranslator.scala:379-410``)."""

    language = ServiceParam(str, is_url_param=True, is_required=True,
                            doc="language of the text")
    from_script = ServiceParam(str, is_url_param=True,
                               payload_name="fromScript",
                               is_required=True, doc="source script")
    to_script = ServiceParam(str, is_url_param=True, payload_name="toScript",
                             is_required=True, doc="target script")


class DetectLanguage(TranslatorBase):
    """Parity: translator ``Detect`` (``TextTranslator.scala:414-423``)."""


class BreakSentence(TranslatorBase):
    """Parity: ``BreakSentence`` (``TextTranslator.scala:427-452``)."""

    language = ServiceParam(str, is_url_param=True, doc="language hint")
    script = ServiceParam(str, is_url_param=True, doc="script hint")

    def _parse_one(self, item):
        if isinstance(item, dict):
            return item.get("sentLen", item)
        return item


class DictionaryLookup(TranslatorBase):
    """Parity: ``DictionaryLookup`` (``TextTranslator.scala:456-466``) —
    alternative translations for a word/phrase; from/to are required."""

    from_language = ServiceParam(str, is_url_param=True, payload_name="from",
                                 is_required=True, doc="source language")
    to_language = ServiceParam(str, is_url_param=True, payload_name="to",
                               is_required=True, doc="target language")


def _single_pair(v) -> bool:
    return (isinstance(v, (list, tuple)) and len(v) == 2
            and all(isinstance(x, str) for x in v)) or isinstance(v, dict)


class DictionaryExamples(TranslatorBase):
    """Parity: ``DictionaryExamples`` (``TextTranslator.scala:487-540``) —
    usage examples for (text, translation) pairs previously returned by
    DictionaryLookup. ``text_and_translation`` is one pair ``(text,
    translation)`` / ``{"text":..., "translation":...}`` or a list of
    pairs; the body carries ``Text``+``Translation`` per pair."""

    text = ServiceParam(str, doc="unused (pairs carry the text)")
    text_and_translation = ServiceParam(
        list, is_required=True,
        doc="(text, translation) pair or list of pairs")
    from_language = ServiceParam(str, is_url_param=True, payload_name="from",
                                 is_required=True, doc="source language")
    to_language = ServiceParam(str, is_url_param=True, payload_name="to",
                               is_required=True, doc="target language")

    @staticmethod
    def _pair(p):
        if isinstance(p, dict):
            t = p.get("text", p.get("Text"))
            tr = p.get("translation", p.get("Translation"))
        elif isinstance(p, (list, tuple)) and len(p) == 2:
            t, tr = p
        else:
            raise ValueError(
                f"text_and_translation entries must be (text, translation) "
                f"pairs, got {p!r}")
        if t is None or tr is None:
            raise ValueError(
                f"text_and_translation pair needs text AND translation, "
                f"got {p!r}")
        return {"Text": str(t), "Translation": str(tr)}

    def _pairs(self, row: dict):
        v = self.get_value_opt(row, "text_and_translation")
        if v is None:
            return None, False
        if _single_pair(v):
            return [v], False
        if not isinstance(v, (list, tuple, np.ndarray)):
            # ValueError (not TypeError) so the per-row catch keeps one
            # malformed row from aborting the batch
            raise ValueError(
                f"text_and_translation must be a (text, translation) pair "
                f"or a list of pairs, got {v!r}")
        return list(v), True

    def _is_batch_row(self, row: dict) -> bool:
        _, batched = self._pairs(row)
        return batched

    def _body(self, row: dict):
        pairs, _ = self._pairs(row)
        return [self._pair(p) for p in pairs or []]


class DocumentTranslator(ServiceTransformer, HasAsyncReply):
    """Batch document translation (parity: ``DocumentTranslator.scala``,
    167 LoC): POST ``{"inputs": [{source, targets}]}`` to ``/batches``;
    the 202 + Operation-Location long-poll is inherited from HasAsyncReply."""

    source_url = ServiceParam(str, is_required=True,
                              doc="container URL of source documents")
    target_url = ServiceParam(str, is_required=True,
                              doc="container URL for translated output")
    target_language = ServiceParam(str, is_required=True,
                                   doc="language code to translate to")
    storage_type = ServiceParam(str, doc="Folder or File")

    def _payload(self, row: dict):
        target = {"targetUrl": self.get_value_opt(row, "target_url"),
                  "language": self.get_value_opt(row, "target_language")}
        inp = {"source": {"sourceUrl": self.get_value_opt(row, "source_url")},
               "targets": [target]}
        st = self.get_value_opt(row, "storage_type")
        if st is not None:
            inp["storageType"] = st
        return {"inputs": [inp]}
