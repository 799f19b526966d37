"""Form-recognizer service transformers.

Parity: ``cognitive/.../FormRecognizer.scala`` (438 LoC) op-for-op:
``AnalyzeLayout`` (language/pages/readingOrder, ``:170-199``),
``AnalyzeReceipts``, ``AnalyzeBusinessCards``, ``AnalyzeInvoices``,
``AnalyzeIDDocuments`` (prebuilt models, async 202 + Operation-Location
polling), the custom-model trio ``ListCustomModels`` (GET + ``op``,
``:259-280``) / ``GetCustomModel`` (GET ``/{modelId}`` + ``includeKeys``,
``:284-322``) / ``AnalyzeCustomModel`` (``/{modelId}/analyze``,
``:326-360``), and the ``FormsFlatteners`` UDF quartet (``:84-166``) as
plain column functions like vision's ``flatten_ocr``.

The port's copy of ``mmlspark_tpu/services/form.py`` (host work).
"""

from __future__ import annotations

import json as _json

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..core.params import Param
from ..core.pipeline import Estimator, Model
from .base import HasAsyncReply, ServiceParam, ServiceTransformer
from .vision import VisionBase

__all__ = ["FormRecognizerBase", "AnalyzeLayout", "AnalyzeInvoices",
           "AnalyzeReceipts", "AnalyzeBusinessCards", "AnalyzeIDDocuments",
           "ListCustomModels", "GetCustomModel", "AnalyzeCustomModel",
           "FormOntologyLearner", "FormOntologyTransformer",
           "flatten_read_results", "flatten_page_results",
           "flatten_document_results", "flatten_model_list"]


class FormRecognizerBase(VisionBase, HasAsyncReply):
    """POST document url/bytes, long-poll the analyzeResults."""

    def _parse(self, body):
        if isinstance(body, dict) and "analyzeResult" in body:
            return body["analyzeResult"]
        return body


class AnalyzeLayout(FormRecognizerBase):
    """Parity: ``AnalyzeLayout`` (``FormRecognizer.scala:170-199``)."""

    language = ServiceParam(str, is_url_param=True,
                            doc="BCP-47 language code of the text")
    pages = ServiceParam(str, is_url_param=True,
                         doc="page selection, e.g. '1-3,5'")
    reading_order = ServiceParam(str, is_url_param=True,
                                 payload_name="readingOrder",
                                 doc="'basic' or 'natural'")

    def _build_request(self, row):
        if self.should_skip(row):  # null required params skip, not 400
            return None
        ro = self.get_value_opt(row, "reading_order")
        if ro is not None and ro not in ("basic", "natural"):
            raise ValueError(
                f"reading_order must be basic or natural, got {ro!r}")
        return super()._build_request(row)


class AnalyzeInvoices(FormRecognizerBase):
    """Parity: ``AnalyzeInvoices`` (``FormRecognizer.scala:231-241``)."""

    include_text_details = ServiceParam(bool, is_url_param=True,
                                        payload_name="includeTextDetails",
                                        doc="include raw OCR lines")
    pages = ServiceParam(str, is_url_param=True,
                         doc="page selection, e.g. '1-3,5'")
    locale = ServiceParam(str, is_url_param=True,
                          doc="document locale, e.g. en-US")


class AnalyzeReceipts(FormRecognizerBase):
    """Parity: ``AnalyzeReceipts`` (``FormRecognizer.scala:203-213``)."""

    include_text_details = ServiceParam(bool, is_url_param=True,
                                        payload_name="includeTextDetails",
                                        doc="include raw OCR lines")
    pages = ServiceParam(str, is_url_param=True,
                         doc="page selection, e.g. '1-3,5'")
    locale = ServiceParam(str, is_url_param=True,
                          doc="receipt locale, e.g. en-US")


class AnalyzeBusinessCards(FormRecognizerBase):
    """Parity: ``AnalyzeBusinessCards`` (``FormRecognizer.scala:217-227``)."""

    include_text_details = ServiceParam(bool, is_url_param=True,
                                        payload_name="includeTextDetails",
                                        doc="include raw OCR lines")
    pages = ServiceParam(str, is_url_param=True,
                         doc="page selection, e.g. '1-3,5'")
    locale = ServiceParam(str, is_url_param=True,
                          doc="card locale, e.g. en-US")


class AnalyzeIDDocuments(FormRecognizerBase):
    """Parity: ``AnalyzeIDDocuments`` (``FormRecognizer.scala:245-255``)."""

    include_text_details = ServiceParam(bool, is_url_param=True,
                                        payload_name="includeTextDetails",
                                        doc="include raw OCR lines")
    pages = ServiceParam(str, is_url_param=True,
                         doc="page selection, e.g. '1-3,5'")


def _model_url(base_url: str, model_id, q: dict, suffix: str = "") -> str:
    """``{base}/{modelId}{suffix}?{query}`` with the model id escaped and
    any query already on the base URL preserved (the base class handles
    this merge for plain endpoints; custom-model URLs splice a path
    segment so they rebuild here)."""
    from urllib.parse import quote, urlencode
    if base_url is None:
        raise ValueError("url must be set")
    base, _, existing = base_url.partition("?")
    url = f"{base.rstrip('/')}/{quote(str(model_id), safe='')}{suffix}"
    query = "&".join(x for x in (existing, urlencode(q)) if x)
    return url + (f"?{query}" if query else "")


class ListCustomModels(ServiceTransformer):
    """Parity: ``ListCustomModels`` (``FormRecognizer.scala:259-280``) —
    GET the trained-model inventory; ``op`` selects summary vs full."""

    method = Param(str, default="GET", doc="HTTP method")
    op = ServiceParam(str, is_url_param=True,
                      doc="'summary' or 'full' model listing")


class GetCustomModel(ServiceTransformer):
    """Parity: ``GetCustomModel`` (``FormRecognizer.scala:284-322``) —
    GET ``/{modelId}``; ``includeKeys`` adds extracted keys."""

    method = Param(str, default="GET", doc="HTTP method")
    model_id = ServiceParam(str, is_required=True, doc="model identifier")
    include_keys = ServiceParam(bool, is_url_param=True,
                                payload_name="includeKeys",
                                doc="include extracted keys")

    def _full_url(self, row: dict) -> str:
        return _model_url(self.get("url"),
                          self.get_value_opt(row, "model_id"),
                          self.get_url_params(row))


class AnalyzeCustomModel(FormRecognizerBase):
    """Parity: ``AnalyzeCustomModel`` (``FormRecognizer.scala:326-360``) —
    ``/{modelId}/analyze`` built per row like the reference's prepareUrl."""

    model_id = ServiceParam(str, is_required=True, doc="model identifier")
    include_text_details = ServiceParam(bool, is_url_param=True,
                                        payload_name="includeTextDetails",
                                        doc="include raw OCR lines")

    def _full_url(self, row: dict) -> str:
        return _model_url(self.get("url"),
                          self.get_value_opt(row, "model_id"),
                          self.get_url_params(row), suffix="/analyze")


# -- FormsFlatteners (FormRecognizer.scala:84-166) as column functions ------

def _as_analyze_result(body):
    if not isinstance(body, dict):
        return {}
    return body.get("analyzeResult", body)


def flatten_read_results(col: np.ndarray) -> np.ndarray:
    """AnalyzeResponse → all OCR line text joined (parity:
    ``FormsFlatteners.flattenReadResults``)."""
    out = np.empty(len(col), dtype=object)
    for i, body in enumerate(col):
        ar = _as_analyze_result(body)
        out[i] = " ".join(
            " ".join(ln.get("text", "") for ln in page.get("lines", []))
            for page in ar.get("readResults", [])) if ar else None
    return out


def flatten_page_results(col: np.ndarray) -> np.ndarray:
    """AnalyzeResponse → key-value pairs + table text (parity:
    ``FormsFlatteners.flattenPageResults``)."""
    out = np.empty(len(col), dtype=object)
    for i, body in enumerate(col):
        ar = _as_analyze_result(body)
        if not ar:
            out[i] = None
            continue
        pages = ar.get("pageResults", [])
        kvs = "\n\n".join(
            "\n".join(f"key: {(kv.get('key') or {}).get('text')} "
                      f"value: {(kv.get('value') or {}).get('text')}"
                      for kv in page.get("keyValuePairs", []))
            for page in pages)
        tables = "\n\n".join(
            "\n".join(" | ".join(c.get("text", "")
                                 for c in tbl.get("cells", []))
                      for tbl in page.get("tables", []))
            for page in pages)
        out[i] = f"KeyValuePairs: {kvs}\n\n\nTables: {tables}"
    return out


def flatten_document_results(col: np.ndarray) -> np.ndarray:
    """AnalyzeResponse → document ``fields`` JSON per row (parity:
    ``FormsFlatteners.flattenDocumentResults``)."""
    out = np.empty(len(col), dtype=object)
    for i, body in enumerate(col):
        ar = _as_analyze_result(body)
        out[i] = "\n".join(
            _json.dumps((doc or {}).get("fields", {}), sort_keys=True)
            for doc in ar.get("documentResults", [])) if ar else None
    return out


def flatten_model_list(col: np.ndarray) -> np.ndarray:
    """ListCustomModels response → space-joined model ids (parity:
    ``FormsFlatteners.flattenModelList``)."""
    out = np.empty(len(col), dtype=object)
    for i, body in enumerate(col):
        if not isinstance(body, dict):
            out[i] = None
            continue
        out[i] = " ".join(m.get("modelId", "")
                          for m in body.get("modelList", []))
    return out


class FormOntologyLearner(Estimator):
    """Learn a unified field ontology from form-analysis outputs.

    Parity: ``cognitive/.../FormOntologyLearner.scala:42-75`` — merge the
    ``fields`` structures of every row's AnalyzeResponse into one schema;
    the fitted transformer projects each response onto that schema as a
    plain {field: value} struct column.
    """

    input_col = Param(str, default="form", doc="column of analyze outputs")
    output_col = Param(str, default="ontology", doc="extracted struct column")

    @staticmethod
    def _fields_of(resp) -> dict:
        if resp is None:
            return {}
        ar = resp.get("analyzeResult", resp) if isinstance(resp, dict) else {}
        docs = ar.get("documentResults") or []
        return (docs[0] or {}).get("fields", {}) if docs else {}

    def _fit(self, df: DataFrame) -> "FormOntologyTransformer":
        merged: dict = {}
        for resp in df[self.get("input_col")]:
            for name, spec in self._fields_of(resp).items():
                t = (spec or {}).get("type", "string")
                prev = merged.get(name)
                # type union: conflicting types widen to string
                merged[name] = t if prev in (None, t) else "string"
        m = FormOntologyTransformer()
        m.set(input_col=self.get("input_col"),
              output_col=self.get("output_col"),
              ontology={k: merged[k] for k in sorted(merged)})
        return m


class FormOntologyTransformer(Model):
    input_col = Param(str, default="form", doc="column of analyze outputs")
    output_col = Param(str, default="ontology", doc="extracted struct column")
    ontology = Param(dict, default={}, doc="field name → type")

    _VALUE_KEYS = {"number": "valueNumber", "date": "valueDate",
                   "time": "valueTime", "phoneNumber": "valuePhoneNumber",
                   "integer": "valueInteger", "string": "valueString"}

    def _transform(self, df: DataFrame) -> DataFrame:
        onto = self.get("ontology")
        out = []
        for resp in df[self.get("input_col")]:
            fields = FormOntologyLearner._fields_of(resp)
            row = {}
            for name, t in onto.items():
                spec = fields.get(name) or {}
                row[name] = spec.get(self._VALUE_KEYS.get(t, "valueString"),
                                     spec.get("text"))
            out.append(row)
        return df.with_column(self.get("output_col"), object_col(out))
