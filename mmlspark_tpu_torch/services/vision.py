"""Computer-vision service transformers.

Parity: ``cognitive/.../ComputerVision.scala`` (630 LoC) — op-for-op:
``OCR``, ``RecognizeText``, ``ReadImage``, ``GenerateThumbnails``,
``AnalyzeImage``, ``RecognizeDomainSpecificContent``, ``TagImage``,
``DescribeImage``. Each POSTs either ``{"url": ...}`` or raw image bytes;
the Read/RecognizeText family long-polls the 202 Operation-Location
(``HasAsyncReply``, ``ComputerVision.scala:290-330``);
``GenerateThumbnails`` returns raw binary (its reference overrides the
output parser to the entity bytes, ``ComputerVision.scala:437-455``);
``RecognizeDomainSpecificContent`` builds its URL per row from the model
name (``ComputerVision.scala:544-565``).

The port's copy of ``mmlspark_tpu/services/vision.py`` (host work).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..io.http.schema import EntityData, HeaderData, HTTPRequestData
from .base import HasAsyncReply, ServiceParam, ServiceTransformer

__all__ = ["VisionBase", "AnalyzeImage", "OCR", "RecognizeText",
           "ReadImage", "GenerateThumbnails",
           "RecognizeDomainSpecificContent", "DescribeImage", "TagImage",
           "flatten_ocr", "flatten_read"]


class VisionBase(ServiceTransformer):
    image_url = ServiceParam(str, doc="URL of the image to analyze")
    image_bytes = ServiceParam(bytes, doc="raw image bytes (alternative to url)")

    def _build_request(self, row: dict) -> Optional[HTTPRequestData]:
        url_v = self.get_value_opt(row, "image_url")
        bytes_v = self.get_value_opt(row, "image_bytes")
        if url_v is None and bytes_v is None:
            return None
        if self.should_skip(row):
            return None
        headers = self._headers(row)
        if bytes_v is not None:
            headers = [h for h in headers if h.name != "Content-Type"]
            headers.append(HeaderData("Content-Type", "application/octet-stream"))
            entity = EntityData(content=bytes(bytes_v),
                                content_length=len(bytes_v))
        else:
            import json as _json
            entity = EntityData.from_string(_json.dumps({"url": url_v}))
        return HTTPRequestData(url=self._full_url(row), method="POST",
                               headers=headers, entity=entity)


class AnalyzeImage(VisionBase):
    """Parity: ``AnalyzeImage`` — visualFeatures/details/language URL params."""

    visual_features = ServiceParam(str, is_url_param=True,
                                   payload_name="visualFeatures",
                                   doc="comma-joined feature list")
    details = ServiceParam(str, is_url_param=True, doc="celebrity/landmark")
    language = ServiceParam(str, is_url_param=True, default="en",
                            doc="response language")


class OCR(VisionBase, HasAsyncReply):
    """Parity: ``OCR``/``ReadImage`` — async 202 + Operation-Location poll."""

    detect_orientation = ServiceParam(bool, is_url_param=True,
                                      payload_name="detectOrientation",
                                      doc="detect text orientation")
    language = ServiceParam(str, is_url_param=True, doc="OCR language")


class RecognizeText(VisionBase, HasAsyncReply):
    """Parity: ``RecognizeText`` (``ComputerVision.scala:358-386``) —
    async Printed/Handwritten recognition; ``mode`` is a URL param with
    the reference's closed value set."""

    mode = ServiceParam(str, is_url_param=True,
                        doc="'Printed' or 'Handwritten'")

    def _build_request(self, row):
        m = self.get_value_opt(row, "mode")
        if m is not None and m not in ("Printed", "Handwritten"):
            raise ValueError(f"mode must be Printed or Handwritten, got {m!r}")
        return super()._build_request(row)


class ReadImage(VisionBase, HasAsyncReply):
    """Parity: ``ReadImage`` (``ComputerVision.scala:404-433``) — the Read
    v3.x async API; ``language`` forces a specific BCP-47 code from the
    reference's supported set (unset = auto-detect)."""

    _LANGS = ("en", "nl", "fr", "de", "it", "pt", "es")
    language = ServiceParam(str, is_url_param=True,
                            doc="BCP-47 code forcing the doc language")

    def _build_request(self, row):
        lang = self.get_value_opt(row, "language")
        if lang is not None and lang not in self._LANGS:
            raise ValueError(
                f"language must be one of {self._LANGS}, got {lang!r}")
        return super()._build_request(row)


class GenerateThumbnails(VisionBase):
    """Parity: ``GenerateThumbnails`` (``ComputerVision.scala:437-455``) —
    returns the thumbnail BYTES (the reference swaps in a custom output
    parser returning the raw entity)."""

    width = ServiceParam(int, is_url_param=True, is_required=True,
                         doc="thumbnail width")
    height = ServiceParam(int, is_url_param=True, is_required=True,
                          doc="thumbnail height")
    smart_cropping = ServiceParam(bool, is_url_param=True,
                                  payload_name="smartCropping",
                                  doc="crop around the region of interest")

    def _parse_response(self, resp):
        return bytes(resp.entity.content) if resp.entity else None


class RecognizeDomainSpecificContent(VisionBase):
    """Parity: ``RecognizeDomainSpecificContent``
    (``ComputerVision.scala:544-565``) — the model name becomes a URL
    segment (``/models/{model}/analyze``), built per row like the
    reference's ``prepareUrl``."""

    model = ServiceParam(str, is_required=True,
                         doc="domain model: celebrities or landmarks")

    def _full_url(self, row: dict) -> str:
        base = super()._full_url(row)
        model = self.get_value_opt(row, "model")
        return f"{base.rstrip('/')}/models/{model}/analyze"

    def _payload(self, row: dict):
        out = super()._payload(row)
        out.pop("model", None)          # rides in the URL, not the body
        return out


class DescribeImage(VisionBase):
    max_candidates = ServiceParam(int, is_url_param=True,
                                  payload_name="maxCandidates", default=1,
                                  doc="number of caption candidates")


class TagImage(VisionBase):
    language = ServiceParam(str, is_url_param=True, default="en",
                            doc="response language")

    def _parse(self, body):
        return body.get("tags", body)


def flatten_ocr(col: np.ndarray) -> np.ndarray:
    """OCR responses → one text string per row (parity:
    ``OCR.flatten``, ``ComputerVision.scala:163-181``)."""
    out = np.empty(len(col), dtype=object)
    for i, body in enumerate(col):
        if not isinstance(body, dict):
            out[i] = None
            continue
        out[i] = " ".join(
            " ".join(" ".join(w.get("text", "") for w in ln.get("words", []))
                     for ln in region.get("lines", []))
            for region in body.get("regions", []))
    return out


def flatten_read(col: np.ndarray) -> np.ndarray:
    """Read/RecognizeText responses → one text string per row (parity:
    ``ReadImage.flatten``/``RecognizeText.flatten``,
    ``ComputerVision.scala:197-210,389-402``)."""
    out = np.empty(len(col), dtype=object)
    for i, body in enumerate(col):
        if not isinstance(body, dict):
            out[i] = None
            continue
        if "analyzeResult" in body:      # Read v3.x
            pages = body["analyzeResult"].get("readResults", [])
        else:                            # RecognizeText v2.0
            rr = body.get("recognitionResult")
            pages = [rr] if rr else []
        out[i] = " ".join(
            " ".join(ln.get("text", "") for ln in page.get("lines", []))
            for page in pages)
    return out
