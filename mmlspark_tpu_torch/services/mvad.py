"""Multivariate anomaly detection (train-then-detect service pair).

Parity: ``cognitive/.../MultivariateAnomalyDetection.scala`` —
``FitMultivariateAnomaly`` (``:312-437``) POSTs a training request to
``.../multivariate/models``, reads the new ``modelId`` from the Location
header, polls model status until READY/FAILED, and returns a
``DetectMultivariateAnomaly`` model (``:439+``) that POSTs a detection
request, polls the result id, and joins per-timestamp anomaly verdicts back
onto the frame by timestamp.

The port's copy of ``mmlspark_tpu/services/mvad.py`` (host work over the
port's ``shared_session``).
"""

from __future__ import annotations

import json
import time

from ..core.dataframe import DataFrame, object_col
from ..core.params import Param
from ..core.pipeline import Estimator, Model
from ..io.http.clients import shared_session
from ..io.http.schema import EntityData, HeaderData, HTTPRequestData
from .base import _send

__all__ = ["FitMultivariateAnomaly", "DetectMultivariateAnomaly"]


def _json_request(url, method, key, key_header, payload=None):
    headers = [HeaderData("Content-Type", "application/json")]
    if key:
        headers.append(HeaderData(key_header, key))
    entity = None
    if payload is not None:
        body = json.dumps(payload).encode()
        entity = EntityData(content=body, content_length=len(body))
    return HTTPRequestData(url=url, method=method, headers=headers,
                           entity=entity)


class FitMultivariateAnomaly(Estimator):
    """POST training window → poll model status → DetectMultivariateAnomaly."""

    url = Param(str, default=None, doc="service base URL "
                                       "(.../multivariate/models)")
    subscription_key = Param(str, default=None, doc="API key")
    key_header = Param(str, default="Ocp-Apim-Subscription-Key",
                       doc="header carrying the API key")
    source = Param(str, default=None,
                   doc="blob/SAS url of the zipped training csvs")
    start_time = Param(str, default=None, doc="training window start (ISO)")
    end_time = Param(str, default=None, doc="training window end (ISO)")
    sliding_window = Param(int, default=300, doc="model sliding window")
    align_mode = Param(str, default="Outer", doc="timestamp alignment")
    fill_na_method = Param(str, default="Linear", doc="missing-value fill")
    polling_delay_ms = Param(int, default=200, doc="delay between polls")
    max_polling_retries = Param(int, default=100, doc="max poll attempts")
    timestamp_col = Param(str, default="timestamp", doc="timestamp column")
    output_col = Param(str, default="result", doc="detection output column")
    error_col = Param(str, default="error", doc="detection error column")
    timeout = Param(float, default=60.0, doc="per-request timeout")

    def _fit(self, df: DataFrame) -> "DetectMultivariateAnomaly":
        url = self.get("url")
        if url is None:
            raise ValueError("url must be set")
        payload = {
            "source": self.get_or_none("source"),
            "startTime": self.get_or_none("start_time"),
            "endTime": self.get_or_none("end_time"),
            "slidingWindow": self.get("sliding_window"),
            "alignPolicy": {"alignMode": self.get("align_mode"),
                            "fillNAMethod": self.get("fill_na_method")},
        }
        session = shared_session.get()
        resp = _send(session, _json_request(url, "POST",
                                            self.get_or_none("subscription_key"),
                                            self.get("key_header"), payload),
                     self.get("timeout"))
        if resp is None or resp.status_code not in (201, 202):
            raise RuntimeError(f"MVAD training request failed: "
                               f"{None if resp is None else resp.status_code}")
        loc = next((h.value for h in resp.headers
                    if h.name.lower() == "location"), None)
        if loc is None:
            raise RuntimeError("MVAD training response missing Location header")
        model_id = loc.rstrip("/").rsplit("/", 1)[-1]

        # poll model status until READY (reference :66-110)
        status = "CREATED"
        for _ in range(self.get("max_polling_retries")):
            time.sleep(self.get("polling_delay_ms") / 1000.0)
            r = _send(session, _json_request(
                f"{url.rstrip('/')}/{model_id}", "GET",
                self.get_or_none("subscription_key"),
                self.get("key_header")), self.get("timeout"))
            if r is None:
                continue
            try:
                info = r.json_content().get("modelInfo", {})
            except (json.JSONDecodeError, ValueError):
                continue   # transient non-JSON body: keep polling
            status = str(info.get("status", "")).upper()
            if status in ("READY", "FAILED"):
                break
        if status != "READY":
            raise RuntimeError(f"MVAD model {model_id} not ready: {status}")

        m = DetectMultivariateAnomaly()
        m.set(url=url, model_id=model_id,
              subscription_key=self.get_or_none("subscription_key"),
              key_header=self.get("key_header"),
              source=self.get_or_none("source"),
              start_time=self.get_or_none("start_time"),
              end_time=self.get_or_none("end_time"),
              timestamp_col=self.get("timestamp_col"),
              output_col=self.get("output_col"),
              error_col=self.get("error_col"),
              polling_delay_ms=self.get("polling_delay_ms"),
              max_polling_retries=self.get("max_polling_retries"),
              timeout=self.get("timeout"))
        return m


class DetectMultivariateAnomaly(Model):
    """POST detect → poll resultId → join anomaly states by timestamp."""

    url = Param(str, default=None, doc="service base URL")
    model_id = Param(str, default=None, doc="trained model id")
    subscription_key = Param(str, default=None, doc="API key")
    key_header = Param(str, default="Ocp-Apim-Subscription-Key",
                       doc="header carrying the API key")
    source = Param(str, default=None, doc="blob/SAS url of detection data")
    start_time = Param(str, default=None, doc="detection window start")
    end_time = Param(str, default=None, doc="detection window end")
    timestamp_col = Param(str, default="timestamp", doc="timestamp column")
    output_col = Param(str, default="result", doc="output column")
    error_col = Param(str, default="error", doc="error column")
    polling_delay_ms = Param(int, default=200, doc="delay between polls")
    max_polling_retries = Param(int, default=100, doc="max poll attempts")
    timeout = Param(float, default=60.0, doc="per-request timeout")

    def _transform(self, df: DataFrame) -> DataFrame:
        url = self.get("url").rstrip("/")
        mid = self.get("model_id")
        session = shared_session.get()
        key = self.get_or_none("subscription_key")
        payload = {"source": self.get_or_none("source"),
                   "startTime": self.get_or_none("start_time"),
                   "endTime": self.get_or_none("end_time")}
        resp = _send(session, _json_request(f"{url}/{mid}/detect", "POST",
                                            key, self.get("key_header"),
                                            payload), self.get("timeout"))
        n = len(df)
        if resp is None or resp.status_code not in (201, 202):
            err = {"statusCode": None if resp is None else resp.status_code,
                   "reasonPhrase": "detect request failed"}
            return (df.with_column(self.get("output_col"),
                                   object_col([None] * n))
                      .with_column(self.get("error_col"),
                                   object_col([err] * n)))
        loc = next((h.value for h in resp.headers
                    if h.name.lower() == "location"), "")
        result_id = loc.rstrip("/").rsplit("/", 1)[-1]

        results = None
        for _ in range(self.get("max_polling_retries")):
            time.sleep(self.get("polling_delay_ms") / 1000.0)
            r = _send(session, _json_request(
                f"{url.rsplit('/models', 1)[0]}/results/{result_id}", "GET",
                key, self.get("key_header")), self.get("timeout"))
            if r is None:
                continue
            try:
                body = r.json_content()
            except (json.JSONDecodeError, ValueError):
                continue   # transient non-JSON body: keep polling
            if str(body.get("summary", {}).get("status", "")).upper() == "READY":
                results = body.get("results", [])
                break
        by_ts = {r.get("timestamp"): r.get("value") for r in (results or [])}
        ts = df[self.get("timestamp_col")]
        outs = object_col([by_ts.get(str(t)) for t in ts])
        err_val = (None if results is not None
                   else {"statusCode": None,
                         "reasonPhrase": "result polling timed out"})
        return (df.with_column(self.get("output_col"), outs)
                  .with_column(self.get("error_col"),
                               object_col([err_val] * n)))
