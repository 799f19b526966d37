"""Service-transformer framework.

Parity: ``cognitive/.../CognitiveServiceBase.scala``:

* :class:`ServiceParam` — a param set either to a scalar (applies to every
  row) or to a column name (per-row values): the ``Either[T, String]``
  duality of ``HasServiceParams:29-126``.
* :class:`ServiceTransformer` — assembles one HTTP request per row from
  service params (URL params vs body params), skips rows whose required
  params are null (``shouldSkip:93-95``), sends with bounded concurrency
  through the io/http clients, splits errors, and parses JSON output —
  the ``getInternalTransformer`` composition at ``:271-336``.
* :class:`HasAsyncReply` — 202-Accepted + Operation-Location long-polling
  (``ComputerVision.scala:290-330``).

The port's copy of ``mmlspark_tpu/services/base.py`` (host work over the
port's standard-library clients (``io/http/clients.py``)).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..core.params import HasErrorCol, HasOutputCol, Param, Params, identity
from ..core.pipeline import Transformer
from ..io.http.clients import AsyncHTTPClient, SingleThreadedHTTPClient, \
    advanced_handler
from ..io.http.http_transformer import ErrorUtils
from ..io.http.schema import EntityData, HeaderData, HTTPRequestData, \
    HTTPResponseData

__all__ = ["ServiceParam", "HasServiceParams", "ServiceTransformer",
           "HasAsyncReply"]

_SCALAR, _COL = "scalar", "col"


class ServiceParam(Param):
    """Scalar-or-column param. Values are tagged dicts
    ``{"kind": "scalar"|"col", "value": ...}`` so they stay JSON-serializable.
    Setting a plain value means scalar; use ``set_vector_param`` (or a
    ``{"col": name}`` dict) to bind a column."""

    def __init__(self, dtype=None, default=Param._NO_DEFAULT, doc: str = "",
                 is_required: bool = False, is_url_param: bool = False,
                 payload_name: Optional[str] = None):
        super().__init__(None, Param._NO_DEFAULT, doc, converter=identity)
        self.value_dtype = dtype
        self.is_required = is_required
        self.is_url_param = is_url_param
        self.payload_name = payload_name  # name in query/body (defaults to param name)
        if default is not Param._NO_DEFAULT:
            self.default = {"kind": _SCALAR, "value": default}

    def convert(self, value):
        if value is None:
            return None
        if isinstance(value, dict) and set(value) == {"kind", "value"}:
            return value
        if isinstance(value, dict) and set(value) == {"col"}:
            return {"kind": _COL, "value": value["col"]}
        return {"kind": _SCALAR, "value": value}


class HasServiceParams(Params):
    """Row-aware accessors over ServiceParams (``HasServiceParams:29-126``)."""

    def set_scalar_param(self, name: str, value) -> "HasServiceParams":
        return self.set(**{name: {"kind": _SCALAR, "value": value}})

    def set_vector_param(self, name: str, col: str) -> "HasServiceParams":
        return self.set(**{name: {"kind": _COL, "value": col}})

    def _service_params(self) -> Dict[str, ServiceParam]:
        return {n: p for n, p in self.params().items()
                if isinstance(p, ServiceParam)}

    def get_value_opt(self, row: dict, name: str):
        tagged = self.get_or_none(name)
        if tagged is None:
            return None
        if tagged["kind"] == _COL:
            v = row.get(tagged["value"])
        else:
            v = tagged["value"]
        # numpy scalars from DataFrame rows must behave like Python scalars
        # everywhere downstream (JSON bodies, urlencode, bool checks)
        if isinstance(v, np.generic):
            v = v.item()
        return v

    def should_skip(self, row: dict) -> bool:
        """True if any required service param is null for this row."""
        for n, p in self._service_params().items():
            if p.is_required and self.get_value_opt(row, n) is None:
                return True
        return False

    def get_value_map(self, row: dict, exclude=()) -> Dict[str, Any]:
        out = {}
        for n, p in self._service_params().items():
            if n in exclude or p.is_url_param:
                continue
            v = self.get_value_opt(row, n)
            if v is not None:
                out[p.payload_name or n] = v
        return out

    def get_url_params(self, row: dict) -> Dict[str, str]:
        out = {}
        for n, p in self._service_params().items():
            if p.is_url_param:
                v = self.get_value_opt(row, n)
                if v is not None:
                    if isinstance(v, bool):
                        v = "true" if v else "false"   # not Python's str(bool)
                    out[p.payload_name or n] = v
        return out


class HasAsyncReply(Params):
    """202 + long-poll replies (``ComputerVision.scala:290-330``).

    The skeleton (202 check → location header → sleep/poll loop →
    synthesized 504 on exhaustion) is shared; service conventions differ
    only in the three hooks below — the cognitive default polls
    ``Operation-Location`` until a JSON ``status`` field completes, the
    Azure-Maps variant (``geospatial.MapsAsyncReply``) polls ``Location``
    until the HTTP status flips from 202.
    """

    polling_delay_ms = Param(int, default=300, doc="delay between polls")
    max_polling_retries = Param(int, default=100, doc="max poll attempts")

    #: response header carrying the poll URL
    _poll_location_header = "operation-location"

    def _poll_url(self, loc: str, request: HTTPRequestData) -> str:
        """Hook: decorate the poll URL (e.g. re-attach query auth)."""
        return loc

    def _poll_done(self, resp: HTTPResponseData) -> bool:
        """Hook: is this poll response terminal?"""
        import json as _json
        try:
            status = str(resp.json_content().get("status", "")).lower()
        except (_json.JSONDecodeError, ValueError):
            return False
        return status in ("succeeded", "failed", "partiallycompleted")

    def _poll(self, session, initial: HTTPResponseData,
              request: HTTPRequestData, timeout: float) -> HTTPResponseData:
        if initial.status_code != 202:
            return initial
        loc = next((h.value for h in initial.headers
                    if h.name.lower() == self._poll_location_header), None)
        if loc is None:
            return initial
        loc = self._poll_url(loc, request)
        for _ in range(self.get("max_polling_retries")):
            time.sleep(self.get("polling_delay_ms") / 1000.0)
            resp = _send(session, HTTPRequestData(url=loc, method="GET",
                                                  headers=list(request.headers)),
                         timeout)
            if resp is None:
                continue
            if self._poll_done(resp):
                return resp
        # polling exhausted: surface a timeout error instead of returning the
        # bare 202 (202 counts as OK downstream and would read as success)
        from ..io.http.schema import StatusLineData
        return HTTPResponseData(
            status_line=StatusLineData(status_code=504,
                                       reason_phrase="async polling timed out"))


def _send(session, request: HTTPRequestData,
          timeout: float) -> Optional[HTTPResponseData]:
    return advanced_handler(timeout=timeout)(session, request)


class ServiceTransformer(Transformer, HasServiceParams, HasOutputCol,
                         HasErrorCol):
    """Base for one-request-per-row service stages.

    Subclasses define ``_build_request(row) -> HTTPRequestData | None`` (a
    default JSON-POST builder is provided) and ``_parse(json) -> value``.
    """

    url = Param(str, default=None, doc="service endpoint URL")
    subscription_key = ServiceParam(str, doc="API key header value")
    key_header = Param(str, default="Ocp-Apim-Subscription-Key",
                       doc="header carrying the API key")
    method = Param(str, default="POST", doc="HTTP method")
    concurrency = Param(int, default=1, doc="max in-flight requests")
    timeout = Param(float, default=60.0, doc="per-request timeout seconds")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(output_col=f"{self.uid}_output",
                          error_col=f"{self.uid}_error")

    # -- request building ----------------------------------------------------
    def _headers(self, row: dict) -> List[HeaderData]:
        hdrs = [HeaderData("Content-Type", "application/json")]
        key = self.get_value_opt(row, "subscription_key")
        if key:
            hdrs.append(HeaderData(self.get("key_header"), key))
        return hdrs

    def _full_url(self, row: dict) -> str:
        from urllib.parse import urlencode
        url = self.get("url")
        if url is None:
            raise ValueError(f"{type(self).__name__}: url must be set")
        q = self.get_url_params(row)
        if q:
            sep = "&" if "?" in url else "?"
            url = url + sep + urlencode(q)
        return url

    def _payload(self, row: dict):
        return self.get_value_map(row, exclude=("subscription_key",))

    def _build_request(self, row: dict) -> Optional[HTTPRequestData]:
        if self.should_skip(row):
            return None
        import json as _json
        payload = self._payload(row)
        method = self.get("method")
        entity = None
        if method in ("POST", "PUT", "PATCH"):
            entity = EntityData.from_string(_json.dumps(payload))
        return HTTPRequestData(url=self._full_url(row), method=method,
                               headers=self._headers(row), entity=entity)

    # -- response parsing ----------------------------------------------------
    def _parse(self, body):
        return body

    def _parse_response(self, resp: HTTPResponseData):
        """Full-response hook; default = parse the JSON body. Binary
        endpoints (thumbnails) override this to return entity bytes —
        the reference swaps in a ``CustomOutputParser`` for the same
        purpose (``ComputerVision.scala:446-449``)."""
        return self._parse(resp.json_content())

    def _handle(self, session, request: HTTPRequestData
                ) -> Optional[HTTPResponseData]:
        resp = _send(session, request, self.get("timeout"))
        if resp is not None and isinstance(self, HasAsyncReply):
            resp = self._poll(session, resp, request, self.get("timeout"))
        return resp

    # -- execution -----------------------------------------------------------
    def _transform(self, df: DataFrame) -> DataFrame:
        # stage-level misconfiguration fails LOUDLY before any row work —
        # the per-row catch below must not demote "url never set" to a
        # silently all-errored batch
        if self.get("url") is None:
            raise ValueError(f"{type(self).__name__}: url must be set")
        rows = list(df.iter_rows())
        # per-row build failures (e.g. a column-bound param holding an
        # invalid value) land in the ERROR COLUMN like every other per-row
        # failure — one malformed row must not abort the other 999
        requests_: List[Optional[HTTPRequestData]] = []
        build_errs: List[Optional[dict]] = []
        for r in rows:
            try:
                requests_.append(self._build_request(r))
                build_errs.append(None)
            except ValueError as e:
                requests_.append(None)
                build_errs.append({"statusCode": 400,
                                   "reasonPhrase":
                                       f"request build failed: {e}"})
        c = self.get("concurrency")
        client = (AsyncHTTPClient(c, handler=self._handle) if c > 1
                  else SingleThreadedHTTPClient(handler=self._handle))
        outs, errs = [], []
        for i, (req, resp) in enumerate(zip(requests_,
                                            client.send(iter(requests_)))):
            if req is None:  # skipped (null required param) or build error
                outs.append(None)
                errs.append(build_errs[i])
                continue
            ok, err = ErrorUtils.split(resp)
            if ok is None:
                outs.append(None)
                errs.append(err)
                continue
            try:
                outs.append(self._parse_response(ok))
                errs.append(None)
            except Exception as e:
                # a 200 with an unparseable body must be distinguishable
                # from a skipped row: record it in the error column
                outs.append(None)
                errs.append({"statusCode": ok.status_code,
                             "reasonPhrase": f"response parse failed: {e}",
                             "entity": ok.string_content()[:2000]})
        return (df.with_column(self.get("output_col"), object_col(outs))
                  .with_column(self.get("error_col"), object_col(errs)))
