"""HTTP transformer stages: send a request column, get a response column.

Parity:

* ``HTTPTransformer`` (``io/http/HTTPTransformer.scala:91-146``) — maps a
  column of :class:`HTTPRequestData` to a column of
  :class:`HTTPResponseData` per partition, sharing one pooled client per
  process (``:101-113``) and using the async client when ``concurrency > 1``.
* ``SimpleHTTPTransformer`` (``io/http/SimpleHTTPTransformer.scala:64-171``)
  — composes input parser → HTTP → error split (non-2xx rows land in
  ``error_col`` with a null output, ``:33-63,137-140``) → output parser.

The port's copy of ``mmlspark_tpu/io/http/http_transformer.py`` (host
work over the port's standard-library clients (``clients.py``)).
"""

from __future__ import annotations

from typing import Optional


from ...core.dataframe import DataFrame, object_col
from ...core.params import (ComplexParam, HasErrorCol, HasInputCol,
                            HasOutputCol, Param)
from ...core.pipeline import Transformer
from .clients import AsyncHTTPClient, SingleThreadedHTTPClient, advanced_handler
from .parsers import JSONOutputParser
from .schema import HTTPResponseData

__all__ = ["HTTPTransformer", "SimpleHTTPTransformer", "ErrorUtils"]


class HTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Column of requests → column of responses."""

    concurrency = Param(int, default=1, doc="max in-flight requests per partition")
    partition_parallelism = Param(int, default=1,
                                  doc="partitions processed at once; total "
                                      "in-flight = this × concurrency (the "
                                      "Spark analogue is concurrent tasks × "
                                      "concurrency), so the default keeps the "
                                      "user-set concurrency cap exact")
    timeout = Param(float, default=60.0, doc="per-request timeout seconds")
    backoffs_ms = Param((list, int), default=[100, 500, 1000],
                        doc="retry backoff ladder in milliseconds")
    handler = ComplexParam(default=None, saver=None,
                           doc="optional fn(session, HTTPRequestData) -> "
                               "HTTPResponseData override (transient)")

    def _client(self):
        handler = self.get_or_none("handler") or advanced_handler(
            *self.get("backoffs_ms"), timeout=self.get("timeout"))
        c = self.get("concurrency")
        if c > 1:
            return AsyncHTTPClient(c, handler)
        return SingleThreadedHTTPClient(handler)

    def _transform(self, df: DataFrame) -> DataFrame:
        in_col, out_col = self.get("input_col"), self.get("output_col")

        def run(part: DataFrame, _i: int) -> DataFrame:
            client = self._client()
            resps = list(client.send(iter(part[in_col])))
            return part.with_column(out_col, object_col(resps))

        return df.map_partitions(run,
                                 max_workers=self.get("partition_parallelism"))


class ErrorUtils:
    """Split responses into (ok_value, error_value) — parity with the
    error-splitting UDF of ``SimpleHTTPTransformer.scala:33-63``."""

    OK_CODES = (200, 201, 202)

    @staticmethod
    def split(resp: Optional[HTTPResponseData]):
        if resp is None:
            return None, {"statusCode": None, "reasonPhrase": "request failed",
                          "entity": None}
        if resp.status_code in ErrorUtils.OK_CODES:
            return resp, None
        return None, {"statusCode": resp.status_code,
                      "reasonPhrase": resp.status_line.reason_phrase,
                      "entity": resp.string_content()}


class SimpleHTTPTransformer(Transformer, HasInputCol, HasOutputCol, HasErrorCol):
    """input parser → HTTP → error split → output parser, as one stage."""

    input_parser = ComplexParam(default=None,
                                doc="HTTPInputParser stage (e.g. JSONInputParser)")
    output_parser = ComplexParam(default=None,
                                 doc="HTTPOutputParser stage; default JSON")
    concurrency = Param(int, default=1, doc="max in-flight requests")
    timeout = Param(float, default=60.0, doc="per-request timeout seconds")
    handler = ComplexParam(default=None, saver=None,
                           doc="optional custom handler fn (transient)")

    _REQ = "__http_request__"
    _RESP = "__http_response__"

    def flatten_stages(self):
        """The internal pipeline, for introspection (parity:
        ``SimpleHTTPTransformer.makePipeline:118-160``)."""
        inp = self.get_or_none("input_parser")
        if inp is None:
            raise ValueError("input_parser must be set (e.g. JSONInputParser)")
        outp = self.get_or_none("output_parser") or JSONOutputParser()
        inp = inp.copy({"input_col": self.get("input_col"), "output_col": self._REQ})
        outp = outp.copy({"input_col": self._RESP, "output_col": self.get("output_col")})
        http = HTTPTransformer(input_col=self._REQ, output_col=self._RESP,
                               concurrency=self.get("concurrency"),
                               timeout=self.get("timeout"))
        if self.get_or_none("handler") is not None:
            http.set(handler=self.get("handler"))
        return inp, http, outp

    def _transform(self, df: DataFrame) -> DataFrame:
        inp, http, outp = self.flatten_stages()
        cur = http.transform(inp.transform(df))
        oks, errs = [], []
        for resp in cur[self._RESP]:
            ok, err = ErrorUtils.split(resp)
            oks.append(ok)
            errs.append(err)
        cur = cur.with_column(self._RESP, object_col(oks))
        cur = cur.with_column(self.get("error_col"), object_col(errs))
        cur = outp.transform(cur)
        return cur.drop(self._REQ, self._RESP)
