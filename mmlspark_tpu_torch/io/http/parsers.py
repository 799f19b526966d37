"""Input/output parser stages bridging typed columns ↔ HTTP values.

Parity: ``io/http/Parsers.scala`` — ``JSONInputParser:35`` (row value →
POSTed JSON ``HTTPRequestData``), ``CustomInputParser:92`` (user function),
``JSONOutputParser:154`` (``HTTPResponseData`` → parsed JSON value),
``StringOutputParser:210`` (entity → string), ``CustomOutputParser:231``.

The port's copy of ``mmlspark_tpu/io/http/parsers.py`` (host work; the
request and response values are the port's ``io/http/schema.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

from ...core.dataframe import DataFrame, object_col
from ...core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from ...core.serialize import to_jsonable
from ...core.pipeline import Transformer
from .schema import HeaderData, HTTPRequestData

__all__ = ["HTTPInputParser", "JSONInputParser", "CustomInputParser",
           "HTTPOutputParser", "JSONOutputParser", "StringOutputParser",
           "CustomOutputParser"]


class HTTPInputParser(Transformer, HasInputCol, HasOutputCol):
    """Base: column of values → column of :class:`HTTPRequestData`."""


class JSONInputParser(HTTPInputParser):
    """JSON-encode each input value and POST it to ``url``
    (parity: ``Parsers.scala:35-90``)."""

    url = Param(str, doc="target URL for every request")
    method = Param(str, default="POST", doc="HTTP method")
    headers = Param(dict, default={}, doc="static headers added to each request")

    def _transform(self, df: DataFrame) -> DataFrame:
        hdrs = [HeaderData(k, v) for k, v in self.get("headers").items()]
        url, method = self.get("url"), self.get("method")
        col = df[self.get("input_col")]
        reqs = [HTTPRequestData.from_json(url, to_jsonable(v), method, hdrs)
                for v in col]
        return df.with_column(self.get("output_col"), object_col(reqs))


class CustomInputParser(HTTPInputParser):
    """User function value → :class:`HTTPRequestData`
    (parity: ``Parsers.scala:92-120``)."""

    udf = ComplexParam(saver=None, doc="fn(value) -> HTTPRequestData (transient)")

    def _transform(self, df: DataFrame) -> DataFrame:
        fn: Callable = self.get("udf")
        col = df[self.get("input_col")]
        return df.with_column(self.get("output_col"),
                              object_col([fn(v) for v in col]))


class HTTPOutputParser(Transformer, HasInputCol, HasOutputCol):
    """Base: column of :class:`HTTPResponseData` → column of values."""


class JSONOutputParser(HTTPOutputParser):
    """Parse each response entity as JSON; optional ``post_process`` hook
    (parity: ``Parsers.scala:154-208``)."""

    post_process = ComplexParam(default=None, saver=None,
                                doc="optional fn(parsed_json) -> value (transient)")

    def _transform(self, df: DataFrame) -> DataFrame:
        post: Optional[Callable] = self.get_or_none("post_process")
        out = []
        for resp in df[self.get("input_col")]:
            if resp is None:
                out.append(None)
                continue
            try:
                v = resp.json_content()
            except Exception:
                v = None
            out.append(post(v) if (post is not None and v is not None) else v)
        return df.with_column(self.get("output_col"), object_col(out))


class StringOutputParser(HTTPOutputParser):
    """Entity bytes → string column (parity: ``Parsers.scala:210-229``)."""

    def _transform(self, df: DataFrame) -> DataFrame:
        vals = [None if r is None else r.string_content()
                for r in df[self.get("input_col")]]
        return df.with_column(self.get("output_col"), object_col(vals))


class CustomOutputParser(HTTPOutputParser):
    """User function response → value (parity: ``Parsers.scala:231-258``)."""

    udf = ComplexParam(saver=None, doc="fn(HTTPResponseData) -> value (transient)")

    def _transform(self, df: DataFrame) -> DataFrame:
        fn: Callable = self.get("udf")
        vals = [None if r is None else fn(r) for r in df[self.get("input_col")]]
        return df.with_column(self.get("output_col"), object_col(vals))
