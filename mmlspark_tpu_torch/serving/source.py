"""Source/sink + request parsing DSL for serving.

Parity: ``HTTPSource``/``HTTPSink`` v1 (``streaming/HTTPSource.scala:44,179``)
and the ``IOImplicits`` DSL (``io/IOImplicits.scala:20-220``):
``spark.readStream.server`` → :class:`HTTPSource`, ``df.parseRequest`` →
:func:`parse_request`, ``df.makeReply`` → :func:`make_reply`,
``writeStream.server.replyTo`` → :class:`HTTPSink`.

The port's copy of ``mmlspark_tpu/serving/source.py``.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..core.params import Param
from ..core.serialize import to_jsonable
from ..core.pipeline import Transformer
from .server import WorkerServer

__all__ = ["HTTPSource", "HTTPSink", "parse_request", "make_reply"]

ID_COL = "id"
REQUEST_COL = "request"
REPLY_COL = "reply"


class HTTPSource:
    """Pull parked requests as DataFrame micro-batches.

    Each batch carries ``id`` (request id, the reply routing key — parity
    with the (machineIp, requestId, partition) triple of
    ``HTTPSourceV2.scala:657-660``) and ``request`` (:class:`HTTPRequestData`).
    """

    def __init__(self, server: WorkerServer):
        self.server = server

    def read_batch(self, max_rows: int = 1024, timeout: float = 0.1) -> DataFrame:
        cached = self.server.get_batch(max_rows, timeout)
        return DataFrame({ID_COL: object_col(c.request_id for c in cached),
                          REQUEST_COL: object_col(c.request for c in cached)})


class HTTPSink:
    """Route a reply column back to the parked connections
    (parity: ``HTTPSink``/``HTTPDataWriter.write`` ``HTTPSinkV2.scala:105-148``)."""

    def __init__(self, server: WorkerServer, reply_col: str = REPLY_COL,
                 id_col: str = ID_COL):
        self.server = server
        self.reply_col = reply_col
        self.id_col = id_col

    def write_batch(self, df: DataFrame) -> int:
        n = 0
        for rid, val in zip(df[self.id_col], df[self.reply_col]):
            ok = self.server.reply_json(rid, to_jsonable(val))
            n += int(ok)
        return n


def parse_request(df: DataFrame, schema: Optional[Dict[str, type]] = None,
                  request_col: str = REQUEST_COL) -> DataFrame:
    """JSON request bodies → typed columns (parity: ``df.parseRequest``,
    ``IOImplicits.scala:134-170``). ``schema`` maps field → dtype; without a
    schema the parsed dict lands in a ``body`` column."""
    reqs = df[request_col]
    bodies = []
    for r in reqs:
        try:
            bodies.append(json.loads(r.entity.string_content()) if r.entity else {})
        except (json.JSONDecodeError, AttributeError):
            bodies.append({})
    out = df.drop(request_col)
    if schema is None:
        return out.with_column("body", object_col(bodies))
    for name, dtype in schema.items():
        vals = [b.get(name) for b in bodies]
        if dtype in (float, int):
            arr = np.asarray([dtype(v) if v is not None else np.nan for v in vals])
        elif dtype is list:
            arr = object_col(np.asarray(v) if v is not None else None
                             for v in vals)
        else:
            arr = object_col(vals)
        out = out.with_column(name, arr)
    return out


def make_reply(df: DataFrame, value_col: str, reply_col: str = REPLY_COL) -> DataFrame:
    """Wrap a value column as the reply column (parity: ``df.makeReply``,
    ``IOImplicits.scala:172-186``)."""
    return df.with_column(reply_col, df[value_col])


class ParseRequest(Transformer):
    """Stage form of :func:`parse_request`, so serving pipelines can be a
    single ``PipelineModel``."""

    request_col = Param(str, default=REQUEST_COL, doc="request column name")
    schema = Param(dict, default=None, doc="field → type map (None: raw body)")

    def _transform(self, df: DataFrame) -> DataFrame:
        return parse_request(df, self.get_or_none("schema"), self.get("request_col"))


class MakeReply(Transformer):
    value_col = Param(str, doc="column to send back")
    reply_col = Param(str, default=REPLY_COL, doc="reply column name")

    def _transform(self, df: DataFrame) -> DataFrame:
        return make_reply(df, self.get("value_col"), self.get("reply_col"))
