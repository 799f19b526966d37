"""Search service transformers/sinks.

Parity: ``cognitive/.../AzureSearch.scala`` (356 LoC index sink) and
``BingImageSearch.scala`` (309 LoC).

The port's copy of ``mmlspark_tpu/services/search.py`` (host work).
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

from ..core.dataframe import DataFrame
from ..core.params import Param
from ..core.serialize import to_jsonable
from ..io.http.clients import post_json_batches
from ..io.http.schema import EntityData, HeaderData, HTTPRequestData
from .base import ServiceParam, ServiceTransformer

__all__ = ["AddDocuments", "AzureSearchWriter", "BingImageSearch"]


class BingImageSearch(ServiceTransformer):
    """Parity: ``BingImageSearch`` — GET /images/search?q=... with offset/
    count paging params; output is the raw value array."""

    query = ServiceParam(str, is_required=True, is_url_param=True,
                         payload_name="q", doc="search query")
    count = ServiceParam(int, is_url_param=True, doc="results per page")
    offset = ServiceParam(int, is_url_param=True, doc="result offset")
    image_type = ServiceParam(str, is_url_param=True, payload_name="imageType",
                              doc="photo/clipart/...")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(method="GET")

    def _parse(self, body):
        if isinstance(body, dict):
            return body.get("value", body)
        return body

    @staticmethod
    def download_from_urls(df: DataFrame, url_col: str, out_col: str = "bytes",
                           concurrency: int = 4, timeout: float = 30.0
                           ) -> DataFrame:
        """Parity: ``BingImageSearch.downloadFromUrls`` helper."""
        from ..core.dataframe import object_col
        from ..io.http.clients import AsyncHTTPClient
        reqs = [None if u is None else HTTPRequestData(url=u, method="GET")
                for u in df[url_col]]
        client = AsyncHTTPClient(concurrency, timeout=timeout)
        outs = [None if r is None or r.status_code != 200
                else (r.entity.content if r.entity else None)
                for r in client.send(iter(reqs))]
        return df.with_column(out_col, object_col(outs))


class AddDocuments(ServiceTransformer):
    """Parity: ``AddDocuments`` (``AzureSearch.scala:14-120``) — the
    transformer form of the index sink: rows batch into
    ``{"value": [{action_col: ..., ...row}, ...]}`` uploads and every row
    of a batch receives that batch's indexing response (per-key status).
    The reference requires the action column in the DataFrame; rows
    missing it default to 'upload' here and the key header is the search
    convention ``api-key``."""

    action_col = Param(str, default="@search.action",
                       doc="column holding the per-row index action")
    batch_size = Param(int, default=100, doc="documents per upload request")
    key_header = Param(str, default="api-key",
                       doc="header carrying the API key (search convention)")

    def _transform(self, df: DataFrame) -> DataFrame:
        from ..core.dataframe import object_col
        from ..io.http.clients import AsyncHTTPClient, \
            SingleThreadedHTTPClient
        from ..io.http.http_transformer import ErrorUtils
        if self.get("url") is None:
            raise ValueError(f"{type(self).__name__}: url must be set")
        rows = list(df.iter_rows())
        action = self.get("action_col")
        bs = max(1, int(self.get("batch_size")))
        # the API key must never ride into the index: exclude the bound
        # column (column-bound keys live under that column's name)
        skip = {"subscription_key"}
        tagged = self.get_or_none("subscription_key")
        if tagged is not None and tagged["kind"] == "col":
            skip.add(tagged["value"])
        groups = [list(range(i, min(i + bs, len(rows))))
                  for i in range(0, len(rows), bs)]
        requests_ = []
        for idxs in groups:
            docs = []
            for i in idxs:
                doc = {k: to_jsonable(v) for k, v in rows[i].items()
                       if k not in skip}
                doc.setdefault(action, "upload")
                docs.append(doc)
            requests_.append(HTTPRequestData(
                url=self._full_url(rows[idxs[0]]), method="POST",
                headers=self._headers(rows[idxs[0]]),
                entity=EntityData.from_string(
                    json.dumps({"value": docs}))))
        c = self.get("concurrency")
        client = (AsyncHTTPClient(c, handler=self._handle) if c > 1
                  else SingleThreadedHTTPClient(handler=self._handle))
        outs = [None] * len(rows)
        errs = [None] * len(rows)
        for idxs, resp in zip(groups, client.send(iter(requests_))):
            ok, err = ErrorUtils.split(resp)
            for i in idxs:
                if ok is None:
                    errs[i] = err
                else:
                    outs[i] = ok.json_content()
        return (df.with_column(self.get("output_col"), object_col(outs))
                  .with_column(self.get("error_col"), object_col(errs)))


class AzureSearchWriter:
    """Index-upload sink (parity: ``AzureSearchWriter.write``): POSTs
    ``{"value": [{"@search.action": "upload", ...row}, ...]}`` batches."""

    def __init__(self, url: str, api_key: str = "", batch_size: int = 100,
                 action: str = "upload"):
        self.url = url
        self.api_key = api_key
        self.batch_size = batch_size
        self.action = action

    def write(self, df: DataFrame, cols: Optional[Sequence[str]] = None) -> int:
        names = list(cols) if cols else df.columns

        def docs():
            for row in df.iter_rows():
                doc = {"@search.action": self.action}
                doc.update({k: to_jsonable(row[k]) for k in names})
                yield doc

        return post_json_batches(
            self.url, docs(), self.batch_size, wrap=lambda b: {"value": b},
            headers=[HeaderData("api-key", self.api_key)],
            what="search index upload")
