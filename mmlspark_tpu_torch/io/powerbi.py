"""Streaming/batch POST sink for row data.

Parity: ``io/powerbi/PowerBIWriter.scala:114`` — serialize row batches to
JSON and POST them to a push endpoint, with the shared retry ladder
(429 Retry-After handled by ``io/http/clients.py``).

The port's copy of ``mmlspark_tpu/io/powerbi.py`` (host work over the
port's ``post_json_batches``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.dataframe import DataFrame
from .http.clients import post_json_batches

__all__ = ["write_to_powerbi", "PowerBIWriter"]


def _json_rows(df: DataFrame, cols: Optional[Sequence[str]]):
    from ..core.serialize import to_jsonable
    names = list(cols) if cols else df.columns
    for row in df.iter_rows():
        yield {k: to_jsonable(row[k]) for k in names}


def write_to_powerbi(df: DataFrame, url: str, batch_size: int = 1000,
                     cols: Optional[Sequence[str]] = None,
                     backoffs_ms: Sequence[int] = (100, 500, 1000)) -> int:
    """POST rows in batches; returns the number of batches sent. Raises on a
    terminally-failed batch (parity: writer fails the stream task)."""
    return post_json_batches(url, _json_rows(df, cols), batch_size,
                             wrap=lambda b: {"rows": b},
                             backoffs_ms=backoffs_ms, what="PowerBI push")


class PowerBIWriter:
    """Object form mirroring ``PowerBIWriter``'s stream/batch API."""

    def __init__(self, url: str, batch_size: int = 1000):
        self.url = url
        self.batch_size = batch_size

    def write(self, df: DataFrame) -> int:
        return write_to_powerbi(df, self.url, self.batch_size)
