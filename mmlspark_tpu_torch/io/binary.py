"""Binary file ingestion (the port's copy of ``mmlspark_tpu/io/binary.py``).

Parity: ``io/binary/BinaryFileFormat.scala`` (252 LoC Spark datasource
yielding ``(path, bytes)`` rows, with recursive traversal, zip-file
expansion, and subsampling) and ``BinaryFileReader.scala:105`` —
rebuilt as DataFrame constructors instead of a lazy file format.
"""

from __future__ import annotations

import fnmatch
import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np

from ..core.dataframe import DataFrame, object_col

__all__ = ["list_binary_files", "read_binary_files"]


def list_binary_files(path: str, recursive: bool = True,
                      pattern: Optional[str] = None) -> List[str]:
    if os.path.isfile(path):
        return [path]
    out: List[str] = []
    if recursive:
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                out.append(os.path.join(root, f))
    else:
        out = [os.path.join(path, f) for f in sorted(os.listdir(path))
               if os.path.isfile(os.path.join(path, f))]
    if pattern:
        out = [p for p in out if fnmatch.fnmatch(os.path.basename(p), pattern)]
    return out


def _read_one(path: str, inspect_zip: bool) -> List[Tuple[str, bytes]]:
    if inspect_zip and path.endswith(".zip") and zipfile.is_zipfile(path):
        rows = []
        with zipfile.ZipFile(path) as zf:
            for name in zf.namelist():
                if not name.endswith("/"):
                    rows.append((f"{path}/{name}", zf.read(name)))
        return rows
    with open(path, "rb") as f:
        return [(path, f.read())]


def read_binary_files(path: str, recursive: bool = True,
                      pattern: Optional[str] = None,
                      sample_ratio: float = 1.0, seed: int = 0,
                      inspect_zip: bool = True,
                      npartitions: int = 1) -> DataFrame:
    """Directory/file/zip → DataFrame with ``path`` and ``bytes`` columns."""
    files = list_binary_files(path, recursive, pattern)
    if sample_ratio < 1.0:
        rng = np.random.default_rng(seed)
        files = [f for f in files if rng.random() < sample_ratio]
    rows: List[Tuple[str, bytes]] = []
    for f in files:
        rows.extend(_read_one(f, inspect_zip))
    return DataFrame({"path": object_col([r[0] for r in rows]),
                      "bytes": object_col([r[1] for r in rows])},
                     npartitions=npartitions)
