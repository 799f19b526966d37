"""Schema & metadata utilities (the port's copy of
``mmlspark_tpu/core/schema.py``).

Parity surface: ``core/schema`` in the reference — ``Categoricals`` (314 LoC),
``SparkSchema`` label/score metadata (225 LoC),
``DatasetExtensions.findUnusedColumnName``, and the ``SparkBindings`` struct
codecs (``core/schema/SparkBindings.scala:13-47``). Here column metadata is a
plain dict carried by the DataFrame; these helpers standardize the keys.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .dataframe import DataFrame

__all__ = [
    "py_scalar",
    "find_unused_column_name",
    "set_categorical_metadata",
    "get_categorical_levels",
    "is_categorical",
    "set_label_metadata",
    "get_label_metadata",
    "assemble_vector",
    "assemble_features",
    "struct_column",
    "unpack_struct_column",
]

CATEGORICAL_KEY = "ml_categorical"
LABEL_KEY = "ml_label"
SCORE_KEY = "ml_score"


def py_scalar(v):
    """numpy scalar → plain Python scalar (identity otherwise)."""
    return v.item() if isinstance(v, np.generic) else v


def find_unused_column_name(base: str, df: DataFrame) -> str:
    """Reference: ``DatasetExtensions.findUnusedColumnName``."""
    name = base
    i = 0
    while name in df:
        i += 1
        name = f"{base}_{i}"
    return name


# -- categorical metadata ----------------------------------------------------

def set_categorical_metadata(df: DataFrame, col: str, levels: Sequence) -> DataFrame:
    return df.with_column_metadata(col, {CATEGORICAL_KEY: {
        "levels": [l.item() if isinstance(l, np.generic) else l for l in levels]}})


def get_categorical_levels(df: DataFrame, col: str) -> Optional[List]:
    meta = df.column_metadata(col).get(CATEGORICAL_KEY)
    return None if meta is None else list(meta["levels"])


def is_categorical(df: DataFrame, col: str) -> bool:
    return CATEGORICAL_KEY in df.column_metadata(col)


# -- label/score metadata (reference: SparkSchema.scala) ---------------------

def set_label_metadata(df: DataFrame, col: str, num_classes: Optional[int] = None,
                       classes: Optional[Sequence] = None) -> DataFrame:
    meta: Dict = {}
    if num_classes is not None:
        meta["num_classes"] = int(num_classes)
    if classes is not None:
        meta["classes"] = [c.item() if isinstance(c, np.generic) else c for c in classes]
    return df.with_column_metadata(col, {LABEL_KEY: meta})


def get_label_metadata(df: DataFrame, col: str) -> dict:
    return df.column_metadata(col).get(LABEL_KEY, {})


# -- vector assembly (reference: FastVectorAssembler) ------------------------

def assemble_vector(df: DataFrame, input_cols: Sequence[str],
                    allow_none: bool = False) -> np.ndarray:
    """Stack numeric/vector columns into a dense 2-D float array (n, d).

    Object columns must be fixed-width vectors; with ``allow_none`` a None
    row becomes NaN (the width comes from the non-None rows — an all-None
    column is an error, never a silently-zero-width block)."""
    parts = []
    for c in input_cols:
        col = df[c]
        if col.dtype == object:
            if allow_none and any(v is None for v in col):
                first = next((v for v in col if v is not None), None)
                if first is None:
                    raise ValueError(
                        f"column {c!r} is entirely None; its vector width "
                        f"is undefined")
                width = int(np.asarray(first).size)
                block = np.full((len(col), width), np.nan)
                for i, v in enumerate(col):
                    if v is not None:
                        arr = np.asarray(v, dtype=np.float64).ravel()
                        if arr.size != width:
                            raise ValueError(
                                f"column {c!r} row {i}: width {arr.size} != "
                                f"{width} (vectors must be fixed-width)")
                        block[i] = arr
                parts.append(block)
                continue
            rows = [np.asarray(v, dtype=np.float64).ravel() for v in col]
            widths = {r.size for r in rows}
            if len(widths) > 1:
                raise ValueError(
                    f"column {c!r} has mixed widths {sorted(widths)} "
                    f"(vectors must be fixed-width)")
            if not rows:
                # a 0-row frame has no width evidence — a silent (0, 0)
                # block would change the assembled width between empty and
                # non-empty inputs
                raise ValueError(
                    f"column {c!r} is empty; its vector width is undefined "
                    f"(assemble a non-empty frame, or drop the column)")
            col = np.stack(rows)
        col = np.asarray(col, dtype=np.float64)
        if col.ndim == 1:
            col = col[:, None]
        elif col.ndim > 2:
            col = col.reshape(len(col), -1)
        parts.append(col)
    if not parts:
        return np.zeros((len(df), 0))
    return np.concatenate(parts, axis=1)


def assemble_features(df: DataFrame, input_cols: Sequence[str]):
    """``assemble_vector`` that preserves sparsity.

    When the single input column holds scipy sparse row vectors (1×F
    matrices — the stand-in for Spark ML's ``SparseVector`` rows consumed
    by the reference's dataset build, ``DatasetAggregator.scala:127-183``),
    returns one stacked CSR matrix instead of densifying. Every other
    shape defers to :func:`assemble_vector` (dense ``(n, d)`` float array).
    """
    try:
        import scipy.sparse as sp
    except Exception:               # pragma: no cover - scipy is in the image
        sp = None
    if sp is not None and len(input_cols) == 1:
        col = df[input_cols[0]]
        if col.dtype == object and len(col) \
                and any(sp.issparse(v) for v in col):
            rows = []
            for i, v in enumerate(col):
                if not sp.issparse(v):
                    raise ValueError(
                        f"column {input_cols[0]!r} mixes sparse and "
                        f"non-sparse rows (row {i}); a sparse features "
                        "column must be sparse throughout")
                rows.append(v.tocsr().reshape(1, -1))
            widths = {r.shape[1] for r in rows}
            if len(widths) > 1:
                raise ValueError(
                    f"column {input_cols[0]!r} has mixed widths "
                    f"{sorted(widths)} (vectors must be fixed-width)")
            # direct buffer concat — sp.vstack over n 1-row blocks costs
            # an order of magnitude more object churn at large n
            data = np.concatenate([r.data for r in rows]) if rows else \
                np.zeros(0, np.float64)
            indices = np.concatenate([r.indices for r in rows]) if rows \
                else np.zeros(0, np.int32)
            indptr = np.concatenate(
                [[0], np.cumsum([r.nnz for r in rows])])
            return sp.csr_matrix((data, indices, indptr),
                                 shape=(len(rows), widths.pop()))
    return assemble_vector(df, input_cols)


# -- struct columns (reference: SparkBindings row codecs) --------------------

def struct_column(dicts: Sequence[dict]) -> np.ndarray:
    arr = np.empty(len(dicts), dtype=object)
    for i, d in enumerate(dicts):
        arr[i] = d
    return arr


def unpack_struct_column(col: np.ndarray, field: str) -> np.ndarray:
    out = np.empty(len(col), dtype=object)
    for i, v in enumerate(col):
        out[i] = None if v is None else v.get(field)
    return out
