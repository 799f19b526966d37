"""Automatic featurization.

Parity surface: ``Featurize`` (reference
``core/.../featurize/Featurize.scala:37``): inspect each input column's type
and assemble a per-type sub-pipeline (impute numerics, index/one-hot
categoricals, hash text), concatenating everything into one dense features
vector — the column every trainer consumes.

The port's copy of ``mmlspark_tpu/featurize/featurize.py`` (numpy only,
host work; ``FeaturizeModel`` builds its dense float64 matrix with the
same per-row loops).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..core.params import HasInputCols, HasOutputCol, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import get_categorical_levels

__all__ = ["Featurize", "FeaturizeModel", "VectorAssembler"]


def _is_numeric(col: np.ndarray) -> bool:
    return col.dtype != object and np.issubdtype(col.dtype, np.number)


def _is_text(col: np.ndarray) -> bool:
    if col.dtype.kind in ("U", "S"):
        return True
    return col.dtype == object and len(col) > 0 and isinstance(col[0], str)


def _is_vector(col: np.ndarray) -> bool:
    if col.dtype == object:
        return len(col) > 0 and isinstance(col[0], (np.ndarray, list, tuple))
    return col.ndim > 1


class Featurize(Estimator, HasInputCols, HasOutputCol):
    one_hot_encode_categoricals = Param(bool, default=True,
                                        doc="one-hot string/categorical columns")
    num_features = Param(int, default=1 << 8,
                         doc="hash space for high-cardinality text")
    impute_missing = Param(bool, default=True, doc="mean-impute numeric NaNs")

    def __init__(self, input_cols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        self._set_default(output_col="features")
        if input_cols is not None:
            self.set(input_cols=list(input_cols))

    def _fit(self, df: DataFrame) -> "FeaturizeModel":
        plans: List[dict] = []
        for c in self.get("input_cols"):
            col = df[c]
            if _is_vector(col):
                plans.append({"col": c, "kind": "vector"})
            elif _is_numeric(col):
                fill = None
                if self.get("impute_missing"):
                    # unconditional training mean: serving data may have NaNs
                    # even when the training sample had none
                    fill = float(np.nanmean(col.astype(np.float64)))
                plans.append({"col": c, "kind": "numeric", "fill": fill})
            elif _is_text(col):
                levels = get_categorical_levels(df, c)
                if levels is None:
                    levels = sorted({str(v) for v in col})
                if (self.get("one_hot_encode_categoricals")
                        and len(levels) <= self.get("num_features")):
                    plans.append({"col": c, "kind": "onehot",
                                  "levels": [str(l) for l in levels]})
                else:
                    plans.append({"col": c, "kind": "hash",
                                  "n": self.get("num_features")})
            else:
                raise TypeError(f"cannot featurize column {c!r} of "
                                f"type {df.schema()[c]}")
        m = FeaturizeModel()
        m.set(input_cols=self.get("input_cols"), output_col=self.get("output_col"),
              plans=plans)
        return m


class FeaturizeModel(Model, HasInputCols, HasOutputCol):
    plans = Param(list, default=[], doc="per-column featurization plan")

    def _transform(self, df: DataFrame) -> DataFrame:
        from .text import _fnv1a
        parts: List[np.ndarray] = []
        n = len(df)
        for plan in self.get("plans"):
            col = df[plan["col"]]
            kind = plan["kind"]
            if kind == "vector":
                if col.dtype == object:
                    part = np.stack([np.asarray(v, dtype=np.float64).ravel()
                                     for v in col])
                else:
                    part = np.asarray(col, dtype=np.float64).reshape(n, -1)
            elif kind == "numeric":
                part = col.astype(np.float64)[:, None].copy()
                if plan["fill"] is not None:
                    part[np.isnan(part)] = plan["fill"]
            elif kind == "onehot":
                levels = plan["levels"]
                table = {v: i for i, v in enumerate(levels)}
                part = np.zeros((n, len(levels)))
                for i, v in enumerate(col):
                    j = table.get(str(v))
                    if j is not None:
                        part[i, j] = 1.0
            elif kind == "hash":
                nf = plan["n"]
                part = np.zeros((n, nf))
                for i, v in enumerate(col):
                    for tok in str(v).lower().split():
                        part[i, _fnv1a(tok, nf)] += 1.0
            else:
                raise ValueError(f"unknown plan kind {kind!r}")
            parts.append(part)
        X = np.concatenate(parts, axis=1) if parts else np.zeros((n, 0))
        return df.with_column(self.get("output_col"), object_col(X))


class VectorAssembler(Transformer, HasInputCols, HasOutputCol):
    """Concatenate numeric/vector columns into one feature vector per row.

    Parity: the reference's ``FastVectorAssembler``
    (``org/apache/spark/ml/feature/FastVectorAssembler.scala`` — its
    Spark-injection rewrite of VectorAssembler that skips per-row metadata
    work). Columnar-native here: scalars and fixed-width vector columns
    concatenate as one dense (n, total_width) block — one allocation, no
    per-row boxing until the object-column boundary.
    """

    handle_invalid = Param(str, default="error", choices=["error", "keep"],
                           doc="'error' raises on NaN/None; 'keep' passes "
                               "NaN through")

    def _transform(self, df: DataFrame) -> DataFrame:
        from ..core.schema import assemble_vector

        cols = self.get("input_cols")
        if not cols:
            raise ValueError(f"{self.uid}: input_cols is empty")
        X = assemble_vector(df, cols, allow_none=True)
        if self.handle_invalid == "error" and not np.isfinite(X).all():
            bad = int(np.argwhere(~np.isfinite(X).all(axis=1)).ravel()[0])
            raise ValueError(
                f"non-finite values in assembled features (first bad row "
                f"{bad}); set handle_invalid='keep' to pass NaN through")
        return df.with_column(self.get("output_col"), object_col(X))
