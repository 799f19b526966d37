"""Categorical value indexing.

Parity surface: ``ValueIndexer:57`` / ``ValueIndexerModel:107`` /
``IndexToValue:29`` (reference ``core/.../featurize/ValueIndexer.scala``,
``IndexToValue.scala``) plus the ``Categoricals`` metadata they attach
(``core/schema/Categoricals.scala``).

The port's copy of ``mmlspark_tpu/featurize/value_indexer.py`` (numpy
only, host work).
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import get_categorical_levels, set_categorical_metadata

__all__ = ["ValueIndexer", "ValueIndexerModel", "IndexToValue"]


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Map distinct column values to dense indices [0, n)."""

    def _fit(self, df: DataFrame) -> "ValueIndexerModel":
        col = df[self.get("input_col")]
        values = sorted({v.item() if isinstance(v, np.generic) else v
                         for v in col}, key=lambda v: (str(type(v)), v))
        m = ValueIndexerModel()
        m.set(input_col=self.get("input_col"), output_col=self.get("output_col"),
              levels=values)
        return m


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = Param(list, default=[], doc="distinct values; index = position")

    def _transform(self, df: DataFrame) -> DataFrame:
        levels = self.get("levels")
        table = {v: i for i, v in enumerate(levels)}
        col = df[self.get("input_col")]
        idx = np.empty(len(col), dtype=np.int64)
        for i, v in enumerate(col):
            v = v.item() if isinstance(v, np.generic) else v
            if v not in table:
                raise ValueError(f"unseen value {v!r} in {self.get('input_col')}")
            idx[i] = table[v]
        out = df.with_column(self.get("output_col"), idx)
        return set_categorical_metadata(out, self.get("output_col"), levels)


class IndexToValue(Transformer, HasInputCol, HasOutputCol):
    """Inverse of ValueIndexerModel, using the categorical metadata."""

    def _transform(self, df: DataFrame) -> DataFrame:
        levels = get_categorical_levels(df, self.get("input_col"))
        if levels is None:
            raise ValueError(f"column {self.get('input_col')!r} has no "
                             "categorical metadata")
        idx = df[self.get("input_col")].astype(np.int64)
        values = np.empty(len(idx), dtype=object)
        for i, k in enumerate(idx):
            values[i] = levels[k]
        try:
            values = np.asarray(list(values))
        except Exception:
            pass
        return df.with_column(self.get("output_col"), values)
