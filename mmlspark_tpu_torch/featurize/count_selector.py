"""Zero-variance slot pruning for vector columns.

Parity surface: ``CountSelector`` (reference
``core/.../featurize/CountSelector.scala:23``): drop vector slots that are
zero for every row.

The port's copy of ``mmlspark_tpu/featurize/count_selector.py`` (numpy
only, host work).
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model

__all__ = ["CountSelector", "CountSelectorModel"]


def _as_matrix(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.stack([np.asarray(v, dtype=np.float64) for v in col])
    return np.asarray(col, dtype=np.float64)


class CountSelector(Estimator, HasInputCol, HasOutputCol):
    def _fit(self, df: DataFrame) -> "CountSelectorModel":
        X = _as_matrix(df[self.get("input_col")])
        keep = np.flatnonzero((X != 0).any(axis=0))
        m = CountSelectorModel()
        m.set(input_col=self.get("input_col"), output_col=self.get("output_col"),
              indices=[int(i) for i in keep])
        return m


class CountSelectorModel(Model, HasInputCol, HasOutputCol):
    indices = Param(list, default=[], doc="vector slots to keep")

    def _transform(self, df: DataFrame) -> DataFrame:
        X = _as_matrix(df[self.get("input_col")])
        out = X[:, np.asarray(self.get("indices"), dtype=np.int64)]
        col = np.empty(len(out), dtype=object)
        for i in range(len(out)):
            col[i] = out[i]
        return df.with_column(self.get("output_col"), col)
