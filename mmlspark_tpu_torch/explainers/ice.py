"""Individual Conditional Expectation (the port's copy of
``mmlspark_tpu/explainers/ice.py``).

Parity surface: ``ICEExplainer`` (reference ``explainers/ICETransformer.scala``
278 LoC): for each requested feature, sweep a grid of values, score the model
with that feature replaced for every instance, and emit per-instance curves
(kind="individual") or their average, the partial-dependence plot
(kind="average").
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import Param
from .base import LocalExplainer

__all__ = ["ICETransformer"]


class ICETransformer(LocalExplainer):
    kind = Param(str, default="individual", choices=["individual", "average"],
                 doc="per-instance curves or the PDP average")
    numeric_features = Param((list, str), default=[],
                             doc="numeric columns to sweep")
    categorical_features = Param((list, str), default=[],
                                 doc="categorical columns to sweep")
    num_splits = Param(int, default=10, doc="grid points per numeric feature")

    def _grid_for(self, df: DataFrame, feat: str, categorical: bool):
        col = df[feat]
        if categorical:
            return list(dict.fromkeys(
                v.item() if isinstance(v, np.generic) else v for v in col))
        f = col.astype(np.float64)
        return list(np.linspace(np.nanmin(f), np.nanmax(f),
                                self.get("num_splits")))

    def _transform(self, df: DataFrame) -> DataFrame:
        n = len(df)
        out = df
        feats = ([(f, False) for f in self.get("numeric_features")]
                 + [(f, True) for f in self.get("categorical_features")])
        for feat, is_cat in feats:
            grid = self._grid_for(df, feat, is_cat)
            g = len(grid)
            # one scoring frame: every instance × every grid value
            reps: Dict[str, np.ndarray] = {}
            for c in df.columns:
                col = df[c]
                reps[c] = np.tile(col, g) if col.dtype != object else \
                    np.concatenate([col] * g)
            swept = np.concatenate(
                [np.full(n, v, dtype=object if is_cat else np.float64)
                 for v in grid])
            reps[feat] = swept
            scores = self._score_frame(DataFrame(reps)).reshape(g, n).T
            curves = np.empty(n, dtype=object)
            if self.get("kind") == "average":
                pdp = scores.mean(axis=0)
                for i in range(n):
                    curves[i] = pdp
            else:
                for i in range(n):
                    curves[i] = scores[i]
            out = out.with_column(f"{feat}_dependence", curves)
            out = out.with_column_metadata(
                f"{feat}_dependence",
                {"ice_grid": [float(v) if not is_cat else v for v in grid]})
        return out
