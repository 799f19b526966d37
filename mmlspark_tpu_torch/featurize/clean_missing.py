"""Missing-value cleaning.

Parity surface: ``CleanMissingData`` (reference
``core/.../featurize/CleanMissingData.scala:48``): fit computes per-column
replacement values (mean / median / custom), transform fills NaN/None.

The port's copy of ``mmlspark_tpu/featurize/clean_missing.py`` (numpy
only, host work).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasInputCols, HasOutputCols, Param
from ..core.pipeline import Estimator, Model

__all__ = ["CleanMissingData", "CleanMissingDataModel"]


class CleanMissingData(Estimator, HasInputCols, HasOutputCols):
    cleaning_mode = Param(str, default="Mean",
                          choices=["Mean", "Median", "Custom"],
                          doc="replacement strategy")
    custom_value = Param(float, default=None, doc="fill value for Custom mode")

    def __init__(self, input_cols: Optional[Sequence[str]] = None,
                 output_cols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if input_cols is not None:
            self.set(input_cols=list(input_cols))
        if output_cols is not None:
            self.set(output_cols=list(output_cols))

    def _fit(self, df: DataFrame) -> "CleanMissingDataModel":
        mode = self.get("cleaning_mode")
        fills = []
        for c in self.get("input_cols"):
            col = df[c].astype(np.float64)
            if mode == "Mean":
                fills.append(float(np.nanmean(col)))
            elif mode == "Median":
                fills.append(float(np.nanmedian(col)))
            else:
                fills.append(float(self.get("custom_value")))
        m = CleanMissingDataModel()
        m.set(input_cols=self.get("input_cols"),
              output_cols=self.get("output_cols") or self.get("input_cols"),
              fill_values=fills)
        return m


class CleanMissingDataModel(Model, HasInputCols, HasOutputCols):
    fill_values = Param(list, default=[], doc="replacement value per column")

    def _transform(self, df: DataFrame) -> DataFrame:
        out = df
        outs = self.get("output_cols") or self.get("input_cols")
        for c, o, fill in zip(self.get("input_cols"), outs, self.get("fill_values")):
            col = df[c].astype(np.float64).copy()
            col[np.isnan(col)] = fill
            out = out.with_column(o, col)
        return out
