"""Column type conversion.

Parity surface: ``DataConversion`` (reference
``core/.../featurize/DataConversion.scala:22``): cast listed columns to a
target type; date parsing via a format string.

The port's copy of ``mmlspark_tpu/featurize/data_conversion.py`` (numpy
only, host work).
"""

from __future__ import annotations

from datetime import datetime

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasInputCols, Param
from ..core.pipeline import Transformer

__all__ = ["DataConversion"]

_CASTS = {
    "boolean": np.bool_, "byte": np.int8, "short": np.int16, "integer": np.int32,
    "long": np.int64, "float": np.float32, "double": np.float64,
}


class DataConversion(Transformer, HasInputCols):
    convert_to = Param(str, default="double",
                       choices=list(_CASTS) + ["string", "toCategorical",
                                               "clearCategorical", "date"],
                       doc="target type")
    date_time_format = Param(str, default="%Y-%m-%d %H:%M:%S",
                             doc="strptime format for date conversion")

    def _transform(self, df: DataFrame) -> DataFrame:
        target = self.get("convert_to")
        out = df
        for c in self.get("input_cols"):
            col = df[c]
            if target in _CASTS:
                out = out.with_column(c, col.astype(_CASTS[target]))
            elif target == "string":
                arr = np.empty(len(col), dtype=object)
                for i, v in enumerate(col):
                    arr[i] = str(v)
                out = out.with_column(c, arr)
            elif target == "date":
                fmt = self.get("date_time_format")
                arr = np.empty(len(col), dtype=object)
                for i, v in enumerate(col):
                    arr[i] = datetime.strptime(str(v), fmt)
                out = out.with_column(c, arr)
            elif target == "toCategorical":
                from .value_indexer import ValueIndexer
                model = ValueIndexer(input_col=c, output_col=c).fit(out)
                out = model.transform(out)
            elif target == "clearCategorical":
                from ..core.schema import CATEGORICAL_KEY, get_categorical_levels
                levels = get_categorical_levels(out, c)
                if levels is not None:
                    idx = out[c].astype(np.int64)
                    vals = np.asarray([levels[k] for k in idx])
                    md = {k: v for k, v in out.column_metadata(c).items()
                          if k != CATEGORICAL_KEY}
                    out = out.with_column(c, vals)
                    out._metadata[c] = md
        return out
