"""Per-tenant feature utilities: id indexers and scalar scalers.

Parity: ``synapse/ml/cyber/feature/indexers.py`` (IdIndexer/MultiIndexer —
contiguous 1-based ids per partition key, with ``undo_transform``) and
``feature/scalers.py`` (StandardScalarScaler / LinearScalarScaler — z-score
or min-max scaling computed within each partition).

The port's copy of ``mmlspark_tpu/cyber/features.py``
(numpy only, host work).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..core.params import ComplexParam, HasInputCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model
from ..core.schema import py_scalar as _py

__all__ = ["IdIndexer", "IdIndexerModel", "MultiIndexer", "MultiIndexerModel",
           "StandardScalarScaler", "StandardScalarScalerModel",
           "LinearScalarScaler", "LinearScalarScalerModel"]

_NO_TENANT = "__no_tenant__"


def _tenants(df: DataFrame, key: Optional[str]) -> np.ndarray:
    if key is None:
        return np.full(len(df), _NO_TENANT, dtype=object)
    return df[key]


class IdIndexer(Estimator, HasInputCol, HasOutputCol):
    """Map raw ids to contiguous per-tenant 1-based integer ids."""

    partition_key = Param(str, default=None, doc="tenant column (optional)")
    reset_per_partition = Param(bool, default=True,
                                doc="ids restart at 1 within each tenant "
                                    "(vs globally contiguous)")

    def _fit(self, df: DataFrame) -> "IdIndexerModel":
        key = self.get_or_none("partition_key")
        tenants = _tenants(df, key)
        vals = df[self.get("input_col")]
        vocab: Dict = {}
        # store plain Python scalars so the fitted vocab is JSON-serializable
        if self.get("reset_per_partition"):
            counters: Dict = {}
            for t, v in zip(tenants, vals):
                t, v = _py(t), _py(v)
                if (t, v) not in vocab:
                    counters[t] = counters.get(t, 0) + 1
                    vocab[(t, v)] = counters[t]
        else:
            nxt = 1
            for t, v in zip(tenants, vals):
                t, v = _py(t), _py(v)
                if (t, v) not in vocab:
                    vocab[(t, v)] = nxt
                    nxt += 1
        m = IdIndexerModel()
        m.set(input_col=self.get("input_col"),
              output_col=self.get("output_col"), partition_key=key,
              vocab=[[t, v, i] for (t, v), i in vocab.items()])
        return m


class IdIndexerModel(Model, HasInputCol, HasOutputCol):
    partition_key = Param(str, default=None, doc="tenant column (optional)")
    vocab = ComplexParam(default=None, doc="[[tenant, value, id], ...]")

    def _lookup(self) -> Dict:
        return {(t, v): i for t, v, i in self.get("vocab")}

    def _transform(self, df: DataFrame) -> DataFrame:
        lut = self._lookup()
        tenants = _tenants(df, self.get_or_none("partition_key"))
        vals = df[self.get("input_col")]
        out = np.array([lut.get((_py(t), _py(v)), 0)
                        for t, v in zip(tenants, vals)],
                       dtype=np.int64)   # 0 = unseen id
        return df.with_column(self.get("output_col"), out)

    def undo_transform(self, df: DataFrame) -> DataFrame:
        """Indexed ids → original values (reference ``undo_transform``)."""
        inv = {(t, i): v for t, v, i in self.get("vocab")}
        tenants = _tenants(df, self.get_or_none("partition_key"))
        idx = df[self.get("output_col")]
        vals = object_col([inv.get((_py(t), int(i)))
                           for t, i in zip(tenants, idx)])
        return df.with_column(self.get("input_col"), vals)


class MultiIndexer(Estimator):
    """Fit several IdIndexers at once (reference ``MultiIndexer``)."""

    indexers = ComplexParam(default=[], doc="list of IdIndexer stages")

    def __init__(self, indexers: Optional[List[IdIndexer]] = None, **kw):
        super().__init__(**kw)
        if indexers is not None:
            self.set(indexers=list(indexers))

    def _fit(self, df: DataFrame) -> "MultiIndexerModel":
        models = [ix.fit(df) for ix in self.get("indexers")]
        m = MultiIndexerModel()
        m.set(models=models)
        return m


class MultiIndexerModel(Model):
    models = ComplexParam(default=[], doc="fitted IdIndexerModels")

    def _transform(self, df: DataFrame) -> DataFrame:
        for m in self.get("models"):
            df = m.transform(df)
        return df

    def get_model_by_input_col(self, input_col: str) -> Optional[IdIndexerModel]:
        for m in self.get("models"):
            if m.get("input_col") == input_col:
                return m
        return None


# ---------------------------------------------------------------------------
# scalers
# ---------------------------------------------------------------------------

class _ScalerBase(Estimator, HasInputCol, HasOutputCol):
    partition_key = Param(str, default=None, doc="tenant column (optional)")

    def _group_stats(self, df: DataFrame):
        key = self.get_or_none("partition_key")
        tenants = _tenants(df, key)
        vals = df[self.get("input_col")].astype(np.float64)
        stats = {}
        for t in dict.fromkeys(tenants):
            stats[t] = self._stat(vals[tenants == t])
        return [[t, *s] for t, s in stats.items()]


class StandardScalarScaler(_ScalerBase):
    """Per-tenant z-score (reference ``StandardScalarScaler``)."""

    coefficient_factor = Param(float, default=1.0,
                               doc="multiplier applied after standardization")

    def _stat(self, v):
        return [float(v.mean()), float(v.std())]

    def _fit(self, df: DataFrame) -> "StandardScalarScalerModel":
        m = StandardScalarScalerModel()
        m.set(input_col=self.get("input_col"),
              output_col=self.get("output_col"),
              partition_key=self.get_or_none("partition_key"),
              per_group_stats=self._group_stats(df),
              coefficient_factor=self.get("coefficient_factor"))
        return m


class StandardScalarScalerModel(Model, HasInputCol, HasOutputCol):
    partition_key = Param(str, default=None, doc="tenant column (optional)")
    per_group_stats = ComplexParam(default=None, doc="[[tenant, mean, std]]")
    coefficient_factor = Param(float, default=1.0, doc="post multiplier")

    def _transform(self, df: DataFrame) -> DataFrame:
        stats = {t: (mu, sd) for t, mu, sd in self.get("per_group_stats")}
        tenants = _tenants(df, self.get_or_none("partition_key"))
        v = df[self.get("input_col")].astype(np.float64)
        out = np.empty(len(df))
        for i, (t, x) in enumerate(zip(tenants, v)):
            mu, sd = stats.get(t, (0.0, 1.0))
            out[i] = self.get("coefficient_factor") * (
                (x - mu) / sd if sd > 0 else 0.0)
        return df.with_column(self.get("output_col"), out)


class LinearScalarScaler(_ScalerBase):
    """Per-tenant min-max mapping to [min_required, max_required]."""

    min_required_value = Param(float, default=0.0, doc="output min")
    max_required_value = Param(float, default=1.0, doc="output max")

    def _stat(self, v):
        return [float(v.min()), float(v.max())]

    def _fit(self, df: DataFrame) -> "LinearScalarScalerModel":
        m = LinearScalarScalerModel()
        m.set(input_col=self.get("input_col"),
              output_col=self.get("output_col"),
              partition_key=self.get_or_none("partition_key"),
              per_group_stats=self._group_stats(df),
              min_required_value=self.get("min_required_value"),
              max_required_value=self.get("max_required_value"))
        return m


class LinearScalarScalerModel(Model, HasInputCol, HasOutputCol):
    partition_key = Param(str, default=None, doc="tenant column (optional)")
    per_group_stats = ComplexParam(default=None, doc="[[tenant, min, max]]")
    min_required_value = Param(float, default=0.0, doc="output min")
    max_required_value = Param(float, default=1.0, doc="output max")

    def _transform(self, df: DataFrame) -> DataFrame:
        stats = {t: (lo, hi) for t, lo, hi in self.get("per_group_stats")}
        tenants = _tenants(df, self.get_or_none("partition_key"))
        v = df[self.get("input_col")].astype(np.float64)
        lo_r = self.get("min_required_value")
        hi_r = self.get("max_required_value")
        out = np.empty(len(df))
        for i, (t, x) in enumerate(zip(tenants, v)):
            lo, hi = stats.get(t, (0.0, 1.0))
            if hi > lo:
                out[i] = lo_r + (x - lo) * (hi_r - lo_r) / (hi - lo)
            else:
                out[i] = (lo_r + hi_r) / 2.0
        return df.with_column(self.get("output_col"), out)
