"""Complement-set access sampling.

Parity: ``synapse/ml/cyber/anomaly/complement_access.py`` — for each observed
(indexed) access tuple, draw ``complementset_factor`` random tuples from the
per-tenant index ranges, drop any that actually occur in the data, and return
the remainder (a sample of accesses that did NOT happen — the negatives for
explicit-feedback training).

The port's copy of ``mmlspark_tpu/cyber/complement_access.py``
(numpy only, host work).
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..core.params import Param
from ..core.pipeline import Transformer

__all__ = ["ComplementAccessTransformer"]


class ComplementAccessTransformer(Transformer):
    partition_key = Param(str, default=None, doc="tenant column (optional)")
    indexed_col_names = Param((list, str), default=[],
                              doc="indexed id columns (e.g. user/res indices)")
    complementset_factor = Param(int, default=2,
                                 doc="candidate samples drawn per input row")
    seed = Param(int, default=0, doc="sampling seed")

    def _transform(self, df: DataFrame) -> DataFrame:
        factor = self.get("complementset_factor")
        cols = self.get("indexed_col_names")
        key = self.get_or_none("partition_key")
        if factor == 0 or not len(df):
            empty = {c: np.array([], dtype=np.int64) for c in cols}
            if key is not None:
                empty = {key: np.array([], dtype=object), **empty}
            return DataFrame(empty)

        tenants = (df[key] if key is not None
                   else np.zeros(len(df), dtype=np.int64))
        vals = {c: df[c].astype(np.int64) for c in cols}
        rng = np.random.default_rng(self.get("seed"))

        out_tenant, out_cols = [], {c: [] for c in cols}
        for t in dict.fromkeys(tenants):
            mask = tenants == t
            n = int(mask.sum())
            los = {c: int(vals[c][mask].min()) for c in cols}
            his = {c: int(vals[c][mask].max()) for c in cols}
            seen = set(zip(*(vals[c][mask] for c in cols)))
            cand = {c: rng.integers(los[c], his[c] + 1, n * factor)
                    for c in cols}
            kept = set()
            for row in zip(*(cand[c] for c in cols)):
                if row not in seen:
                    kept.add(row)
            for row in sorted(kept):
                out_tenant.append(t)
                for c, v in zip(cols, row):
                    out_cols[c].append(int(v))

        data = {c: np.asarray(out_cols[c], dtype=np.int64) for c in cols}
        if key is not None:
            data = {key: object_col(out_tenant), **data}
        return DataFrame(data)
