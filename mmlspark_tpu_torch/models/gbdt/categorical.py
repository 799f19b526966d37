"""Categorical feature handling for the GBDT trainer (counterpart of
``models/gbdt/categorical.py``; the port's own copy, host numpy).

LightGBM finds an optimal category *subset* per node by sorting the
categories by gradient statistics. The JAX package approximates that
search statically, and so does the port: each categorical feature's
values are re-indexed once per fit by their (smoothed) mean target, so an
ordinary threshold split over the encoded rank selects a contiguous run
of label-ordered categories. The tree kernels (K6, the split search,
routing, TreeSHAP) stay untouched; the encoder persists inside the
booster and is applied to the raw matrix before binning and prediction.

Unseen categories at predict time encode as NaN, the missing bin. Ranks
are small integers, exact in float32, so the trees' float32 thresholds
separate them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["CategoricalEncoder"]


class CategoricalEncoder:
    """Label-ordered rank encoding of selected feature columns.

    Regularization knobs mirror LightGBM's categorical parameters in this
    static setting: ``cat_smooth`` smooths each category's target mean
    toward the global mean with that many pseudo-counts (rare categories'
    noisy means stop dominating the ordering), and ``min_data_per_group``
    pools categories rarer than the threshold into one shared rank — a
    threshold split can then never isolate them, the analog of LightGBM
    refusing per-category treatment below its group-size floor. Because
    this pooling is GLOBAL (LightGBM's is per-node, far weaker), it
    defaults to off here — a deliberate deviation from LightGBM's 100.
    Pooling also skips when every category is rare (nothing to pool into).
    """

    def __init__(self, feature_indices: Sequence[int],
                 cat_smooth: float = 10.0, min_data_per_group: int = 0):
        self.feature_indices: List[int] = sorted(int(i)
                                                 for i in set(feature_indices))
        if cat_smooth < 0:
            raise ValueError("cat_smooth must be >= 0")
        if min_data_per_group < 0:
            raise ValueError("min_data_per_group must be >= 0")
        self.cat_smooth = float(cat_smooth)
        self.min_data_per_group = int(min_data_per_group)
        #: per feature: category values sorted ascending (lookup keys)
        self.values: List[np.ndarray] = []
        #: per feature: rank of each value under the label ordering
        self.ranks: List[np.ndarray] = []

    # -- fit ----------------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "CategoricalEncoder":
        self.values, self.ranks = [], []
        y = np.asarray(y, dtype=np.float64)
        for j in self.feature_indices:
            col = np.asarray(X[:, j], dtype=np.float64)
            ok = ~np.isnan(col)
            uniq, inv = np.unique(col[ok], return_inverse=True)
            sums = np.bincount(inv, weights=y[ok], minlength=len(uniq))
            cnts = np.bincount(inv, minlength=len(uniq)).astype(np.float64)
            gmean = float(y[ok].mean()) if ok.any() else 0.0
            mean = ((sums + self.cat_smooth * gmean)
                    / np.maximum(cnts + self.cat_smooth, 1e-12))
            if self.min_data_per_group > 0:
                rare = cnts < self.min_data_per_group
                if rare.any() and not rare.all():
                    pooled = ((sums[rare].sum() + self.cat_smooth * gmean)
                              / (cnts[rare].sum() + self.cat_smooth))
                    mean[rare] = pooled
            # equal means share one rank (pooled/tied categories become
            # inseparable by any threshold split)
            _, rank = np.unique(mean, return_inverse=True)
            self.values.append(uniq)
            self.ranks.append(rank.astype(np.float64))
        return self

    # -- transform ----------------------------------------------------------
    def transform(self, X: np.ndarray) -> np.ndarray:
        """Return a float copy with categorical columns replaced by their
        label-ordered ranks (unseen values / NaN → NaN → missing bin)."""
        if not self.feature_indices:
            return X
        # preserve float width: ranks are small integers (exact in float32)
        # and a HIGGS-scale float32 matrix must not silently double
        dt = X.dtype if np.asarray(X).dtype.kind == "f" else np.float64
        out = np.array(X, dtype=dt, copy=True)
        for (j, vals, rank) in zip(self.feature_indices, self.values,
                                   self.ranks):
            col = out[:, j]
            idx = np.searchsorted(vals, col)
            idx_c = np.clip(idx, 0, max(len(vals) - 1, 0))
            seen = (len(vals) > 0) & np.isfinite(col) \
                & (vals[idx_c] == col) if len(vals) else np.zeros(len(col),
                                                                  bool)
            enc = np.where(seen, rank[idx_c] if len(vals) else 0.0, np.nan)
            out[:, j] = enc
        return out

    # -- persistence --------------------------------------------------------
    def to_dict(self) -> Dict:
        return {"feature_indices": self.feature_indices,
                "values": [v.tolist() for v in self.values],
                "ranks": [r.tolist() for r in self.ranks]}

    @staticmethod
    def from_dict(d: Dict) -> "CategoricalEncoder":
        enc = CategoricalEncoder(d["feature_indices"])
        enc.values = [np.asarray(v, dtype=np.float64) for v in d["values"]]
        enc.ranks = [np.asarray(r, dtype=np.float64) for r in d["ranks"]]
        return enc
