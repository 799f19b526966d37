"""Isolation forest anomaly detection.

Parity surface: ``IsolationForest:18``/``IsolationForestModel:42`` (reference
``core/.../isolationforest/IsolationForest.scala``, wrapping LinkedIn's
isolation-forest). Re-implemented natively: trees are built host-side on
subsamples (cheap, O(n log n)), and scoring is fully vectorized — each tree is
flat arrays (feature, threshold, child pointers) and all rows descend the
tree in lockstep numpy steps.

The port's copy of ``mmlspark_tpu/isolationforest/iforest.py``
(numpy only, host work).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasFeaturesCol, HasPredictionCol, Param
from ..core.pipeline import Estimator, Model

__all__ = ["IsolationForest", "IsolationForestModel"]


def _avg_path_length(n: float) -> float:
    """c(n): average BST unsuccessful-search depth (the iForest normalizer)."""
    if n <= 1:
        return 0.0
    h = np.log(n - 1) + 0.5772156649
    return 2.0 * h - 2.0 * (n - 1) / n


def _build_tree(X: np.ndarray, rng: np.random.Generator, max_depth: int):
    """Arrays: feature, threshold, left, right, size (leaf: feature=-1)."""
    feats: List[int] = []
    thres: List[float] = []
    lefts: List[int] = []
    rights: List[int] = []
    sizes: List[int] = []

    def rec(idx: np.ndarray, depth: int) -> int:
        node = len(feats)
        feats.append(-1)
        thres.append(0.0)
        lefts.append(-1)
        rights.append(-1)
        sizes.append(len(idx))
        if depth >= max_depth or len(idx) <= 1:
            return node
        d = X.shape[1]
        for _ in range(d):  # find a splittable feature
            f = int(rng.integers(d))
            col = X[idx, f]
            lo, hi = col.min(), col.max()
            if hi > lo:
                t = float(rng.uniform(lo, hi))
                feats[node] = f
                thres[node] = t
                left_idx = idx[col < t]
                right_idx = idx[col >= t]
                lefts[node] = rec(left_idx, depth + 1)
                rights[node] = rec(right_idx, depth + 1)
                break
        return node

    rec(np.arange(len(X)), 0)
    return {"feature": np.asarray(feats, np.int64),
            "threshold": np.asarray(thres, np.float64),
            "left": np.asarray(lefts, np.int64),
            "right": np.asarray(rights, np.int64),
            "size": np.asarray(sizes, np.int64)}


def _tree_path_lengths(tree: dict, X: np.ndarray) -> np.ndarray:
    """All rows descend in lockstep; done rows hold their node."""
    n = len(X)
    node = np.zeros(n, dtype=np.int64)
    depth = np.zeros(n, dtype=np.float64)
    feature = tree["feature"]
    for _ in range(1 + int(np.log2(max(2, len(feature))) * 4)):
        f = feature[node]
        active = f >= 0
        if not active.any():
            break
        x = X[np.arange(n), np.where(active, f, 0)]
        go_left = x < tree["threshold"][node]
        nxt = np.where(go_left, tree["left"][node], tree["right"][node])
        node = np.where(active, nxt, node)
        depth += active
    leaf_size = tree["size"][node].astype(np.float64)
    return depth + np.vectorize(_avg_path_length)(leaf_size)


class IsolationForest(Estimator, HasFeaturesCol, HasPredictionCol):
    num_estimators = Param(int, default=100, doc="trees in the forest")
    max_samples = Param(int, default=256, doc="subsample size per tree")
    max_features = Param(float, default=1.0, doc="parity flag; unused")
    contamination = Param(float, default=0.0,
                          doc="expected outlier fraction (sets the threshold; "
                              "0 keeps the 0.5 score convention)")
    score_col = Param(str, default="outlierScore", doc="anomaly score column")
    seed = Param(int, default=0, doc="PRNG seed")

    def _fit(self, df: DataFrame) -> "IsolationForestModel":
        col = df[self.get("features_col")]
        X = (np.stack([np.asarray(v, dtype=np.float64).ravel() for v in col])
             if col.dtype == object else
             np.asarray(col, dtype=np.float64).reshape(len(df), -1))
        rng = np.random.default_rng(self.get("seed"))
        psi = min(self.get("max_samples"), len(X))
        max_depth = int(np.ceil(np.log2(max(2, psi))))
        trees = []
        for _ in range(self.get("num_estimators")):
            sub = rng.choice(len(X), size=psi, replace=False)
            trees.append(_build_tree(X[sub], rng, max_depth))

        m = IsolationForestModel()
        m.set(features_col=self.get("features_col"),
              prediction_col=self.get("prediction_col"),
              score_col=self.get("score_col"),
              trees=trees, subsample_size=psi)
        if self.get("contamination") > 0:
            scores = m._scores(X)
            thr = float(np.quantile(scores, 1.0 - self.get("contamination")))
            m.set(threshold=thr)
        return m


class IsolationForestModel(Model, HasFeaturesCol, HasPredictionCol):
    score_col = Param(str, default="outlierScore", doc="anomaly score column")
    trees = ComplexParam(default=None, doc="list of flat tree arrays")
    subsample_size = Param(int, default=256, doc="psi used at fit time")
    threshold = Param(float, default=0.5, doc="score above which = outlier")

    def _scores(self, X: np.ndarray) -> np.ndarray:
        trees = self.get("trees")
        depths = np.stack([_tree_path_lengths(t, X) for t in trees])
        e_h = depths.mean(axis=0)
        c = _avg_path_length(self.get("subsample_size"))
        return np.power(2.0, -e_h / c)

    def _transform(self, df: DataFrame) -> DataFrame:
        col = df[self.get("features_col")]
        X = (np.stack([np.asarray(v, dtype=np.float64).ravel() for v in col])
             if col.dtype == object else
             np.asarray(col, dtype=np.float64).reshape(len(df), -1))
        scores = self._scores(X)
        pred = (scores >= self.get("threshold")).astype(np.int64)
        return (df.with_column(self.get("score_col"), scores)
                  .with_column(self.get("prediction_col"), pred))
