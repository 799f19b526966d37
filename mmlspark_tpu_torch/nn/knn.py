"""Exact KNN estimators (counterpart of ``mmlspark_tpu/nn/knn.py``).

Parity surface: ``KNN:48``/``KNNModel:78`` and
``ConditionalKNN:31``/``ConditionalKNNModel`` (reference
``core/.../nn/KNN.scala``), which fit a (Conditional)BallTree and emit, per
query row, the k best matches as structs {value, distance(, label)}.

Unconditional bulk queries run on the model's device as the JAX package
computes them: float32 ``‖q‖² + ‖c‖² − 2 q·c`` (one matmul, TF32 off), the
top k of ``-d2`` with ties to the lower corpus index (``jax.lax.top_k``'s
order), then ``sqrt(max(d2, 0))``. The JAX package forms the whole
(n_q, n_c) matrix; the port takes the queries in chunks whose ``d2`` stays
under :data:`D2_BUDGET_BYTES`, which gives the same rows. Conditional
queries (per-row label filters) use the host ball tree, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasFeaturesCol, HasOutputCol, Param
from ..core.pipeline import Estimator, Model
from ..utils.device import OnDevice, resolve_device
from .balltree import BallTree

__all__ = ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel",
           "brute_force_knn", "topk_stable", "D2_BUDGET_BYTES"]

#: the most bytes one chunk's float32 (queries, corpus) distance matrix may
#: take; the selection's int64 keys take twice that beside it
D2_BUDGET_BYTES = 1 << 30


def _features_matrix(df: DataFrame, col: str) -> np.ndarray:
    # host-side float64, as the JAX package keeps it; the device path casts
    # to float32 at the upload
    vals = df[col]
    if vals.dtype == object:
        return np.stack([np.asarray(v, dtype=np.float64).ravel()
                         for v in vals])
    return np.asarray(vals, dtype=np.float64).reshape(len(df), -1)


def topk_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` of a float32 (rows, n) tensor along its last axis:
    the k largest, descending, the lower index first among equal values
    (``-0.0`` equal to ``0.0``), as the port's full stable sort
    (``transformer._topk_stable``) orders them, without sorting the rows.

    Each value's bits become an int64 key that orders as the float does,
    shifted up 32 bits over ``n - 1 - index``: the keys are distinct, so
    ``torch.topk`` of the keys has one answer, the stable order."""
    n = x.shape[-1]
    bits = (x + 0.0).view(torch.int32).to(torch.int64)
    # negative floats order backwards as integers: flip their low 31 bits
    bits ^= (bits >> 63) & 0x7FFFFFFF
    low = (n - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
    bits <<= 32
    bits |= low
    top = torch.topk(bits, k, dim=-1).values
    idx = (n - 1) - (top & 0xFFFFFFFF)
    del bits
    return x.gather(-1, idx), idx


def _query_chunk(n_corpus: int, budget: int) -> int:
    return max(1, int(budget) // (4 * max(1, n_corpus)))


def brute_force_knn(corpus, queries, k: int, device=None,
                    budget: int = D2_BUDGET_BYTES):
    """Exact top-k on ``device`` (``None`` = the CUDA card). Returns
    (indices int64 (n_q, k), distances float32 (n_q, k)) as numpy.
    ``corpus`` / ``queries`` are arrays, or float32 tensors already on the
    device (a model's cached corpus)."""
    dev = (corpus.device if isinstance(corpus, torch.Tensor)
           else resolve_device(device))
    C = (corpus if isinstance(corpus, torch.Tensor) else
         torch.from_numpy(np.ascontiguousarray(corpus, np.float32)).to(dev))
    Q = (queries if isinstance(queries, torch.Tensor) else
         torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev))
    k = int(k)
    chunk = _query_chunk(C.shape[0], budget)
    idx_out = np.empty((Q.shape[0], k), dtype=np.int64)
    dist_out = np.empty((Q.shape[0], k), dtype=np.float32)
    with torch.no_grad():
        c2 = (C * C).sum(dim=1)
        for s in range(0, Q.shape[0], chunk):
            q = Q[s:s + chunk]
            q2 = (q * q).sum(dim=1)
            # the JAX package's order: (‖q‖² + ‖c‖²) − 2 q·c
            two_qc = (q @ C.T).mul_(2.0)
            d2 = q2[:, None] + c2[None, :]
            d2 -= two_qc
            del two_qc
            neg, idx = topk_stable(d2.neg_(), k)
            del d2
            idx_out[s:s + chunk] = idx.cpu().numpy()
            dist_out[s:s + chunk] = torch.sqrt(
                torch.clamp(-neg, min=0.0)).cpu().numpy()
    return idx_out, dist_out


class _KNNParams(HasFeaturesCol, HasOutputCol):
    values_col = Param(str, default="values",
                       doc="column whose values are returned for matches")
    k = Param(int, default=5, doc="neighbours per query")
    leaf_size = Param(int, default=50, doc="ball tree leaf size")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(output_col="output")


class KNN(OnDevice, Estimator, _KNNParams):
    def _fit(self, df: DataFrame) -> "KNNModel":
        X = _features_matrix(df, self.get("features_col"))
        vcol = self.get("values_col")
        values = list(df[vcol]) if vcol in df else list(range(len(df)))
        m = KNNModel(device=self.device)
        m.set(features_col=self.get("features_col"),
              output_col=self.get("output_col"), k=self.get("k"),
              corpus=X, values=[_json_safe(v) for v in values])
        return m


def _json_safe(v):
    return v.item() if isinstance(v, np.generic) else v


class KNNModel(OnDevice, Model, _KNNParams):
    corpus = ComplexParam(default=None, doc="(n, d) fitted feature matrix")
    values = Param(list, default=[], doc="per-corpus-row payload values")

    def _device_corpus(self) -> torch.Tensor:
        """The corpus as float32 on the model's device, placed once per
        (device, corpus array)."""
        corpus = self.get("corpus")
        key = (str(self.device), id(corpus))
        cached = getattr(self, "_corpus_cache", None)
        if cached is None or cached[0] != key:
            t = torch.from_numpy(np.ascontiguousarray(
                corpus, np.float32)).to(self.device)
            self._corpus_cache = cached = (key, t)
        return cached[1]

    def _transform(self, df: DataFrame) -> DataFrame:
        Q = _features_matrix(df, self.get("features_col"))
        corpus = self._device_corpus()
        k = min(self.get("k"), corpus.shape[0])
        idx, dist = brute_force_knn(corpus, Q, k)
        values = self.get("values")
        out = np.empty(len(df), dtype=object)
        for i in range(len(df)):
            out[i] = [{"value": values[j], "distance": float(d)}
                      for j, d in zip(idx[i], dist[i])]
        return df.with_column(self.get("output_col"), out)


class ConditionalKNN(Estimator, _KNNParams):
    label_col = Param(str, default="labels", doc="corpus label column")

    def _fit(self, df: DataFrame) -> "ConditionalKNNModel":
        X = _features_matrix(df, self.get("features_col"))
        vcol = self.get("values_col")
        values = list(df[vcol]) if vcol in df else list(range(len(df)))
        labels = df[self.get("label_col")]
        tree = BallTree(X, labels=labels, leaf_size=self.get("leaf_size"))
        m = ConditionalKNNModel()
        m.set(features_col=self.get("features_col"),
              output_col=self.get("output_col"), k=self.get("k"),
              label_col=self.get("label_col"),
              ball_tree=tree.to_tree(),
              values=[_json_safe(v) for v in values])
        return m


class ConditionalKNNModel(Model, _KNNParams):
    label_col = Param(str, default="labels", doc="corpus label column")
    conditioner_col = Param(str, default="conditioner",
                            doc="query column holding the allowed-label set")
    ball_tree = ComplexParam(default=None, doc="serialized BallTree arrays")
    values = Param(list, default=[], doc="per-corpus-row payload values")

    def _transform(self, df: DataFrame) -> DataFrame:
        tree = BallTree.from_tree(self.get("ball_tree"))
        Q = _features_matrix(df, self.get("features_col"))
        conds = (df[self.get("conditioner_col")]
                 if self.get("conditioner_col") in df else [None] * len(df))
        values = self.get("values")
        k = self.get("k")
        out = np.empty(len(df), dtype=object)
        for i in range(len(df)):
            allowed = None if conds[i] is None else set(
                _json_safe(c) for c in np.atleast_1d(conds[i]))
            idx, dist = tree.query(Q[i], k=k, allowed_labels=allowed)
            out[i] = [{"value": values[j], "distance": float(d),
                       "label": _json_safe(tree.labels[j])}
                      for j, d in zip(idx, dist)]
        return df.with_column(self.get("output_col"), out)
