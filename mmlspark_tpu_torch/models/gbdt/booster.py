"""Booster — the fitted GBDT model (counterpart of
``models/gbdt/booster.py``).

Trees live as stacked fixed-shape numpy arrays (T, ...) on the host;
prediction moves them to the booster's device (CUDA unless the caller
asks for the CPU) and descends every row through every tree there with
vectorized gathers. ``to_string`` / ``from_string`` use the JAX package's
format (JSON + base64 npz), so a model written by either package loads
into the other and predicts the same.

A multiclass booster (``num_class`` K >= 2) stores its trees class-major,
K an iteration, each with its leaf values in row k of a (K, 2^depth)
array and zeros in the others; the model string records ``num_class``.

After ``fit``: :meth:`Booster.shap_values` (path-dependent TreeSHAP in
float64 on the booster's device, all trees' leaves batched,
``treeshap.py``), :meth:`Booster.refit` (the trees' leaves re-estimated
on new data, gradients and per-leaf sums on the device, no host round
trip a tree) and :meth:`Booster.trees_to_dataframe`; ``onnx_export.py``
writes the trees as an ai.onnx.ml graph.

A model trained with ``categorical_feature`` carries its
``CategoricalEncoder`` (``cat_encoder``): every prediction path rewrites
the raw matrix into the trees' rank space first (:meth:`Booster._x_eff`),
so SHAP values of such a model are in that space, as the JAX package's.
A ``linear_tree`` model carries per-leaf ridge coefficients over each
leaf's path features (``linear``: ``coefs`` (T, 2^D, D+1), ``pf`` (T,
2^D, D)); prediction evaluates them, and ``leaf_values`` hold the bias as
the constant view. TreeSHAP and ``refit`` refuse a linear model, as the
JAX package's do. :meth:`Booster.scale_trees` is dart's re-weighting of
dropped trees.
"""

from __future__ import annotations

import base64
import io
import json
from typing import List, Optional

import numpy as np
import torch

from ...utils.device import resolve_device
from .trees import (map_rows, predict_leaf_indices, predict_trees,
                    predict_trees_linear)

__all__ = ["Booster"]


def _leftover(what: str, item: Optional[int] = None,
              heading: str = "Slice 6 leftovers") -> NotImplementedError:
    """The error of a mode outside the port, naming its ROADMAP.md item
    (§1's queue number, where it has one)."""
    where = f", queue item {item}" if item else ""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, {heading}{where})")


class Booster:
    def __init__(self, depth: int, n_features: int, objective: str,
                 base_score: float = 0.0, num_class: int = 1,
                 feats: Optional[np.ndarray] = None,
                 thr_raw: Optional[np.ndarray] = None,
                 leaf_values: Optional[np.ndarray] = None,
                 gains: Optional[np.ndarray] = None,
                 covers: Optional[np.ndarray] = None,
                 best_iteration: int = -1, *, device=None):
        self.depth = depth
        self.n_features = n_features
        self.objective = objective
        self.base_score = base_score
        self.num_class = num_class
        #: where prediction runs (CUDA unless the caller asked otherwise)
        self.device = resolve_device(device)
        n_int = 2 ** depth - 1
        n_leaf = 2 ** depth
        n_all = 2 ** (depth + 1) - 1
        shape_leaf = (0, num_class, n_leaf) if num_class > 1 else (0, n_leaf)
        # tree arrays accumulate in a pending list (O(1) append per
        # iteration) and are stacked lazily behind __getattr__
        self._base = {
            "feats": feats if feats is not None else np.zeros((0, n_int), np.int32),
            "thr_raw": thr_raw if thr_raw is not None else np.zeros((0, n_int), np.float32),
            "leaf_values": leaf_values if leaf_values is not None else
                np.zeros(shape_leaf, np.float32),
            "gains": gains if gains is not None else np.zeros((0, n_int), np.float32),
            "covers": covers if covers is not None else np.zeros((0, n_all), np.float32),
        }
        self._pending: List[tuple] = []
        self.best_iteration = best_iteration
        #: training hyperparams (learning_rate, lambda_l2); serialized
        self.fit_params = None
        #: host seconds of the training phases (bin_fit, bin_transform,
        #: upload, boost, and the modes' own), stamped by train(); not
        #: serialized
        self.phase_seconds = None
        #: label-ordered categorical encoder (categorical.py), applied to
        #: raw X before every prediction path when set
        self.cat_encoder = None
        #: linear leaves: {"coefs": (T, 2^D, D+1), "pf": (T, 2^D, D)} or
        #: None for constant-leaf models
        self._lin_base = None
        self._lin_pending: List[tuple] = []

    # -- bookkeeping --------------------------------------------------------
    _FIELDS = ("feats", "thr_raw", "leaf_values", "gains", "covers")

    def _materialize(self) -> None:
        if self._pending:
            for i, name in enumerate(self._FIELDS):
                self._base[name] = np.concatenate(
                    [self._base[name]] + [np.asarray(p[i])[None]
                                          for p in self._pending])
            self._pending = []
        if self._lin_pending:
            parts = {k: [np.asarray(p[i])[None] for p in self._lin_pending]
                     for i, k in enumerate(("coefs", "pf"))}
            base = self._lin_base or {k: v[0][:0] for k, v in parts.items()}
            self._lin_base = {k: np.concatenate([base[k]] + parts[k])
                              for k in parts}
            self._lin_pending = []

    def __getattr__(self, name):
        if name in Booster._FIELDS:
            self._materialize()
            return self._base[name]
        raise AttributeError(name)

    @property
    def is_linear(self) -> bool:
        """True for linear-leaf models (LightGBM ``linear_tree``)."""
        return self._lin_base is not None or bool(self._lin_pending)

    @property
    def linear(self):
        self._materialize()
        return self._lin_base

    @property
    def num_trees(self) -> int:
        return len(self._base["feats"]) + len(self._pending)

    def append_tree(self, feat, thr_raw, leaf_value, gain, cover,
                    coefs=None, pf=None):
        if (coefs is None) != (pf is None) \
                or ((coefs is None) and self.is_linear) \
                or (coefs is not None and self.num_trees
                    and not self.is_linear):
            raise ValueError("a booster is linear for all trees or none")
        self._pending.append((feat, thr_raw, leaf_value, gain, cover))
        if coefs is not None:
            self._lin_pending.append((coefs, pf))

    def scale_trees(self, idx, factor: float) -> None:
        """Multiply the leaf outputs of trees ``idx`` in place (dart's
        k / (k + 1) re-weighting of dropped trees); linear leaves scale
        their whole coefficient vector (the output is linear in it)."""
        self._materialize()
        idx = np.asarray(idx, dtype=np.int64)
        self._base["leaf_values"][idx] *= np.float32(factor)
        if self._lin_base is not None:
            self._lin_base["coefs"][idx] *= np.float32(factor)

    def _like(self, arrays, best_iteration, lin=None) -> "Booster":
        """A booster of this one's kind over ``arrays`` (the five tree
        fields in order), with its encoder and fit params."""
        b = Booster(self.depth, self.n_features, self.objective,
                    self.base_score, self.num_class, *arrays,
                    best_iteration=best_iteration, device=self.device)
        b.cat_encoder = self.cat_encoder  # trees split in the encoded space
        b.fit_params = self.fit_params
        b._lin_base = lin
        return b

    def truncated(self, n_trees: int) -> "Booster":
        """Model truncated to the first n_trees (early-stopping cutoff);
        arrays are copied, not viewed (dart's ``scale_trees`` mutates the
        live stack in place)."""
        lin = self.linear
        return self._like(
            [getattr(self, f)[:n_trees].copy() for f in self._FIELDS],
            n_trees, lin and {k: v[:n_trees].copy() for k, v in lin.items()})

    def merge(self, other: "Booster") -> "Booster":
        """Concatenate trees (parity: mergeBooster)."""
        assert self.depth == other.depth and self.num_class == other.num_class
        if self.is_linear != other.is_linear:
            raise ValueError("cannot merge a linear-tree booster with a "
                             "constant-leaf booster")
        a, b = self.linear, other.linear
        return self._like(
            [np.concatenate([getattr(self, f), getattr(other, f)])
             for f in self._FIELDS], -1,
            a and {k: np.concatenate([a[k], b[k]]) for k in a})

    # -- prediction ---------------------------------------------------------
    # thresholds and feature comparisons are float32 end to end, as in the
    # JAX package; dense X crosses to the device in one pass, scipy-sparse
    # X in bounded chunks (trees.map_rows)
    def _tree_cap(self, num_iteration: Optional[int]) -> int:
        """Trees used for a ``num_iteration`` predict cap (LightGBM
        semantics: None = the early-stopped ``best_iteration`` when one
        exists, else all; <= 0 = all; multiclass counts iterations)."""
        if num_iteration is None:
            it = self.best_iteration if self.best_iteration > 0 else 0
        elif num_iteration <= 0:
            it = 0
        else:
            it = int(num_iteration)
        if not it:
            return self.num_trees
        k = self.num_class if self.num_class > 1 else 1
        return min(self.num_trees, it * k)

    def _on_device(self, *arrays):
        return [torch.as_tensor(np.asarray(a)).to(self.device)
                for a in arrays]

    def _x_eff(self, X):
        """Raw matrix -> the space the trees split in (categorical columns
        replaced by their label-ordered ranks). scipy-sparse X passes
        through (prediction densifies it in bounded chunks)."""
        from .binning import is_sparse
        if is_sparse(X):
            if self.cat_encoder is not None:
                raise ValueError("categorical encoding and sparse features "
                                 "cannot combine (rank-encode before "
                                 "sparsifying, or pass dense input)")
            return X
        if self.cat_encoder is not None:
            X = self.cat_encoder.transform(np.asarray(X))
        return X

    def raw_score_on_device(self, X, num_iteration: Optional[int] = None
                            ) -> torch.Tensor:
        """:meth:`raw_score` as a float32 tensor on the booster's device,
        (n,) or (n, K): the trees summed in order from zero, then
        ``base_score`` added."""
        X = self._x_eff(X)
        T = self._tree_cap(num_iteration)
        if T == 0:
            n, K = X.shape[0], self.num_class
            return torch.full((n, K) if K > 1 else (n,), self.base_score,
                              dtype=torch.float32, device=self.device)
        f, t = self._on_device(self.feats[:T], self.thr_raw[:T])
        if self.is_linear:
            c, pf = self._on_device(self.linear["coefs"][:T],
                                    self.linear["pf"][:T])

            def fn(xd):
                return predict_trees_linear(f, t, c, pf, xd, self.depth,
                                            self.num_class)
        else:
            lv, = self._on_device(self.leaf_values[:T])

            def fn(xd):
                return predict_trees(f, t, lv, xd, self.depth)
        return map_rows(fn, X, self.device) + self.base_score

    def raw_score(self, X, num_iteration: Optional[int] = None) -> np.ndarray:
        return self.raw_score_on_device(X, num_iteration).cpu().numpy()

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None) -> np.ndarray:
        """``num_iteration``: predict with the first k iterations only
        (LightGBM's knob; None = the early-stopped best_iteration)."""
        raw = self.raw_score(X, num_iteration=num_iteration)
        if raw_score:
            return raw
        from .objectives import get_objective
        obj = get_objective(self.objective, num_class=max(self.num_class, 2))
        return obj.transform(torch.from_numpy(np.asarray(raw))).numpy()

    def _leaves_on_device(self, X) -> torch.Tensor:
        X = self._x_eff(X)
        f, t = self._on_device(self.feats, self.thr_raw)
        return map_rows(lambda xd: predict_leaf_indices(f, t, xd, self.depth),
                        X, self.device)

    def predict_leaf(self, X) -> np.ndarray:
        """Leaf index per (row, tree), (n, T) int32 (LightGBM
        predictLeaf)."""
        return self._leaves_on_device(X).cpu().numpy()

    # -- TreeSHAP -----------------------------------------------------------
    def shap_values(self, X) -> np.ndarray:
        """Path-dependent TreeSHAP on the booster's device. Returns (n, F+1)
        float32: per-feature contributions plus the expected value in the
        last column (the layout LightGBM's predict_contrib emits); a
        multiclass model gives (K, n, F+1). A categorical model's values
        are in its rank space; a linear model raises (LightGBM rejects
        predict_contrib for linear_tree models too)."""
        from .treeshap import shap_trees
        if self.is_linear:
            raise NotImplementedError(
                "TreeSHAP over linear leaves is not defined (LightGBM "
                "rejects predict_contrib for linear_tree models too)")
        X = self._x_eff(X)
        phi = map_rows(lambda xd: shap_trees(
            self.feats, self.thr_raw, self.leaf_values, self.covers,
            self.depth, self.num_class, self.base_score, xd),
            X, self.device, dim=1)
        out = phi if self.num_class > 1 else phi[0]
        return out.to(torch.float32).cpu().numpy()

    # -- refit (parity: LightGBM Booster.refit) -----------------------------
    def refit(self, X, y, decay_rate: float = 0.9,
              learning_rate: Optional[float] = None,
              lam: Optional[float] = None,
              sample_weight=None) -> "Booster":
        """Adapt the model to new data without changing tree structures:
        every tree keeps its splits, its leaf values are re-estimated on
        ``(X, y)`` and blended ``decay * old + (1 - decay) * new``
        (LightGBM's ``Booster.refit(decay_rate=0.9)``).

        Trees refit in boosting order, each tree's gradients taken at the
        running scores of the refitted prefix; tree t updates class t % K
        only, and a leaf no row reaches keeps its value.
        ``learning_rate`` / ``lam`` default to the training values in
        ``fit_params``. On the booster's device: leaf indices, the
        objective's gradients, per-leaf float64 sums by a scatter-add; the
        leaf values come back once, at the end."""
        if self.is_linear:
            raise NotImplementedError(
                "refit re-estimates constant leaf values; linear leaves "
                "need a full linear refit (retrain instead)")
        if not 0.0 <= decay_rate <= 1.0:
            raise ValueError(f"decay_rate must be in [0, 1], got {decay_rate}")
        fp = getattr(self, "fit_params", None) or {}
        if learning_rate is None:
            learning_rate = float(fp.get("learning_rate", 0.1))
        if lam is None:
            lam = float(fp.get("lambda_l2", 0.0)) + 1e-10  # train's lam
        from .objectives import get_objective
        y = np.asarray(y, dtype=np.float64)
        n = len(y)
        w = (np.asarray(sample_weight, dtype=np.float64)
             if sample_weight is not None else np.ones(n))
        K = self.num_class if self.num_class > 1 else 1
        obj = get_objective(self.objective, num_class=max(K, 2))
        if obj.grad_hess is None:
            raise NotImplementedError(
                f"refit needs analytic gradients for {self.objective!r}")
        dev = self.device
        T = self.num_trees
        n_leaf = 2 ** self.depth
        leaves = self._leaves_on_device(X).to(torch.int64)
        # one code path for both arities: leaf values as (T, K, L) and
        # gradients as (n, K); binary is the K == 1 case
        lvv = torch.as_tensor(np.ascontiguousarray(
            self.leaf_values, dtype=np.float32)).to(dev).reshape(
                T, K, n_leaf).clone()
        scores = torch.full((n, K) if K > 1 else (n,), self.base_score,
                            dtype=torch.float32, device=dev)
        y_d = torch.as_tensor(y, dtype=torch.float32).to(dev)
        w_d = torch.as_tensor(w, dtype=torch.float32).to(dev)
        for t in range(T):
            g, h = obj.grad_hess(scores, y_d, w_d)
            k = t % K
            li = leaves[:, t]
            # tree t was trained for class t % K only (class-major order)
            g = g.reshape(n, K)[:, k].to(torch.float64)
            h = h.reshape(n, K)[:, k].to(torch.float64)
            Gs = torch.zeros(n_leaf, dtype=torch.float64,
                             device=dev).index_add_(0, li, g)
            Hs = torch.zeros(n_leaf, dtype=torch.float64,
                             device=dev).index_add_(0, li, h)
            has = Hs > 0
            opt = torch.where(has, -Gs / (Hs + lam) * learning_rate, 0.0)
            blended = ((decay_rate * lvv[t, k]).to(torch.float64)
                       + (1.0 - decay_rate) * opt).to(torch.float32)
            # empty leaves keep their trained value (no evidence to move)
            lvv[t, k] = torch.where(has, blended, lvv[t, k])
            upd = lvv[t].T[li]                                  # (n, K)
            scores = scores + (upd if K > 1 else upd[:, 0])
        new_lv = lvv.cpu().numpy().reshape(self.leaf_values.shape)
        return self._like([self.feats.copy(), self.thr_raw.copy(), new_lv,
                           self.gains.copy(), self.covers.copy()],
                          self.best_iteration)

    # -- introspection (parity: LightGBM Booster.trees_to_dataframe) --------
    def trees_to_dataframe(self):
        """The model as a DataFrame of one row per node: tree_index,
        node_index (heap order), node_type (split / stub / leaf),
        split_feature (-1 for stubs and leaves), threshold, split_gain,
        count (training cover), class_index (-1 for structure rows),
        value (per-class leaf outputs: a multiclass model has one leaf row
        per class). Host numpy, vectorized."""
        from ...core.dataframe import DataFrame
        T = self.num_trees
        n_leaf = 2 ** self.depth
        n_int = n_leaf - 1
        K = self.num_class if self.num_class > 1 else 1
        feats = np.asarray(self.feats).reshape(T, n_int)
        stub = feats.ravel() < 0

        def nan_if(a):
            return np.where(stub, np.nan, a)
        internal = {
            "tree_index": np.repeat(np.arange(T), n_int),
            "node_index": np.tile(np.arange(n_int), T),
            "node_type": np.where(stub, "stub", "split"),
            "split_feature": feats.ravel(),
            "threshold": nan_if(np.asarray(self.thr_raw).ravel()
                                .astype(np.float64)),
            "split_gain": nan_if(np.asarray(self.gains).ravel()
                                 .astype(np.float64)),
            "count": np.asarray(self.covers)[:, :n_int].ravel()
                     .astype(np.float64),
            "class_index": np.full(T * n_int, -1),
            "value": np.full(T * n_int, np.nan),
        }
        lv = np.asarray(self.leaf_values).reshape(T, K, n_leaf)
        leaf_cov = np.asarray(self.covers)[:, n_int:].astype(np.float64)
        leaf = {
            "tree_index": np.repeat(np.arange(T), K * n_leaf),
            "node_index": np.tile(np.arange(n_int, n_int + n_leaf), T * K),
            "node_type": np.full(T * K * n_leaf, "leaf"),
            "split_feature": np.full(T * K * n_leaf, -1),
            "threshold": np.full(T * K * n_leaf, np.nan),
            "split_gain": np.full(T * K * n_leaf, np.nan),
            "count": np.repeat(leaf_cov[:, None, :], K, axis=1).ravel(),
            "class_index": np.tile(np.repeat(np.arange(K), n_leaf), T)
                           if K > 1 else np.zeros(T * n_leaf, np.int64),
            "value": lv.astype(np.float64).ravel(),
        }
        return DataFrame({k: np.concatenate([internal[k],
                                             np.asarray(leaf[k])])
                          for k in internal})

    # -- importances --------------------------------------------------------
    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        imp = np.zeros(self.n_features)
        valid = self.feats >= 0
        if importance_type == "split":
            np.add.at(imp, self.feats[valid], 1)
        elif importance_type == "gain":
            np.add.at(imp, self.feats[valid], self.gains[valid])
        else:
            raise ValueError(f"importance_type {importance_type!r}")
        return imp

    # -- persistence (parity: saveToString / loadFromString) ----------------
    def to_string(self) -> str:
        buf = io.BytesIO()
        arrays = dict(feats=self.feats, thr_raw=self.thr_raw,
                      leaf_values=self.leaf_values, gains=self.gains,
                      covers=self.covers)
        if self.is_linear:
            arrays["lin_coefs"] = self.linear["coefs"]
            arrays["lin_pf"] = self.linear["pf"]
        np.savez_compressed(buf, **arrays)
        meta = {"depth": self.depth, "n_features": self.n_features,
                "objective": self.objective, "base_score": self.base_score,
                "num_class": self.num_class,
                "best_iteration": self.best_iteration,
                "arrays": base64.b64encode(buf.getvalue()).decode("ascii")}
        if self.cat_encoder is not None:
            meta["cat_encoder"] = self.cat_encoder.to_dict()
        if self.fit_params is not None:
            meta["fit_params"] = self.fit_params
        return json.dumps(meta)

    @staticmethod
    def from_string(s: str, device=None) -> "Booster":
        """Load a model string written by either package; predictions run
        on ``device`` (CUDA when None)."""
        meta = json.loads(s)
        buf = io.BytesIO(base64.b64decode(meta["arrays"]))
        with np.load(buf) as z:
            arrays = {k: z[k] for k in z.files}
        b = Booster(meta["depth"], meta["n_features"], meta["objective"],
                    meta["base_score"], meta["num_class"],
                    arrays["feats"], arrays["thr_raw"],
                    arrays["leaf_values"], arrays["gains"],
                    arrays["covers"], meta["best_iteration"], device=device)
        if "lin_coefs" in arrays:
            b._lin_base = {"coefs": arrays["lin_coefs"],
                           "pf": arrays["lin_pf"]}
        if "cat_encoder" in meta:
            from .categorical import CategoricalEncoder
            b.cat_encoder = CategoricalEncoder.from_dict(meta["cat_encoder"])
        b.fit_params = meta.get("fit_params")
        return b
