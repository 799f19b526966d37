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

Left out: linear leaves and categorical encoders (a model string that
carries either raises ``NotImplementedError``).
"""

from __future__ import annotations

import base64
import io
import json
from typing import List, Optional

import numpy as np
import torch

from ...utils.device import resolve_device
from .trees import map_rows, predict_leaf_indices, predict_trees

__all__ = ["Booster"]


def _leftover(what: str, item: Optional[int] = None,
              heading: str = "slice-3 leftovers") -> NotImplementedError:
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
        #: upload, boost), stamped by train(); not serialized
        self.phase_seconds = None

    # -- bookkeeping --------------------------------------------------------
    _FIELDS = ("feats", "thr_raw", "leaf_values", "gains", "covers")

    def _materialize(self) -> None:
        if self._pending:
            for i, name in enumerate(self._FIELDS):
                self._base[name] = np.concatenate(
                    [self._base[name]] + [np.asarray(p[i])[None]
                                          for p in self._pending])
            self._pending = []

    def __getattr__(self, name):
        if name in Booster._FIELDS:
            self._materialize()
            return self._base[name]
        raise AttributeError(name)

    @property
    def num_trees(self) -> int:
        return len(self._base["feats"]) + len(self._pending)

    def append_tree(self, feat, thr_raw, leaf_value, gain, cover):
        self._pending.append((feat, thr_raw, leaf_value, gain, cover))

    def truncated(self, n_trees: int) -> "Booster":
        """Model truncated to the first n_trees (early-stopping cutoff);
        arrays are copied, not viewed."""
        b = Booster(self.depth, self.n_features, self.objective,
                    self.base_score, self.num_class,
                    self.feats[:n_trees].copy(), self.thr_raw[:n_trees].copy(),
                    self.leaf_values[:n_trees].copy(),
                    self.gains[:n_trees].copy(),
                    self.covers[:n_trees].copy(), best_iteration=n_trees,
                    device=self.device)
        b.fit_params = self.fit_params
        return b

    def merge(self, other: "Booster") -> "Booster":
        """Concatenate trees (parity: mergeBooster)."""
        assert self.depth == other.depth and self.num_class == other.num_class
        merged = Booster(
            self.depth, self.n_features, self.objective, self.base_score,
            self.num_class,
            np.concatenate([self.feats, other.feats]),
            np.concatenate([self.thr_raw, other.thr_raw]),
            np.concatenate([self.leaf_values, other.leaf_values]),
            np.concatenate([self.gains, other.gains]),
            np.concatenate([self.covers, other.covers]), device=self.device)
        merged.fit_params = self.fit_params
        return merged

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

    def raw_score_on_device(self, X, num_iteration: Optional[int] = None
                            ) -> torch.Tensor:
        """:meth:`raw_score` as a float32 tensor on the booster's device,
        (n,) or (n, K): the trees summed in order from zero, then
        ``base_score`` added."""
        T = self._tree_cap(num_iteration)
        if T == 0:
            n, K = X.shape[0], self.num_class
            return torch.full((n, K) if K > 1 else (n,), self.base_score,
                              dtype=torch.float32, device=self.device)
        f, t, lv = self._on_device(self.feats[:T], self.thr_raw[:T],
                                   self.leaf_values[:T])
        return map_rows(lambda xd: predict_trees(f, t, lv, xd, self.depth),
                        X, self.device) + self.base_score

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
        multiclass model gives (K, n, F+1)."""
        from .treeshap import shap_trees
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
        out = Booster(self.depth, self.n_features, self.objective,
                      self.base_score, self.num_class,
                      self.feats.copy(), self.thr_raw.copy(), new_lv,
                      self.gains.copy(), self.covers.copy(),
                      best_iteration=self.best_iteration, device=dev)
        out.fit_params = self.fit_params
        return out

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
        np.savez_compressed(buf, feats=self.feats, thr_raw=self.thr_raw,
                            leaf_values=self.leaf_values, gains=self.gains,
                            covers=self.covers)
        meta = {"depth": self.depth, "n_features": self.n_features,
                "objective": self.objective, "base_score": self.base_score,
                "num_class": self.num_class,
                "best_iteration": self.best_iteration,
                "arrays": base64.b64encode(buf.getvalue()).decode("ascii")}
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
        if "lin_coefs" in arrays:
            raise _leftover("a linear-tree model (linear_tree)", 19)
        if "cat_encoder" in meta:
            raise _leftover("a model with categorical features", 17)
        b = Booster(meta["depth"], meta["n_features"], meta["objective"],
                    meta["base_score"], meta["num_class"],
                    arrays["feats"], arrays["thr_raw"],
                    arrays["leaf_values"], arrays["gains"],
                    arrays["covers"], meta["best_iteration"], device=device)
        b.fit_params = meta.get("fit_params")
        return b
