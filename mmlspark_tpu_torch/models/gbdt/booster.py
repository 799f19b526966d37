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

Left out: TreeSHAP, ``refit``, ``trees_to_dataframe``, linear leaves and
categorical encoders (a model string that carries either of the last
two raises ``NotImplementedError``).
"""

from __future__ import annotations

import base64
import io
import json
from typing import List, Optional

import numpy as np
import torch

from ...utils.device import resolve_device
from .trees import apply_chunked_dense, predict_leaf_indices, \
    predict_trees_any

__all__ = ["Booster"]


def _leftover(what: str, item: Optional[int] = None) -> NotImplementedError:
    """The error of a mode outside the port, naming its ROADMAP.md item
    (§1's queue number, where it has one)."""
    where = f", queue item {item}" if item else ""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, slice-3 leftovers{where})")


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
    # JAX package
    @staticmethod
    def _x_eff(X):
        """Dense X as float32; scipy-sparse X passes through (prediction
        densifies it in bounded chunks)."""
        from .binning import is_sparse
        if is_sparse(X):
            return X
        return np.asarray(X, dtype=np.float32)

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

    def raw_score(self, X, num_iteration: Optional[int] = None) -> np.ndarray:
        X = self._x_eff(X)
        T = self._tree_cap(num_iteration)
        if T == 0:
            shape = (X.shape[0], self.num_class) if self.num_class > 1 \
                else (X.shape[0],)
            return np.full(shape, self.base_score, dtype=np.float32)
        out = predict_trees_any(self.feats[:T], self.thr_raw[:T],
                                self.leaf_values[:T], X, depth=self.depth,
                                device=self.device)
        return np.asarray(out) + self.base_score

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

    def predict_leaf(self, X) -> np.ndarray:
        X = self._x_eff(X)
        f, t = (torch.as_tensor(a).to(self.device)
                for a in (self.feats, self.thr_raw))
        return apply_chunked_dense(
            lambda xd: predict_leaf_indices(
                f, t, torch.from_numpy(xd).to(self.device),
                depth=self.depth).cpu().numpy(),
            X, empty_shape=(0, self.num_trees), empty_dtype=np.int32)

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
