"""Local explainer base (counterpart of ``mmlspark_tpu/explainers/base.py``).

Parity surface: ``LocalExplainer`` (reference
``explainers/LocalExplainer.scala:16-72``) — shared plumbing for LIME/SHAP:
wrap an inner model, score perturbed samples through it, and emit one
attribution vector per explained row.

All rows' perturbations are concatenated into ONE frame and scored in ONE
``model.transform`` call (the reference scores per row), so the inner
model sees a large batch and its runner feeds the device in batches of its
``mini_batch_size``; the surrogate fits then run as batched solves on the
explainer's device (:mod:`.regression`). ``device`` is a constructor (and
``load``) keyword: ``None`` is the CUDA card; the inner model keeps its
own device.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, Param
from ..core.pipeline import Transformer
from ..utils.device import OnDevice

__all__ = ["LocalExplainer", "shapley_kernel_weights", "dense_row",
           "dense_matrix"]

try:                            # guarded like models/gbdt/binning.py
    import scipy.sparse as _sp
except Exception:               # pragma: no cover - scipy is in the image
    _sp = None


def dense_row(v) -> np.ndarray:
    """One features-column row → flat float64 vector; scipy sparse rows
    densify here (explainers perturb in dense space — a row's worth at a
    time, so this never materializes the full sparse matrix)."""
    if _sp is not None and _sp.issparse(v):
        return v.toarray().astype(np.float64).ravel()
    return np.asarray(v, dtype=np.float64).ravel()


def dense_matrix(col) -> np.ndarray:
    """A features column (dense or sparse rows) → (n, d) float64 matrix."""
    return np.stack([dense_row(v) for v in col])


class LocalExplainer(OnDevice, Transformer):
    model = ComplexParam(default=None, doc="inner model to explain")
    target_col = Param(str, default="probability",
                       doc="model output column to explain")
    target_classes = Param((list, int), default=[1],
                           doc="class indices summed into the scalar target")
    output_col = Param(str, default="explanation",
                       doc="per-row attribution vector column")
    num_samples = Param(int, default=256, doc="perturbations per row")
    seed = Param(int, default=0, doc="sampling seed")

    def _score_frame(self, samples_df: DataFrame) -> np.ndarray:
        """Run the inner model over a frame of perturbed samples; reduce the
        target column to one scalar per row."""
        out = self.get("model").transform(samples_df)
        col = out[self.get("target_col")]
        targets = self.get("target_classes")
        if col.dtype == object:
            vals = np.stack([np.asarray(v, dtype=np.float64).ravel()
                             for v in col])
        else:
            vals = np.asarray(col, dtype=np.float64)
            if vals.ndim == 1:
                return vals  # already one scalar per row
            vals = vals.reshape(len(col), -1)  # dense (n, classes) column
        bad = [t for t in targets if t >= vals.shape[1]]
        if bad:
            raise ValueError(
                f"target_classes {bad} out of range for "
                f"{self.get('target_col')!r} vectors of length "
                f"{vals.shape[1]}")
        return vals[:, targets].sum(axis=1)


def shapley_kernel_weights(masks: np.ndarray,
                           pinned_weight: float = 0.0) -> np.ndarray:
    """KernelSHAP weights for binary coalition masks (m, d)
    (reference ``KernelSHAPBase.scala:43-94`` sampling weights).

    Empty/full coalitions get ``pinned_weight``: the solver handles the
    f(empty)=base and f(full)=fx constraints by elimination, not by the
    huge-weight trick (whose 1e6..1e-9 dynamic range is unsolvable in the
    float32 the device math runs in). Weights are normalized to max 1.

    Sizes are Python ints: ``comb(d, s)`` passes 2^63 from d = 67 on, and a
    numpy int64 ``s`` in the product overflows there (the JAX package's
    copy raises ``OverflowError`` at 196 superpixels, 224/16 squared).
    """
    from math import comb
    d = masks.shape[1]
    sizes = masks.sum(axis=1).astype(int).tolist()
    w = np.empty(len(masks), dtype=np.float64)
    for i, s in enumerate(sizes):
        if s == 0 or s == d:
            w[i] = pinned_weight
        else:
            w[i] = (d - 1) / (comb(d, s) * s * (d - s))
    peak = w.max()
    return w / peak if peak > 0 else w
