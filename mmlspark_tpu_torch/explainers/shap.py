"""KernelSHAP explainers (counterpart of ``mmlspark_tpu/explainers/shap.py``).

Parity surface: ``KernelSHAPBase.transform`` = coalition sample → score →
weighted least squares (reference ``explainers/KernelSHAPBase.scala:43-94``,
sample-count logic ``:126-139``), variants ``TabularSHAP``/``VectorSHAP``/
``TextSHAP``/``ImageSHAP.scala:131``, sampler ``KernelSHAPSampler.scala``.

Output layout matches the reference: attribution vector = [base_value,
phi_1..phi_d] so sum(vector) ≈ f(x). Coalitions come from
``np.random.default_rng(seed)`` in the JAX package's order (bitwise its
masks); rows of one width are solved in one batch on the explainer's
device.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..core.dataframe import DataFrame, object_col
from ..core.params import ComplexParam, HasInputCol, HasInputCols, Param
from .base import dense_matrix, LocalExplainer, shapley_kernel_weights
from .lime import ImageExplainerParams
from .regression import batched_weighted_lstsq

__all__ = ["VectorSHAP", "TabularSHAP", "TextSHAP", "ImageSHAP"]


def _coalitions(m: int, d: int, rng: np.random.Generator) -> np.ndarray:
    """Binary coalition masks with the empty & full rows pinned first."""
    masks = rng.random((m, d)) > 0.5
    masks[0] = False
    if m > 1:
        masks[1] = True
    return masks


def _shap_solve(masks: np.ndarray, scores: np.ndarray,
                device=None) -> np.ndarray:
    """masks: (B, m, d) with rows 0/1 pinned to empty/full; scores: (B, m)
    → phis (B, d+1) incl. base value.

    The efficiency constraint sum(phi) = f(x) − base is enforced by
    eliminating the last feature (the SHAP-library formulation), keeping the
    weight range float32-friendly instead of using 1e6 constraint weights.
    """
    B, m, d = masks.shape
    base, fx = scores[:, 0], scores[:, 1]
    if d == 1:
        return np.stack([base, fx - base], axis=1)
    Z = masks.astype(np.float64)
    w = np.stack([shapley_kernel_weights(masks[b]) for b in range(B)])
    # substitute phi_d = (fx - base) - sum(phi_1..d-1)
    Zr = Z[:, :, :-1] - Z[:, :, -1:]
    yr = scores - base[:, None] - Z[:, :, -1] * (fx - base)[:, None]
    coefs, _ = batched_weighted_lstsq(Zr, yr, w, fit_intercept=False,
                                      device=device)
    phi_last = (fx - base) - coefs.sum(axis=1)
    return np.concatenate([base[:, None], coefs, phi_last[:, None]], axis=1)


class _SHAPParams(LocalExplainer):
    background_data = ComplexParam(default=None,
                                   doc="background frame for masked values")

    def _solve_rows(self, masks: List[np.ndarray], scores: np.ndarray
                    ) -> List[np.ndarray]:
        """Per-row masks (m, d_i) and scores (n, m) → phis, rows of one
        width solved in one batch."""
        out: List[np.ndarray] = [None] * len(masks)
        by_width: Dict[int, List[int]] = {}
        for i, mk in enumerate(masks):
            by_width.setdefault(mk.shape[1], []).append(i)
        for rows in by_width.values():
            phis = _shap_solve(np.stack([masks[i] for i in rows]),
                               scores[rows], device=self.device)
            for i, p in zip(rows, phis):
                out[i] = p
        return out


class VectorSHAP(_SHAPParams, HasInputCol):
    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="features")

    def _transform(self, df: DataFrame) -> DataFrame:
        col = self.get("input_col")
        X = dense_matrix(df[col])
        bg = self.get("background_data")
        bgX = X if bg is None else dense_matrix(bg[col])
        base = bgX.mean(axis=0)
        n, d = X.shape
        m = self.get("num_samples")
        rng = np.random.default_rng(self.get("seed"))
        masks = np.stack([_coalitions(m, d, rng) for _ in range(n)])
        samples = np.where(masks, X[:, None, :], base[None, None, :])
        scores = self._score_frame(DataFrame(
            {col: object_col(list(samples.reshape(n * m, d)))})).reshape(n, m)
        phis = _shap_solve(masks, scores, device=self.device)
        return df.with_column(self.get("output_col"), object_col(list(phis)))


class TabularSHAP(_SHAPParams, HasInputCols):
    def _transform(self, df: DataFrame) -> DataFrame:
        cols: List[str] = self.get("input_cols")
        X = np.stack([df[c].astype(np.float64) for c in cols], axis=1)
        bg = self.get("background_data")
        bgX = X if bg is None else np.stack(
            [bg[c].astype(np.float64) for c in cols], axis=1)
        base = bgX.mean(axis=0)
        n, d = X.shape
        m = self.get("num_samples")
        rng = np.random.default_rng(self.get("seed"))
        masks = np.stack([_coalitions(m, d, rng) for _ in range(n)])
        samples = np.where(masks, X[:, None, :], base[None, None, :])
        flat = samples.reshape(n * m, d)
        scores = self._score_frame(DataFrame(
            {c: flat[:, j] for j, c in enumerate(cols)})).reshape(n, m)
        phis = _shap_solve(masks, scores, device=self.device)
        return df.with_column(self.get("output_col"), object_col(list(phis)))


class TextSHAP(_SHAPParams, HasInputCol):
    tokens_col = Param(str, default="tokens", doc="emit token list here")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="text")

    def _transform(self, df: DataFrame) -> DataFrame:
        col = self.get("input_col")
        m = self.get("num_samples")
        rng = np.random.default_rng(self.get("seed"))
        n = len(df)
        token_lists = [str(t).split() for t in df[col]]

        texts, masks_per_row = [], []
        for toks in token_lists:
            masks = _coalitions(m, max(1, len(toks)), rng)
            for s in masks:
                texts.append(" ".join(t for t, keep in zip(toks, s) if keep))
            masks_per_row.append(masks)
        scores = self._score_frame(DataFrame({col: texts})).reshape(n, m)
        phis = self._solve_rows(masks_per_row, scores)
        return (df.with_column(self.get("output_col"), object_col(phis))
                  .with_column(self.get("tokens_col"),
                               object_col(token_lists)))


class ImageSHAP(ImageExplainerParams, _SHAPParams, HasInputCol):
    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="image")

    def _transform(self, df: DataFrame) -> DataFrame:
        m = self.get("num_samples")
        rng = np.random.default_rng(self.get("seed"))
        seg_maps, masks, scores = self._image_scores(
            df, lambda k: _coalitions(m, k, rng))
        t0 = time.perf_counter()
        return self._with_explanations(df, self._solve_rows(masks, scores),
                                       seg_maps, t0)
