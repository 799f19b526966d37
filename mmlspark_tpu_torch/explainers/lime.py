"""LIME explainers (counterpart of ``mmlspark_tpu/explainers/lime.py``).

Parity surface: ``LIMEBase.transform`` = sample → score-with-inner-model →
per-row lasso fit (reference ``explainers/LIMEBase.scala:67-115``), with
variants ``TabularLIME.scala:160``, ``VectorLIME``, ``TextLIME.scala:88``,
``ImageLIME.scala:133`` and the samplers in ``Sampler.scala``/``LIMESampler.scala``.

Samples come from ``np.random.default_rng(seed)`` in the JAX package's
order, so perturbations and masks are bitwise the JAX package's. Rows
whose surrogates have the same width are fitted in one batched lasso on
the explainer's device (the JAX package fits text and image rows one at a
time). ImageLIME segments its rows and builds their masked samples on the
explainer's device, and keeps the seconds of each step in
``phase_seconds``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..core.dataframe import DataFrame, object_col
from ..core.params import (ComplexParam, HasInputCol, HasInputCols, Param,
                           Params)
from .base import dense_matrix, LocalExplainer
from .regression import batched_lasso
from .superpixel import mask_samples, slic_superpixels

__all__ = ["VectorLIME", "TabularLIME", "TextLIME", "ImageLIME", "lime_states"]


class _LIMEParams(LocalExplainer):
    kernel_width = Param(float, default=0.75, doc="locality kernel width")
    regularization = Param(float, default=0.01, doc="lasso alpha")
    background_data = ComplexParam(default=None,
                                   doc="DataFrame of background rows "
                                       "(defaults to the explained frame)")

    def _lime_fit(self, states: np.ndarray, scores: np.ndarray,
                  dists: np.ndarray) -> np.ndarray:
        """states: (B, m, d) surrogate inputs; scores: (B, m); dists: (B, m)."""
        w = np.exp(-(dists ** 2) / (self.get("kernel_width") ** 2))
        coefs, _ = batched_lasso(states, scores, w,
                                 alpha=self.get("regularization"),
                                 device=self.device)
        return coefs

    def _fit_rows(self, states: List[np.ndarray], scores: np.ndarray
                  ) -> List[np.ndarray]:
        """Per-row binary states (m, d_i) and scores (n, m) → coefs, rows
        of one width fitted in one batch; the distance is the share of
        features switched off."""
        out: List[np.ndarray] = [None] * len(states)
        by_width: Dict[int, List[int]] = {}
        for i, s in enumerate(states):
            by_width.setdefault(s.shape[1], []).append(i)
        for rows in by_width.values():
            st = np.stack([states[i] for i in rows]).astype(np.float64)
            coefs = self._lime_fit(st, scores[rows], 1.0 - st.mean(axis=2))
            for i, c in zip(rows, coefs):
                out[i] = c
        return out


class VectorLIME(_LIMEParams, HasInputCol):
    """Explain a model consuming a dense vector column. Perturbations are
    gaussian around the row, scaled by background stds."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="features")

    def _transform(self, df: DataFrame) -> DataFrame:
        col = self.get("input_col")
        X = dense_matrix(df[col])
        bg = self.get("background_data")
        bgX = X if bg is None else dense_matrix(bg[col])
        sigma = bgX.std(axis=0) + 1e-12
        n, d = X.shape
        m = self.get("num_samples")
        rng = np.random.default_rng(self.get("seed"))
        noise = rng.normal(0, 1, (n, m, d))
        samples = X[:, None, :] + noise * sigma[None, None, :]
        scores = self._score_frame(DataFrame(
            {col: object_col(list(samples.reshape(n * m, d)))})).reshape(n, m)
        # standardized offsets are the surrogate inputs
        dists = np.sqrt((noise ** 2).mean(axis=2))
        coefs = self._lime_fit(noise, scores, dists)
        return df.with_column(self.get("output_col"),
                              object_col([c / sigma for c in coefs]))


class TabularLIME(_LIMEParams, HasInputCols):
    """Explain a model consuming plain numeric columns."""

    def _transform(self, df: DataFrame) -> DataFrame:
        cols: List[str] = self.get("input_cols")
        X = np.stack([df[c].astype(np.float64) for c in cols], axis=1)
        bg = self.get("background_data")
        bgX = X if bg is None else np.stack(
            [bg[c].astype(np.float64) for c in cols], axis=1)
        sigma = bgX.std(axis=0) + 1e-12
        n, d = X.shape
        m = self.get("num_samples")
        rng = np.random.default_rng(self.get("seed"))
        noise = rng.normal(0, 1, (n, m, d))
        samples = X[:, None, :] + noise * sigma[None, None, :]
        flat = samples.reshape(n * m, d)
        scores = self._score_frame(DataFrame(
            {c: flat[:, j] for j, c in enumerate(cols)})).reshape(n, m)
        dists = np.sqrt((noise ** 2).mean(axis=2))
        coefs = self._lime_fit(noise, scores, dists)
        return df.with_column(self.get("output_col"),
                              object_col([c / sigma for c in coefs]))


class TextLIME(_LIMEParams, HasInputCol):
    """Token-masking LIME for text models: surrogate features are
    keep/drop bits per token (reference ``TextLIME.scala:88``)."""

    tokens_col = Param(str, default="tokens", doc="emit the token list here")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="text")

    def _transform(self, df: DataFrame) -> DataFrame:
        col = self.get("input_col")
        m = self.get("num_samples")
        rng = np.random.default_rng(self.get("seed"))
        token_lists = [str(t).split() for t in df[col]]
        n = len(df)

        all_texts, all_states = [], []
        for toks in token_lists:
            states = lime_states(m, max(1, len(toks)), rng)
            for s in states:
                all_texts.append(" ".join(t for t, keep in zip(toks, s)
                                          if keep))
            all_states.append(states)

        scores = self._score_frame(DataFrame({col: all_texts})).reshape(n, m)
        coefs = self._fit_rows(all_states, scores)
        return (df.with_column(self.get("output_col"), object_col(coefs))
                  .with_column(self.get("tokens_col"),
                               object_col(token_lists)))


def lime_states(m: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """LIME's binary states over k features: each on with probability
    1/2, the first sample all on (the unperturbed row)."""
    states = rng.random((m, k)) > 0.5
    states[0] = True
    return states


def image_samples(images: List[np.ndarray], segments: List[np.ndarray],
                  states: List[np.ndarray], background: float, device):
    """The masked samples of every row, rows in order, built on
    ``device``: one (n · m, H, W, C) tensor when the images share a shape
    and dtype, else an object column of per-sample host arrays."""
    parts = [mask_samples(img, seg, st, background, device)
             for img, seg, st in zip(images, segments, states)]
    if len({(p.shape[1:], p.dtype) for p in parts}) == 1:
        return torch.cat(parts)
    return object_col([s for p in parts for s in p.cpu().numpy()])


class ImageExplainerParams(Params):
    """The superpixel params and sampling of ImageLIME and ImageSHAP: SLIC
    and the masked samples on the explainer's device, the samples handed
    to the model as a resident column (an object column of host arrays
    when the images differ in shape). ``phase_seconds`` holds the last
    transform's ``segment`` (SLIC), ``sample`` (the draws and the masks),
    the inner model's ``score`` and the surrogate ``solve``, by the host's
    clock."""

    cell_size = Param(int, default=16, doc="superpixel target size")
    modifier = Param(float, default=10.0, doc="SLIC color/space balance")
    superpixel_col = Param(str, default="superpixels",
                           doc="emit the (H, W) segment map here")
    background_value = Param(float, default=0.0, doc="masked-pixel fill")

    def _image_scores(self, df: DataFrame,
                      draw: Callable[[int], np.ndarray]):
        """Segment every row, draw its states (``draw(k)``, rows in order),
        score all masked samples in one ``model.transform``: (segments,
        states, scores (n, m))."""
        col = self.get("input_col")
        t0 = time.perf_counter()
        images = [np.asarray(v) for v in df[col]]
        seg_maps = [slic_superpixels(img, self.get("cell_size"),
                                     self.get("modifier"), device=self.device)
                    for img in images]
        t1 = time.perf_counter()
        states = [draw(int(segs.max()) + 1) for segs in seg_maps]
        samples = image_samples(images, seg_maps, states,
                                self.get("background_value"), self.device)
        frame = (DataFrame({}).with_device_column(col, samples)
                 if isinstance(samples, torch.Tensor)
                 else DataFrame({col: samples}))
        t2 = time.perf_counter()
        scores = self._score_frame(frame).reshape(len(df),
                                                  self.get("num_samples"))
        self.phase_seconds = {"segment": t1 - t0, "sample": t2 - t1,
                              "score": time.perf_counter() - t2}
        return seg_maps, states, scores

    def _with_explanations(self, df, explanations, seg_maps, t0):
        self.phase_seconds["solve"] = time.perf_counter() - t0
        return (df.with_column(self.get("output_col"),
                               object_col(explanations))
                  .with_column(self.get("superpixel_col"),
                               object_col(seg_maps)))


class ImageLIME(ImageExplainerParams, _LIMEParams, HasInputCol):
    """Superpixel-masking LIME for image models
    (reference ``ImageLIME.scala:133`` + ``Superpixel.scala``)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="image")

    def _transform(self, df: DataFrame) -> DataFrame:
        m = self.get("num_samples")
        rng = np.random.default_rng(self.get("seed"))
        seg_maps, states, scores = self._image_scores(
            df, lambda k: lime_states(m, k, rng))
        t0 = time.perf_counter()
        return self._with_explanations(df, self._fit_rows(states, scores),
                                       seg_maps, t0)
