"""Port parity: the explainers (``mmlspark_tpu_torch/explainers/``) against
the JAX package's, on the CPU.

* SLIC labels, the masked samples, the coalitions and every perturbation a
  model is fed: **bitwise** (the same float64 numpy, the same
  ``np.random.default_rng(seed)`` draws in the same order).
* The batched solves (the port's batched torch against the JAX package's
  ``vmap``, both float32): ``SOLVE`` — within 1e-4 of the largest |coef|
  (float32 normal equations and 200 ISTA steps in another summation
  order, on grams of condition ≲ 10^3 at these sizes).
* Every LIME / SHAP / ICE class over the same model: explanations within
  ``SOLVE``; ICE curves (no solve) within 1e-12 of each other. SHAP's
  efficiency identity Σφ = f(x) holds in both within 1e-6 of Σ|φ| (the
  float32 sum of the solved coefficients, as the JAX package sums them).
* ImageLIME / ImageSHAP over each package's ``ImageFeaturizer`` on the
  tiny ResNet of ``tests/test_torch_onnx_model.py`` (32×32 images, 16
  superpixels, 64 samples): scores within its ``F32`` (rtol/atol 1e-5),
  explanations within ``SOLVE`` relative to |f(x) − base| for SHAP and to
  the largest |coef| for LIME.
"""

import numpy as np
import pytest
import torch

import mmlspark_tpu.explainers as J
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.core.dataframe import object_col as jobject_col
from mmlspark_tpu.core.pipeline import Transformer as JTransformer
from mmlspark_tpu.explainers import shap as jshap
from mmlspark_tpu.models.featurizer import ImageFeaturizer as JFeaturizer
from mmlspark_tpu.models.onnx_model import ONNXModel as JONNXModel
import mmlspark_tpu_torch.explainers as P
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.core.dataframe import object_col
from mmlspark_tpu_torch.core.pipeline import Transformer as PTransformer
from mmlspark_tpu_torch.core.residency import (configure_residency,
                                               get_residency_manager,
                                               residency_stats)
from mmlspark_tpu_torch.explainers import shap as pshap
from mmlspark_tpu_torch.explainers.superpixel import mask_samples
from mmlspark_tpu_torch.models.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.onnx_model import ONNXModel
from mmlspark_tpu_torch.models.zoo import resnet as pres
from mmlspark_tpu_torch.observability import reset_all

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

SOLVE = 1e-4
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_slate():
    get_residency_manager().spill_all()
    configure_residency(0)
    reset_all()


def _close(got, want, rel=SOLVE, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _efficient(phis, fx):
    """Σφ (base included) = f(x), up to the float32 sum of the solved
    coefficients: within 1e-6 of Σ|φ| a row."""
    phis = np.atleast_2d(np.asarray(phis, np.float64))
    gap = np.abs(phis.sum(axis=1) - np.atleast_1d(fx))
    assert (gap <= 1e-6 * np.abs(phis).sum(axis=1)).all(), gap


def _stack(col):
    return np.stack([np.asarray(v) for v in col])


# ---------------------------------------------------------------------------
# scoring stubs, the same function in both packages, recording their feeds


def _stubs(score):
    """A JAX-package and a port Transformer computing ``score(df)`` into
    ``prediction``; each keeps the frames it was given."""
    def make(base):
        class Stub(base):
            seen = []

            def _transform(self, df):
                Stub.seen.append(df)
                return df.with_column("prediction", score(df))
        return Stub()
    return {"jax": make(JTransformer), "port": make(PTransformer)}


def _linear_score(df):
    X = np.stack([np.asarray(v, dtype=np.float64) for v in df["features"]])
    return 3.0 * X[:, 0] - 2.0 * X[:, 1] + 0.5 * X[:, 0] * X[:, 2]


def _tabular_score(df):
    return 2.0 * df["a"].astype(float) - df["b"].astype(float) + \
        0.3 * df["a"].astype(float) * df["c"].astype(float)


def _text_score(df):
    return np.asarray([float("good" in str(t).split())
                       + 0.5 * float("cast" in str(t).split())
                       for t in df["text"]])


def _image_score(df):
    return np.asarray([float(np.asarray(v, np.float64)[:16, :16].mean())
                       + 0.2 * float(np.asarray(v, np.float64)[16:, 8:].std())
                       for v in df["image"]])


def _run(cls_name, stubs, frames, **kw):
    out = {}
    for name, pkg in (("jax", J), ("port", P)):
        extra = {} if name == "jax" else {"device": "cpu"}
        ex = getattr(pkg, cls_name)(model=stubs[name],
                                    target_col="prediction", **kw, **extra)
        out[name] = ex.transform(frames[name])
    return out


def _feeds_equal(stubs, col):
    """Every frame each package's model saw: the same samples, bitwise."""
    js, ps = type(stubs["jax"]).seen, type(stubs["port"]).seen
    assert len(js) == len(ps) >= 1
    for jdf, pdf in zip(js, ps):
        assert len(jdf) == len(pdf)
        for c in col:
            j, p = jdf[c], pdf[c]
            if j.dtype.kind in "OU" and isinstance(j[0], str):
                assert [str(v) for v in p] == [str(v) for v in j], c
                continue
            assert len(p) == len(j)
            for pv, jv in zip(p, j):
                pv, jv = np.asarray(pv), np.asarray(jv)
                assert pv.dtype == jv.dtype and np.array_equal(pv, jv), c


def _vector_frames(n=6, d=4, seed=0):
    X = np.random.default_rng(seed).normal(0, 1, (n, d))
    return {"jax": JDataFrame({"features": jobject_col(list(X))}),
            "port": DataFrame({"features": object_col(list(X))})}, X


@pytest.mark.parametrize("cls_name", ["VectorLIME", "VectorSHAP"])
def test_vector_explainers_equal_jax(cls_name):
    frames, X = _vector_frames()
    stubs = _stubs(_linear_score)
    out = _run(cls_name, stubs, frames, num_samples=96, seed=3)
    _feeds_equal(stubs, ["features"])
    got, want = _stack(out["port"]["explanation"]), \
        _stack(out["jax"]["explanation"])
    _close(got, want)
    if cls_name == "VectorSHAP":
        _efficient(got, _linear_score(frames["port"]))
        _efficient(want, _linear_score(frames["port"]))


@pytest.mark.parametrize("cls_name", ["TabularLIME", "TabularSHAP"])
def test_tabular_explainers_equal_jax(cls_name):
    rng = np.random.default_rng(1)
    cols = {c: rng.normal(0, 1, 6) for c in "abc"}
    frames = {"jax": JDataFrame(dict(cols)), "port": DataFrame(dict(cols))}
    bg = {"jax": JDataFrame({c: v[:3] for c, v in cols.items()}),
          "port": DataFrame({c: v[:3] for c, v in cols.items()})}
    stubs = _stubs(_tabular_score)
    out = {}
    for name, pkg in (("jax", J), ("port", P)):
        extra = {} if name == "jax" else {"device": "cpu"}
        out[name] = getattr(pkg, cls_name)(
            model=stubs[name], target_col="prediction",
            input_cols=["a", "b", "c"], num_samples=80,
            background_data=bg[name], **extra).transform(frames[name])
    _feeds_equal(stubs, ["a", "b", "c"])
    _close(_stack(out["port"]["explanation"]),
           _stack(out["jax"]["explanation"]))


@pytest.mark.parametrize("cls_name", ["TextLIME", "TextSHAP"])
def test_text_explainers_equal_jax(cls_name):
    texts = ["good plot strong cast", "dull film bad cast",
             "good good cast", "", "one"]
    frames = {"jax": JDataFrame({"text": texts}),
              "port": DataFrame({"text": texts})}
    stubs = _stubs(_text_score)
    out = _run(cls_name, stubs, frames, num_samples=48)
    _feeds_equal(stubs, ["text"])
    assert [list(t) for t in out["port"]["tokens"]] == \
        [list(t) for t in out["jax"]["tokens"]]
    for g, w in zip(out["port"]["explanation"], out["jax"]["explanation"]):
        _close(g, w, scale=max(1.0, np.abs(w).max()))


def _image_frames(n=2, h=32, w=32, seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    imgs = [rng.random((h, w + 8 * i * ragged, 3)).astype(np.float32)
            for i in range(n)]
    return {"jax": JDataFrame({"image": jobject_col(imgs)}),
            "port": DataFrame({"image": object_col(imgs)})}, imgs


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("cls_name", ["ImageLIME", "ImageSHAP"])
def test_image_explainers_equal_jax(cls_name, ragged):
    """Same-shape rows reach the model as one resident column, rows of
    two shapes as an object column of host arrays."""
    frames, imgs = _image_frames(ragged=ragged)
    stubs = _stubs(_image_score)
    out = _run(cls_name, stubs, frames, num_samples=64, cell_size=8,
               background_value=0.25)
    _feeds_equal(stubs, ["image"])
    for g, w in zip(out["port"]["superpixels"], out["jax"]["superpixels"]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(out["port"]["explanation"], out["jax"]["explanation"]):
        _close(g, w)


def test_ice_equals_jax():
    rng = np.random.default_rng(2)
    cols = {"a": rng.normal(0, 1, 5), "b": rng.normal(0, 1, 5),
            "c": np.array(["x", "y", "x", "z", "y"], dtype=object)}
    frames = {"jax": JDataFrame(dict(cols)), "port": DataFrame(dict(cols))}

    def score(df):
        return 2.0 * df["a"].astype(float) - df["b"].astype(float) + \
            np.asarray([{"x": 0.0, "y": 1.0, "z": -1.0}[v] for v in df["c"]])
    for kind in ("individual", "average"):
        stubs = _stubs(score)
        out = _run("ICETransformer", stubs, frames, numeric_features=["a"],
                   categorical_features=["c"], num_splits=7, kind=kind)
        for feat in ("a", "c"):
            col = f"{feat}_dependence"
            np.testing.assert_allclose(_stack(out["port"][col]),
                                       _stack(out["jax"][col]), rtol=1e-12,
                                       atol=1e-12)
            assert out["port"].column_metadata(col) == \
                out["jax"].column_metadata(col)


# ---------------------------------------------------------------------------
# SLIC, masks, coalitions, weights, solves


@pytest.mark.parametrize("shape,cell,mod", [
    ((32, 32, 3), 8, 10.0), ((40, 24, 3), 16, 10.0), ((5, 5, 3), 16, 10.0),
    ((64, 48), 8, 5.0), ((48, 48, 4), 12, 20.0), ((224, 224, 3), 16, 10.0)])
def test_slic_bitwise(shape, cell, mod):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    want = J.slic_superpixels(img, cell, mod)
    got = P.slic_superpixels(img, cell, mod, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["smooth", "halves", "float", "flat"])
def test_slic_bitwise_on_ties_and_smooth_images(kind):
    """Smooth ramps, two flat halves and a constant image put many
    distances in exact ties: the first minimum wins on both sides."""
    y, x = np.mgrid[0:48, 0:64]
    img = {"smooth": np.stack([x * 3, y * 4, (x + y) * 2], -1).astype(
               np.uint8),
           "halves": np.where(x[..., None] < 32, 0.0, 1.0) * np.ones(3),
           "float": np.random.default_rng(0).random((20, 30, 3)),
           "flat": np.full((24, 24, 3), 7, np.uint8)}[kind]
    np.testing.assert_array_equal(P.slic_superpixels(img, 8, device="cpu"),
                                  J.slic_superpixels(img, 8))


def test_masks_and_coalitions_bitwise():
    rng = np.random.default_rng(4)
    for img in (rng.integers(0, 256, (12, 10, 3), dtype=np.uint8),
                rng.random((12, 10)).astype(np.float32)):
        segs = J.slic_superpixels(img, 4)
        k = int(segs.max()) + 1
        states = rng.random((7, k)) > 0.5
        for bg in (0.0, 0.5, 77.0):
            batch = mask_samples(img, segs, states, bg, device="cpu").numpy()
            for s, b in zip(states, batch):
                want = J.mask_image(img, segs, s, bg)
                got = P.mask_image(img, segs, s, bg)
                assert got.dtype == b.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(b, want)
    for m, d in ((1, 3), (2, 1), (64, 17)):
        np.testing.assert_array_equal(
            pshap._coalitions(m, d, np.random.default_rng(9)),
            jshap._coalitions(m, d, np.random.default_rng(9)))
    masks = pshap._coalitions(40, 6, np.random.default_rng(1))
    np.testing.assert_array_equal(P.shapley_kernel_weights(masks),
                                  J.shapley_kernel_weights(masks))


def test_shapley_weights_at_196_superpixels():
    """224/16 squared superpixels: the weights are the exact Python-int
    formula, normalized; the JAX package's copy overflows (a numpy int64
    size times ``comb(196, s)``) and raises."""
    from math import comb
    masks = pshap._coalitions(256, 196, np.random.default_rng(2))
    got = P.shapley_kernel_weights(masks)
    sizes = masks.sum(axis=1).tolist()
    raw = np.asarray([0.0 if s in (0, 196) else
                      195 / (comb(196, s) * s * (196 - s)) for s in sizes])
    np.testing.assert_array_equal(got, raw / raw.max())
    assert got.max() == 1.0 and (got[2:] > 0).all()
    with pytest.raises(OverflowError):
        J.shapley_kernel_weights(masks)


@pytest.mark.parametrize("B,m,d", [(3, 50, 4), (8, 256, 16), (2, 40, 1)])
def test_batched_solves_equal_jax(B, m, d):
    rng = np.random.default_rng(B * m + d)
    X = rng.normal(0, 1, (B, m, d))
    y = X @ rng.normal(0, 1, d) + rng.normal(0, 0.1, (B, m)) + 0.7
    w = rng.random((B, m))
    for fit in (True, False):
        gc, gi = P.batched_weighted_lstsq(X, y, w, fit, device="cpu")
        wc, wi = J.batched_weighted_lstsq(X, y, w, fit)
        _close(gc, wc)
        _close(gi, wi, scale=max(1.0, np.abs(wi).max()))
    for alpha, steps in ((0.01, 200), (1e-4, 50)):
        gc, gi = P.batched_lasso(X, y, w, alpha, steps, device="cpu")
        wc, wi = J.batched_lasso(X, y, w, alpha, steps)
        _close(gc, wc)
        _close(gi, wi)
    # the solves take tensors too
    tc, _ = P.batched_lasso(torch.from_numpy(X), torch.from_numpy(y),
                            torch.from_numpy(w), device="cpu")
    np.testing.assert_array_equal(tc, P.batched_lasso(X, y, w,
                                                      device="cpu")[0])


def test_shap_solve_equals_jax_and_keeps_efficiency():
    rng = np.random.default_rng(5)
    masks = np.stack([pshap._coalitions(128, 12, rng) for _ in range(3)])
    truth = rng.normal(0, 1, (3, 12))
    scores = 0.4 + (masks * truth[:, None, :]).sum(axis=2) + \
        rng.normal(0, 0.01, (3, 128))
    got = pshap._shap_solve(masks, scores, device="cpu")
    want = jshap._shap_solve(masks, scores)
    gap = np.abs(scores[:, 1] - scores[:, 0]).max()
    _close(got, want, scale=gap)
    _efficient(got, scores[:, 1])
    _efficient(want, scores[:, 1])


def test_explainers_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ImageSHAP()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.batched_lasso(np.zeros((1, 2, 1)), np.zeros((1, 2)),
                        np.ones((1, 2)))


def test_superpixel_transformer_equals_jax():
    frames, imgs = _image_frames(3, seed=6)
    cells = list(imgs) + [None]
    got = P.SuperpixelTransformer(cell_size=8, device="cpu").transform(
        DataFrame({"image": object_col(cells)}))["superpixels"]
    want = J.SuperpixelTransformer(cell_size=8).transform(
        JDataFrame({"image": jobject_col(cells)}))["superpixels"]
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# ImageLIME / ImageSHAP over ImageFeaturizer on the tiny ResNet


@pytest.fixture(scope="module")
def model_bytes():
    return pres.export_resnet_onnx(
        pres.ResNetConfig([1, 1], num_classes=7, width=8), seed=0,
        input_size=32)


@pytest.mark.parametrize("cls_name", ["ImageLIME", "ImageSHAP"])
def test_image_explainers_over_the_featurizer_equal_jax(model_bytes,
                                                        cls_name):
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            for _ in range(2)]
    kw = dict(input_size=32, cut_output_layers=0, output_col="logits")
    # the JAX featurizer scores in one batch: its runner on the CPU backend
    # can recycle a staging slab an earlier batch's computation still reads
    jfeat = JFeaturizer(JONNXModel(model_bytes), mini_batch_size=256, **kw)
    pfeat = ImageFeaturizer(ONNXModel(model_bytes, device="cpu"),
                            mini_batch_size=16, **kw)
    ex = dict(target_col="logits", target_classes=[2], num_samples=64,
              cell_size=8)
    want = getattr(J, cls_name)(model=jfeat, **ex).transform(
        JDataFrame({"image": jobject_col(imgs)}))
    reset_all()
    got = getattr(P, cls_name)(model=pfeat, device="cpu", **ex).transform(
        DataFrame({"image": object_col(imgs)}))
    # 128 masked images built on the explainer's device, handed over as a
    # resident column: no ingest, eight batches of 16
    assert residency_stats()["h2d_ops"]["ingest"] == 0
    snap = pfeat.get("onnx_model").stage_counters.snapshot()
    assert snap["dispatch"]["calls"] == 8 and snap["h2d"]["bytes"] == 0
    # the model's f(x): row 0 of each image's samples is the whole image
    fx_p = pfeat.transform(DataFrame({"image": object_col(imgs)}))["logits"]
    fx_j = np.asarray(jfeat.transform(
        JDataFrame({"image": jobject_col(imgs)}))["logits"])
    np.testing.assert_allclose(fx_p, fx_j, **F32)
    for i in range(2):
        g, w = got["explanation"][i], want["explanation"][i]
        np.testing.assert_array_equal(got["superpixels"][i],
                                      want["superpixels"][i])
        if cls_name == "ImageSHAP":
            gap = abs(float(fx_j[i, 2]) - float(w[0]))
            _close(g, w, scale=gap)
            _efficient(g, fx_p[i, 2])
        else:
            _close(g, w)
