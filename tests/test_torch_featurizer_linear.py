"""Port parity: ``ImageFeaturizer`` (``mmlspark_tpu_torch/models/
featurizer.py``), the linear learners (``models/linear.py``) and
``TorchModel`` (``models/torch_model.py``) against the JAX package's, on
the CPU.

ImageFeaturizer runs the tiny ResNet of ``tests/test_torch_onnx_model.py``
(``ResNetConfig([1, 1], num_classes=7, width=8)``, 32×32 input). Images
already at 32×32 go through both packages unresized: features
(``cut_output_layers=1``) and logits (0) within ``F32`` (rtol 1e-5, atol
1e-5: float32 sum order), the tolerance that file states; bf16 within
its ``BF16`` (2^-7). Images of other sizes are resized by the port's one
resize, which is up to a level off the JAX package's cv2 resize: the JAX
featurizer is then fed the port's resized pixels, and held to ``F32``.

The linear runners start from the SAME initial params (the JAX package
draws W from ``jax.random``, the port from a ``torch.Generator``) and are
held after ``steps`` Adam steps within ``LIN`` (rtol 1e-5, atol 1e-5:
float32 reductions in another order, W of order 0.1-1). ``TorchModel`` is
held to ``JaxModel`` on the same weights within ``F32`` (bf16: ``BF16``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.core.dataframe import object_col as jobject_col
from mmlspark_tpu.image import make_image as jmake_image
from mmlspark_tpu.models import linear as jlinear
from mmlspark_tpu.models.featurizer import ImageFeaturizer as JFeaturizer
from mmlspark_tpu.models.jax_model import JaxModel
from mmlspark_tpu.models.onnx_model import ONNXModel as JONNXModel
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.core.dataframe import object_col
from mmlspark_tpu_torch.core.residency import (configure_residency,
                                               get_residency_manager,
                                               residency_stats)
from mmlspark_tpu_torch.image.unroll import _resize
from mmlspark_tpu_torch.models import linear as plinear
from mmlspark_tpu_torch.models.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.onnx_model import ONNXModel
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.zoo import resnet as pres
from mmlspark_tpu_torch.observability import reset_all

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
LIN = dict(rtol=1e-5, atol=1e-5)
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


@pytest.fixture(autouse=True)
def _clean_slate():
    get_residency_manager().spill_all()
    configure_residency(0)
    reset_all()


@pytest.fixture(scope="module")
def model_bytes():
    return pres.export_resnet_onnx(
        pres.ResNetConfig([1, 1], num_classes=7, width=8), seed=0,
        input_size=32)


def _images(n, h=32, w=32, seed=0):
    """Structured uint8 BGR images (a colour, a ramp, noise per row), so
    the random network tells the rows apart."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 1, 1, 3))
    ramp = np.linspace(0, 1, w)[None, None, :, None] * \
        rng.integers(-128, 128, (n, 1, 1, 3))
    return np.clip(base + ramp + rng.normal(0, 20, (n, h, w, 3)), 0,
                   255).astype(np.uint8)


def _kw(**extra):
    return dict(input_size=32, mini_batch_size=4, mean=MEAN, std=STD,
                **extra)


def _jkw(**extra):
    """The JAX featurizer's params: one batch for the whole frame. Its
    runner on the CPU backend returns a staging slab to the pool while the
    computation that aliases it may still be reading it, so a second batch
    can overwrite the first one's pixels (the port holds its slab until
    the copy has landed)."""
    return dict(_kw(**extra), mini_batch_size=256)


def _pair(model_bytes, cells, dtype="float32", **kw):
    """(JAX output column, port output column, port featurizer, port
    frame out) for the same cells."""
    j = JFeaturizer(JONNXModel(model_bytes, compute_dtype=dtype),
                    **_jkw(**kw))
    p = ImageFeaturizer(ONNXModel(model_bytes, device="cpu",
                                  compute_dtype=dtype), **_kw(**kw))
    want = j.transform(JDataFrame({"image": jobject_col(cells),
                                   "rowid": np.arange(len(cells))}))
    got = p.transform(DataFrame({"image": object_col(cells),
                                 "rowid": np.arange(len(cells))}))
    return want, got, p


@pytest.mark.parametrize("cut,width", [(1, 64), (0, 7)])
@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_featurizer_equals_jax(model_bytes, cut, width, order):
    X = _images(9)
    cells = [jmake_image(X[i], origin=f"i{i}") for i in range(5)] + \
        [X[i] for i in range(5, 9)]
    want, got, _ = _pair(model_bytes, cells, cut_output_layers=cut,
                         channel_order=order)
    w, g = np.asarray(want["features"]), got["features"]
    assert g.shape == (9, width) and g.dtype == np.float32
    np.testing.assert_allclose(g, w, **F32)
    assert np.abs(g).max() > 100 * F32["atol"]


def test_featurizer_bf16_equals_jax(model_bytes):
    want, got, _ = _pair(model_bytes, list(_images(6, seed=2)), "bfloat16",
                         cut_output_layers=0)
    np.testing.assert_allclose(got["features"],
                               np.asarray(want["features"], np.float32),
                               **BF16)


def test_featurizer_resizes_on_the_device_in_row_order(model_bytes):
    """Rows of three shapes (one gray) keep their order; each shape is one
    counted ingest of its raw uint8 bytes, and the inner model's runner
    moves nothing. The JAX featurizer fed the port's resized pixels gives
    the same features."""
    a, b = _images(3, 40, 48, seed=3), _images(2, 20, 24, seed=4)
    g = _images(2, 32, 36, seed=5)[..., 0]
    cells = [a[0], b[0], g[0], a[1], b[1], a[2], g[1]]
    p = ImageFeaturizer(ONNXModel(model_bytes, device="cpu"), **_kw())
    reset_all()
    got = p.transform(DataFrame({"image": object_col(cells)}))["features"]
    s = residency_stats()
    assert s["h2d_ops"]["ingest"] == 3
    assert s["h2d_bytes"]["ingest"] == a.nbytes + b.nbytes + g.nbytes
    inner_h2d = p.get("onnx_model").stage_counters.snapshot()
    assert inner_h2d["h2d"]["bytes"] == 0
    resized = [_resize(c, 32, 32) for c in cells]
    resized = [np.repeat(r, 3, axis=-1) if r.shape[-1] == 1 else r
               for r in resized]
    want = JFeaturizer(JONNXModel(model_bytes), **_jkw()).transform(
        JDataFrame({"image": jobject_col(resized)}))["features"]
    np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_featurizer_batches_through_the_runner(model_bytes):
    """A dense uint8 column (the explainers' masked samples) is one
    ingest, then ceil(n / mini_batch_size) dispatches, each a padded batch
    sliced from the resident column; rows as an object column give the
    same features."""
    X = _images(11, seed=6)
    p = ImageFeaturizer(ONNXModel(model_bytes, device="cpu"), **_kw())
    reset_all()
    dense = p.transform(DataFrame({"image": X}))["features"]
    assert residency_stats()["h2d_ops"]["ingest"] == 1
    snap = p.get("onnx_model").stage_counters.snapshot()
    assert snap["dispatch"]["calls"] == 3
    assert snap["pad"]["calls"] == 3 and snap["h2d"]["bytes"] == 0
    rows = p.transform(DataFrame({"image": object_col(list(X))}))["features"]
    np.testing.assert_array_equal(dense, rows)


def test_featurizer_drop_na_equals_jax(model_bytes):
    X = _images(2, seed=7)
    cells = [jmake_image(X[0]), None, b"garbagebytes", X[1]]
    want, got, _ = _pair(model_bytes, cells)
    assert list(got["rowid"]) == list(want["rowid"]) == [0, 3]
    np.testing.assert_allclose(got["features"],
                               np.asarray(want["features"]), **F32)
    p = ImageFeaturizer(ONNXModel(model_bytes, device="cpu"), drop_na=False,
                        **_kw())
    with pytest.raises(ValueError, match="drop_na"):
        p.transform(DataFrame({"image": object_col(cells)}))
    empty = ImageFeaturizer(ONNXModel(model_bytes, device="cpu"), **_kw())
    assert len(empty.transform(DataFrame({"image": object_col([None])}))) == 0


def test_featurizer_from_bytes_save_load(model_bytes, tmp_path):
    X = _images(3, seed=8)
    f = ImageFeaturizer(model_bytes, device="cpu", **_kw())
    first = f.transform(DataFrame({"image": X}))["features"]
    f.save(str(tmp_path / "feat"))
    back = ImageFeaturizer.load(str(tmp_path / "feat"), device="cpu")
    np.testing.assert_array_equal(
        back.transform(DataFrame({"image": X}))["features"], first)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ImageFeaturizer(model_bytes)


# ---------------------------------------------------------------------------
# linear learners


def _linear_data(kind, n=120, d=6, k=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = rng.integers(0, k, n) if kind == "logistic" else \
        X @ rng.normal(0, 1, d) + rng.normal(0, 0.1, n)
    w = rng.random(n).astype(np.float32) + 0.5
    W0 = (rng.normal(0, 1, (d, k if kind == "logistic" else 1)) * 0.01
          ).astype(np.float32)
    return X, y, w, W0


@pytest.mark.parametrize("kind", ["logistic", "squared"])
@pytest.mark.parametrize("steps", [1, 20, 200])
@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_linear_runner_equals_jax_from_the_same_start(kind, steps, reg):
    X, y, w, W0 = _linear_data(kind)
    k = W0.shape[1]
    want = jlinear._jitted_runner()(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        {"W": jnp.asarray(W0), "b": jnp.zeros(k)}, jnp.float32(reg),
        jnp.float32(0.1), n_out=k, loss_kind=kind, steps=steps)
    got = plinear.run_linear(
        torch.from_numpy(X), torch.from_numpy(np.asarray(y)),
        torch.from_numpy(w), {"W": torch.from_numpy(W0),
                              "b": torch.zeros(k)},
        reg, 0.1, n_out=k, loss_kind=kind, steps=steps)
    np.testing.assert_allclose(got["W"].numpy(), np.asarray(want["W"]), **LIN)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]), **LIN)


def test_init_params_are_seeded_on_the_cpu():
    a, b = plinear.init_params(5, 3, 7), plinear.init_params(5, 3, 7)
    assert torch.equal(a["W"], b["W"]) and not a["b"].any()
    assert not torch.equal(a["W"], plinear.init_params(5, 3, 8)["W"])
    assert 0.001 < float(a["W"].abs().mean()) < 0.05


def _cls_frames(n=120, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 3))
    y = np.where(X[:, 0] + 0.5 * X[:, 1] > 0.3, "b",
                 np.where(X[:, 2] > 0, "c", "a"))
    w = rng.random(n) + 0.5
    cols = {"features": list(X), "label": y, "w": w}
    return (JDataFrame({"features": jobject_col(cols["features"]),
                        "label": y, "w": w}),
            DataFrame({"features": object_col(cols["features"]),
                       "label": y, "w": w}))


def test_logistic_regression_fits_and_scores_like_jax(tmp_path):
    jdf, pdf = _cls_frames()
    est = plinear.LogisticRegression(device="cpu", max_iter=300,
                                     weight_col="w")
    model = est.fit(pdf)
    out = model.transform(pdf)
    assert model.get("classes") == ["a", "b", "c"]
    assert (out["prediction"] == pdf["label"]).mean() > 0.9
    assert out["probability"][0].shape == (3,)
    # the JAX model with the port's coefficients scores the same
    jm = jlinear.LogisticRegressionModel()
    jm.set(coefficients=model.get("coefficients"),
           intercept=model.get("intercept"), classes=model.get("classes"))
    want = jm.transform(jdf)
    assert list(out["prediction"]) == list(want["prediction"])
    np.testing.assert_allclose(np.stack(out["probability"]),
                               np.stack(want["probability"]), **F32)
    assert out.column_metadata("prediction") == \
        want.column_metadata("prediction")
    model.save(str(tmp_path / "lr"))
    back = plinear.LogisticRegressionModel.load(str(tmp_path / "lr"),
                                                device="cpu")
    assert list(back.transform(pdf)["prediction"]) == list(out["prediction"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plinear.LogisticRegression()


def test_linear_regression_fits_and_scores_like_jax():
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (100, 2))
    y = 2.0 * X[:, 0] - 1.0 * X[:, 1] + 0.5
    model = plinear.LinearRegression(device="cpu", max_iter=500,
                                     learning_rate=0.2).fit(
        DataFrame({"features": object_col(list(X)), "label": y}))
    pred = model.transform(DataFrame({"features": object_col(list(X))}))
    assert np.mean((pred["prediction"] - y) ** 2) < 0.05
    jm = jlinear.LinearRegressionModel()
    jm.set(coefficients=model.get("coefficients"),
           intercept=model.get("intercept"))
    want = jm.transform(JDataFrame({"features": jobject_col(list(X))}))
    np.testing.assert_allclose(pred["prediction"], want["prediction"],
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# TorchModel against JaxModel


def _jax_mlp(params, feeds):
    x = feeds["input"]
    h = jnp.maximum(x @ params["w1"] + params["b1"], 0.0)
    return {"logits": h @ params["w2"] + params["b2"], "hidden": h}


def _torch_mlp(params, feeds):
    x = feeds["input"]
    h = torch.relu(x @ params["w1"] + params["b1"])
    return {"logits": h @ params["w2"] + params["b2"], "hidden": h}


def _mlp_params(seed=0, din=6, dh=8, dout=3):
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(0, 0.5, (din, dh)).astype(np.float32),
            "b1": rng.normal(0, 0.1, dh).astype(np.float32),
            "w2": rng.normal(0, 0.5, (dh, dout)).astype(np.float32),
            "b2": np.zeros(dout, dtype=np.float32)}


def _mlp_frames(n=11, din=6, seed=1):
    X = np.random.default_rng(seed).normal(0, 1, (n, din)).astype(np.float32)
    return (JDataFrame({"feats": list(X)}, npartitions=2),
            DataFrame({"feats": list(X)}, npartitions=2), X)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("fetch", [{}, {"out": "logits"}])
def test_torch_model_equals_jax_model(dtype, tol, fetch):
    params = _mlp_params()
    jdf, pdf, _ = _mlp_frames()
    kw = dict(feed_dict={"input": "feats"}, fetch_dict=fetch,
              mini_batch_size=4, compute_dtype=dtype)
    want = JaxModel(_jax_mlp, params, **kw).transform(jdf)
    m = TorchModel(_torch_mlp, params, device="cpu", **kw)
    got = m.transform(pdf)
    cols = list(fetch) or ["logits", "hidden"]
    for c in cols:
        assert got[c].dtype == np.float32
        np.testing.assert_allclose(got[c], np.asarray(want[c], np.float32),
                                   **tol)
    snap = m.stage_counters.snapshot()
    assert snap["dispatch"]["calls"] == 4        # 6 + 5 rows in batches of 4


def test_torch_model_runs_a_module_and_single_outputs():
    params = _mlp_params(seed=3)
    jdf, pdf, X = _mlp_frames(seed=2)
    lin = torch.nn.Linear(6, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(params["w1"][:, :3].T.copy()))
        lin.bias.copy_(torch.from_numpy(params["b1"][:3]))
    got = TorchModel(lin, device="cpu", feed_dict={"input": "feats"},
                     mini_batch_size=4).transform(pdf)["output"]
    want = JaxModel(lambda p, f: f["input"] @ p["w"] + p["b"],
                    {"w": params["w1"][:, :3], "b": params["b1"][:3]},
                    feed_dict={"input": "feats"}).transform(jdf)["output"]
    np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_torch_model_save_load_and_refusals(tmp_path):
    params = _mlp_params()
    _, pdf, _ = _mlp_frames()
    # a closure is transient: the params survive, apply_fn is re-set
    m = TorchModel(lambda p, f: _torch_mlp(p, f), params, device="cpu",
                   feed_dict={"input": "feats"})
    first = m.transform(pdf)["logits"]
    m.save(str(tmp_path / "tm"))
    back = TorchModel.load(str(tmp_path / "tm"), device="cpu")
    with pytest.raises(ValueError, match="apply_fn is unset"):
        back.transform(pdf)
    back.set(apply_fn=_torch_mlp)
    np.testing.assert_array_equal(back.transform(pdf)["logits"], first)
    # a module-level function outside the package is saved by reference,
    # and the port's loader refuses to import it
    m.set(apply_fn=_torch_mlp)
    m.save(str(tmp_path / "ref"))
    with pytest.raises(ValueError, match="refusing"):
        TorchModel.load(str(tmp_path / "ref"), device="cpu")
    # tuning="auto" is ported: the model accepts it, and takes it back
    m.set(tuning="auto")
    assert m.get("tuning") == "auto"
    m.set(tuning="")
    with pytest.raises(NotImplementedError, match="mesh"):
        TorchModel(_torch_mlp, params, device="cpu", mesh_sharded=True,
                   feed_dict={"input": "feats"}).transform(pdf)
    warm = m.warm_up({"input": (np.float32, (6,))}, batch_sizes=[4, 3])
    assert warm["buckets"] == [4]
