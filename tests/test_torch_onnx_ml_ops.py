"""The port's ai.onnx.ml handlers (``mmlspark_tpu_torch/onnx/ml_ops.py``)
against the JAX converter on the CPU, and the booster -> ONNX -> converter
round trip of the port's GBDT models.

Every case of ``tests/test_onnx_ml_ops.py`` is here as a graph written
once with the port's builder and fed the same seeded numpy inputs through
both converters (the JAX one eagerly, its feeds as jax arrays), plus
MIN / MAX aggregation, every post transform, ``ZipMap`` and every
refusal. Tolerances:

* integer and index outputs (labels, ``Hardmax``), and data a handler
  only moves or selects (``ArrayFeatureExtractor``, ``FeatureVectorizer``,
  ``Imputer``, ``ZipMap``, ``ScatterElements``), bitwise;
* float outputs within 1e-5 · max|ref| + 1e-6 of the JAX converter's;
* each ``UnsupportedOp`` the JAX handler raises, the port raises too.

An exported booster's probabilities are also held to the booster's own
``predict`` (1e-5), and one ``ONNXModel(device="cpu")`` transform to the
port model's ``transform``. ``chip_smoke.ml_op_cases`` (phase 19c's
graphs) go through both converters too.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mmlspark_tpu.onnx as J
import mmlspark_tpu_torch.onnx as O
from mmlspark_tpu.onnx.convert import UnsupportedOp as JaxUnsupported
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.models.gbdt import (LightGBMClassifier,
                                            LightGBMRegressor)
from mmlspark_tpu_torch.models.gbdt.onnx_export import booster_to_onnx
from mmlspark_tpu_torch.models.onnx_model import ONNXModel
from mmlspark_tpu_torch.onnx.convert import UnsupportedOp

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import ml_op_cases  # noqa: E402

ML = {"domain": "ai.onnx.ml"}


def _model(nodes, feeds, inits=None, outs=("y",), opset=17):
    g = O.make_graph(
        nodes, "t",
        [O.make_tensor_value_info(k, np.asarray(v).dtype, list(np.shape(v)))
         for k, v in feeds.items()],
        [O.make_tensor_value_info(o, np.float32, []) for o in outs],
        initializers=inits or {})
    return O.make_model(g, opset=opset, extra_opsets={"ai.onnx.ml": 3})


def _port(data, feeds, outs):
    pm = O.convert_model(data)
    out = pm({k: torch.from_numpy(v) for k, v in pm.params.items()},
             {k: torch.from_numpy(np.array(v)) for k, v in feeds.items()})
    return {o: out[o].numpy() for o in outs}


def _jax(data, feeds, outs):
    jm = J.convert_model(data)
    out = jm(jm.params, {k: jnp.asarray(v) for k, v in feeds.items()})
    return {o: np.asarray(out[o]) for o in outs}


def _hold(got, want, exact, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # JAX runs with 64-bit types off: int64 comes back as int32
    assert got.dtype.kind == want.dtype.kind, (what, got.dtype, want.dtype)
    if want.dtype.kind != "f" or exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    tol = 1e-5 * float(np.abs(want).max(initial=0.0)) + 1e-6
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    assert err <= tol, f"{what}: max |port - jax| {err} > {tol}"


def _run_both(data, feeds, outs, exact=False):
    got, want = _port(data, feeds, outs), _jax(data, feeds, outs)
    for o in outs:
        _hold(got[o], want[o], exact, o)
    return got


def _both(op, feeds, inits=None, outs=("y",), exact=False, ml=True,
          opset=17, **attrs):
    """One node through both converters, every output held. Returns the
    port's outputs."""
    node = O.make_node(op, list(feeds) + list(inits or {}), list(outs),
                       **(ML if ml else {}), **attrs)
    return _run_both(_model([node], feeds, inits, outs, opset), feeds, outs,
                     exact)


def _refused(op, feeds, outs=("y",), match=None, ml=True, **attrs):
    node = O.make_node(op, list(feeds), list(outs), **(ML if ml else {}),
                       **attrs)
    data = _model([node], feeds, outs=outs)
    with pytest.raises(JaxUnsupported, match=match):
        _jax(data, feeds, outs)
    with pytest.raises(UnsupportedOp, match=match):
        _port(data, feeds, outs)


def _r(seed):
    g = np.random.default_rng(seed)
    return lambda *shape, s=1.0: g.normal(0, s, shape).astype(np.float32)


def _df(X, y=None):
    d = {"features": np.asarray(X, np.float32)}
    if y is not None:
        d["label"] = np.asarray(y, np.float64)
    return DataFrame(d)


def test_handler_set():
    """The port registers all 16 handlers of JAX ``onnx/ml_ops.py``."""
    from mmlspark_tpu.onnx.convert import OP_HANDLERS as jax_ops
    from mmlspark_tpu_torch.onnx.convert import OP_HANDLERS as port_ops
    ml = {"TreeEnsembleClassifier", "TreeEnsembleRegressor",
          "LinearClassifier", "LinearRegressor", "SVMClassifier",
          "SVMRegressor", "Scaler", "Normalizer", "Binarizer", "Imputer",
          "LabelEncoder", "ZipMap", "ArrayFeatureExtractor",
          "FeatureVectorizer", "Hardmax", "ScatterElements"}
    assert ml <= set(port_ops) and ml <= set(jax_ops)


# -- exported boosters -------------------------------------------------------

def _fit(kind, seed, nan=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (300, 6))
    if kind == "binary":
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
        est = LightGBMClassifier(device="cpu", num_iterations=12,
                                 num_leaves=8, learning_rate=0.2)
    elif kind == "multiclass":
        y = np.argmax(X[:, :3] + 0.3 * rng.normal(size=(300, 3)), axis=1)
        est = LightGBMClassifier(device="cpu", num_iterations=8,
                                 num_leaves=6, learning_rate=0.3)
    else:
        y = X[:, 0] * 2 - X[:, 1] + 0.1 * rng.normal(size=300)
        est = LightGBMRegressor(device="cpu", num_iterations=10,
                                num_leaves=8)
    model = est.fit(_df(X, y))
    Xq = rng.normal(0, 1, (64, 6)).astype(np.float32)
    if nan:
        Xq[::3, 0] = np.nan
        Xq[1::5, 2] = np.nan
    return model, Xq


@pytest.mark.parametrize("kind,nan", [("binary", False), ("binary", True),
                                      ("multiclass", False),
                                      ("multiclass", True),
                                      ("regression", False),
                                      ("regression", True)])
def test_exported_booster_through_both_converters(kind, nan):
    model, Xq = _fit(kind, {"binary": 0, "multiclass": 1,
                            "regression": 2}[kind], nan)
    booster = model.booster
    data = booster_to_onnx(booster)
    outs = ("variable",) if kind == "regression" else ("label",
                                                       "probabilities")
    got = _run_both(data, {"features": Xq}, outs)
    want = booster.predict(Xq)
    if kind == "regression":
        np.testing.assert_allclose(got["variable"][:, 0], want, rtol=1e-5,
                                   atol=1e-5)
        return
    p = got["probabilities"]
    if kind == "binary":
        np.testing.assert_allclose(p[:, 1], want, rtol=0, atol=1e-5)
        sure = np.abs(want - 0.5) > 1e-5
        np.testing.assert_array_equal(got["label"][sure],
                                      (want[sure] > 0.5).astype(np.int64))
    else:
        np.testing.assert_allclose(p, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-6)
    assert got["label"].dtype == np.int64


def test_model_to_onnx_method():
    """The fitted model's ``to_onnx()``."""
    model, Xq = _fit("binary", 6)
    got = _run_both(model.to_onnx(), {"features": Xq},
                    ("label", "probabilities"))
    np.testing.assert_allclose(got["probabilities"][:, 1],
                               model.booster.predict(Xq), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_exported_booster_through_onnx_model(kind):
    """An exported booster served by ``ONNXModel`` over a ``DataFrame``
    in float32 against the port model's own ``transform``: probabilities
    within 1e-5, the int64 labels surviving the runner."""
    model, Xq = _fit(kind, 4)
    stage = ONNXModel(model.to_onnx(), device="cpu",
                      compute_dtype="float32",
                      feed_dict={"features": "features"},
                      fetch_dict={"proba": "probabilities", "pred": "label"},
                      mini_batch_size=24)
    out = stage.transform(_df(Xq))
    want = np.stack(model.transform(_df(Xq))["probability"])
    got = np.stack(list(out["proba"]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    labels = np.asarray(out["pred"])
    assert labels.dtype == np.int64
    sure = np.sort(want, axis=1)[:, -1] - np.sort(want, axis=1)[:, -2] > 1e-5
    np.testing.assert_array_equal(labels[sure],
                                  np.argmax(want, axis=1)[sure])


# -- hand-built ensembles ----------------------------------------------------

# tree 0: root(f0 < 1.5) -> leaf1 / node2(f1 >= 0) -> leaf3 / leaf4
# tree 1: root(f0 > -1) -> leaf1 / node2(f1 == 0.5) -> leaf3 / node4(f1 != 2)
#         -> leaf5 / leaf6;  tree 7 (a sparse id): root(f1 <= 0) -> 1 / 2
RAGGED = dict(
    nodes_treeids=[0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 7, 7, 7],
    nodes_nodeids=[0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 5, 6, 0, 1, 2],
    nodes_featureids=[0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0, 0],
    nodes_values=[1.5, 0, 0.0, 0, 0, -1.0, 0, 0.5, 0, 2.0, 0, 0, 0.0, 0, 0],
    nodes_modes=["BRANCH_LT", "LEAF", "BRANCH_GTE", "LEAF", "LEAF",
                 "BRANCH_GT", "LEAF", "BRANCH_EQ", "LEAF", "BRANCH_NEQ",
                 "LEAF", "LEAF", "BRANCH_LEQ", "LEAF", "LEAF"],
    nodes_truenodeids=[1, 0, 3, 0, 0, 1, 0, 3, 0, 5, 0, 0, 1, 0, 0],
    nodes_falsenodeids=[2, 0, 4, 0, 0, 2, 0, 4, 0, 6, 0, 0, 2, 0, 0],
    nodes_missing_value_tracks_true=[1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0,
                                     1, 0, 0])
LEAVES = [(0, 1), (0, 3), (0, 4), (1, 1), (1, 3), (1, 5), (1, 6), (7, 1),
          (7, 2)]
RAGGED_X = np.array([[0.0, 5.0], [2.0, 1.0], [2.0, -1.0], [-3.0, 0.0],
                     [np.nan, -2.0], [0.0, 0.5], [0.0, 2.0], [0.0, np.nan],
                     [1.5, 0.0], [-1.0, 3.0]], np.float32)


def _oracle(row):
    """Per-row leaves of the RAGGED trees, as a plain python walk."""
    x0, x1 = float(row[0]), float(row[1])
    t0 = 1 if (np.isnan(x0) or x0 < 1.5) else (3 if x1 >= 0 else 4)
    if x0 > -1:
        t1 = 1
    elif np.isnan(x1) or x1 == 0.5:
        t1 = 3
    else:
        t1 = 5 if x1 != 2.0 else 6
    t7 = 1 if (np.isnan(x1) or x1 <= 0) else 2
    return {0: t0, 1: t1, 7: t7}


@pytest.mark.parametrize("agg", ["SUM", "AVERAGE", "MIN", "MAX"])
@pytest.mark.parametrize("post", ["NONE", "LOGISTIC", "PROBIT"])
def test_ragged_regressor_every_branch_mode(agg, post):
    rng = np.random.default_rng(7)
    w = rng.normal(0, 3, len(LEAVES)).round(2)
    got = _both("TreeEnsembleRegressor", {"x": RAGGED_X},
                target_treeids=[t for t, _ in LEAVES],
                target_nodeids=[n for _, n in LEAVES],
                target_ids=[0] * len(LEAVES),
                target_weights=w.tolist(), n_targets=1,
                aggregate_function=agg, post_transform=post,
                base_values=[0.25], **RAGGED)["y"][:, 0]
    table = {leaf: float(np.float32(v)) for leaf, v in zip(LEAVES, w)}
    per = np.array([[table[(t, n)] for t, n in _oracle(r).items()]
                    for r in RAGGED_X])
    raw = {"SUM": per.sum(1), "AVERAGE": per.mean(1), "MIN": per.min(1),
           "MAX": per.max(1)}[agg] + 0.25
    from scipy.special import erf
    want = {"NONE": raw, "LOGISTIC": 1 / (1 + np.exp(-raw)),
            "PROBIT": 0.5 * (1 + erf(raw / np.sqrt(2)))}[post]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("post", ["NONE", "SOFTMAX", "SOFTMAX_ZERO",
                                  "LOGISTIC"])
def test_multi_target_regressor_and_classifier(post):
    """Two targets / three classes, repeated leaf entries (+=), zero
    logits for SOFTMAX_ZERO."""
    ids = [t for t, _ in LEAVES]
    nids = [n for _, n in LEAVES]
    w = [0.5, -1.0, 2.0, 0.0, 1.5, -0.5, 0.25, 3.0, -2.0]
    _both("TreeEnsembleRegressor", {"x": RAGGED_X},
          target_treeids=ids + ids[:3], target_nodeids=nids + nids[:3],
          target_ids=[0] * 9 + [1, 1, 1], target_weights=w + [1.0, 0.0, 2.0],
          n_targets=2, post_transform=post, **RAGGED)
    _both("TreeEnsembleClassifier", {"x": RAGGED_X}, outs=("label", "p"),
          class_treeids=ids * 2, class_nodeids=nids * 2,
          class_ids=[0] * 9 + [2] * 9, class_weights=w + w[::-1],
          classlabels_int64s=[10, 20, 30], post_transform=post, **RAGGED)


@pytest.mark.parametrize("post", ["NONE", "LOGISTIC"])
def test_binary_single_class_classifier(post):
    """One class id with two labels: every entry scores class 1 (sklearn
    forests carry probabilities under NONE)."""
    ids = [t for t, _ in LEAVES]
    nids = [n for _, n in LEAVES]
    got = _both("TreeEnsembleClassifier", {"x": RAGGED_X},
                outs=("label", "p"), class_treeids=ids, class_nodeids=nids,
                class_ids=[1] * 9,
                class_weights=[0.1, 0.2, 0.05, 0.1, 0.3, 0.02, 0.15, 0.1,
                               0.05],
                classlabels_int64s=[0, 1], post_transform=post, **RAGGED)
    np.testing.assert_allclose(got["p"].sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("case", ["string_labels", "binary_softmax",
                                  "post", "aggregate", "domain"])
def test_tree_ensemble_refusals(case):
    ids = [t for t, _ in LEAVES]
    nids = [n for _, n in LEAVES]
    x = {"x": RAGGED_X}
    if case == "string_labels":
        _refused("TreeEnsembleClassifier", x, outs=("label", "p"),
                 match="string class", class_treeids=ids, class_nodeids=nids,
                 class_ids=[0] * 9, class_weights=[1.0] * 9,
                 classlabels_strings=["a", "b"], **RAGGED)
    elif case == "binary_softmax":
        _refused("TreeEnsembleClassifier", x, outs=("label", "p"),
                 match="binary single-class", class_treeids=ids,
                 class_nodeids=nids, class_ids=[1] * 9,
                 class_weights=[1.0] * 9, classlabels_int64s=[0, 1],
                 post_transform="SOFTMAX", **RAGGED)
    elif case == "post":
        _refused("TreeEnsembleRegressor", x, match="post_transform",
                 target_treeids=ids, target_nodeids=nids,
                 target_ids=[0] * 9, target_weights=[1.0] * 9,
                 post_transform="CUBE", **RAGGED)
    elif case == "aggregate":
        _refused("TreeEnsembleRegressor", x, match="aggregate_function",
                 target_treeids=ids, target_nodeids=nids,
                 target_ids=[0] * 9, target_weights=[1.0] * 9,
                 aggregate_function="MEDIAN", **RAGGED)
    else:
        _refused("TreeEnsembleRegressor", x, match="domain", ml=False,
                 target_treeids=ids, target_nodeids=nids,
                 target_ids=[0] * 9, target_weights=[1.0] * 9, **RAGGED)


def test_tree_tables_placed_once_per_device():
    """The walk tables are parsed and placed once per converted node, not
    once a batch."""
    model, Xq = _fit("binary", 3)
    pm = O.convert_model(model.to_onnx())
    for lo in (0, 16, 32):
        pm({}, {"features": torch.from_numpy(Xq[lo:lo + 16])})
    node = pm.model.graph.nodes[0]
    assert list(node._ml_constants) == ["cpu"]
    first = node._ml_constants["cpu"]["tables"][0]
    pm({}, {"features": torch.from_numpy(Xq[:8])})
    assert node._ml_constants["cpu"]["tables"][0] is first


# -- linear models and preprocessing -----------------------------------------

def test_scaler():
    r = _r(10)
    x = r(4, 3)
    _both("Scaler", {"x": x}, offset=r(3).tolist(), scale=r(3).tolist())
    got = _both("Scaler", {"x": np.array([[1.0, 2.0], [3.0, 4.0]],
                                         np.float32)},
                offset=[1.0, 2.0], scale=[2.0, 0.5])["y"]
    np.testing.assert_allclose(got, [[0, 0], [4, 1]])


@pytest.mark.parametrize("norm", ["MAX", "L1", "L2"])
def test_normalizer(norm):
    x = _r(11)(5, 4)
    x[2] = 0.0
    _both("Normalizer", {"x": x}, norm=norm)


def test_normalizer_refusal():
    _refused("Normalizer", {"x": _r(12)(2, 3)}, norm="L3", match="norm")


@pytest.mark.parametrize("case", ["nan", "value", "int", "one_fill"])
def test_imputer(case):
    x = _r(13)(4, 3)
    if case == "nan":
        x[::2, 1] = np.nan
        x[3, 0] = np.nan
        got = _both("Imputer", {"x": x}, exact=True,
                    imputed_value_floats=[9.0, 7.0, 5.0])["y"]
        assert not np.isnan(got).any()
    elif case == "value":
        x[1, :] = -1.0
        _both("Imputer", {"x": x}, exact=True,
              imputed_value_floats=[9.0, 7.0, 5.0],
              replaced_value_float=-1.0)
    elif case == "one_fill":
        x[0, 2] = np.nan
        _both("Imputer", {"x": x}, exact=True, imputed_value_floats=[3.5])
    else:
        xi = np.array([[0, 4, 2], [7, 0, 0]], np.int64)
        _both("Imputer", {"x": xi}, imputed_value_int64s=[1, 2, 3],
              replaced_value_int64=0)


def test_binarizer():
    x = _r(14)(3, 4)
    _both("Binarizer", {"x": x}, threshold=0.25)
    np.testing.assert_array_equal(
        _both("Binarizer", {"x": np.array([[0.2, 0.8]], np.float32)},
              threshold=0.5)["y"], [[0.0, 1.0]])


def test_array_feature_extractor():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = _both("ArrayFeatureExtractor", {"x": x},
                {"idx": np.array([3, 1], np.int64)}, exact=True)["y"]
    np.testing.assert_array_equal(got, x[:, [3, 1]])
    _both("ArrayFeatureExtractor", {"x": x, "idx": np.array([[2]], np.int64)},
          exact=True)


def test_feature_vectorizer():
    a = np.array([[1.0], [2.0]], np.float32)
    b = np.array([[3.0, 4.0], [5.0, 6.0]], np.float32)
    c = np.array([7.0, 8.0], np.float32)
    got = _both("FeatureVectorizer", {"a": a, "b": b, "c": c}, exact=True,
                inputdimensions=[1, 2, 1])["y"]
    np.testing.assert_array_equal(got, [[1, 3, 4, 7], [2, 5, 6, 8]])


@pytest.mark.parametrize("keys,vals", [
    ("keys_int64s", "values_floats"), ("keys_int64s", "values_int64s"),
    ("keys_floats", "values_int64s"), ("keys_floats", "values_floats")])
def test_label_encoder(keys, vals):
    fk = keys == "keys_floats"
    x = (np.array([0.5, 7.0, 9.0, 0.5, 1.25], np.float32) if fk
         else np.array([5, 7, 9, 5, 11], np.int64))
    kv = [0.5, 7.0, 1.25] if fk else [5, 7, 11]
    vv = [0.5, 0.7, 1.1] if vals == "values_floats" else [10, 20, 30]
    default = ({"default_float": -1.0} if vals == "values_floats"
               else {"default_int64": -7})
    _both("LabelEncoder", {"x": x}, exact=True, **{keys: kv, vals: vv},
          **default)


def test_label_encoder_defaults_and_refusal():
    x = np.array([5, 7, 9], np.int64)
    got = _both("LabelEncoder", {"x": x}, keys_int64s=[5, 7],
                values_floats=[0.5, 0.7], default_float=-1.0)["y"]
    np.testing.assert_allclose(got, [0.5, 0.7, -1.0])
    _both("LabelEncoder", {"x": x}, keys_int64s=[5], values_int64s=[3])
    _refused("LabelEncoder", {"x": x}, match="string keys",
             keys_strings=["a"], values_int64s=[1])


def test_zipmap_passes_probabilities_through():
    p = _r(15)(4, 3)
    got = _both("ZipMap", {"x": p}, exact=True,
                classlabels_int64s=[0, 1, 2])["y"]
    np.testing.assert_array_equal(got, p)


@pytest.mark.parametrize("post", ["LOGISTIC", "NONE"])
def test_linear_classifier_binary(post):
    x = np.array([[1.0, 0.0], [-1.0, 0.0], [0.3, 2.0]], np.float32)
    labels, scores = (_both("LinearClassifier", {"x": x},
                            outs=("label", "scores"),
                            coefficients=[2.0, 0.5], intercepts=[0.1],
                            classlabels_ints=[0, 1],
                            post_transform=post)[o]
                      for o in ("label", "scores"))
    s = x @ np.array([2.0, 0.5], np.float32) + 0.1
    p1 = 1 / (1 + np.exp(-s)) if post == "LOGISTIC" else s
    np.testing.assert_allclose(scores[:, 1], p1, rtol=1e-5)


@pytest.mark.parametrize("post", ["NONE", "SOFTMAX", "LOGISTIC",
                                  "SOFTMAX_ZERO"])
def test_linear_classifier_multiclass(post):
    r = _r(16)
    _both("LinearClassifier", {"x": r(5, 4)}, outs=("label", "scores"),
          coefficients=r(3, 4).ravel().tolist(), intercepts=r(3).tolist(),
          classlabels_ints=[7, 8, 9], post_transform=post)


def test_linear_classifier_refusal():
    _refused("LinearClassifier", {"x": _r(17)(2, 2)},
             outs=("label", "scores"), match="string class",
             coefficients=[1.0, 1.0], intercepts=[0.0],
             classlabels_strings=["a", "b"])


@pytest.mark.parametrize("targets", [1, 2])
def test_linear_regressor(targets):
    r = _r(18)
    _both("LinearRegressor", {"x": r(4, 3)},
          coefficients=r(targets, 3).ravel().tolist(),
          intercepts=r(targets).tolist(), targets=targets)
    got = _both("LinearRegressor", {"x": np.array([[1.0, 2.0]], np.float32)},
                coefficients=[3.0, -1.0], intercepts=[0.5], targets=1)["y"]
    np.testing.assert_allclose(got, [[1.5]])


# -- SVMs --------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["LINEAR", "POLY", "RBF", "SIGMOID"])
def test_svm_regressor(kernel):
    r = _r(20)
    SV = r(3, 2)
    coef = np.array([0.5, -1.0, 0.25], np.float32)
    X = r(5, 2)
    got = _both("SVMRegressor", {"x": X}, coefficients=coef.tolist(),
                support_vectors=SV.reshape(-1).tolist(), rho=[0.3],
                kernel_type=kernel, kernel_params=[0.7, 0.5, 3.0])["y"]
    if kernel == "RBF":
        d2 = ((X[:, None] - SV[None]) ** 2).sum(-1)
        np.testing.assert_allclose(got[:, 0], np.exp(-0.7 * d2) @ coef + 0.3,
                                   rtol=1e-5, atol=1e-5)


def test_svm_classifier_binary_linear():
    """dec = 2 * x0 + rho (rho holds sklearn's intercept_, added)."""
    SV = np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)
    X = np.array([[2.0, 0.0], [-2.0, 0.0], [-0.25, 1.0]], np.float32)
    got = _both("SVMClassifier", {"x": X}, outs=("label", "scores"),
                classlabels_ints=[0, 1], vectors_per_class=[1, 1],
                support_vectors=SV.reshape(-1).tolist(),
                coefficients=[1.0, -1.0], rho=[0.5], kernel_type="LINEAR")
    np.testing.assert_allclose(got["scores"][:, 0], [4.5, -3.5, 0.0],
                               atol=1e-6)
    np.testing.assert_array_equal(got["label"], [0, 1, 1])


@pytest.mark.parametrize("kernel", ["RBF", "POLY"])
def test_svm_classifier_one_vs_one(kernel):
    """Three classes; the third row ties every vote (one win each), so
    the decision sums pick the label."""
    r = _r(21)
    X = np.concatenate([r(5, 3), np.zeros((1, 3), np.float32)])
    _both("SVMClassifier", {"x": X}, outs=("label", "scores"),
          classlabels_ints=[3, 4, 5], vectors_per_class=[2, 1, 2],
          support_vectors=r(5, 3).ravel().tolist(),
          coefficients=r(2, 5).ravel().tolist(), rho=r(3).tolist(),
          kernel_type=kernel, kernel_params=[0.5, 1.0, 2.0],
          post_transform="NONE")


@pytest.mark.parametrize("case", ["one_class", "kernel", "platt",
                                  "string_labels"])
def test_svm_refusals(case):
    x = {"x": _r(22)(2, 2)}
    sv = dict(support_vectors=[1.0, 0.0, -1.0, 0.0], rho=[0.0])
    if case == "one_class":
        _refused("SVMRegressor", x, match="one_class", one_class=1,
                 coefficients=[1.0, 1.0], **sv)
    elif case == "kernel":
        _refused("SVMRegressor", x, match="kernel", kernel_type="CUBIC",
                 coefficients=[1.0, 1.0], **sv)
    elif case == "platt":
        _refused("SVMClassifier", x, outs=("label", "scores"),
                 match="Platt", prob_a=[1.0], prob_b=[0.0],
                 classlabels_ints=[0, 1], vectors_per_class=[1, 1],
                 coefficients=[1.0, -1.0], **sv)
    else:
        _refused("SVMClassifier", x, outs=("label", "scores"),
                 match="string class", classlabels_strings=["a", "b"],
                 vectors_per_class=[1, 1], coefficients=[1.0, -1.0], **sv)


# -- core-domain stragglers --------------------------------------------------

@pytest.mark.parametrize("axis,opset", [(None, 17), (0, 17), (None, 11)])
def test_hardmax(axis, opset):
    """Ties take the first maximal index."""
    x = np.array([[1.0, 3.0, 3.0], [2.0, 0.0, -1.0], [5.0, 5.0, 5.0]],
                 np.float32)
    attrs = {} if axis is None else {"axis": axis}
    got = _both("Hardmax", {"x": x}, exact=True, ml=False, opset=opset,
                **attrs)["y"]
    if axis is None:
        np.testing.assert_array_equal(got, [[0, 1, 0], [1, 0, 0], [1, 0, 0]])


@pytest.mark.parametrize("reduction", ["none", "add", "mul", "max", "min"])
@pytest.mark.parametrize("axis", [0, 1])
def test_scatter_elements(reduction, axis):
    """Unique indices (repeats are undefined for "none" and
    order-dependent on CUDA), some negative."""
    r = _r(23)
    data = r(3, 4)
    idx = (np.array([[0, -1], [2, 1]], np.int64) if axis == 1
           else np.array([[0, 2, -1, 1], [-2, 0, 0, 2]], np.int64))
    upd = r(*idx.shape)
    _both("ScatterElements", {"data": data, "idx": idx, "upd": upd},
          exact=True, ml=False, axis=axis, reduction=reduction)


def test_scatter_elements_add_matches_loop():
    data = np.zeros((3, 3), np.float32)
    idx = np.array([[0, 1], [1, 2]], np.int64)
    upd = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    got = _both("ScatterElements", {"data": data, "idx": idx, "upd": upd},
                exact=True, ml=False, axis=1, reduction="add")["y"]
    want = np.zeros((3, 3), np.float32)
    want[0, 0] += 1
    want[0, 1] += 2
    want[1, 1] += 3
    want[1, 2] += 4
    np.testing.assert_array_equal(got, want)


def test_scatter_elements_refusal():
    _refused("ScatterElements", {"data": np.zeros((2, 2), np.float32),
                                 "idx": np.zeros((1, 1), np.int64),
                                 "upd": np.ones((1, 1), np.float32)},
             ml=False, reduction="xor", match="reduction")


CARD_CASES = ml_op_cases()


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_chip_smoke_ml_cases_match_the_reference(name):
    data, feeds, exact = CARD_CASES[name]
    _run_both(data, feeds, O.convert_model(data).output_names, exact)
