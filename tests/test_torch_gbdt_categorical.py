"""Categorical features in the port (``mmlspark_tpu_torch/models/gbdt/
categorical.py``, the encoder's glue in ``train.py`` and ``booster.py``)
against the JAX package on the CPU.

The label-ordered rank encoding is bitwise the JAX package's (values,
ranks and transformed matrices, with ``cat_smooth``,
``min_data_per_group``, NaN and unseen categories), and its dicts load
across the packages. ``train()`` with ``categorical_feature`` gives the
JAX package's trees (split features and raw thresholds exact, leaves
within rtol 1e-5 / atol 1e-7, covers exact, predictions within rtol
1e-5 / atol 1e-6), with validation sets and early stopping too; SHAP of
a categorical model runs in its rank space, as the JAX package's (within
1e-6 of the largest |phi|). Then the properties of
``tests/test_gbdt_categorical.py`` through the estimator, and the JAX
package's refusals."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.models.gbdt import estimators as jest
from mmlspark_tpu.models.gbdt.categorical import CategoricalEncoder as JEnc
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.models.gbdt import Booster as PBooster
from mmlspark_tpu_torch.models.gbdt import estimators as pest
from mmlspark_tpu_torch.models.gbdt import train as ptrain
from mmlspark_tpu_torch.models.gbdt.categorical import \
    CategoricalEncoder as PEnc
from test_torch_gbdt import _same_predictions, _same_trees

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

BASE = {"num_iterations": 8, "num_leaves": 8, "max_bin": 64,
        "min_data_in_leaf": 5, "seed": 3}


def _cat_data(objective, n=2000, seed=0, nan=0.0):
    """Two categorical columns (12 and 40 values, codes not in label
    order) and four numeric ones; the label mixes per-category effects
    with a numeric signal."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    c1 = rng.integers(0, 12, n)
    c2 = rng.integers(0, 40, n)
    e1 = rng.normal(0, 1.0, 12)
    e2 = rng.normal(0, 0.7, 40)
    X[:, 0] = c1 * 3.0 + 1.0
    X[:, 3] = c2
    if nan:
        X[rng.random(n) < nan, 3] = np.nan
    s = e1[c1] + e2[c2] + X[:, 1] - 0.5 * X[:, 2]
    if objective == "regression":
        return X, s + rng.normal(0, 0.3, n)
    if objective == "multiclass":
        return X, np.digitize(s, [-1.0, 1.0]).astype(np.float64)
    return X, (s + rng.normal(0, 0.3, n) > 0).astype(np.float64)


ENCODERS = {
    "default": {},
    "no_smooth": {"cat_smooth": 0.0},
    "smooth50": {"cat_smooth": 50.0},
    "pooled": {"cat_smooth": 0.0, "min_data_per_group": 60},
    "pooled_smooth": {"cat_smooth": 5.0, "min_data_per_group": 40},
}


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_encoder_bitwise(case):
    X, y = _cat_data("regression", n=1500, nan=0.05)
    X[:5, 0] = [100.0, 101.0, 102.0, 100.0, 103.0]      # rare categories
    kw = ENCODERS[case]
    je = JEnc([3, 0], **kw).fit(X, y)
    pe = PEnc([3, 0], **kw).fit(X, y)
    assert pe.feature_indices == je.feature_indices == [0, 3]
    for a, b in zip(pe.values + pe.ranks, je.values + je.ranks):
        np.testing.assert_array_equal(a, b)
    Xq = X.copy()
    Xq[:7, 3] = 999.0                                   # unseen -> NaN
    for dt in (np.float64, np.float32):
        got, want = pe.transform(Xq.astype(dt)), je.transform(Xq.astype(dt))
        assert got.dtype == want.dtype == dt
        np.testing.assert_array_equal(got, want)
    assert np.isnan(pe.transform(Xq)[:7, 3]).all()
    # the dicts load across the packages
    np.testing.assert_array_equal(PEnc.from_dict(je.to_dict()).transform(X),
                                  je.transform(X))
    np.testing.assert_array_equal(JEnc.from_dict(pe.to_dict()).transform(X),
                                  pe.transform(X))


def test_encoder_rejects_negative_knobs():
    for kw in ({"cat_smooth": -1.0}, {"min_data_per_group": -1}):
        with pytest.raises(ValueError):
            PEnc([0], **kw)


CASES = {
    "one": {"categorical_feature": [0]},
    "two": {"categorical_feature": [3, 0]},
    "two_smoothed": {"categorical_feature": [0, 3], "cat_smooth": 2.0,
                     "min_data_per_group": 30},
    "dart": {"categorical_feature": [0, 3], "boosting": "dart",
             "skip_drop": 0.0},
    "goss": {"categorical_feature": [0, 3], "boosting": "goss"},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("objective", ["binary", "regression", "multiclass"])
def test_train_matches_reference(objective, case):
    X, y = _cat_data(objective, nan=0.02)
    p = {**BASE, "objective": objective, **CASES[case]}
    if objective == "multiclass":
        p["num_class"] = 3
    bj, bp = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)
    assert bp.cat_encoder is not None
    for a, b in zip(bp.cat_encoder.ranks, bj.cat_encoder.ranks):
        np.testing.assert_array_equal(a, b)
    assert "cat_encode" in bp.phase_seconds


def test_valid_sets_and_early_stopping_match_reference():
    X, y = _cat_data("regression", n=1500)
    p = {**BASE, "objective": "regression", "num_iterations": 60,
         "learning_rate": 0.8, "num_leaves": 31, "min_data_in_leaf": 2,
         "categorical_feature": [0, 3], "early_stopping_round": 3,
         "metric": "l2"}
    jlog, plog = [], []
    bj = jtrain(p, X[:1000], y[:1000], valid_sets=[(X[1000:], y[1000:])],
                eval_log=jlog)
    bp = ptrain(p, X[:1000], y[:1000], valid_sets=[(X[1000:], y[1000:])],
                eval_log=plog, device="cpu")
    np.testing.assert_allclose([e["l2"] for e in plog],
                               [e["l2"] for e in jlog], rtol=1e-5)
    assert bp.num_trees == bj.num_trees < 60
    assert bp.cat_encoder is not None            # survives truncation
    _same_predictions(bj, bp, X)


def test_warm_start_reuses_the_encoder():
    X, y = _cat_data("regression", n=1000)
    p = {**BASE, "objective": "regression", "categorical_feature": [0]}
    bj0, bp0 = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    q = {**BASE, "objective": "regression", "num_iterations": 4}
    bj = jtrain(q, X, y, init_model=bj0)
    bp = ptrain(q, X, y, init_model=bp0, device="cpu")
    assert bp.cat_encoder is bp0.cat_encoder
    np.testing.assert_array_equal(bp.feats, bj.feats)
    # the JAX package appends to its init model and leaves its
    # best_iteration at the new iterations: predict with all of them
    np.testing.assert_allclose(bp.predict(X),
                               np.asarray(bj.predict(X, num_iteration=0)),
                               rtol=1e-5, atol=1e-6)


def test_shap_in_rank_space_matches_reference():
    X, y = _cat_data("binary", n=600)
    p = {**BASE, "objective": "binary", "categorical_feature": [0, 3]}
    bj, bp = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    pj, pp = np.asarray(bj.shap_values(X[:50])), bp.shap_values(X[:50])
    np.testing.assert_allclose(pp, pj, rtol=0,
                               atol=1e-6 * np.abs(pj).max())
    np.testing.assert_allclose(pp.sum(axis=1), bp.raw_score(X[:50]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(bp.predict_leaf(X), bj.predict_leaf(X))


def test_model_strings_cross_load():
    X, y = _cat_data("multiclass", n=800)
    p = {**BASE, "objective": "multiclass", "num_class": 3,
         "categorical_feature": [0, 3]}
    bj, bp = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    _same_predictions(bj, PBooster.from_string(bj.to_string(), device="cpu"),
                      X)
    from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
    _same_predictions(JBooster.from_string(bp.to_string()), bp, X)
    m = bp.merge(bp.truncated(3))
    assert m.cat_encoder is bp.cat_encoder


# -- the estimator (tests/test_gbdt_categorical.py's problems) -----------------

def _interleaved(n=400, seed=0):
    """y = 1 for categories {0, 2}, 0 for {1, 3}: in code order the
    classes interleave, so one ordinal threshold cannot separate them."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 4, n).astype(np.float64)
    y = np.isin(cat, [0, 2]).astype(np.float64)
    return {"features": np.stack([cat, rng.normal(0, 1, n)], axis=1),
            "label": y}


def test_single_split_separates_interleaved_categories():
    cols = _interleaved()
    kw = dict(num_iterations=1, max_depth=1, min_data_in_leaf=1)
    cat = pest.LightGBMClassifier(device="cpu", categorical_feature=[0],
                                  **kw).fit(DataFrame(cols))
    plain = pest.LightGBMClassifier(device="cpu", **kw).fit(DataFrame(cols))
    y = cols["label"]
    pred = np.asarray(cat.transform(DataFrame(cols))["prediction"])
    assert (pred == y).mean() == 1.0
    assert (np.asarray(plain.transform(DataFrame(cols))["prediction"])
            == y).mean() < 0.8
    want = jest.LightGBMClassifier(categorical_feature=[0], **kw).fit(
        JDataFrame(cols)).transform(JDataFrame(cols))
    np.testing.assert_array_equal(pred, np.asarray(want["prediction"]))


def test_save_load_and_shap_columns(tmp_path):
    cols = _interleaved(seed=2)
    model = pest.LightGBMClassifier(
        device="cpu", num_iterations=3, max_depth=2, categorical_feature=[0],
        features_shap_col="shap", leaf_prediction_col="leaf").fit(
            DataFrame(cols))
    out = model.transform(DataFrame(cols))
    shap = np.stack(list(out["shap"]))
    raw = model.booster.raw_score(cols["features"].astype(np.float32))
    np.testing.assert_allclose(shap.sum(axis=1), raw, rtol=1e-3, atol=1e-3)
    model.save(str(tmp_path / "m"))
    m2 = PipelineStage.load(str(tmp_path / "m"))
    m2.device = model.device
    m2._booster = PBooster.from_string(
        m2.get("booster_string").decode(), device="cpu")
    got = np.stack(list(m2.transform(DataFrame(cols))["probability"]))
    np.testing.assert_array_equal(got, np.stack(list(out["probability"])))


# -- refusals: the JAX package's, raised the same way --------------------------

def test_refusals_match_reference():
    X, y = _cat_data("binary", n=300)
    p = {**BASE, "objective": "binary", "num_iterations": 2}
    plain_j, plain_p = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    cat = {**p, "categorical_feature": [0]}
    cases = [
        ((cat, sp.csr_matrix(np.nan_to_num(X)), y), {}, {}, "categorical"),
        ((cat, X, y), {"init_model": plain_j}, {"init_model": plain_p},
         "warm-start"),
        (({**cat, "linear_tree": True}, X, y), {}, {}, "numerical"),
        ((cat, X[:200], y[:200]),
         {"valid_sets": [(sp.csr_matrix(np.nan_to_num(X[200:])), y[200:])]},
         None, "sparse validation"),
    ]
    for args, jkw, pkw, match in cases:
        with pytest.raises(ValueError, match=match):
            jtrain(*args, **jkw)
        with pytest.raises(ValueError, match=match):
            ptrain(*args, device="cpu", **(jkw if pkw is None else pkw))
    bc = ptrain(cat, X, y, device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        bc.predict(sp.csr_matrix(np.nan_to_num(X)))
