"""goss, dart and rf boosting in the port (``mmlspark_tpu_torch/models/
gbdt/train.py``) against the JAX package's ``train()`` on the CPU.

Trees are held as ``tests/test_torch_gbdt.py`` holds them: split
features and raw thresholds exact, leaves within rtol 1e-5 / atol 1e-7,
covers exact, predictions within rtol 1e-5 / atol 1e-6. The draws are
held bitwise: goss's selected rows (the count weights each tree is built
with) and dart's drops (which trees ``scale_trees`` rescales, by what
factor) are recorded in both packages and compared, iteration by
iteration. The quality guards and refusals of
``tests/test_gbdt_boosting.py`` run on the port too.

Binary gradients differ between the two frameworks by an ulp (sigmoid),
so the binary cases use ``test_torch_gbdt.make_data``, whose splits are
not near-ties; regression (L2) gradients are exact."""

import importlib

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.models.gbdt import estimators as jest
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.objectives import get_metric
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.models.gbdt import Booster as PBooster
from mmlspark_tpu_torch.models.gbdt import estimators as pest
from mmlspark_tpu_torch.models.gbdt import train as ptrain
from test_torch_gbdt import _same_predictions, _same_trees, make_data

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

# the train modules (the port package's ``train`` attribute is the
# function)
jtrain_mod = importlib.import_module("mmlspark_tpu.models.gbdt.train")
ptrain_mod = importlib.import_module("mmlspark_tpu_torch.models.gbdt.train")

BASE = {"num_iterations": 8, "num_leaves": 8, "max_bin": 64,
        "min_data_in_leaf": 5, "seed": 3}

MODES = {
    "goss": {"boosting": "goss"},
    "goss_rates": {"boosting_type": "goss", "top_rate": 0.3,
                   "other_rate": 0.15},
    "dart": {"boosting": "dart", "skip_drop": 0.0, "drop_rate": 0.5},
    "dart_defaults": {"boosting": "dart"},
    "dart_max_drop": {"boosting": "dart", "skip_drop": 0.0,
                      "drop_rate": 0.9, "max_drop": 2},
    "rf": {"boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1,
           "feature_fraction": 0.7},
    "random_forest": {"boosting_type": "random_forest",
                      "bagging_fraction": 0.632, "bagging_freq": 1},
}


def _data(objective, n=2000, seed=0):
    X, y, logit = make_data(n=n, seed=seed)
    if objective == "regression":
        return X, logit + np.random.default_rng(seed + 1).normal(0, 0.3, n)
    if objective == "multiclass":
        return X, (np.digitize(logit, [-1.0, 1.0])).astype(np.float64)
    return X, y


def _params(objective, mode):
    p = {**BASE, "objective": objective, **MODES[mode]}
    if objective == "multiclass":
        p["num_class"] = 3
    return p


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("objective", ["binary", "regression", "multiclass"])
def test_train_matches_reference(objective, mode):
    X, y = _data(objective)
    p = _params(objective, mode)
    bj, bp = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)
    if "goss" in mode:
        assert set(bp.phase_seconds) >= {"goss_d2h", "goss_select"}


def _spy_builds(monkeypatch, module, store, to_np):
    """Record each tree build's count weights (goss's selected rows)."""
    real = module.build_tree

    def spy(*args, **kw):
        store.append(to_np(args[3]))
        return real(*args, **kw)
    monkeypatch.setattr(module, "build_tree", spy)


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("mode", ["goss", "goss_rates"])
def test_goss_selection_bitwise(monkeypatch, objective, mode):
    """The rows goss selects each iteration (the same argpartition and
    rng.choice on the host) are bitwise the JAX package's, and the count
    channel is never amplified."""
    X, y = _data(objective)
    p = _params(objective, mode)
    js, ps = [], []
    _spy_builds(monkeypatch, jtrain_mod, js, np.asarray)
    _spy_builds(monkeypatch, ptrain_mod, ps, lambda t: t.numpy())
    jtrain(p, X, y)
    ptrain(p, X, y, device="cpu")
    assert len(js) == len(ps) == p["num_iterations"]
    for a, b in zip(js, ps):
        np.testing.assert_array_equal(b, a)
        assert set(np.unique(b)) <= {0.0, 1.0}
    a, b = p.get("top_rate", 0.2), p.get("other_rate", 0.1)
    assert ps[0].sum() == np.ceil(a * len(y)) + np.ceil(b * len(y))


def _spy_scales(monkeypatch, cls, store):
    real = cls.scale_trees

    def spy(self, idx, factor):
        store.append((np.asarray(idx).tolist(), float(factor)))
        return real(self, idx, factor)
    monkeypatch.setattr(cls, "scale_trees", spy)


@pytest.mark.parametrize("objective", ["binary", "regression",
                                       "multiclass"])
@pytest.mark.parametrize("mode", ["dart", "dart_defaults",
                                  "dart_max_drop"])
def test_dart_drops_bitwise(monkeypatch, objective, mode):
    """dart's drops (trees and k / (k + 1) factors, iteration by
    iteration) are the JAX package's: the same draws from the one rng
    stream, in the same order."""
    X, y = _data(objective, n=800)
    p = {**_params(objective, mode), "num_iterations": 12}
    js, ps = [], []
    _spy_scales(monkeypatch, JBooster, js)
    _spy_scales(monkeypatch, PBooster, ps)
    bj, bp = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    assert ps == js
    if mode != "dart_defaults":
        assert ps, "no iteration dropped"
    _same_trees(bj, bp)


# -- the quality guards of tests/test_gbdt_boosting.py ------------------------

def _binary(n=1200, f=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    logit = X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (logit + rng.normal(0, 0.5, n) > 0).astype(np.float64)
    return X, y


def _auc(y, p):
    return get_metric("auc", "binary")[1][0](y, p, np.ones(len(y)))


GUARD = {"objective": "binary", "num_iterations": 30, "num_leaves": 15,
         "learning_rate": 0.1, "min_data_in_leaf": 5, "seed": 3}


@pytest.mark.parametrize("mode", ["goss", "dart", "rf"])
def test_quality_close_to_gbdt(mode):
    X, y = _binary()
    extra = MODES[mode] if mode != "rf" else {
        "boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1,
        "feature_fraction": 0.7}
    auc_gbdt = _auc(y, ptrain(GUARD, X, y, device="cpu").predict(X))
    b = ptrain({**GUARD, **extra}, X, y, device="cpu")
    auc = _auc(y, b.predict(X))
    assert auc > 0.85
    if mode == "goss":
        assert abs(auc_gbdt - auc) < 0.05
    if mode == "rf":
        # the 1/T average: raw scores stay in one tree's range
        assert b.num_trees == GUARD["num_iterations"]
        assert np.abs(b.predict(X, raw_score=True)).max() < 5.0


def test_dart_rescales_trees():
    X, y = _binary(n=500)
    b = ptrain({**GUARD, "num_iterations": 10, "boosting": "dart",
                "skip_drop": 0.0, "drop_rate": 0.9}, X, y, device="cpu")
    g = ptrain({**GUARD, "num_iterations": 10}, X, y, device="cpu")
    assert b.num_trees == 10
    assert np.abs(b.leaf_values).max() < np.abs(g.leaf_values).max() + 1e-6


def test_dart_string_round_trip_bitwise():
    X, y = _binary(n=400)
    b = ptrain({**GUARD, "num_iterations": 8, "boosting": "dart",
                "skip_drop": 0.0}, X, y, device="cpu")
    s = b.to_string()
    np.testing.assert_array_equal(
        PBooster.from_string(s, device="cpu").predict(X), b.predict(X))
    # and across the packages
    np.testing.assert_allclose(np.asarray(JBooster.from_string(s).predict(X)),
                               b.predict(X), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("patience,iters", [(50, 30), (5, 60)])
def test_dart_early_stopping_returns_best_snapshot(patience, iters):
    """With early stopping, dart returns the best iteration's snapshot
    (later drops rescale earlier trees): its metric is the best logged
    one, and the run equals the JAX package's (log, trees)."""
    X, y = _data("regression", n=800)
    Xv, yv = _data("regression", n=300, seed=1)
    p = {**_params("regression", "dart"), "num_iterations": iters,
         "early_stopping_round": patience, "metric": "l2"}
    jlog, plog = [], []
    bj = jtrain(p, X, y, valid_sets=[(Xv, yv)], eval_log=jlog)
    bp = ptrain(p, X, y, valid_sets=[(Xv, yv)], eval_log=plog, device="cpu")
    assert [e["iteration"] for e in plog] == [e["iteration"] for e in jlog]
    np.testing.assert_allclose([e["l2"] for e in plog],
                               [e["l2"] for e in jlog], rtol=1e-5)
    l2 = get_metric("l2", "regression")[1][0](yv, bp.predict(Xv),
                                               np.ones(len(yv)))
    assert abs(l2 - min(e["l2"] for e in plog)) < 1e-9
    _same_trees(bj, bp)


def test_goss_counts_not_amplified():
    X, y = _binary(n=1000)
    b = ptrain({**GUARD, "num_iterations": 3, "boosting": "goss"}, X, y,
               device="cpu")
    selected = int(np.ceil(0.2 * 1000) + np.ceil(0.1 * 1000))
    assert b.covers[0][0] <= selected + 1


def test_goss_multiclass_accuracy():
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (600, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(int) + (X[:, 2] > 0.5)
    b = ptrain({"objective": "multiclass", "num_class": 3,
                "num_iterations": 10, "boosting": "goss",
                "min_data_in_leaf": 5, "seed": 0}, X, y.astype(float),
               device="cpu")
    pred = b.predict(X)
    assert pred.shape == (600, 3)
    assert (pred.argmax(1) == y).mean() > 0.7


def test_dart_warm_start_leaves_caller_untouched():
    X, y = _binary(n=500)
    p = {**GUARD, "num_iterations": 10}
    b0 = ptrain(p, X, y, device="cpu")
    before = b0.predict(X).copy()
    b1 = ptrain({**p, "boosting": "dart", "skip_drop": 0.0,
                 "drop_rate": 0.9}, X, y, init_model=b0, device="cpu")
    np.testing.assert_array_equal(b0.predict(X), before)
    assert b1.num_trees == 20


def test_estimator_boosting_type_matches_reference():
    X, y = _binary(n=300, f=5)
    cols = {"features": X, "label": y}
    kw = dict(num_iterations=5, boosting_type="goss", min_data_in_leaf=5)
    mj = jest.LightGBMClassifier(**kw).fit(JDataFrame(cols))
    mp = pest.LightGBMClassifier(device="cpu", **kw).fit(DataFrame(cols))
    np.testing.assert_array_equal(mp.booster.feats, mj.booster.feats)
    np.testing.assert_array_equal(
        np.asarray(mp.transform(DataFrame(cols))["prediction"]),
        np.asarray(mj.transform(JDataFrame(cols))["prediction"]))


# -- refusals: the JAX package's, raised the same way --------------------------

REFUSALS = {
    "rf_without_bagging": ({"boosting": "rf"}, "bagging"),
    "rf_half_bagging": ({"boosting": "rf", "bagging_freq": 1}, "bagging"),
    "rf_early_stopping": ({"boosting": "rf", "bagging_fraction": 0.6,
                           "bagging_freq": 1, "early_stopping_round": 5},
                          "early stopping"),
    "rf_warm_start": ({"boosting": "rf", "bagging_fraction": 0.6,
                       "bagging_freq": 1}, "warm-start"),
    "goss_with_bagging": ({"boosting": "goss", "bagging_freq": 1,
                           "bagging_fraction": 0.5}, "GOSS"),
    "unknown_boosting": ({"boosting": "nope"}, "boosting must be"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_reference(case):
    X, y = _binary(n=200)
    extra, match = REFUSALS[case]
    p = {**GUARD, "num_iterations": 2, **extra}
    jkw = pkw = {}
    if case == "rf_warm_start":
        jkw = {"init_model": jtrain({**GUARD, "num_iterations": 2}, X, y)}
        pkw = {"init_model": ptrain({**GUARD, "num_iterations": 2}, X, y,
                                    device="cpu")}
    with pytest.raises(ValueError, match=match):
        jtrain(p, X, y, **jkw)
    with pytest.raises(ValueError, match=match):
        ptrain(p, X, y, device="cpu", **pkw)
