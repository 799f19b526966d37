"""The port's GBDT estimators (``mmlspark_tpu_torch/models/gbdt/
estimators.py``) against the JAX package's on the same ``DataFrame``
columns, on the CPU (``device="cpu"``): binary, multiclass and
regression fits give identical prediction columns, probabilities and raw
scores within rtol 1e-5 / atol 1e-6 (the ``train()`` parity tests'
prediction tolerance), and the same ``feature_importances``; the
validation column drives early stopping as it does there; save/load
goes through the port's serializer and predicts the same in a fresh
process; every option the port leaves out raises
``NotImplementedError`` naming its ROADMAP.md item, and the boosting
modes and options ported since fit as the JAX estimator's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.models.gbdt import estimators as jest
from mmlspark_tpu_torch.core import DataFrame, Pipeline
from mmlspark_tpu_torch.core.schema import get_label_metadata
from mmlspark_tpu_torch.models.gbdt import estimators as pest

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"num_iterations": 6, "num_leaves": 8, "max_bin": 32,
         "min_data_in_leaf": 5}


def _data(n=800, f=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    cols = {"features": X,
            "binary": (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64),
            "classes": np.argmax(X[:, :3] + 0.3 * rng.normal(size=(n, 3)),
                                 axis=1).astype(np.float64),
            "target": (2 * X[:, 0] - X[:, 1] * X[:, 2]).astype(np.float64),
            "weight": rng.uniform(0.5, 2.0, n),
            "is_valid": rng.random(n) < 0.25}
    return cols


def _fit_both(jcls, pcls, cols, **params):
    mj = jcls(**params).fit(JDataFrame(cols))
    mp = pcls(device="cpu", **params).fit(DataFrame(cols))
    return mj, mp, mj.transform(JDataFrame(cols)), mp.transform(
        DataFrame(cols))


def _stack(col):
    return np.stack(list(col)).astype(np.float64)


def _same_columns(oj, op, vector_cols, exact_cols):
    assert op.columns == oj.columns
    for c in exact_cols:
        a, b = np.asarray(op[c]), np.asarray(oj[c])
        if a.dtype == object:
            a, b = _stack(a), _stack(b)
        np.testing.assert_array_equal(a, b)
    for c in vector_cols:
        np.testing.assert_allclose(_stack(op[c]), _stack(oj[c]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("label,k", [("binary", 2), ("classes", 3)])
def test_classifier_matches_reference(label, k):
    cols = _data()
    mj, mp, oj, op = _fit_both(jest.LightGBMClassifier,
                               pest.LightGBMClassifier, cols,
                               label_col=label, weight_col="weight",
                               leaf_prediction_col="leaves", **SMALL)
    _same_columns(oj, op, ["probability", "rawPrediction"],
                  ["prediction", "leaves"])
    assert _stack(op["probability"]).shape == (800, k)
    np.testing.assert_allclose(_stack(op["probability"]).sum(1), 1,
                               atol=1e-6)
    assert get_label_metadata(op, "prediction") == {"num_classes": k}
    assert mp.booster.num_class == (k if k > 2 else 1)
    assert mp.booster.device.type == "cpu"
    np.testing.assert_array_equal(mp.booster.feats, mj.booster.feats)
    for kind in ("split", "gain"):
        np.testing.assert_allclose(mp.feature_importances(kind),
                                   mj.feature_importances(kind), rtol=1e-5)


def test_multiclass_objective_and_early_stopping_match_reference():
    """``objective="multiclass"`` with a validation column: the same
    early-stopped model (iterations counted, trees class-major)."""
    cols = _data(seed=1)
    params = {**SMALL, "num_iterations": 40, "learning_rate": 0.5,
              "early_stopping_round": 2}
    mj, mp, oj, op = _fit_both(jest.LightGBMClassifier,
                               pest.LightGBMClassifier, cols,
                               label_col="classes", objective="multiclass",
                               validation_indicator_col="is_valid", **params)
    assert mp.booster.num_trees == mj.booster.num_trees < 40 * 3
    assert mp.booster.best_iteration == mj.booster.best_iteration
    np.testing.assert_array_equal(mp.booster.feats, mj.booster.feats)
    np.testing.assert_array_equal(mp.booster.thr_raw, mj.booster.thr_raw)
    _same_columns(oj, op, ["probability", "rawPrediction"], ["prediction"])


def test_regressor_matches_reference():
    cols = _data(seed=2)
    for objective in ("regression", "huber"):
        mj, mp, oj, op = _fit_both(jest.LightGBMRegressor,
                                   pest.LightGBMRegressor, cols,
                                   label_col="target", objective=objective,
                                   alpha=0.7, **SMALL)
        assert op.columns == oj.columns
        np.testing.assert_allclose(op["prediction"], oj["prediction"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mp.feature_importances("gain"),
                                   mj.feature_importances("gain"), rtol=1e-5)


def test_estimator_in_a_pipeline_and_param_overrides():
    cols = _data(seed=3)
    model = Pipeline([pest.LightGBMClassifier(device="cpu",
                                              label_col="binary", **SMALL)]
                     ).fit(DataFrame(cols))
    out = model.transform(DataFrame({"features": cols["features"]}))
    assert out.columns == ["features", "rawPrediction", "probability",
                           "prediction"]
    est = pest.LightGBMClassifier(device="cpu", label_col="binary", **SMALL)
    three = est.fit(DataFrame(cols), {"num_iterations": 3})
    assert three.booster.num_trees == 3 and est.num_iterations == 6
    assert three.device.type == "cpu"


SAVED_CHECK = """
import json, sys
import numpy as np
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.models.gbdt.estimators import {cls}
m = {cls}.load(sys.argv[1], device="cpu")
X = np.load(sys.argv[2])
out = m.transform(DataFrame({{"features": X}}))
print(json.dumps([np.asarray(out["prediction"]).tolist(),
                  np.stack(list(out["{col}"])).astype(float)
                  .reshape(len(X), -1).tolist(),
                  m.feature_importances().tolist()]))
"""


@pytest.mark.parametrize("cls,label,col", [
    ("LightGBMClassificationModel", "classes", "probability"),
    ("LightGBMRegressionModel", "target", "prediction")])
def test_save_load_in_a_fresh_process(tmp_path, cls, label, col):
    cols = _data(seed=4)
    est = (pest.LightGBMClassifier if label == "classes"
           else pest.LightGBMRegressor)(device="cpu", label_col=label,
                                        **SMALL)
    model = est.fit(DataFrame(cols))
    model.save(str(tmp_path / "model"))
    np.save(tmp_path / "X.npy", cols["features"])
    out = model.transform(DataFrame({"features": cols["features"]}))
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(ROOT),
           "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run(
        [sys.executable, "-c", SAVED_CHECK.format(cls=cls, col=col),
         str(tmp_path / "model"), str(tmp_path / "X.npy")],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    pred, vals, imp = json.loads(proc.stdout.strip().splitlines()[-1])
    np.testing.assert_array_equal(pred, np.asarray(out["prediction"]))
    want = (_stack(out[col]) if col == "probability"
            else np.asarray(out[col])[:, None])
    np.testing.assert_array_equal(np.asarray(vals).reshape(want.shape), want)
    np.testing.assert_array_equal(imp, model.feature_importances())
    # the port's loader refuses a stage the JAX package saved
    mj = jest.LightGBMRegressor(label_col="target", **SMALL).fit(
        JDataFrame(cols))
    mj.save(str(tmp_path / "jax_model"))
    with pytest.raises(ValueError, match="refusing"):
        pest.LightGBMRegressionModel.load(str(tmp_path / "jax_model"),
                                          device="cpu")


UNPORTED = {
    "parallelism": ({"parallelism": "data_parallel"}, "31"),
    "categorical": ({"categorical_feature": [0]}, "17"),
    "goss": ({"boosting_type": "goss"}, "14"),
    "linear_tree": ({"linear_tree": True}, "19"),
    "monotone": ({"monotone_constraints": [1, 0, 0, 0, 0]}, "16"),
}


#: cases of UNPORTED that fit now (ROADMAP items 14, 16, 17
#: and 19)
PORTED_SINCE = {"categorical", "goss", "linear_tree", "monotone"}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_options_raise_at_fit(case):
    """An option outside the port raises naming its ROADMAP item at
    ``fit``; the ones ported since fit as the JAX estimator does (the
    same columns)."""
    params, item = UNPORTED[case]
    if case in PORTED_SINCE:
        cols = _data()
        if case == "categorical":
            cols["features"][:, 0] = np.floor(np.abs(cols["features"][:, 0])
                                              * 4)
        mj, mp, oj, op = _fit_both(jest.LightGBMClassifier,
                                   pest.LightGBMClassifier, cols,
                                   label_col="binary", weight_col="weight",
                                   **{**SMALL, **params})
        _same_columns(oj, op, ["probability", "rawPrediction"],
                      ["prediction"])
        np.testing.assert_array_equal(mp.booster.feats, mj.booster.feats)
        return
    est = pest.LightGBMClassifier(device="cpu", label_col="binary",
                                  **{**SMALL, **params})
    with pytest.raises(NotImplementedError, match=f"queue item {item}\\b"):
        est.fit(DataFrame(_data(n=60)))


def test_unported_model_options_raise_at_transform():
    """``LightGBMRanker`` (once refused) fits lambdarank over the query
    runs of ``group`` as the JAX ranker does: the same trees and raw-score
    predictions."""
    cols = _data(n=200, seed=5)
    cols["group"] = np.repeat(np.arange(20), 10)
    cols["relevance"] = np.clip(np.round(cols["target"]), 0, 3)
    mj, mp, oj, op = _fit_both(jest.LightGBMRanker, pest.LightGBMRanker,
                               cols, label_col="relevance", **SMALL)
    _same_columns(oj, op, [], [])
    np.testing.assert_array_equal(mp.booster.feats, mj.booster.feats)
    np.testing.assert_allclose(np.asarray(op["prediction"]),
                               np.asarray(oj["prediction"]), rtol=1e-5,
                               atol=1e-6)


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: pest.LightGBMClassifier(),
                 lambda: pest.LightGBMRegressor(device=None),
                 lambda: pest.LightGBMClassificationModel()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = pest.LightGBMRegressor(device="cpu", label_col="target",
                                   **SMALL).fit(DataFrame(_data(n=100)))
    with pytest.raises(RuntimeError, match="CUDA"):
        pest.LightGBMRegressionModel(model.booster)
