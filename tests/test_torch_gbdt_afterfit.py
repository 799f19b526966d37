"""The port's GBDT features after ``fit`` against the JAX package on the
CPU, on the same model strings and seeded data: TreeSHAP
(``Booster.shap_values``, ``features_shap_col``), ``booster_to_onnx``,
``Booster.refit``, ``Booster.trees_to_dataframe``, the warm start
(``train(init_model=)``, the estimators' ``model_string``) and the
starting margin (``init_score``, ``valid_init_scores``,
``init_score_col``).

Tolerances: SHAP values within 1e-6 · max|phi| of the JAX numpy version,
and additive (sum of phi and the expected value equal to ``raw_score``
within 1e-5 · (1 + |margin|)); exported graphs equal with node names
excluded; refit leaves within 1e-6 · max|leaf|, structures bitwise;
``trees_to_dataframe`` columns equal, NaN in the same places; warm-start
and ``init_score`` trees as ``tests/test_torch_gbdt.py``'s
``test_train_*_matches_reference`` hold them (split features, bins and
covers bitwise, leaves within rtol 1e-5 / atol 1e-7).

Two JAX departures are pinned (ROADMAP.md §3): a JAX warm start appends
to the caller's init model (the port appends to a copy), and without
``valid_sets`` it sets ``best_iteration`` to the new iterations only, so
its ``predict`` drops the new trees (the port counts the init model's
iterations too, as the JAX package does with ``valid_sets``)."""


import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.models.gbdt import estimators as jest
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.onnx_export import booster_to_onnx as jexport
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu.onnx import convert_model as jconvert
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.models.gbdt import Booster as PBooster
from mmlspark_tpu_torch.models.gbdt import estimators as pest
from mmlspark_tpu_torch.models.gbdt import train as ptrain
from mmlspark_tpu_torch.models.gbdt.onnx_export import booster_to_onnx
from mmlspark_tpu_torch.onnx import convert_model as pconvert
from mmlspark_tpu_torch.onnx import parse_model

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

BASE = {"num_iterations": 8, "num_leaves": 8, "max_bin": 32,
        "min_data_in_leaf": 5}


def _data(n=600, f=6, seed=0, kind="binary", nan=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f))
    logit = X[:, 0] * 2 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    if kind == "binary":
        y = (logit + rng.normal(0, 0.3, n) > 0).astype(np.float64)
    elif kind == "multiclass":
        y = np.argmax(X[:, :3] + 0.3 * rng.normal(size=(n, 3)),
                      axis=1).astype(np.float64)
    else:
        y = logit + 3.0 + rng.normal(0, 0.1, n)
    if nan:
        X[::7, 0] = np.nan
        X[3::11, 2] = np.nan
    return X, y


def _params(kind, **kw):
    p = {**BASE, "objective": {"binary": "binary", "regression": "regression",
                               "multiclass": "multiclass"}[kind]}
    if kind == "multiclass":
        p["num_class"] = 3
    return {**p, **kw}


def _pair(kind, seed=0, nan=False, **kw):
    """A JAX-trained booster and the port's copy of it (the model
    string), with the data."""
    X, y = _data(seed=seed, kind=kind, nan=nan)
    bj = jtrain(_params(kind, **kw), X, y)
    return bj, PBooster.from_string(bj.to_string(), device="cpu"), X, y


def _same_trees(bj, bp, best_iteration=True):
    assert bp.num_trees == bj.num_trees and bp.depth == bj.depth
    assert bp.base_score == bj.base_score
    if best_iteration:
        assert bp.best_iteration == bj.best_iteration
    np.testing.assert_array_equal(bp.feats, bj.feats)
    np.testing.assert_array_equal(bp.thr_raw, bj.thr_raw)
    np.testing.assert_allclose(bp.leaf_values, bj.leaf_values, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(bp.gains, bj.gains, rtol=1e-5,
                               atol=1e-6 * np.abs(bj.gains).max())
    np.testing.assert_array_equal(bp.covers, bj.covers)


# -- TreeSHAP ----------------------------------------------------------------

def _hold_shap(bj, bp, X):
    got, want = bp.shap_values(X), bj.shap_values(X)
    assert got.shape == want.shape and got.dtype == np.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    # additivity: the contributions and the expected value sum to the
    # margin of every row (every class of a multiclass model)
    raw = bp.raw_score(X, num_iteration=0).astype(np.float64)
    total = got.astype(np.float64).sum(axis=-1)
    total = total.T if total.ndim == 2 else total
    np.testing.assert_allclose(total, raw, rtol=0,
                               atol=1e-5 * (1 + np.abs(raw)).max())
    return got


@pytest.mark.parametrize("kind,nan", [("binary", False), ("binary", True),
                                      ("regression", False),
                                      ("regression", True),
                                      ("multiclass", False),
                                      ("multiclass", True)])
def test_shap_values_match_reference(kind, nan):
    bj, bp, X, _ = _pair(kind, seed=1, nan=nan)
    got = _hold_shap(bj, bp, X[:200])
    F = X.shape[1]
    assert got.shape == ((3, 200, F + 1) if kind == "multiclass"
                         else (200, F + 1))


def test_shap_values_on_stub_nodes():
    """Few rows and a large ``min_data_in_leaf`` leave stub nodes (feat
    < 0), which the recursion treats as leaves."""
    bj, bp, X, _ = _pair("binary", seed=2, num_leaves=31,
                         min_data_in_leaf=60)
    assert (bp.feats < 0).any()
    _hold_shap(bj, bp, X[:150])


def test_shap_values_on_edited_covers():
    """Hand-edited covers reach the rarer branches of both recursions: a
    zero zero-fraction (a child of cover 0) and a node of cover 0 (its
    subtree skipped); deep trees repeat features on a path (UNWIND)."""
    bj, bp, X, _ = _pair("regression", seed=3, num_leaves=32,
                         min_data_in_leaf=3, num_iterations=4)
    cov = bj.covers.copy()
    cov[0, 1] = 0.0                  # tree 0: the root's left child
    cov[1, 2] = 0.0                  # tree 1: the root's right child
    cov[2, 4] = 0.0
    edited = JBooster(bj.depth, bj.n_features, bj.objective, bj.base_score,
                      1, bj.feats, bj.thr_raw, bj.leaf_values, bj.gains, cov)
    pe = PBooster.from_string(edited.to_string(), device="cpu")
    got, want = pe.shap_values(X[:100]), edited.shap_values(X[:100])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert any(len(set(f[f >= 0].tolist())) < (f >= 0).sum()
               for f in bp.feats)


@pytest.mark.parametrize("budget", [1 << 12, 1 << 8])
def test_shap_groups_and_row_chunks_agree(budget):
    """A small budget splits the trees into groups (and, at the smallest,
    the rows into chunks); the values do not move beyond rounding."""
    import torch
    from mmlspark_tpu_torch.models.gbdt.treeshap import shap_trees
    bj, bp, X, _ = _pair("multiclass", seed=27)
    Xd = torch.from_numpy(X[:64].astype(np.float32))
    args = (bp.feats, bp.thr_raw, bp.leaf_values, bp.covers, bp.depth,
            bp.num_class, bp.base_score, Xd)
    whole, split = shap_trees(*args), shap_trees(*args, budget=budget)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=0,
                               atol=1e-12 * float(whole.abs().max()))
    np.testing.assert_allclose(whole.float().numpy(),
                               bj.shap_values(X[:64]), rtol=0,
                               atol=1e-6 * float(whole.abs().max()))


def test_shap_values_sparse_input():
    bj, bp, X, _ = _pair("binary", seed=4)
    Xs = X[:120].copy()
    Xs[np.abs(Xs) < 0.8] = 0.0
    got = bp.shap_values(sp.csr_matrix(Xs))
    np.testing.assert_allclose(got, bj.shap_values(sp.csr_matrix(Xs)),
                               rtol=0, atol=1e-6 * np.abs(got).max())


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_scoring_sparse_and_empty_input(kind, monkeypatch):
    """Scipy-sparse X crosses to the device in chunks of ``SPARSE_ROWS``
    rows (made small here, so 120 rows take three), dense X in one pass;
    both score as the JAX package does, zero rows included."""
    from mmlspark_tpu_torch.models.gbdt import trees
    monkeypatch.setattr(trees, "SPARSE_ROWS", 50)
    bj, bp, X, _ = _pair(kind, seed=5)
    Xs = X[:120].copy()
    Xs[np.abs(Xs) < 0.8] = 0.0
    for x in (Xs, sp.csr_matrix(Xs), Xs[:0], sp.csr_matrix(Xs[:0])):
        np.testing.assert_allclose(bp.raw_score(x), bj.raw_score(x),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(bp.predict_leaf(x),
                                      np.asarray(bj.predict_leaf(x)))
        got, want = bp.shap_values(x), bj.shap_values(x)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * (np.abs(want).max(initial=0)))


def test_features_shap_col_matches_reference():
    """``features_shap_col`` on both model classes over the same model
    string; a multiclass model concatenates its classes per row."""
    X, y = _data(n=300, f=4, seed=12, kind="regression")
    cols = {"features": X.astype(np.float32), "label": y}
    mj = jest.LightGBMRegressor(num_iterations=6, num_leaves=8,
                                min_data_in_leaf=5,
                                features_shap_col="shap").fit(
        JDataFrame(cols))
    mp = pest.LightGBMRegressionModel(
        PBooster.from_string(mj.booster.to_string(), device="cpu"),
        device="cpu", features_shap_col="shap")
    a = np.stack(list(mp.transform(DataFrame(cols))["shap"]))
    b = np.stack(list(mj.transform(JDataFrame(cols))["shap"]))
    assert a.shape == (300, 5)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())

    Xm, ym = _data(n=300, f=4, seed=13, kind="multiclass")
    cols = {"features": Xm.astype(np.float32), "label": ym}
    mj = jest.LightGBMClassifier(num_iterations=3, num_leaves=8,
                                 features_shap_col="shap").fit(
        JDataFrame(cols))
    mp = pest.LightGBMClassificationModel(
        PBooster.from_string(mj.booster.to_string(), device="cpu"),
        device="cpu", features_shap_col="shap", num_classes=3)
    a = np.stack(list(mp.transform(DataFrame(cols))["shap"]))
    b = np.stack(list(mj.transform(JDataFrame(cols))["shap"]))
    assert a.shape == (300, 15)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())


# -- ONNX export -------------------------------------------------------------

def _graph_without_names(data):
    m = parse_model(data)
    for node in m.graph.nodes:
        node.name = ""
    return m


@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
def test_booster_to_onnx_matches_reference(kind):
    bj, bp, X, _ = _pair(kind, seed=5)
    mine, theirs = booster_to_onnx(bp), jexport(bj)
    assert _graph_without_names(mine) == _graph_without_names(theirs)
    Xq = X[:50].astype(np.float32)
    Xq[::4, 1] = np.nan
    out = "variable" if kind == "regression" else "probabilities"
    import torch
    pm = pconvert(theirs)
    got = pm({}, {"features": torch.from_numpy(Xq)})[out].numpy()
    jm = jconvert(mine)
    want = np.asarray(jm(jm.params, {"features": Xq})[out])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max() + 1e-6)


def test_booster_to_onnx_refusals():
    bj, bp, _, _ = _pair("binary", seed=6, num_iterations=2)
    lin = bj.truncated(2)
    lin._lin_base = {"coefs": np.zeros((2, 8, 4), np.float32),
                     "pf": np.zeros((2, 8, 3), np.int32)}
    for export in (booster_to_onnx, jexport):
        with pytest.raises(ValueError, match="linear"):
            export(lin)
    cat = bj.truncated(2)
    cat.cat_encoder = object()
    for export in (booster_to_onnx, jexport):
        with pytest.raises(ValueError, match="categorical"):
            export(cat)


# -- refit -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
@pytest.mark.parametrize("decay", [0.0, 0.9, 1.0])
def test_refit_matches_reference(kind, decay):
    bj, bp, X, y = _pair(kind, seed=7)
    Xn, yn = _data(n=400, seed=8, kind=kind)
    if kind == "binary":
        yn = 1.0 - yn                          # an adversarial shift
    rj, rp = bj.refit(Xn, yn, decay_rate=decay), \
        bp.refit(Xn, yn, decay_rate=decay)
    for name in ("feats", "thr_raw", "gains", "covers"):
        np.testing.assert_array_equal(getattr(rp, name), getattr(bp, name))
    assert rp.leaf_values.dtype == np.float32
    np.testing.assert_allclose(rp.leaf_values, rj.leaf_values, rtol=0,
                               atol=1e-6 * np.abs(rj.leaf_values).max())
    assert rp.fit_params == bp.fit_params and rp.device.type == "cpu"
    if decay == 1.0:
        np.testing.assert_array_equal(rp.leaf_values, bp.leaf_values)
    elif kind == "multiclass":
        # tree t moves class t % K only
        t = np.arange(rp.num_trees)
        other = np.ones(rp.leaf_values.shape[:2], bool)
        other[t, t % 3] = False
        assert (rp.leaf_values[other] == 0).all()


def test_refit_options_match_reference():
    bj, bp, X, y = _pair("regression", seed=9)
    w = np.random.default_rng(10).uniform(0.2, 2.0, 300)
    kw = dict(decay_rate=0.3, learning_rate=0.05, lam=2.0,
              sample_weight=w)
    rj, rp = bj.refit(X[:300], y[:300] + 1.0, **kw), \
        bp.refit(X[:300], y[:300] + 1.0, **kw)
    np.testing.assert_allclose(rp.leaf_values, rj.leaf_values, rtol=0,
                               atol=1e-6 * np.abs(rj.leaf_values).max())
    # a leaf no refit row reaches keeps its value
    few = bp.refit(X[:3], y[:3], decay_rate=0.0)
    reached = np.zeros(bp.leaf_values.shape, bool)
    leaves = bp.predict_leaf(X[:3])
    for t in range(bp.num_trees):
        reached[t, leaves[:, t]] = True
    np.testing.assert_array_equal(few.leaf_values[~reached],
                                  bp.leaf_values[~reached])
    for b in (bj, bp):
        with pytest.raises(ValueError, match="decay_rate"):
            b.refit(X, y, decay_rate=1.5)


# -- trees_to_dataframe ------------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_trees_to_dataframe_matches_reference(kind):
    bj, bp, _, _ = _pair(kind, seed=11, num_leaves=31, min_data_in_leaf=40)
    assert (bp.feats < 0).any()                # stub rows present
    dj, dp = bj.trees_to_dataframe(), bp.trees_to_dataframe()
    assert list(dp.columns) == list(dj.columns) and len(dp) == len(dj)
    for c in dj.columns:
        a, b = np.asarray(dp[c]), np.asarray(dj[c])
        assert a.dtype == b.dtype, c
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), c)
        np.testing.assert_array_equal(a, b, c)
    K = 3 if kind == "multiclass" else 1
    n_int, n_leaf = bp.feats.shape[1], 2 ** bp.depth
    assert len(dp) == bp.num_trees * (n_int + K * n_leaf)


# -- warm start --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "regression", "multiclass"])
def test_warm_start_matches_reference(kind):
    """``train(init_model=)`` on the fused path: the same trees as the
    JAX package's continuation of the same model (its model string: two
    fits agree only to rounding, and a continuation would carry that on)."""
    X, y = _data(seed=14, kind=kind)
    p1 = _params(kind)
    p2 = _params(kind, num_iterations=5)
    bj1 = jtrain(p1, X, y)
    bp1 = PBooster.from_string(bj1.to_string(), device="cpu")
    n1 = bp1.num_trees
    bj2 = jtrain(p2, X, y, init_model=bj1)
    bp2 = ptrain(p2, X, y, init_model=bp1, device="cpu")
    _same_trees(bj2, bp2, best_iteration=False)
    K = 3 if kind == "multiclass" else 1
    assert bp2.num_trees == n1 + 5 * K
    np.testing.assert_array_equal(bp2.feats[:n1], bp1.feats)
    np.testing.assert_array_equal(bp2.leaf_values[:n1], bp1.leaf_values)
    # the port leaves the caller's model as it was; JAX appends to it
    assert bp1.num_trees == n1 and bj1 is bj2
    # absolute iterations: the port's predict uses every tree; the JAX
    # package's (n_iter only) drops the new ones
    assert bp2.best_iteration == 8 + 5 and bj2.best_iteration == 5
    np.testing.assert_allclose(bp2.predict(X),
                               np.asarray(bj2.predict(X, num_iteration=0)),
                               rtol=1e-5, atol=1e-6)
    assert bp2.fit_params == {"learning_rate": 0.1, "lambda_l2": 0.0}


def test_warm_start_from_a_reference_model_string():
    X, y = _data(seed=15)
    s = jtrain(_params("binary"), X, y).to_string()
    p2 = _params("binary", num_iterations=4)
    bj = jtrain(p2, X, y, init_model=JBooster.from_string(s))
    bp = ptrain(p2, X, y, init_model=PBooster.from_string(s, device="cpu"),
                device="cpu")
    _same_trees(bj, bp, best_iteration=False)


def test_warm_start_early_stopping_keeps_init_trees():
    """The general path: validation scores start from the init model's,
    early stopping truncates after the init trees, and best_iteration
    counts them (as in the JAX package)."""
    X, y = _data(n=800, seed=16)
    b1p = ptrain(_params("binary", num_iterations=15), X[:500], y[:500],
                 device="cpu")
    b1j = JBooster.from_string(b1p.to_string())
    p2 = _params("binary", num_iterations=100, learning_rate=0.3,
                 early_stopping_round=3)
    logs = ([], [])
    bj = jtrain(p2, X[:500], y[:500], init_model=b1j,
                valid_sets=[(X[500:], y[500:])], eval_log=logs[0])
    bp = ptrain(p2, X[:500], y[:500], init_model=b1p,
                valid_sets=[(X[500:], y[500:])], eval_log=logs[1],
                device="cpu")
    assert bp.num_trees < 15 + 100 and bp.num_trees >= 15
    _same_trees(bj, bp)
    for a, b in zip(*logs):
        np.testing.assert_allclose(b["binary_logloss"], a["binary_logloss"],
                                   rtol=1e-5)
    np.testing.assert_array_equal(bp.feats[:15], b1p.feats)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_estimator_model_string_matches_reference(kind):
    X, y = _data(n=500, f=5, seed=17, kind=kind)
    cols = {"features": X.astype(np.float32), "label": y}
    first = jest.LightGBMClassifier(num_iterations=4, num_leaves=8,
                                    min_data_in_leaf=5).fit(JDataFrame(cols))
    s = first.booster.to_string()
    kw = dict(num_iterations=3, num_leaves=8, min_data_in_leaf=5,
              model_string=s)
    mj = jest.LightGBMClassifier(**kw).fit(JDataFrame(cols))
    mp = pest.LightGBMClassifier(device="cpu", **kw).fit(DataFrame(cols))
    _same_trees(mj.booster, mp.booster, best_iteration=False)
    K = 3 if kind == "multiclass" else 1
    assert mp.booster.num_trees == 7 * K


# -- init_score --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["regression", "binary", "multiclass"])
def test_init_score_matches_reference(kind):
    X, y = _data(seed=18, kind=kind)
    rng = np.random.default_rng(19)
    m = rng.normal(0, 1, (len(y), 3) if kind == "multiclass" else len(y))
    p = _params(kind)
    bj = jtrain(p, X, y, init_score=m)
    bp = ptrain(p, X, y, init_score=m, device="cpu")
    _same_trees(bj, bp)
    assert bp.base_score == 0.0
    np.testing.assert_allclose(bp.raw_score(X), bj.raw_score(X), rtol=1e-5,
                               atol=1e-6)


def test_init_score_with_valid_sets_matches_reference():
    X, y = _data(n=700, seed=20, kind="regression")
    margin = 2.0 * np.nan_to_num(X[:, 0])
    p = _params("regression", num_iterations=40, early_stopping_round=4,
                learning_rate=0.3)
    kw = dict(init_score=margin[:500], valid_sets=[(X[500:], y[500:])],
              valid_init_scores=[margin[500:]])
    logs = ([], [])
    bj = jtrain(p, X[:500], y[:500], eval_log=logs[0], **kw)
    bp = ptrain(p, X[:500], y[:500], eval_log=logs[1], device="cpu", **kw)
    assert bj.best_iteration < 40
    _same_trees(bj, bp)
    for a, b in zip(*logs):
        np.testing.assert_allclose(b["l2"], a["l2"], rtol=1e-5)


def test_estimator_init_score_col_matches_reference():
    X, y = _data(n=400, f=4, seed=21, kind="regression")
    margin = 2.0 * X[:, 0]
    valid = np.random.default_rng(22).random(400) < 0.25
    cols = {"features": X.astype(np.float32), "label": y, "margin": margin,
            "is_valid": valid}
    kw = dict(num_iterations=10, num_leaves=8, min_data_in_leaf=5,
              init_score_col="margin", validation_indicator_col="is_valid",
              early_stopping_round=3)
    mj = jest.LightGBMRegressor(**kw).fit(JDataFrame(cols))
    mp = pest.LightGBMRegressor(device="cpu", **kw).fit(DataFrame(cols))
    _same_trees(mj.booster, mp.booster)
    # a multiclass margin column of per-row vectors
    Xm, ym = _data(n=300, f=4, seed=23, kind="multiclass")
    mm = np.random.default_rng(24).normal(0, 1, (300, 3))
    col = np.empty(300, dtype=object)
    col[:] = list(mm)
    cols = {"features": Xm.astype(np.float32), "label": ym, "margin": col}
    mp = pest.LightGBMClassifier(device="cpu", num_iterations=3,
                                 num_leaves=8, min_data_in_leaf=5,
                                 init_score_col="margin").fit(
        DataFrame(cols))
    bj = jtrain({"objective": "multiclass", "num_class": 3,
                 "num_iterations": 3, "num_leaves": 8,
                 "min_data_in_leaf": 5}, Xm.astype(np.float32), ym,
                init_score=mm)
    _same_trees(bj, mp.booster)


@pytest.mark.parametrize("case", ["shape", "with_init_model", "no_valid",
                                  "valid_count", "valid_shape",
                                  "leaf_family"])
def test_warm_start_and_init_score_errors(case):
    """Each ValueError of the JAX package, raised by both."""
    X, y = _data(n=200, seed=25, kind="regression")
    p = _params("regression", num_iterations=2)
    kw, match = {}, None
    if case == "shape":
        kw, match = {"init_score": np.zeros(50)}, "init_score shape"
    elif case == "with_init_model":
        b = jtrain(p, X, y)
        kw, match = {"init_model": b, "init_score": np.zeros(200)}, \
            "warm-start"
    elif case == "no_valid":
        kw, match = {"init_score": np.zeros(150),
                     "valid_sets": [(X[150:], y[150:])]}, "valid_init_scores"
        X, y = X[:150], y[:150]
    elif case == "valid_count":
        kw, match = {"init_score": np.zeros(150),
                     "valid_sets": [(X[150:], y[150:])],
                     "valid_init_scores": []}, "valid_init_scores has"
        X, y = X[:150], y[:150]
    elif case == "valid_shape":
        kw, match = {"init_score": np.zeros(150),
                     "valid_sets": [(X[150:], y[150:])],
                     "valid_init_scores": [np.zeros(3)]}, "shape"
        X, y = X[:150], y[:150]
    else:
        b = jtrain(p, X, y)
        b._lin_base = {"coefs": np.zeros((2, 8, 4), np.float32),
                       "pf": np.zeros((2, 8, 3), np.int32)}
        kw, match = {"init_model": b}, "leaf model family"
    with pytest.raises(ValueError, match=match):
        jtrain(p, X, y, **kw)
    with pytest.raises(ValueError, match=match):
        ptrain(p, X, y, device="cpu", **kw)


def test_what_stays_unported_raises():
    """Data-parallel training (queue item 31) still raises; step
    checkpoints (item 24's ``TrainingCheckpointer``) are ported, held by
    ``tests/test_torch_gbdt_checkpoint.py``."""
    X, y = _data(n=100, seed=26, kind="regression")
    with pytest.raises(NotImplementedError, match="queue item 31"):
        ptrain({"objective": "regression", "num_iterations": 1,
                "tree_learner": "data_parallel"}, X, y, device="cpu")
    # a categorical model string (queue item 17, ported since) loads and
    # predicts as the JAX package's
    Xc = X.copy()
    Xc[:, 0] = np.floor(np.abs(Xc[:, 0]) * 3)
    bj = jtrain({"objective": "regression", "num_iterations": 1,
                 "categorical_feature": [0]}, Xc, y)
    bp = PBooster.from_string(bj.to_string(), device="cpu")
    np.testing.assert_allclose(bp.predict(Xc), np.asarray(bj.predict(Xc)),
                               rtol=1e-5, atol=1e-6)
