"""Linear trees (``linear_tree``) in the port (``mmlspark_tpu_torch/
models/gbdt/trees.py``: ``path_features``, ``fit_linear_leaves``,
``predict_trees_linear``; the glue in ``train.py`` and ``booster.py``)
against the JAX package on the CPU.

On CPU tensors the per-leaf ridge systems solve through LAPACK's sgetrf
and strsm, and the row sums of the leaf models fuse their multiplies as
XLA's CPU backend does, so ``fit_linear_leaves`` is bitwise the JAX
package's there. ``train()`` with ``linear_tree`` gives the JAX
package's trees (split features and raw thresholds exact, leaves and
leaf coefficients within rtol 1e-5 / atol 1e-7, covers exact,
predictions within rtol 1e-5 / atol 1e-6) for the regression, binary
and multiclass objectives and under goss, dart and rf; the binary and
multiclass coefficients within 2e-4 of each tree's largest and their
raw scores within 2e-5 of the largest (their gradients are an ulp
apart, ``_same_linear``). Then the
properties and refusals of ``tests/test_gbdt_linear.py``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.models.gbdt import estimators as jest
from mmlspark_tpu.models.gbdt import trees as jtrees
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.models.gbdt import Booster as PBooster
from mmlspark_tpu_torch.models.gbdt import estimators as pest
from mmlspark_tpu_torch.models.gbdt import train as ptrain
from mmlspark_tpu_torch.models.gbdt import trees as ptrees
from mmlspark_tpu_torch.models.gbdt.onnx_export import booster_to_onnx
from test_torch_gbdt import _same_predictions, _same_trees

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

BASE = {"objective": "regression", "num_iterations": 10, "num_leaves": 7,
        "learning_rate": 0.2, "seed": 3}


def _piecewise_linear(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = np.where(X[:, 0] > 0, 2.0 * X[:, 1] + 1.0, -1.5 * X[:, 2]) \
        + 0.05 * rng.normal(size=n)
    return X, y


def _multi(n=1500, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    z = np.stack([2.0 * X[:, 1] + 1.0, -1.5 * X[:, 2], X[:, 3] - X[:, 1]],
                 axis=1)
    return X, np.argmax(z + 0.05 * rng.normal(size=z.shape), axis=1) \
        .astype(np.float64)


def _same_linear(bj, bp, exact_grads=True):
    """Trees as ``_same_trees`` holds them, path features exact, and the
    leaf coefficients within rtol 1e-5 / atol 1e-7 — or, where the
    objective's gradients differ between the frameworks by an ulp
    (sigmoid, softmax: ``exact_grads=False``), which each leaf's ridge
    solve amplifies by its conditioning, within 2e-4 of each tree's
    largest |coefficient| (the leaf values, each leaf's bias, with
    them)."""
    assert bp.is_linear and bj.is_linear
    np.testing.assert_array_equal(bp.linear["pf"], bj.linear["pf"])
    cj, cp = bj.linear["coefs"], bp.linear["coefs"]
    if exact_grads:
        _same_trees(bj, bp)
        np.testing.assert_allclose(cp, cj, rtol=1e-5, atol=1e-7)
        return
    assert (bp.num_trees, bp.base_score, bp.best_iteration) == \
        (bj.num_trees, bj.base_score, bj.best_iteration)
    for name in ("feats", "thr_raw", "covers"):
        np.testing.assert_array_equal(getattr(bp, name), getattr(bj, name))
    np.testing.assert_allclose(bp.gains, bj.gains, rtol=1e-5,
                               atol=1e-6 * np.abs(bj.gains).max())
    scale = np.abs(cj).reshape(len(cj), -1).max(axis=1)
    for a, b in ((cp, cj), (bp.leaf_values, bj.leaf_values)):
        err = np.abs(a - b).reshape(len(cj), -1).max(axis=1)
        assert (err <= 2e-4 * scale).all(), (err / scale).max()


@pytest.mark.parametrize("depth", [2, 3, 5])
def test_path_features_bitwise(depth):
    rng = np.random.default_rng(depth)
    for _ in range(20):
        feats = rng.integers(-1, 4, 2 ** depth - 1).astype(np.int32)
        np.testing.assert_array_equal(ptrees.path_features(feats, depth),
                                      jtrees.path_features(feats, depth))


@pytest.mark.parametrize("lam_lin,n_leaf,sparse_leaf", [
    (0.0, 8, False), (0.5, 8, False), (0.0, 16, True)])
def test_fit_linear_leaves_bitwise(lam_lin, n_leaf, sparse_leaf):
    """Coefficients and per-row contributions bitwise the JAX package's,
    NaN features and masked slots included, a leaf with too few rows
    falling back to its constant."""
    rng = np.random.default_rng(int(lam_lin * 10) + n_leaf)
    n, F, D = 3000, 6, 3
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.03] = np.nan
    leaf = rng.integers(0, n_leaf, n).astype(np.int32)
    if sparse_leaf:
        leaf[leaf == 5] = 6
        leaf[:3] = 5                                # 3 rows < D + 2
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    live = (rng.random(n) > 0.1).astype(np.float32)
    pf = rng.integers(-1, F, (n_leaf, D)).astype(np.int32)
    jb, jc = jtrees.fit_linear_leaves(
        jnp.asarray(X), jnp.asarray(leaf), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(live), jnp.asarray(pf), n_leaf=n_leaf, lam_lin=lam_lin,
        lam=1e-10)
    pb, pc = ptrees.fit_linear_leaves(
        torch.from_numpy(X), torch.from_numpy(leaf).long(),
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(live),
        torch.from_numpy(pf), n_leaf=n_leaf, lam_lin=lam_lin, lam=1e-10)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    if sparse_leaf:
        assert (pb[5, :D] == 0).all()


def test_predict_trees_linear_matches_reference():
    X, y = _piecewise_linear(n=600)
    bj = jtrain(dict(BASE, linear_tree=True), X, y)
    lin = bj.linear
    Xq = X.copy()
    Xq[::7, 1] = np.nan
    want = np.asarray(jtrees.predict_trees_linear(
        jnp.asarray(bj.feats), jnp.asarray(bj.thr_raw),
        jnp.asarray(lin["coefs"]), jnp.asarray(lin["pf"]),
        jnp.asarray(Xq), depth=bj.depth))
    got = ptrees.predict_trees_linear(
        *(torch.from_numpy(np.asarray(a)) for a in (
            bj.feats, bj.thr_raw, lin["coefs"], lin["pf"], Xq)),
        depth=bj.depth)
    np.testing.assert_array_equal(got.numpy(), want)


CASES = {
    "plain": {},
    "lambda": {"linear_lambda": 5.0, "lambda_l2": 1.0},
    "goss": {"boosting": "goss"},
    "dart": {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.0},
    "rf": {"boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("objective", ["regression", "binary", "multiclass"])
def test_train_matches_reference(objective, case):
    if objective == "multiclass":
        X, y = _multi()
        p = dict(BASE, objective="multiclass", num_class=3)
    else:
        X, y = _piecewise_linear()
        if objective == "binary":
            y = (y > 0).astype(np.float64)
        p = dict(BASE, objective=objective)
    p = dict(p, linear_tree=True, **CASES[case])
    bj, bp = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    exact = objective == "regression"
    _same_linear(bj, bp, exact_grads=exact)
    if exact:
        _same_predictions(bj, bp, X)
    else:
        # the coefficients' drift (above) moves raw scores by up to
        # 2e-5 of their scale
        rj = np.asarray(bj.raw_score(X))
        np.testing.assert_allclose(bp.raw_score(X), rj, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(rj).max()))
        np.testing.assert_allclose(bp.predict(X), np.asarray(bj.predict(X)),
                                   rtol=0, atol=1e-5)
    assert bp.phase_seconds["linear_fit"] > 0


def test_early_stopping_truncates_linear_arrays():
    X, y = _piecewise_linear()
    p = dict(BASE, num_iterations=60, linear_tree=True,
             early_stopping_round=5)
    kw = dict(valid_sets=[(X[1500:], y[1500:])])
    bj = jtrain(p, X[:1500], y[:1500], **kw)
    bp = ptrain(p, X[:1500], y[:1500], device="cpu", **kw)
    assert bp.best_iteration > 0
    assert bp.linear["coefs"].shape[0] == bp.num_trees == bj.num_trees
    _same_linear(bj, bp)


def test_linear_beats_constant_and_lambda_shrinks():
    X, y = _piecewise_linear()
    p = dict(BASE, num_iterations=25)
    const = ptrain(p, X, y, device="cpu")
    lin = ptrain(dict(p, linear_tree=True), X, y, device="cpu")
    assert lin.is_linear and not const.is_linear
    mse = lambda b: float(np.mean((b.predict(X) - y) ** 2))   # noqa: E731
    assert mse(lin) < 0.5 * mse(const)
    big = ptrain(dict(p, linear_tree=True, linear_lambda=1e4), X[:800],
                 y[:800], device="cpu")
    small = ptrain(dict(p, linear_tree=True), X[:800], y[:800],
                   device="cpu")
    wn = lambda b: float(np.abs(b.linear["coefs"][..., :-1]).mean())  # noqa
    assert wn(big) < 0.1 * wn(small)


def test_booster_round_trips_and_caps():
    X, y = _piecewise_linear(n=600)
    b = ptrain(dict(BASE, linear_tree=True), X, y, device="cpu")
    s = b.to_string()
    b2 = PBooster.from_string(s, device="cpu")
    assert b2.is_linear
    np.testing.assert_array_equal(b2.predict(X), b.predict(X))
    np.testing.assert_allclose(np.asarray(JBooster.from_string(s).predict(X)),
                               b.predict(X), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(b.predict(X, num_iteration=5),
                                  b.truncated(5).predict(X))
    m = b.merge(b.truncated(2))
    assert m.linear["coefs"].shape[0] == m.num_trees == 12
    Xq = X[:10].copy()
    Xq[:, 4] = np.nan             # a noise feature: its term becomes 0
    assert np.isfinite(b.predict(Xq)).all()


def test_unsupported_paths_raise():
    X, y = _piecewise_linear(n=400)
    b = ptrain(dict(BASE, num_iterations=3, linear_tree=True), X, y,
               device="cpu")
    with pytest.raises(NotImplementedError):
        b.shap_values(X[:5])
    with pytest.raises(NotImplementedError):
        b.refit(X, y)
    with pytest.raises(ValueError, match="linear"):
        booster_to_onnx(b)
    c = ptrain(dict(BASE, num_iterations=3), X, y, device="cpu")
    with pytest.raises(ValueError, match="linear"):
        b.merge(c)


REFUSALS = {
    "sparse": ({}, "dense"),
    "categorical": ({"categorical_feature": [0]}, "numerical"),
    "monotone": ({"monotone_constraints": [1, 0, 0, 0, 0]}, "monotone"),
    "lambda_l1": ({"lambda_l1": 0.5}, "lambda_l1"),
    "path_smooth": ({"path_smooth": 2.0}, "path_smooth"),
    "family": ({}, "leaf model family"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_reference(case):
    X, y = _piecewise_linear(n=300)
    extra, match = REFUSALS[case]
    p = dict(BASE, num_iterations=2, linear_tree=True, **extra)
    Xa, jkw, pkw = X, {}, {}
    if case == "sparse":
        Xa = sp.csr_matrix(X)
    elif case == "family":
        q = dict(BASE, num_iterations=2)
        p = q
        jkw = {"init_model": jtrain(dict(q, linear_tree=True), X, y)}
        pkw = {"init_model": ptrain(dict(q, linear_tree=True), X, y,
                                    device="cpu")}
    with pytest.raises(ValueError, match=match):
        jtrain(p, Xa, y, **jkw)
    with pytest.raises(ValueError, match=match):
        ptrain(p, Xa, y, device="cpu", **pkw)


def test_warm_start_continues_linear_model():
    X, y = _piecewise_linear(n=400)
    p = dict(BASE, num_iterations=5, linear_tree=True)
    b0 = ptrain(p, X, y, device="cpu")
    b1 = ptrain(p, X, y, init_model=b0, device="cpu")
    assert b1.num_trees == 10 and b1.is_linear and b0.num_trees == 5


def test_estimator_multiclass_linear_pipeline(tmp_path):
    X, y = _multi(n=600)
    cols = {"features": X, "label": y}
    kw = dict(num_iterations=10, num_leaves=7, learning_rate=0.2,
              linear_tree=True)
    mp = pest.LightGBMClassifier(device="cpu", **kw).fit(DataFrame(cols))
    mj = jest.LightGBMClassifier(**kw).fit(JDataFrame(cols))
    assert mp.booster.is_linear and mp.booster.num_class == 3
    pred = np.asarray(mp.transform(DataFrame(cols))["prediction"])
    assert (pred == y).mean() > 0.85
    np.testing.assert_array_equal(
        pred, np.asarray(mj.transform(JDataFrame(cols))["prediction"]))
    mp.save(str(tmp_path / "m"))
    r = PipelineStage.load(str(tmp_path / "m"))
    r.device = mp.device
    r._booster = PBooster.from_string(r.get("booster_string").decode(),
                                      device="cpu")
    np.testing.assert_array_equal(
        np.asarray(r.transform(DataFrame(cols))["prediction"]), pred)
