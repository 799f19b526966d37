"""Monotone constraints, ``path_smooth`` and interaction constraints in
the port's tree build (``mmlspark_tpu_torch/models/gbdt/trees.py``)
against the JAX package on the CPU.

``train()`` parity as ``tests/test_torch_gbdt.py`` holds it: split
features and raw thresholds exact, leaves within rtol 1e-5 / atol 1e-7,
covers exact, predictions within rtol 1e-5 / atol 1e-6; gains within
rtol 1e-5 / atol 1e-6 of the largest (under ``path_smooth`` the two
packages' gains part by an ulp where XLA fuses differently in context).
``build_tree`` alone on the same binned inputs, with every constraint
at once, gives the same trees for one class and for a class-batched
build. Then the properties of ``tests/test_gbdt_monotone.py`` and
``test_gbdt_regularizers.py`` on the port's models (sweeps monotone,
paths within a group, smoothing flattens) and the JAX package's
refusals."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.gbdt import trees as jtrees
from mmlspark_tpu.models.gbdt.binning import BinMapper
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.models.gbdt import LightGBMRegressor
from mmlspark_tpu_torch.models.gbdt import train as ptrain
from mmlspark_tpu_torch.models.gbdt import trees as ptrees
from mmlspark_tpu_torch.ops.histogram import prepare_bins_columns
from test_torch_gbdt import _same_predictions, _same_trees, make_data

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

BASE = {"num_iterations": 8, "num_leaves": 8, "max_bin": 64,
        "min_data_in_leaf": 5, "seed": 3}

CASES = {
    "monotone": {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0]},
    "monotone_goss": {"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, -1],
                      "boosting": "goss"},
    "monotone_dart": {"monotone_constraints": [0, -1, 0, 1, 0, 0, 0, 0],
                      "boosting": "dart", "skip_drop": 0.0},
    "path_smooth": {"path_smooth": 5.0},
    "path_smooth_large": {"path_smooth": 200.0, "lambda_l2": 1.0},
    "interaction": {"interaction_constraints": [[0, 1], [2, 3]]},
    "interaction_overlap": {"interaction_constraints": [[0, 1, 2], [2, 3],
                                                        [4, 5, 6, 7]]},
    "all": {"monotone_constraints": [1, -1, 0, 0, 0, 0, 0, 0],
            "path_smooth": 3.0,
            "interaction_constraints": [[0, 1, 2], [1, 3, 4]],
            "feature_fraction": 0.8},
}


def _data(objective, n=2000, seed=0):
    X, y, logit = make_data(n=n, seed=seed)
    if objective == "regression":
        return X, logit + np.random.default_rng(seed + 1).normal(0, 0.3, n)
    if objective == "multiclass":
        return X, (np.digitize(logit, [-1.0, 1.0])).astype(np.float64)
    return X, y


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("objective", ["binary", "regression", "multiclass"])
def test_train_matches_reference(objective, case):
    X, y = _data(objective)
    p = {**BASE, "objective": objective, **CASES[case]}
    if objective == "multiclass":
        p["num_class"] = 3
    bj, bp = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)


def _tree_inputs(seed, n=1500, F=6, max_bin=32):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    s = X[:, 0] - 0.7 * X[:, 1] + 0.4 * X[:, 2] * X[:, 3]
    g = (s + rng.normal(0, 0.5, n)).astype(np.float32)
    h = rng.uniform(0.5, 1.5, n).astype(np.float32)
    w = (rng.random(n) > 0.1).astype(np.float32)
    xb = BinMapper(max_bin=max_bin).fit(X).transform(X)
    return xb, g * w, h * w, w


KW = dict(lam=1.0, min_gain=0.0, min_child_weight=1e-3,
          min_data_in_leaf=5.0)


@pytest.mark.parametrize("depth", [3, 4])
def test_build_tree_all_constraints_matches_reference(depth):
    """One build_tree with monotone, path_smooth and interaction groups
    at once, single-class and class-batched (each class's tree equal to
    the JAX package's build of it)."""
    mono = np.array([1, -1, 0, 0, 0, 1], np.int32)
    groups = np.zeros((2, 6), bool)
    groups[0, [0, 1, 2]] = True
    groups[1, [2, 3, 5]] = True
    xb, g0, h0, w = _tree_inputs(depth)
    g = np.stack([g0, -0.5 * g0 + 0.1, np.roll(g0, 7)])
    h = np.stack([h0, h0 * 0.5, np.roll(h0, 7)])
    nb = int(xb.max()) + 1
    want = []
    for k in range(3):
        out = jtrees.build_tree(
            jnp.asarray(xb), jnp.asarray(g[k]), jnp.asarray(h[k]),
            jnp.asarray(w), depth=depth, n_bins=nb,
            monotone=jnp.asarray(mono), path_smooth=4.0,
            ic_groups=jnp.asarray(groups), **KW)
        want.append([np.asarray(a) for a in out])
    cols = prepare_bins_columns(xb, "cpu")
    pkw = dict(depth=depth, n_bins=nb, monotone=torch.from_numpy(mono),
               path_smooth=4.0, ic_groups=torch.from_numpy(groups), **KW)
    one = [t.numpy() for t in ptrees.build_tree(
        cols, torch.from_numpy(g[0]), torch.from_numpy(h[0]),
        torch.from_numpy(w), **pkw)]
    batched = [t.numpy() for t in ptrees.build_tree(
        cols, torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(w), **pkw)]
    for k in range(3):
        got = one if k == 0 else [a[k] for a in batched]
        for i in (0, 1, 3, 5):       # feats, thr_bin, node_rel, covers
            np.testing.assert_array_equal(got[i], want[k][i])
        np.testing.assert_allclose(got[2], want[k][2], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got[4], want[k][4], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[k][4]).max())
        if k == 0:
            for a, b in zip(one, batched):
                np.testing.assert_array_equal(a, b[0])


# -- properties (tests/test_gbdt_monotone.py, test_gbdt_regularizers.py) --------

def _mono_data(n=800, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 4))
    y = (1.5 * X[:, 0] - 2.0 * X[:, 1] + 0.8 * np.sin(4 * X[:, 2])
         + rng.normal(0, 0.4, n))
    return X, y


def _sweep(booster, feature, n_bg=12, n_grid=40, seed=1):
    rng = np.random.default_rng(seed)
    bg = rng.normal(0, 1, (n_bg, 4))
    grid = np.linspace(-2.5, 2.5, n_grid)
    pts = np.repeat(bg, n_grid, axis=0)
    pts[:, feature] = np.tile(grid, n_bg)
    pred = booster.predict(pts.astype(np.float32), raw_score=True)
    return np.diff(pred.reshape(n_bg, n_grid), axis=1).ravel()


MONO = {"objective": "regression", "num_iterations": 40, "num_leaves": 15,
        "min_data_in_leaf": 5, "learning_rate": 0.15}


@pytest.mark.parametrize("boosting", ["gbdt", "goss", "dart"])
def test_monotone_sweeps(boosting):
    X, y = _mono_data(seed=2 if boosting != "gbdt" else 0)
    b = ptrain(dict(MONO, boosting=boosting, seed=3,
                    monotone_constraints=[1, -1, 0, 0]), X, y, device="cpu")
    assert (_sweep(b, 0) >= -1e-6).all()       # non-decreasing in x0
    assert (_sweep(b, 1) <= 1e-6).all()        # non-increasing in x1
    free = ptrain(dict(MONO, boosting=boosting, seed=3), X, y, device="cpu")
    assert (_sweep(free, 0) < -1e-9).any()     # the free fit wiggles
    if boosting == "gbdt":
        r2 = lambda p: 1 - np.var(y - p) / np.var(y)     # noqa: E731
        assert r2(b.predict(X)) > 0.9 * r2(free.predict(X))


def _paths_within_groups(m, groups):
    depth = m.depth
    for tree in np.asarray(m.feats):
        for leaf in range(2 ** depth):
            idx, used = 0, set()
            for d in range(depth):
                f = tree[idx]
                if f >= 0:
                    used.add(int(f))
                idx = 2 * idx + 1 + ((leaf >> (depth - 1 - d)) & 1)
            if used and not any(used <= set(g) for g in groups):
                return False
    return True


REG = {"objective": "regression", "num_iterations": 12, "num_leaves": 15,
       "learning_rate": 0.2, "seed": 3}


@pytest.mark.parametrize("groups", [[[0, 1], [2, 3]], [[0, 1, 2], [2, 3]]])
def test_interaction_paths_within_groups(groups):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1200, 6)).astype(np.float32)
    y = X[:, 0] * X[:, 1] + X[:, 2] * X[:, 3] + 0.05 * rng.normal(size=1200)
    m = ptrain(dict(REG, interaction_constraints=groups), X, y,
               device="cpu")
    assert _paths_within_groups(m, groups)
    assert not np.isin(m.feats, [4, 5]).any()   # features in no group


def test_path_smooth_flattens_and_shrinks():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(900, 8)).astype(np.float32)
    y = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.1 * rng.normal(size=900)
    a = ptrain(REG, X, y, device="cpu")
    np.testing.assert_array_equal(
        ptrain(dict(REG, path_smooth=0.0), X, y, device="cpu").predict(X),
        a.predict(X))
    assert float(np.std(ptrain(dict(REG, path_smooth=1e9), X, y,
                               device="cpu").predict(X))) < 1e-3
    b = ptrain(dict(REG, path_smooth=50.0), X, y, device="cpu")
    assert float(np.std(b.leaf_values)) < float(np.std(a.leaf_values))
    assert float(np.mean((b.predict(X) - y) ** 2)) < float(np.var(y))


def test_estimator_monotone_matches_reference():
    from mmlspark_tpu.core import DataFrame as JDataFrame
    from mmlspark_tpu.models.gbdt import LightGBMRegressor as JRegressor
    X, y = _mono_data(n=300, seed=6)
    cols = {"features": X.astype(np.float32), "label": y}
    kw = dict(num_iterations=20, num_leaves=15, min_data_in_leaf=5,
              monotone_constraints=[1, -1, 0, 0])
    mp = LightGBMRegressor(device="cpu", **kw).fit(DataFrame(cols))
    mj = JRegressor(**kw).fit(JDataFrame(cols))
    assert (_sweep(mp.booster, 0) >= -1e-6).all()
    np.testing.assert_array_equal(mp.booster.feats, mj.booster.feats)
    np.testing.assert_allclose(
        np.asarray(mp.transform(DataFrame(cols))["prediction"]),
        np.asarray(mj.transform(JDataFrame(cols))["prediction"]),
        rtol=1e-5, atol=1e-6)


# -- refusals: the JAX package's, raised the same way --------------------------

REFUSALS = {
    "mono_length": ({"monotone_constraints": [1, 0]}, "one entry per"),
    "mono_values": ({"monotone_constraints": [2, 0, 0, 0]}, "-1, 0, or"),
    "mono_fraction": ({"monotone_constraints": [0.5, 0, 0, 0]}, "-1, 0, or"),
    "mono_categorical": ({"monotone_constraints": [1, 0, 0, 0],
                          "categorical_feature": [0]}, "categorical"),
    "path_smooth_negative": ({"path_smooth": -1.0}, "path_smooth"),
    "ic_outside": ({"interaction_constraints": [[0, 9]]}, "outside"),
    "ic_empty": ({"interaction_constraints": [[]]}, "non-empty"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_reference(case):
    X, y = _mono_data(n=100)
    X[:, 0] = np.round(X[:, 0])
    extra, match = REFUSALS[case]
    p = dict(MONO, num_iterations=2, **extra)
    with pytest.raises(ValueError, match=match):
        jtrain(p, X, y)
    with pytest.raises(ValueError, match=match):
        ptrain(p, X, y, device="cpu")


def test_empty_monotone_list_means_none():
    X, y = _mono_data(n=100, seed=7)
    p = dict(MONO, num_iterations=2, monotone_constraints=[])
    _same_trees(jtrain(p, X, y), ptrain(p, X, y, device="cpu"))
