"""Sparse input and EFB bundling in the port (``mmlspark_tpu_torch/
models/gbdt/binning.py``, ``bundling.py``, ``trees._debundle`` and the
sparse glue of ``train.py``) against the JAX package on the CPU.

Binning CSR and CSC input (stored NaNs, explicit zeros, a sampled fit)
gives bitwise the JAX package's bins. The bundle plan (``plan_bundles``,
``FeatureBundler``'s tables, its sampled conflict count drawn from
``np.random.default_rng(seed)``) and the bundled bin matrix are bitwise
the JAX package's; ``_debundle`` of the same bundled histogram is
bitwise the JAX package's, and a bundled ``build_tree`` gives its trees.
``train()`` on sparse X, with and without bundling, with a conflict
budget, with sparse validation sets, gives the JAX package's trees
(split features and raw thresholds exact, leaves within rtol 1e-5 / atol
1e-7, covers exact, predictions within rtol 1e-5 / atol 1e-6; a gain
floor keeps rounding-noise splits out, and goss runs on exact
gradients, both as noted where they are set). K6's
launch plan covers the bundled shape of the card's 21d run (uint16 bins,
901 bundle bins, 1-16 nodes)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.models.gbdt import estimators as jest
from mmlspark_tpu.models.gbdt import trees as jtrees
from mmlspark_tpu.models.gbdt.binning import BinMapper as JMapper
from mmlspark_tpu.models.gbdt.bundling import FeatureBundler as JBundler
from mmlspark_tpu.models.gbdt.bundling import plan_bundles as jplan
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.models.gbdt import estimators as pest
from mmlspark_tpu_torch.models.gbdt import train as ptrain
from mmlspark_tpu_torch.models.gbdt import trees as ptrees
from mmlspark_tpu_torch.models.gbdt.binning import BinMapper as PMapper
from mmlspark_tpu_torch.models.gbdt.bundling import FeatureBundler as \
    PBundler
from mmlspark_tpu_torch.models.gbdt.bundling import plan_bundles as pplan
from mmlspark_tpu_torch.ops import histogram as hist
from test_torch_gbdt import _same_predictions, _same_trees
from test_torch_histogram import H100, _block_ranges, _plan_emulation, \
    _within_bound

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def make_sparse(n=600, f=12, density=0.25, seed=0, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, f)) < density
    dense = np.where(mask, rng.normal(0, 2, (n, f)), 0.0)
    if nan_frac:
        dense[mask & (rng.random((n, f)) < nan_frac)] = np.nan
    return dense, sp.csr_matrix(dense)


def make_exclusive(n=600, groups=4, per_group=3, seed=0, dense_cols=0):
    """Groups of mutually exclusive columns (each row one value per
    group, one-hot with values: the shape EFB exists for), then
    ``dense_cols`` dense ones."""
    rng = np.random.default_rng(seed)
    F = groups * per_group
    X = np.zeros((n, F + dense_cols))
    for g in range(groups):
        which = rng.integers(0, per_group, n)
        X[np.arange(n), g * per_group + which] = rng.normal(1, 1, n)
    X[:, F:] = rng.normal(size=(n, dense_cols))
    return X, sp.csr_matrix(X)


def target(X, objective, seed=0):
    rng = np.random.default_rng(seed)
    s = np.nan_to_num(X[:, 0] + X[:, 3] - X[:, 1])
    if objective == "regression":
        return s + rng.normal(0, 0.2, len(X))
    if objective == "multiclass":
        return np.digitize(s, [0.0, 1.0]).astype(np.float64)
    return (s + rng.normal(0, 0.2, len(X)) > 0.4).astype(np.float64)


# -- binning -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["csr", "csc", "nan", "explicit_zeros",
                                  "sampled", "uint16"])
def test_sparse_bins_bitwise(case):
    dense, X = make_sparse(nan_frac=0.3 if case == "nan" else 0.0)
    kw, max_bin = {}, 32
    if case == "csc":
        X = X.tocsc()
    elif case == "explicit_zeros":
        X = X.tocoo()
        X = sp.csr_matrix((np.where(np.arange(X.nnz) % 5 == 0, 0.0, X.data),
                           (X.row, X.col)), shape=X.shape)
        dense = X.toarray()
    elif case == "sampled":
        kw = {"sample_cnt": 256, "seed": 7}
    elif case == "uint16":
        max_bin = 400
        dense, X = make_sparse(n=2000, density=0.9)
    jm, pm = JMapper(max_bin=max_bin, **kw).fit(X), \
        PMapper(max_bin=max_bin, **kw).fit(X)
    for a, b in zip(pm.upper_bounds, jm.upper_bounds):
        np.testing.assert_array_equal(a, b)
    got, want = pm.transform(X), jm.transform(X)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pm.transform(dense), got)
    if case == "nan":
        assert (got[np.isnan(dense)] == 0).all()


# -- the bundle plan -----------------------------------------------------------

@pytest.mark.parametrize("rate,cap", [(0.0, 4096), (0.02, 4096), (0.0, 12),
                                      (0.1, 9)])
def test_plan_bundles_bitwise(rate, cap):
    rng = np.random.default_rng(1)
    rows = [np.sort(rng.choice(200, size=int(k), replace=False))
            for k in rng.integers(0, 40, 30)]
    widths = rng.integers(2, 6, 30)
    assert pplan(rows, 200, widths, rate, cap) == \
        jplan(rows, 200, widths, rate, cap)


BUNDLERS = {
    "exclusive": dict(data=lambda: make_exclusive()[1]),
    "exclusive_dense": dict(data=lambda: make_exclusive(dense_cols=3)[1]),
    "random": dict(data=lambda: make_sparse(density=0.05)[1]),
    "conflicts": dict(data=lambda: make_sparse(density=0.12, seed=3)[1],
                      rate=0.05),
    "sampled": dict(data=lambda: make_exclusive(n=3000, seed=4)[1],
                    sample=500),
    "nan": dict(data=lambda: make_sparse(density=0.1, nan_frac=0.3)[1]),
    "cap": dict(data=lambda: make_exclusive(per_group=6)[1], cap=10),
}


@pytest.mark.parametrize("case", sorted(BUNDLERS))
def test_bundler_bitwise(case):
    c = BUNDLERS[case]
    X = c["data"]()
    kw = dict(max_conflict_rate=c.get("rate", 0.0),
              max_bundle_bins=c.get("cap", 4096),
              plan_sample_cnt=c.get("sample", 100_000))
    jm, pm = JMapper(max_bin=16).fit(X), PMapper(max_bin=16).fit(X)
    jb, pb = JBundler(**kw).fit(X, jm), PBundler(**kw).fit(X, pm)
    assert pb.bundles == jb.bundles
    assert pb.n_bundle_bins == jb.n_bundle_bins
    assert pb.worthwhile(X.shape[1]) == jb.worthwhile(X.shape[1])
    for name in ("bundle_of", "offset_of", "width_of", "zero_bin"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name))
    xb = pb.transform(X, pm)
    np.testing.assert_array_equal(xb, jb.transform(X, jm))
    # the cache (same matrix) and a fresh bin pass agree
    np.testing.assert_array_equal(PBundler(**kw).fit(X, pm).transform(
        sp.csr_matrix(X.toarray()), pm), xb)
    if not kw["max_conflict_rate"]:
        # lossless: every feature's bins decode from its bundle column
        direct = pm.transform(X)
        for f in range(X.shape[1]):
            rel = xb[:, pb.bundle_of[f]].astype(int) - pb.offset_of[f]
            dec = np.where((rel >= 0) & (rel < pb.width_of[f]), rel,
                           pb.zero_bin[f])
            np.testing.assert_array_equal(dec, direct[:, f])


def _bundled(X, max_bin=16, rate=0.0):
    pm = PMapper(max_bin=max_bin).fit(X)
    pb = PBundler(max_conflict_rate=rate).fit(X, pm)
    return pm, pb, pb.transform(X, pm)


@pytest.mark.parametrize("n_nodes", [1, 4])
def test_debundle_bitwise(n_nodes):
    """The port's debundled histogram of the JAX package's bundled one is
    bitwise the JAX package's ``_debundle`` (its sums associated as XLA
    reduces them), and close to the direct per-feature histogram."""
    X = make_exclusive(dense_cols=2)[1]
    pm, pb, xb_b = _bundled(X)
    rng = np.random.default_rng(2)
    n = X.shape[0]
    node = rng.integers(0, n_nodes, n).astype(np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    w = np.ones(n, np.float32)
    hb = jtrees._level_histogram(jnp.asarray(xb_b), jnp.asarray(node),
                                 jnp.asarray(g), jnp.asarray(h),
                                 jnp.asarray(w), n_nodes, pb.n_bundle_bins,
                                 None)
    tables = jtrees.BundleTables(*(jnp.asarray(getattr(pb, k)) for k in (
        "bundle_of", "offset_of", "width_of", "zero_bin")))
    want = np.asarray(jtrees._debundle(hb, tables, pm.n_bins))
    got = ptrees._debundle(torch.from_numpy(np.array(hb)),
                           ptrees.BundleTables.from_bundler(pb, "cpu"),
                           pm.n_bins).numpy()
    np.testing.assert_array_equal(got, want)
    direct = hist.level_histogram_plain(
        hist.prepare_bins_columns(pm.transform(X), "cpu"),
        torch.from_numpy(node), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(w), n_nodes, pm.n_bins).numpy()
    np.testing.assert_allclose(got, direct, rtol=1e-4, atol=2e-5)


def test_bundled_build_tree_matches_reference():
    X = make_exclusive(n=1500, groups=5, per_group=4, dense_cols=2)[1]
    pm, pb, xb_b = _bundled(X, max_bin=32)
    rng = np.random.default_rng(5)
    n = X.shape[0]
    dense = X.toarray()
    g = (dense[:, 0] - dense[:, 5] + rng.normal(0, 0.3, n)).astype(
        np.float32)
    h = rng.uniform(0.5, 1.5, n).astype(np.float32)
    w = np.ones(n, np.float32)
    kw = dict(depth=4, n_bins=pm.n_bins, lam=1.0, min_data_in_leaf=5.0,
              n_bundle_bins=pb.n_bundle_bins)
    want = jtrees.build_tree(
        jnp.asarray(xb_b), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        bundles=jtrees.BundleTables(*(jnp.asarray(getattr(pb, k)) for k in (
            "bundle_of", "offset_of", "width_of", "zero_bin"))), **kw)
    got = ptrees.build_tree(
        hist.prepare_bins_columns(xb_b, "cpu"), torch.from_numpy(g),
        torch.from_numpy(h), torch.from_numpy(w),
        bundles=ptrees.BundleTables.from_bundler(pb, "cpu"), **kw)
    for i in (0, 1, 3, 5):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-7)


# -- training ------------------------------------------------------------------

#: min_gain_to_split 1e-3, as the JAX package's bundling tests set it: on
#: one-hot columns many candidate gains are rounding noise (1e-7 where a
#: node's sums cancel), which the floor keeps out of the comparison
BASE = {"num_iterations": 8, "num_leaves": 8, "max_bin": 32,
        "min_data_in_leaf": 5, "seed": 3, "min_gain_to_split": 1e-3}

CASES = {
    "efb": ("exclusive", {}),
    "efb_dense_cols": ("exclusive_dense", {}),
    "no_bundle": ("exclusive", {"enable_bundle": False}),
    "not_worthwhile": ("random", {}),
    "conflicts": ("conflicts", {"max_conflict_rate": 0.05}),
    "efb_goss": ("exclusive", {"boosting": "goss"}),
    "efb_dart": ("exclusive", {"boosting": "dart", "skip_drop": 0.0}),
    "efb_monotone": ("exclusive_dense", {"monotone_constraints":
                                         [1] + [0] * 14}),
}


def _train_data(kind, objective):
    X = {"exclusive": lambda: make_exclusive(n=1500)[0],
         "exclusive_dense": lambda: make_exclusive(n=1500, dense_cols=3)[0],
         "random": lambda: make_sparse(n=1500, density=0.3)[0],
         "conflicts": lambda: make_sparse(n=1500, density=0.12, seed=3)[0],
         }[kind]()
    return X, sp.csr_matrix(X), target(X, objective)


#: goss selects rows by |g| on the host; binary and multiclass gradients
#: differ between the frameworks by an ulp, which can reorder rows of
#: nearly equal |g| on these few-valued columns, so goss runs on the
#: regression objective (exact gradients) here
TRAIN_CASES = [(o, c) for c in sorted(CASES)
               for o in ("binary", "regression", "multiclass")
               if "goss" not in c or o == "regression"]


@pytest.mark.parametrize("objective,case", TRAIN_CASES)
def test_train_matches_reference(objective, case):
    kind, extra = CASES[case]
    dense, X, y = _train_data(kind, objective)
    p = {**BASE, "objective": objective, **extra}
    if objective == "multiclass":
        p["num_class"] = 3
    bj, bp = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)
    np.testing.assert_allclose(bp.predict(dense), bp.predict(X), rtol=1e-6,
                               atol=1e-7)
    bundled = p.get("enable_bundle", True) and kind != "random"
    assert (bp.efb_plan is not None) == bundled
    if bundled:
        assert bp.efb_plan["n_bundles"] < X.shape[1]
        assert "bundle_fit" in bp.phase_seconds


def test_lossless_bundling_equals_dense_training():
    """Conflict budget 0: the bundled trees are the unbundled ones (a
    shallow problem with well-separated gains and a min_gain floor, as
    the JAX package's own test holds it)."""
    dense, X, y = _train_data("exclusive", "binary")
    p = {"objective": "binary", "num_iterations": 8, "num_leaves": 4,
         "min_data_in_leaf": 20, "min_gain_to_split": 1e-3}
    on = ptrain(p, X, y, device="cpu")
    off = ptrain({**p, "enable_bundle": False}, X, y, device="cpu")
    d = ptrain(p, dense, y, device="cpu")
    assert on.efb_plan is not None and off.efb_plan is None
    for b in (off, d):
        np.testing.assert_array_equal(on.feats, b.feats)
        np.testing.assert_array_equal(on.thr_raw, b.thr_raw)
        np.testing.assert_allclose(on.leaf_values, b.leaf_values, rtol=1e-4,
                                   atol=1e-6)


def test_sparse_valid_sets_and_early_stopping_match_reference():
    dense, X, y = _train_data("exclusive_dense", "regression")
    p = {**BASE, "objective": "regression", "num_iterations": 60,
         "learning_rate": 0.8, "num_leaves": 31, "min_data_in_leaf": 2,
         "early_stopping_round": 3, "metric": "l2"}
    jlog, plog = [], []
    bj = jtrain(p, X[:1000], y[:1000], valid_sets=[(X[1000:], y[1000:])],
                eval_log=jlog)
    bp = ptrain(p, X[:1000], y[:1000], valid_sets=[(X[1000:], y[1000:])],
                eval_log=plog, device="cpu")
    np.testing.assert_allclose([e["l2"] for e in plog],
                               [e["l2"] for e in jlog], rtol=1e-5)
    assert bp.num_trees == bj.num_trees < 60
    _same_predictions(bj, bp, X)


def test_sparse_prediction_paths_match_dense():
    dense, X, y = _train_data("exclusive_dense", "binary")
    b = ptrain({**BASE, "objective": "binary"}, X, y, device="cpu")
    np.testing.assert_array_equal(b.raw_score(dense), b.raw_score(X))
    np.testing.assert_array_equal(b.predict_leaf(dense), b.predict_leaf(X))
    np.testing.assert_allclose(b.shap_values(dense[:40]),
                               b.shap_values(X[:40]), rtol=1e-5, atol=1e-6)


def test_warm_start_on_sparse_input():
    dense, X, y = _train_data("exclusive", "binary")
    p = {**BASE, "objective": "binary", "num_iterations": 4}
    bj0, bp0 = jtrain(p, X, y), ptrain(p, X, y, device="cpu")
    bj, bp = jtrain(p, X, y, init_model=bj0), \
        ptrain(p, X, y, init_model=bp0, device="cpu")
    assert bp.num_trees == 8
    np.testing.assert_array_equal(bp.feats, bj.feats)
    np.testing.assert_allclose(bp.predict(X),
                               np.asarray(bj.predict(X, num_iteration=0)),
                               rtol=1e-5, atol=1e-6)


def test_estimator_sparse_features_column():
    dense, X, y = _train_data("exclusive_dense", "binary")
    col = np.empty(X.shape[0], dtype=object)
    for i in range(X.shape[0]):
        col[i] = X[i]
    kw = dict(num_iterations=8, num_leaves=7, min_data_in_leaf=5)
    mp = pest.LightGBMClassifier(device="cpu", **kw).fit(
        DataFrame({"features": col, "label": y}))
    mj = jest.LightGBMClassifier(**kw).fit(
        JDataFrame({"features": col, "label": y}))
    assert mp.booster.efb_plan is not None
    np.testing.assert_array_equal(mp.booster.feats, mj.booster.feats)
    got = mp.transform(DataFrame({"features": col}))
    want = mj.transform(JDataFrame({"features": col}))
    np.testing.assert_array_equal(np.asarray(got["prediction"]),
                                  np.asarray(want["prediction"]))


# -- K6 at the bundled shape ---------------------------------------------------

#: the card's 21d run: 10,000,000 rows, 8 bundles (six one-hot groups and
#: two numeric columns), 901 bundle bins as uint16
BUNDLED_21D = (10_000_000, 8, 901)


@pytest.mark.parametrize("n_nodes", [1, 2, 4, 8, 16])
def test_launch_plan_covers_the_bundled_shape(n_nodes):
    n, F, n_bins = BUNDLED_21D
    plan = hist.hist_launch_plan(n, F, n_nodes, n_bins, 2, *H100)
    assert plan.smem <= H100[0] and 1 <= plan.blocks <= 2 ** 31 - 1
    ranges = list(_block_ranges(plan, n, F, n_nodes * n_bins))
    for axis, size in enumerate((F, n_nodes * n_bins, n)):
        cuts = sorted({r[axis] for r in ranges})
        assert cuts[0][0] == 0 and cuts[-1][1] == size
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))


@pytest.mark.parametrize("n_nodes", [1, 16])
def test_plan_emulation_at_bundled_bins(n_nodes):
    """K6's per-block partials over its plan at 901 uint16 bins (a small
    row count, the H100's limits) give the plain version's counts
    bitwise and g/h within the card's bound."""
    rng = np.random.default_rng(n_nodes)
    n, F, n_bins = 3000, BUNDLED_21D[1], BUNDLED_21D[2]
    xb = rng.integers(0, n_bins, (n, F)).astype(np.uint16)
    cols = hist.prepare_bins_columns(xb, "cpu")
    nd = torch.from_numpy(rng.integers(0, n_nodes, n).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    h = torch.from_numpy(rng.random(n).astype(np.float32))
    w = torch.ones(n)
    plan = hist.hist_launch_plan(n, F, n_nodes, n_bins, 2, *H100)
    got = _plan_emulation(cols, nd, g, h, w, n_nodes, n_bins, plan)
    plain = hist.level_histogram_plain(cols, nd, g, h, w, n_nodes, n_bins)
    assert torch.equal(got[..., 2], plain[..., 2])
    assert _within_bound(got, cols, nd, g, h, w, n_nodes, n_bins)
