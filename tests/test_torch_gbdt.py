"""The port's GBDT path (``mmlspark_tpu_torch/models/gbdt/``) against the
JAX package on the CPU: bins bitwise, gradients within f32 rounding
(rtol 1e-6), split search and whole trees identical on seeded data whose
top-two gain margin is checked on the JAX side first, ``train()``
identical trees with predictions within rtol 1e-5 / atol 1e-6, and model
strings that load across the two packages both ways. Multiclass: the
class-batched tree build equals one build per class bitwise and the
JAX package's ``vmap``ped build; multiclass ``train()`` gives the JAX
package's split features and bins, leaf values and predictions within
the binary tests' tolerances, with and without early stopping."""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.gbdt import binning as jbin
from mmlspark_tpu.models.gbdt import objectives as jobj
from mmlspark_tpu.models.gbdt import trees as jtrees
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.models.gbdt import Booster as PBooster
from mmlspark_tpu_torch.models.gbdt import BinMapper as PBinMapper
from mmlspark_tpu_torch.models.gbdt import objectives as pobj
from mmlspark_tpu_torch.models.gbdt import train as ptrain
from mmlspark_tpu_torch.models.gbdt import trees as ptrees
from mmlspark_tpu_torch.ops.histogram import prepare_bins_columns

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

BASE = {"num_iterations": 10, "num_leaves": 8, "max_bin": 64,
        "min_data_in_leaf": 5}


def make_data(n=2000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f))
    logit = X[:, 0] * 2 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (logit + rng.normal(0, 0.3, n) > 0).astype(np.float64)
    return X, y, logit


def _same_trees(bj, bp):
    assert bp.num_trees == bj.num_trees and bp.depth == bj.depth
    assert bp.base_score == bj.base_score
    assert bp.best_iteration == bj.best_iteration
    np.testing.assert_array_equal(bp.feats, bj.feats)
    np.testing.assert_array_equal(bp.thr_raw, bj.thr_raw)
    np.testing.assert_allclose(bp.leaf_values, bj.leaf_values, rtol=1e-5,
                               atol=1e-7)
    # a gain is a difference of f32 scores (G^2 / H) that are larger than
    # it, so across many iterations its rounding error is absolute: within
    # 1e-6 of the largest gain
    np.testing.assert_allclose(bp.gains, bj.gains, rtol=1e-5,
                               atol=1e-6 * np.abs(bj.gains).max())
    np.testing.assert_array_equal(bp.covers, bj.covers)   # integer counts


def _same_predictions(bj, bp, X):
    np.testing.assert_allclose(bp.raw_score(X), bj.raw_score(X), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bp.predict(X), np.asarray(bj.predict(X)),
                               rtol=1e-5, atol=1e-6)


def _both(params, X, y, **kw):
    return jtrain(params, X, y, **kw), ptrain(params, X, y, device="cpu",
                                              **kw)


# -- binning -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["f64_nan", "f32", "uint16", "int", "sparse",
                                  "sampled", "few_values"])
def test_binmapper_bitwise(case):
    rng = np.random.default_rng(1)
    X = rng.normal(0, 1, (1500, 5))
    max_bin, kw = 32, {}
    if case == "f64_nan":
        X[rng.random(X.shape) < 0.05] = np.nan
    elif case == "f32":
        X = X.astype(np.float32)
        X[::7, 2] = np.nan
    elif case == "uint16":
        max_bin = 300
    elif case == "int":
        X = rng.integers(-50, 50, (1500, 5))
    elif case == "sparse":
        X[rng.random(X.shape) < 0.7] = 0.0
        X = sp.csr_matrix(X)
    elif case == "sampled":
        kw = {"sample_cnt": 400, "seed": 3}
    else:
        X = np.round(X)                      # exact one-bin-per-value path
    jm = jbin.BinMapper(max_bin=max_bin, **kw).fit(X)
    pm = PBinMapper(max_bin=max_bin, **kw).fit(X)
    assert pm.n_bins == jm.n_bins
    for a, b in zip(pm.upper_bounds, jm.upper_bounds):
        np.testing.assert_array_equal(a, b)
    got, want = pm.transform(X), jm.transform(X)
    assert got.dtype == want.dtype
    assert got.dtype == (np.uint16 if case == "uint16" else np.uint8)
    np.testing.assert_array_equal(got, want)
    if case in ("f64_nan", "f32"):
        nan = np.isnan(X)
        assert (got[nan] == 0).all() and (got[~nan] >= 1).all()
    for (ta, la), (tb, lb) in [(pm.bounds_table(), jm.bounds_table())]:
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(la, lb)
    assert pm.bin_threshold_value(1, 3) == jm.bin_threshold_value(1, 3)


def test_binmapper_dicts_cross_load():
    X = np.random.default_rng(2).normal(size=(400, 3))
    jm = jbin.BinMapper(max_bin=16).fit(X)
    pm = PBinMapper.from_dict(json.loads(json.dumps(jm.to_dict())))
    np.testing.assert_array_equal(pm.transform(X), jm.transform(X))
    back = jbin.BinMapper.from_dict(pm.to_dict())
    np.testing.assert_array_equal(back.transform(X), jm.transform(X))


# -- objectives ---------------------------------------------------------------

OBJ_KW = {"huber": {"alpha": 0.7}, "quantile": {"alpha": 0.3},
          "tweedie": {"tweedie_variance_power": 1.3},
          "multiclass": {"num_class": 3}}


@pytest.mark.parametrize("name", ["regression", "regression_l1", "huber",
                                  "quantile", "poisson", "tweedie", "gamma",
                                  "binary", "multiclass"])
def test_grad_hess_and_transform(name):
    """f32 gradients within f32 rounding of the reference's (exp and
    sigmoid round differently in the two frameworks; atol 1e-6 covers
    tweedie's cancelling terms)."""
    rng = np.random.default_rng(3)
    n = 512
    multi = name == "multiclass"
    s = rng.normal(0, 1, (n, 3) if multi else n).astype(np.float32)
    if multi:
        y = rng.integers(0, 3, n).astype(np.float32)
    elif name in ("poisson", "tweedie", "gamma"):
        y = rng.uniform(0.5, 3.0, n).astype(np.float32)
    elif name == "binary":
        y = (rng.random(n) < 0.4).astype(np.float32)
    else:
        y = rng.normal(0, 1, n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jo = jobj.get_objective(name, **OBJ_KW.get(name, {}))
    po = pobj.get_objective(name, **OBJ_KW.get(name, {}))
    jg, jh = jo.grad_hess(jnp.asarray(s), jnp.asarray(y), jnp.asarray(w))
    pg, ph = po.grad_hess(*(torch.from_numpy(a) for a in (s, y, w)))
    assert pg.dtype == ph.dtype == torch.float32
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(po.transform(torch.from_numpy(s)).numpy(),
                               np.asarray(jo.transform(jnp.asarray(s))),
                               rtol=1e-6, atol=1e-7)
    y64, w64 = y.astype(np.float64), w.astype(np.float64)
    assert po.init_score(y64, w64) == jo.init_score(y64, w64)
    assert po.n_scores == jo.n_scores


def test_metrics_and_aliases_match():
    rng = np.random.default_rng(4)
    y = (rng.random(300) < 0.5).astype(np.float64)
    p = rng.random(300)
    w = rng.uniform(0.5, 1.5, 300)
    assert sorted(pobj.OBJECTIVES) == sorted(jobj.OBJECTIVES)
    assert sorted(pobj.METRICS) == sorted(jobj.METRICS)
    for name in ("l2", "rmse", "l1", "auc", "binary_logloss",
                 "binary_error"):
        assert pobj.METRICS[name][0](y, p, w) == \
            jobj.METRICS[name][0](y, p, w)
        assert pobj.METRICS[name][1] == jobj.METRICS[name][1]
    for obj in ("binary", "regression", "huber", "poisson"):
        assert pobj.get_metric("auto", obj)[0] == \
            jobj.get_metric("auto", obj)[0]
    with pytest.raises(ValueError):
        pobj.get_objective("nope")


# -- split search and tree building -------------------------------------------

def _ref_hist(xb, node, g, h, w, n_nodes, n_bins):
    import jax
    data = jnp.stack([jnp.asarray(g), jnp.asarray(h), jnp.asarray(w)], -1)

    def per_feature(col):
        seg = jnp.asarray(node) * n_bins + col.astype(jnp.int32)
        return jax.ops.segment_sum(data, seg, num_segments=n_nodes * n_bins)

    hist = jax.vmap(per_feature, in_axes=1)(jnp.asarray(xb))
    return jnp.transpose(hist.reshape(xb.shape[1], n_nodes, n_bins, 3),
                         (1, 0, 2, 3))


def _assert_margin(jgain):
    """JAX-side top-two check: every node's best gain is either an exact
    tie (resolved to the first index by both frameworks) or ahead of the
    next distinct gain by more than 1e-5 relative, so rounding-level
    differences could not flip the choice."""
    gain = np.asarray(jgain).reshape(jgain.shape[0], -1)
    for row in gain:
        best = row.max()
        if not np.isfinite(best):
            continue
        rest = row[row < best]
        if rest.size and np.isfinite(rest.max()):
            assert best - rest.max() > 1e-5 * abs(best), (best, rest.max())


def _tree_inputs(seed, n, F, n_bins, bin_dtype=np.uint8):
    rng = np.random.default_rng(seed)
    xb = rng.integers(1, n_bins, (n, F)).astype(bin_dtype)
    signal = (xb[:, 0].astype(np.float32) / n_bins
              - (xb[:, 1] > n_bins // 2))
    s = signal + rng.normal(0, 0.5, n).astype(np.float32)
    p = 1 / (1 + np.exp(-s))
    y = (rng.random(n) < 0.5).astype(np.float32)
    w = (rng.random(n) > 0.1).astype(np.float32)
    g = ((p - y) * w).astype(np.float32)
    h = (np.maximum(p * (1 - p), 1e-16) * w).astype(np.float32)
    return xb, g, h, w


SPLIT_KW = dict(lam=1e-10 + 0.5, min_gain=0.0, min_child_weight=1e-3,
                min_data_in_leaf=10.0)


def test_find_splits_matches_reference():
    n, F, n_nodes, n_bins = 2000, 6, 4, 48
    xb, g, h, w = _tree_inputs(5, n, F, n_bins)
    node = np.random.default_rng(6).integers(0, n_nodes, n).astype(np.int32)
    jh = _ref_hist(xb, node, g, h, w, n_nodes, n_bins)
    fmask = np.ones(F, bool)
    fmask[2] = False
    _assert_margin(jtrees._split_gains(jh, SPLIT_KW["lam"], 0.0, 1e-3, 10.0,
                                       jnp.asarray(fmask)))
    jf, jb, jg = jtrees._find_splits(jh, SPLIT_KW["lam"], 0.0, 1e-3, 10.0,
                                     jnp.asarray(fmask))
    pf, pb, pg = ptrees._find_splits(torch.from_numpy(np.array(jh)),
                                     SPLIT_KW["lam"], 0.0, 1e-3, 10.0,
                                     torch.from_numpy(fmask))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-5)
    assert (pf.numpy() != 2).all()
    # a node with nothing valid gets the stub split
    empty = torch.zeros(1, F, n_bins, 3)
    sf, sb, sg = ptrees._find_splits(empty, 1.0, 0.0, 1e-3, 10.0, None)
    assert (sf.item(), sb.item(), sg.item()) == (-1, n_bins, 0.0)


def test_prefix_sum_matches_reference_cumsum():
    rng = np.random.default_rng(7)
    for shape, ax in [((3, 4, 255), 2), ((5, 17), 1), ((2, 300, 3), 1),
                      ((4, 16), 1), ((2, 1), 1)]:
        x = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(
            ptrees._prefix_sum(torch.from_numpy(x), ax).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(x), axis=ax)))


@pytest.mark.parametrize("n_bins,dt,depth", [(48, np.uint8, 3),
                                             (300, np.uint16, 2)])
def test_build_tree_matches_reference(n_bins, dt, depth):
    n, F = 2000, 5
    xb, g, h, w = _tree_inputs(8, n, F, n_bins, dt)
    fmask = np.array([True, True, False, True, True])
    kw = dict(depth=depth, n_bins=n_bins, alpha=0.05, **SPLIT_KW)
    jout = [np.asarray(a) for a in jtrees.build_tree(
        jnp.asarray(xb), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        feature_mask=jnp.asarray(fmask), **kw)]
    jf, jt, jl, jnode, jgain, jcov = jout
    # the JAX side's margins, level by level, from its own routing
    for d in range(depth):
        nodes = (jnode >> (depth - d)).astype(np.int32)
        hist = _ref_hist(xb, nodes, g, h, w, 2 ** d, n_bins)
        _assert_margin(jtrees._split_gains(hist, kw["lam"], 0.0, 1e-3,
                                           10.0, jnp.asarray(fmask)))
    args = (prepare_bins_columns(xb, "cpu"), torch.from_numpy(g),
            torch.from_numpy(h), torch.from_numpy(w))
    for impl in ("kernel", "plain"):
        pf, pt, pl, pnode, pgain, pcov = ptrees.build_tree(
            *args, feature_mask=torch.from_numpy(fmask), hist_impl=impl,
            **kw)
        assert pf.dtype == pt.dtype == pnode.dtype == torch.int32
        np.testing.assert_array_equal(pf.numpy(), jf)
        np.testing.assert_array_equal(pt.numpy(), jt)
        np.testing.assert_array_equal(pnode.numpy(), jnode)
        np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(pgain.numpy(), jgain, rtol=1e-5)
        np.testing.assert_allclose(pcov.numpy(), jcov, rtol=1e-5)
    assert (jf >= 0).sum() > 1              # it really split
    with pytest.raises(ValueError):
        ptrees.build_tree(*args, hist_impl="xla", **kw)


def _class_inputs(seed, n, F, n_bins, K):
    """Bins and (K, n) multiclass g/h at the first iteration's softmax
    (scores 0 plus seeded noise), labels learnable from features 0-1."""
    rng = np.random.default_rng(seed)
    xb = rng.integers(1, n_bins, (n, F)).astype(np.uint8)
    y = (xb[:, 0].astype(np.int64) * K // n_bins + (xb[:, 1] > n_bins // 2)
         + (rng.random(n) < 0.2)) % K
    s = rng.normal(0, 0.3, (n, K)).astype(np.float32)
    p = np.exp(s) / np.exp(s).sum(1, keepdims=True)
    onehot = np.eye(K, dtype=np.float32)[y]
    w = (rng.random(n) > 0.1).astype(np.float32)
    g = ((p - onehot) * w[:, None]).T.copy()
    h = (np.maximum(p * (1 - p), 1e-16) * 2.0 * w[:, None]).T.copy()
    return xb, g.astype(np.float32), h.astype(np.float32), w


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_build_tree_classes_equal_one_build_per_class(impl):
    """(K, n) g/h grow K trees at once: each bitwise the tree one (n,)
    build grows from that class's g/h."""
    n, F, n_bins, K = 1500, 5, 40, 3
    xb, g, h, w = _class_inputs(11, n, F, n_bins, K)
    cols = prepare_bins_columns(xb, "cpu")
    kw = dict(depth=3, n_bins=n_bins, alpha=0.05, hist_impl=impl,
              **SPLIT_KW)
    batched = ptrees.build_tree(cols, torch.from_numpy(g),
                                torch.from_numpy(h), torch.from_numpy(w),
                                **kw)
    assert batched[0].shape == (K, 7) and batched[3].shape == (K, n)
    assert batched[2].shape == (K, 8) and batched[5].shape == (K, 15)
    for k in range(K):
        one = ptrees.build_tree(cols, torch.from_numpy(g[k]),
                                torch.from_numpy(h[k]), torch.from_numpy(w),
                                **kw)
        for a, b in zip(batched, one):
            assert torch.equal(a[k], b)
    assert (batched[0] >= 0).sum() > K          # it really split


def test_build_tree_classes_match_reference_vmap():
    """The class-batched build against the JAX package's ``vmap`` of its
    ``build_tree`` over classes (``train.py``'s multiclass branch)."""
    import jax
    n, F, n_bins, K, depth = 2000, 4, 32, 3, 3
    xb, g, h, w = _class_inputs(12, n, F, n_bins, K)
    kw = dict(depth=depth, n_bins=n_bins, **SPLIT_KW)
    jout = [np.asarray(a) for a in jax.vmap(
        lambda gk, hk: jtrees.build_tree(jnp.asarray(xb), gk, hk,
                                         jnp.asarray(w), **kw))(
        jnp.asarray(g), jnp.asarray(h))]
    jf, jt, jl, jnode, jgain, jcov = jout
    for k in range(K):
        for d in range(depth):
            nodes = (jnode[k] >> (depth - d)).astype(np.int32)
            hist = _ref_hist(xb, nodes, g[k], h[k], w, 2 ** d, n_bins)
            _assert_margin(jtrees._split_gains(hist, kw["lam"], 0.0, 1e-3,
                                               10.0, None))
    pf, pt, pl, pnode, pgain, pcov = ptrees.build_tree(
        prepare_bins_columns(xb, "cpu"), torch.from_numpy(g),
        torch.from_numpy(h), torch.from_numpy(w), **kw)
    np.testing.assert_array_equal(pf.numpy(), jf)
    np.testing.assert_array_equal(pt.numpy(), jt)
    np.testing.assert_array_equal(pnode.numpy(), jnode)
    np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pgain.numpy(), jgain, rtol=1e-5)
    np.testing.assert_allclose(pcov.numpy(), jcov, rtol=1e-5)


def test_stub_nodes_route_everything_left():
    """A level that finds no valid split writes the sentinel (-1, n_bins)
    and sends every row left; the leaf stats keep the whole node."""
    n, F, n_bins = 300, 3, 16
    xb, g, h, w = _tree_inputs(9, n, F, n_bins)
    pf, pt, pl, pnode, _, pcov = ptrees.build_tree(
        prepare_bins_columns(xb, "cpu"), torch.from_numpy(g),
        torch.from_numpy(h), torch.from_numpy(w), depth=2, n_bins=n_bins,
        min_data_in_leaf=1e6)
    assert pf.tolist() == [-1, -1, -1] and pt.tolist() == [n_bins] * 3
    assert (pnode == 0).all()
    assert pcov[3].item() == w.sum() and pcov[4:].sum().item() == 0


# -- train() against the reference --------------------------------------------

@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_train_fused_path_matches_reference(objective):
    X, y, logit = make_data()
    target = y if objective == "binary" else logit
    bj, bp = _both({**BASE, "objective": objective}, X, target)
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)
    assert bp.device.type == "cpu"
    assert set(bp.phase_seconds) == {"bin_fit", "bin_transform", "upload",
                                     "boost"}


@pytest.mark.parametrize("objective", ["regression_l1", "huber", "quantile",
                                       "poisson", "tweedie", "gamma"])
def test_train_other_objectives_match_reference(objective):
    X, _, logit = make_data(n=1200, f=6, seed=1)
    target = np.exp(logit / 4) if objective in ("poisson", "tweedie",
                                                "gamma") else logit
    bj, bp = _both({**BASE, "objective": objective, "num_iterations": 6},
                   X, target)
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)


def test_train_general_path_early_stopping_matches_reference():
    X, y, _ = make_data(seed=2)
    Xv, yv, _ = make_data(n=600, seed=3)
    params = {**BASE, "objective": "binary", "num_iterations": 40,
              "learning_rate": 0.5,
              "early_stopping_round": 3, "metric": ["binary_logloss", "auc"]}
    vw = [np.random.default_rng(4).uniform(0.5, 1.5, len(yv))]
    logs = ([], [])
    bj = jtrain(params, X, y, valid_sets=[(Xv, yv)], eval_log=logs[0],
                valid_weights=vw)
    bp = ptrain(params, X, y, valid_sets=[(Xv, yv)], eval_log=logs[1],
                valid_weights=vw, device="cpu")
    assert bj.best_iteration < 40            # it really stopped early
    _same_trees(bj, bp)
    _same_predictions(bj, bp, Xv)
    assert len(logs[1]) == len(logs[0])
    for a, b in zip(*logs):
        assert a.keys() == b.keys()
        for k in a:
            # AUC counts ranked pairs: predictions a few ulps apart may swap
            # a pair, which moves a 600-row AUC by ~1e-5 per pair
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                       atol=1e-4 if k == "auc" else 0)


def test_train_bagging_and_feature_fraction_match_reference():
    """Masks come from the same numpy stream, drawn in the same order."""
    X, y, _ = make_data(seed=5)
    params = {**BASE, "objective": "binary", "bagging_fraction": 0.7,
              "bagging_freq": 2, "feature_fraction": 0.6, "seed": 11}
    bj, bp = _both(params, X, y)
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)
    assert len(np.unique(bp.covers[:, 0])) > 1     # bagging moved the root


def test_train_weights_regularizers_uint16_match_reference():
    X, y, _ = make_data(n=1500, seed=6)
    sw = np.random.default_rng(7).uniform(0.2, 3.0, len(y))
    params = {**BASE, "objective": "binary", "max_bin": 300,
              "scale_pos_weight": 2.5, "lambda_l1": 0.1, "lambda_l2": 1.0,
              "min_gain_to_split": 0.01, "min_sum_hessian_in_leaf": 0.5,
              "num_iterations": 6}
    bj, bp = _both(params, X, y, sample_weight=sw)
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)
    bj2, bp2 = _both({**BASE, "objective": "binary", "is_unbalance": True,
                      "boost_from_average": False, "num_iterations": 4},
                     X, y)
    _same_trees(bj2, bp2)
    assert bp2.base_score == 0.0


def test_train_quantized_grad_matches_reference(monkeypatch):
    """use_quantized_grad rounds the histogram's stats to bf16. The
    reference applies it only inside its Pallas kernel, so it runs
    interpreted here (``MMLSPARK_TPU_PALLAS=1``)."""
    monkeypatch.setenv("MMLSPARK_TPU_PALLAS", "1")
    X, y, _ = make_data(n=600, f=4, seed=8)
    params = {"objective": "binary", "num_iterations": 5, "num_leaves": 8,
              "max_bin": 32, "use_quantized_grad": True}
    bj, bp = _both(params, X, y)
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)
    exact = ptrain({**params, "use_quantized_grad": False}, X, y,
                   device="cpu")
    assert not np.array_equal(exact.leaf_values, bp.leaf_values)


def make_multiclass(n=900, f=5, k=3, seed=15):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = np.argmax(X[:, :k] + 0.3 * rng.normal(size=(n, k)), axis=1)
    return X, y.astype(np.float64)


MULTI = {"objective": "multiclass", "num_class": 3, "num_iterations": 6,
         "num_leaves": 8, "max_bin": 32, "min_data_in_leaf": 5}


@pytest.mark.parametrize("params", [
    {}, {"bagging_fraction": 0.7, "bagging_freq": 2, "feature_fraction": 0.6,
         "seed": 3, "lambda_l2": 1.0}], ids=["plain", "bagged"])
def test_train_multiclass_matches_reference(params):
    """K trees an iteration, class-major, each leaf row k of (K, 2^D):
    the JAX package's split features and bins, leaf values within the
    binary tests' rtol 1e-5 / atol 1e-7, predictions within rtol 1e-5 /
    atol 1e-6."""
    X, y = make_multiclass()
    bj, bp = _both({**MULTI, **params}, X, y)
    assert bp.num_class == 3 and bp.num_trees == 18
    assert bp.leaf_values.shape == (18, 3, 8)
    _same_trees(bj, bp)
    _same_predictions(bj, bp, X)
    # tree t holds class t % K's values only
    t = np.arange(18)
    mask = np.zeros((18, 3), bool)
    mask[t, t % 3] = True
    assert (bp.leaf_values[~mask] == 0).all()


def test_train_multiclass_early_stopping_matches_reference():
    X, y = make_multiclass(seed=16)
    Xv, yv = make_multiclass(n=300, seed=17)
    params = {**MULTI, "num_iterations": 40, "learning_rate": 0.5,
              "early_stopping_round": 2,
              "metric": ["multi_logloss", "multi_error"]}
    logs = ([], [])
    bj = jtrain(params, X, y, valid_sets=[(Xv, yv)], eval_log=logs[0])
    bp = ptrain(params, X, y, valid_sets=[(Xv, yv)], eval_log=logs[1],
                device="cpu")
    assert bj.num_trees < 40 * 3              # it really stopped early
    _same_trees(bj, bp)
    _same_predictions(bj, bp, Xv)
    assert len(logs[1]) == len(logs[0])
    for a, b in zip(*logs):
        assert a.keys() == b.keys()
        for key in a:
            # a few-ulp prediction difference can move one of 300 rows
            # across the argmax: multi_error by 1/300 at most
            np.testing.assert_allclose(
                b[key], a[key], rtol=1e-5,
                atol=1 / 300 if key == "multi_error" else 0)


def test_multiclass_model_strings_cross_load_both_ways():
    X, y = make_multiclass(seed=18)
    bj, bp = _both(MULTI, X, y)
    from_j = PBooster.from_string(bj.to_string(), device="cpu")
    from_p = JBooster.from_string(bp.to_string())
    assert json.loads(bp.to_string())["num_class"] == 3
    for a, b in ((bj, from_j), (from_p, bp)):
        np.testing.assert_array_equal(b.raw_score(X), a.raw_score(X))
        _same_predictions(a, b, X)
        np.testing.assert_array_equal(b.predict_leaf(X),
                                      np.asarray(a.predict_leaf(X)))
    for k in (None, 2):
        np.testing.assert_allclose(bp.predict(X, num_iteration=k),
                                   np.asarray(bj.predict(X, num_iteration=k)),
                                   rtol=1e-5, atol=1e-6)


def test_multiclass_needs_two_classes():
    X, y = make_multiclass(n=60)
    with pytest.raises(ValueError, match="num_class"):
        ptrain({**MULTI, "num_class": 1}, X, y, device="cpu")


def test_train_callbacks_see_the_reference_scores():
    X, _, logit = make_data(n=800, seed=9)
    seen = ([], [])

    def cb(i):
        return lambda it, booster, scores: seen[i].append(
            (it, booster.num_trees, scores.copy()))
    params = {**BASE, "objective": "regression", "num_iterations": 4}
    bj = jtrain(params, X, logit, callbacks=[cb(0)])
    bp = ptrain(params, X, logit, callbacks=[cb(1)], device="cpu")
    _same_trees(bj, bp)
    for (ia, ta, sa), (ib, tb, sb) in zip(*seen):
        assert (ia, ta) == (ib, tb)
        np.testing.assert_allclose(sb, sa, rtol=1e-6, atol=1e-6)


# -- Booster ------------------------------------------------------------------

def test_model_strings_cross_load_both_ways():
    X, y, _ = make_data(n=1000, seed=10)
    Xn = X.copy()
    Xn[::13, 1] = np.nan                       # NaN routes left in both
    bj, bp = _both({**BASE, "objective": "binary"}, X, y)
    from_j = PBooster.from_string(bj.to_string(), device="cpu")
    from_p = JBooster.from_string(bp.to_string())
    for a, b in ((bj, from_j), (from_p, bp)):
        np.testing.assert_array_equal(b.raw_score(Xn), a.raw_score(Xn))
        _same_predictions(a, b, Xn)
        np.testing.assert_array_equal(b.predict_leaf(Xn),
                                      np.asarray(a.predict_leaf(Xn)))
    assert from_j.fit_params == bj.fit_params
    # the port's own round trip is bitwise
    again = PBooster.from_string(bp.to_string(), device="cpu")
    np.testing.assert_array_equal(again.predict(Xn), bp.predict(Xn))


def test_booster_api_matches_reference():
    X, y, _ = make_data(n=800, seed=11)
    bj, bp = _both({**BASE, "objective": "binary"}, X, y)
    for k in (None, 0, 3, 50):
        np.testing.assert_allclose(bp.predict(X, num_iteration=k),
                                   np.asarray(bj.predict(X, num_iteration=k)),
                                   rtol=1e-5, atol=1e-6)
    for kind in ("split", "gain"):
        np.testing.assert_allclose(bp.feature_importance(kind),
                                   bj.feature_importance(kind), rtol=1e-5)
    tj, tp = bj.truncated(4), bp.truncated(4)
    assert tp.num_trees == 4 and tp.best_iteration == tj.best_iteration
    mj, mp = bj.merge(tj), bp.merge(tp)
    assert mp.num_trees == mj.num_trees == 14
    _same_predictions(mj, mp, X)
    empty = PBooster(3, X.shape[1], "regression", 0.25, device="cpu")
    np.testing.assert_array_equal(empty.predict(X), np.full(len(X), 0.25,
                                                            np.float32))


def test_reference_multiclass_model_predicts_in_port():
    """A multiclass model written by the JAX package loads and predicts
    in the port."""
    rng = np.random.default_rng(12)
    X = rng.normal(size=(600, 4))
    y = np.argmax(X[:, :3], axis=1).astype(np.float64)
    bj = jtrain({"objective": "multiclass", "num_class": 3,
                 "num_iterations": 4, "num_leaves": 4, "max_bin": 16},
                X, y)
    bp = PBooster.from_string(bj.to_string(), device="cpu")
    _same_predictions(bj, bp, X)


def test_unported_model_strings_raise():
    """Model strings of the modes once refused here, a categorical model
    and a linear-tree model written by the JAX package, now load into the
    port and predict as the JAX package's (the port's own tests of those
    modes: tests/test_torch_gbdt_categorical.py and _linear.py)."""
    X, y, _ = make_data(n=300, seed=13)
    X[:, 2] = np.floor(np.abs(X[:, 2]) * 3)
    for extra in ({"categorical_feature": [2]}, {"linear_tree": True}):
        bj = jtrain({**BASE, "objective": "binary", "num_iterations": 2,
                     **extra}, X, y)
        bp = PBooster.from_string(bj.to_string(), device="cpu")
        assert bp.is_linear == bj.is_linear
        assert (bp.cat_encoder is None) == (bj.cat_encoder is None)
        _same_predictions(bj, bp, X)
        assert PBooster.from_string(bp.to_string(),
                                    device="cpu").to_string() == \
            bp.to_string()


# -- what the port leaves out, and the modes it took in since ----------------

UNPORTED = {
    "goss": {"boosting": "goss"}, "dart": {"boosting": "dart"},
    "rf": {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.5},
    "lambdarank": {"objective": "lambdarank"},
    "data_parallel": {"tree_learner": "data_parallel"},
    "linear_tree": {"linear_tree": True},
    "categorical": {"categorical_feature": [0]},
    "monotone": {"monotone_constraints": [1, 0, 0]},
    "path_smooth": {"path_smooth": 1.0},
    "interaction": {"interaction_constraints": [[0, 1]]},
    "extra_trees": {"extra_trees": True},
    "ff_bynode": {"feature_fraction_bynode": 0.5},
    "checkpoints": {"checkpoint_interval": 1},      # + a tmp_path dir
}
#: cases of UNPORTED that the port trains now (ROADMAP items 14 and
#: 16-19; head E and item 24's step checkpoints)
PORTED_SINCE = {"goss", "dart", "rf", "linear_tree", "categorical",
                "monotone", "path_smooth", "interaction", "sparse",
                "lambdarank", "extra_trees", "ff_bynode", "checkpoints",
                "group"}


@pytest.mark.parametrize("case", sorted(UNPORTED) + ["sparse", "mesh",
                                                     "group"])
def test_unported_options_raise(case, tmp_path):
    """Options outside the port raise NotImplementedError naming their
    ROADMAP item; the ones ported since train as the JAX package does
    (the same trees). lambdarank trains on one query of all rows; a
    ``group`` with another objective is ignored, as by the JAX package;
    each package checkpoints into its own directory."""
    rng = np.random.default_rng(14)
    X = rng.normal(size=(50, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    params, kw = {"num_iterations": 1, **UNPORTED.get(case, {})}, {}
    if case == "sparse":
        X = sp.csr_matrix(X)
    elif case == "mesh":
        kw = {"mesh": object()}
    elif case in ("group", "lambdarank"):
        kw = {"group": np.array([50])}
    if case in PORTED_SINCE:
        pj, pp = params, params
        if case == "checkpoints":
            pj = {**params, "checkpoint_dir": str(tmp_path / "jax")}
            pp = {**params, "checkpoint_dir": str(tmp_path / "port")}
        _same_trees(jtrain(pj, X, y, **kw),
                    ptrain(pp, X, y, device="cpu", **kw))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ptrain(params, X, y, device="cpu", **kw)


def test_entry_points_default_to_cuda_and_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, y, _ = make_data(n=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptrain({**BASE, "objective": "binary"}, X, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        PBooster(3, 8, "binary")
    s = PBooster(3, 8, "binary", device="cpu").to_string()
    with pytest.raises(RuntimeError, match="CUDA"):
        PBooster.from_string(s)
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_bins_columns(np.zeros((4, 2), np.uint8))
