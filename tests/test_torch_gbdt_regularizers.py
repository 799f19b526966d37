"""``extra_trees`` and ``feature_fraction_bynode`` in the port's GBDT
trainer against the JAX package's ``train()``: both draw each level's
candidate bins and feature subsets from threefry keys (the port's copy in
``utils/prng.py``), so the trees are held equal by ``_same_trees``, alone,
together, under ``feature_fraction`` and interaction constraints, for a
multiclass model (one key a class) and with goss."""

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.models.gbdt import trees as ptrees
from mmlspark_tpu_torch.models.gbdt.train import train as ptrain
from mmlspark_tpu_torch.utils import prng

from test_torch_gbdt import (BASE, MULTI, _same_trees, make_data,
                             make_multiclass)

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

SMALL = {**BASE, "num_iterations": 6}


@pytest.fixture(scope="module")
def data():
    X, y, logit = make_data(n=800, f=8, seed=21)
    yr = logit + np.random.default_rng(2).normal(0, 0.3, len(logit))
    return X, y, yr


CASES = {
    "extra_trees": ({"objective": "binary", "extra_trees": True}, "y"),
    "ff_bynode": ({"objective": "binary", "feature_fraction_bynode": 0.5},
                  "y"),
    "both_feature_fraction": ({"extra_trees": True,
                               "feature_fraction_bynode": 0.4,
                               "feature_fraction": 0.7}, "yr"),
    "both_interaction": ({"extra_trees": True,
                          "feature_fraction_bynode": 0.6,
                          "interaction_constraints": [[0, 1, 2],
                                                      [2, 3, 4, 5]]}, "yr"),
    "goss": ({"boosting": "goss", "extra_trees": True,
              "feature_fraction_bynode": 0.75}, "yr"),
}


@pytest.mark.parametrize("case", sorted(CASES) + ["multiclass"])
def test_randomized_trees_match_the_reference(case, data):
    """Multiclass (one key a class, ``split(it_key, K)``) runs on the
    multiclass tests' data and params (``test_torch_gbdt.py``)."""
    if case == "multiclass":
        X, yy = make_multiclass()
        params = {**MULTI, "extra_trees": True,
                  "feature_fraction_bynode": 0.5}
    else:
        X, y, yr = data
        extra, target = CASES[case]
        yy = {"y": y, "yr": yr}[target]
        params = {**SMALL, **extra}
    _same_trees(jtrain(params, X, yy), ptrain(params, X, yy, device="cpu"))


@pytest.mark.parametrize("value", [0.0, -0.5, 1.5])
def test_bynode_fraction_out_of_range_raises_as_the_reference(value, data):
    X, y, _ = data
    params = {**SMALL, "feature_fraction_bynode": value}
    with pytest.raises(ValueError) as je:
        jtrain(params, X, y)
    with pytest.raises(ValueError) as pe:
        ptrain(params, X, y, device="cpu")
    assert str(pe.value) == str(je.value)


def test_draws_mask_the_split_search():
    """One tree through ``build_tree``: every split's bin is its node's
    drawn candidate for the split feature, within the feature's own
    populated range, and the feature is in the node's drawn subset."""
    F, depth = 8, 3
    rng = np.random.default_rng(3)
    bins = torch.as_tensor(rng.integers(0, 16, (F, 800)), dtype=torch.uint8)
    feat_bins = torch.as_tensor(rng.integers(2, 17, F), dtype=torch.int32)
    bins = torch.minimum(bins, (feat_bins - 1)[:, None].to(torch.uint8))
    g = torch.as_tensor(rng.normal(size=800), dtype=torch.float32)
    h = torch.ones(800)
    key = prng.fold_in(prng.PRNGKey(7), 2)
    feats, thr, *_ = ptrees.build_tree(
        bins, g, h, torch.ones(800), depth=depth, n_bins=16,
        min_data_in_leaf=1.0, feature_mask=torch.ones(F, dtype=torch.bool),
        rng=key, extra_trees=True, ff_bynode=0.5, feat_bins=feat_bins)
    for d in range(depth):
        m, off = 2 ** d, 2 ** d - 1
        u = prng.uniform(prng.fold_in(key, 2 * d), (m, F))
        bin_hi = (feat_bins - 1).clamp_min(1)
        cand = torch.minimum((u * bin_hi).to(torch.int32), bin_hi - 1)
        u = prng.uniform(prng.fold_in(key, 2 * d + 1), (m, F))
        subset = u >= torch.topk(u, 4, dim=1).values[:, -1:]
        for j in range(m):
            f = int(feats[off + j])
            if f < 0:
                continue
            assert int(thr[off + j]) == int(cand[j, f])
            assert int(thr[off + j]) < int(feat_bins[f]) - 1
            assert bool(subset[j, f])
    with pytest.raises(ValueError, match="rng"):
        ptrees.build_tree(bins, g, h, torch.ones(800), depth=depth,
                          n_bins=16, extra_trees=True)
