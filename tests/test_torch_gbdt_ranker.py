"""Lambdarank in the port against the JAX package: the gradients
(``models/gbdt/lambdarank.py``, float64 on the device, groups bucketed by
size) against JAX ``_lambdarank_grad`` (numpy on the host), ``train(
objective="lambdarank", group=)``'s trees, ``LightGBMRanker`` on a
``DataFrame``, the non-contiguous group refusal, the model string, and the
validation NDCG the reference computes over the whole set as one query."""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDF
from mmlspark_tpu.models.gbdt import LightGBMRanker as JRanker
from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
from mmlspark_tpu.models.gbdt.train import _lambdarank_grad
from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu_torch.core import DataFrame as PDF
from mmlspark_tpu_torch.models.gbdt import LightGBMRanker as PRanker
from mmlspark_tpu_torch.models.gbdt.booster import Booster as PBooster
from mmlspark_tpu_torch.models.gbdt.lambdarank import (
    LambdarankPlan, lambdarank_grad, lambdarank_grad_plain)
from mmlspark_tpu_torch.models.gbdt.objectives import get_metric
from mmlspark_tpu_torch.models.gbdt.train import train as ptrain

from test_torch_gbdt import BASE, _same_trees

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

RANK = {**BASE, "objective": "lambdarank", "num_iterations": 6}


def _ranking(n_groups=40, seed=3, lo=1, hi=40, F=6):
    rng = np.random.default_rng(seed)
    groups = rng.integers(lo, hi, n_groups)
    n = int(groups.sum())
    X = rng.normal(size=(n, F))
    y = np.clip(np.round(X[:, 0] + rng.normal(0, 0.5, n) + 1), 0, 4)
    return X, y, groups


@pytest.fixture(scope="module")
def ranking():
    return _ranking()


GRAD_CASES = {
    "tied": (np.array([5, 3, 40, 17, 2, 9]), "zeros"),
    "size_one": (np.array([1, 4, 1, 1, 6, 1, 2]), "normal"),
    "uneven": (np.array([2, 3, 5, 8, 13, 21, 34, 55, 1, 89]), "rounded"),
    "one_long": (np.array([3, 700, 4]), "normal"),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grads_match_the_reference(case):
    """Within 1e-12 of max|g| (max|h|): the pair sums run over other
    padded widths, so the last bits differ."""
    groups, kind = GRAD_CASES[case]
    rng = np.random.default_rng(len(groups))
    n = int(groups.sum())
    y = rng.integers(0, 5, n).astype(np.float64)
    scores = {"zeros": np.zeros(n), "normal": rng.normal(size=n),
              "rounded": np.round(rng.normal(size=n), 1)}[kind]
    gj, hj = _lambdarank_grad(scores, y, groups)
    plan = LambdarankPlan(groups, y, "cpu")
    gp, hp = (t.numpy() for t in lambdarank_grad(torch.from_numpy(scores),
                                                   plan))
    assert np.abs(gp - gj).max() <= 1e-12 * np.abs(gj).max()
    assert np.abs(hp - hj).max() <= 1e-12 * np.abs(hj).max()
    # groups of one keep zero gradients (and the reference's h of 0)
    offs = np.concatenate([[0], np.cumsum(groups)])
    for g, lo in zip(groups, offs[:-1]):
        if g == 1:
            assert gp[lo] == 0.0 and hp[lo] == 0.0
    # the plain copy is the reference's function
    gq, hq = lambdarank_grad_plain(scores, y, groups)
    np.testing.assert_array_equal(gq, gj)
    np.testing.assert_array_equal(hq, hj)


def test_plan_buckets_and_chunks():
    """Groups bucketed by powers of two, each bucket padded to its own
    largest group; rows past the groups' sum keep zero gradients."""
    groups = np.array([3, 100, 4, 2, 90, 1])
    y = np.arange(205, dtype=np.float64) % 5
    plan = LambdarankPlan(groups, y, "cpu", n=210)
    widths = sorted(int(c.idx.shape[1]) for c in plan.chunks)
    assert widths == [2, 4, 100]
    g, h = lambdarank_grad(torch.zeros(210, dtype=torch.float64), plan)
    assert g.shape == (210,) and float(g[200:].abs().sum()) == 0.0
    assert plan.pair_elements() == 1 * 4 + 2 * 16 + 2 * 100 ** 2


def test_train_lambdarank_matches_reference(ranking):
    X, y, groups = ranking
    _same_trees(jtrain(RANK, X, y, group=groups),
                ptrain(RANK, X, y, group=groups, device="cpu"))


def test_train_lambdarank_weighted_and_bagged(ranking):
    X, y, groups = ranking
    w = np.random.default_rng(4).uniform(0.5, 2.0, len(y))
    params = {**RANK, "bagging_fraction": 0.7, "bagging_freq": 1}
    _same_trees(jtrain(params, X, y, sample_weight=w, group=groups),
                ptrain(params, X, y, sample_weight=w, group=groups,
                       device="cpu"))


def test_lambdarank_needs_groups(ranking):
    X, y, _ = ranking
    with pytest.raises(ValueError, match="group"):
        ptrain(RANK, X, y, device="cpu")


def _frame():
    """``tests/test_gbdt.py::test_ranker``'s frame: 30 queries of 10
    documents, relevance 0-3 from the first feature."""
    rng = np.random.default_rng(13)
    n_q, per_q = 30, 10
    X = rng.normal(0, 1, (n_q * per_q, 4))
    rel = np.clip((X[:, 0] * 2 + rng.normal(0, 0.5, n_q * per_q)).round(),
                  0, 3)
    qid = np.repeat(np.arange(n_q), per_q)
    return {"features": X, "label": rel, "group": qid}


@pytest.fixture(scope="module")
def rankers():
    cols = _frame()
    kw = dict(num_iterations=20, num_leaves=7, min_data_in_leaf=3)
    mj = JRanker(**kw).fit(JDF(dict(cols)))
    mp = PRanker(device="cpu", **kw).fit(PDF(dict(cols)))
    return cols, mj, mp


def test_ranker_fit_transform_matches_reference(rankers):
    cols, mj, mp = rankers
    _same_trees(mj.booster, mp.booster)
    oj = np.asarray(mj.transform(JDF(dict(cols)))["prediction"])
    op = np.asarray(mp.transform(PDF(dict(cols)))["prediction"])
    np.testing.assert_allclose(op, oj, rtol=1e-5, atol=1e-6)
    # raw scores, not probabilities
    np.testing.assert_array_equal(op, mp.booster.predict(
        cols["features"], raw_score=True).astype(np.float64))


def test_ranker_model_string_round_trip(rankers):
    cols, mj, mp = rankers
    s = mp.booster.to_string()
    back = PBooster.from_string(s, device="cpu")
    assert back.to_string() == s
    X = cols["features"]
    np.testing.assert_array_equal(back.predict(X, raw_score=True),
                                  mp.booster.predict(X, raw_score=True))
    np.testing.assert_allclose(
        np.asarray(JBooster.from_string(s).predict(X, raw_score=True)),
        mp.booster.predict(X, raw_score=True), rtol=1e-6, atol=1e-6)


def test_non_contiguous_groups_raise_as_the_reference():
    cols = _frame()
    cols["group"] = np.tile(np.arange(30), 10)      # ids interleaved
    for ranker, frame in ((JRanker(num_iterations=2), JDF),
                          (PRanker(device="cpu", num_iterations=2), PDF)):
        with pytest.raises(ValueError, match="not contiguous"):
            ranker.fit(frame(dict(cols)))


def test_validation_ndcg_is_over_the_whole_set(ranking):
    """The reference passes no groups to the eval metric: a validation
    set's NDCG@10 is over all its rows as one query, of the sigmoid of the
    raw scores (ROADMAP.md section 3, recorded). The port computes the
    same numbers."""
    X, y, groups = ranking
    Xv, yv, gv = _ranking(n_groups=12, seed=9)
    logs = []
    for fn, kw in ((jtrain, {}), (ptrain, {"device": "cpu"})):
        log = []
        b = fn(RANK, X, y, group=groups, valid_sets=[(Xv, yv)],
               eval_log=log, **kw)
        logs.append([e["ndcg"] for e in log])
    np.testing.assert_allclose(logs[1], logs[0], rtol=1e-6)
    p = 1.0 / (1.0 + np.exp(-b.predict(Xv, raw_score=True,
                                        num_iteration=len(logs[1]))))
    ndcg = get_metric("ndcg", "lambdarank")[1][0]
    whole = ndcg(yv, p, np.ones(len(yv)))
    per_query = ndcg(yv, p, np.ones(len(yv)), groups=gv)
    assert logs[1][-1] == pytest.approx(whole, rel=1e-6)
    assert whole != pytest.approx(per_query, rel=1e-6)
