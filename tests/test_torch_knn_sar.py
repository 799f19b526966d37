"""The port's nearest neighbours (``mmlspark_tpu_torch/nn/``) and SAR with
the ranking stages (``mmlspark_tpu_torch/recommendation/``) against the
JAX package's, on the same seeded inputs, at
``tests/test_nn_reco_iforest.py``'s tiny sizes.

Tolerances: KNN ids equal (ties to the lower corpus index, as
``jax.lax.top_k``), squared distances within 1e-5 · (1 + the largest)
(float32 ``‖q‖² + ‖c‖² − 2 q·c`` through another matmul), and bitwise on
integer data, where every sum is exact. ``ConditionalKNN`` and the ball
tree are host numpy: equal. SAR's co-occurrence counts are exact in
float32, so the item similarity is bitwise the JAX package's; the scores
``A · S`` are within 1e-6 · (1 + the largest |score|). The ranking
stages are numpy: equal.
"""

import numpy as np
import pytest
import torch

import mmlspark_tpu.nn as JN
import mmlspark_tpu.recommendation as JR
import mmlspark_tpu_torch.nn as PN
import mmlspark_tpu_torch.recommendation as PR
from mmlspark_tpu.core import DataFrame as JDF
from mmlspark_tpu_torch.core import DataFrame as PDF
from mmlspark_tpu_torch.models.zoo.transformer import _topk_stable
from mmlspark_tpu_torch.nn.knn import topk_stable
from test_torch_vw import jax_saved_into_port

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def _vec_col(X):
    col = np.empty(len(X), dtype=object)
    for i in range(len(X)):
        col[i] = X[i]
    return col


def _dist_close(got, want):
    """Squared distances within 1e-5 · (1 + the largest): the float32
    rounding of ‖q‖² + ‖c‖² − 2 q·c, which ``sqrt`` magnifies near 0."""
    got, want = np.asarray(got, np.float64) ** 2, np.asarray(want,
                                                             np.float64) ** 2
    tol = 1e-5 * (1.0 + float(np.max(want)))
    assert float(np.abs(got - want).max()) <= tol


# ---------------------------------------------------------------------------
# KNN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_topk_stable_equals_the_full_stable_sort(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-3, 4, (9, 57)).astype(np.float32))
    x[0, :6] = -0.0
    x[1, :] = 0.0
    x[2, 3] = float("inf")
    x[3, 5] = -float("inf")
    for k in (1, 7, 57):
        got = topk_stable(x, k)
        want = _topk_stable(x + 0.0, k)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("budget", [None, 4 * 500 * 3])
def test_brute_force_ids_and_distances(budget):
    rng = np.random.default_rng(0)
    C, Q = rng.normal(0, 1, (500, 16)), rng.normal(0, 1, (40, 16))
    kw = {} if budget is None else {"budget": budget}   # 3 queries a chunk
    i_p, d_p = PN.brute_force_knn(C, Q, 7, device="cpu", **kw)
    i_j, d_j = JN.brute_force_knn(C, Q, 7)
    np.testing.assert_array_equal(i_p, i_j)
    assert d_p.dtype == np.float32
    _dist_close(d_p, d_j)


def test_brute_force_ties_bitwise():
    """Integer points: every distance is exact, many tie, and the port's
    ids (lower index first) and distances are bitwise the JAX package's."""
    rng = np.random.default_rng(1)
    C = rng.integers(0, 3, (300, 4)).astype(np.float64)
    Q = np.vstack([rng.integers(0, 3, (30, 4)), C[:5]]).astype(np.float64)
    for k in (1, 9, 300):
        i_p, d_p = PN.brute_force_knn(C, Q, k, device="cpu", budget=4 * 300)
        i_j, d_j = JN.brute_force_knn(C, Q, k)
        np.testing.assert_array_equal(i_p, i_j)
        np.testing.assert_array_equal(d_p, d_j)


def test_knn_model_matches_reference_and_reference_save_loads(tmp_path):
    rng = np.random.default_rng(2)
    X = rng.normal(0, 1, (100, 4))
    cols = {"features": _vec_col(X),
            "values": [f"doc{i}" for i in range(100)]}
    jm = JN.KNN(k=3).fit(JDF(dict(cols)))
    pm = PN.KNN(k=3, device="cpu").fit(PDF(dict(cols)))
    assert pm.device.type == "cpu"
    q = rng.normal(0, 1, (12, 4))
    qdf = {"features": _vec_col(np.vstack([X[:3], q]))}
    jo = jm.transform(JDF(dict(qdf)))["output"]
    po = pm.transform(PDF(dict(qdf)))["output"]
    for a, b in zip(po, jo):
        assert [m["value"] for m in a] == [m["value"] for m in b]
        _dist_close(np.array([m["distance"] for m in a]),
                    np.array([m["distance"] for m in b]))
    assert po[0][0]["value"] == "doc0"
    jm.save(str(tmp_path / "jax"))
    loaded = PN.KNNModel.load(jax_saved_into_port(
        str(tmp_path / "jax"), str(tmp_path / "port")), device="cpu")
    again = loaded.transform(PDF(dict(qdf)))["output"]
    assert [[m["value"] for m in r] for r in again] == \
        [[m["value"] for m in r] for r in jo]


def test_conditional_knn_and_ball_tree_equal_reference():
    rng = np.random.default_rng(3)
    X = rng.normal(0, 1, (60, 3))
    labels = np.array(["a", "b", "c"] * 20)
    cols = {"features": _vec_col(X), "labels": labels,
            "values": list(range(60))}
    q = {"features": _vec_col(X[:4]),
         "conditioner": [["a"], ["b"], ["a", "c"], None]}
    jo = JN.ConditionalKNN(k=4, leaf_size=8).fit(JDF(dict(cols))).transform(
        JDF(dict(q)))["output"]
    po = PN.ConditionalKNN(k=4, leaf_size=8).fit(PDF(dict(cols))).transform(
        PDF(dict(q)))["output"]
    assert list(po) == list(jo)
    assert all(m["label"] == "a" for m in po[0])
    tj = JN.BallTree(X, labels=labels, leaf_size=16)
    tp = PN.BallTree.from_tree(PN.BallTree(X, labels=labels,
                                           leaf_size=16).to_tree())
    for i in range(5):
        a = tp.query(X[i] + 0.1, k=5, allowed_labels={"a", "b"})
        b = tj.query(X[i] + 0.1, k=5, allowed_labels={"a", "b"})
        assert list(a[0]) == list(b[0])
        np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# SAR and the ranking stages
# ---------------------------------------------------------------------------

def _interactions(n_users=12, n_items=20, n=150, seed=4, ints=False):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n)
    # two tastes: even users like low items, odd users high ones
    items = np.where(users % 2 == 0, rng.integers(0, n_items // 2, n),
                     rng.integers(n_items // 2, n_items, n))
    cols = {"user": users, "item": items}
    if not ints:
        cols["rating"] = rng.integers(1, 6, n).astype(np.float64)
        cols["time"] = 1.6e9 + rng.uniform(0, 90 * 86400, n)
    return cols


@pytest.mark.parametrize("sim", ["jaccard", "lift", "cooccurrence"])
def test_sar_similarity_bitwise_and_scores_close(sim):
    cols = _interactions()
    kw = dict(similarity_function=sim, support_threshold=2,
              time_col="time", time_decay_coeff=30)
    jm = JR.SAR(**kw).fit(JDF(dict(cols)))
    pm = PR.SAR(device="cpu", **kw).fit(PDF(dict(cols)))
    np.testing.assert_array_equal(pm.get("item_similarity"),
                                  np.asarray(jm.get("item_similarity")))
    np.testing.assert_array_equal(pm.get("user_affinity"),
                                  np.asarray(jm.get("user_affinity")))
    sj, sp = jm._scores(), pm._scores()
    assert float(np.abs(sp - sj).max()) <= 1e-6 * (1 + float(
        np.abs(sj).max()))
    pairs = {"user": np.array([0, 1, 5, 11, 40]),
             "item": np.array([1, 15, 2, 19, 3])}
    pj = jm.transform(JDF(dict(pairs)))["prediction"]
    pp = pm.transform(PDF(dict(pairs)))["prediction"]
    assert pp[3] == pj[3] == 0.0 or abs(pp[3] - pj[3]) <= 1e-6
    np.testing.assert_allclose(pp, pj, rtol=1e-6, atol=1e-6)


def test_recommend_for_all_users_separated_and_tied():
    """Continuous scores (each row's five best unseen items more than 1e-4
    apart): the same lists; integer scores (cooccurrence similarity, unit
    ratings, no decay: exact sums with ties): the same items as sets, the
    same ratings."""
    rng = np.random.default_rng(1)
    cols = {"user": rng.integers(0, 30, 400), "item": rng.integers(0, 40, 400),
            "rating": rng.uniform(1, 5, 400),
            "time": 1.6e9 + rng.uniform(0, 90 * 86400, 400)}
    kw = dict(support_threshold=1, time_col="time")
    jm = JR.SAR(**kw).fit(JDF(dict(cols)))
    pm = PR.SAR(device="cpu", **kw).fit(PDF(dict(cols)))
    s = np.where(np.asarray(jm.get("user_affinity")) > 0, -np.inf,
                 jm._scores())
    top = -np.sort(-s, axis=1)[:, :5]
    assert np.isfinite(top).all() and (np.diff(-top, axis=1) > 1e-4).all()
    jr = jm.recommend_for_all_users(k=4)
    pr = pm.recommend_for_all_users(k=4)
    assert list(pr["recommendations"]) == list(jr["recommendations"])
    for a, b in zip(pr["ratings"], jr["ratings"]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    ints = _interactions(seed=6, ints=True)
    kw = dict(support_threshold=1, similarity_function="cooccurrence")
    jm = JR.SAR(**kw).fit(JDF(dict(ints)))
    pm = PR.SAR(device="cpu", **kw).fit(PDF(dict(ints)))
    np.testing.assert_array_equal(pm._scores(), jm._scores())
    jr = jm.recommend_for_all_users(k=5, remove_seen=False)
    pr = pm.recommend_for_all_users(k=5, remove_seen=False)
    assert any(len(set(r)) < len(r) for r in jr["ratings"])  # ties exist
    for a, b in zip(pr["recommendations"], jr["recommendations"]):
        assert set(a) == set(b)
    assert list(pr["ratings"]) == list(jr["ratings"])


def test_reference_saved_sar_predicts_in_the_port(tmp_path):
    cols = _interactions(seed=7)
    jm = JR.SAR(support_threshold=1).fit(JDF(dict(cols)))
    jm.save(str(tmp_path / "jax"))
    pm = PR.SARModel.load(jax_saved_into_port(
        str(tmp_path / "jax"), str(tmp_path / "port")), device="cpu")
    pairs = {"user": np.arange(6), "item": np.arange(6) * 3}
    np.testing.assert_allclose(pm.transform(PDF(dict(pairs)))["prediction"],
                               jm.transform(JDF(dict(pairs)))["prediction"],
                               rtol=1e-6, atol=1e-7)


def test_ranking_stages_equal_reference():
    ids = {"user": ["u1", "u2", "u1", "u3"], "item": ["iA", "iB", "iB", "iC"]}
    jx = JR.RecommendationIndexer().fit(JDF(dict(ids)))
    px = PR.RecommendationIndexer().fit(PDF(dict(ids)))
    jo, po = jx.transform(JDF(dict(ids))), px.transform(PDF(dict(ids)))
    np.testing.assert_array_equal(po["user_idx"], jo["user_idx"])
    np.testing.assert_array_equal(po["item_idx"], jo["item_idx"])
    assert px.recover_item(po["item_idx"][1]) == "iB"
    lists = {"recommendations": [[1, 2, 3], [4, 5, 6], [9, 1]],
             "labels": [[1, 3], [9], [9]]}
    for k in (1, 3):
        assert PR.RankingEvaluator(k=k).transform(PDF(dict(lists))
                                                  ).to_rows() == \
            JR.RankingEvaluator(k=k).transform(JDF(dict(lists))).to_rows()
    rng = np.random.default_rng(8)
    rows = [(u, i) for u in range(8) for i in range(10) if rng.random() > 0.4]
    cols = {"user": np.array([r[0] for r in rows]),
            "item": np.array([r[1] for r in rows])}
    jt = JR.RankingTrainValidationSplit(
        recommender=JR.SAR(support_threshold=1), train_ratio=0.7, k=4,
        seed=0)
    pt = PR.RankingTrainValidationSplit(
        recommender=PR.SAR(support_threshold=1, device="cpu"),
        train_ratio=0.7, k=4, seed=0)
    jmod, pmod = jt.fit(JDF(dict(cols))), pt.fit(PDF(dict(cols)))
    assert set(pt.validation_metrics) == {"ndcgAt", "map", "precisionAtk",
                                          "recallAtK"}
    for key, v in jt.validation_metrics.items():
        assert pt.validation_metrics[key] == pytest.approx(v, abs=1e-12)
    jo = jmod.transform(JDF(dict(cols)))
    po = pmod.transform(PDF(dict(cols)))
    assert list(po["recommendations"]) == list(jo["recommendations"])
