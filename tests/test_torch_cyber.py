"""The port's CyberML (``mmlspark_tpu_torch/cyber/``) and isolation forest
(``mmlspark_tpu_torch/isolationforest/``) against the JAX package's, on
the same seeded inputs, at ``tests/test_cyber.py``'s and
``tests/test_nn_reco_iforest.py``'s tiny sizes.

Tolerances: the indexers, scalers, complement draws, the data generator
and the isolation forest are host numpy copies: equal (bitwise). ALS runs
through another matmul and solve (``torch.linalg.solve``: LAPACK ``gesv``
here; the JAX package's CPU solve is ``sgetrf`` + two ``strsm``) from the
same initial factors: the factors within 1e-5 of the largest |factor|,
the anomaly scores within 1e-5 · (1 + the largest finite |score|), and
the special cases (seen → 0, unknown → None, another component → +inf)
equal.
"""

import numpy as np
import pytest
import torch

import mmlspark_tpu.cyber as JC
import mmlspark_tpu_torch.cyber as PC
from mmlspark_tpu.core import DataFrame as JDF
from mmlspark_tpu.cyber.access_anomaly import _als as j_als
from mmlspark_tpu.isolationforest import IsolationForest as JIF
from mmlspark_tpu_torch.core import DataFrame as PDF
from mmlspark_tpu_torch.core.dataframe import object_col
from mmlspark_tpu_torch.cyber.access_anomaly import _als as p_als
from mmlspark_tpu_torch.isolationforest import (IsolationForest,
                                                IsolationForestModel)
from test_torch_knn_sar import _vec_col
from test_torch_vw import jax_saved_into_port

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def _frames(cols):
    return JDF(dict(cols)), PDF(dict(cols))


def _cols(df):
    return {c: df[c] for c in df.columns}


def _acc_cols():
    return {"tenant": object_col(["a", "a", "a", "b", "b", "b"]),
            "user": object_col(["u1", "u2", "u1", "u1", "u3", "u3"]),
            "res": object_col(["r1", "r1", "r2", "r9", "r9", "r7"]),
            "likelihood": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 0.5])}


def _same_frames(a, b):
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        x, y = a[c], b[c]
        if x.dtype == object:
            assert list(x) == list(y), c
        else:
            assert x.dtype == y.dtype, c
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the host stages: equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reset", [True, False])
def test_indexers_equal_reference(reset):
    jdf, pdf = _frames(_acc_cols())
    kw = dict(partition_key="tenant", reset_per_partition=reset)
    jm = JC.MultiIndexer([
        JC.IdIndexer(input_col="user", output_col="uidx", **kw),
        JC.IdIndexer(input_col="res", output_col="ridx", **kw)]).fit(jdf)
    pm = PC.MultiIndexer([
        PC.IdIndexer(input_col="user", output_col="uidx", **kw),
        PC.IdIndexer(input_col="res", output_col="ridx", **kw)]).fit(pdf)
    _same_frames(pm.transform(pdf), jm.transform(jdf))
    q = {"tenant": object_col(["a", "b"]), "user": object_col(["zz", "u3"])}
    ju = jm.get_model_by_input_col("user")
    pu = pm.get_model_by_input_col("user")
    _same_frames(pu.transform(PDF(dict(q))), ju.transform(JDF(dict(q))))
    out = pu.transform(pdf)
    _same_frames(pu.undo_transform(out.select(["tenant", "uidx"])),
                 ju.undo_transform(ju.transform(jdf).select(["tenant",
                                                             "uidx"])))


@pytest.mark.parametrize("kind", ["standard", "linear"])
def test_scalers_equal_reference(kind):
    jdf, pdf = _frames(_acc_cols())
    name = "StandardScalarScaler" if kind == "standard" \
        else "LinearScalarScaler"
    kw = dict(input_col="likelihood", output_col="s",
              partition_key="tenant")
    if kind == "linear":
        kw.update(min_required_value=5.0, max_required_value=10.0)
    want = getattr(JC, name)(**kw).fit(jdf).transform(jdf)
    got = getattr(PC, name)(**kw).fit(pdf).transform(pdf)
    _same_frames(got, want)


@pytest.mark.parametrize("key,factor,seed", [(None, 4, 0), ("tenant", 6, 1),
                                             (None, 8, 5)])
def test_complement_draws_equal_reference(key, factor, seed):
    cols = {"tenant": object_col(["a", "a", "b", "b", "b"]),
            "u": np.array([1, 2, 1, 3, 2]), "r": np.array([1, 2, 1, 3, 4])}
    jdf, pdf = _frames(cols)
    kw = dict(partition_key=key, indexed_col_names=["u", "r"],
              complementset_factor=factor, seed=seed)
    _same_frames(PC.ComplementAccessTransformer(**kw).transform(pdf),
                 JC.ComplementAccessTransformer(**kw).transform(jdf))


def test_data_factory_equal_reference():
    kw = dict(num_hr_users=6, num_hr_resources=9, num_fin_users=5,
              num_fin_resources=7, seed=4)
    jf, pf = JC.DataFactory(**kw), PC.DataFactory(**kw)
    _same_frames(pf.create_clustered_training_data(0.4),
                 jf.create_clustered_training_data(0.4))
    _same_frames(pf.create_clustered_intra_test_data(10),
                 jf.create_clustered_intra_test_data(10))
    _same_frames(pf.create_clustered_inter_test_data(10),
                 jf.create_clustered_inter_test_data(10))


# ---------------------------------------------------------------------------
# ALS and AccessAnomaly: to a tolerance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("implicit", [True, False])
def test_als_factors_match_reference(implicit):
    rng = np.random.default_rng(6)
    M = (rng.random((14, 9)) < 0.4).astype(np.float64)
    R = M * rng.uniform(5, 10, M.shape)
    U1, V1 = p_als(R, M, 4, 12, 1.0, implicit, 1.0, 3, torch.device("cpu"))
    U2, V2 = j_als(R, M, 4, 12, 1.0, implicit, 1.0, 3)
    assert U1.dtype == V1.dtype == np.float32
    for a, b in ((U1, U2), (V1, V2)):
        assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(b).max())


def _scores(col):
    return np.array([np.nan if s is None else s for s in col], np.float64)


def _scores_close(got, want):
    g, w = _scores(got), _scores(want)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    tol = 1e-5 * (1.0 + float(np.abs(w[fin]).max(initial=0.0)))
    assert float(np.abs(g[fin] - w[fin]).max(initial=0.0)) <= tol
    assert ((g == 0.0) == (w == 0.0)).all()


@pytest.fixture(scope="module")
def fitted():
    """The JAX package's fixture (tests/test_cyber.py), fitted by both."""
    factory = JC.DataFactory(num_hr_users=10, num_hr_resources=15,
                             num_fin_users=10, num_fin_resources=15, seed=2)
    train = _cols(factory.create_clustered_training_data(ratio=0.4))
    intra = _cols(factory.create_clustered_intra_test_data(30))
    inter = _cols(factory.create_clustered_inter_test_data(30))
    kw = dict(rank_param=6, max_iter=15, seed=0)
    jm = JC.AccessAnomaly(**kw).fit(JDF(dict(train)))
    pm = PC.AccessAnomaly(device="cpu", **kw).fit(PDF(dict(train)))
    return train, intra, inter, jm, pm


def test_access_anomaly_matches_reference(fitted):
    train, intra, inter, jm, pm = fitted
    for t in jm._state["user_maps"]:
        for side in ("user_maps", "res_maps"):
            jmap, pmap = jm._state[side][t], pm._state[side][t]
            assert list(jmap) == list(pmap)
            a, b = np.stack(list(pmap.values())), np.stack(list(jmap.values()))
            assert float(np.abs(a - b).max()) <= 1e-5 * float(
                np.abs(b).max())
    assert pm._state["seen"] == jm._state["seen"]
    assert pm._state["comps"] == jm._state["comps"]
    for cols in (intra, inter, train):
        _scores_close(pm.transform(PDF(dict(cols)))["anomaly_score"],
                      jm.transform(JDF(dict(cols)))["anomaly_score"])
    si = _scores(pm.transform(PDF(dict(intra)))["anomaly_score"])
    sx = _scores(pm.transform(PDF(dict(inter)))["anomaly_score"])
    assert np.nanmean(sx[np.isfinite(sx)]) > \
        np.nanmean(si[np.isfinite(si)]) + 0.5
    assert set(pm.phase_seconds) == {"als", "host"}


def test_access_anomaly_explicit_mode_matches_reference():
    factory = JC.DataFactory(num_hr_users=8, num_hr_resources=10,
                             num_fin_users=8, num_fin_resources=10, seed=3)
    train = _cols(factory.create_clustered_training_data(ratio=0.5))
    inter = _cols(factory.create_clustered_inter_test_data(20))
    kw = dict(rank_param=5, max_iter=10, apply_implicit_cf=False, seed=0)
    jm = JC.AccessAnomaly(**kw).fit(JDF(dict(train)))
    pm = PC.AccessAnomaly(device="cpu", **kw).fit(PDF(dict(train)))
    _scores_close(pm.transform(PDF(dict(inter)))["anomaly_score"],
                  jm.transform(JDF(dict(inter)))["anomaly_score"])


def test_reference_saved_model_scores_in_the_port(fitted, tmp_path):
    train, intra, inter, jm, _ = fitted
    jm.save(str(tmp_path / "jax"))
    pm = PC.AccessAnomalyModel.load(jax_saved_into_port(
        str(tmp_path / "jax"), str(tmp_path / "port")))
    for cols in (inter, intra):
        got = _scores(pm.transform(PDF(dict(cols)))["anomaly_score"])
        want = _scores(jm.transform(JDF(dict(cols)))["anomaly_score"])
        np.testing.assert_array_equal(got, want)


def test_save_load_hostile_tenants_and_unknowns(tmp_path):
    factory = PC.DataFactory(num_hr_users=6, num_hr_resources=8,
                             num_fin_users=6, num_fin_resources=8, seed=3)
    train = factory.create_clustered_training_data(ratio=0.5)
    train = train.with_column("tenant", object_col(
        [f"ten/ant:{t}" for t in train["tenant"]]))
    model = PC.AccessAnomaly(device="cpu", rank_param=4, max_iter=5,
                             seed=0).fit(train)
    model.save(str(tmp_path / "aa"))
    back = PC.AccessAnomalyModel.load(str(tmp_path / "aa"))
    test = train.head(5)
    assert list(back.transform(test)["anomaly_score"]) == \
        list(model.transform(test)["anomaly_score"]) == [0.0] * 5
    q = PDF({"tenant": object_col(["ten/ant:t0"]),
             "user": object_col(["nobody"]), "res": object_col(["hr_res_0"])})
    assert back.transform(q)["anomaly_score"][0] is None
    num = PDF({"tenant": np.array([7] * 6),
               "user": object_col(["u1", "u2", "u3", "u1", "u2", "u3"]),
               "res": object_col(["r1", "r1", "r2", "r2", "r3", "r3"]),
               "likelihood": np.ones(6)})
    m = PC.AccessAnomaly(device="cpu", rank_param=2, max_iter=3).fit(num)
    m.save(str(tmp_path / "num"))
    assert all(s == 0.0 for s in PC.AccessAnomalyModel.load(
        str(tmp_path / "num")).transform(num)["anomaly_score"])


# ---------------------------------------------------------------------------
# the isolation forest: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(num_estimators=50, max_samples=64,
                                     contamination=3 / 203),
                                dict(num_estimators=20, max_samples=32,
                                     max_features=0.5, seed=3)])
def test_isolation_forest_bitwise(kw, tmp_path):
    rng = np.random.default_rng(5)
    X = np.vstack([rng.normal(0, 0.5, (200, 2)),
                   [[6.0, 6.0], [-7.0, 7.0], [8.0, -6.0]]])
    if "max_features" in kw:
        X = np.hstack([X, rng.normal(0, 1, (len(X), 2))])
    cols = {"features": _vec_col(X)}
    jm = JIF(**kw).fit(JDF(dict(cols)))
    pm = IsolationForest(**kw).fit(PDF(dict(cols)))
    jo, po = jm.transform(JDF(dict(cols))), pm.transform(PDF(dict(cols)))
    np.testing.assert_array_equal(po["outlierScore"], jo["outlierScore"])
    np.testing.assert_array_equal(po["prediction"], jo["prediction"])
    jm.save(str(tmp_path / "jax"))
    back = IsolationForestModel.load(jax_saved_into_port(
        str(tmp_path / "jax"), str(tmp_path / "port")))
    np.testing.assert_array_equal(
        back.transform(PDF(dict(cols)))["outlierScore"], jo["outlierScore"])
