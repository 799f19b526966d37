"""The port's VowpalWabbit module (``mmlspark_tpu_torch/vw/``) against the
JAX package's, on the same seeded inputs, at ``tests/test_vw.py``'s tiny
sizes.

Tolerances: murmur3 (native and plain), the featurizer's indices and
values and the native padding are bitwise. Trained weights, margins and
bandit scores are float32 sums of gathered weights and scatter-added
updates taken in another order: within 1e-6 of the largest |weight| (or
|score|) plus 1e-7 (observed: one or two float32 ulps).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import mmlspark_tpu.vw as J
import mmlspark_tpu_torch.vw as P
from mmlspark_tpu.core import DataFrame as JDF
from mmlspark_tpu.native import murmur3_batch as j_murmur3_batch
from mmlspark_tpu.native import pad_sparse as j_pad_sparse
from mmlspark_tpu.vw.featurizer import NUM_BITS_KEY
from mmlspark_tpu.vw.featurizer import sparse_column as jsc
from mmlspark_tpu.vw.murmur import murmur3_32 as j_murmur3
from mmlspark_tpu_torch import native
from mmlspark_tpu_torch.core import DataFrame as PDF
from mmlspark_tpu_torch.vw import learners as PL
from mmlspark_tpu_torch.vw.murmur import _murmur3_32_py, murmur3_32

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

LOSSES = {"squared": "reg", "quantile": "reg", "logistic": "clf",
          "hinge": "clf"}


def _close(a, b, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tol = 1e-6 * max(1.0, float(np.abs(b).max(initial=0.0))) + 1e-7
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


def jax_saved_into_port(src, dst):
    """A copy of a stage the JAX package saved, its class paths pointed at
    the port's modules (the payload format is shared; the port's loader
    imports only its own package)."""
    shutil.copytree(src, dst)
    for root, _, files in os.walk(dst):
        if "metadata.json" in files:
            path = os.path.join(root, "metadata.json")
            meta = json.load(open(path))
            meta["class"] = meta["class"].replace("mmlspark_tpu.",
                                                  "mmlspark_tpu_torch.", 1)
            json.dump(meta, open(path, "w"))
    return dst


# ---------------------------------------------------------------------------
# hashing and padding: bitwise
# ---------------------------------------------------------------------------

def _byte_strings(seed=0, n=200):
    rng = np.random.default_rng(seed)
    out = [b"", b"a", b"hello", b"hello, world",
           b"The quick brown fox jumps over the lazy dog",
           "col\x1fvalé".encode("utf-8"), b"\x00\x00\x01"]
    out += [rng.integers(0, 256, int(rng.integers(0, 40)),
                         dtype=np.uint8).tobytes() for _ in range(n)]
    return out


def test_murmur3_native_plain_and_reference_bitwise():
    assert murmur3_32(b"", 1) == 0x514E28B7
    assert murmur3_32(b"The quick brown fox jumps over the lazy dog", 0) \
        == 0x2E4FF723
    for seed in (0, 1, 0xDEADBEEF, 0xFFFFFFFF, -5):
        for data in _byte_strings(seed % 7):
            want = j_murmur3(data, seed)
            assert native.murmur3(data, seed) == want
            assert _murmur3_32_py(data, seed) == want
            assert murmur3_32(data, seed) == want


@pytest.mark.parametrize("mask", [0xFFFFFFFF, (1 << 18) - 1, 0xFF])
def test_murmur3_batch_bitwise(mask):
    items = _byte_strings(3)
    got = native.murmur3_batch(items, 12345, mask)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, j_murmur3_batch(items, 12345, mask))
    np.testing.assert_array_equal(got, np.asarray(
        [_murmur3_32_py(b, 12345) & mask for b in items], np.uint32))
    assert native.murmur3_batch([], 0, mask).shape == (0,)


def test_pad_sparse_native_plain_and_reference_bitwise():
    rng = np.random.default_rng(4)
    rows = []
    for i in range(60):
        k = int(rng.integers(0, 9))
        idx = rng.integers(0, 1 << 31, k, dtype=np.int64).astype(np.uint32)
        rows.append((idx, rng.normal(0, 1, k).astype(np.float32)))
    rows[5] = (np.array([3, 4, 5], np.uint32), np.array([1.0], np.float32))
    rows[6] = ([7, 8], [0.5, 0.25, 9.0])           # lists, longer values
    rows[7] = (np.array([], np.uint32), np.array([], np.float32))
    for K in (1, 4, 8, 12):
        got = native.pad_sparse(rows, K)
        want = j_pad_sparse(rows, K)
        plain = PL.pad_sparse_plain(rows, K)
        for a, b, c in zip(got, want, plain):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    i, v = PL.pad_sparse(jsc(rows))
    assert i.shape == (60, 8) and v[7].sum() == 0


# ---------------------------------------------------------------------------
# the featurizer: bitwise
# ---------------------------------------------------------------------------

def _feature_frames():
    cols = {
        "num": np.array([1.5, 0.0, -2.0, 3.0]),
        "cat": np.array(["a", "b", "a", None], dtype=object),
        "txt": np.array(["red green", "blue", "", "red red"], dtype=object),
        "flag": np.array([True, False, True, True], dtype=object),
        "m": jsc([{"a": 2.0, "b": 0.0}, {"c": 1.0}, {}, {"a": -1.0}]),
        "v": jsc([np.array([1.0, 0.0, 3.0]), np.zeros(3), np.ones(3),
                  np.array([0.0, 2.0, 0.0])]),
        "toks": jsc([["x", "y"], [], ["y"], ["x", "x"]]),
    }
    return JDF(dict(cols)), PDF(dict(cols))


@pytest.mark.parametrize("bits,collide,seed", [(15, True, 0), (18, False, 7),
                                               (4, True, 3)])
def test_featurizer_bitwise(bits, collide, seed):
    jdf, pdf = _feature_frames()
    kw = dict(input_cols=list(jdf.columns), string_split_cols=["txt"],
              num_bits=bits, sum_collisions=collide, seed=seed)
    want = J.VowpalWabbitFeaturizer(**kw).transform(jdf)
    got = P.VowpalWabbitFeaturizer(**kw).transform(pdf)
    assert got.column_metadata("features")[NUM_BITS_KEY] == bits
    for (gi, gv), (wi, wv) in zip(got["features"], want["features"]):
        assert gi.dtype == wi.dtype and gv.dtype == wv.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)


def test_interactions_bitwise():
    jdf, pdf = _feature_frames()
    outs = []
    for mod, df in ((J, jdf), (P, pdf)):
        df = mod.VowpalWabbitFeaturizer(input_cols=["cat", "txt"],
                                        output_col="fa",
                                        string_split_cols=["txt"],
                                        num_bits=12).transform(df)
        df = mod.VowpalWabbitFeaturizer(input_cols=["num", "v"],
                                        output_col="fb",
                                        num_bits=12).transform(df)
        outs.append(mod.VowpalWabbitInteractions(
            input_cols=["fa", "fb"], num_bits=12).transform(df))
    for (gi, gv), (wi, wv) in zip(outs[1]["interactions"],
                                  outs[0]["interactions"]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)


# ---------------------------------------------------------------------------
# the learners
# ---------------------------------------------------------------------------

def _rows(n=300, bits=10, seed=0, zero_bucket_every=7):
    """Random hashed rows (1-5 features each, bucket 0 planted often, so
    that it meets the padding slots' index 0) and 0/1 labels."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = int(rng.integers(1, 6))
        idx = rng.integers(0, 1 << bits, k).astype(np.uint32)
        if i % zero_bucket_every == 0:
            idx[0] = 0
        rows.append((idx, rng.normal(0, 1, k).astype(np.float32)))
    y = (rng.random(n) < 0.5).astype(np.float64)
    return rows, y, rng.normal(2.0, 0.5, n)


def _fit_both(loss, rows, labels, **kw):
    est = "Classifier" if LOSSES[loss] == "clf" else "Regressor"
    kw = dict(loss_function=loss, use_all_reduce=False, **kw)
    cols = {"features": jsc(rows), "label": labels}
    jm = getattr(J, f"VowpalWabbit{est}")(**kw).fit(JDF(dict(cols)))
    pm = getattr(P, f"VowpalWabbit{est}")(device="cpu", **kw).fit(
        PDF(dict(cols)))
    return jm, pm, cols


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("reg", [(0.0, 0.0), (1e-3, 1e-2)])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_weights_and_predictions_match_reference(loss, reg, passes):
    """Weights and adagrad state after 1 and 2 passes (300 rows in
    minibatches of 16: the last one padded with 4 zero-weight rows that
    still advance the schedule), and the model's outputs."""
    rows, y, target = _rows()
    labels = y if LOSSES[loss] == "clf" else target
    jm, pm, cols = _fit_both(loss, rows, labels, num_passes=passes,
                             mini_batch=16, l1=reg[0], l2=reg[1],
                             num_bits=10, quantile_tau=0.8)
    _close(pm.get("weights"), np.asarray(jm.get("weights")), "weights")
    _close(pm.get("adaptive_state"), np.asarray(jm.get("adaptive_state")),
           "adaptive state")
    assert pm.train_steps == passes * 19
    jo, po = jm.transform(JDF(dict(cols))), pm.transform(PDF(dict(cols)))
    if LOSSES[loss] == "clf":
        _close(po["rawPrediction"], jo["rawPrediction"], "margins")
        _close(po["probability"], jo["probability"], "probabilities")
        margin = np.abs(np.asarray(jo["rawPrediction"])) > 1e-5
        np.testing.assert_array_equal(po["prediction"][margin],
                                      jo["prediction"][margin])
    else:
        _close(po["prediction"], jo["prediction"], "predictions")
    assert list(pm.performance_statistics.columns) == \
        list(jm.performance_statistics.columns)


def test_shrink_write_keeps_the_last_duplicate():
    """One minibatch where bucket 0 is a real feature and a padding slot:
    the row-major last occurrence decides whether bucket 0 is written
    shrunk (row 1 holds it as a feature, after row 0's padding) or
    unshrunk (row 2's padding comes last). The JAX package (XLA's CPU
    scatter) and the port agree; keeping the first occurrence instead
    would not."""
    f32 = np.float32
    rows = [(np.array([5], np.uint32), np.array([1.0], f32)),      # pads 0
            (np.array([7, 0, 3], np.uint32), np.array([0.5, 2.0, 1.0],
                                                     f32)),
            (np.array([0], np.uint32), np.array([1.5], f32))]      # pads 0
    for order in ([0, 1, 2], [2, 1, 0], [1, 0, 2]):
        sub = [rows[i] for i in order]
        y = np.array([1.0, 0.0, 1.0])[order]
        jm, pm, _ = _fit_both("logistic", sub, y, num_passes=2,
                              mini_batch=3, l1=0.2, l2=0.1, num_bits=4,
                              learning_rate=2.0)
        wj, wp = np.asarray(jm.get("weights")), pm.get("weights")
        _close(wp, wj, f"weights, row order {order}")
        assert wj[0] != 0.0


def test_warm_start_from_a_reference_fit():
    rows, y, target = _rows(n=200, seed=3)
    jm, pm, cols = _fit_both("squared", rows, target, num_passes=3,
                             num_bits=10, learning_rate=1.0)
    warm = dict(initial_model=np.asarray(jm.get("weights")),
                initial_adaptive_state=np.asarray(jm.get("adaptive_state")),
                num_passes=1, num_bits=10, label_col="label")
    jw = J.VowpalWabbitRegressor(use_all_reduce=False, **warm).fit(
        JDF(dict(cols)))
    pw = P.VowpalWabbitRegressor(device="cpu", **warm).fit(PDF(dict(cols)))
    _close(pw.get("weights"), np.asarray(jw.get("weights")), "warm weights")
    with pytest.raises(ValueError, match="initial_model"):
        P.VowpalWabbitRegressor(device="cpu", num_bits=10,
                                initial_model=np.zeros(3)).fit(
            PDF(dict(cols)))


def test_reference_saved_model_predicts_in_the_port(tmp_path):
    rows, y, _ = _rows(n=120, seed=5)
    jm, _, cols = _fit_both("logistic", rows, y, num_passes=2, num_bits=10)
    jm.save(str(tmp_path / "jax"))
    path = jax_saved_into_port(str(tmp_path / "jax"), str(tmp_path / "port"))
    pm = P.VowpalWabbitClassifierModel.load(path, device="cpu")
    assert pm.device.type == "cpu"
    jo, po = jm.transform(JDF(dict(cols))), pm.transform(PDF(dict(cols)))
    _close(po["rawPrediction"], jo["rawPrediction"], "margins")
    np.testing.assert_array_equal(pm.get("weights"),
                                  np.asarray(jm.get("weights")))
    # and the port's own save / load round trip
    pm.save(str(tmp_path / "again"))
    back = P.VowpalWabbitClassifierModel.load(str(tmp_path / "again"),
                                              device="cpu")
    np.testing.assert_array_equal(back.transform(PDF(dict(cols)))
                                  ["rawPrediction"], po["rawPrediction"])


def test_labels_and_default_all_reduce():
    rows, y, _ = _rows(n=64, seed=6)
    with pytest.raises(ValueError, match="binary labels"):
        P.VowpalWabbitClassifier(device="cpu").fit(
            PDF({"features": jsc(rows), "label": y * 3}))
    # use_all_reduce=True (the default) trains on one device in the port,
    # as the JAX package does without a default mesh
    kw = dict(num_bits=10, num_passes=2)
    cols = {"features": jsc(rows), "label": y}
    jw = J.VowpalWabbitClassifier(**kw).fit(JDF(dict(cols))).get("weights")
    pw = P.VowpalWabbitClassifier(device="cpu", **kw).fit(
        PDF(dict(cols))).get("weights")
    _close(pw, np.asarray(jw), "weights")


def test_fit_multiple_sweeps_params():
    rows, y, _ = _rows(n=80, seed=8)
    clf = P.VowpalWabbitClassifier(device="cpu", num_bits=10)
    models = clf.fit_multiple(PDF({"features": jsc(rows), "label": y}),
                              [{"learning_rate": 0.1},
                               {"learning_rate": 1.0}])
    assert len(models) == 2
    assert all(m.device.type == "cpu" for m in models)
    assert not np.allclose(models[0].get("weights"),
                           models[1].get("weights"))


# ---------------------------------------------------------------------------
# the contextual bandit
# ---------------------------------------------------------------------------

def _bandit_frame(n=300, k=3, bits=12, seed=9):
    rng = np.random.default_rng(seed)
    shared, acts, chosen, cost, prob = [], [], [], [], []
    for _ in range(n):
        user = int(rng.random() < 0.5)
        shared.append((np.array([100 + user, 7], np.uint32),
                       np.array([1.0, 0.5], np.float32)))
        acts.append([(np.array([200 + a], np.uint32),
                      np.array([1.0], np.float32)) for a in range(k)])
        a = int(rng.integers(0, k))
        chosen.append(a + 1)
        cost.append((0.0 if a == user else 1.0) + rng.normal(0, 0.05))
        prob.append(float(rng.uniform(0.02, 0.6)))
    cols = {"shared": jsc(shared), "features": jsc(acts),
            "chosenAction": np.array(chosen),
            "label": np.array(cost, np.float32),
            "probability": np.array(prob, np.float32)}
    return (JDF(dict(cols)).with_column_metadata("features",
                                                 {NUM_BITS_KEY: bits}),
            PDF(dict(cols)).with_column_metadata("features",
                                                 {NUM_BITS_KEY: bits}))


@pytest.mark.parametrize("cb_type", ["ips", "mtr"])
def test_bandit_matches_reference(cb_type):
    jdf, pdf = _bandit_frame()
    kw = dict(num_passes=4, learning_rate=0.5, epsilon=0.1, cb_type=cb_type,
              l2=1e-3)
    jm = J.VowpalWabbitContextualBandit(**kw).fit(jdf)
    pm = P.VowpalWabbitContextualBandit(device="cpu", **kw).fit(pdf)
    _close(pm.get("weights"), np.asarray(jm.get("weights")), "weights")
    jo, po = jm.transform(jdf), pm.transform(pdf)
    js = np.stack(list(jo["scores"]))
    ps = np.stack(list(po["scores"]))
    _close(ps, js, "scores")
    np.testing.assert_array_equal(po["prediction"], jo["prediction"])
    np.testing.assert_array_equal(np.stack(list(po["pmf"])),
                                  np.stack(list(jo["pmf"])))
    users = np.array([int(s[0][0] - 100) for s in pdf["shared"]])
    assert (po["prediction"] - 1 == users).mean() > 0.9


def test_bandit_fit_multiple_and_validation():
    jdf, pdf = _bandit_frame(n=60)
    cb = P.VowpalWabbitContextualBandit(device="cpu", num_passes=1)
    models = cb.fit_multiple(pdf, [{"learning_rate": 0.1},
                                   {"learning_rate": 1.0},
                                   {"epsilon": 0.3}])
    assert [m.get("epsilon") for m in models] == [0.05, 0.05, 0.3]
    sh = jsc([(np.array([1], np.uint32), np.array([1.], np.float32))])
    acts = jsc([[(np.array([2], np.uint32), np.array([1.], np.float32))]])
    base = {"shared": sh, "features": acts, "chosenAction": np.array([0]),
            "label": np.array([0.5], np.float32),
            "probability": np.array([0.5], np.float32)}
    with pytest.raises(ValueError, match="out of range"):
        cb.fit(PDF(dict(base)))
    with pytest.raises(ValueError, match="empty action list"):
        cb.fit(PDF({**base, "chosenAction": np.array([1]),
                    "features": jsc([[]])}))
    m = cb.fit(PDF({**base, "chosenAction": np.array([1])}))
    with pytest.raises(ValueError, match="empty action list"):
        m.transform(PDF({"shared": sh, "features": jsc([[]])}))


def test_learner_step_counts_minibatches_not_rows():
    """``train_passes`` advances the schedule once a minibatch: two
    minibatches at t = 0, 1 equal two calls of ``minibatch_step`` with the
    float32 steps lr, lr * 2^-power_t."""
    rng = np.random.default_rng(10)
    idx = torch.from_numpy(rng.integers(0, 16, (2, 4, 3)))
    val = torch.from_numpy(rng.normal(0, 1, (2, 4, 3)).astype(np.float32))
    y = torch.from_numpy(np.sign(rng.normal(0, 1, (2, 4))).astype(
        np.float32))
    sw = torch.ones(2, 4)
    w1, G1 = torch.zeros(16), torch.full((16,), 1e-12)
    steps = PL.train_passes(w1, G1, idx, val, y, sw, loss="logistic",
                            tau=0.5, n_passes=1, lr=0.5, l1=0.0, l2=0.0,
                            power_t=0.5)
    assert steps == 2
    w2, G2 = torch.zeros(16), torch.full((16,), 1e-12)
    for t in range(2):
        PL.minibatch_step(w2, G2, idx[t], val[t], y[t], -y[t], sw[t],
                          PL._step_scalars(t, 0.5, 0.0, 0.0, 0.5),
                          loss="logistic", tau=0.5, shrink=False)
    assert torch.equal(w1, w2) and torch.equal(G1, G2)
    assert PL._step_scalars(1, 0.5, 0.0, 0.0, 0.5)[0] == float(
        np.float32(0.5) * np.float32(2.0) ** np.float32(-0.5))
