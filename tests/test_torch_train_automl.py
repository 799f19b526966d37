"""The port's train wrappers, metrics and search
(``mmlspark_tpu_torch/train/``, ``automl/``) against the JAX package's on
the CPU.

- The linear learners start from the same W: the JAX package draws it
  from ``jax.random``, the port from a ``torch.Generator``, so
  ``jax_init`` hands the port the JAX draw (as
  ``test_torch_featurizer_linear.py`` does for the runner). Their
  coefficients are then held within ``LIN`` (rtol 1e-5, atol 1e-5: float32
  reductions in another order), probabilities within ``F32`` (the same),
  predictions equal.
- LightGBM (3 trees, 7 leaves) gives the JAX package's trees: split
  features and bins equal, probabilities within ``GBDT`` (rtol 1e-5, atol
  1e-6), the port's GBDT tests' tolerance, predictions equal.
- ``ComputeModelStatistics`` / ``ComputePerInstanceStatistics`` on the
  same scored frame: within ``STATS`` (1e-12 absolute); confusion
  matrices equal.
- The search streams are numpy in both packages: the split, the random and
  grid maps and TPE's proposals are equal. Per-trial metrics are held
  within ``TRIAL`` (1e-6 absolute: accuracy and AUC over the
  learners' probabilities above), the best params equal. In the port,
  ``parallelism=4`` gives exactly ``parallelism=1``'s trials.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu import automl as ja
from mmlspark_tpu import train as jt
from mmlspark_tpu.automl import tune as jtune
from mmlspark_tpu.models import linear as jlinear
from mmlspark_tpu.models.gbdt import LightGBMClassifier as JLGBMC
from mmlspark_tpu.models.gbdt import LightGBMRegressor as JLGBMR
from mmlspark_tpu_torch import automl as pa
from mmlspark_tpu_torch import train as pt
from mmlspark_tpu_torch.automl import tune as ptune
from mmlspark_tpu_torch.core.dataframe import object_col
from mmlspark_tpu_torch.models import linear as plinear
from mmlspark_tpu_torch.models.gbdt import LightGBMClassifier as PLGBMC
from mmlspark_tpu_torch.models.gbdt import LightGBMRegressor as PLGBMR
from test_torch_featurize import frames, same_frame, same_value

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

LIN = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=1e-5, atol=1e-5)
GBDT = dict(rtol=1e-5, atol=1e-6)
STATS = dict(rtol=0, atol=1e-12)
TRIAL = 1e-6
TINY = dict(num_iterations=3, num_leaves=7, max_bin=32, min_data_in_leaf=5)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's linear learners start from the JAX package's W."""
    import jax

    def init(d, n_out, seed):
        W = jax.random.normal(jax.random.PRNGKey(seed), (d, n_out)) * 0.01
        return {"W": torch.from_numpy(np.array(W)), "b": torch.zeros(n_out)}
    monkeypatch.setattr(plinear, "init_params", init)


def adult_cols(n=160, seed=0, classes=2):
    """A tiny Adult-shaped frame: numeric columns (one with NaNs), string
    categoricals, and a string label learnable from them."""
    rng = np.random.default_rng(seed)
    age = rng.integers(17, 90, n).astype(np.float64)
    hours = rng.normal(40, 12, n)
    hours[rng.random(n) < 0.1] = np.nan
    edu = rng.integers(1, 17, n)
    work = np.array(["Private", "Self-emp", "Gov", "Never"], dtype=object)[
        rng.integers(0, 4, n)]
    sex = np.array(["Male", "Female"], dtype=object)[rng.integers(0, 2, n)]
    z = (0.05 * (age - 40) + 0.4 * (edu - 9) + 1.2 * (sex == "Male")
         + np.nan_to_num(0.03 * (hours - 40)) - 1.0)
    if classes == 2:
        label = np.where(z + 0.3 * rng.normal(size=n) > 0, ">50K", "<=50K"
                         ).astype(object)
    else:
        label = np.array(["lo", "mid", "hi"], dtype=object)[
            np.digitize(z, [-0.8, 0.8])]
    return {"age": age, "hours-per-week": hours, "education-num": edu,
            "workclass": work, "sex": sex, "income": label}


def _scored_same(jo, po, exact, close, tol):
    assert po.columns == jo.columns
    for c in exact:
        same_value(jo[c], po[c], c)
        same_value(jo.column_metadata(c), po.column_metadata(c), c)
    for c in close:
        np.testing.assert_allclose(np.stack(list(po[c])),
                                   np.stack(list(jo[c])), **tol)


# ---------------------------------------------------------------------------
# TrainClassifier / TrainRegressor


def test_train_classifier_default_learner_matches_jax(jax_init, tmp_path):
    jdf, pdf = frames(adult_cols())
    jm = jt.TrainClassifier(label_col="income").fit(jdf)
    pm = pt.TrainClassifier(label_col="income", device="cpu").fit(pdf)
    same_value(jm.get("featurizer").get("plans"),
               pm.get("featurizer").get("plans"))
    assert pm.get("classes") == jm.get("classes")
    pin = pm.get("inner_model")
    assert isinstance(pin, plinear.LogisticRegressionModel)
    assert pin.device.type == "cpu"
    np.testing.assert_allclose(pin.get("coefficients"),
                               jm.get("inner_model").get("coefficients"),
                               **LIN)
    jo, po = jm.transform(jdf), pm.transform(pdf)
    _scored_same(jo, po, ["features", "prediction"], ["probability"], F32)
    pm.save(str(tmp_path / "tc"))
    back = pt.TrainedClassifierModel.load(str(tmp_path / "tc"))
    # a loaded learner resolves the card on first use; here, the CPU
    back.get("inner_model")._device = torch.device("cpu")
    same_frame(po, back.transform(pdf))


def test_train_regressor_default_learner_matches_jax(jax_init):
    cols = adult_cols(seed=1)
    cols["target"] = cols.pop("age")
    jdf, pdf = frames(cols)
    kw = dict(label_col="target")
    jm = jt.TrainRegressor(**kw).fit(jdf)
    pm = pt.TrainRegressor(device="cpu", **kw).fit(pdf)
    pin = pm.get("inner_model")
    np.testing.assert_allclose(pin.get("coefficients"),
                               jm.get("inner_model").get("coefficients"),
                               **LIN)
    # the JAX model with the port's weights scores bitwise the same
    jin = jlinear.LinearRegressionModel()
    jin.set(coefficients=pin.get("coefficients"),
            intercept=pin.get("intercept"))
    jm.set(inner_model=jin)
    same_frame(jm.transform(jdf), pm.transform(pdf))


def gbdt_cols(n=300, seed=0):
    """Continuous columns and a string label with clear split margins:
    binary gradients are an ulp apart in the two packages, so near-tied
    gains could pick other splits."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    y = np.where(X[:, 0] + 0.5 * X[:, 1] + 0.2 * rng.normal(size=n) > 0,
                 ">50K", "<=50K").astype(object)
    return {**{f"x{i}": X[:, i] for i in range(4)}, "income": y}


def test_train_regressor_lightgbm_matches_jax():
    cols = gbdt_cols(seed=3)
    cols["target"] = cols["x0"] * 2 - cols.pop("x1") * cols["x2"]
    jdf, pdf = frames({k: v for k, v in cols.items() if k != "income"})
    jm = jt.TrainRegressor(model=JLGBMR(**TINY), label_col="target").fit(jdf)
    pm = pt.TrainRegressor(model=PLGBMR(device="cpu", **TINY),
                           label_col="target").fit(pdf)
    jo, po = jm.transform(jdf), pm.transform(pdf)
    assert po.columns == jo.columns
    np.testing.assert_allclose(po["prediction"], jo["prediction"], **GBDT)


def test_wrappers_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (pt.TrainClassifier, pt.TrainRegressor):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(label_col="income")
    # an explicit learner keeps its own device; the default one needs it
    pdf = frames(adult_cols(n=40))[1]
    m = pt.TrainClassifier(model=plinear.LogisticRegression(device="cpu"),
                           label_col="income").fit(pdf)
    assert m.get("inner_model").device.type == "cpu"
    tc = pt.TrainClassifier(model=plinear.LogisticRegression(device="cpu"),
                            label_col="income")
    tc.set(model=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.fit(pdf)
    # a loaded wrapper takes ``device`` at load, else resolves the card
    pt.TrainClassifier(label_col="income", device="cpu").save(
        str(tmp_path / "tc"))
    back = pt.TrainClassifier.load(str(tmp_path / "tc"), device="cpu")
    assert back.fit(pdf).get("inner_model").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.TrainClassifier.load(str(tmp_path / "tc")).fit(pdf)


# ---------------------------------------------------------------------------
# metrics


def _scored_frames(kind):
    rng = np.random.default_rng(11)
    n = 64
    if kind == "regression":
        y = rng.normal(size=n)
        return frames({"label": y, "prediction": y + rng.normal(0, .3, n)})
    k = 2 if kind == "binary" else 3
    p = rng.dirichlet(np.ones(k), n)
    p[:8] = p[0]                                    # tied scores
    y = rng.integers(0, k, n)
    labels = np.array(["a", "b", "c"], dtype=object)[:k]
    cols = {"label": labels[y], "prediction": labels[p.argmax(1)],
            "probability": object_col(list(p))}
    jdf, pdf = frames(cols)
    if kind == "subset":                            # model knew 3 classes
        from mmlspark_tpu.core.schema import set_label_metadata as jset
        from mmlspark_tpu_torch.core.schema import set_label_metadata as pset
        jdf = jset(jdf, "prediction", num_classes=3, classes=list(labels))
        pdf = pset(pdf, "prediction", num_classes=3, classes=list(labels))
        keep = cols["label"] != "b"
        jdf, pdf = jdf.filter(keep), pdf.filter(keep)
    return jdf, pdf


@pytest.mark.parametrize("kind", ["binary", "multiclass", "subset",
                                  "regression"])
def test_model_statistics_within_1e12(kind):
    jdf, pdf = _scored_frames(kind)
    js = jt.ComputeModelStatistics(label_col="label").transform(jdf)
    ps = pt.ComputeModelStatistics(label_col="label").transform(pdf)
    assert ps.columns == js.columns
    for c in js.columns:
        if c == "confusion_matrix":
            same_value(js[c], ps[c])
        else:
            np.testing.assert_allclose(ps[c].astype(float),
                                       js[c].astype(float), **STATS)
    jp = jt.ComputePerInstanceStatistics(label_col="label").transform(jdf)
    pp = pt.ComputePerInstanceStatistics(label_col="label").transform(pdf)
    assert pp.columns == jp.columns
    for c in set(pp.columns) - set(pdf.columns):
        np.testing.assert_allclose(pp[c], jp[c], **STATS)


def test_roc_auc_and_confusion_matrix_equal():
    rng = np.random.default_rng(12)
    for n in (2, 5, 50):
        y = rng.integers(0, 2, n)
        s = np.round(rng.random(n), 1)              # many ties
        a, b = pt.roc_auc(y, s), jt.roc_auc(y, s)
        assert (np.isnan(a) and np.isnan(b)) or a == b
        yp = rng.integers(0, 3, n)
        np.testing.assert_array_equal(pt.confusion_matrix(y, yp, 3),
                                      jt.confusion_matrix(y, yp, 3))
    jdf, pdf = frames({"label": np.array(["a", "b"], dtype=object),
                       "prediction": np.array(["a", "c"], dtype=object),
                       "probability": object_col([np.ones(4) / 4] * 2)})
    with pytest.raises(ValueError) as ej:
        jt.ComputePerInstanceStatistics(label_col="label").transform(jdf)
    with pytest.raises(ValueError) as ep:
        pt.ComputePerInstanceStatistics(label_col="label").transform(pdf)
    assert str(ep.value) == str(ej.value)


# ---------------------------------------------------------------------------
# search spaces, TPE, the split


def _space(pkg):
    return (pkg.HyperparamBuilder()
            .add_hyperparam("learning_rate",
                            pkg.RangeHyperParam(0.01, 0.5, is_log=True))
            .add_hyperparam("max_iter", pkg.DiscreteHyperParam([5, 30]))
            .add_hyperparam("reg_param", pkg.RangeHyperParam(0.0, 0.1))
            .build())


def test_param_maps_and_shuffle_equal():
    for seed in (0, 3):
        assert list(pa.RandomSpace(_space(pa), seed=seed).param_maps(7)) == \
            list(ja.RandomSpace(_space(ja), seed=seed).param_maps(7))
    grid = {"k": pa.RangeHyperParam(1, 40, is_int=True, is_log=True),
            "c": pa.DiscreteHyperParam(["x", "y"])}
    jgrid = {"k": ja.RangeHyperParam(1, 40, is_int=True, is_log=True),
             "c": ja.DiscreteHyperParam(["x", "y"])}
    assert list(pa.GridSpace(grid).param_maps()) == \
        list(ja.GridSpace(jgrid).param_maps())
    jdf, pdf = frames(adult_cols(n=50))
    for seed in (0, 7):
        same_frame(jdf.shuffle(seed), pdf.shuffle(seed))


@pytest.mark.parametrize("maximize", [True, False])
def test_tpe_proposals_equal_after_the_same_tells(maximize):
    from mmlspark_tpu.automl.tpe import TPESampler as JTPE
    from mmlspark_tpu_torch.automl.tpe import TPESampler as PTPE

    def space(pkg):
        return {"lr": pkg.RangeHyperParam(1e-4, 1.0, is_log=True),
                "kind": pkg.DiscreteHyperParam(["a", "b", "c"]),
                "k": pkg.RangeHyperParam(1, 32, is_int=True),
                "x": pkg.RangeHyperParam(-1.0, 1.0)}
    js = JTPE(space(ja), seed=4, n_startup=5, maximize=maximize)
    ps = PTPE(space(pa), seed=4, n_startup=5, maximize=maximize)
    for step in range(12):
        jm, pm = js.propose(2), ps.propose(2)
        assert pm == jm, step
        for m in pm:
            score = -abs(np.log10(m["lr"]) + 2) + (m["kind"] == "b") \
                - m["x"] ** 2
            js.tell(m, score)
            ps.tell(m, score)
    with pytest.raises(ValueError):
        PTPE(space(pa), gamma=1.5)


# ---------------------------------------------------------------------------
# TuneHyperparameters / FindBestModel


def _record_trials(monkeypatch, module, out):
    """Record (trial params, metric) per evaluated trial; the learner's
    fitted model carries its params (``_trial``, set by ``_spy``)."""
    real = module._evaluate

    def evaluate(model, df, label_col, metric):
        score = real(model, df, label_col, metric)
        inner = model.get("inner_model") if model.has_param(
            "inner_model") else model
        out.append((tuple(sorted(inner._trial.items())), score))
        return score
    monkeypatch.setattr(module, "_evaluate", evaluate)


def _spy(cls, names, **kw):
    class Spy(cls):
        def _fit(self, df):
            m = super()._fit(df)
            m._trial = {k: self.get(k) for k in names}
            return m
    Spy.__name__ = cls.__name__
    return Spy(**kw)


def _same_trials(jtr, ptr):
    assert [p for p, _ in ptr] == [p for p, _ in jtr]
    np.testing.assert_allclose([s for _, s in ptr], [s for _, s in jtr],
                               rtol=0, atol=TRIAL)


LR_NAMES = ("learning_rate", "max_iter", "reg_param")
GB_NAMES = ("learning_rate", "min_data_in_leaf", "num_iterations")


@pytest.mark.parametrize("strategy", ["full", "grid", "halving", "tpe"])
def test_search_strategies_match_jax_over_the_linear_learner(
        jax_init, monkeypatch, strategy):
    cols = adult_cols(n=120, seed=5)
    jdf, pdf = frames(cols)
    space = {"full": lambda pkg: pkg.RandomSpace(_space(pkg), seed=2),
             "grid": lambda pkg: pkg.GridSpace(
                 {"learning_rate": pkg.DiscreteHyperParam([0.05, 0.3]),
                  "max_iter": pkg.DiscreteHyperParam([5, 30])}),
             "halving": lambda pkg: pkg.RandomSpace(
                 {"learning_rate": pkg.RangeHyperParam(0.01, 0.5)}, seed=2),
             "tpe": lambda pkg: _space(pkg)}[strategy]
    kw = dict(label_col="income", number_of_iterations=6, parallelism=1,
              evaluation_metric="accuracy", seed=1,
              search_strategy="full" if strategy == "grid" else strategy)
    if strategy == "halving":
        kw.update(resource_param="max_iter", min_resource=5,
                  max_resource=40, halving_factor=2)
    if strategy == "tpe":
        kw.update(tpe_startup_trials=3)
    jtr, ptr = [], []
    _record_trials(monkeypatch, jtune, jtr)
    _record_trials(monkeypatch, ptune, ptr)
    jtun = ja.TuneHyperparameters(
        model=jt.TrainClassifier(model=_spy(jlinear.LogisticRegression,
                                            LR_NAMES), label_col="income"),
        search_space=space(ja), **kw)
    ptun = pa.TuneHyperparameters(
        model=pt.TrainClassifier(model=_spy(plinear.LogisticRegression,
                                            LR_NAMES, device="cpu"),
                                 label_col="income"),
        search_space=space(pa), **kw)
    jbest, pbest = jtun.fit(jdf), ptun.fit(pdf)
    _same_trials(jtr, ptr)
    assert ptun.best_params == jtun.best_params
    assert abs(ptun.best_metric - jtun.best_metric) <= TRIAL
    if strategy == "halving":
        assert [dict(p)["max_iter"] for p, _ in ptr] == \
            [5] * 6 + [10] * 3 + [40]
    assert list(pbest.transform(pdf)["prediction"]) == \
        list(jbest.transform(jdf)["prediction"])


def test_halving_matches_jax_over_lightgbm(monkeypatch):
    """``TrainClassifier`` over LightGBM, tuned by halving: the rungs set
    ``num_iterations`` on the wrapped learner (``_apply_params`` routes it
    inside); the best models have the JAX package's trees and score
    alike."""
    jdf, pdf = frames(gbdt_cols(n=240, seed=6))

    def space(pkg):
        return pkg.RandomSpace(
            {"learning_rate": pkg.RangeHyperParam(0.05, 0.5, is_log=True),
             "min_data_in_leaf": pkg.DiscreteHyperParam([5, 20])}, seed=3)
    kw = dict(label_col="income", number_of_iterations=2, parallelism=1,
              evaluation_metric="AUC", seed=2, search_strategy="halving",
              min_resource=2, max_resource=4, halving_factor=2)
    tiny = {k: v for k, v in TINY.items() if k != "min_data_in_leaf"}
    jtr, ptr = [], []
    _record_trials(monkeypatch, jtune, jtr)
    _record_trials(monkeypatch, ptune, ptr)
    jtun = ja.TuneHyperparameters(model=jt.TrainClassifier(
        model=_spy(JLGBMC, GB_NAMES, **tiny), label_col="income"),
        search_space=space(ja), **kw)
    ptun = pa.TuneHyperparameters(model=pt.TrainClassifier(
        model=_spy(PLGBMC, GB_NAMES, device="cpu", **tiny),
        label_col="income"), search_space=space(pa), **kw)
    jbest, pbest = jtun.fit(jdf), ptun.fit(pdf)
    _same_trials(jtr, ptr)
    assert [dict(p)["num_iterations"] for p, _ in ptr] == [2, 2, 4]
    assert ptun.best_params == jtun.best_params
    assert abs(ptun.best_metric - jtun.best_metric) <= TRIAL
    pb = pbest.get("inner_model").booster
    jb = jbest.get("inner_model").booster
    np.testing.assert_array_equal(pb.feats, jb.feats)
    np.testing.assert_array_equal(pb.thr_raw, jb.thr_raw)
    _scored_same(jbest.transform(jdf), pbest.transform(pdf),
                 ["features", "prediction"], ["probability", "rawPrediction"],
                 GBDT)


@pytest.mark.parametrize("learner", ["linear", "lightgbm"])
def test_parallelism_four_equals_one_exactly(monkeypatch, learner):
    pdf = frames(adult_cols(n=160, seed=7) if learner == "linear"
                 else gbdt_cols(n=160, seed=7))[1]
    if learner == "linear":
        inner, names = _spy(plinear.LogisticRegression, LR_NAMES,
                            device="cpu"), LR_NAMES
        space = pa.RandomSpace(_space(pa), seed=4)
    else:
        inner, names = _spy(PLGBMC, GB_NAMES, device="cpu", **{
            k: v for k, v in TINY.items() if k != "min_data_in_leaf"}), \
            GB_NAMES
        space = pa.RandomSpace(
            {"learning_rate": pa.RangeHyperParam(0.05, 0.5),
             "min_data_in_leaf": pa.DiscreteHyperParam([5, 20])}, seed=4)
    runs = {}
    for par in (1, 4):
        trials = []
        _record_trials(monkeypatch, ptune, trials)
        tun = pa.TuneHyperparameters(
            model=pt.TrainClassifier(model=inner, label_col="income"),
            search_space=space,
            number_of_iterations=4 if learner == "lightgbm" else 8,
            parallelism=par, label_col="income",
            evaluation_metric="AUC")
        tun.fit(pdf)
        runs[par] = (sorted(trials), tun.best_params, tun.best_metric)
    assert runs[4] == runs[1]


def test_find_best_model_matches_jax(jax_init):
    jdf, pdf = frames(adult_cols(n=120, seed=8))
    jms = [jt.TrainClassifier(model=jlinear.LogisticRegression(max_iter=it),
                              label_col="income").fit(jdf)
           for it in (1, 40)]
    pms = [pt.TrainClassifier(model=plinear.LogisticRegression(
        max_iter=it, device="cpu"), label_col="income").fit(pdf)
        for it in (1, 40)]
    for metric in ("accuracy", "AUC"):
        jr = ja.FindBestModel(jms, label_col="income",
                              evaluation_metric=metric).fit(jdf)
        pr = pa.FindBestModel(pms, label_col="income",
                              evaluation_metric=metric).fit(pdf)
        ja_m, pa_m = jr.get("all_model_metrics"), pr.get("all_model_metrics")
        assert [i for i, _ in pa_m] == [i for i, _ in ja_m] == [0, 1]
        np.testing.assert_allclose([s for _, s in pa_m],
                                   [s for _, s in ja_m], rtol=0, atol=TRIAL)
        best = pms.index(pr.get("best_model"))
        assert best == jms.index(jr.get("best_model"))
        same_value(pr.transform(pdf)["prediction"],
                   jr.transform(jdf)["prediction"])


def test_tune_rejects_what_jax_rejects():
    pdf = frames(adult_cols(n=30))[1]
    lr = plinear.LogisticRegression(device="cpu")
    with pytest.raises(ValueError, match="halving controls"):
        pa.TuneHyperparameters(
            model=lr, search_space=pa.RandomSpace(
                {"max_iter": pa.DiscreteHyperParam([10, 20])}),
            number_of_iterations=2, label_col="income",
            search_strategy="halving", resource_param="max_iter").fit(pdf)
    with pytest.raises(ValueError, match="tpe"):
        pa.TuneHyperparameters(
            model=lr, search_space=pa.GridSpace(
                {"a": pa.DiscreteHyperParam([1])}),
            search_strategy="tpe", label_col="income").fit(pdf)
    with pytest.raises(KeyError, match="no inner 'model'"):
        ptune._apply_params(lr, {"nope": 1})
    assert sorted(pa.__all__) == sorted(ja.__all__)
    assert sorted(pt.__all__) == sorted(jt.__all__)
