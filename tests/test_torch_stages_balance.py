"""The port's utility stages (``mmlspark_tpu_torch/stages/misc.py``) and
data balance measures (``exploratory/balance.py``) against the JAX
package's on the CPU.

Both sides are host numpy, so every output frame is held bitwise
(values, dtypes, partitions and metadata) on the same frame made from a
numpy seed; ``Timer`` is held on what it wraps (its seconds are the
host's clock)."""

import numpy as np
import pytest
import torch

from mmlspark_tpu import exploratory as jx
from mmlspark_tpu import stages as js
from mmlspark_tpu_torch import exploratory as px
from mmlspark_tpu_torch import stages as ps
from test_torch_featurize import frames, same_frame, same_raise

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def _cols(n=24, seed=0):
    rng = np.random.default_rng(seed)
    vec = np.empty(n, dtype=object)
    for i in range(n):
        vec[i] = rng.normal(0, 1, 3)
    a = rng.normal(0, 1, n)
    a[[2, 7]] = np.nan
    return {
        "a": a, "b": rng.integers(0, 50, n),
        "label": (rng.random(n) < 0.3).astype(np.int64),
        "key": np.array([f"k{int(v)}" for v in rng.integers(0, 4, n)],
                        dtype=object),
        "text": np.array(["Hello World", "FOO bar", "baz", "Ｑｕｘ ｑｕｕｘ",
                          "I luv u", "naïve café"] * (n // 6), dtype=object),
        "vec": vec,
    }


def _pair(name, **kw):
    return getattr(js, name)(**kw), getattr(ps, name)(**kw)


@pytest.mark.parametrize("name,kw", [
    ("Cacher", {}), ("DropColumns", dict(cols=["a", "vec"])),
    ("SelectColumns", dict(cols=["text", "b"])),
    ("RenameColumn", dict(input_col="a", output_col="alpha")),
    ("Repartition", dict(n=3)), ("Repartition", dict(n=3, disable=True)),
    ("PartitionConsolidator", {}),
    ("UnicodeNormalize", dict(input_col="text", output_col="n")),
    ("UnicodeNormalize", dict(input_col="text", output_col="n", form="NFC",
                              lower=False)),
    ("TextPreprocessor", dict(input_col="text", output_col="o",
                              map={"luv": "love", "u": "you", "o": "0"})),
    ("TextPreprocessor", dict(input_col="text", output_col="o",
                              map={"ba": "BA"}, normalize_func="upper")),
    ("SummarizeData", {}),
    ("SummarizeData", dict(counts=False, percentiles=False)),
    ("StratifiedRepartition", dict(label_col="label", seed=3)),
    ("StratifiedRepartition", dict(label_col="key", seed=1, mode="mixed")),
    ("StratifiedRepartition", dict(label_col="label", mode="original")),
    ("EnsembleByKey", dict(keys=["key"], cols=["a", "vec"])),
    ("EnsembleByKey", dict(keys=["key", "label"], cols=["b"],
                           col_names=["mb"], collapse_group=False)),
    ("EnsembleByKey", dict(keys=["key"], cols=["vec"],
                           collapse_group=False)),
])
def test_transformers_bitwise(name, kw):
    jdf, pdf = frames(_cols(), npartitions=3)
    jst, pst = _pair(name, **kw)
    same_frame(jst.transform(jdf), pst.transform(pdf))


def test_explode_lambda_udf_and_adapter_bitwise():
    cols = {"id": np.arange(4),
            "vals": np.array([[1, 2, 3], [4], [], [5, 6]], dtype=object),
            "b": np.array([10, 20, 30, 40]),
            "t": np.array(["Ａ b", "C d", "e", "F"], dtype=object)}
    jdf, pdf = frames(cols)
    same_frame(js.Explode(input_col="vals", output_col="v").transform(jdf),
               ps.Explode(input_col="vals", output_col="v").transform(pdf))
    fn = lambda d: d.with_column("c", d["b"] * 2)  # noqa: E731
    same_frame(js.Lambda(fn).transform(jdf), ps.Lambda(fn).transform(pdf))
    for kw in (dict(input_col="b", output_col="o"),
               dict(input_col="b", output_col="o", vectorized=True),
               dict(input_cols=["b", "id"], output_col="o")):
        f = (lambda *x: sum(x) * 3) if "input_cols" in kw else \
            (lambda x: x + 1)
        same_frame(js.UDFTransformer(f, **kw).transform(jdf),
                   ps.UDFTransformer(f, **kw).transform(pdf))
    same_frame(js.UDFTransformer(lambda x: [x, x], input_col="b",
                                 output_col="o").transform(jdf),
               ps.UDFTransformer(lambda x: [x, x], input_col="b",
                                 output_col="o").transform(pdf))
    kw = dict(input_cols=["t"], output_cols=["t2"])
    same_frame(js.MultiColumnAdapter(base_stage=js.UnicodeNormalize(), **kw)
               .transform(jdf),
               ps.MultiColumnAdapter(base_stage=ps.UnicodeNormalize(), **kw)
               .transform(pdf))
    same_raise(lambda: js.Lambda().transform(jdf),
               lambda: ps.Lambda().transform(pdf))
    same_raise(lambda: js.MultiColumnAdapter(
        base_stage=js.UnicodeNormalize(), input_cols=["t"], output_cols=[]
    ).transform(jdf), lambda: ps.MultiColumnAdapter(
        base_stage=ps.UnicodeNormalize(), input_cols=["t"], output_cols=[]
    ).transform(pdf))


@pytest.mark.parametrize("labels,parts", [
    ([0] * 6 + [1] * 2, 2), ([0] * 5 + [1] * 5 + [2] * 2, 2),
    ([3, 1, 1, 2, 2, 2, 0, 0, 0, 0, 1, 3, 3], 4)])
def test_stratified_repartition_orders_alike(labels, parts):
    jdf, pdf = frames({"label": np.array(labels),
                       "x": np.arange(len(labels))}, npartitions=parts)
    for seed in (0, 5):
        same_frame(js.StratifiedRepartition(label_col="label", seed=seed)
                   .transform(jdf),
                   ps.StratifiedRepartition(label_col="label", seed=seed)
                   .transform(pdf))


def test_class_balancer_and_timer_bitwise(tmp_path):
    jdf, pdf = frames(_cols())
    for col in ("label", "key"):
        jm = js.ClassBalancer(input_col=col, output_col="w").fit(jdf)
        pm = ps.ClassBalancer(input_col=col, output_col="w").fit(pdf)
        assert pm.get("values") == jm.get("values")
        assert pm.get("weights") == jm.get("weights")
        same_frame(jm.transform(jdf), pm.transform(pdf))
    pm.save(str(tmp_path / "cb"))
    same_frame(jm.transform(jdf),
               ps.ClassBalancerModel.load(str(tmp_path / "cb"))
               .transform(pdf))
    jt = js.Timer(stage=js.ClassBalancer(input_col="label", output_col="w"))
    pt = ps.Timer(stage=ps.ClassBalancer(input_col="label", output_col="w"))
    jtm, ptm = jt.fit(jdf), pt.fit(pdf)
    assert pt.last_fit_seconds >= 0 and ptm.last_transform_seconds is None
    same_frame(jtm.transform(jdf), ptm.transform(pdf))
    assert ptm.last_transform_seconds >= 0
    # a transformer is timed as it stands (no fit)
    ptm2 = ps.Timer(stage=ps.Cacher()).fit(pdf)
    same_frame(js.Timer(stage=js.Cacher()).fit(jdf).transform(jdf),
               ptm2.transform(pdf))


def _balance_cols(n=200, seed=0):
    rng = np.random.default_rng(seed)
    gender = np.array(["f", "m", "x"], dtype=object)[
        rng.choice(3, n, p=[0.45, 0.5, 0.05])]
    race = np.array(["r0", "r1", "r2", "r3"], dtype=object)[
        rng.integers(0, 4, n)]
    age = rng.integers(1, 4, n)
    y = (rng.random(n) < np.where(gender == "m", 0.4, 0.2)).astype(np.int64)
    return {"gender": gender, "race": race, "age": age, "label": y}


@pytest.mark.parametrize("seed", [0, 1])
def test_feature_balance_measure_bitwise(seed):
    jdf, pdf = frames(_balance_cols(seed=seed))
    kw = dict(sensitive_cols=["gender", "race", "age"], label_col="label")
    same_frame(jx.FeatureBalanceMeasure(**kw).transform(jdf),
               px.FeatureBalanceMeasure(**kw).transform(pdf))
    # a value with no positives: the -inf branches of pmi and llr
    cols = _balance_cols(seed=seed)
    cols["label"][cols["gender"] == "x"] = 0
    jdf, pdf = frames(cols)
    same_frame(jx.FeatureBalanceMeasure(**kw).transform(jdf),
               px.FeatureBalanceMeasure(**kw).transform(pdf))


@pytest.mark.parametrize("eps", [1.0, 0.5, 2.0])
def test_distribution_and_aggregate_balance_bitwise(eps):
    jdf, pdf = frames(_balance_cols(seed=2))
    kw = dict(sensitive_cols=["gender", "race", "age"])
    same_frame(jx.DistributionBalanceMeasure(**kw).transform(jdf),
               px.DistributionBalanceMeasure(**kw).transform(pdf))
    same_frame(jx.AggregateBalanceMeasure(epsilon=eps, **kw).transform(jdf),
               px.AggregateBalanceMeasure(epsilon=eps, **kw).transform(pdf))


def test_exports_match_the_jax_package():
    import mmlspark_tpu.stages.misc as jmisc
    import mmlspark_tpu_torch.stages.misc as pmisc
    assert pmisc.__all__ == jmisc.__all__
    assert px.__all__ == jx.__all__
