"""The port's tuner (``mmlspark_tpu_torch/tuning/cost_model.py``) and its
``tuning="auto"`` wiring against the JAX package's.

The cost model is Python float arithmetic, so on the same observation rows
every fitted coefficient, prediction and decision equals the JAX
package's exactly (``==``, no tolerance). ``tests/test_tuning.py``'s
``TestCostModel``, ``TestMeasuredSweep``, ``TestWarmupLadder`` and
``TestBatchRunnerAuto`` cases run through both packages on copies of the
same store; the harvested observations are compared apart from their
seconds (wall time) and compile counts (the port's runner compiles
nothing: its ``compiles`` are 0), and the timing race of
``test_autotuned_beats_defaults_on_skewed_workload`` is restated as a
check on the decision and on the dispatches it saves.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.runner import BatchRunner as JBatchRunner
from mmlspark_tpu.ops.compile_cache import warm_up_jitted as j_warm
from mmlspark_tpu.tuning import cost_model as jcm
from mmlspark_tpu.tuning import observations as jobs
from mmlspark_tpu_torch.models.runner import BatchRunner as PBatchRunner
from mmlspark_tpu_torch.ops.compile_cache import M_WARMUP_BUCKETS
from mmlspark_tpu_torch.ops.compile_cache import warm_up_jitted as p_warm
from mmlspark_tpu_torch.tuning import cost_model as pcm
from mmlspark_tpu_torch.tuning import observations as pobs

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

CPU = torch.device("cpu")


@pytest.fixture
def stores():
    """Fresh in-memory stores installed as each package's process-global
    one, so runner harvests and sweep probes never leak across tests."""
    j, p = jobs.ObservationStore(), pobs.ObservationStore()
    jobs.set_store(j)
    pobs.set_store(p)
    yield j, p
    jobs.set_store(None)
    pobs.set_store(None)


def linear_rows(sig, *, alpha=0.01, beta=1e-4, prep=1e-5,
                buckets=(64, 128), batches=10, t=1.0):
    """Per-bucket samples lying on sec/batch = alpha + beta*bucket, as plain
    dicts (each package's store takes them)."""
    return [dict(jobs.Observation(
        sig=sig, source="runner", bucket=b, rows=b * batches,
        batches=batches, seconds=(alpha + beta * b) * batches,
        prep_seconds=prep * b * batches, t=t)) for b in buckets]


def record_both(stores, rows):
    for s in stores:
        s.record_many(copy.deepcopy(rows))


def _model_state(m):
    return (m.alpha, m.beta, m.prep_rate, m.compile_cost, m.direct,
            m.n_samples)


def _decision(d):
    return None if d is None else (d.as_dict(), d.source, d.details,
                                   d.predicted_seconds)


# ---------------------------------------------------------------------------
# the cost model: exact equality with the JAX package
# ---------------------------------------------------------------------------

ROWSETS = {
    "linear": dict(alpha=0.02, beta=5e-4, buckets=(32, 64, 128, 256)),
    "single_bucket": dict(buckets=(64,)),
    "skewed": dict(alpha=0.01, beta=1e-4),
    "noisy_negative_slope": dict(alpha=0.05, beta=-1e-4,
                                 buckets=(16, 64, 256)),
}
HISTOGRAMS = [{66: 4}, {40: 1}, {1: 3, 100: 2, 513: 1}, {5: 1, 66: 1},
              {2048: 1}]


@pytest.mark.parametrize("rowset", sorted(ROWSETS))
def test_fit_equals_reference(rowset):
    rows = linear_rows("s", **ROWSETS[rowset])
    assert _model_state(pcm.CostModel.fit(copy.deepcopy(rows))) == \
        _model_state(jcm.CostModel.fit(copy.deepcopy(rows)))


def test_fit_recovers_linear_coefficients():
    m = pcm.CostModel.fit(linear_rows("s", alpha=0.02, beta=5e-4,
                                      buckets=(32, 64, 128, 256)))
    assert m.alpha == pytest.approx(0.02, rel=1e-6)
    assert m.beta == pytest.approx(5e-4, rel=1e-6)
    assert m.prep_rate > 0
    single = pcm.CostModel.fit(linear_rows("s", buckets=(64,)))
    assert single.alpha == 0.0 and single.beta > 0.0


@pytest.mark.parametrize("rowset", sorted(ROWSETS))
@pytest.mark.parametrize("defaults", [(64, 2), (16, 1), (512, 0)])
def test_decisions_equal_reference(rowset, defaults):
    """``candidate_configs``, every candidate's ``predict_seconds`` and the
    chosen decision equal the JAX package's on every histogram."""
    rows = linear_rows("s", **ROWSETS[rowset])
    pm = pcm.CostModel.fit(copy.deepcopy(rows))
    jm = jcm.CostModel.fit(copy.deepcopy(rows))
    for hist in HISTOGRAMS:
        cands = pcm.candidate_configs(hist, defaults)
        assert cands == jcm.candidate_configs(hist, defaults)
        for m, d, ladder in cands:
            for w in (1.0, 0.25):
                assert pm.predict_seconds(hist, m, d, ladder, w) == \
                    jm.predict_seconds(hist, m, d, ladder, w)
        assert _decision(pm.choose(hist, defaults)) == \
            _decision(jm.choose(hist, defaults))


def test_pick_beats_both_endpoints():
    """Runs of 66 rows: tiny batches pay the intercept 5x a run, the
    power-of-two default pads 66 to 128, and the pick (the JAX package's)
    is strictly cheaper than either and pads nothing."""
    m = pcm.CostModel.fit(linear_rows("s", alpha=0.01, beta=1e-4))
    hist = {66: 4}
    cands = pcm.candidate_configs(hist, defaults=(64, 2))
    lo = min(c[0] for c in cands)
    hi = max(c[0] for c in cands)
    pick = m.choose(hist, defaults=(64, 2))
    sec_pick = m.predict_seconds(hist, pick.mini_batch_size,
                                 pick.prefetch_depth, pick.buckets)
    assert sec_pick < m.predict_seconds(hist, lo, 2, None)
    assert sec_pick <= m.predict_seconds(hist, hi, 2, None)
    assert pick.buckets is not None and 66 in pick.vocabulary


def test_probe_rows_outrank_the_fit():
    rows = linear_rows("s")
    rows.append(dict(jobs.Observation(
        sig="s", source="probe", rows_per_sec=1e6,
        config={"mini_batch_size": 16, "prefetch_depth": 0,
                "buckets": None}, t=1.0)))
    pm = pcm.CostModel.fit(copy.deepcopy(rows))
    jm = jcm.CostModel.fit(copy.deepcopy(rows))
    assert pm.predict_seconds({64: 1}, 16, 0, None) == pytest.approx(64 / 1e6)
    assert pm.predict_seconds({64: 1}, 16, 0, None) == \
        jm.predict_seconds({64: 1}, 16, 0, None)
    assert _decision(pm.choose({64: 1})) == _decision(jm.choose({64: 1}))


def test_decision_reproducible_across_packages_from_disk(tmp_path):
    """A store the port persists re-fits, in either package, to the same
    pick; so does one the JAX package persists."""
    p1 = pobs.ObservationStore(str(tmp_path / "port"))
    p1.record_many(linear_rows("s", alpha=0.02))
    j1 = jobs.ObservationStore(str(tmp_path / "jax"))
    j1.record_many(linear_rows("s", alpha=0.02))
    want = _decision(jcm.CostModel.fit(j1.rows(sig="s")).choose({66: 4}))
    for d in ("port", "jax"):
        assert _decision(pcm.CostModel.fit(pobs.ObservationStore(
            str(tmp_path / d)).rows(sig="s")).choose({66: 4})) == want
        assert _decision(jcm.CostModel.fit(jobs.ObservationStore(
            str(tmp_path / d)).rows(sig="s")).choose({66: 4})) == want


def test_resolve_tuning_equals_reference(stores):
    """Cold, placement-matched, mesh-filtered and predecessor-seeded
    (transfer) decisions, and the decision counters, equal the JAX
    package's."""
    rows = (linear_rows("onnx:a:float32:fp", alpha=0.02)
            + [dict(r, placement="cuda:0", mesh_shape="dp2")
               for r in linear_rows("onnx:a:float32:fp", alpha=0.05,
                                    buckets=(16, 32))]
            + linear_rows("cost:http/gen/m@v1", alpha=0.01)
            + linear_rows("cost:http/gen/m@v2", alpha=0.03))
    record_both(stores, rows)
    j, p = stores
    cases = [("never-seen", "default", {64: 1}, None),
             ("onnx:a:float32:fp", "default", {66: 1}, None),
             ("onnx:a:float32:fp", "cuda:0", {66: 2}, None),
             ("onnx:a:float32:fp", "default", {66: 1}, "single"),
             ("onnx:a:float32:fp", "cuda:0", {300: 1}, "dp2"),
             ("onnx:a:float32:fp", "default", {66: 1}, "tp4"),
             ("cost:http/gen/m@v3", "default", {40: 3}, None),
             ("cost:http/gen/x@v1", "default", {40: 3}, None)]
    for sig, placement, hist, mesh in cases:
        before = {s: pcm.M_DECISIONS.labels(source=s).get()
                  for s in ("default", "model", "probe", "transfer")}
        got = pcm.resolve_tuning(sig, placement, hist, store=p,
                                 mesh_shape=mesh)
        want = jcm.resolve_tuning(sig, placement, hist, store=j,
                                  mesh_shape=mesh)
        assert _decision(got) == _decision(want), (sig, placement, mesh)
        src = "default" if got is None else got.source
        assert pcm.M_DECISIONS.labels(source=src).get() - before[src] == 1
    assert pcm.resolve_tuning("cost:http/gen/m@v3", "default", {40: 3},
                              store=p).details["seeded_from"] == \
        "cost:http/gen/m@v2"
    assert pcm.resolve_tuning("never-seen", "default", {64: 1}) is None


def test_predecessor_and_comparisons_equal_reference(stores):
    known = ["cost:http/a/m@1", "cost:http/a/m@2", "cost:http/a/m@10",
             "cost:http/a/n@1", "cost:grpc/a/m@1", "plain"]
    for sig in ("cost:http/a/m@3", "cost:http/a/m@1", "cost:http/a/n@2",
                "cost:http/a/m", "plain", "cost:grpc/a/m@9"):
        assert pcm.predecessor_signature(sig, known) == \
            jcm.predecessor_signature(sig, known)
    gen = []
    for i, (impl, dt, tps, place) in enumerate(
            [("kernel", "int8", 900.0, "a"), ("gather", None, 450.0, "a"),
             ("kernel", "fp8", 950.0, "b"), ("kernel", None, 0.0, "b"),
             (None, "int8", 800.0, "a"), ("gather", "bf16", 500.0, "b")]):
        gen.append(dict(jobs.Observation(
            sig="generation", source="bench", placement=place,
            config={"paged_attn_impl": impl, "kv_dtype": dt},
            rows_per_sec=tps, t=float(i))))
    record_both(stores, gen)
    j, p = stores
    assert pcm.compare_paged_attn(p) == jcm.compare_paged_attn(j)
    assert pcm.compare_kv_dtype(p) == jcm.compare_kv_dtype(j)


# ---------------------------------------------------------------------------
# the measured sweep
# ---------------------------------------------------------------------------

def _apply_jax(params, feeds):
    return {"y": feeds["x"] @ params["w"]}


def _apply_torch(params, feeds):
    return {"y": feeds["x"] @ params["w"]}


def _factories(n_rows, din=8, dout=4, seed=0, **extra):
    """Runner factories over the same rows and weights: the JAX package's
    ``BatchRunner`` (jitted) and the port's (torch on the CPU)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n_rows, din)).astype(np.float32)
    w = rng.normal(0, 0.5, (din, dout)).astype(np.float32)
    jitted = jax.jit(_apply_jax)
    jparams = {"w": jnp.asarray(w)}
    pparams = {"w": torch.from_numpy(w)}

    def coerce(sl):
        return {"x": X[sl]}

    def make_j(m, d, buckets):
        return JBatchRunner(jitted, jparams, coerce, jax.device_put,
                            mini_batch_size=m, prefetch_depth=d,
                            buckets=buckets, **extra)

    def make_p(m, d, buckets):
        return PBatchRunner(_apply_torch, pparams, coerce, CPU,
                            mini_batch_size=m, prefetch_depth=d,
                            buckets=buckets, **extra)
    return make_j, make_p, (jitted, jparams), pparams, X, w


def test_probe_budget_env(monkeypatch):
    for v, want in (("3", 3), ("garbage", 6), ("0", 1)):
        monkeypatch.setenv(pcm.PROBE_BUDGET_ENV, v)
        assert pcm.probe_budget() == jcm.probe_budget() == want
    assert pcm.PROBE_BUDGET_ENV == jcm.PROBE_BUDGET_ENV


def test_sweep_bounded_and_refits_to_the_reference_pick(stores):
    """The port's sweep runs exactly ``budget`` probes through the port's
    runner, each a store row; the JAX package's sweep over the same
    candidates probes the same configs, and either package's fit of
    either package's probe rows picks as the JAX fit of those rows."""
    j, p = stores
    make_j, make_p, *_ = _factories(40)
    cands = pcm.candidate_configs({40: 1}, defaults=(16, 1))
    assert len(cands) > 3
    before = pcm.M_PROBES.labels().get()
    dp = pcm.measured_sweep(make_p, 40, sig="sweep", budget=3, store=p)
    assert pcm.M_PROBES.labels().get() - before == 3
    dj = jcm.measured_sweep(make_j, 40, sig="sweep", budget=3, store=j)
    probes_p = p.rows(sig="sweep", source="probe")
    probes_j = j.rows(sig="sweep", source="probe")
    assert len(probes_p) == len(probes_j) == 3
    assert all(r["rows_per_sec"] > 0 for r in probes_p)
    assert [r["config"] for r in probes_p] == [r["config"]
                                               for r in probes_j]
    for mine, theirs in ((probes_p, dp), (probes_j, dj)):
        want = jcm.CostModel.fit(copy.deepcopy(mine)).choose(
            {40: 1}, (64, 2))
        got = pcm.CostModel.fit(copy.deepcopy(mine)).choose(
            {40: 1}, (64, 2))
        assert _decision(got) == _decision(want)
        assert (theirs.mini_batch_size, theirs.prefetch_depth,
                theirs.buckets) == (want.mini_batch_size,
                                    want.prefetch_depth, want.buckets)


# ---------------------------------------------------------------------------
# warm-up follows the active ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,ladder,want", [([5, 66], (66,), [66]),
                                               ([5, 66], None, [8, 128]),
                                               ([3, 17, 40], (4, 20, 40),
                                                [4, 20, 40])])
def test_warm_up_ladder_equals_reference(sizes, ladder, want):
    _, _, (jitted, jparams), pparams, *_ = _factories(66)
    specs = {"x": (np.dtype(np.float32), (8,))}
    before = M_WARMUP_BUCKETS.labels().get()
    got = p_warm(_apply_torch, pparams, specs, sizes, CPU, buckets=ladder)
    assert got["buckets"] == want
    assert M_WARMUP_BUCKETS.labels().get() - before == len(want)
    assert j_warm(jitted, jparams, specs, sizes,
                  buckets=ladder)["buckets"] == want


# ---------------------------------------------------------------------------
# BatchRunner(tuning="auto") and the harvest
# ---------------------------------------------------------------------------

_TIMING = ("seconds", "prep_seconds", "compile_seconds", "compiles", "t",
           "rows_per_sec")


def _untimed(rows):
    return [{k: v for k, v in r.items() if k not in _TIMING} for r in rows]


@pytest.mark.parametrize("n,m,d,ladder", [(40, 16, 1, None),
                                          (66, 64, 2, None),
                                          (66, 128, 0, (66, 128)),
                                          (7, 4, 2, (3, 4))])
def test_harvest_equals_reference_apart_from_seconds(stores, n, m, d,
                                                     ladder):
    j, p = stores
    make_j, make_p, *_ = _factories(n, model_sig="harvest")
    make_j(m, d, ladder).run_and_drain(n)
    out = make_p(m, d, ladder).run_and_drain(n)
    assert sum(b for _, b in out) == n
    got = p.rows(sig="harvest", source="runner")
    assert got and sum(r["rows"] for r in got) == n
    assert _untimed(got) == _untimed(j.rows(sig="harvest", source="runner"))
    assert all(r["compiles"] == 0 and r["seconds"] >= 0 for r in got)
    assert got[0]["config"] == {"mini_batch_size": m, "prefetch_depth": d,
                                "buckets": None if ladder is None
                                else list(ladder)}


def test_runner_without_signature_harvests_nothing(stores):
    _, p = stores
    _, make_p, *_ = _factories(40)
    make_p(16, 1, None).run_and_drain(40)
    assert len(p) == 0


def test_auto_applies_the_reference_pick(stores):
    """Seed both stores; the port's runner built with the 64/2 defaults and
    ``tuning="auto"`` adopts exactly the JAX package's decision, and its
    warm-up of the decision's vocabulary covers every bucket it runs."""
    j, p = stores
    sig = "auto-sig"
    record_both(stores, linear_rows(sig, alpha=0.01, beta=1e-4))
    want = jcm.resolve_tuning(sig, "default", {66: 1}, defaults=(64, 2),
                              store=j)
    _, make_p, _, pparams, *_ = _factories(66, model_sig=sig,
                                           tuning="auto")
    warm = p_warm(_apply_torch, pparams,
                  {"x": (np.dtype(np.float32), (8,))}, want.warm_up_sizes,
                  CPU, buckets=want.buckets)
    runner = make_p(64, 2, None)
    seeded = len(p.rows(sig=sig))
    out = runner.run_and_drain(66)
    assert _decision(runner.decision) == _decision(want)
    assert (runner.mini_batch_size, runner.prefetch_depth,
            runner.buckets) == (want.mini_batch_size, want.prefetch_depth,
                                want.buckets)
    assert sum(b for _, b in out) == 66
    ran = {r["bucket"] for r in p.rows(sig=sig)[seeded:]}
    assert ran <= set(warm["buckets"]) == set(want.vocabulary)
    # a second run does not consult the store again
    runner.run_and_drain(66)
    assert runner.decision is not None


def test_autotuned_decision_beats_defaults_on_skewed_workload(stores):
    """The acceptance criterion, restated on the decision: runs of 66
    rows; the tuned config (equal to the JAX package's) takes one
    dispatch a run and pads nothing, where the 64/2 power-of-two defaults
    take two dispatches (64 + 2); and the model predicts it faster. The
    pick re-fits from the persisted rows alone."""
    j, p = stores
    sig, n = "acc-sig", 66
    record_both(stores, linear_rows(sig, alpha=0.01, beta=1e-4))
    decision = pcm.resolve_tuning(sig, "default", {n: 1}, defaults=(64, 2),
                                  store=p)
    assert _decision(decision) == _decision(jcm.resolve_tuning(
        sig, "default", {n: 1}, defaults=(64, 2), store=j))
    assert decision.mini_batch_size >= n and decision.buckets is not None
    model = pcm.CostModel.fit(p.rows(sig=sig))
    assert model.predict_seconds({n: 1}, decision.mini_batch_size,
                                 decision.prefetch_depth, decision.buckets) \
        < model.predict_seconds({n: 1}, 64, 2, None)
    _, make_p, *_ = _factories(n)
    tuned = make_p(decision.mini_batch_size, decision.prefetch_depth,
                   decision.buckets)
    default = make_p(64, 2, None)
    tuned.run_and_drain(n)
    default.run_and_drain(n)
    assert tuned.counters.snapshot()["dispatch"]["calls"] == 1
    assert default.counters.snapshot()["dispatch"]["calls"] == 2
    refit = pcm.CostModel.fit(linear_rows(sig, alpha=0.01, beta=1e-4)
                              ).choose({n: 1}, defaults=(64, 2))
    assert (refit.mini_batch_size, refit.prefetch_depth, refit.buckets) == \
        (decision.mini_batch_size, decision.prefetch_depth, decision.buckets)


def test_ladder_and_tuning_validation():
    _, make_p, *_ = _factories(40)
    with pytest.raises(ValueError):
        make_p(64, 2, (8, 16))
    with pytest.raises(ValueError):
        PBatchRunner(_apply_torch, {}, lambda sl: {}, CPU, tuning="bogus")


# ---------------------------------------------------------------------------
# tuning="auto" at the four sites
# ---------------------------------------------------------------------------

def _matmul_graph(seed=7, name=""):
    import mmlspark_tpu_torch.onnx as O
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.5, (8, 3)).astype(np.float32)
    graph = O.make_graph(
        [O.make_node("MatMul", ["x", "w"], ["logits"], name=name)], "m",
        inputs=[O.make_tensor_value_info("x", np.float32, ["N", 8])],
        outputs=[O.make_tensor_value_info("logits", np.float32, ["N", 3])],
        initializers={"w": w})
    return O.make_model(graph)


def test_onnx_signature_matches_the_reference_and_is_stable():
    from mmlspark_tpu.models.onnx_model import ONNXModel as JONNXModel
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    b1, b2 = _matmul_graph(name="a"), _matmul_graph(name="b")
    assert b1 != b2                      # node names differ between builds
    kw = dict(feed_dict={"x": "f"}, fetch_dict={"o": "logits"})
    m1 = ONNXModel(b1, device="cpu", **kw)
    assert m1.tuning_signature() == ONNXModel(
        b2, device="cpu", **kw).tuning_signature()
    assert m1.tuning_signature() == JONNXModel(b1, **kw).tuning_signature()
    m1.set(compute_dtype="bfloat16")
    assert m1.tuning_signature().endswith(":bfloat16:fp")


@pytest.mark.parametrize("site", ["onnx", "torch"])
def test_models_take_the_store_pick(stores, site):
    """``ONNXModel`` / ``TorchModel`` with ``tuning="auto"``: a cold store
    keeps the params and its harvest lands under the model's signature;
    a seeded store's pick (the JAX package's decision on the same rows)
    sets the batches and the warm-up vocabulary."""
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    j, p = stores
    X = np.random.default_rng(1).normal(0, 1, (66, 8)).astype(np.float32)
    w = np.random.default_rng(2).normal(0, 1, (8, 3)).astype(np.float32)
    if site == "onnx":
        m = ONNXModel(_matmul_graph(), device="cpu", feed_dict={"x": "f"},
                      fetch_dict={"o": "logits"}, tuning="auto")
        spec = {}
    else:
        m = TorchModel(_apply_torch, {"w": w}, device="cpu",
                       feed_dict={"x": "f"}, fetch_dict={"o": "y"},
                       tuning="auto")
        spec = {"x": (np.float32, (8,))}
    df = DataFrame({"f": X})
    cold = m.transform(df)["o"]
    sig = m.tuning_signature()
    assert {r["bucket"] for r in p.rows(sig=sig)} == {64, 2}
    # the cold decision stays cached for this histogram (as in the JAX
    # package) until a reconfiguration drops it
    assert m._resolve_tuning({66: 1}) is None
    # a seeded store, the same rows in the JAX package's
    fresh = pobs.ObservationStore()
    pobs.set_store(fresh)
    rows = linear_rows(sig, alpha=0.01, beta=1e-4)
    fresh.record_many(copy.deepcopy(rows))
    j.record_many(copy.deepcopy(rows))
    m.set(tuning="auto")                 # drops the cached decisions
    # TorchModel resolves from single-device rows (mesh_shape "single"),
    # as the JAX package's JaxModel does off a mesh
    want = jcm.resolve_tuning(sig, "default", {66: 1}, defaults=(64, 2),
                              store=j,
                              mesh_shape="single" if site == "torch" else None)
    assert _decision(m._resolve_tuning({66: 1})) == _decision(want)
    assert m._runner_config(66) == (want.mini_batch_size,
                                    want.prefetch_depth, want.buckets)
    seeded = len(fresh.rows(sig=sig))
    tuned = m.transform(df)["o"]
    np.testing.assert_allclose(tuned, cold, rtol=1e-6, atol=1e-6)
    ran = {r["bucket"] for r in fresh.rows(sig=sig)[seeded:]}
    assert ran == set(want.vocabulary)
    warm = m.warm_up(spec, batch_sizes=[66]) if site == "torch" \
        else m.warm_up(batch_sizes=[66])
    assert warm["buckets"] == list(want.vocabulary)
    m.set(tuning="")
    assert m._resolve_tuning({66: 1}) is None


def test_serving_engine_switches_its_models_to_auto():
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.serving.engine import ServingEngine
    m = TorchModel(_apply_torch, {"w": np.eye(8, dtype=np.float32)},
                   device="cpu")
    warmed = []
    eng = ServingEngine(lambda df: df, tuning="auto", tuned_models=[m],
                        warm_up=lambda: warmed.append(m.get("tuning")))
    try:
        assert m.get("tuning") == ""
        eng.start()
        assert m.get("tuning") == "auto" and warmed == ["auto"]
    finally:
        eng.stop()
