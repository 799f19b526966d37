"""The port's core data plane (``mmlspark_tpu_torch/core/``) on the CPU:
DataFrame, Params, Pipeline and save/load against the JAX package's copies
(the same operations give equal results, exactly: nothing here does
arithmetic that could round differently), and the transfer-count contract
of ``tests/test_residency.py`` restated over torch tensors (one h2d at
ingest, one d2h at the sink, counted materialization, LRU spill and
restage, ``pad_axis_device``). The port's residency manager is
process-global, so every test starts from a spilled, unbudgeted manager
and zeroed counters."""

import json
import os

import numpy as np
import pytest
import torch

import mmlspark_tpu.core as jcore
import mmlspark_tpu_torch.core as pcore
import mmlspark_tpu_torch.core.residency as R
from mmlspark_tpu_torch.core import (DataFrame, Param, Params, Pipeline,
                                     PipelineModel, PipelineStage,
                                     Transformer, concat)
from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.core import serialize
from mmlspark_tpu_torch.core.pipeline import DeviceTransformer, Estimator, \
    Model
from mmlspark_tpu_torch.core.residency import (DeviceColumn, HostMirror,
                                               configure_residency,
                                               get_residency_manager,
                                               make_put, residency_stats)
from mmlspark_tpu_torch.models.runner import StagingSlabPool
from mmlspark_tpu_torch.observability import reset_all
from mmlspark_tpu_torch.ops.padding import pad_axis_device

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

CPU = make_put("cpu")


@pytest.fixture(autouse=True)
def _clean_slate():
    get_residency_manager().spill_all()
    configure_residency(0)
    reset_all()
    yield
    configure_residency(0)


def _h2d(site):
    return R.M_H2D.labels(site=site).get()


def _d2h(site):
    return R.M_D2H.labels(site=site).get()


class Scale(DeviceTransformer):
    def _transform_device(self, arrays):
        return {n: a * 2.0 for n, a in arrays.items()}


class AddOne(Transformer):
    col = Param(str, default="x", doc="column")

    def _transform(self, df):
        return df.with_column(self.col, df[self.col] + 1)


class MeanModel(Model):
    mean = Param(float, default=0.0, doc="fitted mean")

    def _transform(self, df):
        return df.with_column("centered", df["x"] - self.mean)


class MeanEstimator(Estimator):
    def _fit(self, df):
        return MeanModel(mean=float(np.mean(df["x"])))


# ---------------------------------------------------------------------------
# Params and DataFrame against the JAX package


class JParamsStage(jcore.Params):
    n = jcore.Param(int, default=3, doc="an int")
    r = jcore.Param(float, default=0.5, doc="a float")
    names = jcore.Param((list, str), default=[], doc="names")
    mode = jcore.Param(str, default="a", choices=["a", "b"], doc="mode")


class PParamsStage(Params):
    n = Param(int, default=3, doc="an int")
    r = Param(float, default=0.5, doc="a float")
    names = Param((list, str), default=[], doc="names")
    mode = Param(str, default="a", choices=["a", "b"], doc="mode")


@pytest.mark.parametrize("value", [
    {"n": 7}, {"n": np.int64(4)}, {"n": 2.0}, {"r": 3}, {"r": np.float32(2)},
    {"names": ("a", "b")}, {"mode": "b"}, {"n": True}, {"n": 2.5},
    {"r": "x"}, {"mode": "c"}, {"names": "ab"}])
def test_params_convert_and_reject_as_the_reference(value):
    """Every converter accepts and refuses the same values, with the same
    resulting value and type, in both packages."""
    results = []
    for cls in (JParamsStage, PParamsStage):
        p = cls()
        try:
            p.set(**value)
            got = p.extract_param_map()
            results.append(("ok", {k: (v, type(v).__name__)
                                   for k, v in got.items()}))
        except (TypeError, ValueError) as e:
            results.append((type(e).__name__, None))
    assert results[0] == results[1]


def test_params_copy_isolated_and_uids_unique():
    a = PParamsStage(n=5)
    b = a.copy({"n": 6})
    assert (a.n, b.n) == (5, 6)
    assert a.uid != PParamsStage().uid
    assert "an int" in a.explain_params()
    with pytest.raises(KeyError):
        a.set(nope=1)


def _frame(pkg, npartitions=3):
    rng = np.random.default_rng(0)
    return pkg.DataFrame({"x": rng.normal(0, 1, 10).astype(np.float32),
                          "k": rng.integers(0, 4, 10),
                          "s": [f"r{i}" for i in range(10)]},
                         npartitions=npartitions)


@pytest.mark.parametrize("op", [
    lambda d: d.filter(np.arange(10) % 3 != 0),
    lambda d: d.take([9, 0, 4, 4]),
    lambda d: d.head(4),
    lambda d: d.sort_values("x"),
    lambda d: d.sort_values("k", ascending=False),
    lambda d: d.select(["s", "x"]).rename({"s": "t"}),
    lambda d: d.drop("k").with_column("y", np.arange(10)),
    lambda d: d.repartition(4).sample(0.5, seed=3),
    lambda d: d.shuffle(seed=1),
    lambda d: d.map_partitions(lambda p, i: p.with_column(
        "i", np.full(len(p), i)))])
def test_dataframe_ops_match_reference(op):
    """The same row operations give identical columns, partition bounds
    and schemas in both packages."""
    j, p = op(_frame(jcore)), op(_frame(pcore))
    assert j.columns == p.columns and len(j) == len(p)
    assert j.partition_bounds() == p.partition_bounds()
    assert j.schema() == p.schema()
    for c in j.columns:
        np.testing.assert_array_equal(j[c], p[c])


def test_map_partitions_order_errors_and_nesting():
    df = DataFrame({"x": np.arange(20)}, npartitions=5)
    out = df.map_partitions(lambda p, i: p.with_column(
        "i", np.full(len(p), i)), max_workers=4)
    np.testing.assert_array_equal(out["x"], np.arange(20))
    np.testing.assert_array_equal(out["i"], np.repeat(np.arange(5), 4))

    def boom(p, i):
        if i == 2:
            raise RuntimeError("partition 2")
        return p
    with pytest.raises(RuntimeError, match="partition 2"):
        df.map_partitions(boom)

    def nested(p, i):
        return p.map_partitions(lambda q, j: q)
    assert len(df.map_partitions(nested)) == 20


def test_metadata_and_schema_helpers():
    df = S.set_categorical_metadata(DataFrame({"c": np.arange(3)}), "c",
                                    [np.int64(1), "b"])
    assert S.get_categorical_levels(df.take([2, 0]), "c") == [1, "b"]
    assert S.find_unused_column_name("c", df) == "c_1"
    np.testing.assert_array_equal(
        S.assemble_vector(DataFrame({"a": np.arange(2), "b": [np.ones(2)] * 2}),
                          ["a", "b"]), [[0, 1, 1], [1, 1, 1]])


# ---------------------------------------------------------------------------
# Pipeline and persistence


def test_pipeline_fit_transform_and_params_override():
    df = DataFrame({"x": np.arange(4, dtype=np.float64)})
    model = Pipeline(stages=[AddOne(), MeanEstimator()]).fit(df)
    out = model.transform(df)
    np.testing.assert_allclose(out["centered"], np.arange(4) - 1.5)
    out2 = AddOne().transform(df, {"col": "x"})
    np.testing.assert_allclose(out2["x"], np.arange(4) + 1)


@pytest.mark.parametrize("value", [
    np.arange(6, dtype=np.int32).reshape(2, 3), b"\x00\x01bytes",
    {"a": [np.ones(2, np.float32), 3], "b": {"c": np.float64(2.5)}},
    {"plain": [1, "two"]}, np.array(["u", "vw"]),
    [np.arange(3), (np.zeros(1),)]])
def test_complex_values_roundtrip(tmp_path, value):
    tag = serialize.save_value(value, str(tmp_path / "v"))
    back = serialize.load_value(tag, str(tmp_path / "v"))

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        else:
            assert a == b
    same(value, back)


def test_port_stage_roundtrip_and_reference_stage_refused(tmp_path):
    """A port pipeline model saves and loads; a stage saved by the JAX
    package (whose metadata names ``mmlspark_tpu`` modules) is refused
    before anything is imported."""
    from mmlspark_tpu.models.onnx_model import ONNXModel as JONNXModel
    from mmlspark_tpu_torch.models.onnx_model import ONNXModel
    from mmlspark_tpu_torch.onnx import (make_graph, make_model, make_node,
                                         make_tensor_value_info)
    g = make_graph([make_node("Relu", ["x"], ["y"])], "g",
                   [make_tensor_value_info("x", np.float32, ["N", 2])],
                   [make_tensor_value_info("y", np.float32, ["N", 2])])
    data = make_model(g)
    pm = PipelineModel([ONNXModel(data, device="cpu", mini_batch_size=3)])
    path = str(tmp_path / "port")
    pm.save(path)
    meta = json.load(open(os.path.join(path, "metadata.json")))
    assert meta["class"].startswith("mmlspark_tpu_torch.")
    back = PipelineStage.load(path)
    assert back.get("stages")[0].mini_batch_size == 3

    jpath = str(tmp_path / "jax")
    JONNXModel(data).save(jpath)
    with pytest.raises(ValueError, match="refusing to load 'mmlspark_tpu"):
        PipelineStage.load(jpath)


# ---------------------------------------------------------------------------
# the residency contract: one h2d at ingest, one d2h at the sink


def test_three_stage_pipeline_moves_data_exactly_twice():
    df = DataFrame({"x": np.arange(8, dtype=np.float32)})
    stages = [Scale(input_cols=["x"], device="cpu") for _ in range(3)]
    model = Pipeline(stages=stages).fit(df)
    reset_all()   # fit's pass-through transforms staged their own copy
    out = model.transform(df)
    assert _h2d("ingest") == 1
    assert _h2d("restage") == 0
    assert R.M_MISSES.labels().get() == 1
    assert R.M_HITS.labels().get() == 2
    assert _d2h("sink") == 0

    host = out.to_host()
    assert _d2h("sink") == 1
    assert _d2h("materialize") == 0
    np.testing.assert_allclose(host["x"], np.arange(8) * 8.0)
    assert residency_stats()["residency_hit_rate"] == pytest.approx(2 / 3)


def test_device_put_is_idempotent_and_defaults_to_the_card():
    df = DataFrame({"x": np.arange(4, dtype=np.float32)})
    staged = df.device_put(["x"], put=CPU)
    again = staged.device_put(["x"], put=CPU)
    assert again.is_resident("x")
    assert _h2d("ingest") == 1
    assert R.M_HITS.labels().get() == 1
    assert R.M_MISSES.labels().get() == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            df.device_put(["x"])


def test_row_ops_stay_resident_and_keep_metadata():
    df = DataFrame({"x": np.arange(12, dtype=np.float32)}, npartitions=3)
    df = S.set_categorical_metadata(df, "x", ["lo", "hi"])
    df = df.device_put(["x"], put=CPU)
    out = (df.filter(np.arange(12) % 2 == 0)
             .take([0, 2, 4])
             .sort_values("x", ascending=False)
             .repartition(2)
             .head(2))
    assert out.is_resident("x")
    assert S.get_categorical_levels(out, "x") == ["lo", "hi"]
    assert _h2d("ingest") == 1
    assert _d2h("sink") == 0 and _d2h("materialize") == 0
    np.testing.assert_allclose(out.to_host()["x"], [8.0, 4.0])


def test_concat_of_resident_frames_stays_resident():
    df = DataFrame({"x": np.arange(6, dtype=np.float32)},
                   npartitions=2).device_put(["x"], put=CPU)
    back = concat(list(df.partitions()))
    assert back.is_resident("x")
    assert _d2h("sink") == 0 and _d2h("materialize") == 0
    np.testing.assert_allclose(back.to_host()["x"], np.arange(6))


def test_lru_spill_respects_budget_and_restages_on_access():
    df = DataFrame({"x": np.zeros(16, dtype=np.float32)}, npartitions=4)
    col = df.device_put(["x"], put=CPU).device_column("x")
    assert col.chunk_states() == ["device"] * 4
    configure_residency(32)          # room for 2 of the 4 16-byte chunks
    assert col.chunk_states() == ["spilled", "spilled", "device", "device"]
    assert get_residency_manager().stats()["resident_bytes"] <= 32
    assert R.M_SPILLS.labels().get() == 2
    assert _d2h("spill") == 0        # ingest kept host views: free spill
    assert len(col.device_array()) == 16
    assert _h2d("restage") > 0


def test_spill_is_lru_ordered_and_device_born_spill_is_counted():
    df = DataFrame({"x": np.zeros(16, dtype=np.float32)}, npartitions=4)
    col = df.device_put(["x"], put=CPU).device_column("x")
    col.slice_rows(0, 4).device_array()   # chunk 0 most recently used
    configure_residency(32)
    states = col.chunk_states()
    assert states[0] == "device" and states.count("spilled") == 2

    configure_residency(0)
    born = DeviceColumn.from_device([torch.arange(8, dtype=torch.float32)])
    get_residency_manager().spill_all()
    assert born.chunk_states() == ["spilled"]
    assert _d2h("spill") == 1         # no host copy: one writeback
    np.testing.assert_allclose(born.to_host(), np.arange(8))


def test_host_mirror_materializes_once_and_is_counted():
    df = DataFrame({"x": np.arange(4, dtype=np.float32)})
    df = df.with_device_column("y", torch.arange(4, dtype=torch.bfloat16) + 1)
    assert df.is_resident("y")
    assert isinstance(df._columns["y"], HostMirror)
    assert df._columns["y"].dtype == np.float32   # bf16 comes back as f32
    assert _d2h("materialize") == 0
    first = df["y"]
    assert _d2h("materialize") == 1
    assert R.M_MATERIALIZE.labels(op="materialize").get() == 1
    np.testing.assert_allclose(first, [1, 2, 3, 4])
    assert first.dtype == np.float32
    df["y"]
    assert _d2h("materialize") == 1


def test_to_host_returns_plain_frame():
    df = DataFrame({"x": np.arange(4, dtype=np.float32)}).device_put(
        ["x"], put=CPU)
    host = df.to_host()
    assert not host.resident_columns
    assert isinstance(host["x"], np.ndarray)


def test_device_column_transfer_batching():
    df = DataFrame({"x": np.arange(12, dtype=np.float32)}, npartitions=3)
    df = df.device_put(["x"], put=CPU)
    assert _h2d("ingest") == 1
    col = df.device_column("x")
    assert len(col.chunk_states()) == 3
    col.to_host()
    dcol = DeviceColumn.from_device([c * 1.0 for c in col.device_chunks()])
    dcol.to_host()
    assert _d2h("sink") == 1


def test_staging_slab_pool_reuses_and_caps():
    pool = StagingSlabPool(depth=2, pin=False)
    a = pool.acquire((4, 2), np.float32)
    b = pool.acquire((4, 2), np.float32)
    assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
    assert pool.stats()["allocs"] == 2
    pool.release(a)
    c = pool.acquire((4, 2), np.float32)
    assert c is a and pool.stats()["reuses"] == 1
    assert not pool.release(torch.zeros((4, 2)))
    assert not pool.release(np.zeros((4, 2), np.float32))
    for t in (b, c):
        assert pool.release(t)
    assert not pool.release(c)


def test_pad_axis_device_stays_on_device():
    arr = torch.arange(6, dtype=torch.float32)
    padded = pad_axis_device(arr, 8)
    assert R.is_device_array(padded) and padded.shape == (8,)
    np.testing.assert_allclose(padded[6:].numpy(), 0.0)
    assert pad_axis_device(arr, 6) is arr
    img = torch.ones((3, 2, 2, 3), dtype=torch.uint8)
    assert pad_axis_device(img, 4)[3].sum() == 0
    with pytest.raises(ValueError):
        pad_axis_device(arr, 4)
