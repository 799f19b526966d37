"""The port's batched ONNX inference (``DataFrame`` → ``ONNXModel.transform``,
``mmlspark_tpu_torch/models/onnx_model.py``) against the JAX package on
the CPU, on the tiny ResNet of ``tests/test_zoo_parallel.py``
(``ResNetConfig([1, 1], num_classes=7, width=8)``, 32×32 inputs) fed as
13 uint8 NHWC rows with ``transpose_dict``, ``normalize_dict`` and
``argmax_dict`` at ``mini_batch_size=4``, so the last batch is a ragged
tail padded to its bucket.

Tolerances: float32 logits within ``F32`` (rtol 1e-5, atol 1e-5: sum
order only) with argmax identical, the test first checking that every
row's top-two gap is far above it; bfloat16 logits within ``BF16`` (rtol
and atol 2^-7: a few bf16 roundings of values of order 1) with argmax
identical wherever the reference's top-two gap exceeds twice that.
``init_resnet`` and the exporter's initializers are held bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.models.onnx_model import ONNXModel as JONNXModel
from mmlspark_tpu.models.zoo import resnet as jres
from mmlspark_tpu.onnx import proto as jproto
from mmlspark_tpu_torch.core import DataFrame, PipelineStage
from mmlspark_tpu_torch.core.residency import (configure_residency,
                                               get_residency_manager,
                                               make_put)
from mmlspark_tpu_torch.models.onnx_model import ONNXModel
from mmlspark_tpu_torch.models.zoo import resnet as pres
from mmlspark_tpu_torch.observability import reset_all
from mmlspark_tpu_torch.onnx import proto as pproto
from mmlspark_tpu_torch.ops.padding import bucket_size

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


@pytest.fixture(autouse=True)
def _clean_slate():
    get_residency_manager().spill_all()
    configure_residency(0)
    reset_all()


def _tiny(pkg, dtype=None):
    kw = {} if dtype is None else {"dtype": dtype}
    return pkg.ResNetConfig([1, 1], num_classes=7, width=8, **kw)


def _images(n=13, seed=0):
    """Structured uint8 NHWC images (a colour, a ramp, noise per row), so
    the random network's predictions differ from row to row."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 1, 1, 3))
    ramp = np.linspace(0, 1, 32)[None, :, None, None] * \
        rng.integers(-128, 128, (n, 1, 1, 3))
    return np.clip(base + ramp + rng.normal(0, 20, (n, 32, 32, 3)), 0,
                   255).astype(np.uint8)


def _kw(mini_batch_size=4, **extra):
    return dict(feed_dict={"input": "image"},
                fetch_dict={"logits": "logits"},
                transpose_dict={"input": [0, 3, 1, 2]},
                normalize_dict={"input": {"scale": 1 / 255., "mean": MEAN,
                                          "std": STD}},
                argmax_dict={"pred": "logits"},
                mini_batch_size=mini_batch_size, **extra)


@pytest.fixture(scope="module")
def model_bytes():
    return pres.export_resnet_onnx(_tiny(pres), seed=0, input_size=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("npartitions", [1, 2])
def test_transform_matches_reference(model_bytes, dtype, npartitions):
    X = _images()
    want = JONNXModel(model_bytes, compute_dtype=dtype, **_kw()).transform(
        JDataFrame({"image": X}, npartitions=npartitions))
    m = ONNXModel(model_bytes, device="cpu", compute_dtype=dtype, **_kw())
    got = m.transform(DataFrame({"image": X}, npartitions=npartitions))
    wl, gl = np.asarray(want["logits"], np.float32), got["logits"]
    assert gl.dtype == np.float32 and gl.shape == (13, 7)
    assert got["pred"].dtype == np.int64
    top2 = np.sort(wl, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    if dtype == "float32":
        np.testing.assert_allclose(gl, wl, **F32)
        assert gap.min() > 10 * (F32["atol"] + F32["rtol"] * abs(wl).max())
        np.testing.assert_array_equal(got["pred"], want["pred"])
    else:
        np.testing.assert_allclose(gl, wl, **BF16)
        clear = gap > 2 * (BF16["atol"] + BF16["rtol"] * np.abs(wl).max())
        assert clear.sum() >= 1
        np.testing.assert_array_equal(got["pred"][clear],
                                      np.asarray(want["pred"])[clear])
    assert len(set(got["pred"])) > 1        # the rows are told apart
    # each partition's rows in batches of 4, a ragged tail padded to its
    # power-of-two bucket, every padded batch moved once
    padded = [bucket_size(min(4, hi - lo - i))
              for lo, hi in DataFrame({"image": X}, npartitions=npartitions)
              .partition_bounds() for i in range(0, hi - lo, 4)]
    snap = m.stage_counters.snapshot()
    assert snap["dispatch"]["calls"] == len(padded)
    assert snap["h2d"]["bytes"] == sum(padded) * 32 * 32 * 3


def test_resnet_apply_matches_reference():
    x = np.random.default_rng(1).normal(0, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    params = pres.init_resnet(_tiny(pres), seed=1)
    for pdt, jdt, tol in ((torch.float32, jnp.float32, F32),
                          (torch.bfloat16, jnp.bfloat16, BF16)):
        for features_only in (False, True):
            got = pres.resnet_apply(params, torch.from_numpy(x),
                                    _tiny(pres, pdt), features_only)
            want = jres.resnet_apply(params, jnp.asarray(x),
                                     _tiny(jres, jdt), features_only)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_resnet_apply_matches_its_onnx_export():
    params = pres.init_resnet(_tiny(pres), seed=2)
    cfg = _tiny(pres, torch.float32)
    data = pres.export_resnet_onnx(cfg, params=params, input_size=32)
    from mmlspark_tpu_torch.onnx import convert_model
    cm = convert_model(data)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 32, 32, 3)).astype(np.float32))
    np.testing.assert_allclose(
        cm(cm.params, {"input": x.permute(0, 3, 1, 2)})["logits"].numpy(),
        pres.resnet_apply(params, x, cfg).numpy(), **F32)


@pytest.mark.parametrize("cfg_name", ["tiny", "RESNET50"])
def test_init_and_export_are_bitwise_the_reference(cfg_name):
    if cfg_name == "tiny":
        pc, jc, size = _tiny(pres), _tiny(jres), 32
    else:
        pc, jc, size = pres.RESNET50, jres.RESNET50, 224
    pp, jp = pres.init_resnet(pc, seed=3), jres.init_resnet(jc, seed=3)

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]
    for a, b in zip(leaves(pp), leaves(jp), strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if cfg_name == "RESNET50":
        return      # the full exporter runs on the card (chip_smoke 11)
    pm = pproto.parse_model(pres.export_resnet_onnx(pc, params=pp,
                                                    input_size=size))
    jm = jproto.parse_model(jres.export_resnet_onnx(jc, params=jp,
                                                    input_size=size))
    pinit = {t.name: pproto.tensor_to_numpy(t) for t in pm.graph.initializers}
    jinit = {t.name: jproto.tensor_to_numpy(t) for t in jm.graph.initializers}
    assert sorted(pinit) == sorted(jinit)
    for k in pinit:
        assert pinit[k].dtype == jinit[k].dtype
        assert pinit[k].tobytes() == jinit[k].tobytes()
    assert [n.op_type for n in pm.graph.nodes] == \
        [n.op_type for n in jm.graph.nodes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_resident_feed_moves_no_bytes(model_bytes, dtype):
    """A resident uint8 column feeds device slices: zero h2d bytes, the
    outputs stay resident, and they equal the host-fed run's bitwise."""
    X = _images()
    host = ONNXModel(model_bytes, device="cpu", compute_dtype=dtype,
                     **_kw()).transform(DataFrame({"image": X}))
    m = ONNXModel(model_bytes, device="cpu", compute_dtype=dtype,
                  output_device=True, **_kw())
    df = DataFrame({"image": X}, npartitions=2).device_put(
        ["image"], put=make_put("cpu"))
    out = m.transform(df)
    assert set(out.resident_columns) == {"image", "logits", "pred"}
    assert m.stage_counters.snapshot()["h2d"]["bytes"] == 0
    dev = out.device_column("logits").device_array()
    assert dev.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    back = out.to_host()
    np.testing.assert_array_equal(back["logits"], host["logits"])
    np.testing.assert_array_equal(back["pred"], host["pred"])


def test_save_load_and_transform_again(model_bytes, tmp_path):
    X = _images(6, seed=4)
    m = ONNXModel(model_bytes, device="cpu", **_kw(mini_batch_size=3))
    first = m.transform(DataFrame({"image": X}))
    path = str(tmp_path / "onnx_model")
    m.save(path)
    back = ONNXModel.load(path, device="cpu")
    assert back.device.type == "cpu"
    assert back.mini_batch_size == 3 and back.get("model_bytes") == \
        model_bytes
    again = back.transform(DataFrame({"image": X}))
    np.testing.assert_array_equal(again["logits"], first["logits"])
    np.testing.assert_array_equal(again["pred"], first["pred"])
    generic = PipelineStage.load(path)      # device resolved on first use
    assert isinstance(generic, ONNXModel)


def test_warm_up_runs_each_bucket_once(model_bytes):
    m = ONNXModel(model_bytes, device="cpu", **_kw())
    stats = m.warm_up(batch_sizes=[4, 3, 1],
                      input_specs={"input": (np.uint8, (32, 32, 3))})
    assert stats["buckets"] == [1, 4] and stats["placements"] == 1
    assert m.stage_counters.snapshot()["compile"]["calls"] == 2
    # without specs, the declared NCHW row shape is run back through the
    # transpose: float32 (32, 32, 3) zeros, one bucket of mini_batch_size
    assert m.warm_up()["buckets"] == [4]


def test_metadata_post_ops_and_unported_options(model_bytes):
    m = ONNXModel(model_bytes, device="cpu")
    assert list(m.model_inputs()) == ["input"]
    assert m.model_inputs()["input"][1] == ("N", 3, 32, 32)
    assert set(m.model_outputs()) == {"logits", "feat"}
    X = _images(5, seed=5)
    out = ONNXModel(model_bytes, device="cpu",
                    **_kw(softmax_dict={"probs": "logits"})).transform(
        DataFrame({"image": X}))
    np.testing.assert_allclose(out["probs"].sum(axis=1), 1.0, rtol=1e-6)
    # tuning="auto" is ported: accepted at construction
    assert ONNXModel(model_bytes, device="cpu",
                     tuning="auto").get("tuning") == "auto"
    # weights_override (ported): an npz of changed params layered over
    # the initializers serves as the JAX ONNXModel serves it
    import io
    from mmlspark_tpu_torch.onnx import convert_model
    params = convert_model(model_bytes).params
    name = sorted(k for k, v in params.items() if v.ndim == 2)[0]
    buf = io.BytesIO()
    np.savez(buf, **{name: params[name] * 1.5})
    ov = buf.getvalue()
    want = JONNXModel(model_bytes, weights_override=ov, **_kw()).transform(
        JDataFrame({"image": X}))
    got = ONNXModel(model_bytes, device="cpu", weights_override=ov,
                    **_kw()).transform(DataFrame({"image": X}))
    np.testing.assert_allclose(np.stack(list(got["logits"])),
                               np.stack(list(want["logits"])), rtol=1e-5,
                               atol=1e-5)
    plain = ONNXModel(model_bytes, device="cpu", **_kw()).transform(
        DataFrame({"image": X}))
    assert not np.allclose(np.stack(list(got["logits"])),
                           np.stack(list(plain["logits"])))
    sharded = ONNXModel(model_bytes, device="cpu", mesh_sharded=True,
                        **_kw())
    with pytest.raises(NotImplementedError, match="ROADMAP slice 6"):
        sharded.transform(DataFrame({"image": X}))


def test_external_data_dir_loads_the_bert_graph(tmp_path):
    """``external_data_dir``: the BERT encoder exported with its matrices
    in a sidecar file serves through ``ONNXModel`` exactly as the inline
    export does (outputs bitwise), and as the JAX ``ONNXModel`` serves it;
    without the directory, or from one without the sidecar file, the
    graph fails to load."""
    from mmlspark_tpu.models.zoo import bert_onnx as jbert
    from mmlspark_tpu_torch.models.zoo import bert_onnx as pbert
    cfg = pbert.BertOnnxConfig()
    params = pbert.init_bert_params(cfg, seed=3)
    ext = pbert.export_bert_onnx(cfg, params=params,
                                 external_data_dir=str(tmp_path))
    inline = pbert.export_bert_onnx(cfg, params=params)
    rng = np.random.default_rng(4)
    ids = rng.integers(1, cfg.vocab, (9, 20)).astype(np.int64)
    mask = (np.arange(20)[None] < rng.integers(5, 21, (9, 1))).astype(
        np.int64)
    kw = dict(feed_dict={"input_ids": "ids", "attention_mask": "mask"},
              fetch_dict={"hidden": "last_hidden_state"}, mini_batch_size=4)
    got = ONNXModel(ext, device="cpu", external_data_dir=str(tmp_path),
                    **kw).transform(DataFrame({"ids": ids, "mask": mask}))
    want = ONNXModel(inline, device="cpu", **kw).transform(
        DataFrame({"ids": ids, "mask": mask}))
    np.testing.assert_array_equal(got["hidden"], want["hidden"])
    jgot = JONNXModel(jbert.export_bert_onnx(
        cfg, params=params, external_data_dir=str(tmp_path / "j")),
        external_data_dir=str(tmp_path / "j"), **kw).transform(
        JDataFrame({"ids": ids, "mask": mask}))
    np.testing.assert_allclose(got["hidden"], np.asarray(jgot["hidden"]),
                               **F32)
    with pytest.raises(ValueError, match="external_data_dir"):
        ONNXModel(ext, device="cpu", **kw).transform(
            DataFrame({"ids": ids, "mask": mask}))
    with pytest.raises(FileNotFoundError, match="weights.bin"):
        ONNXModel(ext, device="cpu", external_data_dir=str(tmp_path / "x"),
                  **kw).transform(DataFrame({"ids": ids, "mask": mask}))


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ONNXModel(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        ONNXModel()
