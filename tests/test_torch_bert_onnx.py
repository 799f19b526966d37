"""BERT through the port's ONNX path (``models/zoo/bert_onnx.py``,
``onnx/convert.py``, ``models/onnx_model.py``) against the JAX package on
the CPU, at the reference tests' tiny config (``tests/test_onnx_foreign.py``:
vocab 97, 2 layers, d_model 48, 4 heads).

* The port's ``export_bert_onnx`` writes, for the same config, seed and
  opset, the same nodes, attributes, inputs, outputs and bitwise-equal
  initializers as the JAX package's (node names excluded: the builder
  derives them from object ids).
* The same bytes through both converters and ``bert_reference`` at opsets
  11, 13 and 17 (``F32``: within 1e-5 · max|ref| + 1e-6 of the JAX
  converter; ``REF``: rtol 2e-4, atol 2e-5 of the numpy reference, the
  reference test's bound).
* The ORT-optimized graph ``chip_smoke.fused_bert_onnx`` writes (the graph
  phase 14 runs on the card) through both converters, and against the
  decomposed graph with the same params on the port (``F32``).
* ``ONNXModel(device="cpu")`` against the JAX ``ONNXModel`` on one id/mask
  ``DataFrame``: int64 ids and masks reach the graph as integers, in
  float32 and bfloat16 (``BF16``: 2^-5 · max|ref|, four bf16 ulps at the
  largest value: each package rounds every node's output to bf16, in its
  own order, through 2 layers); warm-up over the dynamic
  sequence axis takes ``input_specs`` in both packages.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mmlspark_tpu.onnx as J
import mmlspark_tpu_torch.onnx as O
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.models.onnx_model import ONNXModel as JONNXModel
from mmlspark_tpu.models.zoo import bert_onnx as jbert
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.models.onnx_model import ONNXModel
from mmlspark_tpu_torch.models.zoo import bert_onnx as pbert
from mmlspark_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import bert_rows, fused_bert_onnx  # noqa: E402

CFG = pbert.BertOnnxConfig(vocab=97, layers=2, d_model=48, heads=4, d_ff=96,
                           max_len=32)
JCFG = jbert.BertOnnxConfig(vocab=97, layers=2, d_model=48, heads=4,
                            d_ff=96, max_len=32)
REF = dict(rtol=2e-4, atol=2e-5)


def _f32_close(got, want):
    tol = 1e-5 * float(np.abs(want).max()) + 1e-6
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol


def _io(seed=0, B=3, S=17):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab, (B, S)).astype(np.int64)
    mask = np.ones((B, S), dtype=np.int64)
    mask[0, S - 4:] = 0  # ragged rows
    mask[2, S - 1:] = 0
    return ids, mask


def _port(data, feeds):
    pm = O.convert_model(data)
    return {k: v.numpy() for k, v in pm(
        {k: torch.from_numpy(v) for k, v in pm.params.items()},
        {k: torch.from_numpy(v) for k, v in feeds.items()}).items()}


def _jax(data, feeds):
    jm = J.convert_model(data)
    return {k: np.asarray(v) for k, v in jm(
        jm.params, {k: jnp.asarray(v) for k, v in feeds.items()}).items()}


def _view(pkg, data):
    m = pkg.parse_model(data)
    g = m.graph
    return {"opset": m.opset, "imports": dict(m.opset_imports),
            "producer": m.producer_name,
            "nodes": [(n.op_type, n.domain, list(n.input), list(n.output),
                       {k: repr(n.attr(k)) for k in sorted(n.attributes)})
                      for n in g.nodes],
            "inputs": [(v.name, v.elem_type, list(v.shape))
                       for v in g.inputs],
            "outputs": [(v.name, v.elem_type, list(v.shape))
                        for v in g.outputs]}


def _inits(pkg, data):
    return {t.name: pkg.tensor_to_numpy(t)
            for t in pkg.parse_model(data).graph.initializers}


@pytest.mark.parametrize("opset", [11, 13, 17])
def test_export_matches_reference_exporter(opset):
    mine = pbert.export_bert_onnx(CFG, seed=3, opset=opset)
    ref = jbert.export_bert_onnx(JCFG, seed=3, opset=opset)
    assert _view(O, mine) == _view(J, ref)
    a, b = _inits(O, mine), _inits(J, ref)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_init_params_bitwise():
    a, b = pbert.init_bert_params(CFG, 5), jbert.init_bert_params(JCFG, 5)
    assert list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
               for k in a)


@pytest.mark.parametrize("opset", [11, 13, 17])
def test_both_converters_and_reference(opset):
    params = pbert.init_bert_params(CFG, seed=1)
    data = pbert.export_bert_onnx(CFG, opset=opset, params=params)
    ids, mask = _io()
    feeds = {"input_ids": ids, "attention_mask": mask}
    got, want = _port(data, feeds), _jax(data, feeds)
    for name in ("last_hidden_state", "pooled"):
        _f32_close(got[name], want[name])
    np.testing.assert_allclose(got["last_hidden_state"],
                               pbert.bert_reference(params, ids, mask, CFG),
                               **REF)


def test_dynamic_axes_and_external_data_not_ported(tmp_path):
    params = pbert.init_bert_params(CFG, seed=2)
    cm = O.convert_model(pbert.export_bert_onnx(CFG, params=params))
    assert {v.name: v.shape for v in cm.inputs}["input_ids"] == \
        ["batch", "seq"]
    for B, S in [(1, 5), (4, 12), (2, 32)]:
        out = _port(pbert.export_bert_onnx(CFG, params=params),
                    {"input_ids": np.ones((B, S), np.int64),
                     "attention_mask": np.ones((B, S), np.int64)})
        assert out["last_hidden_state"].shape == (B, S, CFG.d_model)
    # external data (the name predates its port): the exporter spills the
    # matrices into one sidecar file, written bytes for bytes as the JAX
    # exporter writes them, and both converters read the graph back to the
    # inline graph's outputs, bitwise
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    ext = pbert.export_bert_onnx(CFG, params=params,
                                 external_data_dir=str(pdir))
    jext = jbert.export_bert_onnx(CFG, params=params,
                                  external_data_dir=str(jdir))
    assert (pdir / "weights.bin").read_bytes() == \
        (jdir / "weights.bin").read_bytes()
    assert _view(O, ext) == _view(J, jext)
    ids, mask = _io(seed=9)
    feeds = {"input_ids": ids, "attention_mask": mask}
    inline = _port(pbert.export_bert_onnx(CFG, params=params), feeds)
    pm = O.convert_model(ext, external_data_dir=str(pdir))
    got = {k: v.numpy() for k, v in pm(
        {k: torch.from_numpy(v) for k, v in pm.params.items()},
        {k: torch.from_numpy(v) for k, v in feeds.items()}).items()}
    for name in inline:
        np.testing.assert_array_equal(got[name], inline[name])
    with pytest.raises(ValueError, match="external_data_dir"):
        O.convert_model(ext)


def test_fused_graph_through_both_converters():
    """The ORT-optimized encoder phase 14 runs on the card: the same
    network as the decomposed export (epsilon 1e-5, erf-GELU, -1e30 mask
    against -1e4 bias: equal wherever a row has a valid key)."""
    params = pbert.init_bert_params(CFG, seed=4)
    fused = fused_bert_onnx(CFG, params)
    ops = [n.op_type for n in O.parse_model(fused).graph.nodes]
    assert ops[0] == "EmbedLayerNormalization"
    assert ops.count("Attention") == CFG.layers
    assert ops.count("SkipLayerNormalization") == 2 * CFG.layers
    assert ops.count("BiasGelu") == CFG.layers
    ids, mask = _io(seed=5)
    feeds = {"input_ids": ids, "attention_mask": mask}
    got, want = _port(fused, feeds), _jax(fused, feeds)
    _f32_close(got["last_hidden_state"], want["last_hidden_state"])
    dec = _port(pbert.export_bert_onnx(CFG, params=params, opset=17),
                feeds)["last_hidden_state"]
    _f32_close(got["last_hidden_state"], dec)


def test_bert_rows_are_right_padded():
    ids, mask = bert_rows(64, 512, CFG.vocab, seed=1)
    lengths = mask.sum(1)
    assert ids.dtype == mask.dtype == np.int64
    assert lengths.min() >= 32 and lengths.max() <= 512
    assert len(set(lengths.tolist())) > 1
    assert np.array_equal(mask, (np.arange(512) < lengths[:, None]))
    assert np.all(ids[mask == 0] == 0) and np.all(ids[mask == 1] > 0)


@pytest.mark.parametrize("graph", ["fused", "decomposed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onnx_model_matches_reference(graph, dtype):
    params = pbert.init_bert_params(CFG, seed=6)
    data = fused_bert_onnx(CFG, params) if graph == "fused" else \
        pbert.export_bert_onnx(CFG, params=params, opset=13)
    ids, mask = bert_rows(11, 24, CFG.vocab, seed=7)
    kw = dict(feed_dict={"input_ids": "ids", "attention_mask": "mask"},
              fetch_dict={"hidden": "last_hidden_state"}, mini_batch_size=4,
              compute_dtype=dtype)
    want = np.asarray(JONNXModel(data, **kw).transform(
        JDataFrame({"ids": ids, "mask": mask}))["hidden"], np.float32)
    before = flash_attention.launches
    m = ONNXModel(data, device="cpu", **kw)
    got = m.transform(DataFrame({"ids": ids, "mask": mask}))["hidden"]
    assert flash_attention.launches == before      # no launch on the CPU
    assert got.dtype == np.float32 and got.shape == (11, 24, CFG.d_model)
    if dtype == "float32":
        _f32_close(got, want)
    else:
        assert float(np.abs(got - want).max()) <= \
            2 ** -5 * float(np.abs(want).max())


def test_warm_up_over_the_dynamic_sequence_axis():
    data = fused_bert_onnx(CFG, pbert.init_bert_params(CFG, seed=8))
    kw = dict(feed_dict={"input_ids": "ids", "attention_mask": "mask"},
              mini_batch_size=4)
    specs = {"input_ids": (np.int64, (24,)),
             "attention_mask": (np.int64, (24,))}
    for model in (JONNXModel(data, **kw),
                  ONNXModel(data, device="cpu", **kw)):
        with pytest.raises(ValueError, match="symbolic"):
            model.warm_up()
        stats = model.warm_up(batch_sizes=[3, 4], input_specs=specs)
        assert stats["buckets"] == [4]
    assert stats["compiles"] == 1           # the port runs each bucket once


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_integer_columns_reach_the_graph_as_integers(dtype):
    """Ids above bfloat16's exact-integer range (256) come through
    ``compute_dtype`` unchanged: only float inputs are cast."""
    g = O.make_graph([O.make_node("Cast", ["ids"], ["y"], to=1)], "t",
                     [O.make_tensor_value_info("ids", np.int64,
                                               ("batch", "seq"))],
                     [O.make_tensor_value_info("y", np.float32, [])])
    data = O.make_model(g)
    ids = np.array([[30001, 257, 1], [29999, 30521, 0]], np.int64)
    kw = dict(feed_dict={"ids": "ids"}, fetch_dict={"y": "y"},
              mini_batch_size=2, compute_dtype=dtype)
    got = ONNXModel(data, device="cpu", **kw).transform(
        DataFrame({"ids": ids}))["y"]
    want = JONNXModel(data, **kw).transform(JDataFrame({"ids": ids}))["y"]
    np.testing.assert_array_equal(got, ids.astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
