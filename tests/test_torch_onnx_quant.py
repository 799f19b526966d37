"""The port's quantized ONNX path against the JAX package on the CPU.

* The eight quantized handlers (``QuantizeLinear``, ``DequantizeLinear``,
  ``QLinearConv``, ``QLinearMatMul``, ``QGemm``, ``QLinearAdd``,
  ``QLinearMul``, ``QLinearGlobalAveragePool``) on
  ``tests/test_onnx_quant_detect.py``'s cases (the mixed uint8-activation
  / int8-weight ``QLinearConv`` and the per-channel ``w_scale`` among
  them) and a few more, through both converters. Output codes are bitwise
  the JAX converter's: this file allows no code to differ (the JAX test's
  own off-by-one at requantization ties, ``:81``, is against a float
  reference, not between the converters). Float outputs (``QGemm``
  without ``y_scale``, ``DequantizeLinear``) are bitwise too: both sides
  accumulate exactly and then run the same float32 operations in the
  same order. Each case also keeps the JAX test's check against its
  float reference.
* A QLinear-quantized ResNet in onnxruntime's QOperator layout
  (``chip_smoke.qoperator_resnet_onnx``) built from the port ResNet
  tests' tiny config, calibrated on 4 seeded images in float32: every
  ``QLinearConv`` output of both converters bitwise, the ``QGemm`` logits
  bitwise (the stated bound, 1e-6 · max|logit|, is not needed), and the
  logits within 0.1 · max|logit| of the float graph's.
* ``ONNXModel(quantize="int8")`` against the JAX ``ONNXModel(quantize=
  "int8")`` on ``tests/test_onnx_weight_quant.py``'s MLP, in float32 and
  bfloat16: the packed codes and scales bitwise, the outputs within
  1e-5 · max|ref| + 1e-6 (float32; the dequantized weights are bitwise, so
  only the matmul's sum order differs) and 2^-7 · max|ref| (bfloat16, a
  couple of bf16 roundings), and each package's int8 outputs within that
  file's own bound of its full-precision ones (0.05 · max|full|); the
  toggling and save/load cases. That file's ``weights_override`` case
  (ported with ROADMAP queue item 23) is held against the JAX
  ``ONNXModel`` in ``tests/test_torch_onnx_model.py``.
* The ORT-fused BERT (``chip_smoke.fused_bert_onnx``, the graph phase 18b
  runs at BERT-base's widths) at a small width with ``quantize="int8"``:
  the port's hidden states within 1e-5 · max|ref| + 1e-6 of the JAX
  ``ONNXModel``'s, and within 2^-4 of the largest |hidden| of the
  unquantized run (here 0.0057 of it), the bound phase 18b holds the card
  to at BERT-base's widths.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mmlspark_tpu.onnx as J
import mmlspark_tpu.onnx.convert as jconv
import mmlspark_tpu_torch.onnx as O
import mmlspark_tpu_torch.onnx.convert as pconv
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.models.onnx_model import ONNXModel as JONNXModel
from mmlspark_tpu.onnx.convert import UnsupportedOp as JaxUnsupported
from mmlspark_tpu_torch.core import DataFrame, PipelineStage
from mmlspark_tpu_torch.models.onnx_model import ONNXModel
from mmlspark_tpu_torch.models.zoo.resnet import (ResNetConfig,
                                                  export_resnet_onnx)
from mmlspark_tpu_torch.onnx.convert import UnsupportedOp
from mmlspark_tpu_torch.onnx.proto import parse_model

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import (bert_rows, float_activations,  # noqa: E402
                        fused_bert_onnx, qlinear_conv_outputs,
                        qoperator_resnet_onnx)

MS = {"domain": "com.microsoft"}


def _model(nodes, feeds, inits, outs=("y",)):
    g = O.make_graph(
        nodes, "t",
        [O.make_tensor_value_info(k, v.dtype, list(v.shape))
         for k, v in feeds.items()],
        [O.make_tensor_value_info(o, np.float32, []) for o in outs],
        initializers=inits)
    return O.make_model(g, extra_opsets={"com.microsoft": 1})


def _both(nodes, feeds, inits, outs=("y",)):
    """Both converters on one graph; every output bitwise. Returns the
    port's outputs."""
    data = _model(nodes, feeds, inits, outs)
    pm, jm = O.convert_model(data), J.convert_model(data)
    got = pm({k: torch.from_numpy(v) for k, v in pm.params.items()},
             {k: torch.from_numpy(v.copy()) for k, v in feeds.items()})
    want = jm(jm.params, {k: jnp.asarray(v) for k, v in feeds.items()})
    out = {}
    for o in outs:
        g, w = got[o].numpy(), np.asarray(want[o])
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (o, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=o)
        out[o] = g
    return out


def _quant(x, scale, zp, dtype):
    info = np.iinfo(dtype)
    return np.clip(np.round(x / scale) + zp, info.min, info.max).astype(dtype)


def _vi(name, dtype, shape):
    return O.make_tensor_value_info(name, dtype, shape)


# ---------------------------------------------------------------------------
# the quantized handlers: tests/test_onnx_quant_detect.py's TestQLinearOps

def test_qlinear_matmul(rng):
    a_f = rng.normal(0, 1, (4, 8)).astype(np.float32)
    b_f = rng.normal(0, 1, (8, 6)).astype(np.float32)
    a_s, b_s, y_s = 0.02, 0.015, 0.05
    a_q = _quant(a_f, a_s, 3, np.uint8)
    b_q = _quant(b_f, b_s, 0, np.int8)
    inits = {"as_": np.float32(a_s), "azp": np.uint8(3), "b": b_q,
             "bs": np.float32(b_s), "bzp": np.int8(0),
             "ys": np.float32(y_s), "yzp": np.int8(0)}
    got = _both([O.make_node("QLinearMatMul", ["a", "as_", "azp", "b", "bs",
                                               "bzp", "ys", "yzp"], ["y"])],
                {"a": a_q}, inits)["y"]
    acc = (a_q.astype(np.int32) - 3) @ b_q.astype(np.int32)
    want = np.clip(np.round(acc * (a_s * b_s / y_s)), -128, 127)
    np.testing.assert_array_equal(got, want.astype(np.int8))


def _conv_reference(x_q, x_zp, x_s, w_q, w_s, bias, y_s, y_zp, lo, hi,
                    padding=0):
    import torch.nn.functional as F
    xd = (x_q.astype(np.float32) - x_zp) * x_s
    wd = w_q.astype(np.float32) * np.reshape(w_s, (-1, 1, 1, 1))
    b = None if bias is None else torch.from_numpy(
        (bias.astype(np.float32) * x_s * w_s).astype(np.float32))
    ref = F.conv2d(torch.from_numpy(xd), torch.from_numpy(wd), bias=b,
                   padding=padding).numpy()
    return np.clip(np.round(ref / y_s) + y_zp, lo, hi)


def test_qlinear_conv_per_channel_scale_and_bias(rng):
    x_f = rng.normal(0, 1, (1, 3, 8, 8)).astype(np.float32)
    w_f = rng.normal(0, 0.3, (4, 3, 3, 3)).astype(np.float32)
    x_s, y_s = 0.03, 0.1
    w_s = np.asarray([0.01, 0.02, 0.015, 0.025], np.float32)
    x_q = _quant(x_f, x_s, 128, np.uint8)
    w_q = np.stack([_quant(w_f[i], w_s[i], 0, np.int8) for i in range(4)])
    bias = rng.integers(-50, 50, (4,)).astype(np.int32)
    inits = {"xs": np.float32(x_s), "xzp": np.uint8(128), "w": w_q,
             "ws": w_s, "wzp": np.int8(0), "ys": np.float32(y_s),
             "yzp": np.uint8(120), "b": bias}
    got = _both([O.make_node("QLinearConv", ["x", "xs", "xzp", "w", "ws",
                                             "wzp", "ys", "yzp", "b"],
                             ["y"], pads=[1, 1, 1, 1])],
                {"x": x_q}, inits)["y"]
    want = _conv_reference(x_q, 128, x_s, w_q, w_s, bias, y_s, 120, 0, 255,
                           padding=1)
    # the JAX test's bound against its float reference: one code at ties
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_qlinear_conv_mixed_uint8_int8_zero_points(rng):
    """uint8 activations + int8 weights, both zero points 0 (onnxruntime's
    post-ReLU layout): the reference widens to int32, the port to
    float64."""
    x_q = rng.integers(0, 255, (1, 2, 5, 5)).astype(np.uint8)
    w_q = rng.integers(-127, 127, (3, 2, 3, 3)).astype(np.int8)
    inits = {"xs": np.float32(0.02), "xzp": np.uint8(0), "w": w_q,
             "ws": np.float32(0.01), "wzp": np.int8(0),
             "ys": np.float32(0.7), "yzp": np.uint8(0)}
    got = _both([O.make_node("QLinearConv", ["x", "xs", "xzp", "w", "ws",
                                             "wzp", "ys", "yzp"], ["y"])],
                {"x": x_q}, inits)["y"]
    want = _conv_reference(x_q, 0, 0.02, w_q, np.float32(0.01), None, 0.7,
                           0, 0, 255)
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_qlinear_conv_strided_grouped_int8_activations(rng):
    """Signed activations with a nonzero zero point, stride 2, groups 2,
    asymmetric pads: the accumulation's exactness, not just its sign."""
    x_q = rng.integers(-128, 128, (2, 4, 9, 9)).astype(np.int8)
    w_q = rng.integers(-127, 128, (6, 2, 3, 3)).astype(np.int8)
    inits = {"xs": np.float32(0.05), "xzp": np.int8(-7), "w": w_q,
             "ws": rng.uniform(0.001, 0.01, 6).astype(np.float32),
             "wzp": np.int8(0), "ys": np.float32(0.3), "yzp": np.int8(4),
             "b": rng.integers(-500, 500, 6).astype(np.int32)}
    _both([O.make_node("QLinearConv", ["x", "xs", "xzp", "w", "ws", "wzp",
                                       "ys", "yzp", "b"], ["y"],
                       strides=[2, 2], group=2, pads=[0, 1, 2, 0])],
          {"x": x_q}, inits)


def test_qlinear_conv_per_channel_zero_point_refused(rng):
    inits = {"xs": np.float32(0.02), "xzp": np.uint8(0),
             "w": np.zeros((2, 1, 1, 1), np.int8), "ws": np.float32(0.01),
             "wzp": np.array([0, 1], np.int8), "ys": np.float32(0.7),
             "yzp": np.uint8(0)}
    data = _model([O.make_node("QLinearConv", ["x", "xs", "xzp", "w", "ws",
                                               "wzp", "ys", "yzp"], ["y"])],
                  {"x": np.zeros((1, 1, 2, 2), np.uint8)}, inits)
    x = np.zeros((1, 1, 2, 2), np.uint8)
    jm, pm = J.convert_model(data), O.convert_model(data)
    with pytest.raises(JaxUnsupported, match="per-channel"):
        jm(jm.params, {"x": jnp.asarray(x)})
    with pytest.raises(UnsupportedOp, match="per-channel"):
        pm(pm.params, {"x": torch.from_numpy(x)})


@pytest.mark.parametrize("case", ["float-out", "quantized-out"])
def test_qgemm(rng, case):
    a_f = rng.normal(0, 1, (3, 5)).astype(np.float32)
    b_f = rng.normal(0, 1, (4, 5)).astype(np.float32)   # transB form
    a_s, b_s = 0.02, 0.03
    a_q = _quant(a_f, a_s, 0, np.int8)
    b_q = _quant(b_f, b_s, 0, np.int8)
    inits = {"as_": np.float32(a_s), "azp": np.int8(0), "b": b_q,
             "bs": np.float32(b_s), "bzp": np.int8(0)}
    ins = ["a", "as_", "azp", "b", "bs", "bzp"]
    if case == "quantized-out":
        inits.update({"c": rng.integers(-99, 99, 4).astype(np.int32),
                      "ys": np.float32(0.04), "yzp": np.uint8(128)})
        ins += ["c", "ys", "yzp"]
    got = _both([O.make_node("QGemm", ins, ["y"], alpha=2.0, transB=1,
                             **MS)], {"a": a_q}, inits)["y"]
    acc = a_q.astype(np.int32) @ b_q.astype(np.int32).T
    if case == "float-out":
        np.testing.assert_allclose(got, 2.0 * a_s * b_s * acc, rtol=1e-6)
    else:
        want = np.clip(np.round((acc + inits["c"]) * (2.0 * a_s * b_s / 0.04))
                       + 128, 0, 255)
        assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("op", ["QLinearAdd", "QLinearMul"])
def test_qlinear_eltwise(rng, op):
    a_q = _quant(rng.normal(0, 1, (2, 8)).astype(np.float32), 0.05, 10,
                 np.int8)
    b_q = _quant(rng.normal(0, 1, (2, 8)).astype(np.float32), 0.04, -5,
                 np.int8)
    inits = {"as_": np.float32(0.05), "azp": np.int8(10), "b": b_q,
             "bs": np.float32(0.04), "bzp": np.int8(-5),
             "ys": np.float32(0.08), "yzp": np.int8(0)}
    got = _both([O.make_node(op, ["a", "as_", "azp", "b", "bs", "bzp", "ys",
                                  "yzp"], ["y"], **MS)], {"a": a_q},
                inits)["y"]
    ad = (a_q.astype(np.float32) - 10) * 0.05
    bd = (b_q.astype(np.float32) + 5) * 0.04
    f = ad + bd if op == "QLinearAdd" else ad * bd
    want = np.clip(np.round(f / 0.08), -128, 127)
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_qlinear_global_average_pool(rng):
    x_q = _quant(rng.normal(0, 1, (2, 3, 5, 5)).astype(np.float32), 0.1, 20,
                 np.uint8)
    inits = {"xs": np.float32(0.1), "xzp": np.uint8(20),
             "ys": np.float32(0.12), "yzp": np.uint8(15)}
    got = _both([O.make_node("QLinearGlobalAveragePool",
                             ["x", "xs", "xzp", "ys", "yzp"], ["y"], **MS)],
                {"x": x_q}, inits)["y"]
    mean = (x_q.astype(np.float32) - 20).mean(axis=(2, 3),
                                              keepdims=True) * 0.1
    want = np.clip(np.round(mean / 0.12) + 15, 0, 255)
    assert got.shape == (2, 3, 1, 1)
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_qlinear_global_average_pool_channels_last_refused():
    inits = {"xs": np.float32(0.1), "xzp": np.uint8(0),
             "ys": np.float32(0.1), "yzp": np.uint8(0)}
    data = _model([O.make_node("QLinearGlobalAveragePool",
                               ["x", "xs", "xzp", "ys", "yzp"], ["y"],
                               channels_last=1, **MS)],
                  {"x": np.zeros((1, 2, 2, 1), np.uint8)}, inits)
    x = np.zeros((1, 2, 2, 1), np.uint8)
    with pytest.raises(JaxUnsupported, match="channels_last"):
        J.convert_model(data)({}, {"x": jnp.asarray(x)})
    with pytest.raises(UnsupportedOp, match="channels_last"):
        O.convert_model(data)({}, {"x": torch.from_numpy(x)})


def test_quantized_mlp_end_to_end(rng):
    """Q/DQ boundary + two QLinear layers: the pattern onnxruntime's static
    quantizer emits, through one graph."""
    x = rng.normal(0, 1, (4, 16)).astype(np.float32)
    w1 = _quant(rng.normal(0, 0.5, (16, 32)).astype(np.float32), 0.01, 0,
                np.int8)
    w2 = _quant(rng.normal(0, 0.5, (32, 8)).astype(np.float32), 0.01, 0,
                np.int8)
    inits = {"xs": np.float32(0.02), "xzp": np.int8(0),
             "w1": w1, "w1s": np.float32(0.01), "w1zp": np.int8(0),
             "h1s": np.float32(0.12), "h1zp": np.int8(0),
             "w2": w2, "w2s": np.float32(0.01), "w2zp": np.int8(0),
             "h2s": np.float32(0.12), "h2zp": np.int8(0)}
    nodes = [
        O.make_node("QuantizeLinear", ["x", "xs", "xzp"], ["xq"]),
        O.make_node("QLinearMatMul", ["xq", "xs", "xzp", "w1", "w1s", "w1zp",
                                      "h1s", "h1zp"], ["h1"]),
        O.make_node("QLinearMatMul", ["h1", "h1s", "h1zp", "w2", "w2s",
                                      "w2zp", "h2s", "h2zp"], ["h2"]),
        O.make_node("DequantizeLinear", ["h2", "h2s", "h2zp"], ["y"])]
    got = _both(nodes, {"x": x}, inits, outs=("xq", "h1", "h2", "y"))
    want = (x @ (w1.astype(np.float32) * 0.01)) @ (w2.astype(np.float32)
                                                   * 0.01)
    assert got["y"].shape == (4, 8) and np.abs(got["y"] - want).max() < 0.5


def test_quantize_linear_departures_from_the_spec(rng):
    """As in the reference: without a zero point the codes are int8 (ONNX
    says uint8), and ``axis`` is not read, so a per-channel (1-D) scale
    and zero point broadcast against the LAST axis (ROADMAP.md section 3)."""
    x = rng.normal(0, 2, (3, 4)).astype(np.float32)
    got = _both([O.make_node("QuantizeLinear", ["x", "s"], ["y"])], {"x": x},
                {"s": np.float32(0.05)})["y"]
    assert got.dtype == np.int8 and got.min() < 0
    s = np.array([0.01, 0.02, 0.05, 0.1], np.float32)
    zp = np.array([0, 10, 100, 200], np.uint8)
    q = _both([O.make_node("QuantizeLinear", ["x", "s", "zp"], ["y"],
                           axis=0)], {"x": x}, {"s": s, "zp": zp})["y"]
    np.testing.assert_array_equal(q, _quant(x, s, zp.astype(np.int32),
                                            np.uint8))
    d = _both([O.make_node("DequantizeLinear", ["x", "s", "zp"], ["y"],
                           axis=0)], {"x": q}, {"s": s, "zp": zp})["y"]
    np.testing.assert_array_equal(
        d, (q.astype(np.float32) - zp.astype(np.float32)) * s)


# ---------------------------------------------------------------------------
# the QOperator ResNet

def _tiny_resnet():
    return export_resnet_onnx(ResNetConfig([1, 1], num_classes=7, width=8),
                              seed=0, input_size=32)


def _images(n, seed):
    return np.random.default_rng(seed).normal(0, 1, (n, 3, 32, 32)) \
        .astype(np.float32)


def test_qoperator_resnet_codes_and_logits_bitwise():
    fb = _tiny_resnet()
    qb = qoperator_resnet_onnx(fb, torch.from_numpy(_images(4, 40)))
    ops = [n.op_type for n in parse_model(qb).graph.nodes]
    assert ops.count("QLinearConv") == 9 and ops.count("QLinearAdd") == 2
    assert ops.count("QGemm") == 1 and "Conv" not in ops and "Relu" not in ops
    x = _images(6, 41)
    pm, jm = O.convert_model(qb), J.convert_model(qb)
    penv = dict(pm.const_params)
    penv.update({k: torch.from_numpy(v) for k, v in pm.params.items()})
    penv.update({"input": torch.from_numpy(x), "": None})
    pconv._eval_nodes(pm.model.graph.nodes, penv,
                      pconv._Ctx(pm.model.opset, torch.device("cpu")))
    jenv = {**jm.const_params, **jm.params, "input": jnp.asarray(x),
            "": None}
    jconv._eval_nodes(jm.model.graph.nodes, jenv, jconv._Ctx(jm.model.opset))
    convs = qlinear_conv_outputs(qb)
    assert len(convs) == 9
    for name in convs:
        got, want = penv[name].numpy(), np.asarray(jenv[name])
        assert got.dtype == want.dtype and got.dtype in (np.uint8, np.int8)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert len(np.unique(got)) > 16, name      # the codes are used
    logits, want = penv["logits"].numpy(), np.asarray(jenv["logits"])
    np.testing.assert_array_equal(logits, want)
    # the quantized network computes the float one's function
    ref = float_activations(fb, torch.from_numpy(x))["logits"]
    assert np.abs(logits - ref).max() <= 0.1 * np.abs(ref).max()
    # and through ONNXModel (8-bit weights placed with the float params)
    m = ONNXModel(qb, device="cpu", mini_batch_size=4)
    out = m.transform(DataFrame({"input": list(x)}))["logits"]
    np.testing.assert_array_equal(np.stack(out), logits)
    params = m._params_for_device(torch.device("cpu"))
    assert params["w1_q"].dtype == torch.int8
    assert params["w1_s"].dtype == torch.float32


# ---------------------------------------------------------------------------
# ONNXModel(quantize="int8"): tests/test_onnx_weight_quant.py's MLP

def _mlp_bytes(din=16, dhid=64, dout=8, seed=0):
    rng = np.random.default_rng(seed)
    w1 = rng.normal(0, 0.5, (din, dhid)).astype(np.float32)
    b1 = rng.normal(0, 0.1, dhid).astype(np.float32)
    w2 = rng.normal(0, 0.5, (dhid, dout)).astype(np.float32)
    nodes = [O.make_node("MatMul", ["x", "w1"], ["h0"]),
             O.make_node("Add", ["h0", "b1"], ["h1"]),
             O.make_node("Relu", ["h1"], ["h2"]),
             O.make_node("MatMul", ["h2", "w2"], ["logits"])]
    g = O.make_graph(nodes, "mlp", [_vi("x", np.float32, ["N", din])],
                     [_vi("logits", np.float32, ["N", dout])],
                     initializers={"w1": w1, "b1": b1, "w2": w2})
    return O.make_model(g)


def _rows(n=32, din=16, seed=1):
    X = np.random.default_rng(seed).normal(0, 1, (n, din)).astype(np.float32)
    col = np.empty(n, dtype=object)
    col[:] = list(X)
    return col


KW = dict(feed_dict={"x": "x"}, fetch_dict={"logits": "logits"})


def _logits(out):
    return np.stack([np.asarray(v, np.float32) for v in out["logits"]])


def _both_models(dtype, quantize="int8"):
    j = JONNXModel(_mlp_bytes(), quantize=quantize, compute_dtype=dtype, **KW)
    p = ONNXModel(_mlp_bytes(), device="cpu", quantize=quantize,
                  compute_dtype=dtype, **KW)
    col = _rows()
    return (j, _logits(j.transform(JDataFrame({"x": col}))),
            p, _logits(p.transform(DataFrame({"x": col}))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onnx_model_int8_packs_and_outputs_as_the_reference(dtype):
    j, jout, p, pout = _both_models(dtype)
    jpacked = next(iter(j._device_params.values()))
    ppacked = next(iter(p._device_params.values()))
    assert sorted(jpacked) == sorted(ppacked) == ["b1", "w1", "w2"]
    q, s = ppacked["w1"]["q"], ppacked["w1"]["s"]
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jpacked["w1"]["q"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jpacked["w1"]["s"]))
    # the 1-D bias and w2 (64 x 8: a side under 16) stay in compute_dtype
    for k in ("b1", "w2"):
        assert not isinstance(ppacked[k], dict) and \
            not isinstance(jpacked[k], dict)
        assert str(ppacked[k].dtype) == f"torch.{dtype}"
    tol = (1e-5 * np.abs(jout).max() + 1e-6) if dtype == "float32" else \
        2 ** -7 * np.abs(jout).max()
    assert np.abs(pout - jout).max() <= tol
    # each package's int8 run within that file's bound of its full run
    _, jfull, _, pfull = _both_models(dtype, quantize="")
    for full, q in ((jfull, jout), (pfull, pout)):
        assert np.abs(full - q).max() < 0.05 * np.abs(full).max()
        assert (full.argmax(1) == q.argmax(1)).mean() > 0.9


def test_onnx_model_toggling_quantize_takes_effect():
    # set(quantize=...) after a transform invalidates the cached params in
    # BOTH directions
    df = DataFrame({"x": _rows(8)})
    m = ONNXModel(_mlp_bytes(), device="cpu", **KW)
    full = _logits(m.transform(df))
    m.set(quantize="int8")
    q = _logits(m.transform(df))
    assert isinstance(next(iter(m._device_params.values()))["w1"], dict)
    m.set(quantize="")
    again = _logits(m.transform(df))
    assert not isinstance(next(iter(m._device_params.values()))["w1"], dict)
    np.testing.assert_array_equal(again, full)
    assert np.abs(q - full).max() > 0


def test_onnx_model_int8_save_load_roundtrip(tmp_path):
    df = DataFrame({"x": _rows(8)})
    m = ONNXModel(_mlp_bytes(), device="cpu", quantize="int8", **KW)
    a = _logits(m.transform(df))
    m.save(str(tmp_path / "m"))
    loaded = ONNXModel.load(str(tmp_path / "m"), device="cpu")
    assert loaded.quantize == "int8"
    np.testing.assert_array_equal(_logits(loaded.transform(df)), a)
    generic = PipelineStage.load(str(tmp_path / "m"))
    assert generic.quantize == "int8"


def test_onnx_model_int8_fused_bert():
    from mmlspark_tpu_torch.models.zoo.bert_onnx import (BertOnnxConfig,
                                                         init_bert_params)
    cfg = BertOnnxConfig(vocab=97, layers=2, d_model=48, heads=4, d_ff=96,
                         max_len=32)
    data = fused_bert_onnx(cfg, init_bert_params(cfg, seed=3))
    ids, mask = bert_rows(6, 32, cfg.vocab, seed=4)
    kw = dict(feed_dict={"input_ids": "input_ids",
                         "attention_mask": "attention_mask"},
              fetch_dict={"hidden": "last_hidden_state"}, mini_batch_size=4)
    frame = {"input_ids": ids, "attention_mask": mask}
    hidden = {}
    for quantize in ("", "int8"):
        m = ONNXModel(data, device="cpu", quantize=quantize, **kw)
        hidden[quantize] = np.asarray(m.transform(DataFrame(frame))["hidden"])
    packed = next(iter(m._device_params.values()))
    assert isinstance(packed["embed.word"], dict)
    assert isinstance(packed["l0.ff1.w"], dict)
    j = JONNXModel(data, quantize="int8", **kw)
    want = np.asarray(j.transform(JDataFrame(frame))["hidden"])
    got = hidden["int8"]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + 1e-6
    ref = np.abs(hidden[""]).max()
    assert np.abs(got - hidden[""]).max() <= 2.0 ** -4 * ref
