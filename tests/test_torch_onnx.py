"""The port's ONNX parser and converter (``mmlspark_tpu_torch/onnx/``)
against the JAX package on the CPU.

* The same model bytes parse to equal graphs in both packages (node names
  excluded: the builder derives them from object ids), with initializers
  bitwise equal; both builders write graphs that parse equal.
* Each ported handler, as a one-node graph on seeded numpy inputs, runs
  through both converters (the JAX side eagerly on the CPU, as
  ``tests/test_onnx.py`` runs it). Data movement, integer and comparison
  ops are held exact. Elementwise float math is held to ``ELEM`` (rtol
  1e-6, atol 1e-7: the two libraries' transcendental functions differ by
  an ulp or so). Conv, Gemm, MatMul, the pools and the normalizations sum
  in different orders: ``SUM`` (rtol 1e-5, atol 1e-5, inputs of unit
  scale).
* Operand promotion follows the reference: a 0-d float32 constant meeting
  a bfloat16 activation gives float32 in both packages.
* An unported op raises ``UnsupportedOp``; a shape computed from a
  device tensor is refused rather than read back; ``pruned`` drops dead
  nodes and inputs as the reference does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mmlspark_tpu.onnx as J
import mmlspark_tpu_torch.onnx as O
from mmlspark_tpu.onnx import proto as jproto
from mmlspark_tpu_torch.onnx import proto as pproto
from mmlspark_tpu_torch.onnx.convert import UnsupportedOp

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

EXACT = dict(rtol=0, atol=0)
ELEM = dict(rtol=1e-6, atol=1e-7)
SUM = dict(rtol=1e-5, atol=1e-5)


def _graph(builder, nodes, feeds, inits, outs):
    return builder.make_graph(
        nodes, "t",
        [builder.make_tensor_value_info(k, np.asarray(v).dtype
                                        if np.asarray(v).dtype != object
                                        else np.float32, list(np.shape(v)))
         for k, v in feeds.items()],
        [builder.make_tensor_value_info(o, np.float32, []) for o in outs],
        initializers=inits)


def _run_both(nodes, feeds, inits=None, outs=("y",), opset=17,
              jax_feeds=None, port_feeds=None):
    data = O.make_model(_graph(O, nodes, feeds, inits or {}, outs),
                        opset=opset)
    jm, pm = J.convert_model(data), O.convert_model(data)
    # feeds enter the JAX converter as jax arrays (as under ONNXModel's
    # jit), so no node of theirs takes the host table
    jout = jm(jm.params, jax_feeds or {k: jnp.asarray(v)
                                       for k, v in feeds.items()})
    pout = pm(pm.params, port_feeds or {k: torch.from_numpy(np.asarray(v))
                                       for k, v in feeds.items()})
    return ([np.asarray(jout[o]) for o in outs],
            [pout[o] for o in outs])


def _same(want, got, tol):
    got_np = got.float().numpy() if got.dtype == torch.bfloat16 \
        else got.numpy()
    assert want.shape == got_np.shape, (want.shape, got_np.shape)
    # JAX runs with 64-bit types off: int64 comes back as int32
    assert want.dtype.kind == got_np.dtype.kind, (want.dtype, got_np.dtype)
    if want.dtype.kind == "f":
        assert str(want.dtype) == str(got.dtype).replace("torch.", "")
        np.testing.assert_allclose(got_np, want.astype(np.float32), **tol)
    else:
        np.testing.assert_array_equal(got_np, want)


# ---------------------------------------------------------------------------
# the parser and the builder


def _mlp_bytes(builder, seed=0):
    rng = np.random.default_rng(seed)
    inits = {"w1": rng.normal(0, 0.5, (8, 16)).astype(np.float32),
             "b1": rng.normal(0, 0.1, 16).astype(np.float32),
             "shape": np.array([0, -1], np.int64),
             "half": np.array(0.5, np.float32)}
    nodes = [builder.make_node("MatMul", ["x", "w1"], ["h0"]),
             builder.make_node("Add", ["h0", "b1"], ["h1"]),
             builder.make_node("Relu", ["h1"], ["h2"]),
             builder.make_node("Reshape", ["h2", "shape"], ["h3"]),
             builder.make_node("Mul", ["h3", "half"], ["h4"]),
             builder.make_node("Softmax", ["h4"], ["y"], axis=-1),
             builder.make_node("Conv", ["h4", "w1"], ["unused"],
                               pads=[1, 1, 1, 1], strides=[2, 2],
                               auto_pad="NOTSET", alpha=0.25)]
    return builder.make_model(_graph(builder, nodes,
                                     {"x": np.zeros((2, 8), np.float32)},
                                     inits, ["y"]))


def _graph_view(m):
    g = m.graph
    return {"opset": m.opset, "producer": m.producer_name,
            "nodes": [(n.op_type, list(n.input), list(n.output),
                       {k: repr(n.attr(k)) for k in sorted(n.attributes)})
                      for n in g.nodes],
            "inputs": [(v.name, v.elem_type, list(v.shape)) for v in g.inputs],
            "outputs": [(v.name, v.elem_type, list(v.shape))
                        for v in g.outputs]}


@pytest.mark.parametrize("which", ["mlp", "resnet"])
def test_same_bytes_parse_to_equal_graphs(which):
    if which == "mlp":
        data = _mlp_bytes(O)
    else:
        from mmlspark_tpu_torch.models.zoo.resnet import (ResNetConfig,
                                                          export_resnet_onnx)
        data = export_resnet_onnx(ResNetConfig([1, 1], num_classes=7,
                                               width=8), seed=0,
                                  input_size=32)
    jm, pm = jproto.parse_model(data), pproto.parse_model(data)
    assert _graph_view(jm) == _graph_view(pm)
    assert len(jm.graph.initializers) == len(pm.graph.initializers)
    for jt, pt in zip(jm.graph.initializers, pm.graph.initializers):
        assert jt.name == pt.name
        a, b = jproto.tensor_to_numpy(jt), pproto.tensor_to_numpy(pt)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert jproto.model_content_digest(data) == \
        pproto.model_content_digest(data)


def test_both_builders_write_graphs_that_parse_equal():
    pb, jb = _mlp_bytes(O), _mlp_bytes(J)
    assert _graph_view(pproto.parse_model(pb)) == \
        _graph_view(pproto.parse_model(jb))
    assert pproto.model_content_digest(pb) == jproto.model_content_digest(jb)


def test_tensor_dtypes_roundtrip_and_bf16_widens():
    for arr in [np.arange(6, dtype=np.int64).reshape(2, 3),
                np.ones((3,), dtype=np.bool_), np.float16([1.5, -2]),
                np.linspace(0, 1, 4, dtype=np.float64)]:
        dec = pproto.tensor_to_numpy(pproto.TensorProto.parse(
            O.make_tensor("t", arr).to_bytes()))
        assert dec.dtype == arr.dtype and np.array_equal(dec, arr)
    bits = np.array([0x3F80, 0xC000, 0x7F80], np.uint16)   # 1, -2, inf
    np.testing.assert_array_equal(pproto._bf16_bits_to_f32(bits),
                                  [1.0, -2.0, np.inf])


# ---------------------------------------------------------------------------
# one-node graphs through both converters

rng = np.random.default_rng(0)
A = rng.normal(0, 1, (3, 4)).astype(np.float32)
B = rng.normal(0, 1, (3, 4)).astype(np.float32)
POS = rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
UNIT = rng.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
IA = rng.integers(-9, 10, (3, 4)).astype(np.int64)
IB = rng.integers(1, 5, (3, 4)).astype(np.int64) * \
    np.where(rng.random((3, 4)) < 0.5, -1, 1)
BA, BB = A > 0, B > 0


def _bin(op, a, b, tol, **attrs):
    return (op, [op, ["a", "b"], ["y"]], {"a": a, "b": b}, {}, attrs, tol)


ELEMENTWISE = [
    _bin("Add", A, B, EXACT), _bin("Sub", A, B, EXACT),
    _bin("Mul", A, B, EXACT), _bin("Div", A, POS, EXACT),
    _bin("Div", IA, IB, EXACT), _bin("Pow", POS, A, ELEM),
    _bin("Mod", IA, IB, EXACT), _bin("Mod", IA, IB, EXACT, fmod=1),
    _bin("Mod", A, POS, ELEM, fmod=1), _bin("Min", A, B, EXACT),
    _bin("Max", A, B, EXACT), _bin("And", BA, BB, EXACT),
    _bin("Or", BA, BB, EXACT), _bin("Xor", BA, BB, EXACT),
    _bin("Equal", IA, IB, EXACT), _bin("Greater", A, B, EXACT),
    _bin("GreaterOrEqual", IA, IB, EXACT), _bin("Less", A, B, EXACT),
    _bin("LessOrEqual", A, B, EXACT),
    ("Sum", ["Sum", ["a", "b", "c"], ["y"]], {"a": A, "b": B, "c": POS}, {},
     {}, EXACT),
    ("Mean", ["Mean", ["a", "b", "c"], ["y"]], {"a": A, "b": B, "c": POS},
     {}, {}, ELEM),
    ("Add-int-float", ["Add", ["a", "b"], ["y"]], {"a": IA, "b": A}, {}, {},
     EXACT),
]

UNARY_INPUT = {"Log": POS, "Sqrt": POS, "Acosh": POS + 1, "Asin": UNIT,
               "Acos": UNIT, "Atanh": UNIT, "Not": BA, "Reciprocal": POS}
UNARY = [(op, [op, ["a"], ["y"]], {"a": UNARY_INPUT.get(op, A)}, {}, {},
          EXACT if op in ("Abs", "Neg", "Floor", "Ceil", "Round", "Sign",
                          "Not", "Identity", "Relu", "IsNaN") else ELEM)
         for op in ["Abs", "Neg", "Exp", "Log", "Sqrt", "Floor", "Ceil",
                    "Round", "Sign", "Tanh", "Sin", "Cos", "Tan", "Asin",
                    "Acos", "Atan", "Sinh", "Cosh", "Asinh", "Acosh",
                    "Atanh", "Not", "Erf", "Reciprocal", "Identity", "Relu",
                    "Sigmoid", "Softsign", "IsNaN", "Mish"]]
UNARY.append(("Round-half-even", ["Round", ["a"], ["y"]],
              {"a": np.float32([0.5, 1.5, 2.5, -0.5, -2.5])}, {}, {}, EXACT))
UNARY.append(("Floor-int", ["Floor", ["a"], ["y"]], {"a": IA}, {}, {}, EXACT))

INF = np.float32([1.0, np.inf, -np.inf, np.nan, 0.0])
MISC = [
    ("IsInf", ["IsInf", ["a"], ["y"]], {"a": INF}, {}, {}, EXACT),
    ("IsInf-neg", ["IsInf", ["a"], ["y"]], {"a": INF}, {},
     {"detect_positive": 0}, EXACT),
    ("Clip-inputs", ["Clip", ["a", "lo", "hi"], ["y"]], {"a": A},
     {"lo": np.float32(-0.5), "hi": np.float32(0.7)}, {}, EXACT),
    ("Clip-min-only", ["Clip", ["a", "lo"], ["y"]], {"a": A},
     {"lo": np.float32(0.0)}, {}, EXACT),
    ("Clip-none", ["Clip", ["a"], ["y"]], {"a": A}, {}, {}, EXACT),
    ("Dropout", ["Dropout", ["a"], ["y", "mask"]], {"a": A}, {}, {}, EXACT),
    ("Cast-int", ["Cast", ["a"], ["y"]], {"a": A * 5}, {}, {"to": 6}, EXACT),
    ("Cast-float", ["Cast", ["a"], ["y"]], {"a": IA}, {}, {"to": 1}, EXACT),
    ("Cast-bool", ["Cast", ["a"], ["y"]], {"a": IA}, {}, {"to": 9}, EXACT),
    ("Where", ["Where", ["c", "a", "b"], ["y"]], {"c": BA, "a": A, "b": B},
     {}, {}, EXACT),
    ("Where-const", ["Where", ["c", "a", "z"], ["y"]], {"c": BA, "a": A},
     {"z": np.float32(-1)}, {}, EXACT),
]

RNG = np.random.default_rng(1)
X4 = RNG.normal(0, 1, (2, 4, 9, 9)).astype(np.float32)
X3 = RNG.normal(0, 1, (2, 4, 11)).astype(np.float32)
W4 = RNG.normal(0, 0.3, (6, 4, 3, 3)).astype(np.float32)
WG = RNG.normal(0, 0.3, (6, 2, 3, 3)).astype(np.float32)
W3 = RNG.normal(0, 0.3, (5, 4, 3)).astype(np.float32)
BIAS6 = RNG.normal(0, 0.1, 6).astype(np.float32)
MM_A = RNG.normal(0, 1, (2, 5, 7)).astype(np.float32)
MM_B = RNG.normal(0, 1, (7, 3)).astype(np.float32)
GA = RNG.normal(0, 1, (5, 7)).astype(np.float32)
GB = RNG.normal(0, 1, (3, 7)).astype(np.float32)
GC = RNG.normal(0, 1, (3,)).astype(np.float32)


def _conv(name, w, attrs, bias=True, x=X4):
    ins = ["x", "w"] + (["b"] if bias else [])
    inits = {"w": w}
    if bias:
        inits["b"] = BIAS6[:w.shape[0]] if len(BIAS6) >= w.shape[0] \
            else RNG.normal(0, 0.1, w.shape[0]).astype(np.float32)
    return (name, ["Conv", ins, ["y"]], {"x": x}, inits, attrs, SUM)


def _pool(name, op, attrs, x=X4):
    return (name, [op, ["x"], ["y"]], {"x": x}, {}, attrs, SUM)


DENSE = [
    ("MatMul", ["MatMul", ["a", "b"], ["y"]], {"a": MM_A}, {"b": MM_B}, {},
     SUM),
    ("Gemm", ["Gemm", ["a", "b", "c"], ["y"]], {"a": GA}, {"b": GB, "c": GC},
     {"transB": 1, "alpha": 0.5, "beta": 2.0}, SUM),
    ("Gemm-transA", ["Gemm", ["a", "b"], ["y"]], {"a": GA.T.copy()},
     {"b": GB.T.copy()}, {"transA": 1}, SUM),
    _conv("Conv", W4, {"pads": [1, 1, 1, 1], "strides": [2, 2]}),
    _conv("Conv-asym-pads", W4, {"pads": [0, 1, 2, 1]}),
    _conv("Conv-same-upper", W4, {"auto_pad": "SAME_UPPER",
                                   "strides": [2, 2]}),
    _conv("Conv-same-lower", W4, {"auto_pad": "SAME_LOWER",
                                   "strides": [2, 2]}),
    _conv("Conv-dilated-group", WG, {"dilations": [2, 2], "group": 2,
                                     "pads": [2, 2, 2, 2]}),
    _conv("Conv-nobias", W4, {}, bias=False),
    _conv("Conv-1d", W3, {"pads": [1, 0]}, x=X3),
    _pool("MaxPool", "MaxPool", {"kernel_shape": [3, 3], "strides": [2, 2],
                                 "pads": [1, 1, 1, 1]}),
    _pool("MaxPool-ceil", "MaxPool", {"kernel_shape": [2, 2],
                                      "strides": [2, 2], "ceil_mode": 1}),
    _pool("MaxPool-asym-dilated", "MaxPool", {
        "kernel_shape": [2, 3], "dilations": [2, 1], "pads": [0, 2, 1, 0]}),
    _pool("MaxPool-1d", "MaxPool", {"kernel_shape": [3], "strides": [2],
                                    "pads": [1, 1]}, x=X3),
    _pool("AveragePool", "AveragePool", {"kernel_shape": [3, 3],
                                         "strides": [2, 2],
                                         "pads": [1, 1, 1, 1]}),
    _pool("AveragePool-include-pad", "AveragePool", {
        "kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1],
        "count_include_pad": 1}),
    _pool("AveragePool-ceil-asym", "AveragePool", {
        "kernel_shape": [2, 2], "strides": [2, 2], "pads": [0, 1, 1, 0],
        "ceil_mode": 1}),
    _pool("AveragePool-ceil-include-pad", "AveragePool", {
        "kernel_shape": [3, 3], "strides": [2, 2], "ceil_mode": 1,
        "count_include_pad": 1}),
    _pool("GlobalAveragePool", "GlobalAveragePool", {}),
    _pool("GlobalMaxPool", "GlobalMaxPool", {}),
    ("BatchNormalization",
     ["BatchNormalization", ["x", "s", "bi", "m", "v"], ["y"]], {"x": X4},
     {"s": RNG.uniform(0.5, 1.5, 4).astype(np.float32),
      "bi": RNG.normal(0, 0.1, 4).astype(np.float32),
      "m": RNG.normal(0, 0.1, 4).astype(np.float32),
      "v": RNG.uniform(0.5, 1.5, 4).astype(np.float32)},
     {"epsilon": 1e-3}, SUM),
    ("LayerNormalization", ["LayerNormalization", ["x", "s", "bi"], ["y"]],
     {"x": X4}, {"s": RNG.normal(1, 0.1, (9,)).astype(np.float32),
                 "bi": RNG.normal(0, 0.1, (9,)).astype(np.float32)},
     {"axis": -1}, SUM),
    ("Softmax", ["Softmax", ["x"], ["y"]], {"x": X4}, {}, {"axis": 1}, SUM),
    ("LogSoftmax", ["LogSoftmax", ["x"], ["y"]], {"x": X4}, {}, {}, SUM),
]

REDUCE = [(f"{op}-{k}", [op, ["x"] + (["ax"] if ax_in else []), ["y"]],
           {"x": POS}, ({"ax": np.array([1], np.int64)} if ax_in else {}),
           attrs, SUM)
          for op in ["ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin",
                     "ReduceProd", "ReduceL1", "ReduceL2", "ReduceSumSquare",
                     "ReduceLogSumExp"]
          for k, ax_in, attrs in [("all", False, {"keepdims": 0}),
                                  ("axis1", True, {})]]
REDUCE += [("ArgMax", ["ArgMax", ["x"], ["y"]], {"x": X4}, {},
            {"axis": 1}, EXACT),
           ("ArgMin", ["ArgMin", ["x"], ["y"]], {"x": X4}, {},
            {"axis": -1, "keepdims": 0}, EXACT)]

SHAPES = [
    ("Shape", ["Shape", ["x"], ["y"]], {"x": X4}, {}, {"start": 1, "end": -1},
     EXACT),
    ("Size", ["Size", ["x"], ["y"]], {"x": X4}, {}, {}, EXACT),
    ("Reshape", ["Reshape", ["x", "s"], ["y"]], {"x": X4},
     {"s": np.array([0, -1, 9], np.int64)}, {}, EXACT),
    ("Flatten", ["Flatten", ["x"], ["y"]], {"x": X4}, {}, {"axis": 2}, EXACT),
    ("Transpose", ["Transpose", ["x"], ["y"]], {"x": X4}, {},
     {"perm": [0, 2, 3, 1]}, EXACT),
    ("Squeeze", ["Squeeze", ["x", "ax"], ["y"]],
     {"x": X4[:, :1]}, {"ax": np.array([1], np.int64)}, {}, EXACT),
    ("Unsqueeze", ["Unsqueeze", ["x", "ax"], ["y"]], {"x": X3},
     {"ax": np.array([-1, 0], np.int64)}, {}, EXACT),
    ("Concat", ["Concat", ["a", "b"], ["y"]], {"a": A, "b": B}, {},
     {"axis": 1}, EXACT),
    ("Split", ["Split", ["x", "sp"], ["y", "z"]], {"x": X3},
     {"sp": np.array([4, 7], np.int64)}, {"axis": -1}, EXACT),
    ("Split-even", ["Split", ["x"], ["y", "z"]], {"x": X3}, {}, {"axis": 2},
     EXACT),
    ("Slice", ["Slice", ["x", "st", "en", "ax", "sp"], ["y"]], {"x": X4},
     {"st": np.array([1, -1], np.int64), "en": np.array([8, -8], np.int64),
      "ax": np.array([2, 3], np.int64), "sp": np.array([3, -2], np.int64)},
     {}, EXACT),
    ("Slice-to-end", ["Slice", ["x", "st", "en"], ["y"]], {"x": A},
     {"st": np.array([1, 0], np.int64),
      "en": np.array([2 ** 63 - 1, -1], np.int64)}, {}, EXACT),
    ("Slice-reverse", ["Slice", ["x", "st", "en", "ax", "sp"], ["y"]],
     {"x": A}, {"st": np.array([-1], np.int64),
                "en": np.array([-(2 ** 63)], np.int64),
                "ax": np.array([1], np.int64),
                "sp": np.array([-1], np.int64)}, {}, EXACT),
    ("Gather", ["Gather", ["x", "i"], ["y"]], {"x": X4},
     {"i": np.array([[0, -1], [2, 3]], np.int64)}, {"axis": 1}, EXACT),
    ("Gather-scalar", ["Gather", ["x", "i"], ["y"]], {"x": A},
     {"i": np.array(-2, np.int64)}, {}, EXACT),
    ("Gather-fed-indices", ["Gather", ["x", "i"], ["y"]],
     {"x": A, "i": np.array([3, -4, 0], np.int64)}, {}, {"axis": 1}, EXACT),
    ("Expand", ["Expand", ["x", "s"], ["y"]], {"x": A[:, :1]},
     {"s": np.array([2, 1, 5], np.int64)}, {}, EXACT),
    ("Tile", ["Tile", ["x", "r"], ["y"]], {"x": A},
     {"r": np.array([2, 3], np.int64)}, {}, EXACT),
] + [
    (f"Pad-{mode}", ["Pad", ["x", "p", "v"], ["y"]], {"x": X3},
     {"p": np.array([0, 1, 2, 0, 0, 3], np.int64),
      "v": np.float32(0.25)}, {"mode": mode}, EXACT)
    for mode in ["constant", "reflect", "edge", "wrap"]
] + [
    ("Pad-axes", ["Pad", ["x", "p", "", "ax"], ["y"]], {"x": X3},
     {"p": np.array([2, 1], np.int64), "ax": np.array([-1], np.int64)},
     {}, EXACT),
    ("Constant", ["Constant", [], ["y"]], {"x": A}, {},
     {"value": np.arange(5, dtype=np.float32)}, EXACT),
    ("Constant-ints", ["Constant", [], ["y"]], {"x": A}, {},
     {"value_ints": [3, -1, 2]}, EXACT),
    ("ConstantOfShape", ["ConstantOfShape", ["s"], ["y"]], {"x": A},
     {"s": np.array([2, 3], np.int64)}, {"value": np.float32([1.5])}, EXACT),
    ("Range", ["Range", ["a", "b", "c"], ["y"]], {"x": A},
     {"a": np.int64(1), "b": np.int64(11), "c": np.int64(3)}, {}, EXACT),
]

CASES = ELEMENTWISE + UNARY + MISC + DENSE + REDUCE + SHAPES


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_handler_matches_reference(case):
    _, (op, ins, outs), feeds, inits, attrs, tol = case
    node = O.make_node(op, ins, outs, **attrs)
    want, got = _run_both([node], feeds, inits, outs=outs)
    for w, g in zip(want, got):
        _same(w, g, tol)


def test_softmax_before_opset13_flattens_at_axis():
    node = O.make_node("Softmax", ["x"], ["y"], axis=1)
    want, got = _run_both([node], {"x": X4}, opset=11)
    _same(want[0], got[0], SUM)


def test_clip_attribute_bounds_before_opset11():
    node = O.make_node("Clip", ["x"], ["y"], min=-0.25, max=0.5)
    want, got = _run_both([node], {"x": A}, opset=6)
    _same(want[0], got[0], EXACT)


def test_shape_arithmetic_folds_on_the_host():
    """BERT-style y = LayerNorm(Reshape(x, [Shape(x)[0], -1])): the target
    is computed on the host from Shape's numpy output."""
    nodes = [
        O.make_node("Shape", ["x"], ["shp"]),
        O.make_node("Gather", ["shp", "zero"], ["n"], axis=0),
        O.make_node("Unsqueeze", ["n", "zero_axes"], ["n1"]),
        O.make_node("Concat", ["n1", "negone"], ["target"], axis=0),
        O.make_node("Reshape", ["x", "target"], ["flat"]),
        O.make_node("LayerNormalization", ["flat", "scale", "bias"], ["y"],
                    axis=-1, epsilon=1e-5),
    ]
    x = np.random.default_rng(4).normal(0, 1, (5, 3, 4)).astype(np.float32)
    inits = {"zero": np.array(0, np.int64),
             "zero_axes": np.array([0], np.int64),
             "negone": np.array([-1], np.int64),
             "scale": np.ones(12, np.float32), "bias": np.zeros(12, np.float32)}
    want, got = _run_both(nodes, {"x": x}, inits)
    _same(want[0], got[0], SUM)


@pytest.mark.parametrize("case", ["add", "clip", "where", "mul-param"])
def test_bf16_operands_promote_as_the_reference(case):
    """bf16 activation + 0-d float32 constant gives float32 in JAX; the
    port follows it (PyTorch's own rule would keep bf16). A float32
    param of rank 1 promotes the same way in both."""
    x = np.random.default_rng(5).normal(0, 1, (3, 4)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    node, inits = {
        "add": (O.make_node("Add", ["x", "c"], ["y"]),
                {"c": np.float32(2.0)}),
        "clip": (O.make_node("Clip", ["x", "lo", "hi"], ["y"]),
                 {"lo": np.float32(-0.5), "hi": np.float32(0.5)}),
        "where": (O.make_node("Where", ["m", "x", "c"], ["y"]),
                  {"c": np.float32(3.0), "m": np.array([True, False, True,
                                                        False])}),
        "mul-param": (O.make_node("Mul", ["x", "p"], ["y"]),
                      {"p": np.float32([1.5, 2, 3, 4])}),
    }[case]
    want, got = _run_both([node], {"x": x}, inits,
                          jax_feeds={"x": xb}, port_feeds={"x": xt})
    assert str(want[0].dtype) == "float32" and got[0].dtype == torch.float32
    _same(want[0], got[0], EXACT)


def test_bf16_conv_keeps_bf16():
    node = O.make_node("Conv", ["x", "w", "b"], ["y"], pads=[1, 1, 1, 1])
    x = X4.astype(np.float32)
    wb = {"w": torch.from_numpy(W4).to(torch.bfloat16),
          "b": torch.from_numpy(BIAS6).to(torch.bfloat16)}
    data = O.make_model(_graph(O, [node], {"x": x}, {"w": W4, "b": BIAS6},
                               ["y"]))
    jm, pm = J.convert_model(data), O.convert_model(data)
    jout = jm({k: jnp.asarray(v, jnp.bfloat16) for k, v in jm.params.items()},
              {"x": jnp.asarray(x, jnp.bfloat16)})["y"]
    pout = pm(wb, {"x": torch.from_numpy(x).to(torch.bfloat16)})["y"]
    assert pout.dtype == torch.bfloat16 and str(jout.dtype) == "bfloat16"
    # bf16 outputs: each side rounds its f32 sum once (2^-8 relative),
    # the bias add aside
    np.testing.assert_allclose(pout.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_unsupported_op_raises():
    for op in ["FancyNewOp", "NotAnOnnxOp"]:
        data = O.make_model(_graph(O, [O.make_node(op, ["x"], ["y"])],
                                   {"x": A}, {}, ["y"]))
        cm = O.convert_model(data)
        with pytest.raises(UnsupportedOp, match=f"{op}.*no handler"):
            cm(cm.params, {"x": torch.from_numpy(A)})


def test_shape_from_a_device_tensor_is_refused():
    """A Reshape target computed from a fed tensor would have to be read
    back from the device every batch; the port refuses it (the reference
    refuses it under jit)."""
    node = O.make_node("Reshape", ["x", "s"], ["y"])
    data = O.make_model(_graph(O, [node], {"x": A,
                                           "s": np.array([4, 3], np.int64)},
                               {}, ["y"]))
    cm = O.convert_model(data)
    with pytest.raises(UnsupportedOp, match="host"):
        cm(cm.params, {"x": torch.from_numpy(A),
                       "s": torch.tensor([4, 3])})


def test_pruned_matches_reference():
    nodes = [O.make_node("Relu", ["x"], ["r"]),
             O.make_node("MatMul", ["r", "w"], ["y"]),
             O.make_node("Sub", ["y", "labels"], ["err"]),
             O.make_node("ReduceSumSquare", ["err"], ["loss"], keepdims=0)]
    w = np.random.default_rng(6).normal(0, 1, (4, 2)).astype(np.float32)
    data = O.make_model(_graph(
        O, nodes, {"x": A, "labels": np.zeros((3, 2), np.float32)},
        {"w": w}, ["y", "loss"]))
    jm, pm = J.convert_model(data).pruned(["y"]), \
        O.convert_model(data).pruned(["y"])
    assert pm.input_names == jm.input_names == ["x"]
    assert pm.output_names == ["y"]
    assert [n.op_type for n in pm.model.graph.nodes] == ["Relu", "MatMul"]
    assert set(pm.params) == set(jm.params) == {"w"}
    got = pm(pm.params, {"x": torch.from_numpy(A)})["y"]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm(jm.params, {"x": A})["y"]),
                               **SUM)
    with pytest.raises(ValueError, match="unknown outputs"):
        O.convert_model(data).pruned(["nope"])
