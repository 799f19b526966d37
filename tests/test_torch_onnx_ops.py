"""The port's ONNX handlers for control flow, recurrent cells, resampling,
detection and the long tail of ``mmlspark_tpu/onnx/convert.py`` against
the JAX converter on the CPU.

Each case is a graph written once with the port's builder (one node, or
the JAX tests' own graphs: ``tests/test_onnx_controlflow.py``,
``test_onnx_quant_detect.py``, ``test_onnx.py``, ``test_onnx_extra_ops.py``,
``test_onnx_generation.py``), fed the same seeded numpy inputs through both
converters (the JAX one eagerly, its feeds as jax arrays so no node takes
its host table). Tolerances:

* integer, boolean and index outputs, and data a handler only moves
  (gathers, scatters, sorts, permutations, ``nearest`` resampling, the
  branch an ``If`` selects), bitwise;
* float outputs within 1e-5 · max|ref| + 1e-6 of the JAX converter's, ref
  its output (``tests/test_torch_onnx_contrib.py``'s bound): the two
  libraries round transcendental functions and order sums differently;
* each ``UnsupportedOp`` the JAX handler raises, the port raises too.

``ConvTranspose`` is the exception: the JAX handler passes
``transpose_kernel=True`` to ``lax.conv_general_dilated``, which takes no
such keyword, so every ConvTranspose graph raises TypeError there. The
port computes the ONNX operator; its case pins the JAX converter's
TypeError and holds the port to the JAX handler's own ``lax`` formula with
the spatial flip that keyword names applied by hand (and to
``F.conv_transpose2d``).

``chip_smoke.onnx_op_cases`` (the graphs phase 18c runs on the card, Loop,
Scan, LSTM and GRU at T = 64) go through both converters here too.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

import mmlspark_tpu.onnx as J
import mmlspark_tpu_torch.onnx as O
from mmlspark_tpu.onnx.convert import UnsupportedOp as JaxUnsupported
from mmlspark_tpu_torch.onnx.convert import UnsupportedOp

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import onnx_op_cases  # noqa: E402

MS = {"domain": "com.microsoft"}


def _model(nodes, feeds, inits=None, outs=("y",), opset=17):
    g = O.make_graph(
        nodes, "t",
        [O.make_tensor_value_info(k, np.asarray(v).dtype,
                                  list(np.shape(v)))
         for k, v in feeds.items()],
        [O.make_tensor_value_info(o, np.float32, []) for o in outs],
        initializers=inits or {})
    return O.make_model(g, opset=opset, extra_opsets={"com.microsoft": 1})


def _port(data, feeds, outs):
    pm = O.convert_model(data)
    out = pm({k: torch.from_numpy(v) for k, v in pm.params.items()},
             {k: torch.from_numpy(np.array(v)) for k, v in feeds.items()})
    return {o: out[o].numpy() for o in outs}


def _jax(data, feeds, outs):
    jm = J.convert_model(data)
    out = jm(jm.params, {k: jnp.asarray(v) for k, v in feeds.items()})
    return {o: np.asarray(out[o]) for o in outs}


def _hold(got, want, exact, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # JAX runs with 64-bit types off: int64 comes back as int32
    assert got.dtype.kind == want.dtype.kind, (what, got.dtype, want.dtype)
    if want.dtype.kind != "f" or exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    tol = 1e-5 * float(np.abs(want).max(initial=0.0)) + 1e-6
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    assert err <= tol, f"{what}: max |port - jax| {err} > {tol}"


def _both(nodes, feeds, inits=None, outs=("y",), exact=False, opset=17):
    """One graph through both converters, every output held (see the
    module docstring). Returns the port's outputs."""
    data = _model(nodes, feeds, inits, outs, opset)
    got, want = _port(data, feeds, outs), _jax(data, feeds, outs)
    for o in outs:
        _hold(got[o], want[o], exact, o)
    return got


def _refused(nodes, feeds, inits=None, outs=("y",), match=None):
    """Both converters refuse the graph with UnsupportedOp."""
    data = _model(nodes, feeds, inits, outs)
    with pytest.raises(JaxUnsupported, match=match):
        _jax(data, feeds, outs)
    with pytest.raises(UnsupportedOp, match=match):
        _port(data, feeds, outs)


def _r(seed):
    g = np.random.default_rng(seed)
    return lambda *shape, s=1.0: g.normal(0, s, shape).astype(np.float32)


def _node(op, ins=("x",), outs=("y",), **attrs):
    return O.make_node(op, list(ins), list(outs), **attrs)


# ---------------------------------------------------------------------------
# activations, casts and bits (group 5)

X = _r(0)(3, 4, 5)
PRELU_SLOPE = np.abs(_r(1)(4, 1, 1)) * 0.3

ACTIVATIONS = {
    "LeakyRelu": dict(alpha=0.1), "Elu": dict(alpha=0.7), "Selu": {},
    "Celu": dict(alpha=1.3), "Softplus": {},
    "HardSigmoid": dict(alpha=0.3, beta=0.4), "HardSwish": {},
    "Shrink": dict(lambd=0.5, bias=0.1), "ThresholdedRelu": dict(alpha=0.5),
}


@pytest.mark.parametrize("op", sorted(ACTIVATIONS))
def test_activation(op):
    x = np.concatenate([X.ravel() * 4, [-2.0, -0.3, 0.0, 0.4, 2.0, 30.0]]) \
        .astype(np.float32)
    _both([_node(op, **ACTIVATIONS[op])], {"x": x})


def test_prelu_broadcasts_a_channel_slope():
    _both([_node("PRelu", ["x", "slope"])], {"x": X[None].repeat(2, 0)
                                             .reshape(2, 3, 4, 5)[:, :, :4]
                                             .transpose(0, 2, 1, 3).copy()},
          {"slope": PRELU_SLOPE})


@pytest.mark.parametrize("case", ["f32-like-int", "int-like-f32"])
def test_castlike(case):
    if case == "f32-like-int":
        feeds = {"x": X * 10, "t": np.zeros(1, np.int32)}
    else:
        feeds = {"x": np.arange(-6, 6, dtype=np.int32), "t": X[0, 0]}
    _both([_node("CastLike", ["x", "t"])], feeds)


@pytest.mark.parametrize("dtype,direction", [
    (np.uint32, "LEFT"), (np.uint32, "RIGHT"), (np.uint8, "LEFT"),
    (np.uint8, "RIGHT")])
def test_bitshift(dtype, direction):
    # tests/test_onnx.py's uint32 case, then random codes and shifts
    g = np.random.default_rng(2)
    info = np.iinfo(dtype)
    x = np.concatenate([[1, 2, 8], g.integers(0, info.max, 13)]).astype(dtype)
    s = np.concatenate([[1, 2, 2], g.integers(0, info.bits, 13)]) \
        .astype(dtype)
    got = _both([_node("BitShift", ["x", "s"], direction=direction)],
                {"x": x, "s": s})
    want = [2, 8, 32] if direction == "LEFT" else [0, 0, 2]
    np.testing.assert_array_equal(got["y"][:3], want)


@pytest.mark.parametrize("direction", ["LEFT", "RIGHT"])
def test_bitshift_uint64_against_numpy(direction):
    """uint64 (the JAX package, 64-bit types off, computes it as uint32):
    the port against numpy, shifts of 64 and more giving 0."""
    g = np.random.default_rng(3)
    x = g.integers(0, 2 ** 63, 16, dtype=np.uint64) * np.uint64(2) + \
        np.uint64(1)
    s = np.concatenate([[0, 1, 63, 64, 70], g.integers(0, 64, 11)]) \
        .astype(np.uint64)
    got = _port(_model([_node("BitShift", ["x", "s"], direction=direction)],
                       {"x": x, "s": s}), {"x": x, "s": s}, ["y"])["y"]
    big = s >= 64
    sc = np.where(big, 0, s)
    want = (x << sc) if direction == "LEFT" else (x >> sc)
    np.testing.assert_array_equal(got, np.where(big, np.uint64(0), want))


# ---------------------------------------------------------------------------
# indexing and shape (group 5)

@pytest.mark.parametrize("case", ["spec", "batch-first"])
def test_reverse_sequence(case):
    if case == "spec":
        # tests/test_onnx.py: (time=4, batch=2), each batch's prefix
        x = np.arange(8, dtype=np.float32).reshape(4, 2)
        got = _both([_node("ReverseSequence", ["x", "l"], batch_axis=1,
                           time_axis=0)],
                    {"x": x, "l": np.array([4, 2], np.int64)}, exact=True)
        want = x.copy()
        want[:4, 0] = x[:4, 0][::-1]
        want[:2, 1] = x[:2, 1][::-1]
        np.testing.assert_array_equal(got["y"], want)
    else:
        _both([_node("ReverseSequence", ["x", "l"], batch_axis=0,
                     time_axis=1)],
              {"x": X, "l": np.array([4, 1, 3], np.int64)}, exact=True)


def test_gather_elements_negative_indices():
    idx = np.random.default_rng(3).integers(-5, 5, (3, 6, 5)).astype(np.int64)
    _both([_node("GatherElements", ["x", "i"], axis=1)],
          {"x": X.reshape(3, 4, 5)[:, [0, 1, 2, 3]].copy(), "i": idx % 4 - 2},
          exact=True)


@pytest.mark.parametrize("case", ["rows", "elements"])
def test_gather_nd(case):
    idx = np.array([[0, 1], [2, -1]], np.int64) if case == "rows" else \
        np.array([[[0, 1, 2]], [[2, 3, 4]]], np.int64)
    _both([_node("GatherND", ["x", "i"])], {"x": X, "i": idx}, exact=True)


def test_gather_nd_batch_dims_refused():
    _refused([_node("GatherND", ["x", "i"], batch_dims=1)],
             {"x": X, "i": np.zeros((3, 1), np.int64)}, match="batch_dims")


@pytest.mark.parametrize("case", ["rows", "elements"])
def test_scatter_nd_unique_indices(case):
    if case == "rows":
        idx = np.array([[2], [0]], np.int64)
        upd = _r(4)(2, 4, 5)
    else:
        idx = np.array([[0, 1, 2], [2, 3, 4], [1, 0, 0]], np.int64)
        upd = _r(4)(3)
    _both([_node("ScatterND", ["x", "i", "u"])],
          {"x": X, "i": idx, "u": upd}, exact=True)


def test_scatter_nd_reduction_is_not_read():
    """As in the reference, ``reduction`` (opset 16) is not read: "add"
    sets the rows (ROADMAP.md section 3)."""
    idx = np.array([[2], [0]], np.int64)
    upd = _r(4)(2, 4, 5)
    got = _both([_node("ScatterND", ["x", "i", "u"], reduction="add")],
                {"x": X, "i": idx, "u": upd}, exact=True, opset=18)
    np.testing.assert_array_equal(got["y"][[2, 0]], upd)


@pytest.mark.parametrize("largest,axis", [(1, -1), (0, -1), (1, 1)])
def test_topk_ties_take_the_lower_index(largest, axis):
    # values drawn from 4 levels: most rows hold ties
    x = np.random.default_rng(5).integers(0, 4, (3, 6, 7)).astype(np.float32)
    got = _both([_node("TopK", ["x", "k"], ["v", "i"], largest=largest,
                       axis=axis)],
                {"x": x}, {"k": np.array([3], np.int64)}, outs=("v", "i"),
                exact=True)
    assert got["i"].dtype == np.int64


@pytest.mark.parametrize("axis,values", [(-1, [0.0, 3.0]), (0, [-1, 2])])
def test_onehot(axis, values):
    idx = np.array([[0, 4, -1], [2, 7, -6]], np.int64)
    vals = np.array(values, np.float32 if isinstance(values[0], float)
                    else np.int64)
    _both([_node("OneHot", ["i", "d", "v"], axis=axis)], {"i": idx},
          {"d": np.array(5, np.int64), "v": vals})


@pytest.mark.parametrize("exclusive,reverse", [(0, 0), (1, 0), (0, 1),
                                               (1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_cumsum(exclusive, reverse, dtype):
    x = (X * 10).astype(dtype)
    _both([_node("CumSum", ["x", "a"], exclusive=exclusive,
                 reverse=reverse)], {"x": x}, {"a": np.array(1, np.int64)})


@pytest.mark.parametrize("upper,k", [(0, 0), (1, 1), (0, -1), (1, -2)])
def test_trilu(upper, k):
    _both([_node("Trilu", ["x", "k"], upper=upper)], {"x": X},
          {"k": np.array(k, np.int64)}, exact=True)


def test_trilu_of_the_generation_graph():
    """tests/test_onnx_generation.py's causal mask: Trilu(ones (S, T),
    k = T - S, upper=0) with S and T from shapes, folded on the host."""
    nodes = [_node("Shape", ["q"], ["qs"]), _node("Shape", ["m"], ["ms"]),
             _node("Gather", ["qs", "i1"], ["S"], axis=0),
             _node("Gather", ["ms", "i1"], ["T"], axis=0),
             _node("Sub", ["T", "S"], ["P"]),
             _node("Unsqueeze", ["S"], ["Su"], axes=[0]),
             _node("Unsqueeze", ["T"], ["Tu"], axes=[0]),
             _node("Concat", ["Su", "Tu"], ["st"], axis=0),
             _node("Expand", ["one", "st"], ["ones"]),
             _node("Trilu", ["ones", "P"], ["tril"], upper=0),
             _node("Mul", ["tril", "q0"], ["y"])]
    _both(nodes, {"q": np.zeros((2, 3), np.float32),
                  "m": np.zeros((2, 5), np.float32),
                  "q0": np.ones((3, 5), np.float32)},
          {"i1": np.array(1, np.int64), "one": np.array(1.0, np.float32)},
          opset=11, exact=True)


@pytest.mark.parametrize("attrs", [{}, {"k": 1}, {"k": -2, "dtype": 6}])
def test_eyelike(attrs):
    _both([_node("EyeLike", **attrs)], {"x": X[0]}, exact=True)


@pytest.mark.parametrize("mode", ["DCR", "CRD"])
def test_depth_to_space(mode):
    _both([_node("DepthToSpace", blocksize=2, mode=mode)],
          {"x": _r(6)(2, 8, 3, 4)}, exact=True)


def test_space_to_depth():
    _both([_node("SpaceToDepth", blocksize=2)], {"x": _r(7)(2, 3, 4, 6)},
          exact=True)


# ---------------------------------------------------------------------------
# convolution and normalization (group 5)

def _jax_conv_transpose(x, w, strides, dilations, pads, out_pad):
    """The JAX handler's formula (``convert.py:1032``) with the spatial flip
    ``transpose_kernel=True`` names done by hand: ONNX (C_in, C_out, *k)
    weights read as IO, the input dilated by the strides."""
    rank = w.ndim - 2
    spatial = "DHW"[-rank:]
    dn = lax.conv_dimension_numbers(x.shape, w.shape, (
        f"NC{spatial}", f"IO{spatial}", f"NC{spatial}"))
    pad_cfg = [(dilations[i] * (w.shape[2 + i] - 1) - pads[i],
                dilations[i] * (w.shape[2 + i] - 1) - pads[i + rank]
                + out_pad[i]) for i in range(rank)]
    wf = jnp.flip(jnp.asarray(w), axis=tuple(range(2, w.ndim)))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), wf, (1,) * rank, pad_cfg, lhs_dilation=strides,
        rhs_dilation=dilations, dimension_numbers=dn,
        precision=lax.Precision.HIGHEST))


@pytest.mark.parametrize("strides,dilations,pads,out_pad,bias", [
    ([2, 2], [1, 1], [1, 1, 1, 1], [0, 0], False),
    ([2, 1], [1, 2], [0, 1, 2, 0], [1, 0], True),
    ([1, 1], [1, 1], [0, 0, 0, 0], [0, 0], False)])
def test_conv_transpose(strides, dilations, pads, out_pad, bias):
    import torch.nn.functional as F
    x, w, b = _r(8)(2, 3, 5, 6), _r(9)(3, 4, 3, 3), _r(10)(4)
    ins = ["x", "w"] + (["b"] if bias else [])
    node = _node("ConvTranspose", ins, strides=strides, dilations=dilations,
                 pads=pads, output_padding=out_pad)
    inits = {"w": w, **({"b": b} if bias else {})}
    data = _model([node], {"x": x}, inits)
    # the JAX converter cannot run any ConvTranspose (ROADMAP.md section 3)
    with pytest.raises(TypeError, match="transpose_kernel"):
        _jax(data, {"x": x}, ["y"])
    got = _port(data, {"x": x}, ["y"])["y"]
    want = _jax_conv_transpose(x, w, strides, dilations, pads, out_pad)
    if bias:
        want = want + b.reshape(1, -1, 1, 1)
    _hold(got, want, False, "ConvTranspose vs the handler's lax formula")
    if pads[:2] == pads[2:]:
        ref = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b) if bias else None,
                                 stride=strides, padding=pads[:2],
                                 output_padding=out_pad,
                                 dilation=dilations).numpy()
        _hold(got, ref, False, "ConvTranspose vs F.conv_transpose2d")


def test_conv_transpose_grouped_refused():
    data = _model([_node("ConvTranspose", ["x", "w"], group=3)],
                  {"x": _r(8)(1, 3, 4, 4)}, {"w": _r(9)(3, 1, 3, 3)})
    for run, exc in ((_jax, JaxUnsupported), (_port, UnsupportedOp)):
        with pytest.raises(exc, match="grouped"):
            run(data, {"x": _r(8)(1, 3, 4, 4)}, ["y"])


FUSED_X, FUSED_W, FUSED_B = _r(11)(1, 3, 8, 8), _r(12)(4, 3, 3, 3, s=0.3), \
    _r(13)(4, s=0.1)


@pytest.mark.parametrize("act,params,residual", [
    ("Relu", [], False), ("LeakyRelu", [0.2], True), ("Tanh", [], False),
    ("Sigmoid", [], False), ("Clip", [-0.5, 0.5], False),
    ("HardSigmoid", [0.3, 0.4], True), ("", [], True)])
def test_fused_conv(act, params, residual):
    # tests/test_onnx_extra_ops.py's TestFusedConv, every activation
    ins = ["x", "w", "b"] + (["z"] if residual else [])
    inits = {"w": FUSED_W, "b": FUSED_B}
    if residual:
        inits["z"] = _r(14)(1, 4, 6, 6)
    attrs = {"activation": act} if act else {}
    if params:
        attrs["activation_params"] = params
    _both([_node("FusedConv", ins, **attrs, **MS)], {"x": FUSED_X}, inits)


def test_fused_conv_unknown_activation_refused():
    _refused([_node("FusedConv", ["x", "w", "b"], activation="Swoosh", **MS)],
             {"x": FUSED_X}, {"w": FUSED_W, "b": FUSED_B}, match="activation")


def test_instance_normalization():
    x = _r(15)(2, 3, 4, 5) * 3 + 1
    _both([_node("InstanceNormalization", ["x", "s", "b"], epsilon=1e-4)],
          {"x": x}, {"s": _r(16)(3), "b": _r(17)(3)})


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_normalization_per_channel_scale(groups):
    x = _r(18)(2, 4, 3, 5) * 2 - 1
    _both([_node("GroupNormalization", ["x", "s", "b"], num_groups=groups)],
          {"x": x}, {"s": _r(19)(4), "b": _r(20)(4)}, opset=18)


@pytest.mark.parametrize("p,axis", [(1, 1), (2, -1)])
def test_lp_normalization(p, axis):
    _both([_node("LpNormalization", p=p, axis=axis)], {"x": X})


def test_reduce_log_sum():
    # tests/test_onnx_extra_ops.py's case
    x = np.abs(np.random.default_rng(0).normal(1, 1, (3, 4))) \
        .astype(np.float32)
    got = _both([_node("ReduceLogSum", axes=[1])], {"x": x}, opset=13)
    np.testing.assert_allclose(got["y"], np.log(x.sum(1, keepdims=True)),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# resampling (group 4): jax.image.resize, not F.interpolate

@pytest.mark.parametrize("mode,sizes,dtype", [
    ("nearest", [2, 3, 11, 9], np.float32),
    ("nearest", [2, 3, 3, 2], np.float32),
    ("linear", [2, 3, 13, 7], np.float32),
    ("linear", [2, 3, 3, 2], np.float32),       # antialiased
    ("cubic", [2, 3, 12, 10], np.float32),
    ("cubic", [2, 3, 4, 3], np.float32),        # antialiased
    ("linear", [2, 3, 9, 11], np.uint8),
    ("nearest", [2, 3, 9, 11], np.uint8)])
def test_resize_sizes(mode, sizes, dtype):
    x = _r(21)(2, 3, 6, 5) * 50 + 100
    x = x.astype(dtype)
    _both([_node("Resize", ["x", "", "", "sz"], mode=mode)], {"x": x},
          {"sz": np.array(sizes, np.int64)}, exact=mode == "nearest")


@pytest.mark.parametrize("mode", ["nearest", "linear"])
def test_resize_scales_and_upsample(mode):
    """Scales from a ``Constant`` node, a host value in both converters (a
    1-D float initializer is a param: a device tensor in the port, traced
    under the JAX ``ONNXModel``'s jit, refused by both there)."""
    x = _r(22)(1, 2, 5, 4)

    def scales(v):
        return _node("Constant", [], ["s"],
                     value=np.array(v, np.float32))

    _both([scales([1.0, 1.0, 2.0, 0.75]),
           _node("Resize", ["x", "", "s"], mode=mode)], {"x": x},
          exact=mode == "nearest")
    _both([scales([1.0, 1.0, 2.0, 3.0]),
           _node("Upsample", ["x", "s"], mode=mode)], {"x": x}, opset=9,
          exact=mode == "nearest")


def test_resize_differs_from_f_interpolate():
    """The reference's cubic kernel (Keys, a = -0.5) is not
    ``F.interpolate``'s (a = -0.75): pinned so no one swaps them."""
    import torch.nn.functional as F
    x = _r(23)(1, 1, 6, 6)
    got = _both([_node("Resize", ["x", "", "", "sz"], mode="cubic")],
                {"x": x}, {"sz": np.array([1, 1, 12, 12], np.int64)})["y"]
    lib = F.interpolate(torch.from_numpy(x), size=(12, 12), mode="bicubic",
                        align_corners=False).numpy()
    assert np.abs(got - lib).max() > 1e-3


def test_resize_without_sizes_refused():
    _refused([_node("Resize", ["x", "r"])], {"x": _r(24)(1, 1, 2, 2)},
             {"r": np.zeros(0, np.float32)}, match="sizes")


# ---------------------------------------------------------------------------
# detection (group 4): tests/test_onnx_quant_detect.py's cases

NMS_CASES = {
    "overlaps": (np.asarray([[[0, 0, 10, 10], [1, 1, 11, 11],
                              [50, 50, 60, 60]]], np.float32),
                 np.asarray([[[0.9, 0.8, 0.7]]], np.float32), 10, 0.5, None,
                 {}, [[0, 0, 0], [0, 0, 2]]),
    "threshold-and-max": (np.asarray([[[0, 0, 1, 1], [10, 10, 11, 11],
                                       [20, 20, 21, 21], [30, 30, 31, 31]]],
                                     np.float32),
                          np.asarray([[[0.9, 0.8, 0.05, 0.7]]], np.float32),
                          2, 0.5, 0.1, {}, [[0, 0, 0], [0, 0, 1]]),
    "max-zero": (np.asarray([[[0, 0, 1, 1]]], np.float32),
                 np.asarray([[[0.9]]], np.float32), 0, 0.5, None, {},
                 np.zeros((0, 3), np.int64)),
    "center-multiclass": (np.asarray([[[5, 5, 10, 10], [5.5, 5.5, 10, 10],
                                       [30, 30, 4, 4]]], np.float32),
                          np.asarray([[[0.9, 0.85, 0.1], [0.2, 0.95, 0.3]]],
                                     np.float32), 10, 0.4, None,
                          {"center_point_box": 1},
                          [[0, 0, 0], [0, 0, 2], [0, 1, 1], [0, 1, 2]]),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_non_max_suppression(case):
    boxes, scores, max_out, iou, thr, attrs, want = NMS_CASES[case]
    names = ["b", "s", "m", "i"] + (["t"] if thr is not None else [])
    inits = {"m": np.int64(max_out), "i": np.float32(iou)}
    if thr is not None:
        inits["t"] = np.float32(thr)
    got = _both([_node("NonMaxSuppression", names, **attrs)],
                {"b": boxes, "s": scores}, inits)
    np.testing.assert_array_equal(got["y"], want)


def test_non_max_suppression_random_boxes():
    g = np.random.default_rng(25)
    corners = g.uniform(0, 20, (2, 30, 2)).astype(np.float32)
    boxes = np.concatenate([corners, corners + g.uniform(
        1, 8, (2, 30, 2)).astype(np.float32)], axis=-1)
    scores = g.uniform(0, 1, (2, 3, 30)).astype(np.float32)
    _both([_node("NonMaxSuppression", ["b", "s", "m", "i", "t"])],
          {"b": boxes, "s": scores},
          {"m": np.int64(7), "i": np.float32(0.3), "t": np.float32(0.2)})


@pytest.mark.parametrize("case", ["unit", "dense-avg", "max", "legacy"])
def test_roi_align(case):
    if case == "unit":
        x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
        rois = np.asarray([[0.0, 0.0, 2.0, 2.0]], np.float32)
        bi = np.asarray([0], np.int64)
        attrs = dict(output_height=2, output_width=2, sampling_ratio=1)
    else:
        x = _r(26)(2, 3, 16, 16)
        rois = np.asarray([[1.0, 2.0, 9.0, 12.0], [0.0, 0.0, 16.0, 16.0],
                           [-3.0, 5.0, 30.0, 18.0]], np.float32)
        bi = np.asarray([1, 0, 1], np.int64)
        attrs = dict(output_height=4, output_width=3, sampling_ratio=2,
                     spatial_scale=0.5)
        if case == "max":
            attrs["mode"] = "max"
        if case == "legacy":
            attrs["coordinate_transformation_mode"] = "output_half_pixel"
    got = _both([_node("RoiAlign", ["x", "r", "bi"], **attrs)],
                {"x": x, "r": rois, "bi": bi})
    if case == "unit":
        np.testing.assert_allclose(got["y"][0, 0], [[0, 1], [4, 5]],
                                   atol=1e-5)


def test_roi_align_adaptive_sampling_refused():
    _refused([_node("RoiAlign", ["x", "r", "bi"], output_height=2,
                    output_width=2)],
             {"x": np.zeros((1, 1, 4, 4), np.float32),
              "r": np.zeros((1, 4), np.float32),
              "bi": np.zeros(1, np.int64)}, match="sampling_ratio")


@pytest.mark.parametrize("mode,pad,align", [
    ("bilinear", "zeros", 0), ("bilinear", "border", 1),
    ("nearest", "zeros", 0), ("bilinear", "reflection", 0),
    ("linear", "reflection", 1), ("nearest", "border", 1)])
def test_grid_sample(mode, pad, align):
    g = np.random.default_rng(27)
    x = g.normal(0, 1, (2, 3, 7, 9)).astype(np.float32)
    grid = g.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    _both([_node("GridSample", ["x", "g"], mode=mode, padding_mode=pad,
                 align_corners=align)], {"x": x, "g": grid},
          exact=mode == "nearest")


def test_grid_sample_cubic_refused():
    _refused([_node("GridSample", ["x", "g"], mode="cubic")],
             {"x": np.zeros((1, 1, 3, 3), np.float32),
              "g": np.zeros((1, 2, 2, 2), np.float32)}, match="mode")


# ---------------------------------------------------------------------------
# control flow (group 2): tests/test_onnx_controlflow.py's graphs

def _vi(name, dtype, shape):
    return O.make_tensor_value_info(name, dtype, shape)


def _if_graph(cond_from_init):
    then_g = O.make_graph([_node("Mul", ["x", "two"], ["y"])], "then", [],
                          [_vi("y", np.float32, [3])],
                          initializers={"two": np.float32(2.0).reshape(())})
    else_g = O.make_graph([_node("Neg", ["x"], ["y"])], "else", [],
                          [_vi("y", np.float32, [3])])
    inputs = [_vi("x", np.float32, [3])]
    if not cond_from_init:
        inputs.insert(0, _vi("cond", np.bool_, []))
    return [_node("If", ["cond"], ["out"], then_branch=then_g,
                  else_branch=else_g)], inputs


@pytest.mark.parametrize("where", ["host", "device"])
@pytest.mark.parametrize("cond", [True, False])
def test_if(where, cond):
    """A host predicate (an initializer, as exporters write them) runs one
    branch; a fed predicate is a device tensor, so both branches run and
    the predicate selects (the reference: ``lax.cond``)."""
    nodes, inputs = _if_graph(where == "host")
    x = np.array([1.0, 2.0, 3.0], np.float32)
    feeds = {"x": x} if where == "host" else {"cond": np.asarray(cond),
                                              "x": x}
    inits = {"cond": np.asarray(cond)} if where == "host" else {}
    got = _both(nodes, feeds, inits, outs=("out",), exact=True)
    np.testing.assert_array_equal(got["out"], x * 2 if cond else -x)


def _loop_scan_body():
    return O.make_graph(
        [_node("Add", ["acc_in", "x"], ["acc_out"]),
         _node("Identity", ["cond_in"], ["cond_out"]),
         _node("Identity", ["acc_out"], ["scan_out"])], "body",
        [_vi("iter", np.int64, []), _vi("cond_in", np.bool_, []),
         _vi("acc_in", np.float32, [2])],
        [_vi("cond_out", np.bool_, []), _vi("acc_out", np.float32, [2]),
         _vi("scan_out", np.float32, [2])])


@pytest.mark.parametrize("trip", [4, 64, 0])
def test_loop_static_trip_count_with_scan_output(trip):
    x = np.array([1.0, 10.0], np.float32)
    got = _both([_node("Loop", ["M", "", "acc0"], ["acc_final", "trace"],
                       body=_loop_scan_body())],
                {"acc0": np.zeros(2, np.float32), "x": x},
                {"M": np.int64(trip).reshape(())},
                outs=("acc_final", "trace"))
    np.testing.assert_allclose(got["acc_final"], trip * x)
    assert got["trace"].shape == (trip, 2)


def _counting_loop(with_break_at=None):
    nodes = [_node("Add", ["v_in", "one"], ["v_out"])]
    inits = {"one": np.float32(1.0).reshape(())}
    if with_break_at is None:
        nodes.append(_node("Identity", ["cond_in"], ["cond_out"]))
    else:
        nodes.append(_node("Less", ["v_out", "limit"], ["cond_out"]))
        inits["limit"] = np.float32(with_break_at).reshape(())
    body = O.make_graph(
        nodes, "body",
        [_vi("iter", np.int64, []), _vi("cond_in", np.bool_, []),
         _vi("v_in", np.float32, [])],
        [_vi("cond_out", np.bool_, []), _vi("v_out", np.float32, [])],
        initializers=inits)
    return [_node("Loop", ["M", "cond0", "v0"], ["v_final"], body=body)]


@pytest.mark.parametrize("cond0,v0,brk,want", [
    (False, 5.0, None, 5.0), (True, 0.0, 3.0, 3.0), (True, 2.0, None, 12.0)])
def test_loop_conditions(cond0, v0, brk, want):
    """An initial condition of False runs nothing; a body condition that
    turns False (on the device) stops the carry: tests/test_onnx_
    controlflow.py's TestLoopSemantics."""
    got = _both(_counting_loop(brk), {"v0": np.float32(v0)},
                {"M": np.int64(10).reshape(()),
                 "cond0": np.asarray(cond0)}, outs=("v_final",))
    assert float(got["v_final"]) == want


def test_loop_iteration_number_and_outer_capture():
    """The body reads the iteration number and an outer-scope tensor."""
    body = O.make_graph(
        [_node("Cast", ["iter"], ["it"], to=1),
         _node("Mul", ["it", "w"], ["inc"]),
         _node("Add", ["v_in", "inc"], ["v_out"]),
         _node("Identity", ["cond_in"], ["cond_out"])], "body",
        [_vi("iter", np.int64, []), _vi("cond_in", np.bool_, []),
         _vi("v_in", np.float32, [3])],
        [_vi("cond_out", np.bool_, []), _vi("v_out", np.float32, [3])])
    w = np.array([1.0, -2.0, 0.5], np.float32)
    got = _both([_node("Loop", ["M", "", "v0"], ["v"], body=body)],
                {"v0": np.zeros(3, np.float32), "w": w},
                {"M": np.int64(5).reshape(())}, outs=("v",))
    np.testing.assert_allclose(got["v"], 10 * w)


def test_loop_device_trip_count_refused():
    body = O.make_graph(
        [_node("Identity", ["cond_in"], ["cond_out"]),
         _node("Identity", ["v_in"], ["v_out"])], "body",
        [_vi("iter", np.int64, []), _vi("cond_in", np.bool_, []),
         _vi("v_in", np.float32, [1])],
        [_vi("cond_out", np.bool_, []), _vi("v_out", np.float32, [1])])
    _refused([_node("Loop", ["M", "", "v0"], ["y"], body=body)],
             {"M": np.int64(3), "v0": np.zeros(1, np.float32)},
             match="static trip count")


@pytest.mark.parametrize("T", [5, 64])
def test_scan_cumulative_sum(T):
    body = O.make_graph(
        [_node("Add", ["s_in", "x_t"], ["s_out"]),
         _node("Identity", ["s_out"], ["y_t"])], "body",
        [_vi("s_in", np.float32, [3]), _vi("x_t", np.float32, [3])],
        [_vi("s_out", np.float32, [3]), _vi("y_t", np.float32, [3])])
    xs = _r(28)(T, 3)
    got = _both([_node("Scan", ["s0", "xs"], ["s_final", "ys"], body=body,
                       num_scan_inputs=1)],
                {"s0": np.zeros(3, np.float32), "xs": xs},
                outs=("s_final", "ys"))
    np.testing.assert_allclose(got["ys"], np.cumsum(xs, axis=0), rtol=1e-4,
                               atol=1e-5)


def test_scan_reverse_direction_refused():
    body = O.make_graph([_node("Identity", ["x_t"], ["y_t"])], "body",
                        [_vi("x_t", np.float32, [3])],
                        [_vi("y_t", np.float32, [3])])
    _refused([_node("Scan", ["xs"], ["ys"], body=body, num_scan_inputs=1,
                    scan_input_directions=[1])],
             {"xs": _r(29)(4, 3)}, match="directions")


# ---------------------------------------------------------------------------
# recurrent cells (group 3)

def _rnn_inits(gates, dirs, H, I, seed, bias=True):
    g = np.random.default_rng(seed)
    out = {"W": g.normal(0, 0.4, (dirs, gates * H, I)).astype(np.float32),
           "R": g.normal(0, 0.4, (dirs, gates * H, H)).astype(np.float32)}
    if bias:
        out["B"] = g.normal(0, 0.1, (dirs, 2 * gates * H)).astype(np.float32)
    return out


@pytest.mark.parametrize("direction,T,initial", [
    ("forward", 6, False), ("bidirectional", 5, True),
    ("reverse", 64, False)])
def test_lstm(direction, T, initial):
    dirs, Bt, I, H = (2 if direction == "bidirectional" else 1), 2, 4, 3
    inits = _rnn_inits(4, dirs, H, I, 30)
    ins = ["X", "W", "R", "B"]
    feeds = {"X": _r(31)(T, Bt, I)}
    if initial:
        ins += ["", "h0", "c0"]
        feeds["h0"] = _r(32)(dirs, Bt, H)
        feeds["c0"] = _r(33)(dirs, Bt, H)
    _both([_node("LSTM", ins, ["Y", "Y_h", "Y_c"], hidden_size=H,
                 direction=direction)], feeds, inits,
          outs=("Y", "Y_h", "Y_c"))


@pytest.mark.parametrize("lbr,direction,bias", [
    (1, "forward", True), (0, "forward", True), (0, "bidirectional", False),
    (1, "reverse", True)])
def test_gru(lbr, direction, bias):
    dirs, T, Bt, I, H = (2 if direction == "bidirectional" else 1), 5, 2, 3, 4
    inits = _rnn_inits(3, dirs, H, I, 34, bias)
    ins = ["X", "W", "R"] + (["B"] if bias else [])
    got = _both([_node("GRU", ins, ["Y", "Y_h"], hidden_size=H,
                       linear_before_reset=lbr, direction=direction)],
                {"X": _r(35)(T, Bt, I)}, inits, outs=("Y", "Y_h"))
    assert np.abs(got["Y"]).max() <= 1.0 + 1e-5      # tanh-bounded state


@pytest.mark.parametrize("op,attrs,match", [
    ("LSTM", dict(activations=["HardSigmoid", "Tanh", "Tanh"]),
     "activations"),
    ("LSTM", dict(clip=3.0), "clipping"),
    ("GRU", dict(direction="sideways"), "direction")])
def test_recurrent_refusals(op, attrs, match):
    gates = 4 if op == "LSTM" else 3
    _refused([_node(op, ["X", "W", "R"], ["Y"], hidden_size=2, **attrs)],
             {"X": np.zeros((3, 1, 2), np.float32)},
             {"W": np.zeros((1, 2 * gates, 2), np.float32),
              "R": np.zeros((1, 2 * gates, 2), np.float32)}, match=match)


def test_handler_sets():
    """The port registers exactly the JAX converter's 199 handlers: those
    of ``convert.py``, ``ml_ops.py`` (``tests/test_torch_onnx_ml_ops.py``),
    ``extra_ops.py`` (``tests/test_torch_onnx_extra_ops.py``) and
    ``generation_ops.py`` (``tests/test_torch_onnx_generation.py``)."""
    from mmlspark_tpu.onnx.convert import OP_HANDLERS as jax_ops
    from mmlspark_tpu_torch.onnx.convert import OP_HANDLERS as port_ops
    assert set(port_ops) == set(jax_ops)
    assert len(port_ops) == 199
    for name in ("extra_ops", "generation_ops", "ml_ops"):
        assert f"mmlspark_tpu_torch.onnx.{name}" in sys.modules


CARD_CASES = onnx_op_cases()


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_chip_smoke_cases_match_the_reference(name):
    data, feeds, exact = CARD_CASES[name]
    outs = O.convert_model(data).output_names
    got = _port(data, feeds, outs)
    if name == "ConvTranspose":
        with pytest.raises(TypeError, match="transpose_kernel"):
            _jax(data, feeds, outs)
        pm = O.convert_model(data)
        node = pm.model.graph.nodes[0]
        want = {"y": _jax_conv_transpose(
            feeds["x"], pm.params["w"], node.attr("strides"),
            node.attr("dilations"), node.attr("pads"),
            node.attr("output_padding")) + pm.params["b"].reshape(1, -1, 1, 1)}
    else:
        want = _jax(data, feeds, outs)
    for o in outs:
        _hold(got[o], want[o], exact, f"{name} {o}")
