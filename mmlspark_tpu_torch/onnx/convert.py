"""ONNX graph → PyTorch function (counterpart of
``mmlspark_tpu/onnx/convert.py``).

The JAX package turns a graph into a function XLA compiles; the port runs
the same graph eagerly, one PyTorch op per node, on the device its feeds
live on. What the JAX package left to XLA becomes ordinary PyTorch ops:
``Conv`` is ``F.conv2d`` (cuDNN), ``Gemm``/``MatMul`` are ``torch.matmul``
(cuBLAS), pools are ``F.max_pool2d`` or windowed sums. No node here
reaches a hand-written kernel: the one Pallas consumer of the reference
converter (``_attention_core``, the BERT family) is not ported yet.

Design notes, as in the reference:

* A node whose inputs are all host values (numpy: initializers that are
  shape constants, ``Shape`` outputs, ``Constant`` nodes) runs on the host
  and its result stays on the host — through the numpy table
  ``NUMPY_OPS`` where it has an entry, else through the node's handler on
  CPU tensors. ``Shape`` → ``Gather`` → ``Concat`` → ``Reshape`` chains
  therefore fold on the host, and no device tensor is ever read back to
  build a shape (that would wait for the device on every batch):
  :func:`_concrete` refuses one.
* The converted callable is ``fn(params, feeds) -> {name: tensor}`` with
  ``params`` passed explicitly, so callers place and cast them once.
* Operands of a node are promoted to one dtype the way JAX promotes
  operands that are all strongly typed (``torch.promote_types``): a 0-d
  float32 constant meeting a bfloat16 activation gives float32, as in the
  reference, where PyTorch's own rule for 0-d tensors would keep bfloat16.
  float64 host constants enter the device as float32 (the reference runs
  with 64-bit types off).

Ported handlers: the elementwise, unary and comparison tables, ``Clip``,
``Dropout``, ``Cast``, ``Where``, ``MatMul``, ``Gemm``, ``Conv``, the
pools, ``BatchNormalization``, ``LayerNormalization``, ``Softmax``,
``LogSoftmax``, the reductions, ``ArgMax``/``ArgMin`` and the shape and
data-movement ops. Any other op raises :class:`UnsupportedOp`.
"""

from __future__ import annotations

import copy
import functools
import itertools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .proto import (DataType, ModelProto, ValueInfo, ONNX_TO_NUMPY,
                    parse_model, tensor_to_numpy)

__all__ = ["ConvertedModel", "convert_model", "OP_HANDLERS", "NUMPY_OPS",
           "register_op", "UnsupportedOp"]


class UnsupportedOp(NotImplementedError):
    pass


#: ONNX element types → torch dtypes (bfloat16 included: numpy has none)
ONNX_TO_TORCH = {DataType.FLOAT: torch.float32, DataType.UINT8: torch.uint8,
                 DataType.INT8: torch.int8, DataType.INT16: torch.int16,
                 DataType.INT32: torch.int32, DataType.INT64: torch.int64,
                 DataType.BOOL: torch.bool, DataType.FLOAT16: torch.float16,
                 DataType.DOUBLE: torch.float64,
                 DataType.BFLOAT16: torch.bfloat16}


class _Ctx:
    """Per-call evaluation context: the opset and the device that tensors
    made from host values go to."""

    def __init__(self, opset: int, device: torch.device):
        self.opset = opset
        self.device = device


def _is_host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _torch_dtype(dt) -> torch.dtype:
    dt = np.dtype(dt)
    if dt == np.float64:
        return torch.float32
    if dt.kind not in "biuf":
        raise UnsupportedOp(f"host value of dtype {dt} cannot enter a "
                            f"tensor op")
    return torch.from_numpy(np.zeros(0, dt)).dtype


def _as_tensor(x, ctx: _Ctx, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """``x`` as a tensor on ``ctx.device`` (cast to ``dtype`` if given).
    A host scalar becomes a device fill, not a copy; a host array is
    copied with ``non_blocking``."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    a = np.asarray(x)
    tdt = dtype or _torch_dtype(a.dtype)
    if a.ndim == 0:
        return torch.full((), a.item(), dtype=tdt, device=ctx.device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(ctx.device, non_blocking=True).to(tdt)


def _dtype_of(x) -> torch.dtype:
    return x.dtype if isinstance(x, torch.Tensor) else \
        _torch_dtype(np.asarray(x).dtype)


def _promoted(ctx: _Ctx, *xs) -> List[torch.Tensor]:
    """The operands as tensors on one device, in the dtype JAX promotes
    them to (every operand strongly typed)."""
    dt = functools.reduce(torch.promote_types, [_dtype_of(x) for x in xs])
    return [_as_tensor(x, ctx, dt) for x in xs]


def _float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.float()


def _concrete(v, what: str) -> np.ndarray:
    """Require a host value (e.g. a Reshape target)."""
    if isinstance(v, torch.Tensor):
        raise UnsupportedOp(
            f"{what} must be computable on the host from constants and "
            "shapes; here it depends on a device tensor, and reading that "
            "back would wait for the device on every batch")
    return np.asarray(v)


OP_HANDLERS: Dict[str, Callable] = {}


def register_op(name: str):
    def deco(fn):
        OP_HANDLERS[name] = fn
        return fn
    return deco


# -- elementwise -------------------------------------------------------------

def _variadic(fn):
    def h(node, inputs, ctx):
        xs = _promoted(ctx, *inputs)
        out = xs[0]
        for x in xs[1:]:
            out = fn(out, x)
        return out
    return h


def _onnx_div(a, b):
    # integer Div truncates toward zero (C semantics), float Div is true div
    if a.is_floating_point():
        return a / b
    return torch.div(a, b, rounding_mode="trunc")


for _name, _fn in [
    ("Add", torch.add), ("Sub", torch.sub), ("Mul", torch.mul),
    ("Div", _onnx_div), ("And", torch.logical_and),
    ("Or", torch.logical_or), ("Xor", torch.logical_xor),
    ("Min", torch.minimum), ("Max", torch.maximum), ("Sum", torch.add),
]:
    OP_HANDLERS[_name] = _variadic(_fn)


@register_op("Pow")
def _onnx_pow(node, inputs, ctx):
    # the exponent takes the base's dtype (no promotion), as the reference
    a = _as_tensor(inputs[0], ctx)
    return torch.pow(a, _as_tensor(inputs[1], ctx, a.dtype))


@register_op("Mod")
def _onnx_mod(node, inputs, ctx):
    # fmod=1 truncates toward zero (C fmod); default follows the divisor's
    # sign (python %)
    a, b = _promoted(ctx, inputs[0], inputs[1])
    return torch.fmod(a, b) if node.attr("fmod", 0) else \
        torch.remainder(a, b)


@register_op("Mean")
def _mean(node, inputs, ctx):
    return _variadic(torch.add)(node, inputs, ctx) / len(inputs)


def _keep_int(f):
    """Floor/Ceil/Round leave integer inputs as they are."""
    return lambda x: x if not x.is_floating_point() else f(x)


def _on_float(f):
    return lambda x: f(_float(x))


for _name, _u in [
    ("Abs", torch.abs), ("Neg", torch.neg), ("Exp", _on_float(torch.exp)),
    ("Log", _on_float(torch.log)), ("Sqrt", _on_float(torch.sqrt)),
    ("Floor", _keep_int(torch.floor)), ("Ceil", _keep_int(torch.ceil)),
    ("Round", _keep_int(torch.round)), ("Sign", torch.sign),
    ("Tanh", _on_float(torch.tanh)), ("Sin", _on_float(torch.sin)),
    ("Cos", _on_float(torch.cos)), ("Tan", _on_float(torch.tan)),
    ("Asin", _on_float(torch.asin)), ("Acos", _on_float(torch.acos)),
    ("Atan", _on_float(torch.atan)), ("Sinh", _on_float(torch.sinh)),
    ("Cosh", _on_float(torch.cosh)), ("Asinh", _on_float(torch.asinh)),
    ("Acosh", _on_float(torch.acosh)), ("Atanh", _on_float(torch.atanh)),
    ("Not", torch.logical_not), ("Erf", _on_float(torch.erf)),
    ("Reciprocal", lambda x: 1.0 / x), ("Identity", lambda x: x),
    ("Relu", torch.relu), ("Sigmoid", _on_float(torch.sigmoid)),
    ("Softsign", _on_float(lambda x: x / (1 + torch.abs(x)))),
    ("IsNaN", torch.isnan),
    ("Mish", _on_float(lambda x: x * torch.tanh(
        torch.logaddexp(x, torch.zeros_like(x))))),
]:
    OP_HANDLERS[_name] = (lambda f: lambda node, inputs, ctx:
                          f(_as_tensor(inputs[0], ctx)))(_u)


@register_op("IsInf")
def _isinf(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    pos = torch.isposinf(x) if node.attr("detect_positive", 1) else \
        torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    neg = torch.isneginf(x) if node.attr("detect_negative", 1) else \
        torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return torch.logical_or(pos, neg)


for _name, _cmp in [("Equal", torch.eq), ("Greater", torch.gt),
                    ("GreaterOrEqual", torch.ge), ("Less", torch.lt),
                    ("LessOrEqual", torch.le)]:
    OP_HANDLERS[_name] = (lambda f: lambda n, i, c:
                          f(*_promoted(c, i[0], i[1])))(_cmp)


@register_op("Clip")
def _clip(node, inputs, ctx):
    if ctx.opset < 11:
        # attribute bounds are Python floats: weakly typed in both
        # frameworks, so the input keeps its dtype
        return torch.clamp(_as_tensor(inputs[0], ctx), node.attr("min"),
                           node.attr("max"))
    bounds = [(i, v) for i, v in enumerate(inputs[1:3], 1) if v is not None]
    xs = _promoted(ctx, inputs[0], *[v for _, v in bounds])
    x = xs[0]
    for (i, _), b in zip(bounds, xs[1:]):
        x = torch.maximum(x, b) if i == 1 else torch.minimum(x, b)
    return x


@register_op("Dropout")
def _dropout(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    if len(node.output) > 1:
        return x, torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return x


@register_op("Cast")
def _cast(node, inputs, ctx):
    to = node.attr("to")
    if to not in ONNX_TO_TORCH:
        raise UnsupportedOp(f"Cast to ONNX type {to}")
    return _as_tensor(inputs[0], ctx).to(ONNX_TO_TORCH[to])


@register_op("Where")
def _where(node, inputs, ctx):
    cond = _as_tensor(inputs[0], ctx, torch.bool)
    x, y = _promoted(ctx, inputs[1], inputs[2])
    return torch.where(cond, x, y)


# -- matmul family -----------------------------------------------------------

@register_op("MatMul")
def _matmul(node, inputs, ctx):
    return torch.matmul(*_promoted(ctx, inputs[0], inputs[1]))


@register_op("Gemm")
def _gemm(node, inputs, ctx):
    a, b = _promoted(ctx, inputs[0], inputs[1])
    if node.attr("transA", 0):
        a = a.transpose(-1, -2)
    if node.attr("transB", 0):
        b = b.transpose(-1, -2)
    y = torch.matmul(a, b)
    alpha = node.attr("alpha", 1.0)
    if alpha != 1.0:
        y = y * alpha
    if len(inputs) > 2 and inputs[2] is not None:
        c = _as_tensor(inputs[2], ctx)
        beta = node.attr("beta", 1.0)
        if beta != 1.0:
            c = c * beta
        y, c = _promoted(ctx, y, c)
        y = y + c
    return y


# -- conv / pool -------------------------------------------------------------

def _onnx_pads(pads: Optional[Sequence[int]], rank: int, auto_pad: str,
               x_shape, k_shape, strides, dilations):
    """ONNX pads (or ``auto_pad``) → per-spatial-dim (low, high) pairs, as
    the reference's ``_onnx_pads_to_lax``. They may be asymmetric."""
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for i in range(rank):
            eff_k = (k_shape[i] - 1) * dilations[i] + 1
            out_dim = -(-x_shape[i] // strides[i])
            total = max(0, (out_dim - 1) * strides[i] + eff_k - x_shape[i])
            lo = total // 2 if auto_pad == "SAME_UPPER" else (total + 1) // 2
            out.append((lo, total - lo))
        return out
    if pads is None:
        return [(0, 0)] * rank
    return [(pads[i], pads[i + rank]) for i in range(rank)]


def _pad_spatial(x: torch.Tensor, pads, value) -> torch.Tensor:
    """Pad the trailing ``len(pads)`` dims by (low, high) pairs."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat, mode="constant", value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register_op("Conv")
def _conv(node, inputs, ctx):
    x, w = _promoted(ctx, inputs[0], inputs[1])
    rank = w.ndim - 2
    if rank not in _CONV:
        raise UnsupportedOp(f"Conv rank {rank}")
    strides = node.attr("strides", [1] * rank)
    dilations = node.attr("dilations", [1] * rank)
    k_shape = node.attr("kernel_shape", list(w.shape[2:]))
    pads = _onnx_pads(node.attr("pads"), rank, node.attr("auto_pad", "NOTSET"),
                      x.shape[2:], k_shape, strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        # F.conv* pads symmetrically only: pad the input with zeros first
        x = _pad_spatial(x, pads, 0.0)
        padding = [0] * rank
    bias = None
    if len(inputs) > 2 and inputs[2] is not None:
        bias = _as_tensor(inputs[2], ctx)
    fused = bias is not None and bias.dtype == x.dtype and bias.ndim == 1
    out = _CONV[rank](x, w, bias if fused else None, stride=strides,
                      padding=padding, dilation=dilations,
                      groups=node.attr("group", 1))
    if bias is not None and not fused:
        out, b = _promoted(ctx, out, bias)
        out = out + b.reshape((1, -1) + (1,) * rank)
    return out


def _pool_geometry(node, x):
    """(kernel, strides, dilations, pads) of a pool node, with ``ceil_mode``
    growing the trailing pad exactly as the reference does (so windows
    that start in that pad exist, as XLA's reduce_window makes them)."""
    k = list(node.attr("kernel_shape"))
    rank = len(k)
    strides = list(node.attr("strides", [1] * rank))
    dilations = list(node.attr("dilations", [1] * rank))
    pads = _onnx_pads(node.attr("pads"), rank, node.attr("auto_pad", "NOTSET"),
                      x.shape[2:], k, strides, dilations)
    if node.attr("ceil_mode", 0):
        grown = []
        for i in range(rank):
            eff_k = (k[i] - 1) * dilations[i] + 1
            span = x.shape[2 + i] + pads[i][0] + pads[i][1] - eff_k
            rem = span % strides[i]
            grown.append((pads[i][0],
                          pads[i][1] + ((strides[i] - rem) if rem else 0)))
        pads = grown
    return k, strides, dilations, pads


@register_op("MaxPool")
def _maxpool(node, inputs, ctx):
    if len(node.output) > 1:
        raise UnsupportedOp("MaxPool with Indices output")
    x = _as_tensor(inputs[0], ctx)
    k, strides, dilations, pads = _pool_geometry(node, x)
    rank = len(k)
    if rank not in _MAXPOOL:
        raise UnsupportedOp(f"MaxPool rank {rank}")
    # F.max_pool* pads with -inf, symmetrically, up to half the window
    if all(lo == hi and 2 * lo <= (kk - 1) * d + 1
           for (lo, hi), kk, d in zip(pads, k, dilations)):
        padding = [lo for lo, _ in pads]
    else:
        x = _pad_spatial(x, pads, float("-inf"))
        padding = [0] * rank
    return _MAXPOOL[rank](x, k, stride=strides, padding=padding,
                          dilation=dilations)


def _window_sum(xp: torch.Tensor, k, strides, dilations) -> torch.Tensor:
    """Sum of every (dilated) window over the trailing ``len(k)`` dims of
    an already padded tensor, one strided slice per window offset."""
    rank = len(k)
    spatial = xp.shape[xp.ndim - rank:]
    out_len = [(n - ((kk - 1) * d + 1)) // s + 1
               for n, kk, d, s in zip(spatial, k, dilations, strides)]
    lead = [slice(None)] * (xp.ndim - rank)
    total = None
    for offs in itertools.product(*[range(kk) for kk in k]):
        sl = lead + [slice(o * d, o * d + (m - 1) * s + 1, s)
                     for o, d, s, m in zip(offs, dilations, strides, out_len)]
        part = xp[tuple(sl)]
        total = part if total is None else total + part
    return total


@register_op("AveragePool")
def _avgpool(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    k, strides, dilations, pads = _pool_geometry(node, x)
    # sums accumulate in float32 and round once
    xf = x.float()
    summed = _window_sum(_pad_spatial(xf, pads, 0.0), k, strides, dilations)
    # ONNX's default (and the reference's) is count_include_pad = 0
    if node.attr("count_include_pad", 0):
        return (summed / float(np.prod(k))).to(x.dtype)
    ones = torch.ones(tuple(x.shape[2:]), dtype=torch.float32,
                      device=x.device)
    counts = _window_sum(_pad_spatial(ones, pads, 0.0), k, strides,
                         dilations)
    return (summed / counts).to(x.dtype)


@register_op("GlobalAveragePool")
def _gap(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)


@register_op("GlobalMaxPool")
def _gmp(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)


# -- normalization -----------------------------------------------------------

@register_op("BatchNormalization")
def _batchnorm(node, inputs, ctx):
    x, scale, bias, mean = _promoted(ctx, *inputs[:4])
    var = _as_tensor(inputs[4], ctx)
    eps = node.attr("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var.float() + eps).to(x.dtype)
    return (x - mean.reshape(shape)) * (inv.reshape(shape)
                                        * scale.reshape(shape)) \
        + bias.reshape(shape)


@register_op("LayerNormalization")
def _layernorm(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    axis = node.attr("axis", -1)
    eps = node.attr("epsilon", 1e-5)
    if axis < 0:
        axis += x.ndim
    dims = tuple(range(axis, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, correction=0, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y, scale = _promoted(ctx, (x - mean) * inv, inputs[1])
    y = y * scale
    if len(inputs) > 2 and inputs[2] is not None:
        y, bias = _promoted(ctx, y, inputs[2])
        y = y + bias
    if len(node.output) > 1:
        return tuple([y, mean, inv][:len(node.output)])
    return y


@register_op("Softmax")
def _softmax(node, inputs, ctx):
    axis = node.attr("axis", -1 if ctx.opset >= 13 else 1)
    x = _as_tensor(inputs[0], ctx)
    if ctx.opset >= 13:
        return torch.softmax(x, dim=axis)
    # before opset 13 the input is coerced to 2-D at ``axis``
    lead = int(np.prod(x.shape[:axis]) or 1)
    return torch.softmax(x.reshape(lead, -1), dim=-1).reshape(x.shape)


@register_op("LogSoftmax")
def _logsoftmax(node, inputs, ctx):
    axis = node.attr("axis", -1 if ctx.opset >= 13 else 1)
    return torch.log_softmax(_as_tensor(inputs[0], ctx), dim=axis)


# -- reductions --------------------------------------------------------------

def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=True)
    return x if keepdim else x.squeeze(dim)


def _reduce(fn, axes_as_input_since: int):
    def h(node, inputs, ctx):
        x = _as_tensor(inputs[0], ctx)
        if ctx.opset >= axes_as_input_since and len(inputs) > 1 \
                and inputs[1] is not None:
            axes = tuple(int(a) for a in _concrete(inputs[1], "reduce axes"))
        else:
            a = node.attr("axes")
            axes = tuple(a) if a else None
        if axes == ():
            axes = None
        keepdims = bool(node.attr("keepdims", 1))
        if axes is None and node.attr("noop_with_empty_axes", 0):
            return x
        dims = tuple(range(x.ndim)) if axes is None else \
            tuple(a % x.ndim for a in axes)
        return fn(x, dims, keepdims)
    return h


OP_HANDLERS["ReduceSum"] = _reduce(
    lambda x, d, k: torch.sum(x, dim=d, keepdim=k), 13)
OP_HANDLERS["ReduceMean"] = _reduce(
    lambda x, d, k: torch.mean(_float(x), dim=d, keepdim=k), 18)
OP_HANDLERS["ReduceMax"] = _reduce(
    lambda x, d, k: torch.amax(x, dim=d, keepdim=k), 18)
OP_HANDLERS["ReduceMin"] = _reduce(
    lambda x, d, k: torch.amin(x, dim=d, keepdim=k), 18)
OP_HANDLERS["ReduceProd"] = _reduce(_prod, 18)
OP_HANDLERS["ReduceL1"] = _reduce(
    lambda x, d, k: torch.sum(torch.abs(x), dim=d, keepdim=k), 18)
OP_HANDLERS["ReduceL2"] = _reduce(
    lambda x, d, k: torch.sqrt(torch.sum(x * x, dim=d, keepdim=k)), 18)
OP_HANDLERS["ReduceSumSquare"] = _reduce(
    lambda x, d, k: torch.sum(x * x, dim=d, keepdim=k), 18)
OP_HANDLERS["ReduceLogSumExp"] = _reduce(
    lambda x, d, k: torch.logsumexp(_float(x), dim=d, keepdim=k), 18)


def _arg(fn):
    def h(node, inputs, ctx):
        return fn(_as_tensor(inputs[0], ctx), dim=node.attr("axis", 0),
                  keepdim=bool(node.attr("keepdims", 1)))
    return h


OP_HANDLERS["ArgMax"] = _arg(torch.argmax)
OP_HANDLERS["ArgMin"] = _arg(torch.argmin)


# -- shape ops ---------------------------------------------------------------

@register_op("Shape")
def _shape(node, inputs, ctx):
    shape = np.asarray(tuple(inputs[0].shape), dtype=np.int64)
    start = node.attr("start", 0)
    end = node.attr("end")
    return shape[start:end if end is not None else len(shape)]


@register_op("Size")
def _size(node, inputs, ctx):
    return np.asarray(int(np.prod(inputs[0].shape)), dtype=np.int64)


@register_op("Reshape")
def _reshape(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    target = [int(d) for d in _concrete(inputs[1], "Reshape shape").ravel()]
    if not node.attr("allowzero", 0):
        target = [x.shape[i] if d == 0 else d for i, d in enumerate(target)]
    return x.reshape(target)


@register_op("Flatten")
def _flatten(node, inputs, ctx):
    axis = node.attr("axis", 1)
    x = _as_tensor(inputs[0], ctx)
    if axis < 0:
        axis += x.ndim
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


@register_op("Transpose")
def _transpose(node, inputs, ctx):
    perm = node.attr("perm")
    x = _as_tensor(inputs[0], ctx)
    return x.permute(*(perm if perm else reversed(range(x.ndim))))


@register_op("Squeeze")
def _squeeze(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    if ctx.opset >= 13 and len(inputs) > 1 and inputs[1] is not None:
        axes = tuple(int(a) for a in _concrete(inputs[1], "Squeeze axes"))
    else:
        a = node.attr("axes")
        axes = tuple(a) if a else None
    if axes is None:
        return x.squeeze()
    return x.squeeze(tuple(a % x.ndim for a in axes))


@register_op("Unsqueeze")
def _unsqueeze(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    if ctx.opset >= 13 and len(inputs) > 1 and inputs[1] is not None:
        axes = [int(a) for a in _concrete(inputs[1], "Unsqueeze axes")]
    else:
        axes = list(node.attr("axes"))
    out_rank = x.ndim + len(axes)
    for a in sorted(a + out_rank if a < 0 else a for a in axes):
        x = x.unsqueeze(a)
    return x


@register_op("Concat")
def _concat(node, inputs, ctx):
    return torch.cat(_promoted(ctx, *inputs), dim=node.attr("axis"))


@register_op("Split")
def _split(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    axis = node.attr("axis", 0)
    if len(inputs) > 1 and inputs[1] is not None:
        sizes = [int(s) for s in _concrete(inputs[1], "Split sizes")]
    elif node.attr("split"):
        sizes = list(node.attr("split"))
    else:
        n_out = node.attr("num_outputs", len(node.output))
        dim = x.shape[axis]
        base = -(-dim // n_out)
        sizes = [base] * (n_out - 1) + [dim - base * (n_out - 1)]
    return tuple(torch.split(x, sizes, dim=axis))


def _slice_axis(x: torch.Tensor, axis: int, sl: slice) -> torch.Tensor:
    """``x`` sliced along ``axis`` with Python slice semantics; a negative
    step (which tensor indexing lacks) reads the flipped axis."""
    n = x.shape[axis]
    start, stop, step = sl.indices(n)
    if step > 0:
        return x[(slice(None),) * axis + (slice(start, stop, step),)]
    # the elements start, start + step, ... above stop, read backwards
    flipped = x.flip(axis)
    return flipped[(slice(None),) * axis
                   + (slice(n - 1 - start, n - 1 - stop, -step),)]


@register_op("Slice")
def _slice(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    if ctx.opset >= 10:
        starts = [int(v) for v in _concrete(inputs[1], "Slice starts")]
        ends = [int(v) for v in _concrete(inputs[2], "Slice ends")]
        axes = ([int(v) for v in _concrete(inputs[3], "Slice axes")]
                if len(inputs) > 3 and inputs[3] is not None
                else list(range(len(starts))))
        steps = ([int(v) for v in _concrete(inputs[4], "Slice steps")]
                 if len(inputs) > 4 and inputs[4] is not None
                 else [1] * len(starts))
    else:
        starts = list(node.attr("starts"))
        ends = list(node.attr("ends"))
        axes = list(node.attr("axes", range(len(starts))))
        steps = [1] * len(starts)
    int_max = np.iinfo(np.int64).max
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        en_val = None if en >= int_max // 2 else \
            (None if sp < 0 and en == -int_max - 1 else en)
        x = _slice_axis(x, ax % x.ndim, slice(st, en_val, sp))
    return x


@register_op("Gather")
def _gather(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    axis = node.attr("axis", 0) % x.ndim
    dim = x.shape[axis]
    idx = inputs[1]
    if _is_host(idx):
        idx = np.asarray(idx, dtype=np.int64)
        idx = _as_tensor(np.where(idx < 0, idx + dim, idx), ctx)
    else:
        idx = idx.long()
        idx = torch.where(idx < 0, idx + dim, idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


@register_op("Expand")
def _expand(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    shape = [int(d) for d in _concrete(inputs[1], "Expand shape")]
    # ONNX Expand broadcasts: dims of 1 broadcast, and the input may have
    # more dims than the target
    return torch.broadcast_to(x, np.broadcast_shapes(tuple(x.shape),
                                                     tuple(shape)))


@register_op("Tile")
def _tile(node, inputs, ctx):
    reps = [int(r) for r in _concrete(inputs[1], "Tile repeats")]
    return torch.tile(_as_tensor(inputs[0], ctx), reps)


@register_op("Pad")
def _pad(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    mode = node.attr("mode", "constant")
    if ctx.opset >= 11:
        pads = [int(p) for p in _concrete(inputs[1], "Pad pads")]
        cval = (float(np.asarray(_concrete(inputs[2], "Pad value")).ravel()[0])
                if len(inputs) > 2 and inputs[2] is not None else 0.0)
        axes = ([int(a) for a in _concrete(inputs[3], "Pad axes")]
                if len(inputs) > 3 and inputs[3] is not None
                else list(range(x.ndim)))
    else:
        pads = list(node.attr("pads"))
        cval = node.attr("value", 0.0)
        axes = list(range(x.ndim))
    half = len(pads) // 2
    widths = [(0, 0)] * x.ndim
    for i, ax in enumerate(axes):
        widths[ax % x.ndim] = (pads[i], pads[i + half])
    np_mode = {"constant": "constant", "reflect": "reflect", "edge": "edge",
               "wrap": "wrap"}[mode]
    if np_mode == "constant":
        return _pad_spatial(x, widths, cval)
    # reflect / edge / wrap: one gather per padded axis, its source
    # positions given by numpy's own padding of an index ramp
    for ax, (lo, hi) in enumerate(widths):
        if lo or hi:
            src = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=np_mode)
            x = torch.index_select(x, ax, _as_tensor(src, ctx))
    return x


@register_op("Constant")
def _constant(node, inputs, ctx):
    for key in ("value", "value_float", "value_int", "value_floats",
                "value_ints", "value_string", "value_strings"):
        v = node.attr(key)
        if v is not None:
            return np.asarray(v) if not isinstance(v, np.ndarray) else v
    raise ValueError(f"Constant node {node.name} has no value")


@register_op("ConstantOfShape")
def _constant_of_shape(node, inputs, ctx):
    shape = [int(d) for d in _concrete(inputs[0], "ConstantOfShape shape")]
    value = node.attr("value")
    if value is None:
        return np.zeros(shape, dtype=np.float32)
    value = np.asarray(value)
    return np.full(shape, value.ravel()[0], dtype=value.dtype)


@register_op("Range")
def _range(node, inputs, ctx):
    s, lim, d = (np.asarray(_concrete(v, "Range args")).ravel()[0]
                 for v in inputs)
    return np.arange(s, lim, d)


# -- the host table: nodes whose inputs are all numpy ------------------------

def _np_slice(node, inputs, ctx):
    x = inputs[0]
    starts = [int(v) for v in np.ravel(inputs[1])]
    ends = [int(v) for v in np.ravel(inputs[2])]
    axes = ([int(v) for v in np.ravel(inputs[3])]
            if len(inputs) > 3 and inputs[3] is not None
            else list(range(len(starts))))
    steps = ([int(v) for v in np.ravel(inputs[4])]
             if len(inputs) > 4 and inputs[4] is not None
             else [1] * len(starts))
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[ax] = slice(st, None if abs(en) >= np.iinfo(np.int64).max // 2
                       else en, sp)
    return x[tuple(sl)]


def _np_unsqueeze(node, inputs, ctx):
    x = inputs[0]
    axes = ([int(a) for a in np.ravel(inputs[1])] if len(inputs) > 1
            and inputs[1] is not None else list(node.attr("axes")))
    out_rank = x.ndim + len(axes)
    for a in sorted(a + out_rank if a < 0 else a for a in axes):
        x = np.expand_dims(x, a)
    return x


def _np_squeeze(node, inputs, ctx):
    x = inputs[0]
    axes = ([int(a) for a in np.ravel(inputs[1])] if len(inputs) > 1
            and inputs[1] is not None else node.attr("axes"))
    return np.squeeze(x, axis=tuple(axes) if axes else None)


NUMPY_OPS: Dict[str, Callable] = {
    "Add": lambda n, i, c: i[0] + i[1],
    "Sub": lambda n, i, c: i[0] - i[1],
    "Mul": lambda n, i, c: i[0] * i[1],
    "Div": lambda n, i, c: (np.trunc(i[0] / i[1]).astype(i[0].dtype)
                            if i[0].dtype.kind in "iu" else i[0] / i[1]),
    "Mod": lambda n, i, c: (np.fmod(i[0], i[1]) if n.attr("fmod", 0)
                            else np.mod(i[0], i[1])),
    "Neg": lambda n, i, c: -i[0],
    "Abs": lambda n, i, c: np.abs(i[0]),
    "Min": lambda n, i, c: np.minimum.reduce(i),
    "Max": lambda n, i, c: np.maximum.reduce(i),
    "Equal": lambda n, i, c: i[0] == i[1],
    "Greater": lambda n, i, c: i[0] > i[1],
    "Less": lambda n, i, c: i[0] < i[1],
    "Where": lambda n, i, c: np.where(i[0], i[1], i[2]),
    "Cast": lambda n, i, c: i[0].astype(ONNX_TO_NUMPY[n.attr("to")]),
    "Concat": lambda n, i, c: np.concatenate(i, axis=n.attr("axis")),
    "Gather": lambda n, i, c: np.take(i[0], i[1], axis=n.attr("axis", 0)),
    "Reshape": lambda n, i, c: i[0].reshape(
        [i[0].shape[k] if d == 0 and not n.attr("allowzero", 0) else d
         for k, d in enumerate(int(x) for x in np.ravel(i[1]))]),
    "Transpose": lambda n, i, c: np.transpose(
        i[0], n.attr("perm") or tuple(reversed(range(i[0].ndim)))),
    "ReduceProd": lambda n, i, c: np.prod(
        i[0], axis=tuple(n.attr("axes")) if n.attr("axes") else None,
        keepdims=bool(n.attr("keepdims", 1))),
    "ReduceSum": lambda n, i, c: np.sum(
        i[0],
        axis=(tuple(int(a) for a in np.ravel(i[1]))
              if c.opset >= 13 and len(i) > 1 and i[1] is not None
              else (tuple(n.attr("axes")) if n.attr("axes") else None)),
        keepdims=bool(n.attr("keepdims", 1))),
    "Slice": _np_slice,
    "Unsqueeze": _np_unsqueeze,
    "Squeeze": _np_squeeze,
    "Identity": lambda n, i, c: i[0],
    "Floor": lambda n, i, c: np.floor(i[0]),
    "Ceil": lambda n, i, c: np.ceil(i[0]),
    "Sqrt": lambda n, i, c: np.sqrt(i[0]),
    "Expand": lambda n, i, c: np.broadcast_to(
        i[0], np.broadcast_shapes(i[0].shape,
                                  tuple(int(d) for d in np.ravel(i[1])))),
    "Tile": lambda n, i, c: np.tile(i[0], [int(r) for r in np.ravel(i[1])]),
    "Range": lambda n, i, c: np.arange(np.ravel(i[0])[0], np.ravel(i[1])[0],
                                       np.ravel(i[2])[0]),
}


def _to_host(out):
    if isinstance(out, tuple):
        return tuple(_to_host(o) for o in out)
    return out.numpy() if isinstance(out, torch.Tensor) else out


def _eval_nodes(nodes, env: Dict[str, object], ctx: _Ctx) -> None:
    """Walk a node list, writing outputs into ``env``."""
    for node in nodes:
        ins = [env[i] if i else None for i in node.input]
        host = any(v is not None for v in ins) and all(
            v is None or _is_host(v) for v in ins)
        np_handler = NUMPY_OPS.get(node.op_type)
        if host and np_handler is not None:
            out = np_handler(node, ins, ctx)
        else:
            handler = OP_HANDLERS.get(node.op_type)
            if handler is None:
                raise UnsupportedOp(
                    f"ONNX op {node.op_type!r} (node {node.name!r}) is not "
                    f"ported to PyTorch yet; {len(OP_HANDLERS)} ops are "
                    f"(ROADMAP queue items 2-3)")
            if host:
                # constants only: fold on the host, keep the result there
                out = _to_host(handler(node, ins,
                                       _Ctx(ctx.opset, torch.device("cpu"))))
            else:
                out = handler(node, ins, ctx)
        if isinstance(out, tuple):
            for name, val in zip(node.output, out):
                if name:
                    env[name] = val
        else:
            env[node.output[0]] = out


class ConvertedModel:
    """An ONNX graph as a PyTorch callable.

    ``fn(params, feeds)`` returns ``{output_name: tensor}``; ``params`` is
    the float initializer dict (numpy here; callers pass it placed and
    cast), so callers can cast it independently. Integer, bool and 0-d
    initializers are shape constants, axes and indices: they stay numpy in
    ``const_params`` and fold on the host.
    """

    def __init__(self, model: ModelProto):
        self.model = model
        g = model.graph
        all_inits = {t.name: tensor_to_numpy(t) for t in g.initializers}
        self.const_params: Dict[str, np.ndarray] = {
            k: v for k, v in all_inits.items()
            if v.dtype.kind in "iub" or v.ndim == 0}
        self.params: Dict[str, np.ndarray] = {
            k: v for k, v in all_inits.items() if k not in self.const_params}
        init_names = set(all_inits)
        self.inputs: List[ValueInfo] = [vi for vi in g.inputs
                                        if vi.name not in init_names]
        self.outputs: List[ValueInfo] = list(g.outputs)
        self.input_names = [vi.name for vi in self.inputs]
        self.output_names = [vi.name for vi in self.outputs]

    def __call__(self, params: Dict[str, object],
                 feeds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Run the graph on the device of its tensors (feeds first, then
        params); numpy params or feeds are copied there."""
        device = next((v.device for v in list(feeds.values())
                       + list(params.values())
                       if isinstance(v, torch.Tensor)), None)
        if device is None:
            raise ValueError("pass at least one feed or param as a tensor on "
                             "the device to run on")
        ctx = _Ctx(self.model.opset, device)
        env: Dict[str, object] = dict(self.const_params)
        for name, val in params.items():
            env[name] = _as_tensor(val, ctx)
        for name, val in feeds.items():
            env[name] = _as_tensor(val, ctx)
        env[""] = None
        _eval_nodes(self.model.graph.nodes, env, ctx)
        missing = [o for o in self.output_names if o not in env]
        if missing:
            raise ValueError(f"graph did not produce outputs {missing}")
        return {o: _as_tensor(env[o], ctx) for o in self.output_names}

    def pruned(self, outputs: List[str]) -> "ConvertedModel":
        """Dead-node-eliminated view computing only ``outputs``.

        A training graph serves inference by requesting just the prediction
        outputs: the loss node becomes dead, and with it the labels input
        disappears from ``input_names``. The ancestor walk covers
        control-flow subgraph captures (If/Loop/Scan bodies read
        outer-scope names), though no such op is ported yet.
        """
        unknown = [o for o in outputs if o not in
                   {n for node in self.model.graph.nodes for n in node.output}
                   | set(self.input_names) | set(self.const_params)
                   | set(self.params)]
        if unknown:
            raise ValueError(f"pruned(): unknown outputs {unknown}")

        def node_reads(node) -> set:
            names = {i for i in node.input if i}
            for a in node.attributes.values():
                for sub in ([a.g] if a.g is not None else []) + list(a.graphs):
                    produced = {n for sn in sub.nodes for n in sn.output}
                    produced |= {vi.name for vi in sub.inputs}
                    produced |= {t.name for t in sub.initializers}
                    for sn in sub.nodes:
                        names |= node_reads(sn) - produced
            return names

        producer = {}
        for node in self.model.graph.nodes:
            for out in node.output:
                if out:
                    producer[out] = node
        seen_ids: set = set()
        stack = list(outputs)
        visited_names: set = set()
        while stack:
            name = stack.pop()
            if name in visited_names:
                continue
            visited_names.add(name)
            node = producer.get(name)
            if node is None or id(node) in seen_ids:
                continue
            seen_ids.add(id(node))
            stack.extend(node_reads(node))

        clone = copy.copy(self)
        clone.model = copy.copy(self.model)
        clone.model.graph = copy.copy(self.model.graph)
        clone.model.graph.nodes = [n for n in self.model.graph.nodes
                                   if id(n) in seen_ids]   # original order
        clone.outputs = [vi for vi in self.outputs if vi.name in outputs]
        clone.output_names = list(outputs)
        used = visited_names
        clone.inputs = [vi for vi in self.inputs if vi.name in used]
        clone.input_names = [vi.name for vi in clone.inputs]
        clone.const_params = {k: v for k, v in self.const_params.items()
                              if k in used}
        clone.params = {k: v for k, v in self.params.items() if k in used}
        return clone


def convert_model(model_bytes: bytes) -> ConvertedModel:
    return ConvertedModel(parse_model(model_bytes))
