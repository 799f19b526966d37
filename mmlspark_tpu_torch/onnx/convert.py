"""ONNX graph → PyTorch function (counterpart of
``mmlspark_tpu/onnx/convert.py``).

The JAX package turns a graph into a function XLA compiles; the port runs
the same graph eagerly, one PyTorch op per node, on the device its feeds
live on. What the JAX package left to XLA becomes ordinary PyTorch ops:
``Conv`` is ``F.conv2d`` (cuDNN), ``Gemm``/``MatMul`` are ``torch.matmul``
(cuBLAS), pools are ``F.max_pool2d`` or windowed sums. The one Pallas
consumer of the reference converter, ``_attention_core`` (behind the fused
``Attention``, ``MultiHeadAttention``, ai.onnx ``Attention`` and
``GroupQueryAttention`` prefill), runs the hand-written flash kernel K7
(``ops/flash_attention.py``) on CUDA tensors where the reference runs its
flash kernel, and raises there where K7 has no instantiation; it runs the
reference's dense branch where the reference does (host tensors, Sq !=
Sk, a pair mask). ``dense_on_cuda`` counts the dense calls on the card by
reason.

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

Ported handlers: the elementwise, unary and comparison tables, the
activations (``LeakyRelu`` ... ``ThresholdedRelu``, ``PRelu``), ``Clip``,
``Dropout``, ``Cast``, ``CastLike``, ``BitShift``, ``Where``, ``MatMul``,
``Gemm``, ``Einsum``, ``Conv``, ``ConvTranspose``, ``FusedConv``, the
pools, the normalizations (batch, layer, instance, group, Lp), ``Softmax``,
``LogSoftmax``, the reductions, ``ArgMax``/``ArgMin``, ``TopK``, the shape,
indexing and data-movement ops, ``Resize``/``Upsample`` (the reference's
``jax.image.resize``), the quantized ops (``QuantizeLinear``,
``DequantizeLinear`` and the QLinear family, integer accumulation exact in
float64 on the tensors' device), detection (``NonMaxSuppression`` on the
host, as in the reference; ``RoiAlign``, ``GridSample``), control flow
(``If``, ``Loop``, ``Scan``; bodies through :meth:`_Ctx.run_subgraph`),
the ``LSTM`` and ``GRU`` cells, and the transformer ops of ORT's optimizer:
the Gelu family (``Gelu``, ``BiasGelu``, ``FastGelu``, ``QuickGelu``),
``FusedMatMul``, the LayerNorm and RMSNorm contrib ops, rotary
embeddings, the four attention ops and ``RelativePositionBias``; and,
from ``ml_ops.py``, the 16 handlers of the JAX package's ``ml_ops.py``
(tree ensembles, linear models, SVMs, preprocessing, ``Hardmax``,
``ScatterElements``); from ``extra_ops.py``, its 26 (DSP, the integer ops
exact in float64, ``RNN``, losses, pools, bitwise, ``Det``, ``Random*``);
from ``generation_ops.py``, ORT's ``GreedySearch`` and ``BeamSearch``. The
port registers every handler of the JAX converter; any other op raises
:class:`UnsupportedOp`.
"""

from __future__ import annotations

import collections
import copy
import functools
import itertools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import HEAD_DIMS, flash_attention
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
    """Per-call evaluation context: the opset, the device that tensors
    made from host values go to, and the environment of the graph being
    evaluated (control-flow bodies read outer-scope names from it)."""

    def __init__(self, opset: int, device: torch.device,
                 scope_env: Optional[Dict[str, object]] = None):
        self.opset = opset
        self.device = device
        self.scope_env = scope_env

    def run_subgraph(self, graph, inputs: List) -> List:
        """Evaluate a body graph (If/Loop/Scan): the outer scope, then the
        body's initializers, then ``inputs`` bound positionally to
        ``graph.inputs`` (a bound input wins over an initializer of the
        same name, as feeds win over initializers at the top level)."""
        env: Dict[str, object] = dict(self.scope_env or {})
        for t in graph.initializers:
            env[t.name] = tensor_to_numpy(t)
        for vi, val in zip(graph.inputs, inputs):
            env[vi.name] = val
        env[""] = None
        _eval_nodes(graph.nodes, env, self)
        return [env[o.name] for o in graph.outputs]


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


@register_op("Einsum")
def _einsum(node, inputs, ctx):
    return torch.einsum(node.attr("equation"), *_promoted(ctx, *inputs))


# -- the Gelu family and FusedMatMul (ORT transformer-optimizer output) ------
# Real BERT-class deployments ship through onnxruntime's transformer
# optimizer, which fuses subgraphs into com.microsoft contrib ops. Dispatch
# is by op type, domain-agnostic, except where a standard op shares the
# name (``Attention``, ``RotaryEmbedding``).

def _opt(inputs, i: int):
    """Input ``i`` of a node, or None where it is absent or empty."""
    return inputs[i] if len(inputs) > i else None


def _opt_tensor(inputs, i: int, ctx: _Ctx):
    v = _opt(inputs, i)
    return None if v is None else _as_tensor(v, ctx)


def _gelu(x: torch.Tensor, tanh: bool) -> torch.Tensor:
    # torch's default is the erf form; jax.nn.gelu's is tanh
    return F.gelu(_float(x), approximate="tanh" if tanh else "none")


@register_op("Gelu")
def _gelu_op(node, inputs, ctx):
    # ai.onnx Gelu (opset 20): erf unless approximate="tanh"
    return _gelu(_as_tensor(inputs[0], ctx),
                 node.attr("approximate", "none") == "tanh")


@register_op("FusedMatMul")
def _fused_matmul(node, inputs, ctx):
    if node.attr("transBatchA", 0) or node.attr("transBatchB", 0):
        # batch-dim transpose is a different permutation than transA/transB;
        # silently ignoring it would multiply the wrong operands
        raise UnsupportedOp("FusedMatMul with transBatchA/transBatchB")
    a, b = _promoted(ctx, inputs[0], inputs[1])
    if node.attr("transA", 0):
        a = a.transpose(-1, -2)
    if node.attr("transB", 0):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b) * node.attr("alpha", 1.0)


@register_op("BiasGelu")
def _bias_gelu(node, inputs, ctx):
    x, b = _promoted(ctx, inputs[0], inputs[1])
    return _gelu(x + b, tanh=False)


@register_op("FastGelu")
def _fast_gelu(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    if _opt(inputs, 1) is not None:
        x, b = _promoted(ctx, x, inputs[1])
        x = x + b
    return _gelu(x, tanh=True)


@register_op("QuickGelu")
def _quick_gelu(node, inputs, ctx):
    x = _float(_as_tensor(inputs[0], ctx))
    return x * torch.sigmoid(node.attr("alpha", 1.702) * x)


# -- LayerNorm / RMSNorm contrib ops ------------------------------------------

def _layernorm_last(x, gamma, beta, eps):
    """LayerNorm over the last axis with f32 statistics, cast back to
    ``x``'s dtype → (y, mean, inv_std), the stats f32 with a kept axis."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, correction=0, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = (xf - mu) * inv * gamma
    if beta is not None:
        y = y + beta
    return y.to(x.dtype), mu, inv


def _skip_sum(ctx, x, skip, bias):
    total = functools.reduce(torch.add, _promoted(ctx, x, skip))
    if bias is not None:
        total = functools.reduce(torch.add, _promoted(ctx, total, bias))
    return total


@register_op("SkipLayerNormalization")
def _skip_layernorm(node, inputs, ctx):
    total = _skip_sum(ctx, inputs[0], inputs[1], _opt(inputs, 4))
    y, mu, inv = _layernorm_last(total, _as_tensor(inputs[2], ctx),
                                 _opt_tensor(inputs, 3, ctx),
                                 node.attr("epsilon", 1e-12))
    # ONNX's order: out, (mean), (inv_std_var), (input_skip_bias_sum)
    return y, mu[..., 0], inv[..., 0], total


@register_op("EmbedLayerNormalization")
def _embed_layernorm(node, inputs, ctx):
    ids = _as_tensor(inputs[0], ctx)
    seg_ids, seg_emb = _opt(inputs, 1), _opt(inputs, 4)
    mask, pos_ids = _opt_tensor(inputs, 7, ctx), _opt(inputs, 8)
    word, pos = _promoted(ctx, inputs[2], inputs[3])
    B, S = ids.shape
    x = word[ids.long()]
    if pos_ids is None:
        x = x + pos[:S][None, :, :]
    else:
        x = x + pos[_as_tensor(pos_ids, ctx).long()]
    if seg_emb is not None and seg_ids is not None:
        x, seg = _promoted(ctx, x, seg_emb)
        x = x + seg[_as_tensor(seg_ids, ctx).long()]
    y, _mu, _inv = _layernorm_last(x, _opt_tensor(inputs, 5, ctx),
                                   _opt_tensor(inputs, 6, ctx),
                                   node.attr("epsilon", 1e-12))
    if mask is not None:
        mask_index = mask.to(torch.int32).sum(1, dtype=torch.int32)
    else:
        mask_index = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return y, mask_index, x


def _rms_norm(x, gamma, eps):
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv * gamma).to(x.dtype), inv


def _last_axis_only(node, x, what):
    if node.attr("axis", -1) not in (-1, x.dim() - 1):
        raise UnsupportedOp(f"{what} over a non-last axis")


@register_op("SimplifiedLayerNormalization")
def _simplified_layernorm(node, inputs, ctx):
    # RMS norm (the Llama-family normalization; ORT emits this contrib op)
    x = _as_tensor(inputs[0], ctx)
    _last_axis_only(node, x, "SimplifiedLayerNormalization")
    return _rms_norm(x, _as_tensor(inputs[1], ctx),
                     node.attr("epsilon", 1e-6))[0]


@register_op("RMSNormalization")
def _rms_normalization(node, inputs, ctx):
    # standard ai.onnx RMSNormalization (opset 23) — same math
    x = _as_tensor(inputs[0], ctx)
    _last_axis_only(node, x, "RMSNormalization")
    return _rms_norm(x, _as_tensor(inputs[1], ctx),
                     node.attr("epsilon", 1e-5))[0]


@register_op("SkipSimplifiedLayerNormalization")
def _skip_simplified_layernorm(node, inputs, ctx):
    if len(node.output) > 1 and node.output[1]:
        # RMS norm has no mean; a consumer of output 1 would receive None
        raise UnsupportedOp("SkipSimplifiedLayerNormalization mean output")
    total = _skip_sum(ctx, inputs[0], inputs[1], _opt(inputs, 3))
    y, inv = _rms_norm(total, _as_tensor(inputs[2], ctx),
                       node.attr("epsilon", 1e-12))
    return y, None, inv[..., 0], total


# -- rotary embeddings --------------------------------------------------------

def _rope_rotate(xr, cos, sin, interleaved):
    """The rotation core shared by RotaryEmbedding and fused-attention
    rotary: ``xr`` (..., rot_dim) with broadcastable half-dim cos/sin."""
    if interleaved:
        x0, x1 = xr[..., 0::2], xr[..., 1::2]
        return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                           dim=-1).reshape(xr.shape)
    half = xr.shape[-1] // 2
    x0, x1 = xr[..., :half], xr[..., half:]
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)


def _apply_rope4(x, pos, cos_cache, sin_cache, interleaved):
    """Rotate the first ``2 * cos_cache.shape[-1]`` lanes of a (B, nh, S,
    D) tensor at absolute positions ``pos`` (B, S)."""
    rot_dim = 2 * cos_cache.shape[-1]
    cos = cos_cache[pos.long()][:, None]                   # (B, 1, S, rd/2)
    sin = sin_cache[pos.long()][:, None]
    return torch.cat([_rope_rotate(x[..., :rot_dim], cos, sin, interleaved),
                      x[..., rot_dim:]], dim=-1)



@register_op("RotaryEmbedding")
def _rotary_embedding(node, inputs, ctx):
    """(B, S, H) or (B, heads, S, D) input with position ids and half-dim
    cos/sin caches; ``interleaved`` pairs adjacent lanes, else the halves
    rotate."""
    if node.domain == "com.microsoft":
        x, pos_ids, cos_cache, sin_cache = inputs[:4]
    else:
        # standard ai.onnx RotaryEmbedding (opset 23) orders the caches
        # before position_ids
        x, cos_cache, sin_cache = inputs[:3]
        pos_ids = _opt(inputs, 3)
        if pos_ids is None:
            raise UnsupportedOp("RotaryEmbedding without position_ids")
    x = _as_tensor(x, ctx)
    pos_ids = _as_tensor(pos_ids, ctx)
    cos_cache, sin_cache = _promoted(ctx, cos_cache, sin_cache)
    orig_rank = x.dim()
    if orig_rank == 3:
        heads = node.attr("num_heads", 0)
        if not heads:
            raise UnsupportedOp("RotaryEmbedding 3-D input without num_heads")
        B, S, H = x.shape
        x = x.reshape(B, S, heads, H // heads).transpose(1, 2)
    B, NH, S, D = x.shape
    if pos_ids.dim() == 1 and pos_ids.shape[0] == 1:
        # spec: shape (1) is a per-sequence OFFSET — position s rotates at
        # pos_ids[0] + s (the decode-phase form), not a constant position
        pos_ids = (pos_ids[0] + torch.arange(S, device=x.device))[None, :]
        pos_ids = pos_ids.expand(B, S)
    elif pos_ids.dim() != 2:
        raise UnsupportedOp(
            f"RotaryEmbedding position_ids shape {tuple(pos_ids.shape)}")
    out = _apply_rope4(x, pos_ids, cos_cache, sin_cache,
                     bool(node.attr("interleaved", 0)))
    if orig_rank == 3:
        out = out.transpose(1, 2).reshape(B, S, NH * D)
    return out


# -- attention ----------------------------------------------------------------

_NEG = -1e30

#: dense ``_attention_core`` calls made on CUDA tensors since the last
#: reset, by the reason K7 did not take them (see :func:`_k7_route`)
dense_on_cuda: collections.Counter = collections.Counter()


def _decode_mask_index(mask_index, B, S, op_name):
    """ORT mask forms shared by Attention/MultiHeadAttention: (B, S) 0/1
    mask or (B,) right-pad lengths → (B, S) bool."""
    if mask_index is None:
        return None
    if mask_index.dim() == 2:
        return mask_index != 0
    if mask_index.dim() == 1 and mask_index.shape[0] == B:
        return (torch.arange(S, device=mask_index.device)[None, :]
                < mask_index.to(torch.int32)[:, None])
    raise UnsupportedOp(f"{op_name} mask_index shape "
                        f"{tuple(mask_index.shape)}")


def _attn_scale(node, head_size):
    """ORT reads GetAttrOrDefault("scale", 0.0f) and substitutes
    1/sqrt(head_size) when the stored value is 0 — so an explicitly
    serialized scale=0.0 means "unset", not "zero the logits"."""
    s = node.attr("scale", 0.0)
    return float(s) if s else 1.0 / float(head_size) ** 0.5


def _k7_route(q, k, v, pair_mask) -> Optional[str]:
    """None when K7 takes this attention, else the reason it does not.

    The reference takes its flash kernel on a TPU when ``Sq == Sk`` and
    there is no pair mask; the port takes K7 on CUDA tensors under the
    same rule. CPU tensors ("host"), "sq != sk" and a "pair mask" run
    dense, as in the reference. "head dim" (not in ``HEAD_DIMS``, or v's
    unlike q's) and "dtype" (not float32 or bfloat16) name an attention
    K7 has no instantiation for, which :func:`_attention_core` refuses."""
    if q.device.type != "cuda":
        return "host"
    if q.shape[2] != k.shape[2]:
        return "sq != sk"
    if pair_mask is not None:
        return "pair mask"
    if q.shape[-1] not in HEAD_DIMS or v.shape[-1] != q.shape[-1]:
        return "head dim"
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        return "dtype"
    return None


def _k7_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as K7 takes it: the heads an
    op splits off are transposed views, so this copies them."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _attention_core(q, k, v, kv_mask, causal, scale, pair_mask=None):
    """(B, H, S, D) attention shared by the fused ops: K7 (the hand-written
    flash kernel) where :func:`_k7_route` takes it, the dense branch where
    the reference runs dense too (host tensors, Sq != Sk, a pair mask).
    ``pair_mask`` is an optional (Sq, Sk) boolean mask (the ai.onnx 2-D
    form, trailing-dim aligned). Dense calls on CUDA tensors count in
    ``dense_on_cuda`` by reason; an attention the reference would give its
    flash kernel but K7 has no instantiation for raises."""
    reason = _k7_route(q, k, v, pair_mask)
    if reason is None:
        return flash_attention(_k7_operand(q), _k7_operand(k),
                               _k7_operand(v), causal=causal,
                               kv_mask=kv_mask, scale=scale)
    if reason in ("head dim", "dtype"):
        raise NotImplementedError(
            f"K7 has no instantiation for this attention ({reason}: q "
            f"{tuple(q.shape)} {q.dtype}, v {tuple(v.shape)} {v.dtype}); "
            f"see ROADMAP.md section 2, second pass 6")
    if q.device.type == "cuda":
        dense_on_cuda[reason] += 1
    mask = _qk_valid_mask(q.shape[2], k.shape[2], kv_mask, causal, q.device)
    if pair_mask is not None:
        mask = mask & pair_mask
    return _dense_masked_attn(q, k, v, mask, scale)


def _qk_valid_mask(Sq, Sk, kv_mask, causal, device):
    """(1|B, 1, Sq, Sk) boolean validity mask from the shared ORT
    conventions: optional (B, Sk) key-padding mask, causal diagonal
    end-aligned to the key sequence: query i sees keys j <= i + (Sk - Sq)
    when the lengths differ."""
    mask = torch.ones((1, 1, Sq, Sk), dtype=torch.bool, device=device)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :]
    if causal:
        mask = mask & torch.ones((Sq, Sk), dtype=torch.bool,
                                 device=device).tril(Sk - Sq)[None, None]
    return mask


def _dense_masked_attn(q, k, v, mask, scale, softcap=0.0,
                       smooth_softmax=False, bias=None):
    """(B, Hq, Sq, D) × (B, Hkv, Sk, D) attention with a (B, 1|H, Sq, Sk)
    boolean mask, optional logit softcapping, optional ORT smooth-softmax
    (an implicit extra zero logit in the denominator) and an optional
    additive bias — the decode-phase path, where Sq is tiny.

    GQA (Hkv < Hq) runs grouped over (group, rep) head axes: the KV cache
    is never repeated ``rep`` times."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    qg = q.reshape(B, Hkv, rep, Sq, D).float()
    s = (qg @ k.float()[:, :, None].transpose(-1, -2)) * scale
    Sk = s.shape[-1]
    if bias is not None:
        # additive attention_bias (B|1, H|1, Sq, Sk), ORT semantics: added
        # to the scaled scores before masking/softmax
        bb = torch.broadcast_to(bias, (bias.shape[0], Hq, Sq, Sk))
        s = s + bb.reshape(bias.shape[0], Hkv, rep, Sq, Sk).float()
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if mask.dim() == 4:
        mask = mask[:, :, None]          # (B, 1|Hkv, 1, Sq, Sk)
    s = torch.where(mask, s, _NEG)
    if smooth_softmax:
        # softmax_i = exp(s_i) / (1 + Σ exp(s_j)): stabilize against
        # m = max(s, 0) so the implicit zero logit is included
        m = s.amax(-1, keepdim=True).clamp_min(0.0)
        e = torch.exp(s - m)
        p = (e / (torch.exp(-m) + e.sum(-1, keepdim=True))).to(v.dtype)
    else:
        p = torch.softmax(s, dim=-1).to(v.dtype)
    out = p @ v[:, :, None]
    return out.reshape(B, Hq, Sq, v.shape[-1])


def _split_heads(t, B, S, heads):
    """(B, S, heads·D) → (B, heads, S, D), a transposed view."""
    return t.reshape(B, S, heads, t.shape[-1] // heads).transpose(1, 2)


def _merge_heads(t):
    """(B, heads, S, D) → (B, S, heads·D)."""
    B, H, S, D = t.shape
    return t.transpose(1, 2).reshape(B, S, H * D)


@register_op("MultiHeadAttention")
def _msft_mha(node, inputs, ctx):
    """com.microsoft MultiHeadAttention: separate (B, S, H) q/k/v inputs.
    Supported surface: optional packed bias, key_padding_mask as (B, S_kv)
    0/1 or (B,) lengths, additive attention_bias, and past_key/past_value
    concatenated along the sequence axis (present outputs carry the grown
    cache — MHA's spec is concat-grow, unlike GQA's static buffers)."""
    if node.domain != "com.microsoft":
        raise UnsupportedOp(f"MultiHeadAttention in domain {node.domain!r}")
    q_in, k_in, v_in = _promoted(ctx, *inputs[:3])
    bias = _opt_tensor(inputs, 3, ctx)
    mask_index = _opt_tensor(inputs, 4, ctx)
    attn_bias = _opt_tensor(inputs, 5, ctx)
    past_k, past_v = _opt_tensor(inputs, 6, ctx), _opt_tensor(inputs, 7, ctx)
    if k_in.dim() != 3 or v_in.dim() != 3:
        raise UnsupportedOp("MultiHeadAttention packed/5-D KV layouts")
    heads = node.attr("num_heads")
    if heads is None:
        raise UnsupportedOp("MultiHeadAttention without num_heads")
    B, Sq, H = q_in.shape
    Sk = k_in.shape[1]
    if bias is not None:
        q_in, qb = _promoted(ctx, q_in, bias[:H])
        k_in, kb = _promoted(ctx, k_in, bias[H:2 * H])
        v_in, vb = _promoted(ctx, v_in, bias[2 * H:])
        q_in, k_in, v_in = q_in + qb, k_in + kb, v_in + vb
    q = _split_heads(q_in, B, Sq, heads)
    k = _split_heads(k_in, B, Sk, heads)
    v = _split_heads(v_in, B, Sk, heads)
    if past_k is not None:
        k = torch.cat(_promoted(ctx, past_k, k), dim=2)
        v = torch.cat(_promoted(ctx, past_v, v), dim=2)
        Sk = k.shape[2]
    present_k, present_v = k, v
    scale = _attn_scale(node, H // heads)
    kv_mask = _decode_mask_index(mask_index, B, Sk, "MultiHeadAttention")
    causal = bool(node.attr("unidirectional", 0))
    if attn_bias is not None:
        out = _dense_masked_attn(
            q, k, v, _qk_valid_mask(Sq, Sk, kv_mask, causal, q.device),
            scale, bias=attn_bias)
    else:
        out = _attention_core(q, k, v, kv_mask, causal, scale)
    out = _merge_heads(out)
    if len(node.output) > 1:
        return out, present_k, present_v
    return out


def _std_attention(node, inputs, ctx):
    """Standard ai.onnx Attention (opset 23): Q (B, Hq, Sq, D), K/V
    (B, Hkv, Skv, D) — 4-D form, or 3-D (B, S, H·D) with the
    q_num_heads/kv_num_heads attributes; GQA via Hq % Hkv == 0 head
    repetition; optional past_key/past_value concatenated per the spec
    (present outputs carry the grown cache)."""
    q, k, v = _promoted(ctx, *inputs[:3])
    attn_mask = _opt_tensor(inputs, 3, ctx)
    past_k, past_v = _opt_tensor(inputs, 4, ctx), _opt_tensor(inputs, 5, ctx)
    three_d = q.dim() == 3
    if three_d:
        qnh = node.attr("q_num_heads", 0)
        kvnh = node.attr("kv_num_heads", 0)
        if not qnh or not kvnh:
            raise UnsupportedOp("ai.onnx Attention 3-D form without "
                                "q_num_heads/kv_num_heads")
        B, Sq, _ = q.shape
        # the spec allows v_head_size != head_size
        q = _split_heads(q, B, Sq, qnh)
        k = _split_heads(k, B, k.shape[1], kvnh)
        v = _split_heads(v, B, v.shape[1], kvnh)
    elif q.dim() != 4:
        raise UnsupportedOp(f"ai.onnx Attention rank-{q.dim()} inputs")
    if past_k is not None:
        # spec: present = concat(past, current) along the sequence axis
        k = torch.cat(_promoted(ctx, past_k, k), dim=2)
        v = torch.cat(_promoted(ctx, past_v, v), dim=2)
    present_k, present_v = k, v
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq % Hkv:
        raise UnsupportedOp(f"Attention q_num_heads {Hq} not a multiple of "
                            f"kv_num_heads {Hkv}")
    if Hkv != Hq:                      # GQA: each KV head serves rep heads
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    causal = bool(node.attr("is_causal", 0))
    if len(node.output) > 3 and node.output[3]:
        raise UnsupportedOp("ai.onnx Attention qk_matmul_output")
    if node.attr("qk_matmul_output_mode", 0):
        raise UnsupportedOp("ai.onnx Attention qk_matmul_output_mode != 0")
    # standard ai.onnx Attention (unlike ORT contrib): the default applies
    # only when the attribute is ABSENT — an explicit 0.0 is honored
    s = node.attr("scale", None)
    scale = float(s) if s is not None else 1.0 / float(q.shape[-1]) ** 0.5
    softcap = float(node.attr("softcap", 0.0))
    Sq, Sk = q.shape[2], k.shape[2]
    pair_mask = None
    if attn_mask is not None:
        # spec: the mask broadcasts against (B, H, Sq, Skv) aligned at the
        # TRAILING dims, so a 2-D mask is (Sq, Skv) — not a padding mask
        if attn_mask.dim() == 2 and attn_mask.dtype == torch.bool \
                and tuple(attn_mask.shape) == (Sq, Sk):
            pair_mask = attn_mask
        else:
            raise UnsupportedOp(
                f"Attention mask shape {tuple(attn_mask.shape)} dtype "
                f"{attn_mask.dtype} (only boolean (q_seq, kv_seq))")
    if softcap:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if pair_mask is not None:
            mask = mask & pair_mask
        if causal:
            mask = mask.tril(Sk - Sq)
        out = _dense_masked_attn(q, k, v, mask[None, None], scale, softcap)
    else:
        out = _attention_core(q, k, v, None, causal, scale,
                              pair_mask=pair_mask)
    if three_d:
        out = _merge_heads(out)
    if len(node.output) > 1:
        return out, present_k, present_v
    return out


@register_op("GroupQueryAttention")
def _gqa(node, inputs, ctx):
    """com.microsoft GroupQueryAttention — prefill AND decode (kv-cache)
    forms, packed or separate QKV, optional fused rotary embedding.

    Decode keeps the past_key/past_value buffers at their STATIC (B,
    kv_heads, S_max, D) shape and writes the new K/V rows into them in
    place, each batch row at its own ``past_len`` (ORT's shared past and
    present buffer): ``present_k`` IS the fed ``past_k``. Prefill without
    past runs causal attention with a key mask through
    :func:`_attention_core`, K/V repeated to the query heads (K7 on the
    card)."""
    q_in = _as_tensor(inputs[0], ctx)
    k_in, v_in = _opt(inputs, 1), _opt(inputs, 2)
    past_k, past_v = _opt_tensor(inputs, 3, ctx), _opt_tensor(inputs, 4, ctx)
    seqlens_k = _opt_tensor(inputs, 5, ctx)
    cos_cache, sin_cache = _opt(inputs, 7), _opt(inputs, 8)
    heads = node.attr("num_heads")
    kv_heads = node.attr("kv_num_heads")
    if not heads or not kv_heads:
        raise UnsupportedOp("GroupQueryAttention without num_heads/"
                            "kv_num_heads")
    if node.attr("local_window_size", -1) != -1:
        raise UnsupportedOp("GroupQueryAttention local_window_size")
    softcap = float(node.attr("softcap", 0.0))
    smooth = bool(node.attr("smooth_softmax", 0))
    do_rotary = bool(node.attr("do_rotary", 0))
    interleaved = bool(node.attr("rotary_interleaved", 0))
    if do_rotary and (cos_cache is None or sin_cache is None):
        raise UnsupportedOp("GroupQueryAttention do_rotary without "
                            "cos/sin caches")
    B, S = q_in.shape[0], q_in.shape[1]
    dev = q_in.device
    if k_in is None or v_in is None:
        # packed layout: query carries (heads + 2*kv_heads)·D lanes
        D = q_in.shape[2] // (heads + 2 * kv_heads)
        q_in, k_in, v_in = torch.split(
            q_in, [heads * D, kv_heads * D, kv_heads * D], dim=2)
    else:
        q_in, k_in, v_in = _promoted(ctx, q_in, k_in, v_in)
    D = q_in.shape[2] // heads
    q = _split_heads(q_in, B, S, heads)
    k_new = _split_heads(k_in, B, S, kv_heads)
    v_new = _split_heads(v_in, B, S, kv_heads)
    scale = _attn_scale(node, D)
    rep = heads // kv_heads
    if seqlens_k is not None:
        # seqlens_k[b] = total valid key count (past + new) - 1
        last = seqlens_k.to(torch.int32).reshape(-1)          # (B,)
    else:
        last = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    # clamped at 0: a right-padded prefill row (valid < S) has its new
    # tokens at positions 0..valid-1 with the tail masked by `last`, NOT at
    # negative positions — matching ORT's slot-i-is-position-i prefill
    past_len = (last + 1 - S).clamp_min(0)                    # (B,)
    steps = torch.arange(S, device=dev)
    if do_rotary:
        cos_cache, sin_cache = _promoted(ctx, cos_cache, sin_cache)
        pos = past_len[:, None] + steps[None, :]               # (B, S)
        q = _apply_rope4(q, pos, cos_cache, sin_cache, interleaved)
        k_new = _apply_rope4(k_new, pos, cos_cache, sin_cache, interleaved)

    if past_k is not None:
        # decode: write the new rows into the static cache, in place; the
        # start is clamped so the chunk fits, as dynamic_update_slice does
        S_max = past_k.shape[2]
        start = past_len.clamp_max(S_max - S).long()
        rows = torch.arange(B, device=dev)[:, None]
        cols = start[:, None] + steps[None, :]                 # (B, S)
        past_k[rows, :, cols] = k_new.transpose(1, 2).to(past_k.dtype)
        past_v[rows, :, cols] = v_new.transpose(1, 2).to(past_v.dtype)
        present_k, present_v = past_k, past_v
        # query i (absolute position past_len+i) sees keys j <= past_len+i
        # (grouped attention: the cache is NOT repeated across q heads)
        mask = (torch.arange(S_max, device=dev)[None, None, None, :]
                <= (past_len[:, None, None, None]
                    + steps[None, None, :, None]))
        out = _dense_masked_attn(q, present_k, present_v, mask, scale,
                                 softcap, smooth)
    else:
        present_k, present_v = k_new, v_new
        if softcap or smooth:
            mask = ((steps[None, None, None, :] <= last[:, None, None, None])
                    & (steps[None, None, :, None]
                       >= steps[None, None, None, :]))
            out = _dense_masked_attn(q, k_new, v_new, mask, scale, softcap,
                                     smooth)
        else:
            k = k_new.repeat_interleave(rep, dim=1)
            v = v_new.repeat_interleave(rep, dim=1)
            kv_mask = steps[None, :] <= last[:, None]
            # GQA is causal by construction in ORT's decoder graphs
            out = _attention_core(q, k, v, kv_mask, True, scale)
    out = _merge_heads(out)
    if len(node.output) > 1:
        return out, present_k, present_v
    return out


@register_op("Attention")
def _msft_attention(node, inputs, ctx):
    """ORT fused multi-head attention. Supported surface: equal q/k/v
    hidden sizes, no past state; mask as (B, S) 0/1 or (B,) right-pad
    lengths; ``unidirectional`` → causal; ``extra_add_qk`` /
    ``attention_bias`` through the dense branch. The rest runs
    :func:`_attention_core` (K7 on the card)."""
    if node.domain != "com.microsoft":
        # the standard ai.onnx Attention (opset 23) takes Q/K/V tensors
        return _std_attention(node, inputs, ctx)
    if _opt(inputs, 4) is not None:
        raise UnsupportedOp("Attention with past state")
    if node.attr("do_rotary", 0):
        raise UnsupportedOp("Attention with do_rotary (use a separate "
                            "RotaryEmbedding node)")
    heads = node.attr("num_heads")
    if heads is None:
        raise UnsupportedOp("Attention without num_heads")
    qkv_sizes = node.attr("qkv_hidden_sizes")
    if qkv_sizes and len(set(qkv_sizes)) != 1:
        raise UnsupportedOp(f"Attention qkv_hidden_sizes {qkv_sizes}")
    x, w = _promoted(ctx, inputs[0], inputs[1])
    mask_index = _opt_tensor(inputs, 3, ctx)
    attn_bias = _opt_tensor(inputs, 5, ctx)
    causal = bool(node.attr("unidirectional", 0))
    B, S, _ = x.shape
    hidden = w.shape[1] // 3
    qkv = torch.matmul(x, w)                              # (B, S, 3*hidden)
    if _opt(inputs, 2) is not None:                       # bias is optional
        qkv, b = _promoted(ctx, qkv, inputs[2])
        qkv = qkv + b
    q, k, v = (_split_heads(t, B, S, heads)
               for t in torch.split(qkv, hidden, dim=-1))
    scale = _attn_scale(node, hidden // heads)
    kv_mask = _decode_mask_index(mask_index, B, S, "Attention")
    if attn_bias is not None:
        # additive attention_bias / extra_add_qk (B|1, H|1, S, S)
        out = _dense_masked_attn(
            q, k, v, _qk_valid_mask(S, S, kv_mask, causal, x.device), scale,
            bias=attn_bias)
    else:
        out = _attention_core(q, k, v, kv_mask, causal, scale)
    return _merge_heads(out)


@register_op("RelativePositionBias")
def _relative_position_bias(node, inputs, ctx):
    """ORT contrib ``com.microsoft.RelativePositionBias`` — T5's bucketed
    relative attention bias as one op. Output (1, num_heads, q_len, k_len)
    gathered from the (num_buckets, num_heads) bias table with the T5
    log-bucketing: near offsets get exact buckets, far offsets share
    logarithmically-spaced ones up to ``max_distance``. The buckets depend
    on the lengths alone, so they are computed on the host, in float32 as
    the reference computes them."""
    table = _as_tensor(inputs[0], ctx)           # (num_buckets, num_heads)
    q_len = int(np.asarray(_concrete(inputs[1], "RelativePositionBias "
                                     "query_length")).ravel()[0])
    k_len = int(np.asarray(_concrete(inputs[2], "RelativePositionBias "
                                     "key_length")).ravel()[0])
    num_buckets = int(table.shape[0])
    max_distance = int(node.attr("max_distance", 128))
    n = np.arange(q_len)[:, None] - np.arange(k_len)[None, :]
    ret = np.zeros((q_len, k_len), np.int32)
    nb = num_buckets
    if node.attr("is_bidirectional", 0):
        nb = num_buckets // 2
        ret = ret + (n < 0).astype(np.int32) * nb
        n = np.abs(n)
    else:
        n = np.maximum(n, 0)
    max_exact = nb // 2
    ratio = np.log(np.maximum(n, 1).astype(np.float32)
                   / np.float32(max_exact))
    large = max_exact + (ratio / np.float32(np.log(max_distance / max_exact))
                         * np.float32(nb - max_exact)).astype(np.int32)
    large = np.minimum(large, nb - 1)
    bucket = ret + np.where(n < max_exact, n, large)
    idx = torch.from_numpy(bucket.astype(np.int64)).to(table.device)
    return table[idx].permute(2, 0, 1)[None]         # (1, H, q, k)


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


def _conv_raw(node, x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Conv body shared by Conv, FusedConv and QLinearConv: the node's
    strides, dilations, group and (possibly asymmetric) pads through
    ``F.conv*d``, with an optional fused 1-D bias."""
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
    return _CONV[rank](x, w, bias, stride=strides, padding=padding,
                       dilation=dilations, groups=node.attr("group", 1))


@register_op("Conv")
def _conv(node, inputs, ctx):
    x, w = _promoted(ctx, inputs[0], inputs[1])
    bias = _opt_tensor(inputs, 2, ctx)
    fused = bias is not None and bias.dtype == x.dtype and bias.ndim == 1
    out = _conv_raw(node, x, w, bias if fused else None)
    if bias is not None and not fused:
        out, b = _promoted(ctx, out, bias)
        out = out + b.reshape((1, -1) + (1,) * (w.ndim - 2))
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


# -- activations --------------------------------------------------------------
# Each computes the reference's own formula, operand order included.

@register_op("ThresholdedRelu")
def _thresholded_relu(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    return torch.where(x > node.attr("alpha", 1.0), x, 0.0)


@register_op("Shrink")
def _shrink(node, inputs, ctx):
    lambd, bias = node.attr("lambd", 0.5), node.attr("bias", 0.0)
    x = _as_tensor(inputs[0], ctx)
    return torch.where(x < -lambd, x + bias,
                       torch.where(x > lambd, x - bias, torch.zeros_like(x)))


@register_op("LeakyRelu")
def _leaky(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    return torch.where(x >= 0, x, node.attr("alpha", 0.01) * x)


@register_op("Elu")
def _elu(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    safe = torch.where(x > 0, 0.0, x)
    return torch.where(x > 0, x, node.attr("alpha", 1.0) * torch.expm1(safe))


@register_op("Selu")
def _selu(node, inputs, ctx):
    alpha = node.attr("alpha", 1.6732632423543772)
    gamma = node.attr("gamma", 1.0507009873554805)
    x = _as_tensor(inputs[0], ctx)
    return gamma * torch.where(x > 0, x, alpha * torch.expm1(x))


@register_op("Celu")
def _celu(node, inputs, ctx):
    alpha = node.attr("alpha", 1.0)
    x = _as_tensor(inputs[0], ctx)
    return torch.clamp_min(x, 0.0) + alpha * torch.expm1(
        torch.clamp_max(x, 0.0) / alpha)


@register_op("Softplus")
def _softplus(node, inputs, ctx):
    x = _float(_as_tensor(inputs[0], ctx))
    return torch.logaddexp(x, torch.zeros_like(x))


@register_op("HardSigmoid")
def _hardsigmoid(node, inputs, ctx):
    a, b = node.attr("alpha", 0.2), node.attr("beta", 0.5)
    return torch.clamp(a * _as_tensor(inputs[0], ctx) + b, 0.0, 1.0)


@register_op("HardSwish")
def _hardswish(node, inputs, ctx):
    # the reference's x * clip(x / 6 + 0.5, 0, 1), not F.hardswish's
    # x * relu6(x + 3) / 6, which rounds differently
    x = _as_tensor(inputs[0], ctx)
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@register_op("PRelu")
def _prelu(node, inputs, ctx):
    x, slope = _promoted(ctx, inputs[0], inputs[1])
    return torch.where(x >= 0, x, slope * x)


@register_op("CastLike")
def _castlike(node, inputs, ctx):
    return _as_tensor(inputs[0], ctx).to(_dtype_of(inputs[1]))


_WIDE_SHIFT = {torch.uint16, torch.uint32}


@register_op("BitShift")
def _bitshift(node, inputs, ctx):
    """Logical shifts; a shift of the width or more gives 0 as in the
    reference. PyTorch has no uint16/uint32 shift kernel, so those shift
    in int64 and are masked back to their width; uint64 shifts its int64
    view (a right shift masks off the sign extension)."""
    x, y = _promoted(ctx, inputs[0], inputs[1])
    left = node.attr("direction", "LEFT") == "LEFT"
    if x.dtype in _WIDE_SHIFT:
        bits = 16 if x.dtype == torch.uint16 else 32
        xi, yi = x.to(torch.int64), y.to(torch.int64).clamp(0, bits)
        out = (xi << yi) if left else (xi >> yi)
        return (out & ((1 << bits) - 1)).to(x.dtype)
    if x.dtype == torch.uint64:
        xi, yi = x.view(torch.int64), y.view(torch.int64)
        big = (yi < 0) | (yi >= 64)
        yc = torch.where(big, 0, yi)
        if left:
            out = xi << yc
        else:
            keep = torch.where(yc == 0, -1, (1 << (64 - yc)) - 1)
            out = (xi >> yc) & keep
        return torch.where(big, 0, out).view(torch.uint64)
    return torch.bitwise_left_shift(x, y) if left else \
        torch.bitwise_right_shift(x, y)


# -- indexing and shape --------------------------------------------------------

@register_op("ReverseSequence")
def _reverse_sequence(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    lens = _as_tensor(inputs[1], ctx).long()
    batch_axis = node.attr("batch_axis", 1)
    time_axis = node.attr("time_axis", 0)
    # one explicit permutation to (batch, time, *rest), as the reference
    rest = [a for a in range(x.ndim) if a not in (batch_axis, time_axis)]
    perm = [batch_axis, time_axis] + rest
    xt = x.permute(*perm)
    B, T = xt.shape[0], xt.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    idx = torch.where(t < lens[:, None], lens[:, None] - 1 - t, t)
    idx = idx.reshape((B, T) + (1,) * (xt.ndim - 2)).expand(xt.shape)
    out = torch.gather(xt, 1, idx)
    return out.permute(*np.argsort(perm).tolist())


def _wrapped(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Indices with negative entries counted from the end, as numpy-style
    indexing (``take_along_axis``, fancy indexing) reads them."""
    idx = idx.long()
    return torch.where(idx < 0, idx + dim, idx)


@register_op("GatherElements")
def _gather_elements(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    axis = node.attr("axis", 0) % x.ndim
    return torch.gather(x, axis, _wrapped(_as_tensor(inputs[1], ctx),
                                          x.shape[axis]))


def _nd_index(x: torch.Tensor, idx: torch.Tensor) -> tuple:
    """The last axis of ``idx`` as a tuple of index tensors into the leading
    axes of ``x`` (``x[tuple(moveaxis(idx, -1, 0))]``)."""
    return tuple(_wrapped(i, x.shape[k])
                 for k, i in enumerate(idx.unbind(-1)))


@register_op("GatherND")
def _gathernd(node, inputs, ctx):
    if node.attr("batch_dims", 0):
        raise UnsupportedOp("GatherND batch_dims")
    x = _as_tensor(inputs[0], ctx)
    return x[_nd_index(x, _as_tensor(inputs[1], ctx))]


@register_op("ScatterND")
def _scatternd(node, inputs, ctx):
    """``x`` with the rows ``indices`` names set to ``updates`` (the
    ``reduction`` attribute is not read, as in the reference). Repeated
    indices leave the result undefined in ONNX and nondeterministic on
    CUDA."""
    x = _as_tensor(inputs[0], ctx)
    out = x.clone()
    out[_nd_index(x, _as_tensor(inputs[1], ctx))] = \
        _as_tensor(inputs[2], ctx, x.dtype)
    return out


@register_op("TopK")
def _topk(node, inputs, ctx):
    """The reference's ``lax.top_k`` puts the lower index first among equal
    values; ``torch.topk`` promises no order, so this is a stable sort."""
    k = int(_concrete(inputs[1], "TopK k").ravel()[0])
    x = _as_tensor(inputs[0], ctx)
    axis = node.attr("axis", -1) % x.ndim
    largest = node.attr("largest", 1)
    moved = x.movedim(axis, -1)
    vals, idx = torch.sort(moved if largest else -moved, dim=-1,
                           descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if not largest:
        vals = -vals
    return vals.movedim(-1, axis), idx.movedim(-1, axis)


@register_op("OneHot")
def _onehot(node, inputs, ctx):
    idx = _as_tensor(inputs[0], ctx)
    depth = int(np.asarray(_concrete(inputs[1], "OneHot depth")).ravel()[0])
    values = _as_tensor(inputs[2], ctx)
    axis = node.attr("axis", -1) % (idx.ndim + 1)
    classes = torch.arange(depth, device=idx.device)
    hot = (torch.remainder(idx, depth).unsqueeze(-1) == classes) \
        .to(torch.float32).movedim(-1, axis)
    off, on = values[0], values[1]
    oh, span = _promoted(ctx, hot, on - off)
    oh, off = _promoted(ctx, oh * span, off)
    return oh + off


@register_op("CumSum")
def _cumsum(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    axis = int(np.asarray(_concrete(inputs[1], "CumSum axis")).ravel()[0]) \
        % x.ndim
    reverse = node.attr("reverse", 0)
    out = torch.cumsum(x.flip(axis) if reverse else x, dim=axis,
                       dtype=x.dtype)
    if node.attr("exclusive", 0):
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, out.shape[axis] - 1)], dim=axis)
    return out.flip(axis) if reverse else out


@register_op("Trilu")
def _trilu(node, inputs, ctx):
    k = int(np.asarray(_concrete(inputs[1], "Trilu k")).ravel()[0]) \
        if _opt(inputs, 1) is not None else 0
    x = _as_tensor(inputs[0], ctx)
    return torch.tril(x, k) if node.attr("upper", 1) == 0 else \
        torch.triu(x, k)


@register_op("EyeLike")
def _eyelike(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    to = node.attr("dtype")
    dt = ONNX_TO_TORCH[to] if to is not None else x.dtype
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    return (rows + node.attr("k", 0) == cols).to(dt)


@register_op("DepthToSpace")
def _depth_to_space(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    b = node.attr("blocksize")
    n, c, h, w = x.shape
    if node.attr("mode", "DCR") == "DCR":
        y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:
        y = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register_op("SpaceToDepth")
def _space_to_depth(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    b = node.attr("blocksize")
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


# -- convolution ---------------------------------------------------------------

_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register_op("ConvTranspose")
def _conv_transpose(node, inputs, ctx):
    """ONNX ConvTranspose (weights (C_in, C_out, *k)): strides, dilations,
    pads that shrink the output and ``output_padding`` that grows its high
    side, with the optional bias. ``F.conv_transpose*d`` computes the
    unpadded output, which is then cut (or zero-extended) to the padded
    one. Grouped ones are refused as the reference refuses them, and so
    are ``auto_pad`` and ``output_shape``, which the reference would
    ignore."""
    x, w = _promoted(ctx, inputs[0], inputs[1])
    rank = w.ndim - 2
    if rank not in _CONV_T:
        raise UnsupportedOp(f"ConvTranspose rank {rank}")
    if node.attr("group", 1) != 1:
        raise UnsupportedOp("grouped ConvTranspose")
    if node.attr("auto_pad", "NOTSET") != "NOTSET" or \
            node.attr("output_shape") is not None:
        raise UnsupportedOp("ConvTranspose auto_pad / output_shape")
    strides = list(node.attr("strides", [1] * rank))
    dilations = list(node.attr("dilations", [1] * rank))
    pads = list(node.attr("pads", [0] * (2 * rank)))
    out_pad = list(node.attr("output_padding", [0] * rank))
    out = _CONV_T[rank](x, w, None, stride=strides, dilation=dilations)
    for i in range(rank):
        ax = 2 + i
        full = out.shape[ax]
        end = full - pads[i + rank] + out_pad[i]
        if end > full:
            grow = [0, 0] * (out.ndim - 1 - ax) + [0, end - full]
            out = F.pad(out, grow)
        out = out.narrow(ax, pads[i], end - pads[i])
    bias = _opt(inputs, 2)
    if bias is not None:
        out, b = _promoted(ctx, out, bias)
        out = out + b.reshape((1, -1) + (1,) * rank)
    return out


@register_op("FusedConv")
def _fused_conv(node, inputs, ctx):
    """ORT contrib ``com.microsoft.FusedConv``: Conv, the optional residual
    ``Z``, then the activation ORT's optimizer folded in."""
    out = _conv(node, inputs[:3], ctx)
    if _opt(inputs, 3) is not None:
        out, z = _promoted(ctx, out, inputs[3])
        out = out + z
    act = node.attr("activation", "")
    p = [float(v) for v in node.attr("activation_params", [])]
    if not act:
        return out
    if act == "Relu":
        return torch.clamp_min(out, 0)
    if act == "Tanh":
        return torch.tanh(out)
    if act == "Sigmoid":
        return torch.sigmoid(out)
    if act == "LeakyRelu":
        alpha = p[0] if p else 0.01
        return torch.where(out < 0, alpha * out, out)
    if act == "Clip":
        return torch.clamp(out, p[0], p[1])
    if act == "HardSigmoid":
        a = p[0] if len(p) > 0 else 0.2
        b = p[1] if len(p) > 1 else 0.5
        return torch.clamp(a * out + b, 0.0, 1.0)
    raise UnsupportedOp(f"FusedConv activation {act!r}")


# -- normalization -------------------------------------------------------------

def _channel(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape((1, -1) + (1,) * (ndim - 2))


@register_op("InstanceNormalization")
def _instancenorm(node, inputs, ctx):
    x, scale, bias = _promoted(ctx, *inputs[:3])
    eps = node.attr("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * _channel(scale, x.ndim) \
        + _channel(bias, x.ndim)


@register_op("GroupNormalization")
def _groupnorm(node, inputs, ctx):
    """Statistics per (sample, group); ``scale``/``bias`` per channel, as
    the reference reads them (opset 21's layout)."""
    x, scale, bias = _promoted(ctx, *inputs[:3])
    g = node.attr("num_groups")
    eps = node.attr("epsilon", 1e-5)
    n, c = x.shape[:2]
    grouped = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, grouped.ndim))
    mean = grouped.mean(dim=axes, keepdim=True)
    var = grouped.var(dim=axes, correction=0, keepdim=True)
    y = ((grouped - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * _channel(scale, x.ndim) + _channel(bias, x.ndim)


@register_op("LpNormalization")
def _lpnorm(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    axis, p = node.attr("axis", -1), node.attr("p", 2)
    if p == 1:
        n = torch.sum(torch.abs(x), dim=axis, keepdim=True)
    else:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return x / torch.clamp_min(n, 1e-12)


OP_HANDLERS["ReduceLogSum"] = _reduce(
    lambda x, d, k: torch.log(torch.sum(x, dim=d, keepdim=k)), 18)


# -- resampling ----------------------------------------------------------------
# Resize and Upsample compute ``jax.image.resize``, as the reference does:
# half-pixel centres, a triangle (linear) or Keys cubic (a = -0.5) kernel
# that widens when downsampling (antialiasing), one weight matrix per resized
# axis; "nearest" picks floor((i + 0.5) * in / out). The ONNX attributes
# ``coordinate_transformation_mode``, ``nearest_mode`` and
# ``cubic_coeff_a`` are not read. The sizes are host values, so the weights
# are built on the host in float32 with the reference's operation order and
# meet the tensor on its device.

_F32 = np.float32


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(_F32(0), _F32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= _F32(1.0),
                   ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0)) * x
                   + _F32(2.0), out)
    return np.where(x >= _F32(2.0), _F32(0.0), out).astype(_F32)


_RESIZE_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def _resize_weights(m: int, n: int, kernel) -> np.ndarray:
    """The (m, n) float32 weights of one axis resized from m to n
    (``jax.image.resize``'s ``compute_weight_mat``, translation 0,
    antialiasing on)."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = _F32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n, dtype=_F32) + _F32(0.5)) * _F32(inv_scale)
                - _F32(0.0) - _F32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=_F32)[:, None]) \
        / kernel_scale
    weights = kernel(x)
    total = np.sum(weights, axis=0, keepdims=True, dtype=_F32)
    weights = np.where(np.abs(total) > _F32(1000.0 * np.finfo(_F32).eps),
                       weights / np.where(total != 0, total, _F32(1)),
                       _F32(0))
    inside = (sample_f >= _F32(-0.5)) & (sample_f <= _F32(m - 0.5))
    return np.where(inside[None, :], weights, _F32(0)).astype(_F32)


def _image_resize(x: torch.Tensor, sizes: Sequence[int], method: str,
                  ctx: _Ctx) -> torch.Tensor:
    if len(sizes) != x.ndim:
        raise ValueError(f"resize sizes {list(sizes)} do not match the "
                         f"input's rank {x.ndim}")
    dims = [d for d in range(x.ndim) if x.shape[d] != sizes[d]]
    if method == "nearest":
        for d in dims:
            m, n = x.shape[d], sizes[d]
            offs = np.floor((np.arange(n, dtype=_F32) + _F32(0.5)) * _F32(m)
                            / _F32(n)).astype(np.int64)
            x = torch.index_select(x, d, _as_tensor(offs, ctx))
        return x
    kernel = _RESIZE_KERNELS[method]
    x = _float(x)
    for d in dims:
        w = _as_tensor(_resize_weights(x.shape[d], sizes[d], kernel), ctx,
                       x.dtype)
        x = torch.matmul(x.movedim(d, -1), w).movedim(-1, d)
    return x


@register_op("Resize")
def _resize(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    mode = node.attr("mode", "nearest")
    sizes = None
    if _opt(inputs, 3) is not None:
        sizes = [int(s) for s in _concrete(inputs[3], "Resize sizes")]
    elif _opt(inputs, 2) is not None:
        scales = np.asarray(_concrete(inputs[2], "Resize scales")).ravel()
        if scales.size:
            sizes = [int(round(d * s)) for d, s in zip(x.shape, scales)]
    if sizes is None:
        raise UnsupportedOp("Resize without sizes/scales")
    method = {"nearest": "nearest", "linear": "linear", "cubic": "cubic"}[mode]
    return _image_resize(x, sizes, method, ctx)


@register_op("Upsample")
def _upsample(node, inputs, ctx):
    x = _as_tensor(inputs[0], ctx)
    scales = np.asarray(_concrete(inputs[1], "Upsample scales")).ravel() \
        if len(inputs) > 1 else np.asarray(node.attr("scales"))
    sizes = [int(round(d * s)) for d, s in zip(x.shape, scales)]
    method = {"nearest": "nearest", "linear": "linear"}[
        node.attr("mode", "nearest")]
    return _image_resize(x, sizes, method, ctx)


# -- quantized ops (QuantizeLinear family and QLinear*) ------------------------
# The reference accumulates integer products in int32
# (``preferred_element_type=jnp.int32``). PyTorch has no integer convolution
# or matmul on CUDA, and a float32 one is not exact (nor free of the global
# TF32 switches), so the accumulation runs in float64 on the tensors' own
# device: |x - zp| <= 255 on both sides, every product is below 2^16 and
# any sum of fewer than 2^37 of them is an integer float64 holds exactly.
# ``torch.round`` then pins the accumulator to that integer whatever
# algorithm cuDNN picked (an FFT one rounds). From there every op is the
# reference's, in float32 and in its order: the accumulator to float32,
# times the multiplier, round half to even, + zero point, saturate.

def _maybe_scalar(v, what):
    a = np.asarray(_concrete(v, what)).ravel()
    if a.size != 1:
        raise UnsupportedOp(f"{what} must be per-tensor (scalar), "
                            f"got {a.size} values")
    return a.dtype.type(a[0])


def _exact(t: torch.Tensor, zp) -> torch.Tensor:
    """``t - zp`` as float64 on ``t``'s device: exact for 8-bit codes."""
    t = t.to(torch.float64)
    return t - float(zp) if int(zp) else t


def _int_accum_matmul(a, a_zp, b, b_zp) -> torch.Tensor:
    """(a - a_zp) @ (b - b_zp), exactly (float64 holding integers)."""
    return torch.round(torch.matmul(_exact(a, a_zp), _exact(b, b_zp)))


def _saturate(y_float: torch.Tensor, zp) -> torch.Tensor:
    """Round half to even, + zp, saturate to zp's integer type: the
    requantization tail every QLinear op shares."""
    zdt = np.asarray(zp).dtype
    info = np.iinfo(zdt)
    return torch.clamp(torch.round(y_float) + int(zp), info.min,
                       info.max).to(_torch_dtype(zdt))


def _requantize(acc: torch.Tensor, multiplier, y_zp) -> torch.Tensor:
    return _saturate(acc.to(torch.float32) * multiplier, y_zp)


def _f32(v, ctx) -> torch.Tensor:
    return _as_tensor(v, ctx).to(torch.float32)


@register_op("QuantizeLinear")
def _quantize(node, inputs, ctx):
    """round(x / scale) + zp, saturated to the zero point's type. As in
    the reference, ``axis`` is not read (a 1-D scale broadcasts against
    the last axis) and a missing zero point means int8 0 (ONNX: uint8)."""
    zp = inputs[2] if _opt(inputs, 2) is not None else np.int8(0)
    zp_t = _as_tensor(zp, ctx)
    x, scale = _promoted(ctx, inputs[0], inputs[1])
    info = np.iinfo(np.asarray(zp).dtype)
    return torch.clamp(torch.round(x / scale) + zp_t.to(torch.int32),
                       info.min, info.max).to(zp_t.dtype)


@register_op("DequantizeLinear")
def _dequantize(node, inputs, ctx):
    """(x - zp) * scale in float32; ``axis`` is not read (a 1-D scale
    broadcasts against the last axis), as in the reference."""
    zp = inputs[2] if _opt(inputs, 2) is not None else np.int32(0)
    x = _f32(inputs[0], ctx) - _f32(zp, ctx)
    return functools.reduce(torch.mul, _promoted(ctx, x, inputs[1]))


@register_op("QLinearConv")
def _qlinear_conv(node, inputs, ctx):
    x, x_scale, x_zp, w, w_scale, w_zp, y_scale, y_zp = inputs[:8]
    bias = _opt(inputs, 8)
    x_zp = _maybe_scalar(x_zp, "QLinearConv x_zero_point")
    w_zp_a = np.asarray(_concrete(w_zp, "QLinearConv w_zero_point")).ravel()
    if (w_zp_a != w_zp_a[0]).any():
        raise UnsupportedOp("QLinearConv per-channel w_zero_point")
    w = _as_tensor(w, ctx)
    rank = w.ndim - 2
    acc = torch.round(_conv_raw(node, _exact(_as_tensor(x, ctx), x_zp),
                                _exact(w, w_zp_a[0])))
    if bias is not None:       # int32, quantized with scale x_scale*w_scale
        acc = acc + _channel(_as_tensor(bias, ctx, torch.float64), acc.ndim)
    # w_scale may be per output channel: broadcast over (N, M, *spatial)
    mult = (_f32(x_scale, ctx)
            * _f32(w_scale, ctx).reshape((1, -1) + (1,) * rank)
            / _f32(y_scale, ctx))
    return _requantize(acc, mult, _maybe_scalar(y_zp, "QLinearConv y_zp"))


@register_op("QLinearMatMul")
def _qlinear_matmul(node, inputs, ctx):
    a, a_scale, a_zp, b, b_scale, b_zp, y_scale, y_zp = inputs[:8]
    acc = _int_accum_matmul(_as_tensor(a, ctx),
                            _maybe_scalar(a_zp, "QLinearMatMul a_zp"),
                            _as_tensor(b, ctx),
                            _maybe_scalar(b_zp, "QLinearMatMul b_zp"))
    mult = _f32(a_scale, ctx) * _f32(b_scale, ctx) / _f32(y_scale, ctx)
    return _requantize(acc, mult, _maybe_scalar(y_zp, "QLinearMatMul y_zp"))


@register_op("QGemm")
def _qgemm(node, inputs, ctx):
    """com.microsoft QGemm: quantized Gemm with an optional int32 C and an
    optional output quantization (float32 out when y_scale is absent)."""
    a, a_scale, a_zp, b, b_scale, b_zp = inputs[:6]
    c, y_scale, y_zp = _opt(inputs, 6), _opt(inputs, 7), _opt(inputs, 8)
    a, b = _as_tensor(a, ctx), _as_tensor(b, ctx)
    if node.attr("transA", 0):
        a = a.transpose(-1, -2)
    if node.attr("transB", 0):
        b = b.transpose(-1, -2)
    acc = _int_accum_matmul(a, _maybe_scalar(a_zp, "QGemm a_zp"),
                            b, _maybe_scalar(b_zp, "QGemm b_zp"))
    if c is not None:          # int32, scale = alpha * a_scale * b_scale
        acc = acc + _as_tensor(c, ctx, torch.float64)
    alpha = torch.full((), node.attr("alpha", 1.0), dtype=torch.float32,
                       device=acc.device)
    sab = alpha * _f32(a_scale, ctx) * _f32(b_scale, ctx)
    if y_scale is None:
        return acc.to(torch.float32) * sab
    return _requantize(acc, sab / _f32(y_scale, ctx),
                       _maybe_scalar(y_zp, "QGemm y_zp"))


def _qlinear_eltwise(op):
    """com.microsoft QLinearAdd/QLinearMul: dequantize, apply, requantize
    (the pattern ORT's quantizer emits around every ResNet skip join)."""
    def handler(node, inputs, ctx):
        a, a_scale, a_zp, b, b_scale, b_zp, y_scale, y_zp = inputs[:8]
        af = (_f32(a, ctx) - float(_maybe_scalar(a_zp, "QLinear a_zp"))) \
            * _f32(a_scale, ctx)
        bf = (_f32(b, ctx) - float(_maybe_scalar(b_zp, "QLinear b_zp"))) \
            * _f32(b_scale, ctx)
        y = op(af, bf) / _f32(y_scale, ctx)
        return _saturate(y, _maybe_scalar(y_zp, "QLinear y_zp"))
    return handler


OP_HANDLERS["QLinearAdd"] = _qlinear_eltwise(torch.add)
OP_HANDLERS["QLinearMul"] = _qlinear_eltwise(torch.mul)


@register_op("QLinearGlobalAveragePool")
def _qlinear_gap(node, inputs, ctx):
    x, x_scale, x_zp, y_scale, y_zp = inputs[:5]
    if node.attr("channels_last", 0):
        raise UnsupportedOp("QLinearGlobalAveragePool channels_last")
    x = _as_tensor(x, ctx)
    spatial = tuple(range(2, x.ndim))
    # exact integer sum, then one requantization
    acc = x.to(torch.int64).sum(dim=spatial, keepdim=True)
    count = int(np.prod([x.shape[i] for i in spatial]))
    mean = acc.to(torch.float32) / count \
        - float(_maybe_scalar(x_zp, "QLinearGAP x_zp"))
    y = mean * _f32(x_scale, ctx) / _f32(y_scale, ctx)
    return _saturate(y, _maybe_scalar(y_zp, "QLinearGAP y_zp"))


# -- detection ------------------------------------------------------------------

def _host_array(v) -> np.ndarray:
    """NMS's inputs on the host: its output length depends on the values,
    so the reference computes it on concrete values too."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().cpu().numpy()
    return np.asarray(v)


@register_op("NonMaxSuppression")
def _nms(node, inputs, ctx):
    """Greedy NMS per (batch, class) on the host, the reference's loop:
    a stable sort by score, the score threshold, then every box whose IoU
    with a kept one exceeds the threshold dropped. Returns host int64
    (selected, 3) rows (batch, class, box)."""
    boxes = _host_array(inputs[0])
    scores = _host_array(inputs[1])
    max_out = (int(np.ravel(_host_array(inputs[2]))[0])
               if _opt(inputs, 2) is not None else 0)
    iou_thr = (float(np.ravel(_host_array(inputs[3]))[0])
               if _opt(inputs, 3) is not None else 0.0)
    score_thr = (float(np.ravel(_host_array(inputs[4]))[0])
                 if _opt(inputs, 4) is not None else None)
    center = bool(node.attr("center_point_box", 0))
    if max_out <= 0:        # spec: "Default to 0, which means no output"
        return np.zeros((0, 3), np.int64)
    sel = []
    for bi in range(scores.shape[0]):
        for ci in range(scores.shape[1]):
            s = scores[bi, ci]
            order = np.argsort(-s, kind="stable")
            if score_thr is not None:
                order = order[s[order] > score_thr]
            kept: list = []
            for i in order:
                if len(kept) >= max_out:
                    break
                if all(_iou(boxes[bi, i], boxes[bi, j], center) <= iou_thr
                       for j in kept):
                    kept.append(i)
            sel.extend([bi, ci, int(i)] for i in kept)
    return np.asarray(sel, np.int64).reshape(-1, 3)


def _iou(a, b, center: bool) -> float:
    if center:      # [x_center, y_center, w, h]
        ay1, ax1 = a[1] - a[3] / 2, a[0] - a[2] / 2
        ay2, ax2 = a[1] + a[3] / 2, a[0] + a[2] / 2
        by1, bx1 = b[1] - b[3] / 2, b[0] - b[2] / 2
        by2, bx2 = b[1] + b[3] / 2, b[0] + b[2] / 2
    else:           # [y1, x1, y2, x2], either corner order allowed
        ay1, ax1, ay2, ax2 = a
        by1, bx1, by2, bx2 = b
        ay1, ay2 = min(ay1, ay2), max(ay1, ay2)
        ax1, ax2 = min(ax1, ax2), max(ax1, ax2)
        by1, by2 = min(by1, by2), max(by1, by2)
        bx1, bx2 = min(bx1, bx2), max(bx1, bx2)
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    inter = ih * iw
    union = ((ay2 - ay1) * (ax2 - ax1) + (by2 - by1) * (bx2 - bx1) - inter)
    return inter / union if union > 0 else 0.0


def _gather_hw(flat: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor,
               W: int) -> torch.Tensor:
    """``flat`` (R, C, H * W) read at rows ``yi`` (R, Sy) and columns ``xi``
    (R, Sx) → (R, C, Sy, Sx)."""
    R, C = flat.shape[:2]
    idx = (yi[:, :, None] * W + xi[:, None, :]).reshape(R, 1, -1)
    out = torch.gather(flat, 2, idx.expand(R, C, idx.shape[-1]))
    return out.reshape(R, C, yi.shape[1], xi.shape[1])


@register_op("RoiAlign")
def _roi_align(node, inputs, ctx):
    """torchvision-semantics RoiAlign (the ONNX spec's model), every ROI at
    once: bilinear samples on a fixed grid per output bin, averaged or
    maxed, in the reference's operation order."""
    out_h = node.attr("output_height", 1)
    out_w = node.attr("output_width", 1)
    sr = node.attr("sampling_ratio", 0)
    if sr <= 0:
        # adaptive sampling counts depend on each ROI's size
        raise UnsupportedOp("RoiAlign sampling_ratio=0 (adaptive)")
    scale = node.attr("spatial_scale", 1.0)
    mode = node.attr("mode", "avg")
    half_pixel = node.attr("coordinate_transformation_mode",
                           "half_pixel") == "half_pixel"
    x, rois = _as_tensor(inputs[0], ctx), _as_tensor(inputs[1], ctx)
    bidx = _as_tensor(inputs[2], ctx).long()
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    off = 0.5 if half_pixel else 0.0
    x1, y1, x2, y2 = (rois[:, i] * scale - off for i in range(4))
    roi_w, roi_h = x2 - x1, y2 - y1
    if not half_pixel:          # legacy mode clamps to min size 1
        roi_w, roi_h = roi_w.clamp_min(1.0), roi_h.clamp_min(1.0)
    bin_w, bin_h = roi_w / out_w, roi_h / out_h
    iy = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5) / sr
    gy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] \
        + iy[None, :]
    gx = torch.arange(out_w, dtype=torch.float32, device=dev)[:, None] \
        + iy[None, :]
    ys = (y1[:, None, None] + gy[None] * bin_h[:, None, None]).reshape(R, -1)
    xs = (x1[:, None, None] + gx[None] * bin_w[:, None, None]).reshape(R, -1)

    def axis_weights(cs, limit):
        valid = (cs >= -1.0) & (cs <= limit)    # torchvision's zero rule
        c = torch.clamp(cs, 0.0, limit - 1)
        lo = torch.floor(c).to(torch.int64)
        hi = torch.clamp_max(lo + 1, int(limit) - 1)
        return lo, hi, c - lo, valid

    y0, y1i, fy, vy = axis_weights(ys, float(H))
    x0, x1i, fx, vx = axis_weights(xs, float(W))
    flat = x.reshape(N, C, H * W)[bidx]                     # (R, C, H W)
    fy_, fx_ = fy[:, None, :, None], fx[:, None, None, :]
    v = ((_gather_hw(flat, y0, x0, W) * (1 - fy_)
          + _gather_hw(flat, y1i, x0, W) * fy_) * (1 - fx_)
         + (_gather_hw(flat, y0, x1i, W) * (1 - fy_)
            + _gather_hw(flat, y1i, x1i, W) * fy_) * fx_)
    v = v * (vy[:, None, :, None] & vx[:, None, None, :])
    v = v.reshape(R, C, out_h, sr, out_w, sr)
    if mode == "max":
        return v.amax(dim=(3, 5))
    return v.mean(dim=(3, 5))


@register_op("GridSample")
def _grid_sample(node, inputs, ctx):
    """4-D GridSample in the reference's formulas (its reflection rule and
    its corner weights), every sample at once."""
    x = _as_tensor(inputs[0], ctx)
    grid = _as_tensor(inputs[1], ctx, torch.float32)
    if x.ndim != 4:
        raise UnsupportedOp(f"GridSample rank {x.ndim} (4-D NCHW only)")
    mode = node.attr("mode", "linear")
    pad = node.attr("padding_mode", "zeros")
    align = bool(node.attr("align_corners", 0))
    if mode not in ("nearest", "linear", "bilinear"):
        raise UnsupportedOp(f"GridSample mode {mode!r}")
    N, C, H, W = x.shape
    Ho, Wo = grid.shape[1], grid.shape[2]

    def unnormalize(coord, size):
        if align:
            return (coord + 1.0) / 2.0 * (size - 1)
        return ((coord + 1.0) * size - 1.0) / 2.0

    def reflect(c, size):
        if align:
            span = 2.0 * (size - 1) if size > 1 else 1.0
            c = torch.abs(torch.remainder(c, span))
            return torch.where(c > size - 1, span - c, c)
        span = 2.0 * size
        c = torch.abs(torch.remainder(c + 0.5, span))
        return torch.clamp(torch.where(c > size, span - c, c) - 0.5,
                           0.0, size - 1)

    gx = unnormalize(grid[..., 0].reshape(N, -1), W)          # (N, P)
    gy = unnormalize(grid[..., 1].reshape(N, -1), H)
    if pad == "reflection":
        gx, gy = reflect(gx, W), reflect(gy, H)
    flat = x.reshape(N, C, H * W)

    def fetch(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        v = torch.gather(flat, 2, idx[:, None, :].expand(N, C, idx.shape[1]))
        if pad == "zeros":
            v = v * valid[:, None, :]
        return v

    if mode == "nearest":
        out = fetch(torch.round(gy).to(torch.int64),
                    torch.round(gx).to(torch.int64))
        return out.reshape(N, C, Ho, Wo)
    if pad == "border":
        gx = torch.clamp(gx, 0.0, W - 1)
        gy = torch.clamp(gy, 0.0, H - 1)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    fx, fy = gx - x0, gy - y0
    out = (fetch(y0, x0) * ((1 - fy) * (1 - fx))[:, None, :]
           + fetch(y0, x0 + 1) * ((1 - fy) * fx)[:, None, :]
           + fetch(y0 + 1, x0) * (fy * (1 - fx))[:, None, :]
           + fetch(y0 + 1, x0 + 1) * (fy * fx)[:, None, :])
    return out.reshape(N, C, Ho, Wo)


# -- control flow and recurrent cells --------------------------------------------
# The reference lowers these to lax.cond / lax.scan; the port runs them
# eagerly. A trip count and an initial Loop condition must be host values
# (the reference takes them concrete); a device predicate or a body's
# termination condition never leaves the device: If evaluates both branches
# and selects, as lax.cond's result does, and Loop masks its carry.

_SUBGRAPH_OPS = frozenset({"If", "Loop", "Scan"})


def _stacked(steps: List[torch.Tensor], probe, ctx) -> torch.Tensor:
    """Per-step outputs stacked on a new leading axis; with no step, an
    empty (0, *shape) tensor shaped like ``probe()``'s output."""
    if steps:
        return torch.stack(steps)
    return _as_tensor(probe(), ctx)[None][:0]


@register_op("If")
def _if(node, inputs, ctx):
    cond = inputs[0]
    then_g, else_g = node.attr("then_branch"), node.attr("else_branch")
    if _is_host(cond):
        # a host predicate (the common exporter pattern): one branch runs
        branch = then_g if bool(np.asarray(cond).reshape(())) else else_g
        outs = ctx.run_subgraph(branch, [])
        return tuple(outs) if len(outs) > 1 else outs[0]
    pred = _as_tensor(cond, ctx).reshape(()).to(torch.bool)
    outs = []
    for t, e in zip(ctx.run_subgraph(then_g, []),
                    ctx.run_subgraph(else_g, [])):
        t, e = _as_tensor(t, ctx), _as_tensor(e, ctx)
        if t.shape != e.shape or t.dtype != e.dtype:
            raise UnsupportedOp(
                f"If on a device predicate with branch outputs of other "
                f"shapes or types ({tuple(t.shape)} {t.dtype}, "
                f"{tuple(e.shape)} {e.dtype})")
        outs.append(torch.where(pred, t, e))
    return tuple(outs) if len(outs) > 1 else outs[0]


def _cond_is_passthrough(body) -> bool:
    """True when the body's cond_out is an Identity chain back to cond_in —
    the fixed-trip-count exporter pattern where termination never fires."""
    producers = {}
    for n in body.nodes:
        for o in n.output:
            producers[o] = n
    name = body.outputs[0].name
    cond_in = body.inputs[1].name if len(body.inputs) > 1 else None
    for _ in range(len(body.nodes) + 1):
        if name == cond_in:
            return True
        n = producers.get(name)
        if n is None or n.op_type != "Identity":
            return False
        name = n.input[0]
    return False


@register_op("Loop")
def _loop(node, inputs, ctx):
    """ONNX Loop with a static trip count: body(iter_num, cond_in, v...) ->
    (cond_out, v'..., scan_outputs...), run M times. A body-computed
    termination condition masks the carry once it turns False (on the
    device); a loop that can end early AND has scan outputs has no static
    output length and is refused, as in the reference."""
    m, cond0 = inputs[0], _opt(inputs, 1)
    body = node.attr("body")
    if m is None or not _is_host(m):
        raise UnsupportedOp(
            "Loop requires a static trip count M (data-dependent loop "
            "termination has no static shape)")
    trip = int(np.asarray(m).reshape(()))
    if cond0 is not None and not _is_host(cond0):
        raise UnsupportedOp("Loop with a device initial condition is not "
                            "supported (static trip counts only)")
    if cond0 is not None and not bool(np.asarray(cond0).reshape(())):
        trip = 0  # spec: an initial cond of False runs no iteration
    carry = [_as_tensor(v, ctx) for v in inputs[2:]]
    n_carry = len(carry)
    n_scan = len(body.outputs) - 1 - n_carry
    fixed_trip = _cond_is_passthrough(body)
    if not fixed_trip and n_scan > 0:
        raise UnsupportedOp(
            "Loop with data-dependent termination AND scan outputs has a "
            "dynamic output length (no static shape)")

    def run(i, vals):
        return ctx.run_subgraph(body, [np.asarray(i, np.int64),
                                       np.asarray(True)] + list(vals))

    init = list(carry)
    active = torch.ones((), dtype=torch.bool, device=ctx.device)
    scans: List[List[torch.Tensor]] = [[] for _ in range(n_scan)]
    for i in range(trip):
        outs = run(i, carry)
        new = [_as_tensor(v, ctx) for v in outs[1:1 + n_carry]]
        if fixed_trip:
            carry = new
        else:
            carry = [torch.where(active, v, old) for v, old in zip(new, carry)]
            active = active & _as_tensor(outs[0], ctx,
                                         torch.bool).reshape(())
        for k in range(n_scan):
            scans[k].append(_as_tensor(outs[1 + n_carry + k], ctx))
    outs = carry + [_stacked(scans[k],
                             lambda k=k: run(0, init)[1 + n_carry + k], ctx)
                    for k in range(n_scan)]
    return tuple(outs) if len(outs) > 1 else outs[0]


@register_op("Scan")
def _scan(node, inputs, ctx):
    """ONNX Scan (forward, axis-0 scans): the body runs once a slice."""
    body = node.attr("body")
    n_scan_in = int(node.attr("num_scan_inputs"))
    if node.attr("scan_input_directions") or \
            node.attr("scan_output_directions") or \
            node.attr("scan_input_axes") or node.attr("scan_output_axes"):
        raise UnsupportedOp("Scan with non-default directions/axes")
    n_state = len(inputs) - n_scan_in
    state = [_as_tensor(v, ctx) for v in inputs[:n_state]]
    xs = [_as_tensor(v, ctx) for v in inputs[n_state:]]
    n_scan_out = len(body.outputs) - n_state
    T = xs[0].shape[0] if xs else 0
    init = list(state)
    scans: List[List[torch.Tensor]] = [[] for _ in range(n_scan_out)]
    for t in range(T):
        outs = ctx.run_subgraph(body, state + [x[t] for x in xs])
        state = [_as_tensor(v, ctx) for v in outs[:n_state]]
        for k in range(n_scan_out):
            scans[k].append(_as_tensor(outs[n_state + k], ctx))
    outs = state + [_stacked(scans[k], lambda k=k: ctx.run_subgraph(
        body, init + [x.new_zeros(x.shape[1:]) for x in xs])[n_state + k],
        ctx)
        for k in range(n_scan_out)]
    return tuple(outs) if len(outs) > 1 else outs[0]


_SIGMOID_TANH_ACTS = (
    ["sigmoid", "tanh"], ["sigmoid", "tanh", "tanh"],
    ["sigmoid", "tanh"] * 2, ["sigmoid", "tanh", "tanh"] * 2)


def _rnn_common(node, inputs, ctx, allowed_acts=_SIGMOID_TANH_ACTS):
    """X (T, B, I), W / R / B per direction, and the direction; only the
    spec's default activations, no clipping and no ``sequence_lens``, as
    in the reference. The cells run as the reference's (ONNX gate order),
    never through cuDNN's fused RNN, whose gate layout and summation order
    differ."""
    X, W, R = _promoted(ctx, *inputs[:3])
    B = _opt(inputs, 3)
    if B is not None:
        X, W, R, B = _promoted(ctx, X, W, R, B)
    if _opt(inputs, 4) is not None:
        raise UnsupportedOp("sequence_lens in recurrent ops (pad/mask "
                            "upstream instead — static shapes)")
    acts = node.attr("activations")
    if acts and [a.lower() for a in acts] not in allowed_acts:
        raise UnsupportedOp(f"{node.op_type} activations {acts} "
                            "(spec defaults only)")
    if node.attr("clip") is not None:
        raise UnsupportedOp("RNN cell clipping")
    direction = node.attr("direction", "forward")
    if direction not in ("forward", "reverse", "bidirectional"):
        raise UnsupportedOp(f"RNN direction {direction!r}")
    return X, W, R, B, direction


def _run_directions(X, W, R, B, h0s, extra0s, direction, cell):
    """``cell`` over time for each direction → per direction (ys (T, B, H),
    final carry)."""
    results = []
    for d in range(W.shape[0]):
        reverse = (direction == "reverse") or \
            (direction == "bidirectional" and d == 1)
        xs = X.flip(0) if reverse else X
        carry = (h0s[d],) + tuple(e[d] for e in extra0s)
        Bd = B[d] if B is not None else None
        ys = []
        for t in range(xs.shape[0]):
            carry, y = cell(carry, xs[t], W[d], R[d], Bd)
            ys.append(y)
        ys = torch.stack(ys) if ys else carry[0][None][:0]
        results.append((ys.flip(0) if reverse else ys, carry))
    return results


def _initial(inputs, i, ctx, shape, like):
    v = _opt(inputs, i)
    return _as_tensor(v, ctx, like.dtype) if v is not None else \
        torch.zeros(shape, dtype=like.dtype, device=like.device)


@register_op("LSTM")
def _lstm(node, inputs, ctx):
    """ONNX LSTM (gate order i, o, f, c; sigmoid, tanh, tanh)."""
    X, W, R, B, direction = _rnn_common(node, inputs, ctx)
    H = int(node.attr("hidden_size"))
    shape = (W.shape[0], X.shape[1], H)
    h0 = _initial(inputs, 5, ctx, shape, X)
    c0 = _initial(inputs, 6, ctx, shape, X)
    if _opt(inputs, 7) is not None:
        raise UnsupportedOp("LSTM peephole weights (input P)")

    def cell(carry, x, W, R, B):
        h, c = carry
        gates = x @ W.T + h @ R.T
        if B is not None:
            gates = gates + B[:4 * H] + B[4 * H:]
        i, o, f, g = torch.split(gates, H, dim=-1)
        i, o, f = (torch.sigmoid(v) for v in (i, o, f))
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        return (h_new, c_new), h_new

    res = _run_directions(X, W, R, B, h0, (c0,), direction, cell)
    Y = torch.stack([ys for ys, _ in res], dim=1)         # (T, dirs, B, H)
    Y_h = torch.stack([carry[0] for _, carry in res], dim=0)
    Y_c = torch.stack([carry[1] for _, carry in res], dim=0)
    return Y, Y_h, Y_c


@register_op("GRU")
def _gru(node, inputs, ctx):
    """ONNX GRU (gate order z, r, h; honours ``linear_before_reset``)."""
    X, W, R, B, direction = _rnn_common(node, inputs, ctx)
    H = int(node.attr("hidden_size"))
    lbr = bool(node.attr("linear_before_reset", 0))
    h0 = _initial(inputs, 5, ctx, (W.shape[0], X.shape[1], H), X)

    def cell(carry, x, W, R, B):
        (h,) = carry
        wb = B[:3 * H] if B is not None else 0.0
        rb = B[3 * H:] if B is not None else 0.0
        gx = x @ W.T + wb                               # (B, 3H)
        gh = h @ R.T + rb
        zx, rx, hx = torch.split(gx, H, dim=-1)
        zh, rh, hh = torch.split(gh, H, dim=-1)
        z = torch.sigmoid(zx + zh)
        r = torch.sigmoid(rx + rh)
        if lbr:
            # the reset after the recurrent matmul (gh already has Rbh)
            n = torch.tanh(hx + r * hh)
        else:
            # the ONNX default: the reset before the recurrent matmul
            rbh = B[5 * H:6 * H] if B is not None else 0.0
            n = torch.tanh(hx + (r * h) @ R[2 * H:].T + rbh)
        h_new = (1 - z) * n + z * h
        return (h_new,), h_new

    res = _run_directions(X, W, R, B, h0, (), direction, cell)
    Y = torch.stack([ys for ys, _ in res], dim=1)
    Y_h = torch.stack([carry[0] for _, carry in res], dim=0)
    return Y, Y_h


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
    """Walk a node list, writing outputs into ``env`` (top-level graphs and
    control-flow bodies share it; ``ctx.scope_env`` is ``env`` meanwhile).
    If/Loop/Scan never fold on the host: their bodies read outer-scope
    values their inputs do not show."""
    outer = ctx.scope_env
    ctx.scope_env = env
    try:
        for node in nodes:
            ins = [env[i] if i else None for i in node.input]
            host = node.op_type not in _SUBGRAPH_OPS and any(
                v is not None for v in ins) and all(
                v is None or _is_host(v) for v in ins)
            np_handler = NUMPY_OPS.get(node.op_type)
            if host and np_handler is not None:
                out = np_handler(node, ins, ctx)
            else:
                handler = OP_HANDLERS.get(node.op_type)
                if handler is None:
                    raise UnsupportedOp(
                        f"ONNX op {node.op_type!r} (node {node.name!r}) has "
                        f"no handler ({len(OP_HANDLERS)} ops have one, the "
                        f"JAX converter's set)")
                if host:
                    # constants only: fold on the host, keep the result there
                    out = _to_host(handler(
                        node, ins, _Ctx(ctx.opset, torch.device("cpu"))))
                else:
                    out = handler(node, ins, ctx)
            if isinstance(out, tuple):
                for name, val in zip(node.output, out):
                    if name:
                        env[name] = val
            else:
                env[node.output[0]] = out
    finally:
        ctx.scope_env = outer


class ConvertedModel:
    """An ONNX graph as a PyTorch callable.

    ``fn(params, feeds)`` returns ``{output_name: tensor}``; ``params`` is
    the float initializer dict (numpy here; callers pass it placed and
    cast), so callers can cast it independently. Integer, bool and 0-d
    initializers are shape constants, axes and indices: they stay numpy in
    ``const_params`` and fold on the host. Initializers stored as external
    data are read from ``external_data_dir`` (paths resolved under it).
    """

    def __init__(self, model: ModelProto, external_data_dir=None):
        self.model = model
        g = model.graph
        all_inits = {t.name: tensor_to_numpy(t, external_data_dir)
                     for t in g.initializers}
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
            # GroupQueryAttention writes its cache feeds in place: a numpy
            # feed is copied where a CPU tensor would alias it (on the card
            # the upload is the copy); a tensor feed is written as given
            if _is_host(val) and device.type == "cpu":
                val = np.array(val)
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
        outer-scope names).
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


def convert_model(model_bytes: bytes,
                  external_data_dir=None) -> ConvertedModel:
    """``external_data_dir``: the directory holding the sidecar files of a
    model saved with external data (torch's ``save_as_external_data``)."""
    return ConvertedModel(parse_model(model_bytes), external_data_dir)


# the ai.onnx.ml domain (tree ensembles, linear models, preprocessing), the
# ORT generation meta-ops and the long-tail standard ops register themselves
# on import; placed at the module's end so register_op exists
from . import extra_ops, generation_ops, ml_ops  # noqa: E402,F401
