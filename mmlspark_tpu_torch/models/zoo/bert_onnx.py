"""BERT-encoder ONNX exporter in *torch-exporter style* (counterpart of
``mmlspark_tpu/models/zoo/bert_onnx.py``) — foreign-graph fodder for the
converter.

The reference's ONNXModel consumes graphs produced by real exporters
(``deep-learning/.../onnx/ONNXModel.scala:195-245`` type handling). The
converter must therefore digest the patterns ``torch.onnx.export`` actually
emits for transformer encoders, not just the clean graphs of the zoo:

* dynamic batch/sequence axes (``dim_param`` on graph inputs)
* Shape → Gather → Unsqueeze → Concat → Reshape arithmetic for every
  attention head split/merge (no static reshape targets)
* attention-mask path: Unsqueeze/Cast/Sub/Mul by -1e4, added to the logits
* opset-dependent emission: ``axes`` as attributes (opset 11) vs inputs
  (13+); decomposed LayerNorm (ReduceMean/Sub/Pow/Sqrt/Div) below opset 17
  vs fused ``LayerNormalization``; decomposed erf-GELU at every opset

The module is numpy over the port's builder, so the same config and seed
write the same nodes, attributes and initializers as the JAX package's.
``bert_reference`` recomputes the same network in pure numpy so tests can
assert numerical parity with the converted graph. With
``external_data_dir`` the weight matrices spill to a sidecar file, as
torch's ``save_as_external_data`` writes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ...onnx.builder import (make_external_tensor, make_graph, make_model,
                             make_node, make_tensor_value_info)

__all__ = ["BertOnnxConfig", "init_bert_params", "export_bert_onnx",
           "bert_reference"]


@dataclass
class BertOnnxConfig:
    vocab: int = 128
    layers: int = 2
    d_model: int = 64
    heads: int = 4
    d_ff: int = 128
    max_len: int = 64


def init_bert_params(cfg: BertOnnxConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {
        "embed.word": rng.normal(0, 0.02, (cfg.vocab, cfg.d_model)),
        "embed.pos": rng.normal(0, 0.02, (cfg.max_len, cfg.d_model)),
        "embed.ln.g": np.ones(cfg.d_model), "embed.ln.b": np.zeros(cfg.d_model),
    }
    for i in range(cfg.layers):
        for nm in ("q", "k", "v", "o"):
            p[f"l{i}.{nm}.w"] = rng.normal(0, 0.02, (cfg.d_model, cfg.d_model))
            p[f"l{i}.{nm}.b"] = np.zeros(cfg.d_model)
        p[f"l{i}.ln1.g"] = np.ones(cfg.d_model)
        p[f"l{i}.ln1.b"] = np.zeros(cfg.d_model)
        p[f"l{i}.ff1.w"] = rng.normal(0, 0.02, (cfg.d_model, cfg.d_ff))
        p[f"l{i}.ff1.b"] = np.zeros(cfg.d_ff)
        p[f"l{i}.ff2.w"] = rng.normal(0, 0.02, (cfg.d_ff, cfg.d_model))
        p[f"l{i}.ff2.b"] = np.zeros(cfg.d_model)
        p[f"l{i}.ln2.g"] = np.ones(cfg.d_model)
        p[f"l{i}.ln2.b"] = np.zeros(cfg.d_model)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _ln_np(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * g + b


def _gelu_np(x):
    from scipy.special import erf  # scipy ships with sklearn's deps
    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


def bert_reference(params: Dict[str, np.ndarray], ids: np.ndarray,
                   mask: np.ndarray, cfg: BertOnnxConfig) -> np.ndarray:
    """Numpy forward pass matching export_bert_onnx's graph exactly."""
    B, S = ids.shape
    H, Dh = cfg.heads, cfg.d_model // cfg.heads
    x = params["embed.word"][ids] + params["embed.pos"][:S][None]
    x = _ln_np(x, params["embed.ln.g"], params["embed.ln.b"])
    att_bias = (1.0 - mask.astype(np.float32))[:, None, None, :] * -10000.0
    for i in range(cfg.layers):
        def proj(nm):
            w, b = params[f"l{i}.{nm}.w"], params[f"l{i}.{nm}.b"]
            return (x @ w + b).reshape(B, S, H, Dh).transpose(0, 2, 1, 3)
        q, k, v = proj("q"), proj("k"), proj("v")
        logits = q @ k.transpose(0, 1, 3, 2) / np.sqrt(Dh) + att_bias
        e = np.exp(logits - logits.max(-1, keepdims=True))
        a = e / e.sum(-1, keepdims=True)
        ctxt = (a @ v).transpose(0, 2, 1, 3).reshape(B, S, cfg.d_model)
        attn_out = ctxt @ params[f"l{i}.o.w"] + params[f"l{i}.o.b"]
        x = _ln_np(x + attn_out, params[f"l{i}.ln1.g"], params[f"l{i}.ln1.b"])
        h = _gelu_np(x @ params[f"l{i}.ff1.w"] + params[f"l{i}.ff1.b"])
        ff = h @ params[f"l{i}.ff2.w"] + params[f"l{i}.ff2.b"]
        x = _ln_np(x + ff, params[f"l{i}.ln2.g"], params[f"l{i}.ln2.b"])
    return x


class _G:
    """Tiny emission helper: unique names + node list."""

    def __init__(self, opset: int):
        self.nodes = []
        self.inits: Dict[str, object] = {}
        self.opset = opset
        self._n = 0

    def name(self, hint="t"):
        self._n += 1
        return f"{hint}_{self._n}"

    def add(self, op, inputs, n_out=1, **attrs):
        outs = [self.name(op.lower()) for _ in range(n_out)]
        self.nodes.append(make_node(op, inputs, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def const(self, arr, hint="c"):
        nm = self.name(hint)
        self.inits[nm] = np.asarray(arr)
        return nm

    # -- opset-sensitive emission ------------------------------------------
    def unsqueeze(self, x, axes):
        if self.opset >= 13:
            return self.add("Unsqueeze", [x, self.const(np.array(axes, np.int64))])
        return self.add("Unsqueeze", [x], axes=[int(a) for a in axes])

    def reduce_mean(self, x, axes, keepdims=1):
        if self.opset >= 18:
            return self.add("ReduceMean",
                            [x, self.const(np.array(axes, np.int64))],
                            keepdims=keepdims)
        return self.add("ReduceMean", [x], axes=[int(a) for a in axes],
                        keepdims=keepdims)

    def layernorm(self, x, g_name, b_name):
        if self.opset >= 17:
            return self.add("LayerNormalization", [x, g_name, b_name],
                            axis=-1, epsilon=1e-5)
        mu = self.reduce_mean(x, [-1])
        diff = self.add("Sub", [x, mu])
        sq = self.add("Pow", [diff, self.const(np.array(2.0, np.float32))])
        var = self.reduce_mean(sq, [-1])
        veps = self.add("Add", [var, self.const(np.array(1e-5, np.float32))])
        std = self.add("Sqrt", [veps])
        normed = self.add("Div", [diff, std])
        scaled = self.add("Mul", [normed, g_name])
        return self.add("Add", [scaled, b_name])

    def gelu(self, x):
        # erf-GELU exactly as torch decomposes it
        scaled = self.add("Div", [x, self.const(np.array(np.sqrt(2.0), np.float32))])
        e = self.add("Erf", [scaled])
        one = self.add("Add", [e, self.const(np.array(1.0, np.float32))])
        half = self.add("Mul", [x, one])
        return self.add("Mul", [half, self.const(np.array(0.5, np.float32))])

    def dyn_reshape(self, x, shape_src, tail):
        """Reshape x to (dim0(shape_src), dim1(shape_src), *tail) computed
        via Shape/Gather/Concat — the torch exporter's dynamic pattern."""
        shp = self.add("Shape", [shape_src])
        dims = []
        for ax in (0, 1):
            g = self.add("Gather", [shp, self.const(np.array(ax, np.int64))],
                         axis=0)
            dims.append(self.unsqueeze(g, [0]))
        dims.append(self.const(np.array(list(tail), np.int64)))
        target = self.add("Concat", dims, axis=0)
        return self.add("Reshape", [x, target])


def export_bert_onnx(cfg: BertOnnxConfig = BertOnnxConfig(), seed: int = 0,
                     opset: int = 13,
                     external_data_dir: Optional[str] = None,
                     params: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """Serialize the encoder as an ONNX graph in torch-exporter style.

    With ``external_data_dir`` set, weight matrices are spilled to a sidecar
    ``weights.bin`` (single file, offset-packed — the torch layout)."""
    p = params if params is not None else init_bert_params(cfg, seed)
    H, Dh = cfg.heads, cfg.d_model // cfg.heads
    g = _G(opset)

    # parameters as initializers (optionally external)
    offset = 0
    for k, v in p.items():
        if external_data_dir is not None and v.ndim >= 2:
            g.inits[k] = make_external_tensor(k, v, "weights.bin",
                                              external_data_dir, offset)
            offset += v.nbytes
        else:
            g.inits[k] = v

    ids, mask = "input_ids", "attention_mask"
    # embeddings: word Gather + position Slice (torch emits Slice over the
    # position table with a Shape-derived end)
    we = g.add("Gather", ["embed.word", ids], axis=0)
    seq_shape = g.add("Shape", [ids])
    s_dim = g.add("Gather", [seq_shape, g.const(np.array(1, np.int64))], axis=0)
    s_1d = g.unsqueeze(s_dim, [0])
    pos = g.add("Slice", ["embed.pos", g.const(np.array([0], np.int64)), s_1d,
                          g.const(np.array([0], np.int64))])
    x = g.add("Add", [we, pos])
    x = g.layernorm(x, "embed.ln.g", "embed.ln.b")

    # attention bias: (1 - mask) * -1e4, broadcast (B,1,1,S)
    mf = g.add("Cast", [mask], to=1)  # float32
    inv = g.add("Sub", [g.const(np.array(1.0, np.float32)), mf])
    bias = g.add("Mul", [inv, g.const(np.array(-10000.0, np.float32))])
    bias = g.unsqueeze(bias, [1, 2])

    for i in range(cfg.layers):
        def head_proj(nm, x=x, i=i):
            mm = g.add("MatMul", [x, f"l{i}.{nm}.w"])
            ad = g.add("Add", [mm, f"l{i}.{nm}.b"])
            r = g.dyn_reshape(ad, ids, (H, Dh))
            return g.add("Transpose", [r], perm=[0, 2, 1, 3])
        q, k, v = head_proj("q"), head_proj("k"), head_proj("v")
        kT = g.add("Transpose", [k], perm=[0, 1, 3, 2])
        logits = g.add("MatMul", [q, kT])
        logits = g.add("Div", [logits,
                               g.const(np.array(np.sqrt(Dh), np.float32))])
        logits = g.add("Add", [logits, bias])
        att = g.add("Softmax", [logits], axis=3)
        ctxt = g.add("MatMul", [att, v])
        ctxt = g.add("Transpose", [ctxt], perm=[0, 2, 1, 3])
        ctxt = g.dyn_reshape(ctxt, ids, (cfg.d_model,))
        attn_out = g.add("Add", [g.add("MatMul", [ctxt, f"l{i}.o.w"]),
                                 f"l{i}.o.b"])
        x = g.layernorm(g.add("Add", [x, attn_out]),
                        f"l{i}.ln1.g", f"l{i}.ln1.b")
        h = g.gelu(g.add("Add", [g.add("MatMul", [x, f"l{i}.ff1.w"]),
                                 f"l{i}.ff1.b"]))
        ff = g.add("Add", [g.add("MatMul", [h, f"l{i}.ff2.w"]), f"l{i}.ff2.b"])
        x = g.layernorm(g.add("Add", [x, ff]), f"l{i}.ln2.g", f"l{i}.ln2.b")

    # rename final output
    g.nodes.append(make_node("Identity", [x], ["last_hidden_state"]))

    # mask-weighted mean pooling → "pooled" (B, D): the sentence-embedding
    # output (sentence-transformers' mean_pooling pattern). Fetching this
    # instead of last_hidden_state cuts the device→host transfer by S×,
    # which is what the BASELINE config #3 pipeline actually wants.
    mexp = g.unsqueeze(mf, [2])                       # (B, S, 1)
    xm = g.add("Mul", [x, mexp])
    if opset >= 13:
        ssum = g.add("ReduceSum", [xm, g.const(np.array([1], np.int64))],
                     keepdims=0)
        cnt = g.add("ReduceSum", [mexp, g.const(np.array([1], np.int64))],
                    keepdims=0)
    else:
        ssum = g.add("ReduceSum", [xm], axes=[1], keepdims=0)
        cnt = g.add("ReduceSum", [mexp], axes=[1], keepdims=0)
    cnt = g.add("Clip", [cnt, g.const(np.array(1e-9, np.float32)),
                         g.const(np.array(3.4e38, np.float32))])
    pooled = g.add("Div", [ssum, cnt])
    g.nodes.append(make_node("Identity", [pooled], ["pooled"]))

    graph = make_graph(
        g.nodes, "bert_encoder",
        inputs=[make_tensor_value_info(ids, np.int64, ("batch", "seq")),
                make_tensor_value_info(mask, np.int64, ("batch", "seq"))],
        outputs=[make_tensor_value_info("last_hidden_state", np.float32,
                                        ("batch", "seq", cfg.d_model)),
                 make_tensor_value_info("pooled", np.float32,
                                        ("batch", cfg.d_model))],
        initializers=g.inits)
    return make_model(graph, opset=opset, producer="pytorch-style")
