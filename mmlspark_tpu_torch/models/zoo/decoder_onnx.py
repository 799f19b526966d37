"""Export the zoo's Llama-style decoder as an ONNX decode-step graph
(counterpart of ``mmlspark_tpu/models/zoo/decoder_onnx.py``).

The graph is the shape real decoder exports take for serving: ONE token in,
logits out, per-layer kv caches as static (B, H, S_max, D) inputs/outputs
flowing through ORT-contrib ``GroupQueryAttention`` nodes with fused rotary
(``do_rotary``) — the op surface ``onnx/convert.py`` executes with
in-place cache writes. Stepping this graph through ``convert_model`` must
reproduce the zoo transformer's decode-step logits in fp32, which
cross-validates the GQA/rotary/RMSNorm handlers against an independent
implementation with learned weights.

``params`` is the zoo's param tree: numpy arrays (``init_transformer``) or
the port's tensors (``params_from_numpy``); either writes the same
initializers.

Parity role: the reference serves exported decoder graphs through
ONNXModel/ORT (``deep-learning/.../onnx/ONNXModel.scala:173-193``); this is
the native path for bringing the zoo's trained decoders to that same wire
format.
"""

from __future__ import annotations

import numpy as np
import torch

from ...onnx.builder import (make_graph, make_model, make_node,
                             make_tensor_value_info)
from .transformer import TransformerConfig

__all__ = ["export_decoder_onnx"]


def _f32(a) -> np.ndarray:
    """A param leaf (numpy array or tensor, any float dtype) as float32
    numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def export_decoder_onnx(cfg: TransformerConfig, params: dict,
                        max_len: int) -> bytes:
    """Serialize ``params`` (an :func:`init_transformer` tree, or its
    :func:`params_from_numpy` tensors, for a causal/rmsnorm/rope config)
    as a decode-step ONNX graph with ``max_len``-slot kv caches."""
    if not (cfg.causal and cfg.norm == "rmsnorm"
            and cfg.position == "rope"):
        raise ValueError("export_decoder_onnx needs the decoder switches "
                         "(causal=True, norm='rmsnorm', position='rope')")
    if cfg.moe_experts:
        raise ValueError("MoE layers have no ONNX decode-step form here")
    D = cfg.d_model
    H = cfg.heads
    hd = D // H
    if hd % 2:
        # same guard as the zoo's _rope_tables: an odd head dim has no
        # split-half rotation, so the export would match no native model
        raise ValueError(f"rotary embeddings need an even head dim, got "
                         f"{hd} (d_model/heads)")
    half = hd // 2

    inits = {"embed_tok": _f32(params["embed"]["tok"])}
    # rope caches, the zoo's exact split-half tables
    freqs = 1.0 / (cfg.rope_theta
                   ** (np.arange(0, half, dtype=np.float32) / half))
    ang = np.arange(max_len, dtype=np.float32)[:, None] * freqs
    inits["cos_cache"] = np.cos(ang).astype(np.float32)
    inits["sin_cache"] = np.sin(ang).astype(np.float32)

    nodes = [make_node("Gather", ["embed_tok", "token"], ["h0"], axis=0)]
    h = "h0"
    graph_inputs = [
        make_tensor_value_info("token", np.int64, ["B", 1]),
        make_tensor_value_info("seqlens", np.int32, ["B"]),
        make_tensor_value_info("total", np.int32, []),
    ]
    graph_outputs = []

    for i, lp in enumerate(params["layers"]):
        w = _f32(lp["qkv"]["w"])
        b = _f32(lp["qkv"]["b"])
        inits[f"ln1_{i}"] = _f32(lp["ln1"]["scale"])
        inits[f"ln2_{i}"] = _f32(lp["ln2"]["scale"])
        for name, sl in (("q", slice(0, D)), ("k", slice(D, 2 * D)),
                         ("v", slice(2 * D, 3 * D))):
            inits[f"w{name}_{i}"] = w[:, sl].copy()
            inits[f"b{name}_{i}"] = b[sl].copy()
        inits[f"wo_{i}"] = _f32(lp["out"]["w"])
        inits[f"bo_{i}"] = _f32(lp["out"]["b"])
        inits[f"w1_{i}"] = _f32(lp["w1"]["w"])
        inits[f"b1_{i}"] = _f32(lp["w1"]["b"])
        inits[f"w2_{i}"] = _f32(lp["w2"]["w"])
        inits[f"b2_{i}"] = _f32(lp["w2"]["b"])

        nodes += [
            make_node("SimplifiedLayerNormalization", [h, f"ln1_{i}"],
                      [f"x_{i}"], epsilon=1e-6, axis=-1),
        ]
        for name in ("q", "k", "v"):
            nodes += [
                make_node("MatMul", [f"x_{i}", f"w{name}_{i}"],
                          [f"{name}mm_{i}"]),
                make_node("Add", [f"{name}mm_{i}", f"b{name}_{i}"],
                          [f"{name}_{i}"]),
            ]
        nodes.append(make_node(
            "GroupQueryAttention",
            [f"q_{i}", f"k_{i}", f"v_{i}", f"past_k_{i}", f"past_v_{i}",
             "seqlens", "total", "cos_cache", "sin_cache"],
            [f"attn_{i}", f"present_k_{i}", f"present_v_{i}"],
            domain="com.microsoft", num_heads=H, kv_num_heads=H,
            do_rotary=1, rotary_interleaved=0))
        nodes += [
            make_node("MatMul", [f"attn_{i}", f"wo_{i}"], [f"omm_{i}"]),
            make_node("Add", [f"omm_{i}", f"bo_{i}"], [f"oproj_{i}"]),
            make_node("Add", [h, f"oproj_{i}"], [f"hattn_{i}"]),
            make_node("SimplifiedLayerNormalization",
                      [f"hattn_{i}", f"ln2_{i}"], [f"y_{i}"],
                      epsilon=1e-6, axis=-1),
            make_node("MatMul", [f"y_{i}", f"w1_{i}"], [f"ff1_{i}"]),
            # FastGelu (com.microsoft): tanh-approximate gelu with a fused
            # bias input — matches the zoo's jax.nn.gelu default AND loads
            # in real onnxruntime (ai.onnx Gelu only exists from opset 20;
            # this graph targets the ORT-optimizer op surface anyway)
            make_node("FastGelu", [f"ff1_{i}", f"b1_{i}"], [f"act_{i}"],
                      domain="com.microsoft"),
            make_node("MatMul", [f"act_{i}", f"w2_{i}"], [f"ff2_{i}"]),
            make_node("Add", [f"ff2_{i}", f"b2_{i}"], [f"ff2b_{i}"]),
            make_node("Add", [f"hattn_{i}", f"ff2b_{i}"], [f"h{i + 1}"]),
        ]
        h = f"h{i + 1}"
        graph_inputs += [
            make_tensor_value_info(f"past_k_{i}", np.float32,
                                   ["B", H, max_len, hd]),
            make_tensor_value_info(f"past_v_{i}", np.float32,
                                   ["B", H, max_len, hd]),
        ]
        graph_outputs += [
            make_tensor_value_info(f"present_k_{i}", np.float32,
                                   ["B", H, max_len, hd]),
            make_tensor_value_info(f"present_v_{i}", np.float32,
                                   ["B", H, max_len, hd]),
        ]

    inits["final_ln"] = _f32(params["final_ln"]["scale"])
    inits["lm_w"] = _f32(params["lm_head"]["w"])
    inits["sq_ax"] = np.array([1], np.int64)
    nodes += [
        make_node("SimplifiedLayerNormalization", [h, "final_ln"],
                  ["hf"], epsilon=1e-6, axis=-1),
        make_node("MatMul", ["hf", "lm_w"], ["logits3"]),
        make_node("Squeeze", ["logits3", "sq_ax"], ["logits"]),
    ]
    graph_outputs.insert(0, make_tensor_value_info(
        "logits", np.float32, ["B", cfg.vocab]))

    g = make_graph(nodes, "decoder_step", graph_inputs, graph_outputs,
                   initializers=inits)
    # the com.microsoft import is required for the GQA/FastGelu/
    # SimplifiedLayerNormalization nodes to load in real onnxruntime
    return make_model(g, opset=17, extra_opsets={"com.microsoft": 1})
