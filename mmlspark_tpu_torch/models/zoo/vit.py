"""Vision Transformer (ViT) for the model zoo — torch-exporter-style ONNX
(counterpart of ``mmlspark_tpu/models/zoo/vit.py``).

Widens the zoo's image family beyond CNNs: the reference's downloader
ships CNN image models consumed by ``ImageFeaturizer``
(``cntk/ImageFeaturizer.scala:100-108``); a ViT exercises the SAME
cut-layer surface (outputs named ``feat``/``logits``, the featurizer's
defaults) with a transformer body. In the port the graph runs through
``ONNXModel``, and through the ported featurizer, int8 weight-only
quantization and fine-tuning (ROADMAP queue items 5, 4 and 23).

The export mirrors how torch serializes ViTs: patchify is a strided
``Conv`` + ``Reshape`` + ``Transpose``, the class token ``Expand``s over
a Shape-derived batch dim, encoder blocks are pre-LN attention/MLP, and
``feat`` is the final-LN class-token row. ``vit_reference`` is the
pure-numpy oracle the tests pin the converted graph against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ...onnx.builder import make_graph, make_model, make_node, \
    make_tensor_value_info
from .bert_onnx import _G, _gelu_np, _ln_np

__all__ = ["ViTConfig", "init_vit_params", "vit_reference",
           "export_vit_onnx"]


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 64
    patch: int = 16
    d_model: int = 128
    heads: int = 4
    layers: int = 4
    d_ff: int = 256
    num_classes: int = 10

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


def init_vit_params(cfg: ViTConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    D, F = cfg.d_model, cfg.d_ff

    def w(*shape, scale=None):
        s = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return rng.normal(0, s, shape).astype(np.float32)

    p = {
        "patch.w": rng.normal(0, 0.02,
                              (D, 3, cfg.patch, cfg.patch)).astype(np.float32),
        "patch.b": np.zeros(D, np.float32),
        "cls": rng.normal(0, 0.02, (1, 1, D)).astype(np.float32),
        "pos": rng.normal(0, 0.02,
                          (1, cfg.n_patches + 1, D)).astype(np.float32),
        "final_ln.g": np.ones(D, np.float32),
        "final_ln.b": np.zeros(D, np.float32),
        "head.w": w(D, cfg.num_classes),
        "head.b": np.zeros(cfg.num_classes, np.float32),
    }
    for i in range(cfg.layers):
        for nm, shape in [("q", (D, D)), ("k", (D, D)), ("v", (D, D)),
                          ("o", (D, D)), ("ff1", (D, F)), ("ff2", (F, D))]:
            p[f"l{i}.{nm}.w"] = w(*shape)
            p[f"l{i}.{nm}.b"] = np.zeros(shape[1], np.float32)
        for ln in ("ln1", "ln2"):
            p[f"l{i}.{ln}.g"] = np.ones(D, np.float32)
            p[f"l{i}.{ln}.b"] = np.zeros(D, np.float32)
    return p


def vit_reference(params: Dict[str, np.ndarray], pixels: np.ndarray,
                  cfg: ViTConfig):
    """Numpy forward: pixels (B, 3, S, S) float32 → (feat (B, D),
    logits (B, classes)). Patchify exploits stride == kernel: a reshape
    + one matmul equals the strided conv."""
    B = pixels.shape[0]
    P, D, H = cfg.patch, cfg.d_model, cfg.heads
    hd = D // H
    n_side = cfg.image_size // P
    x = pixels.reshape(B, 3, n_side, P, n_side, P)
    x = x.transpose(0, 2, 4, 1, 3, 5).reshape(B, n_side * n_side, 3 * P * P)
    wp = params["patch.w"].reshape(D, 3 * P * P)
    x = x @ wp.T + params["patch.b"]                       # (B, N, D)
    x = np.concatenate([np.broadcast_to(params["cls"], (B, 1, D)), x],
                       axis=1) + params["pos"]
    N = x.shape[1]
    for i in range(cfg.layers):
        h = _ln_np(x, params[f"l{i}.ln1.g"], params[f"l{i}.ln1.b"])

        def heads(nm, h=h, i=i):
            t = h @ params[f"l{i}.{nm}.w"] + params[f"l{i}.{nm}.b"]
            return t.reshape(B, N, H, hd).transpose(0, 2, 1, 3)

        q, k, v = heads("q"), heads("k"), heads("v")
        s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(hd)
        a = np.exp(s - s.max(-1, keepdims=True))
        a = a / a.sum(-1, keepdims=True)
        ctx = (a @ v).transpose(0, 2, 1, 3).reshape(B, N, D)
        x = x + ctx @ params[f"l{i}.o.w"] + params[f"l{i}.o.b"]
        h = _ln_np(x, params[f"l{i}.ln2.g"], params[f"l{i}.ln2.b"])
        h = _gelu_np(h @ params[f"l{i}.ff1.w"] + params[f"l{i}.ff1.b"])
        x = x + h @ params[f"l{i}.ff2.w"] + params[f"l{i}.ff2.b"]
    x = _ln_np(x, params["final_ln.g"], params["final_ln.b"])
    feat = x[:, 0]
    return feat, feat @ params["head.w"] + params["head.b"]


def export_vit_onnx(cfg: ViTConfig = ViTConfig(), seed: int = 0,
                    opset: int = 17,
                    params: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """Serialize the ViT as ONNX with outputs ``feat`` (class-token
    embedding, the ImageFeaturizer default) and ``logits``."""
    p = params if params is not None else init_vit_params(cfg, seed)
    D, H = cfg.d_model, cfg.heads
    hd = D // H
    g = _G(opset)
    g.inits.update(p)

    px = "pixel_values"
    conv = g.add("Conv", [px, "patch.w", "patch.b"],
                 strides=[cfg.patch, cfg.patch])            # (B, D, h, w)
    flat = g.add("Reshape", [conv, g.const(np.array([0, D, -1], np.int64))])
    toks = g.add("Transpose", [flat], perm=[0, 2, 1])       # (B, N, D)
    # cls token expands over the Shape-derived batch dim (torch's pattern)
    shp = g.add("Shape", [px])
    b_dim = g.add("Gather", [shp, g.const(np.array(0, np.int64))], axis=0)
    b_1d = g.unsqueeze(b_dim, [0])
    tgt = g.add("Concat", [b_1d, g.const(np.array([1, D], np.int64))],
                axis=0)
    cls = g.add("Expand", ["cls", tgt])
    x = g.add("Concat", [cls, toks], axis=1)
    x = g.add("Add", [x, "pos"])

    for i in range(cfg.layers):
        h = g.layernorm(x, f"l{i}.ln1.g", f"l{i}.ln1.b")

        def head_proj(nm, h=h, i=i):
            mm = g.add("MatMul", [h, f"l{i}.{nm}.w"])
            ad = g.add("Add", [mm, f"l{i}.{nm}.b"])
            r = g.dyn_reshape(ad, h, (H, hd))
            return g.add("Transpose", [r], perm=[0, 2, 1, 3])

        q, k, v = head_proj("q"), head_proj("k"), head_proj("v")
        kT = g.add("Transpose", [k], perm=[0, 1, 3, 2])
        s = g.add("MatMul", [q, kT])
        s = g.add("Div", [s, g.const(np.array(np.sqrt(hd), np.float32))])
        a = g.add("Softmax", [s], axis=3)
        ctx = g.add("MatMul", [a, v])
        ctx = g.add("Transpose", [ctx], perm=[0, 2, 1, 3])
        ctx = g.dyn_reshape(ctx, h, (D,))
        attn = g.add("Add", [g.add("MatMul", [ctx, f"l{i}.o.w"]),
                             f"l{i}.o.b"])
        x = g.add("Add", [x, attn])                        # pre-LN residual
        h2 = g.layernorm(x, f"l{i}.ln2.g", f"l{i}.ln2.b")
        ff = g.gelu(g.add("Add", [g.add("MatMul", [h2, f"l{i}.ff1.w"]),
                                  f"l{i}.ff1.b"]))
        ff = g.add("Add", [g.add("MatMul", [ff, f"l{i}.ff2.w"]),
                           f"l{i}.ff2.b"])
        x = g.add("Add", [x, ff])

    x = g.layernorm(x, "final_ln.g", "final_ln.b")
    cls_row = g.add("Gather", [x, g.const(np.array(0, np.int64))], axis=1)
    g.nodes.append(make_node("Identity", [cls_row], ["feat"]))
    logits = g.add("Add", [g.add("MatMul", [cls_row, "head.w"]), "head.b"])
    g.nodes.append(make_node("Identity", [logits], ["logits"]))

    S = cfg.image_size
    graph = make_graph(
        g.nodes, "vit",
        inputs=[make_tensor_value_info(px, np.float32,
                                       ("batch", 3, S, S))],
        outputs=[make_tensor_value_info("feat", np.float32,
                                        ("batch", D)),
                 make_tensor_value_info("logits", np.float32,
                                        ("batch", cfg.num_classes))],
        initializers=g.inits)
    return make_model(graph, opset=opset, producer="pytorch-style")
