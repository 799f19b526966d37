"""The zoo transformer (counterpart of ``models/zoo/transformer.py``): the
config, seeded weights, the weight loader, the full-sequence forward
(:func:`transformer_apply`, dense or flash attention) with its trainer
(:func:`loss_fn`, :func:`train_step`), the cached prefill and ragged
decode steps, and the paged KV cache with its two attention
implementations.

Layouts are the JAX package's at every public function — (B, H, S, hd)
activations, (N, H, page, hd) page pools, a params dict with the same
keys — so the port and the reference compare like with like. Every
matrix is cast to ``cfg.dtype`` at its use, as the reference's
``.astype(dt)`` does: a serving dict from :func:`params_from_numpy`
holds the matrices already cast (the cast is then a no-op), a
``master=True`` dict holds f32 leaves that train.

The paged functions update the page pools IN PLACE and return the same
list (the JAX package returns fresh, donated buffers; a caller that
rebinds sees the same thing).

Tensor parallelism (``mesh=`` on :func:`prefill_cache` and the paged
decode functions): JAX lays the params out with ``param_shardings`` and
lets GSPMD partition one program; the port runs one process per rank of
the mesh's ``tp`` axis, each holding :func:`shard_params`' Megatron
slice (q/k/v by whole heads, ``w1`` by columns, ``out``/``w2`` by rows;
embeddings, norms and ``lm_head`` replicated) and its head shard of the
pages. The layer math is the same; the head count comes from the
weights, and after each row-parallel projection (``out``, ``w2``) one
``all_reduce`` (sum) runs on the ``tp`` group, whatever its size, before
the bias is added once. The logits are then the same bits on every rank.
With ``slot_axis="dp"`` on the paged decode functions the rows shard
too: each rank passes its ``B / dp`` rows (tokens, positions, block-table
rows, ``active``) and gets their logits, while the page pool replicates
over ``dp``; the fresh K/V rows of every dp shard are gathered and
written on every replica (the kernel path in the mount, the gather path
in its writeback).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ...ops.flash_attention import flash_attention
from ...ops.kv_quant import (SCALE_DTYPE, dequantize_kv, kv_store_dtype,
                             quantize_kv)
from ...ops.paged_attention import (_bits, _check_mesh_axes, _check_mount,
                                    _gather_fresh, paged_attention_window)
from ...parallel.mesh import axis_group, axis_size
from ...utils.device import resolve_device

__all__ = ["TransformerConfig", "BERT_BASE", "BERT_MINI", "DECODER_MINI",
           "init_transformer", "params_from_numpy", "shard_params",
           "transformer_apply",
           "loss_fn", "train_step", "tree_leaves", "prefill_cache",
           "decode_step_ragged", "decode_step_ragged_inplace",
           "decode_window_ragged",
           "init_paged_cache", "paged_gather",
           "paged_scatter_rows", "decode_step_paged", "decode_window_paged",
           "gelu", "init_kv_cache", "decode_step", "decode_window",
           "generate", "generate_cached", "generate_beam"]

_NEG = -1e30


class TransformerConfig(NamedTuple):
    vocab: int = 30522
    layers: int = 12
    d_model: int = 768
    heads: int = 12
    d_ff: int = 3072
    max_len: int = 512
    dtype: Any = torch.bfloat16
    #: mixture-of-experts FFNs (the reference's fields and defaults);
    #: moe_experts > 0 raises: MoE layers come with ROADMAP.md slice 6
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    #: attention through the flash kernels (``ops/flash_attention``)
    #: instead of the dense (B, H, S, S) scores. Only a fully padded row
    #: differs: dense gives the mean of v there, flash gives 0
    use_flash: bool = False
    causal: bool = False
    norm: str = "layernorm"        # "layernorm" | "rmsnorm"
    position: str = "learned"      # "learned" | "rope"
    rope_theta: float = 10000.0

    def is_moe_layer(self, i: int) -> bool:
        return (self.moe_experts > 0 and self.moe_every > 0
                and (i % self.moe_every) == (self.moe_every - 1))


#: the published BERT-base widths (the reference's default config)
BERT_BASE = TransformerConfig()
#: Llama-style decoder shape (causal + RMSNorm + RoPE); small enough to test
DECODER_MINI = TransformerConfig(vocab=1024, layers=4, d_model=256, heads=8,
                                 d_ff=1024, max_len=128, causal=True,
                                 norm="rmsnorm", position="rope")
BERT_MINI = TransformerConfig(vocab=1024, layers=4, d_model=256, heads=8,
                              d_ff=1024, max_len=128)


def _no_moe(cfg: TransformerConfig):
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "MoE layers (moe_experts > 0) need parallel/moe.py: ROADMAP.md "
            "slice 6 (multi-device)")


def init_transformer(cfg: TransformerConfig, seed: int = 0) -> Dict:
    """Seeded numpy weights — the reference's draw order verbatim, so the
    same seed gives bitwise the same arrays (dense layers only)."""
    _no_moe(cfg)
    rng = np.random.default_rng(seed)

    def dense(din, dout, scale=None):
        s = scale or np.sqrt(2.0 / (din + dout))
        return rng.normal(0, s, (din, dout)).astype(np.float32)

    def norm_p():
        p = {"scale": np.ones(cfg.d_model, np.float32)}
        if cfg.norm != "rmsnorm":       # RMSNorm has no bias
            p["bias"] = np.zeros(cfg.d_model, np.float32)
        return p

    params: Dict = {
        "embed": {"tok": dense(cfg.vocab, cfg.d_model, 0.02)},
        "layers": [],
        "final_ln": norm_p(),
        "lm_head": {"w": dense(cfg.d_model, cfg.vocab, 0.02)},
    }
    if cfg.position == "learned":
        params["embed"]["pos"] = dense(cfg.max_len, cfg.d_model, 0.02)
    for _ in range(cfg.layers):
        layer = {
            "ln1": norm_p(),
            "qkv": {"w": dense(cfg.d_model, 3 * cfg.d_model),
                    "b": np.zeros(3 * cfg.d_model, np.float32)},
            "out": {"w": dense(cfg.d_model, cfg.d_model),
                    "b": np.zeros(cfg.d_model, np.float32)},
            "ln2": norm_p(),
            "w1": {"w": dense(cfg.d_model, cfg.d_ff),
                   "b": np.zeros(cfg.d_ff, np.float32)},
            "w2": {"w": dense(cfg.d_ff, cfg.d_model),
                   "b": np.zeros(cfg.d_model, np.float32)},
        }
        params["layers"].append(layer)
    return params


def params_from_numpy(params: Dict, cfg: TransformerConfig,
                      device=None, master: bool = False) -> Dict:
    """The reference's param pytree (numpy arrays, or ``np.asarray`` of
    jax arrays) → the port's tensors on ``device`` (None = the card).

    Serving (``master=False``): embeddings, projection matrices and biases
    are cast ONCE to ``cfg.dtype``; norm scales/biases stay f32 (the norms
    run in f32) and ``lm_head`` stays f32 (the reference multiplies f32
    hidden by an f32 head). Training (``master=True``): every leaf stays
    f32 and requires grad; the forward casts each matrix to ``cfg.dtype``
    at its use, so gradients land on the f32 leaves, as in JAX."""
    dev = resolve_device(device)

    def t(a, dtype):
        x = torch.from_numpy(np.array(a, np.float32)).to(
            device=dev, dtype=torch.float32 if master else dtype)
        return x.requires_grad_(True) if master else x

    def norm(p):
        return {k: t(v, torch.float32) for k, v in p.items()}

    dt = cfg.dtype
    out = {"embed": {k: t(v, dt) for k, v in params["embed"].items()},
           "final_ln": norm(params["final_ln"]),
           "lm_head": {"w": t(params["lm_head"]["w"], torch.float32)},
           "layers": []}
    for lp in params["layers"]:
        if "moe" in lp:
            raise NotImplementedError("MoE layers come with ROADMAP.md "
                                      "slice 6 (multi-device)")
        out["layers"].append({
            "ln1": norm(lp["ln1"]), "ln2": norm(lp["ln2"]),
            **{name: {"w": t(lp[name]["w"], dt), "b": t(lp[name]["b"], dt)}
               for name in ("qkv", "out", "w1", "w2")}})
    return out


def shard_params(params: Dict, cfg: TransformerConfig, rank: int,
                 tp: int) -> Dict:
    """Rank ``rank`` of ``tp``'s Megatron slice of a numpy param tree
    (the port of ``param_shardings`` / ``shardings_for`` as explicit
    slices): q, k and v each keep the columns of heads
    ``[rank·H/tp, (rank+1)·H/tp)``, so a rank's heads are whole (JAX's
    ``P(None, "tp")`` on the fused ``qkv`` cuts its 3·d columns
    contiguously instead and lets GSPMD reshard); ``w1`` keeps a block
    of columns, ``out`` and ``w2`` the matching block of rows, their
    biases whole (added once, after the reduce). Embeddings, norms and
    ``lm_head`` are replicated. The result feeds
    :func:`params_from_numpy`."""
    _no_moe(cfg)
    if cfg.heads % tp:
        raise ValueError(f"heads {cfg.heads} not divisible by mesh tp={tp}")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by mesh tp={tp}")
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    d, f = cfg.d_model // tp, cfg.d_ff // tp
    hs, fs = slice(rank * d, (rank + 1) * d), slice(rank * f, (rank + 1) * f)

    def qkv(a):
        a = np.asarray(a)
        return np.concatenate([a[..., i * cfg.d_model:][..., hs]
                               for i in range(3)], axis=-1)

    out = {"embed": dict(params["embed"]), "final_ln": params["final_ln"],
           "lm_head": params["lm_head"], "layers": []}
    for lp in params["layers"]:
        if "moe" in lp:
            raise NotImplementedError("MoE layers come with ROADMAP.md "
                                      "slice 6 (multi-device)")
        out["layers"].append({
            "ln1": lp["ln1"], "ln2": lp["ln2"],
            "qkv": {"w": qkv(lp["qkv"]["w"]), "b": qkv(lp["qkv"]["b"])},
            "out": {"w": np.asarray(lp["out"]["w"])[hs],
                    "b": lp["out"]["b"]},
            "w1": {"w": np.asarray(lp["w1"]["w"])[:, fs],
                   "b": np.asarray(lp["w1"]["b"])[fs]},
            "w2": {"w": np.asarray(lp["w2"]["w"])[fs],
                   "b": lp["w2"]["b"]}})
    return out


def gelu(x):
    """``jax.nn.gelu``'s default form: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _ln(x, p, eps=1e-5):
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps) * p["scale"] + p["bias"]


def _rms(x, p, eps=1e-6):
    inv = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return x * inv * p["scale"]


def _norm(x, p, cfg):
    """Norm in f32 (callers pass ``h.float()``)."""
    return _rms(x, p) if cfg.norm == "rmsnorm" else _ln(x, p)


def _rope_tables(positions, D: int, theta: float, dtype):
    """cos/sin tables for split-half rotation at ``positions`` (any
    shape), in the activation dtype."""
    if D % 2:
        raise ValueError(f"rotary embeddings need an even head dim, got {D} "
                         f"(d_model/heads)")
    half = D // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _rot_half(t, cos, sin):
    half = t.shape[-1] // 2
    t0, t1 = t[..., :half], t[..., half:]
    return torch.cat([t0 * cos - t1 * sin, t0 * sin + t1 * cos], dim=-1)


def _rope(q, k, theta: float):
    """Rotary position embeddings on (B, H, S, D) q/k (split-half form)."""
    cos, sin = _rope_tables(torch.arange(q.shape[2], device=q.device),
                            q.shape[-1], theta, q.dtype)
    cos, sin = cos[None, None], sin[None, None]
    return _rot_half(q, cos, sin), _rot_half(k, cos, sin)


def _dense(x, p, dt):
    """``x @ w + b`` with both cast to ``dt`` at the use (a no-op on a
    serving dict)."""
    return x @ p["w"].to(dt) + p["b"].to(dt)


def _qkv_heads(x, lp, cfg, B, S):
    """q, k, v as (B, heads, S, hd); the head count is the weights' (all
    of ``cfg.heads``, or a rank's shard of them)."""
    hd = cfg.d_model // cfg.heads
    q, k, v = _dense(x, lp["qkv"], cfg.dtype).chunk(3, dim=-1)

    def heads(t):
        return t.reshape(B, S, -1, hd).transpose(1, 2)

    return heads(q), heads(k), heads(v)


def _row_dense(x, p, dt, group):
    """``x @ w + b`` for a row-parallel projection: with a ``tp`` group
    the rank's partial product is summed over the group (always, even a
    group of one) and the whole bias is added once, after the sum."""
    if group is None:
        return _dense(x, p, dt)
    y = x @ p["w"].to(dt)
    dist.all_reduce(y, group=group)
    return y + p["b"].to(dt)


def _ffn_residual(h, lp, cfg, ctx, B, S, group=None):
    """Output projection + residual, then the norm/FFN/residual half;
    ``group`` is the ``tp`` group that sums the row-parallel halves."""
    dt = cfg.dtype
    ctx = ctx.transpose(1, 2).reshape(B, S, -1)
    h = h + _row_dense(ctx, lp["out"], dt, group)
    x = _norm(h.float(), lp["ln2"], cfg).to(dt)
    y = gelu(_dense(x, lp["w1"], dt))
    return h + _row_dense(y, lp["w2"], dt, group)


def _mesh_group(mesh, cfg: TransformerConfig, B: int, slot_axis=None,
                head_axis=None):
    """The ``tp`` group the layer loop reduces over (None without a mesh
    or a head axis), after checking that the mesh names both axes and
    divides the heads. ``B`` is this rank's rows: with ``slot_axis`` the
    global batch is ``B`` times the axis size."""
    if mesh is None:
        return None
    _check_mesh_axes(mesh, slot_axis, head_axis)
    rows = B * (1 if slot_axis is None else axis_size(mesh, slot_axis))
    _check_mount(mesh, rows, cfg.heads, slot_axis, head_axis)
    return None if head_axis is None else axis_group(mesh, head_axis)


def _attend(q, k, v, ok, dt):
    """Dense masked attention: f32 scores, ``-1e30`` outside ``ok``, f32
    softmax, probabilities cast to the activation dtype before ``p·v``."""
    hd = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) / np.float32(np.sqrt(hd))
    s = torch.where(ok, s, _NEG)
    p = torch.softmax(s, dim=-1).to(dt)
    return p @ v


def _embed(params, ids, cfg, positions):
    """Gathers from the tables cast to ``cfg.dtype`` (the reference's
    ``tok.astype(dt)[ids]``: in training the gradient is a scatter in
    ``cfg.dtype`` into the f32 leaf, as in JAX). Positions past the
    learned table clamp to its last row, as the reference's gather does:
    a speculative verify window writes up to gamma + 1 positions past a
    request's end, into the cache's headroom."""
    h = params["embed"]["tok"].to(cfg.dtype)[ids]
    if cfg.position == "learned":
        table = params["embed"]["pos"]
        h = h + table.to(cfg.dtype)[positions.clamp(max=table.shape[0] - 1)]
    return h


def _check_forward(cfg: TransformerConfig, mesh):
    if cfg.norm not in ("layernorm", "rmsnorm"):
        raise ValueError(f"cfg.norm {cfg.norm!r} (layernorm | rmsnorm)")
    if cfg.position not in ("learned", "rope"):
        raise ValueError(f"cfg.position {cfg.position!r} (learned | rope)")
    _no_moe(cfg)
    if mesh is not None:
        raise NotImplementedError("transformer_apply on a device mesh: "
                                  "ROADMAP.md slice 6 (multi-device)")


def _attend_dense(q, k, v, mask, cfg):
    """The reference's dense branch verbatim: f32 scores over sqrt(hd), a
    -1e9 additive bias on masked keys, a -1e9 causal ``where``, softmax in
    f32, probabilities cast to ``cfg.dtype`` before ``p @ v``. A fully
    padded row therefore attends uniformly (the mean of v)."""
    S, hd = q.shape[2], q.shape[-1]
    scores = (q.float() @ k.float().transpose(-1, -2)) / np.float32(
        np.sqrt(hd))
    if mask is not None:
        scores = scores + torch.where(mask[:, None, None, :], 0.0, -1e9)
    if cfg.causal:
        tri = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                    device=q.device))
        scores = torch.where(tri[None, None], scores, -1e9)
    attn = torch.softmax(scores, dim=-1).to(cfg.dtype)
    return attn @ v


def transformer_apply(params: Dict, ids: torch.Tensor,
                      cfg: TransformerConfig, mesh=None,
                      mask: Optional[torch.Tensor] = None,
                      return_aux: bool = False):
    """Encoder forward → final hidden states (B, S, d_model) in
    ``cfg.dtype``. ``mask`` (B, S) bool marks the keys to attend (the
    BERT padding mask). ``cfg.use_flash`` routes attention through
    :func:`~mmlspark_tpu_torch.ops.flash_attention.flash_attention` (K7
    forward, K8a/K8b backward on the card), else through the reference's
    dense branch. ``return_aux=True`` also returns the MoE auxiliaries,
    zero here (no MoE layers). ``mesh`` must be None."""
    _check_forward(cfg, mesh)
    dt = cfg.dtype
    B, S = ids.shape
    if mask is not None:
        mask = mask.to(torch.bool)
    h = _embed(params, ids, cfg, torch.arange(S, device=ids.device)[None])
    for lp in params["layers"]:
        x = _norm(h.float(), lp["ln1"], cfg).to(dt)
        q, k, v = _qkv_heads(x, lp, cfg, B, S)
        if cfg.position == "rope":
            q, k = _rope(q, k, cfg.rope_theta)
        if cfg.use_flash:
            ctx = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), kv_mask=mask,
                                  causal=cfg.causal).to(dt)
        else:
            ctx = _attend_dense(q, k, v, mask, cfg)
        h = _ffn_residual(h, lp, cfg, ctx, B, S)
    hidden = _norm(h.float(), params["final_ln"], cfg).to(dt)
    if return_aux:
        zero = torch.zeros((), dtype=torch.float32, device=ids.device)
        return hidden, {"balance": zero, "dropped": zero.clone()}
    return hidden


def loss_fn(params, ids, labels, cfg: TransformerConfig, mesh=None):
    """Mean next-token negative log-likelihood of ``labels`` (B, S) under
    the f32 logits ``hidden @ lm_head`` (plus the MoE balance term, zero
    here)."""
    hidden, aux = transformer_apply(params, ids, cfg, mesh,
                                    return_aux=True)
    logits = hidden.float() @ params["lm_head"]["w"]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return nll.mean() + cfg.moe_aux_weight * aux["balance"]


def tree_leaves(tree):
    """The tensors of a params-shaped dict (or list) in a fixed order:
    dict keys sorted, lists in order (the port's ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def train_step(params, opt_state, ids, labels, cfg: TransformerConfig,
               mesh=None, lr: float = 1e-4):
    """One SGD-with-momentum step, as the reference's: ``m = 0.9 m + g``,
    then ``p = p - lr m``, with g the gradient of :func:`loss_fn`.

    ``params`` is a ``master=True`` dict (f32 leaves that require grad)
    and ``opt_state`` zeros shaped like it: a dict of the same structure,
    or a list of zeros in :func:`tree_leaves` order. Unlike the
    reference, which returns fresh pytrees, the port updates both IN
    PLACE (under ``torch.no_grad()``) and returns the same dicts: (params,
    opt_state, loss), the loss a detached f32 scalar."""
    leaves = tree_leaves(params)
    moms = tree_leaves(opt_state)
    if len(leaves) != len(moms):
        raise ValueError("opt_state must have the structure of params")
    loss = loss_fn(params, ids, labels, cfg, mesh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        for p, m, g in zip(leaves, moms, grads):
            m.mul_(0.9)
            if g is not None:
                m.add_(g)
            p.sub_(lr * m)
    return params, opt_state, loss.detach()


def prefill_cache(params: Dict, ids: torch.Tensor, length,
                  cfg: TransformerConfig, max_len: int, mesh=None,
                  head_axis: Optional[str] = "tp"):
    """Batched prompt prefill: ONE causal forward over the (padded) prompt
    (dense attention in plain torch, as the reference leaves it to XLA),
    capturing every layer's K/V into ``max_len`` buffers, plus the logits
    at the last real token.

    ``ids`` (B, P) right-padded, ``length`` (B,) real lengths → (logits
    (B, vocab) f32, cache list of {"k","v"} (B, H, max_len, hd)). Under a
    ``mesh`` (with :func:`shard_params` weights) the cache holds the
    rank's heads and each layer runs two all-reduces over ``head_axis``."""
    dt = cfg.dtype
    group = _mesh_group(mesh, cfg, ids.shape[0], None, head_axis)
    B, P = ids.shape
    if P > max_len:
        raise ValueError(f"prompt {P} exceeds cache max_len {max_len}")
    dev = ids.device
    length = length.to(torch.int64)
    valid = torch.arange(P, device=dev)[None] < length[:, None]    # (B, P)
    h = _embed(params, ids, cfg, torch.arange(P, device=dev)[None])
    tri = torch.tril(torch.ones(P, P, dtype=torch.bool, device=dev))
    attn_ok = tri[None, None] & valid[:, None, None, :]
    cache = []
    for lp in params["layers"]:
        x = _norm(h.float(), lp["ln1"], cfg).to(dt)
        q, k, v = _qkv_heads(x, lp, cfg, B, P)
        if cfg.position == "rope":
            q, k = _rope(q, k, cfg.rope_theta)
        pad = (0, 0, 0, max_len - P)
        cache.append({"k": F.pad(k.to(dt), pad), "v": F.pad(v.to(dt), pad)})
        ctx = _attend(q, k, v, attn_ok, dt)
        h = _ffn_residual(h, lp, cfg, ctx, B, P, group)
    hidden = _norm(h.float(), params["final_ln"], cfg).to(dt)
    last = hidden[torch.arange(B, device=dev), length - 1]
    logits = last.float() @ params["lm_head"]["w"]
    return logits, cache


def _window_ragged_(params, tokens, pos, cache, cfg, active, group):
    """The layer loop of the ragged window, writing each layer's fresh K/V
    rows into ``cache`` itself (an inactive row's rows keep their old
    values) before attending over it. Returns the logits (B, W, vocab)."""
    dt = cfg.dtype
    B, W = tokens.shape
    L = cache[0]["k"].shape[2]
    hd = cfg.d_model // cfg.heads
    dev = tokens.device
    pos = pos.to(torch.int64)
    wpos = pos[:, None] + torch.arange(W, device=dev)             # (B, W)
    h = _embed(params, tokens, cfg, wpos)
    if cfg.position == "rope":
        cos, sin = _rope_tables(wpos, hd, cfg.rope_theta, dt)
        cos, sin = cos[:, None], sin[:, None]                      # B,1,W,·
    key_ok = (torch.arange(L, device=dev)[None, None, :]
              <= wpos[:, :, None])[:, None]                        # B,1,W,L
    keep = None if active is None else active[:, None, None, None]
    rows = torch.arange(B, device=dev)[:, None].expand(B, W)
    for lp, c in zip(params["layers"], cache):
        x = _norm(h.float(), lp["ln1"], cfg).to(dt)
        q, k, v = _qkv_heads(x, lp, cfg, B, W)
        if cfg.position == "rope":
            q = _rot_half(q, cos, sin)
            k = _rot_half(k, cos, sin)
        for kk, t in (("k", k), ("v", v)):
            fresh = t.to(dt).transpose(1, 2)                       # B,W,H,hd
            if keep is not None:
                fresh = torch.where(keep, fresh, c[kk][rows, :, wpos])
            c[kk][rows, :, wpos] = fresh
        ctx = _attend(q, c["k"], c["v"], key_ok, dt)
        h = _ffn_residual(h, lp, cfg, ctx, B, W, group)
    hidden = _norm(h.float(), params["final_ln"], cfg).to(dt)
    return hidden.float() @ params["lm_head"]["w"]


def decode_window_ragged(params: Dict, tokens: torch.Tensor,
                         pos: torch.Tensor, cache, cfg: TransformerConfig,
                         active: Optional[torch.Tensor] = None, group=None):
    """Cached forward over a window of W tokens per row at per-row start
    positions: ``tokens`` (B, W), ``pos`` (B,) → (logits (B, W, vocab)
    f32, new cache). Row b's query j sits at ``pos[b] + j``, attends
    cached keys ``<= pos[b] + j``, and the window's K/V land at
    ``pos[b]..pos[b]+W-1``. Inactive rows keep their cache untouched.
    Functional: the input cache is not modified. ``group``: the ``tp``
    group of a rank holding :func:`shard_params` weights and its heads
    of the cache."""
    new = [{"k": c["k"].clone(), "v": c["v"].clone()} for c in cache]
    return _window_ragged_(params, tokens, pos, new, cfg, active, group), new


def decode_step_ragged(params: Dict, tokens: torch.Tensor, pos: torch.Tensor,
                       cache, cfg: TransformerConfig,
                       active: Optional[torch.Tensor] = None, group=None):
    """One incremental decode step at per-row positions: ``tokens`` (B,),
    ``pos`` (B,) → (logits (B, vocab) f32, new cache) — the W = 1 case of
    :func:`decode_window_ragged` (one layer loop keeps the two paths
    identical)."""
    logits, new = decode_window_ragged(params, tokens[:, None], pos, cache,
                                       cfg, active, group)
    return logits[:, 0], new


def decode_step_ragged_inplace(params: Dict, tokens: torch.Tensor,
                               pos: torch.Tensor, cache,
                               cfg: TransformerConfig,
                               active: Optional[torch.Tensor] = None):
    """:func:`decode_step_ragged` writing the fresh rows into ``cache``
    itself (per layer (B, H, L, hd) ``{"k","v"}``) instead of cloning it:
    the speculative engine's draft slot pool, which the reference updates
    in place by donation. Returns the logits (B, vocab) f32, bitwise
    :func:`decode_step_ragged`'s; an inactive row's cache is unchanged."""
    return _window_ragged_(params, tokens[:, None], pos, cache, cfg, active,
                           None)[:, 0]


# ---- paged KV cache ---------------------------------------------------------
# Per layer a (num_pages, H, page_size, hd) pool pair; each row owns a block
# table row mapping logical pages to physical ones. Physical page 0 is the
# trash page: unallocated block-table entries point at it and inactive rows'
# writebacks land there. impl="kernel" reads the pages in place through the
# hand-written CUDA kernel (ops/paged_attention.py); impl="gather" gathers a
# contiguous copy, runs the ragged math and writes the fresh rows back — the
# oracle the kernel path is held against.

def init_paged_cache(cfg: TransformerConfig, num_pages: int, page_size: int,
                     device=None, kv_dtype=None):
    """Per-layer zeroed (num_pages, H, page_size, hd) k/v pools in
    ``cfg.dtype`` (zeros, not empty: a pool slot never written holds a
    finite value). With ``kv_dtype`` ("int8"/"fp8") the pools hold
    quantized codes (zeros) and each layer dict gains (num_pages, H,
    page_size) bf16 ``k_scale``/``v_scale`` pools of ones."""
    dev = resolve_device(device)
    hd = cfg.d_model // cfg.heads
    shape = (num_pages, cfg.heads, page_size, hd)
    store = kv_store_dtype(kv_dtype)
    if store is None:
        return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
                for _ in range(cfg.layers)]
    return [{"k": torch.zeros(shape, dtype=store, device=dev),
             "v": torch.zeros(shape, dtype=store, device=dev),
             "k_scale": torch.ones(shape[:3], dtype=SCALE_DTYPE, device=dev),
             "v_scale": torch.ones(shape[:3], dtype=SCALE_DTYPE, device=dev)}
            for _ in range(cfg.layers)]


def _is_quant_cache(c) -> bool:
    """A quantized page-pool layer dict carries its scale pools."""
    return "k_scale" in c


def paged_gather(cache_pages, block_tables, length: int, out_dtype=None):
    """Assemble each row's pages into contiguous (B, H, length, hd) k/v.
    Quantized pools dequantize through their gathered scales, in
    ``out_dtype`` (default f32)."""
    bt = block_tables.long()
    out = []
    for c in cache_pages:
        quant = _is_quant_cache(c)
        row = {}
        for kk in ("k", "v"):
            g = _bits(c[kk])[bt].view(c[kk].dtype)     # (B, P, H, page, hd)
            if quant:
                g = dequantize_kv(g, c[kk + "_scale"][bt],
                                  out_dtype or torch.float32)
            elif out_dtype is not None:
                g = g.to(out_dtype)
            B, Pp, H, pg, hd = g.shape
            g = g.permute(0, 2, 1, 3, 4).reshape(B, H, Pp * pg, hd)
            row[kk] = g[:, :, :length]
        out.append(row)
    return out


def _write_rows(c, kk, idx, vals):
    """``c[kk][idx] = vals`` for one layer's pool — quantized through
    :func:`quantize_kv`, with the scales written beside the codes, when
    the layer is quantized. ``idx`` indexes the pool's leading axes."""
    if _is_quant_cache(c):
        codes, sc = quantize_kv(vals, c[kk].dtype)
        _bits(c[kk])[idx] = _bits(codes)
        c[kk + "_scale"][idx] = sc
    else:
        c[kk][idx] = vals.to(c[kk].dtype)


def paged_scatter_rows(cache_pages, rows, block_tables, page_size: int):
    """Write full contiguous (B, H, L, hd) k/v rows (a prefill output) into
    the pools through each row's block table, in place. Logical pages past
    a row's allocation must map to the trash page."""
    L = rows[0]["k"].shape[2]
    n_pages = (L + page_size - 1) // page_size
    dest = block_tables[:, :n_pages].reshape(-1).long()
    for c, rc in zip(cache_pages, rows):
        for kk in ("k", "v"):
            r = rc[kk]
            B, H, _, hd = r.shape
            r = F.pad(r, (0, 0, 0, n_pages * page_size - L))
            r = r.reshape(B, H, n_pages, page_size, hd).permute(
                0, 2, 1, 3, 4).reshape(B * n_pages, H, page_size, hd)
            _write_rows(c, kk, (dest,), r)
    return cache_pages


def _fresh_rows(new_cache, wpos):
    """The freshly written positions ``wpos`` (B, W) of an updated gathered
    cache: per layer ``{"k","v"}`` (B, W, H, hd)."""
    B, W = wpos.shape
    rows = torch.arange(B, device=wpos.device)[:, None].expand(B, W)
    return [{kk: nc[kk][rows, :, wpos.long()] for kk in ("k", "v")}
            for nc in new_cache]


def _write_fresh(cache_pages, fresh, block_tables, wpos, page_size: int,
                 active):
    """Write :func:`_fresh_rows`' values into the pools at ``wpos``
    through ``block_tables``, in place; inactive rows go to trash page
    0."""
    B, W = wpos.shape
    wpos = wpos.long()
    phys = torch.gather(block_tables.long(), 1,
                        torch.div(wpos, page_size, rounding_mode="floor"))
    if active is not None:
        phys = torch.where(active[:, None], phys, torch.zeros_like(phys))
    pf = phys.reshape(-1)
    of = (wpos % page_size).reshape(-1)
    for c, fc in zip(cache_pages, fresh):
        for kk in ("k", "v"):
            vals = fc[kk]                                   # (B, W, H, hd)
            H, hd = vals.shape[2], vals.shape[3]
            _write_rows(c, kk, (pf, slice(None), of),
                        vals.reshape(B * W, H, hd))
    return cache_pages


def _paged_writeback(cache_pages, new_cache, block_tables, wpos,
                     page_size: int, active, mesh=None, slot_axis=None):
    """Scatter the freshly written positions ``wpos`` (B, W) of an updated
    gathered cache back into the pools, in place. Inactive rows (and only
    they) are redirected to trash page 0. Quantized pools get the
    quantized codes and their scales. With ``slot_axis`` (this rank's
    rows over ``dp``, the pool replicated over it) every dp shard's fresh
    rows, block-table rows, positions and ``active`` are gathered in one
    collective (``ops.paged_attention._gather_fresh``) and all of
    them written."""
    fresh = _fresh_rows(new_cache, wpos)
    flat = [fc[kk] for fc in fresh for kk in ("k", "v")]
    (*flat, block_tables, wpos), active = _gather_fresh(
        flat + [block_tables, wpos], active, mesh, slot_axis)
    fresh = [{"k": flat[2 * i], "v": flat[2 * i + 1]}
             for i in range(len(fresh))]
    return _write_fresh(cache_pages, fresh, block_tables, wpos, page_size,
                        active)


def _decode_window_paged_kernel(params: Dict, tokens: torch.Tensor,
                                pos: torch.Tensor, cache_pages,
                                block_tables, cfg: TransformerConfig,
                                active: Optional[torch.Tensor], mesh=None,
                                slot_axis=None, head_axis="tp"):
    """The kernel layer loop: the same embedding / rope / projection / FFN
    math as :func:`decode_window_ragged`, with attention reading the pages
    in place and writing the window's fresh rows in the same launch (K1,
    K2) — or, under a mesh, reading the rank's head shard through K5a/K5b
    with the rows written after the kernel."""
    dt = cfg.dtype
    B, W = tokens.shape
    group = _mesh_group(mesh, cfg, B, slot_axis, head_axis)
    hd = cfg.d_model // cfg.heads
    dev = tokens.device
    pos = pos.to(torch.int32)
    wpos = pos.long()[:, None] + torch.arange(W, device=dev)
    bt = block_tables.to(torch.int32)
    h = _embed(params, tokens, cfg, wpos)
    if cfg.position == "rope":
        cos, sin = _rope_tables(wpos, hd, cfg.rope_theta, dt)
        cos, sin = cos[:, None], sin[:, None]
    for lp, c in zip(params["layers"], cache_pages):
        x = _norm(h.float(), lp["ln1"], cfg).to(dt)
        q, k, v = _qkv_heads(x, lp, cfg, B, W)
        if cfg.position == "rope":
            q = _rot_half(q, cos, sin)
            k = _rot_half(k, cos, sin)
        # pools (and scale pools) are updated in place
        scales = ({"k_scale": c["k_scale"], "v_scale": c["v_scale"]}
                  if _is_quant_cache(c) else {})
        ctx = paged_attention_window(
            q.contiguous(), k.to(dt).contiguous(), v.to(dt).contiguous(),
            c["k"], c["v"], bt, pos, active=active, mesh=mesh,
            slot_axis=slot_axis, head_axis=head_axis, **scales)[0]
        h = _ffn_residual(h, lp, cfg, ctx, B, W, group)
    hidden = _norm(h.float(), params["final_ln"], cfg).to(dt)
    logits = hidden.float() @ params["lm_head"]["w"]
    return logits, cache_pages


def _check_impl(impl: str) -> str:
    if impl not in ("kernel", "gather"):
        raise ValueError(f"unknown paged-attention impl {impl!r} "
                         f"(choose 'kernel' or 'gather')")
    return impl


def decode_step_paged(params: Dict, tokens: torch.Tensor, pos: torch.Tensor,
                      cache_pages, block_tables, cfg: TransformerConfig, *,
                      page_size: int, length: int,
                      active: Optional[torch.Tensor] = None,
                      impl: str = "kernel", mesh=None, slot_axis=None,
                      head_axis="tp"):
    """One paged decode step → (logits (B, vocab) f32, pools updated in
    place). ``impl="kernel"`` (default) attends through the hand-written
    kernel; ``impl="gather"`` gathers to contiguous (``length`` keys),
    runs :func:`decode_step_ragged` and writes the one new position per
    row back — the oracle. Nothing else selects the implementation.

    Under a ``mesh`` (heads over ``head_axis``, default ``"tp"``)
    ``params`` is this rank's :func:`shard_params` slice and
    ``cache_pages`` its head shard: the kernel path reads through
    K5a/K5b, the gather path gathers the rank's heads, and both reduce
    over the ``tp`` group. ``head_axis=None`` means replicated weights
    and heads (no reduce). ``slot_axis`` (``"dp"``) makes ``tokens``,
    ``pos``, ``block_tables`` and ``active`` this rank's rows; both paths
    then write every dp shard's fresh rows into the replicated pool."""
    if _check_impl(impl) == "kernel":
        logits, pages = _decode_window_paged_kernel(
            params, tokens[:, None], pos, cache_pages, block_tables, cfg,
            active, mesh, slot_axis, head_axis)
        return logits[:, 0], pages
    group = _mesh_group(mesh, cfg, tokens.shape[0], slot_axis, head_axis)
    gathered = paged_gather(cache_pages, block_tables, length,
                            out_dtype=cfg.dtype)
    logits, new = decode_step_ragged(params, tokens, pos, gathered, cfg,
                                     active, group)
    pages = _paged_writeback(cache_pages, new, block_tables,
                             pos.long()[:, None], page_size, active, mesh,
                             slot_axis)
    return logits, pages


def decode_window_paged(params: Dict, tokens: torch.Tensor,
                        pos: torch.Tensor, cache_pages, block_tables,
                        cfg: TransformerConfig, *, page_size: int,
                        length: int, active: Optional[torch.Tensor] = None,
                        impl: str = "kernel", mesh=None, slot_axis=None,
                        head_axis="tp"):
    """Paged window decode — the chunked-prefill and prefix-extend
    primitive. Row b's window writes positions ``pos[b]..pos[b]+W-1``
    into its pages (each must be < ``length``). ``impl`` and ``mesh`` as
    in :func:`decode_step_paged`."""
    if _check_impl(impl) == "kernel":
        return _decode_window_paged_kernel(params, tokens, pos, cache_pages,
                                           block_tables, cfg, active, mesh,
                                           slot_axis, head_axis)
    group = _mesh_group(mesh, cfg, tokens.shape[0], slot_axis, head_axis)
    W = tokens.shape[1]
    wpos = pos.long()[:, None] + torch.arange(W, device=tokens.device)
    gathered = paged_gather(cache_pages, block_tables, length,
                            out_dtype=cfg.dtype)
    logits, new = decode_window_ragged(params, tokens, pos, gathered, cfg,
                                       active, group)
    pages = _paged_writeback(cache_pages, new, block_tables, wpos,
                             page_size, active, mesh, slot_axis)
    return logits, pages


def _warp_scaled_rows(scaled, top_k, top_p):
    """Top-k then nucleus filtering on temperature-scaled (S, V) logit rows
    with PER-ROW parameters (-inf outside the kept set); neutral values
    (top_k=0, top_p>=1) are no-ops — the reference's HF convention."""
    S, V = scaled.shape
    sorted_l = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, torch.clamp(top_k, max=V),
                    torch.full_like(top_k, V)).long()
    kth = torch.gather(sorted_l, 1, (k - 1)[:, None])
    filtered = torch.where(scaled < kth, -math.inf, scaled)
    posn = torch.arange(V, device=scaled.device)[None]
    sorted_f = torch.where(posn >= k[:, None], -math.inf, sorted_l)
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    eff_p = torch.where((top_p > 0.0) & (top_p < 1.0), top_p,
                        torch.ones_like(top_p))
    # an index of V (cum short of 1.0 by rounding) keeps everything, as the
    # reference's out-of-range take does; clamping to V-1 keeps everything too
    cutoff_idx = torch.clamp((cum < eff_p[:, None]).sum(-1), max=V - 1)
    cutoff = torch.gather(sorted_f, 1, cutoff_idx[:, None])
    return torch.where(filtered < cutoff, -math.inf, filtered)


# ---- counter-based sampling uniforms ---------------------------------------
# Every sampled draw of the port (this module's generators, the speculative
# reference loops, the continuous engine) takes its uniforms from a hash of
# (a row's seed, the absolute position of the token drawn, the draw's
# purpose, the vocabulary lane), never from a stream with a history: a
# restored session or a truncated speculative round redraws the same values
# at the same positions. int64 tensors hold 32-bit values; products are
# split into 16-bit halves so nothing ever overflows int64 (the same bits on
# every device).
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for x in [0, 2**32) and a 32-bit constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection with full avalanche)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _uniforms(seed: torch.Tensor, qpos: torch.Tensor, purpose: int,
              n: int) -> torch.Tensor:
    """Uniforms in (0, 1) of shape ``qpos.shape + (n,)``: lane j of row i
    is a hash of (``seed[i]``, ``qpos[i, ...]``, ``purpose``, j), computed
    on the device for all rows at once. ``seed`` (S,) int64 holds each
    row's request seed; ``qpos`` (S,) or (S, m) the absolute positions of
    the tokens the draws decide. A restored session draws the same
    uniforms at the same positions, whatever shares its pool."""
    seed = seed.to(torch.int64)
    h = _fmix32((seed & _M32) ^ 0x9E3779B9)
    h = _fmix32(h ^ ((seed >> 32) & _M32))
    h = h.reshape(h.shape + (1,) * (qpos.dim() - 1))
    h = _fmix32(h ^ (qpos.to(torch.int64) & _M32))
    h = _fmix32(h ^ ((purpose * 0x27D4EB2F) & _M32))
    lanes = _mul32(torch.arange(n, device=seed.device, dtype=torch.int64),
                   0x9E3779B1)
    x = _fmix32(h[..., None] ^ lanes)
    return ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _gumbel_argmax(logits, uniform):
    """One categorical draw per row of (S, V) logits (any scale; -inf
    never drawn) by the Gumbel-max rule from ``uniform`` (S, V) draws."""
    gumbel = -torch.log(-torch.log(uniform.clamp(min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def _row_seeds(seed: int, rows: int, device) -> torch.Tensor:
    """The (rows,) stream keys of a batch generated under one call's
    ``seed``: row b's key hashes (seed, b), so the rows of a batch draw
    independently (the reference's categorical draws over a (B, V) batch
    are independent per row) and a row's draws depend on nothing but its
    key, the position and the purpose."""
    s = int(seed) % (1 << 64)
    h = _fmix32(torch.full((rows,), s & _M32, dtype=torch.int64,
                           device=device) ^ 0x85EBCA77)
    h = _fmix32(h ^ (s >> 32))
    return _fmix32(h ^ torch.arange(rows, dtype=torch.int64, device=device))


def _draws(seeds: torch.Tensor, pos, purpose: int, n: int) -> torch.Tensor:
    """(rows, n) uniforms of every row at one absolute position ``pos``."""
    return _uniforms(seeds, torch.full_like(seeds, int(pos)), purpose, n)


def _sample_logits(logits, uniform, temperature: float, top_k: int,
                   top_p: float):
    """Greedy (temperature 0) or filtered sampling shared by the
    generators, on (B, V) float32 logits: optional top-k truncation, then
    nucleus (top-p) truncation over the top-k-filtered renormalized
    distribution (the HF convention), both through
    :func:`_warp_scaled_rows`; the draw is the Gumbel-max rule over
    ``uniform`` (B, V). Neither filter runs when it is neutral."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    need_k = top_k > 0
    need_p = 0.0 < top_p < 1.0
    if need_k or need_p:
        n = logits.shape[0]
        logits = _warp_scaled_rows(
            logits,
            torch.full((n,), int(top_k) if need_k else 0, dtype=torch.int64,
                       device=logits.device),
            torch.full((n,), float(top_p) if need_p else 1.0,
                       dtype=torch.float32, device=logits.device))
    return _gumbel_argmax(logits, uniform).long()


# ---- full-sequence generation ---------------------------------------------

def _model_params(params: Dict, cfg: TransformerConfig, device) -> Dict:
    """``params`` as the port's tensors: a tree of numpy (or jax) arrays
    goes through :func:`params_from_numpy` onto ``device`` (None = the
    card); a tree of tensors is used as it is, on its own device."""
    if isinstance(params["lm_head"]["w"], torch.Tensor):
        return params
    return params_from_numpy(params, cfg, device)


def _ids_on(prompt_ids, device) -> torch.Tensor:
    """A (B, P) prompt as an int64 tensor on ``device``."""
    if isinstance(prompt_ids, torch.Tensor):
        return prompt_ids.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64,
                           device=device)


def _check_generate(cfg: TransformerConfig, ids: torch.Tensor,
                    max_new_tokens: int, what: str) -> int:
    """The reference's checks of every generator → the total length."""
    if ids.ndim != 2 or ids.shape[1] < 1:
        raise ValueError(f"{what}() needs at least one prompt token "
                         "(an empty prompt would condition on padding)")
    L = ids.shape[1] + int(max_new_tokens)
    if L > cfg.max_len and cfg.position == "learned":
        raise ValueError(f"prompt+new = {L} exceeds max_len {cfg.max_len}")
    return L


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device=None):
    """Per-layer zeroed (B, H, L, hd) key/value buffers in ``cfg.dtype``
    for incremental decoding (``device`` None = the card)."""
    dev = resolve_device(device)
    shape = (batch, cfg.heads, max_len, cfg.d_model // cfg.heads)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for _ in range(cfg.layers)]


def decode_step(params: Dict, token: torch.Tensor, pos, cache,
                cfg: TransformerConfig):
    """One incremental decode step: ``token`` (B,) at the shared position
    ``pos`` → (logits (B, vocab) f32, new cache). The shared-``pos`` case
    of :func:`decode_step_ragged`: one layer loop keeps the two (and the
    speculative verify window) identical."""
    B = token.shape[0]
    return decode_step_ragged(
        params, token,
        torch.full((B,), int(pos), dtype=torch.int64, device=token.device),
        cache, cfg)


def decode_window(params: Dict, tokens: torch.Tensor, pos, cache,
                  cfg: TransformerConfig):
    """Cached forward over a window of W tokens at ``pos..pos+W-1`` (a
    shared start) → (logits (B, W, vocab) f32, cache with the window's K/V
    written): the speculative verify primitive, delegating to
    :func:`decode_window_ragged` with a uniform position vector."""
    B = tokens.shape[0]
    return decode_window_ragged(
        params, tokens,
        torch.full((B,), int(pos), dtype=torch.int64, device=tokens.device),
        cache, cfg)


def _window_at_(params, tokens, pos: int, cache, cfg):
    """:func:`decode_window` at a shared start ``pos`` writing into
    ``cache`` in place (the same layer loop, so bitwise the same logits
    (B, W, vocab)): the generators and the speculative loops own their
    caches."""
    B = tokens.shape[0]
    pos_v = torch.full((B,), int(pos), dtype=torch.int64,
                       device=tokens.device)
    return _window_ragged_(params, tokens, pos_v, cache, cfg, None, None)


def generate(params: Dict, prompt_ids, cfg: TransformerConfig,
             max_new_tokens: int = 32, temperature: float = 0.0,
             seed: int = 0, top_k: int = 0, top_p: float = 1.0,
             eos_id: Optional[int] = None, device=None) -> torch.Tensor:
    """Autoregressive generation from a causal config (greedy when
    ``temperature == 0``, else sampling through :func:`_sample_logits`).
    ``eos_id``: rows that emit it keep repeating it.

    Each step runs the whole forward (:func:`transformer_apply`, K7 with
    ``cfg.use_flash`` on the card) over the sequence padded to
    prompt + new tokens and reads the logits at the last written position:
    causality keeps the padding from reaching them. The draw that emits
    position t is keyed by (row seed, t), as :func:`generate_cached`'s,
    so the two give the same tokens. ``params``: numpy (placed on
    ``device``, None = the card) or the port's tensors. Returns (B, P +
    new) int64 ids on the params' device."""
    if not cfg.causal:
        raise ValueError("generate() needs cfg.causal=True")
    params = _model_params(params, cfg, device)
    dev = params["lm_head"]["w"].device
    ids = _ids_on(prompt_ids, dev)
    L = _check_generate(cfg, ids, max_new_tokens, "generate")
    B, P_len = ids.shape
    ids = F.pad(ids, (0, int(max_new_tokens)))
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    seeds = _row_seeds(seed, B, dev) if temperature > 0 else None
    with torch.no_grad():
        for t in range(P_len, L):
            hidden = transformer_apply(params, ids, cfg)
            logits = hidden[:, t - 1].float() @ params["lm_head"]["w"]
            u = None if seeds is None else _draws(seeds, t, 0, cfg.vocab)
            nxt = _sample_logits(logits, u, temperature, top_k, top_p)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            ids[:, t] = nxt
    return ids


def generate_cached(params: Dict, prompt_ids, cfg: TransformerConfig,
                    max_new_tokens: int = 32, temperature: float = 0.0,
                    seed: int = 0, top_k: int = 0, top_p: float = 1.0,
                    eos_id: Optional[int] = None,
                    device=None) -> torch.Tensor:
    """KV-cached :func:`generate`: O(L) attention per emitted token. The
    prompt prefills the cache token by token through the same decode step
    (prompt positions draw nothing); the draw emitting position t + 1 is
    keyed by (row seed, t + 1), :func:`generate`'s key for that position,
    so the two agree token for token. ``eos_id`` repeats once it fires;
    prompt rows never take it."""
    if not cfg.causal:
        raise ValueError("generate_cached() needs cfg.causal=True")
    params = _model_params(params, cfg, device)
    dev = params["lm_head"]["w"].device
    ids = _ids_on(prompt_ids, dev)
    L = _check_generate(cfg, ids, max_new_tokens, "generate_cached")
    B, P_len = ids.shape
    ids = F.pad(ids, (0, int(max_new_tokens)))
    cache = init_kv_cache(cfg, B, L, dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    seeds = _row_seeds(seed, B, dev) if temperature > 0 else None
    with torch.no_grad():
        for t in range(L - 1):
            logits = _window_at_(params, ids[:, t:t + 1], t, cache, cfg)[:, 0]
            if t + 1 < P_len:
                continue            # prefill: the prompt keeps its token
            u = None if seeds is None else _draws(seeds, t + 1, 0, cfg.vocab)
            nxt = _sample_logits(logits, u, temperature, top_k, top_p)
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            ids[:, t + 1] = nxt
    return ids


def _topk_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, descending,
    the lower index first among equal values (a stable descending sort;
    ``torch.topk`` promises no order on ties, and the beam pools are full
    of -inf ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def generate_beam(params: Dict, prompt_ids, cfg: TransformerConfig,
                  max_new_tokens: int = 32, num_beams: int = 4,
                  length_penalty: float = 1.0,
                  eos_id: Optional[int] = None, device=None):
    """Beam search over the cached decoder, the reference's formulation:
    the prompt prefills once (:func:`prefill_cache`), beams fold into the
    batch axis (B·W cache rows), and every step is one decode step, a
    (B, W·V) top-2W candidate pick (2W: at most W are eos extensions, so W
    live beams survive) and a per-layer cache row reorder (an index on the
    device). Finished hypotheses bank into a (B, W) pool scored
    ``sum_logprob / len**length_penalty``; the answer is the best of banked
    and live beams. Ties select as ``jax.lax.top_k`` does (lower index
    first). With ``num_beams=1`` and no eos this is greedy
    :func:`generate_cached`.

    Returns ``(ids (B, P+max_new) int64, scores (B,) f32)``: the best
    hypothesis per row, prompt included, padded with ``eos_id`` past its
    end."""
    if not cfg.causal:
        raise ValueError("generate_beam() needs cfg.causal=True")
    if num_beams < 1:
        raise ValueError("num_beams must be >= 1")
    if num_beams > cfg.vocab:
        raise ValueError(f"num_beams {num_beams} exceeds vocab {cfg.vocab} "
                         "(only vocab distinct first tokens exist)")
    params = _model_params(params, cfg, device)
    dev = params["lm_head"]["w"].device
    ids = _ids_on(prompt_ids, dev)
    L = _check_generate(cfg, ids, max_new_tokens, "generate_beam")
    B, P_len = ids.shape
    W, V, M = int(num_beams), cfg.vocab, int(max_new_tokens)

    def penalize(score, length: int):
        # len ** penalty in float32, as the reference computes it
        return score / float(np.float32(length)
                             ** np.float32(length_penalty))

    neg = torch.tensor(-math.inf, device=dev)
    batch_ix = torch.arange(B, device=dev)[:, None]
    with torch.no_grad():
        logits0, cache = prefill_cache(
            params, ids, torch.full((B,), P_len, device=dev), cfg, L)
        cache = [{k: c[k].repeat_interleave(W, dim=0) for k in ("k", "v")}
                 for c in cache]
        logp0 = torch.log_softmax(logits0.float(), dim=-1)
        # the first step follows the loop's top-2W discipline (k0 caps at V)
        k0 = min(2 * W, V)
        c_scores, c_tok = _topk_stable(logp0, k0)             # (B, k0)
        c_seqs = torch.zeros((B, k0, M), dtype=torch.int64, device=dev)
        c_seqs[:, :, 0] = c_tok
        fin_scores = torch.full((B, W), -math.inf, device=dev)
        fin_seqs = torch.zeros((B, W, M), dtype=torch.int64, device=dev)
        if eos_id is not None:
            c_eos = c_tok == eos_id
            bank = torch.where(c_eos, penalize(c_scores, 1), neg)
            fin_scores, keep = _topk_stable(bank, W)
            fin_seqs = c_seqs[batch_ix, keep]
            live_key = torch.where(c_eos, neg, c_scores)
        else:
            live_key = c_scores
        scores, pick = _topk_stable(live_key, W)
        seqs = c_seqs[batch_ix, pick]
        tok = c_tok[batch_ix, pick].reshape(B * W)
        for t in range(1, M):
            logits = _window_at_(params, tok[:, None], P_len + t - 1, cache,
                                 cfg)[:, 0]
            logp = torch.log_softmax(logits.float(), dim=-1)
            cand = scores[:, :, None] + logp.reshape(B, W, V)
            c_scores, c_idx = _topk_stable(cand.reshape(B, W * V), 2 * W)
            c_parent = torch.div(c_idx, V, rounding_mode="floor")
            c_tok = c_idx % V
            c_seqs = seqs[batch_ix, c_parent]                  # (B, 2W, M)
            c_seqs[:, :, t] = c_tok
            if eos_id is not None:
                c_eos = c_tok == eos_id
                pool_s = torch.cat(
                    [fin_scores,
                     torch.where(c_eos, penalize(c_scores, t + 1), neg)],
                    dim=1)                                     # (B, 3W)
                pool_q = torch.cat([fin_seqs, c_seqs], dim=1)
                fin_scores, keep = _topk_stable(pool_s, W)
                fin_seqs = pool_q[batch_ix, keep]
                live_key = torch.where(c_eos, neg, c_scores)
            else:
                live_key = c_scores
            scores, pick = _topk_stable(live_key, W)
            parent = c_parent[batch_ix, pick]                  # (B, W)
            seqs = c_seqs[batch_ix, pick]
            tok = c_tok[batch_ix, pick].reshape(B * W)
            rows = (batch_ix * W + parent).reshape(B * W)
            cache = [{k: c[k][rows] for k in ("k", "v")} for c in cache]
        all_s = torch.cat([fin_scores, penalize(scores, M)], dim=1)
        all_q = torch.cat([fin_seqs, seqs], dim=1)
        best = torch.argmax(all_s, dim=1)
        best_seq = all_q[torch.arange(B, device=dev), best]       # (B, M)
        best_score = all_s[torch.arange(B, device=dev), best]
        if eos_id is not None:
            hit = torch.cumsum((best_seq == eos_id).long(), dim=1) > 0
            after = torch.cat([torch.zeros_like(hit[:, :1]), hit[:, :-1]],
                              dim=1)                         # strictly after
            best_seq = torch.where(after, torch.full_like(best_seq, eos_id),
                                   best_seq)
    return torch.cat([ids, best_seq], dim=1), best_score
