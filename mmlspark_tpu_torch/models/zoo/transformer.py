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
                                    paged_attention_window)
from ...parallel.mesh import axis_group
from ...utils.device import resolve_device

__all__ = ["TransformerConfig", "BERT_BASE", "BERT_MINI", "DECODER_MINI",
           "init_transformer", "params_from_numpy", "shard_params",
           "transformer_apply",
           "loss_fn", "train_step", "tree_leaves", "prefill_cache",
           "decode_step_ragged", "decode_window_ragged",
           "init_paged_cache", "paged_gather",
           "paged_scatter_rows", "decode_step_paged", "decode_window_paged",
           "gelu"]

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
    or a head axis), after checking that the mesh divides the heads and
    shards no slots."""
    if mesh is None:
        return None
    _check_mount(mesh, B, cfg.heads, slot_axis, head_axis)
    _check_mesh_axes(mesh, slot_axis, head_axis)
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
    ``cfg.dtype`` into the f32 leaf, as in JAX)."""
    h = params["embed"]["tok"].to(cfg.dtype)[ids]
    if cfg.position == "learned":
        h = h + params["embed"]["pos"].to(cfg.dtype)[positions]
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
    new_cache = []
    for lp, c in zip(params["layers"], cache):
        x = _norm(h.float(), lp["ln1"], cfg).to(dt)
        q, k, v = _qkv_heads(x, lp, cfg, B, W)
        if cfg.position == "rope":
            q = _rot_half(q, cos, sin)
            k = _rot_half(k, cos, sin)
        kc, vc = c["k"].clone(), c["v"].clone()
        kc[rows, :, wpos] = k.to(dt).transpose(1, 2)
        vc[rows, :, wpos] = v.to(dt).transpose(1, 2)
        if keep is not None:
            kc = torch.where(keep, kc, c["k"])
            vc = torch.where(keep, vc, c["v"])
        new_cache.append({"k": kc, "v": vc})
        ctx = _attend(q, kc, vc, key_ok, dt)
        h = _ffn_residual(h, lp, cfg, ctx, B, W, group)
    hidden = _norm(h.float(), params["final_ln"], cfg).to(dt)
    logits = hidden.float() @ params["lm_head"]["w"]
    return logits, new_cache


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


def _paged_writeback(cache_pages, new_cache, block_tables, wpos,
                     page_size: int, active):
    """Scatter the freshly written positions ``wpos`` (B, W) of an updated
    gathered cache back into the pools, in place. Inactive rows (and only
    they) are redirected to trash page 0. Quantized pools get the
    quantized codes and their scales."""
    B, W = wpos.shape
    wpos = wpos.long()
    phys = torch.gather(block_tables.long(), 1,
                        torch.div(wpos, page_size, rounding_mode="floor"))
    if active is not None:
        phys = torch.where(active[:, None], phys, torch.zeros_like(phys))
    pf = phys.reshape(-1)
    of = (wpos % page_size).reshape(-1)
    rows = torch.arange(B, device=wpos.device)[:, None].expand(B, W)
    for c, nc in zip(cache_pages, new_cache):
        for kk in ("k", "v"):
            vals = nc[kk][rows, :, wpos]                    # (B, W, H, hd)
            H, hd = vals.shape[2], vals.shape[3]
            _write_rows(c, kk, (pf, slice(None), of),
                        vals.reshape(B * W, H, hd))
    return cache_pages


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
    and heads (no reduce)."""
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
                             pos.long()[:, None], page_size, active)
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
                             page_size, active)
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
