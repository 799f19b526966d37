"""ORT generation meta-ops: ``com.microsoft.GreedySearch`` / ``BeamSearch``
(counterpart of ``mmlspark_tpu/onnx/generation_ops.py``).

onnxruntime's ``convert_generation`` wraps a GPT-style decoder subgraph in
one node that runs the whole autoregressive loop. The reference lowers the
loop to ``lax.scan`` over the converted subgraph; the port steps the
subgraph eagerly, one evaluation a token, with the reference's padded-past
discipline:

* the KV ``past_*`` state lives in fixed (2, B, H, max_length, hd) device
  buffers; each step evaluates the subgraph at the padded past length and
  the ``attention_mask`` input hides the unwritten tail;
* the step's fresh K/V arrive as the LAST row of each ``present_*``
  output and are written into the buffers at the true length, in place;
* beams fold into the batch axis with per-layer row gathers on reorder
  (``zoo.transformer.generate_beam``'s formulation, and its tie rule: the
  lower index first, a stable descending sort).

The subgraph's float initializers are placed on the device once per
(node, device), not once a step. ``max_length``, ``num_beams`` and the
other shape-like inputs must be host values (an integer or 0-d
initializer): a fed value is a device tensor and is refused, as the
converter refuses any shape read back from the device.

Subgraph contract (``model_type = 0``, the GPT one): inputs ``input_ids
(B, S) · position_ids (B, S) · attention_mask (B, total)`` then
``past_0..past_{L-1}`` each (2, B, H, past_len, hd); outputs ``logits (B,
S, V)`` then ``present_0..`` each (2, B, H, past_len+S, hd). The mask must
gate attention scores (ORT's exported subgraphs do), which is what makes
padded pasts sound.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.zoo.transformer import _topk_stable
from .convert import (UnsupportedOp, _as_tensor, _concrete, _eval_nodes,
                      _torch_dtype, register_op)
from .proto import ONNX_TO_NUMPY, tensor_to_numpy

__all__ = []


def _static_int(v, what, default=None):
    if v is None:
        if default is None:
            raise UnsupportedOp(f"{what} is required")
        return int(default)
    return int(np.asarray(_concrete(v, what)).ravel()[0])


def _static_float(v, what, default):
    if v is None:
        return float(default)
    return float(np.asarray(_concrete(v, what)).ravel()[0])


class _Decoder:
    """The GPT-style subgraph plus everything derived from its declared
    signature (layer count, head geometry, mask dtype)."""

    def __init__(self, node, ctx, max_length: int):
        graph = node.attr("decoder")
        if graph is None:
            raise UnsupportedOp("GreedySearch/BeamSearch needs a decoder "
                                "subgraph attribute")
        if int(node.attr("model_type", 0)) != 0:
            raise UnsupportedOp("only model_type=0 (GPT, decoder-only) is "
                                "supported")
        if int(node.attr("no_repeat_ngram_size", 0)):
            raise UnsupportedOp("no_repeat_ngram_size")
        self.graph = graph
        self.ctx = ctx
        self.L = len(graph.inputs) - 3
        if self.L < 1:
            raise UnsupportedOp("decoder subgraph declares no past_* "
                                "inputs")
        dims = list(graph.inputs[3].shape)
        if len(dims) != 5:
            raise UnsupportedOp(f"past input rank {len(dims)} != 5")
        self.H, self.hd = dims[2], dims[4]
        if not (isinstance(self.H, int) and isinstance(self.hd, int)):
            raise UnsupportedOp(
                "decoder past inputs need numeric head-count and head-dim "
                f"dims (got {dims})")
        self.mask_dt = _torch_dtype(ONNX_TO_NUMPY.get(
            graph.inputs[2].elem_type, np.float32))
        self.max_length = int(max_length)
        self.dev = ctx.device
        self.inits = self._placed(node)

    def _placed(self, node):
        """The subgraph's initializers once per (node, device): integer,
        boolean and 0-d ones stay numpy (shape constants, folded on the
        host), the others are tensors on the device."""
        cache = node.__dict__.setdefault("_gen_constants", {})
        key = str(self.dev)
        if key not in cache:
            env = {}
            for t in self.graph.initializers:
                a = tensor_to_numpy(t)
                env[t.name] = (a if a.dtype.kind in "iub" or a.ndim == 0
                               else _as_tensor(a, self.ctx))
            cache[key] = env
        return cache[key]

    def zeros(self, rows: int, length: int):
        return [torch.zeros((2, rows, self.H, length, self.hd),
                            dtype=torch.float32, device=self.dev)
                for _ in range(self.L)]

    def __call__(self, ids, pos, mask, past):
        """One evaluation of the subgraph (the body of
        :meth:`_Ctx.run_subgraph`, with the placed initializers)."""
        env = dict(self.ctx.scope_env or {})
        env.update(self.inits)
        feeds = [ids.to(torch.int32), pos.to(torch.int32),
                 mask.to(self.mask_dt)] + list(past)
        for vi, val in zip(self.graph.inputs, feeds):
            env[vi.name] = val
        env[""] = None
        _eval_nodes(self.graph.nodes, env, self.ctx)
        outs = [_as_tensor(env[o.name], self.ctx).to(torch.float32)
                for o in self.graph.outputs]
        return outs[0], outs[1:]

    def prefill(self, input_ids, prompt_mask):
        """(B, P) prompt → (last-token logits (B, V), padded past, seen
        (B, V) token mask). Left-padded prompts follow ORT's convention:
        position_ids = cumsum(mask) - 1."""
        B, P = input_ids.shape
        pos = torch.clamp(torch.cumsum(prompt_mask, dim=1) - 1, min=0)
        logits, present = self(input_ids, pos, prompt_mask, self.zeros(B, 0))
        past = self.zeros(B, self.max_length)
        for buf, pr in zip(past, present):
            buf[:, :, :, :P] = pr
        # counted, not set: a pad slot must not clear a real occurrence
        # of the same token
        seen = torch.zeros((B, logits.shape[-1]), dtype=torch.int32,
                           device=self.dev)
        rows = torch.arange(B, device=self.dev)[:, None].expand(B, P)
        seen.index_put_((rows.reshape(-1), input_ids.reshape(-1).long()),
                        (prompt_mask.reshape(-1) != 0).to(torch.int32),
                        accumulate=True)
        return logits[:, -1], past, seen > 0

    def step(self, tok, cur_len: int, past, prompt_mask, P: int):
        """One decode step at the padded past length: the mask exposes the
        real prompt slots, every generated slot in [P, cur_len) and the
        fresh token's slot at the end; the new K/V (the last ``present``
        row) are written at cur_len. Generated token k sits at position
        (real prompt length + k)."""
        B = tok.shape[0]
        ML = self.max_length
        cols = torch.arange(ML, device=self.dev)[None, :]
        pm_full = torch.zeros((B, ML), dtype=torch.int32, device=self.dev)
        pm_full[:, :P] = prompt_mask.to(torch.int32)
        past_ok = torch.where(cols < P, pm_full,
                              (cols < cur_len).to(torch.int32))
        mask = torch.cat([past_ok, torch.ones((B, 1), dtype=torch.int32,
                                              device=self.dev)], dim=1)
        plen = prompt_mask.to(torch.int32).sum(1, keepdim=True)   # (B, 1)
        pos = plen + (cur_len - P)
        logits, present = self(tok[:, None], pos, mask, past)
        for buf, pr in zip(past, present):
            buf[:, :, :, cur_len] = pr[:, :, :, ML]
        return logits[:, -1]


def _adjust_logits(logits, seen, total_len: int, min_length: int,
                   eos_id: int, rep_penalty: float, vocab_mask, ctx):
    """The shared logit processors (HF conventions, which ORT follows):
    repetition penalty over seen tokens, vocab mask, min-length eos ban."""
    if rep_penalty != 1.0:
        pen = torch.where(logits > 0, logits / rep_penalty,
                          logits * rep_penalty)
        logits = torch.where(seen, pen, logits)
    if vocab_mask is not None:
        keep = _as_tensor(vocab_mask, ctx).bool()[None, :]
        logits = torch.where(keep, logits,
                             torch.full_like(logits, -math.inf))
    if min_length > 0 and total_len < min_length:
        logits = logits.clone()
        logits[:, eos_id] = -math.inf
    return logits


def _common_setup(node, inputs, ctx):
    if inputs[0] is None:
        raise UnsupportedOp("input_ids is required")
    input_ids = _as_tensor(inputs[0], ctx).to(torch.int64)
    max_length = _static_int(inputs[1] if len(inputs) > 1 else None,
                             "max_length")
    B, P = input_ids.shape
    if P >= max_length:
        raise UnsupportedOp(f"prompt length {P} >= max_length {max_length}")
    dec = _Decoder(node, ctx, max_length)
    eos = int(node.attr("eos_token_id", -1))
    pad = int(node.attr("pad_token_id", -1))
    if eos < 0 or pad < 0:
        raise UnsupportedOp("eos_token_id and pad_token_id attributes are "
                            "required")
    return input_ids, max_length, dec, eos, pad


def _attn(inputs, i, B, P, ctx):
    v = inputs[i] if len(inputs) > i else None
    if v is None:
        return torch.ones((B, P), dtype=torch.int32, device=ctx.device)
    return _as_tensor(v, ctx).to(torch.int32)


@register_op("GreedySearch")
def _greedy_search(node, inputs, ctx):
    input_ids, max_length, dec, eos, pad = _common_setup(node, inputs, ctx)
    B, P = input_ids.shape
    min_length = _static_int(inputs[2] if len(inputs) > 2 else None,
                             "min_length", default=0)
    rep = _static_float(inputs[3] if len(inputs) > 3 else None,
                        "repetition_penalty", 1.0)
    vocab_mask = inputs[4] if len(inputs) > 4 else None
    if len(inputs) > 5 and inputs[5] is not None:
        raise UnsupportedOp("prefix_vocab_mask")
    attn = _attn(inputs, 6, B, P, ctx)
    rows = torch.arange(B, device=ctx.device)
    # the prefill emits buffer position P; each step t (P .. max_length-2)
    # feeds the token at index t and emits index t + 1; eos is emitted and
    # everything after it is pad_token_id (ORT's layout); eos is banned
    # while the length before the new token is < min_length
    with torch.no_grad():
        logits0, past, seen = dec.prefill(input_ids, attn)
        logits0 = _adjust_logits(logits0, seen, P, min_length, eos, rep,
                                 vocab_mask, ctx)
        tok = torch.argmax(logits0, dim=-1)
        done = tok == eos
        buf = torch.zeros((B, max_length), dtype=torch.int32,
                          device=ctx.device)
        buf[:, :P] = input_ids
        buf[:, P] = tok
        for t in range(P, max_length - 1):
            seen[rows, tok] = True
            logits = dec.step(tok, t, past, attn, P)
            logits = _adjust_logits(logits, seen, t + 1, min_length, eos,
                                    rep, vocab_mask, ctx)
            nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
            done = done | (nxt == eos)
            buf[:, t + 1] = nxt
            tok = nxt
    return buf


@register_op("BeamSearch")
def _beam_search(node, inputs, ctx):
    input_ids, max_length, dec, eos, pad = _common_setup(node, inputs, ctx)
    B, P = input_ids.shape
    dev = ctx.device
    min_length = _static_int(inputs[2] if len(inputs) > 2 else None,
                             "min_length", default=0)
    W = _static_int(inputs[3] if len(inputs) > 3 else None, "num_beams")
    R = _static_int(inputs[4] if len(inputs) > 4 else None,
                    "num_return_sequences", default=1)
    lp = _static_float(inputs[5] if len(inputs) > 5 else None,
                       "length_penalty", 1.0)
    rep = _static_float(inputs[6] if len(inputs) > 6 else None,
                        "repetition_penalty", 1.0)
    vocab_mask = inputs[7] if len(inputs) > 7 else None
    if len(inputs) > 8 and inputs[8] is not None:
        raise UnsupportedOp("prefix_vocab_mask")
    attn = _attn(inputs, 9, B, P, ctx)
    if W < 1 or R < 1 or R > W:
        raise UnsupportedOp(f"need 1 <= num_return_sequences ({R}) <= "
                            f"num_beams ({W})")
    # scores: cumulative log-prob over the GENERATED tokens, penalized as
    # sum / len**length_penalty when banked; the loop always runs to
    # max_length (early_stopping=False semantics), as the reference's

    def penalize(score, length: int):
        return score / float(np.float32(length) ** np.float32(lp))

    M = max_length
    neg = torch.tensor(-math.inf, device=dev)
    batch_ix = torch.arange(B, device=dev)[:, None]
    with torch.no_grad():
        logits0, past, seen = dec.prefill(input_ids, attn)
        V = logits0.shape[-1]
        if W > V:
            raise UnsupportedOp(f"num_beams {W} exceeds vocab {V}")
        logits0 = _adjust_logits(logits0, seen, P, min_length, eos, rep,
                                 vocab_mask, ctx)
        logp0 = torch.log_softmax(logits0, dim=-1)
        k0 = min(2 * W, V)
        c_scores, c_tok = _topk_stable(logp0, k0)             # (B, k0)
        c_seqs = torch.zeros((B, k0, M), dtype=torch.int64, device=dev)
        c_seqs[:, :, :P] = input_ids[:, None, :]
        c_seqs[:, :, P] = c_tok
        c_eos = c_tok == eos
        fin_scores, keep = _topk_stable(
            torch.where(c_eos, penalize(c_scores, 1), neg), W)
        fin_seqs = c_seqs[batch_ix, keep]
        scores, pick = _topk_stable(torch.where(c_eos, neg, c_scores), W)
        seqs = c_seqs[batch_ix, pick]
        tok = c_tok[batch_ix, pick].reshape(B * W)
        # fold the beams into the batch axis of every stateful buffer
        past = [buf.repeat_interleave(W, dim=1) for buf in past]
        seen = seen.repeat_interleave(W, dim=0)               # (B*W, V)
        attn_w = attn.repeat_interleave(W, dim=0)
        rows_bw = torch.arange(B * W, device=dev)
        for t in range(P, M - 1):
            seen[rows_bw, tok] = True
            logits = dec.step(tok, t, past, attn_w, P)
            logits = _adjust_logits(logits, seen, t + 1, min_length, eos,
                                    rep, vocab_mask, ctx)
            logp = torch.log_softmax(logits, dim=-1)          # (B*W, V)
            cand = scores[:, :, None] + logp.reshape(B, W, V)
            c_scores, c_idx = _topk_stable(cand.reshape(B, W * V), 2 * W)
            c_parent = torch.div(c_idx, V, rounding_mode="floor")
            c_tok = c_idx % V
            c_seqs = seqs[batch_ix, c_parent]
            c_seqs[:, :, t + 1] = c_tok
            c_eos = c_tok == eos
            gen_len = t + 2 - P                # generated tokens, eos too
            pool_s = torch.cat(
                [fin_scores,
                 torch.where(c_eos, penalize(c_scores, gen_len), neg)],
                dim=1)
            pool_q = torch.cat([fin_seqs, c_seqs], dim=1)
            fin_scores, keep = _topk_stable(pool_s, W)
            fin_seqs = pool_q[batch_ix, keep]
            scores, pick = _topk_stable(torch.where(c_eos, neg, c_scores), W)
            parent = c_parent[batch_ix, pick]
            seqs = c_seqs[batch_ix, pick]
            tok = c_tok[batch_ix, pick].reshape(B * W)
            rows = (batch_ix * W + parent).reshape(B * W)
            past = [buf[:, rows] for buf in past]
            seen = seen[rows]
        all_s = torch.cat([fin_scores, penalize(scores, M - P)], dim=1)
        all_q = torch.cat([fin_seqs, seqs], dim=1)            # (B, 2W, M)
        top_s, top_i = _topk_stable(all_s, R)
        out = all_q[batch_ix, top_i]                          # (B, R, M)
        # pad strictly after the first eos PAST the prompt (a prompt token
        # equal to eos must not trigger padding)
        gen_eos = (out == eos) & (torch.arange(M, device=dev) >= P)
        hit = torch.cumsum(gen_eos.to(torch.int32), dim=-1) > 0
        after = torch.cat([torch.zeros_like(hit[..., :1]), hit[..., :-1]],
                          dim=-1)
        out = torch.where(after, torch.full_like(out, pad), out)
    return out.to(torch.int32), top_s
