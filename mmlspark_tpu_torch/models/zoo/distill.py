"""LM training and draft distillation for the zoo decoder (counterpart of
``models/zoo/distill.py``).

Speculative decoding (``speculative.py``) pays off only when the draft's
greedy choices agree with the target's; a random draft accepts almost
nothing. This module trains a target and distils a draft from it:

* :func:`train_lm`: next-token cross-entropy training of any zoo
  ``TransformerConfig`` model;
* :func:`distill_draft`: KL(target ‖ draft) on the frozen target's logits
  over sampled prompts;
* :func:`markov_sampler`: a low-entropy synthetic language (the
  reference's, draw for draw).

The reference's optimizer is ``optax.adamw(lr)``; its defaults are
b1 0.9, b2 0.999, eps 1e-8 and weight decay 1e-4 on every leaf, so the
port's is ``torch.optim.AdamW`` with exactly those (torch's own default
weight decay is 1e-2). The forward is :func:`transformer.transformer_apply`
on f32 master leaves, matrices cast to ``cfg.dtype`` at each use; with
``cfg.use_flash`` attention runs K7 forward and K8a / K8b backward on the
card. Losses stay on the device during the loop and are fetched once at
the end, with the trained weights (returned as the reference's tree of
numpy arrays, ready for :func:`transformer.params_from_numpy` or any
generator of the port).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .transformer import (TransformerConfig, init_transformer,
                          params_from_numpy, transformer_apply, tree_leaves)

__all__ = ["train_lm", "distill_draft", "markov_sampler"]

#: optax.adamw's defaults, which the reference trains with
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _lm_logits(params: Dict, ids: torch.Tensor,
               cfg: TransformerConfig) -> torch.Tensor:
    """(B, S) ids → (B, S, V) next-token logits, the f32 head of the
    generators (training and serving argmax see the same numerics)."""
    h = transformer_apply(params, ids, cfg)
    return h.float() @ params["lm_head"]["w"].float()


def _to_numpy(tree):
    """A params tree of tensors → the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def _master(params, cfg, device):
    """f32 leaves that require grad on ``device`` (None = the card), from
    numpy or from tensors."""
    if isinstance(params["lm_head"]["w"], torch.Tensor):
        params = _to_numpy(params)
    return params_from_numpy(params, cfg, device, master=True)


def _batch(batch_fn, step: int, device) -> torch.Tensor:
    ids = np.asarray(batch_fn(step), dtype=np.int32)
    return torch.from_numpy(ids).to(device=device, dtype=torch.int64,
                                    non_blocking=True)


def train_lm(params: Dict, cfg: TransformerConfig,
             batch_fn: Callable[[int], np.ndarray], steps: int,
             learning_rate: float = 3e-4, log_every: int = 0,
             device=None) -> Tuple[Dict, list]:
    """Next-token CE training; returns (trained params as numpy, loss
    history). ``batch_fn(step) -> (B, S)`` int token batches; the history
    holds the loss of every ``log_every``-th step (none at 0, as in the
    reference)."""
    p = _master(params, cfg, device)
    dev = p["lm_head"]["w"].device
    leaves = tree_leaves(p)
    opt = torch.optim.AdamW(leaves, lr=learning_rate, **ADAMW)
    dev_losses = []
    for s in range(int(steps)):
        ids = _batch(batch_fn, s, dev)
        logits = _lm_logits(p, ids[:, :-1], cfg)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               ids[:, 1:].reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (s + 1) % log_every == 0:
            dev_losses.append(loss.detach())
    history = (torch.stack(dev_losses).cpu().tolist() if dev_losses else [])
    return _to_numpy(p), history


def distill_draft(t_params: Dict, t_cfg: TransformerConfig,
                  d_cfg: TransformerConfig,
                  batch_fn: Callable[[int], np.ndarray], steps: int,
                  learning_rate: float = 1e-3, tau: float = 1.0,
                  seed: int = 0, d_params: Optional[Dict] = None,
                  device=None) -> Tuple[Dict, list]:
    """Distill a draft for speculative decoding from a frozen target:
    minimize KL(softmax(target/τ) ‖ softmax(draft/τ)) over ``batch_fn``
    prompts (the teacher's probabilities carry no gradient). Returns
    (draft params as numpy, the loss of every step). Vocabularies must
    match (the verifier compares ids)."""
    if t_cfg.vocab != d_cfg.vocab:
        raise ValueError("draft and target must share a vocabulary")
    if d_params is None:
        d_params = init_transformer(d_cfg, seed=seed)
    p = _master(d_params, d_cfg, device)
    dev = p["lm_head"]["w"].device
    teacher = (t_params if isinstance(t_params["lm_head"]["w"], torch.Tensor)
               else params_from_numpy(t_params, t_cfg, dev))
    opt = torch.optim.AdamW(tree_leaves(p), lr=learning_rate, **ADAMW)
    inv_tau = 1.0 / float(tau)
    dev_losses = []
    for s in range(int(steps)):
        ids = _batch(batch_fn, s, dev)
        with torch.no_grad():
            t_logits = _lm_logits(teacher, ids, t_cfg) * inv_tau
            t_logp = torch.log_softmax(t_logits, dim=-1)
            t_prob = torch.exp(t_logp)
            t_ent = -(t_prob * t_logp).sum(-1)
        d_logits = _lm_logits(p, ids, d_cfg) * inv_tau
        ce = -(t_prob * torch.log_softmax(d_logits, dim=-1)).sum(-1)
        loss = (ce - t_ent).mean()                 # KL, >= 0
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        dev_losses.append(loss.detach())
    history = (torch.stack(dev_losses).cpu().tolist() if dev_losses else [])
    return _to_numpy(p), history


def markov_sampler(vocab: int, batch: int, seq: int, seed: int = 0,
                   branching: int = 4):
    """A low-entropy first-order Markov language: every token has
    ``branching`` plausible successors with a dominant mode (the
    reference's sampler, the same numpy draws). Returns ``batch_fn(step)
    -> (batch, seq) int32`` for the trainers."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, (vocab, branching))
    probs = np.full(branching, 0.1 / max(branching - 1, 1))
    probs[0] = 0.9
    probs = probs / probs.sum()

    def batch_fn(step: int) -> np.ndarray:
        r = np.random.default_rng(seed * 1_000_003 + step)
        out = np.empty((batch, seq), np.int32)
        out[:, 0] = r.integers(0, vocab, batch)
        for t in range(1, seq):
            choice = r.choice(branching, size=batch, p=probs)
            out[:, t] = succ[out[:, t - 1], choice]
        return out

    return batch_fn
