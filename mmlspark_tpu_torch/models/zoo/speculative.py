"""Speculative decoding: draft-then-verify generation (counterpart of
``models/zoo/speculative.py``).

A small draft model proposes ``gamma`` tokens per round; the target scores
the whole proposal in ONE cached window forward (the ragged window loop
that :func:`transformer.decode_window` shares with the decode step) and
accepts the longest prefix that matches its own choices, emitting one
token on top, so each round costs one target forward for 1..gamma+1
emitted tokens. Stale cache entries past an accepted prefix need no
rollback: attention masks keys by position and later windows overwrite
them.

Two contracts, four entry points, the reference's:

* greedy (:func:`generate_speculative`, :func:`generate_speculative_fused`,
  :func:`generate_speculative_paged`): output token for token IDENTICAL
  to the target's greedy :func:`transformer.generate_cached`;
* sampled (:func:`generate_speculative_sampled`): temperature > 0 with the
  speculative-sampling correction (a draft token accepted with probability
  min(1, p_t / p_d), a rejection resampled from the normalized residual
  max(p_t - p_d, 0)), so the output is distributed as the target's own
  sampling.

The reference jits its fused and sampled loops into ``lax.while_loop``
programs; here every loop is an eager host loop with the same rounds, one
device-to-host read of the round's acceptance each (rounds advance by the
batch's minimum acceptance, as in the reference, so the rows stay
position-aligned). Caches are the generators' own and are written in
place by the same layer loop.

Sampled draws come from the counter-based hash of
:func:`transformer._uniforms` keyed by (row key, the absolute position of
the token a draw decides, its purpose): 0 the first token, 1 a draft
proposal, 2 an acceptance test, 3 a resample (or the bonus token). A
round cut short by the batch minimum redraws the same values at the same
positions, so each row's tokens are those of the row run alone; the
values differ from the reference's threefry draws, so the contract, and
the tests, are distributional.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .transformer import (TransformerConfig, _check_impl, _draws,
                          _gumbel_argmax, _ids_on, _model_params,
                          _row_seeds, _uniforms, _warp_scaled_rows,
                          _window_at_, decode_window_paged,
                          init_paged_cache,
                          paged_scatter_rows, prefill_cache)

__all__ = ["generate_speculative", "generate_speculative_fused",
           "generate_speculative_paged", "generate_speculative_sampled"]


def _check(t_cfg: TransformerConfig, d_cfg: TransformerConfig, gamma: int):
    if t_cfg.vocab != d_cfg.vocab:
        raise ValueError("draft and target must share a vocabulary")
    if gamma < 1:
        raise ValueError("gamma must be >= 1")


def _setup(t_params, d_params, prompt_ids, t_cfg, d_cfg, device):
    """Both models' tensors on one device and the prompt there."""
    t_params = _model_params(t_params, t_cfg, device)
    dev = t_params["lm_head"]["w"].device
    d_params = _model_params(d_params, d_cfg, dev)
    return t_params, d_params, _ids_on(prompt_ids, dev), dev


def _accepted(greedy: torch.Tensor, wtoks: torch.Tensor) -> int:
    """The batch's accepted draft count: the least, over rows, of the
    matched prefix of ``wtoks[:, 1:]`` against ``greedy[:, :-1]``."""
    match = (greedy[:, :-1] == wtoks[:, 1:]).to(torch.int32)
    return int(torch.cumprod(match, dim=-1).sum(-1).min())


def _greedy_loop(t_params, d_params, ids, t_cfg, d_cfg, max_new_tokens,
                 gamma, verify, t_logits, stats):
    """The reference's python-loop speculative rounds (shared by
    :func:`generate_speculative` and the paged variant): the draft catches
    up on a missing tail, proposes gamma greedy tokens, ``verify`` scores
    the window and the rows advance by the batch minimum."""
    B, P = ids.shape
    L = P + max_new_tokens + gamma + 1
    dev = ids.device
    _, d_cache = prefill_cache(d_params, ids,
                               torch.full((B,), P, device=dev), d_cfg, L)
    pending = torch.argmax(t_logits, dim=-1)                    # (B,)
    out = [pending[:, None]]
    emitted, m = 1, P
    tail = ids.new_zeros((B, 0))
    while emitted < max_new_tokens:
        pos = m - tail.shape[1]
        for i in range(tail.shape[1]):
            _window_at_(d_params, tail[:, i:i + 1], pos + i, d_cache, d_cfg)
        tok, p, props = pending, pos + tail.shape[1], []
        for _ in range(gamma):
            lg = _window_at_(d_params, tok[:, None], p, d_cache, d_cfg)[:, 0]
            tok = torch.argmax(lg, dim=-1)
            props.append(tok)
            p += 1
        drafts = torch.stack(props, dim=1)                      # (B, gamma)
        stats["draft_steps"] += gamma
        wtoks = torch.cat([pending[:, None], drafts], dim=1)
        greedy = torch.argmax(verify(wtoks, m), dim=-1)         # (B, g+1)
        stats["target_forwards"] += 1
        stats["rounds"] += 1
        k = min(_accepted(greedy, wtoks), max_new_tokens - emitted - 1)
        stats["accepted_drafts"] += k
        if k > 0:
            out.append(drafts[:, :k])
            emitted += k
        bonus = greedy[:, k]
        out.append(bonus[:, None])
        emitted += 1
        # k == gamma: the draft proposed d_gamma without consuming it, so
        # its cache misses position m + gamma: the next round's tail
        tail = drafts[:, gamma - 1:gamma] if k == gamma else \
            ids.new_zeros((B, 0))
        pending = bonus
        m = m + k + 1
    new = torch.cat(out, dim=1)[:, :max_new_tokens]
    return torch.cat([ids, new], dim=1)


def generate_speculative(t_params: Dict, d_params: Dict, prompt_ids,
                         t_cfg: TransformerConfig, d_cfg: TransformerConfig,
                         max_new_tokens: int = 32, gamma: int = 4,
                         device=None) -> Tuple[torch.Tensor, dict]:
    """Greedy generation from the TARGET, accelerated by the draft.

    Returns ``(ids (B, P+max_new) int64, stats)``: ids exactly equal to
    ``generate_cached(t_params, ..., temperature=0)``; stats counts target
    forwards, draft steps, accepted drafts and rounds. Rounds advance by
    the batch's minimum acceptance, so the rows stay position-aligned.
    ``params``: numpy trees (placed on ``device``, None = the card) or the
    port's tensors."""
    _check(t_cfg, d_cfg, gamma)
    t_params, d_params, ids, dev = _setup(t_params, d_params, prompt_ids,
                                          t_cfg, d_cfg, device)
    B, P = ids.shape
    L = P + max_new_tokens + gamma + 1          # slack: windows overshoot
    stats = {"target_forwards": 1, "draft_steps": 0, "accepted_drafts": 0,
             "rounds": 0}
    with torch.no_grad():
        t_logits, t_cache = prefill_cache(
            t_params, ids, torch.full((B,), P, device=dev), t_cfg, L)

        def verify(wtoks, m):
            return _window_at_(t_params, wtoks, m, t_cache, t_cfg)

        out = _greedy_loop(t_params, d_params, ids, t_cfg, d_cfg,
                           max_new_tokens, gamma, verify, t_logits, stats)
    return out, stats


def generate_speculative_fused(t_params: Dict, d_params: Dict, prompt_ids,
                               t_cfg: TransformerConfig,
                               d_cfg: TransformerConfig,
                               max_new_tokens: int = 32, gamma: int = 4,
                               device=None) -> Tuple[torch.Tensor, dict]:
    """:func:`generate_speculative` in the reference's fused form: each
    round the draft runs gamma + 1 steps (consuming its own last proposal,
    so its cache never holds a hole), the window's emissions are written
    optimistically into the ids buffer and the rows advance by the
    accepted length only (later rounds overwrite the rejected tail).
    Output token for token that of the loop form and of the target alone;
    ``stats["draft_steps"]`` counts the gamma + 1 steps a round."""
    _check(t_cfg, d_cfg, gamma)
    t_params, d_params, ids, dev = _setup(t_params, d_params, prompt_ids,
                                          t_cfg, d_cfg, device)
    B, P = ids.shape
    L = P + max_new_tokens + gamma + 1
    lengths = torch.full((B,), P, device=dev)
    idxs = torch.arange(gamma + 1, device=dev)
    rounds = accepted = 0
    with torch.no_grad():
        t_logits, t_cache = prefill_cache(t_params, ids, lengths, t_cfg, L)
        _, d_cache = prefill_cache(d_params, ids, lengths, d_cfg, L)
        pending = torch.argmax(t_logits, dim=-1)
        buf = torch.zeros((B, L), dtype=torch.int64, device=dev)
        buf[:, :P] = ids
        buf[:, P] = pending
        m = P
        while m - P + 1 < max_new_tokens:
            tok, props = pending, []
            for i in range(gamma + 1):
                lg = _window_at_(d_params, tok[:, None], m + i, d_cache,
                                 d_cfg)[:, 0]
                tok = torch.argmax(lg, dim=-1)
                props.append(tok)
            drafts = torch.stack(props[:gamma], dim=1)
            wtoks = torch.cat([pending[:, None], drafts], dim=1)
            greedy = torch.argmax(
                _window_at_(t_params, wtoks, m, t_cache, t_cfg), dim=-1)
            k = min(_accepted(greedy, wtoks),
                    max_new_tokens - (m - P + 1) - 1)
            bonus = greedy[:, k]
            emit = torch.where(idxs[None, :] < k,
                               torch.cat([drafts, drafts[:, -1:]], dim=1),
                               bonus[:, None])
            buf[:, m + 1:m + gamma + 2] = emit
            rounds += 1
            accepted += k
            pending = bonus
            m = m + k + 1
    return buf[:, :P + max_new_tokens], {
        "target_forwards": rounds + 1, "rounds": rounds,
        "accepted_drafts": accepted, "draft_steps": rounds * (gamma + 1)}


def generate_speculative_paged(t_params: Dict, d_params: Dict, prompt_ids,
                               t_cfg: TransformerConfig,
                               d_cfg: TransformerConfig,
                               max_new_tokens: int = 32, gamma: int = 4,
                               page_size: int = 16,
                               paged_attn: str = "kernel",
                               device=None) -> Tuple[torch.Tensor, dict]:
    """:func:`generate_speculative` with the TARGET cache in a paged pool,
    the reference loop of the paged verify path the continuous engine
    runs. Row b's block table maps logical page j to physical page
    ``1 + b·n + j`` (page 0 is the trash page); the prefill scatters
    through the table; every verify window runs
    :func:`transformer.decode_window_paged` at the full logical length.
    ``paged_attn`` selects the window's implementation: ``"kernel"`` (the
    default: K1 on the card, reading the pages in place and writing the
    window's rows in the same launch, the tensor-core body in bf16 and the
    FMA body in f32; the plain version on the CPU) or ``"gather"`` (gather,
    the ragged math, write back). On the card the kernel takes head dim 64
    only and raises on any other: no quiet fallback to the gather path.
    The draft cache stays contiguous. ``stats["paged_attn_impl"]`` records
    the implementation; greedy output equals :func:`generate_speculative`'s
    (f32, ``"gather"`` bitwise; ``"kernel"`` to summation order)."""
    _check(t_cfg, d_cfg, gamma)
    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    impl = _check_impl(paged_attn)
    t_params, d_params, ids, dev = _setup(t_params, d_params, prompt_ids,
                                          t_cfg, d_cfg, device)
    B, P = ids.shape
    L = P + max_new_tokens + gamma + 1
    n = -(-L // page_size)
    bt = (1 + torch.arange(B, device=dev)[:, None] * n
          + torch.arange(n, device=dev)[None, :]).to(torch.int32)
    stats = {"target_forwards": 1, "draft_steps": 0, "accepted_drafts": 0,
             "rounds": 0, "pages_per_row": n, "page_size": page_size,
             "paged_attn_impl": impl}
    with torch.no_grad():
        pages = init_paged_cache(t_cfg, 1 + B * n, page_size, dev)
        t_logits, rows = prefill_cache(
            t_params, ids, torch.full((B,), P, device=dev), t_cfg, L)
        paged_scatter_rows(pages, rows, bt, page_size)
        del rows

        def verify(wtoks, m):
            pos = torch.full((B,), m, dtype=torch.int32, device=dev)
            return decode_window_paged(t_params, wtoks, pos, pages, bt,
                                       t_cfg, page_size=page_size,
                                       length=L, impl=impl)[0]

        out = _greedy_loop(t_params, d_params, ids, t_cfg, d_cfg,
                           max_new_tokens, gamma, verify, t_logits, stats)
    return out, stats


def generate_speculative_sampled(t_params: Dict, d_params: Dict,
                                 prompt_ids, t_cfg: TransformerConfig,
                                 d_cfg: TransformerConfig,
                                 max_new_tokens: int = 32, gamma: int = 4,
                                 temperature: float = 1.0, top_k: int = 0,
                                 top_p: float = 1.0, seed: int = 0,
                                 device=None) -> Tuple[torch.Tensor, dict]:
    """Speculative SAMPLING: temperature > 0 generation whose output is
    distributed exactly as sampling from the target alone.

    Per round the draft samples gamma proposals from its own warped
    distribution (and consumes its last one); the target scores the window
    once; proposal x_i is accepted with probability min(1, p_t(x_i) /
    p_d(x_i)); the first rejection resamples from the normalized residual
    max(p_t - p_d, 0), and full acceptance samples the bonus token from
    p_t (the same formula with the draft term zero). A row whose own
    acceptance ran past the batch minimum (or the length cap) emits its
    accepted draft at the cut, never a resample. Top-k / top-p warp the
    target and the draft alike (:func:`transformer._warp_scaled_rows`).
    Draws: see the module docstring. Returns ``(ids, stats)``."""
    _check(t_cfg, d_cfg, gamma)
    if not temperature > 0.0:
        raise ValueError("temperature must be > 0 — use "
                         "generate_speculative_fused for greedy")
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError("top_k must be >= 0 and top_p in (0, 1]")
    t_params, d_params, ids, dev = _setup(t_params, d_params, prompt_ids,
                                          t_cfg, d_cfg, device)
    B, P = ids.shape
    L = P + max_new_tokens + gamma + 1
    V = t_cfg.vocab
    seeds = _row_seeds(seed, B, dev)
    temp = float(temperature)
    warp = top_k > 0 or top_p < 1.0

    def warm_logp(logits):
        """Temperature, the warp, log-softmax: the same for both models,
        so the ratio test stays exact."""
        scaled = logits.float() / temp
        if warp:
            flat = scaled.reshape(-1, V)
            rows = flat.shape[0]
            flat = _warp_scaled_rows(
                flat, torch.full((rows,), int(top_k), device=dev),
                torch.full((rows,), float(top_p), device=dev))
            scaled = flat.reshape(scaled.shape)
        return torch.log_softmax(scaled, dim=-1)

    idxs = torch.arange(gamma + 1, device=dev)
    rounds = accepted = 0
    with torch.no_grad():
        lengths = torch.full((B,), P, device=dev)
        t_logits, t_cache = prefill_cache(t_params, ids, lengths, t_cfg, L)
        _, d_cache = prefill_cache(d_params, ids, lengths, d_cfg, L)
        pending = _gumbel_argmax(warm_logp(t_logits),
                                 _draws(seeds, P, 0, V)).long()
        buf = torch.zeros((B, L), dtype=torch.int64, device=dev)
        buf[:, :P] = ids
        buf[:, P] = pending
        m = P
        while m - P + 1 < max_new_tokens:
            tok, props, d_logps = pending, [], []
            for i in range(gamma + 1):
                lg = _window_at_(d_params, tok[:, None], m + i, d_cache,
                                 d_cfg)[:, 0]
                if i == gamma:          # this step only wrote its K/V
                    break
                logp = warm_logp(lg)
                tok = _gumbel_argmax(logp, _draws(seeds, m + i + 1, 1,
                                                  V)).long()
                props.append(tok)
                d_logps.append(logp)
            drafts = torch.stack(props, dim=1)                   # (B, g)
            d_logp = torch.stack(d_logps, dim=1)                 # (B, g, V)
            wtoks = torch.cat([pending[:, None], drafts], dim=1)
            t_logp = warm_logp(_window_at_(t_params, wtoks, m, t_cache, t_cfg))
            # accept x_i iff u_i < p_t(x_i) / p_d(x_i), in logs
            qpos = (m + 1 + idxs[:gamma])[None].expand(B, gamma)
            us = _uniforms(seeds, qpos, 2, 1)[..., 0]
            lp_t = torch.gather(t_logp[:, :gamma], -1,
                                drafts[..., None])[..., 0]
            lp_d = torch.gather(d_logp, -1, drafts[..., None])[..., 0]
            acc = torch.log(us.clamp(min=1e-38)) < (lp_t - lp_d)
            k_rows = torch.cumprod(acc.to(torch.int32), dim=-1).sum(-1)
            k = min(int(k_rows.min()), max_new_tokens - (m - P + 1) - 1)
            # the token at window position k: a row that accepted x_k
            # (k_rows > k) emits it; a row that rejected at k resamples
            # from the normalized residual (p_d is 0 past the drafts, so
            # at k == gamma the residual is p_t: the bonus draw)
            p_t_k = torch.exp(t_logp[:, k])
            p_d_k = (torch.exp(d_logp[:, k]) if k < gamma
                     else torch.zeros_like(p_t_k))
            resid = torch.clamp(p_t_k - p_d_k, min=0.0)
            total = resid.sum(-1, keepdim=True)
            resid = torch.where(total > 1e-30, resid / total, p_t_k)
            resampled = _gumbel_argmax(torch.log(resid.clamp(min=1e-38)),
                                       _draws(seeds, m + k + 1, 3,
                                              V)).long()
            pad_drafts = torch.cat([drafts, drafts[:, -1:]], dim=1)
            nxt = torch.where(k_rows > k, pad_drafts[:, k], resampled)
            emit = torch.where(idxs[None, :] < k, pad_drafts, nxt[:, None])
            buf[:, m + 1:m + gamma + 2] = emit
            rounds += 1
            accepted += k
            pending = nxt
            m = m + k + 1
    return buf[:, :P + max_new_tokens], {
        "target_forwards": rounds + 1, "rounds": rounds,
        "accepted_drafts": accepted, "draft_steps": rounds * (gamma + 1)}
