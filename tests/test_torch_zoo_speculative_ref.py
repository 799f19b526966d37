"""Port parity: the four speculative reference loops of
``models/zoo/speculative.py``, on the cases of ``tests/test_speculative.py``.

The same seeded numpy weights and prompts go through the JAX reference and
the port, in f32 on the CPU. Tolerances:

* greedy ids exactly the JAX loops' and the JAX ``generate_cached``'s,
  and every stats key equal to the JAX loop's (``rounds``,
  ``accepted_drafts``, ``target_forwards``, ``draft_steps``, the paged
  keys);
* ``generate_speculative_paged`` runs with ``paged_attn="gather"`` and
  with ``"kernel"``, whose wrapper runs the kernel's plain version on CPU
  tensors;
* the sampled loop draws from the port's hash, never the reference's
  threefry keys, so it is held distributionally, as the JAX test holds its
  own: the first two emitted tokens' marginals over thousands of
  identical rows against the enumerated (warped) target distribution,
  within the JAX test's bounds (0.035 and 0.045, about 4 sigma).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.zoo import speculative as rs
from mmlspark_tpu.models.zoo import transformer as ref
from mmlspark_tpu_torch.models.zoo import speculative as ps
from mmlspark_tpu_torch.models.zoo import transformer as port

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def cfg_pair(position="rope", vocab=64):
    t = dict(vocab=vocab, d_model=32, heads=4, layers=3, d_ff=64,
             max_len=128, causal=True, position=position)
    d = dict(vocab=vocab, d_model=16, heads=2, layers=1, d_ff=32,
             max_len=128, causal=True, position=position)
    return (ref.TransformerConfig(dtype=jnp.float32, **t),
            ref.TransformerConfig(dtype=jnp.float32, **d),
            port.TransformerConfig(dtype=torch.float32, **t),
            port.TransformerConfig(dtype=torch.float32, **d))


def make_models(position="rope", seed=0):
    rt, rd, pt, pd = cfg_pair(position)
    return (ref.init_transformer(rt, seed=seed),
            ref.init_transformer(rd, seed=seed + 100), rt, rd, pt, pd)


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- greedy ----------------------------------------------------------------

@pytest.mark.parametrize("position", ["rope", "learned"])
@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_loop_matches_reference_and_target_greedy(position, gamma):
    tp, dp, rt, rd, pt, pd = make_models(position)
    prompt = np.random.default_rng(2).integers(0, 64, (2, 6)).astype(
        np.int32)
    target = ref.generate_cached(tp, prompt, rt, max_new_tokens=20)
    want, wstats = rs.generate_speculative(tp, dp, prompt, rt, rd,
                                           max_new_tokens=20, gamma=gamma)
    got, stats = ps.generate_speculative(tp, dp, prompt, pt, pd,
                                         max_new_tokens=20, gamma=gamma,
                                         device="cpu")
    _same(got, target)
    _same(got, want)
    assert stats == wstats and stats["rounds"] >= 1


def test_perfect_draft_accepts_everything():
    tp, _, rt, _, pt, _ = make_models()
    prompt = np.random.default_rng(3).integers(0, 64, (1, 4)).astype(
        np.int32)
    max_new, gamma = 24, 3
    got, stats = ps.generate_speculative(tp, tp, prompt, pt, pt,
                                         max_new_tokens=max_new, gamma=gamma,
                                         device="cpu")
    _, wstats = rs.generate_speculative(tp, tp, prompt, rt, rt,
                                        max_new_tokens=max_new, gamma=gamma)
    _same(got, ref.generate_cached(tp, prompt, rt, max_new_tokens=max_new))
    assert stats == wstats
    assert stats["accepted_drafts"] / max(stats["rounds"], 1) > gamma - 0.5
    assert stats["target_forwards"] <= 2 + (max_new - 1) // (gamma + 1) + 1


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_fused_matches_loop_reference_and_target(gamma):
    tp, dp, rt, rd, pt, pd = make_models()
    prompt = np.random.default_rng(4).integers(0, 64, (2, 5)).astype(
        np.int32)
    target = ref.generate_cached(tp, prompt, rt, max_new_tokens=17)
    want, wstats = rs.generate_speculative_fused(
        tp, dp, prompt, rt, rd, max_new_tokens=17, gamma=gamma)
    got, stats = ps.generate_speculative_fused(
        tp, dp, prompt, pt, pd, max_new_tokens=17, gamma=gamma, device="cpu")
    loop, _ = ps.generate_speculative(tp, dp, prompt, pt, pd,
                                      max_new_tokens=17, gamma=gamma,
                                      device="cpu")
    _same(got, target)
    _same(got, want)
    np.testing.assert_array_equal(got.numpy(), loop.numpy())
    assert stats == wstats and stats["rounds"] >= 1


def test_fused_perfect_draft_forward_count():
    tp, _, rt, _, pt, _ = make_models()
    prompt = np.random.default_rng(5).integers(0, 64, (1, 4)).astype(
        np.int32)
    max_new, gamma = 24, 3
    got, stats = ps.generate_speculative_fused(
        tp, tp, prompt, pt, pt, max_new_tokens=max_new, gamma=gamma,
        device="cpu")
    _, wstats = rs.generate_speculative_fused(
        tp, tp, prompt, rt, rt, max_new_tokens=max_new, gamma=gamma)
    _same(got, ref.generate_cached(tp, prompt, rt, max_new_tokens=max_new))
    assert stats == wstats
    assert stats["target_forwards"] <= 2 + (max_new - 1) // (gamma + 1) + 1


@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("page_size", [3, 8])
def test_paged_matches_loop_reference_and_target(impl, page_size):
    """The paged target (block table 1 + b·n + j, page 0 the trash page)
    is token-identical to the contiguous loop and to the JAX paged loop,
    through the gather path and through the kernel's wrapper."""
    tp, dp, rt, rd, pt, pd = make_models()
    prompt = np.random.default_rng(5).integers(0, 64, (2, 7)).astype(
        np.int32)
    loop, lstats = ps.generate_speculative(tp, dp, prompt, pt, pd,
                                           max_new_tokens=16, gamma=3,
                                           device="cpu")
    got, stats = ps.generate_speculative_paged(
        tp, dp, prompt, pt, pd, max_new_tokens=16, gamma=3,
        page_size=page_size, paged_attn=impl, device="cpu")
    want, wstats = rs.generate_speculative_paged(
        tp, dp, prompt, rt, rd, max_new_tokens=16, gamma=3,
        page_size=page_size, paged_attn="gather")
    np.testing.assert_array_equal(got.numpy(), loop.numpy())
    _same(got, want)
    _same(got, ref.generate_cached(tp, prompt, rt, max_new_tokens=16))
    assert stats["accepted_drafts"] == lstats["accepted_drafts"]
    assert stats["paged_attn_impl"] == impl
    assert {k: v for k, v in stats.items() if k != "paged_attn_impl"} == \
        {k: v for k, v in wstats.items() if k != "paged_attn_impl"}


def test_validation():
    tp, dp, rt, rd, pt, pd = make_models()
    prompt = np.zeros((1, 2), np.int32)
    bad = pd._replace(vocab=pt.vocab + 1)
    for fn in (ps.generate_speculative, ps.generate_speculative_fused,
               ps.generate_speculative_paged,
               ps.generate_speculative_sampled):
        with pytest.raises(ValueError, match="vocab"):
            fn(tp, dp, prompt, pt, bad, device="cpu")
        with pytest.raises(ValueError, match="gamma"):
            fn(tp, dp, prompt, pt, pd, gamma=0, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        rs.generate_speculative(tp, dp, prompt, rt,
                                rd._replace(vocab=rt.vocab + 1))
    with pytest.raises(ValueError, match="page_size"):
        ps.generate_speculative_paged(tp, dp, prompt, pt, pd, page_size=0,
                                      device="cpu")
    with pytest.raises(ValueError, match="impl"):
        ps.generate_speculative_paged(tp, dp, prompt, pt, pd,
                                      paged_attn="dense", device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        ps.generate_speculative_sampled(tp, dp, prompt, pt, pd,
                                        temperature=0.0, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        ps.generate_speculative_sampled(tp, dp, prompt, pt, pd, top_p=0.0,
                                        device="cpu")


# -- sampled ---------------------------------------------------------------

TEMP = 1.3


def _sampled_setup(vocab=32):
    rt, rd, pt, pd = cfg_pair(vocab=vocab)
    tp = ref.init_transformer(rt, seed=1)
    dp = ref.init_transformer(rd, seed=7)           # a DIFFERENT model
    return tp, dp, pt, pd, np.asarray([[3, 11, 4, 17]], np.int32)


def _marginals(tp, pt, prompt, warp):
    """(p(tok1), p(tok2)) of the target by enumeration, ``warp`` mapping a
    row of logits to probabilities."""
    V, P = pt.vocab, prompt.shape[1]
    t = port.params_from_numpy(tp, pt, device="cpu")
    logits, cache = port.prefill_cache(t, torch.from_numpy(prompt).long(),
                                       torch.tensor([P]), pt, P + 4)
    p1 = warp(logits[0].numpy())
    cacheV = [{k: c[k].repeat(V, 1, 1, 1) for k in ("k", "v")}
              for c in cache]
    l2, _ = port.decode_step(t, torch.arange(V), P, cacheV, pt)
    return p1, p1 @ np.stack([warp(r) for r in l2.numpy()])


def _softmax_warp(row):
    s = np.asarray(row, np.float64) / TEMP
    e = np.exp(s - s.max())
    return e / e.sum()


def _topk_warp(k):
    def warp(row):
        s = np.asarray(row, np.float64) / TEMP
        kth = np.sort(s)[::-1][k - 1]
        e = np.where(s >= kth, np.exp(s - s.max()), 0.0)
        return e / e.sum()
    return warp


def _topp_warp(p):
    def warp(row):
        probs = _softmax_warp(row)
        order = np.argsort(-np.asarray(row, np.float64))
        keep_n = int(np.sum(np.cumsum(probs[order]) < p)) + 1
        out = np.zeros_like(probs)
        kept = order[:keep_n]
        out[kept] = probs[kept] / probs[kept].sum()
        return out
    return warp


def _emp(toks, V):
    return (np.bincount(toks[:, 0], minlength=V) / len(toks),
            np.bincount(toks[:, 1], minlength=V) / len(toks))


def test_sampled_marginals_match_target_exactly():
    tp, dp, pt, pd, prompt = _sampled_setup()
    N = 4096
    ids, stats = ps.generate_speculative_sampled(
        tp, dp, np.repeat(prompt, N, axis=0), pt, pd, max_new_tokens=3,
        gamma=2, temperature=TEMP, seed=11, device="cpu")
    p1, p2 = _marginals(tp, pt, prompt, _softmax_warp)
    e1, e2 = _emp(ids.numpy()[:, 4:], pt.vocab)
    assert np.abs(e1 - p1).max() < 0.035, np.abs(e1 - p1).max()
    assert np.abs(e2 - p2).max() < 0.035, np.abs(e2 - p2).max()
    assert set(stats) == {"target_forwards", "rounds", "accepted_drafts",
                          "draft_steps"}
    assert stats["draft_steps"] == stats["rounds"] * 3


def test_sampled_perfect_draft_high_acceptance_and_exact():
    tp, _, pt, _, prompt = _sampled_setup()
    N = 2048
    ids, stats = ps.generate_speculative_sampled(
        tp, tp, np.repeat(prompt, N, axis=0), pt, pt, max_new_tokens=6,
        gamma=2, temperature=TEMP, seed=3, device="cpu")
    p1, p2 = _marginals(tp, pt, prompt, _softmax_warp)
    e1, e2 = _emp(ids.numpy()[:, 4:], pt.vocab)
    assert np.abs(e1 - p1).max() < 0.045
    assert np.abs(e2 - p2).max() < 0.045
    assert stats["accepted_drafts"] >= stats["rounds"]


def test_sampled_rows_are_independent_and_seeded():
    tp, dp, pt, pd, prompt = _sampled_setup()
    kw = dict(max_new_tokens=4, gamma=2, temperature=TEMP, device="cpu")
    rows = np.repeat(prompt, 64, axis=0)
    a, _ = ps.generate_speculative_sampled(tp, dp, rows, pt, pd, seed=5,
                                           **kw)
    b, _ = ps.generate_speculative_sampled(tp, dp, rows, pt, pd, seed=5,
                                           **kw)
    c, _ = ps.generate_speculative_sampled(tp, dp, rows, pt, pd, seed=6,
                                           **kw)
    assert len({tuple(r) for r in a.numpy()[:, 4:]}) > 16
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())


@pytest.mark.parametrize("warp,kw", [
    (_topk_warp(3), dict(top_k=3, seed=13)),
    (_topp_warp(0.55), dict(top_p=0.55, seed=17))])
def test_sampled_warped_marginals(warp, kw):
    tp, dp, pt, pd, prompt = _sampled_setup()
    N = 2048
    ids, _ = ps.generate_speculative_sampled(
        tp, dp, np.repeat(prompt, N, axis=0), pt, pd, max_new_tokens=3,
        gamma=2, temperature=TEMP, device="cpu", **kw)
    toks = ids.numpy()[:, 4:]
    p1, p2 = _marginals(tp, pt, prompt, warp)
    e1, e2 = _emp(toks, pt.vocab)
    assert np.abs(e1 - p1).max() < 0.045, np.abs(e1 - p1).max()
    assert np.abs(e2 - p2).max() < 0.045, np.abs(e2 - p2).max()
    assert set(np.unique(toks[:, 0])) <= set(np.nonzero(p1)[0])
    assert set(np.unique(toks[:, 1])) <= set(np.nonzero(p2)[0])


def test_sampled_first_token_is_generates_draw():
    """The first emitted token is drawn at position P with purpose 0, the
    key ``generate`` uses there: one seed, the same first token."""
    tp, dp, pt, pd, prompt = _sampled_setup()
    rows = np.repeat(prompt, 16, axis=0)
    a, _ = ps.generate_speculative_sampled(tp, dp, rows, pt, pd,
                                           max_new_tokens=2, gamma=2,
                                           temperature=TEMP, seed=8,
                                           device="cpu")
    b = port.generate_cached(tp, rows, pt, max_new_tokens=1,
                             temperature=TEMP, seed=8, device="cpu")
    np.testing.assert_array_equal(a.numpy()[:, 4], b.numpy()[:, 4])
