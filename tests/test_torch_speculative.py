"""Port parity: speculative decoding inside the continuous-batching engine
and the closed-loop autotuner (``serving/continuous.py``'s draft slot pool
and spec tick, ``serving/kv_pool.py``'s ``KVAutotuner``).

The reference invariants (``tests/test_continuous.py:1038``,
``tests/test_kv_pool.py:561``): greedy spec tokens are request-identical
to the plain engine's, whatever the draft; sampled spec tokens are
distributed as the target's own sampling. Here the port's spec engine
runs on the CPU (its verify windows through the plain K1/K2 version)
beside the port's plain engine and the JAX spec engine, with the same
seeded numpy weights; the tuner gets the same observations in both
packages.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu.serving import kv_pool as ref_pool
from mmlspark_tpu.serving.continuous import ContinuousDecoder as RefEngine
from mmlspark_tpu_torch.models.zoo import transformer as port_tf
from mmlspark_tpu_torch.observability.registry import get_registry
from mmlspark_tpu_torch.serving import kv_pool as port_pool
from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
from mmlspark_tpu_torch.serving.generation import GenerationEngine

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

_TINY = dict(vocab=128, layers=2, d_model=64, heads=4, d_ff=128, max_len=64,
             causal=True, norm="rmsnorm", position="rope")
_DRAFT = dict(_TINY, layers=1, d_model=32, heads=2, d_ff=64)
REF_CFG = ref_tf.TransformerConfig(dtype=jnp.float32, **_TINY)
CFG = port_tf.TransformerConfig(dtype=torch.float32, **_TINY)
REF_D = ref_tf.TransformerConfig(dtype=jnp.float32, **_DRAFT)
D_CFG = port_tf.TransformerConfig(dtype=torch.float32, **_DRAFT)


@pytest.fixture(scope="module")
def params():
    return ref_tf.init_transformer(REF_CFG, seed=0)


def _drafts(params):
    """name -> (numpy draft params, (reference cfg, port cfg))."""
    return {"perfect": (params, (REF_CFG, CFG)),
            "weak": (ref_tf.init_transformer(REF_D, seed=99), (REF_D, D_CFG)),
            "weak7": (ref_tf.init_transformer(REF_D, seed=7), (REF_D, D_CFG))}


def _want(params, prompt, max_new, cfg=REF_CFG):
    ids = ref_tf.generate_cached(params, np.asarray(prompt)[None], cfg,
                                 max_new_tokens=max_new)
    return [int(t) for t in np.asarray(ids)[0, len(prompt):]]


def _drain(eng, reqs, limit=600):
    for _ in range(limit):
        if all(r.done for r in reqs):
            break
        eng.step()
    assert all(r.done for r in reqs)


# ---- KVAutotuner: the same decisions and history as the reference's ----

def _tuners(**kw):
    return ref_pool.KVAutotuner(**kw), port_pool.KVAutotuner(**kw)


def _same_tuner(ref, port):
    assert (port.gamma, port.chunk, port.depth) == (ref.gamma, ref.chunk,
                                                    ref.depth)
    assert port.history == ref.history


# the observation sequences of tests/test_kv_pool.py's TestAutotuner
_TUNER_CASES = {
    "gamma_raises": (dict(gamma=2, gamma_max=6, chunk=64, interval=4),
                     [(2, 4, "full", 100)] * 4),
    "gamma_drops": (dict(gamma=3, gamma_max=6, chunk=64, interval=4),
                    [(2, 4, 100, 100)] * 4),
    "chunk_tracks_occupancy": (dict(gamma=2, gamma_max=4, chunk=128,
                                    interval=2, chunk_min=32, chunk_max=512),
                               [(1, 8, None, None)] * 2
                               + [(8, 8, None, None)] * 2),
    "bounds_respected": (dict(gamma=1, gamma_max=2, chunk=32, interval=1,
                              chunk_min=32, chunk_max=64),
                         [(8, 8, 100, 100)]),
    "depth_tracks_occupancy": (dict(gamma=2, gamma_max=8, chunk=256,
                                    interval=2, depth=2, depth_min=1,
                                    depth_max=4),
                               [(1, 16, 10, 10)] * 6 + [(16, 16, 40, 20)] * 8),
}


@pytest.mark.parametrize("case", list(_TUNER_CASES))
def test_autotuner_matches_reference(case):
    kw, obs = _TUNER_CASES[case]
    ref, port = _tuners(**kw)
    for live, slots, emitted, rounds in obs:
        for t in (ref, port):
            # "full": every round emitted gamma + 1 tokens a slot
            e = (t.gamma + 1) * 2 * rounds if emitted == "full" else emitted
            t.observe(live, slots, spec_emitted=e,
                      spec_round_slots=None if rounds is None
                      else 2 * rounds if emitted == "full" else rounds)
        _same_tuner(ref, port)
    # every case but the bounds one moves a knob
    assert bool(port.history) == (case != "bounds_respected")


@settings(max_examples=40, deadline=None, derandomize=True)
@given(gamma=st.integers(1, 6), extra=st.integers(0, 4),
       chunk_exp=st.integers(5, 10), interval=st.integers(1, 5),
       depth=st.one_of(st.none(), st.integers(0, 5)),
       obs=st.lists(st.tuples(st.integers(0, 16), st.integers(0, 40),
                              st.integers(0, 12), st.booleans()),
                    min_size=1, max_size=60))
def test_autotuner_matches_reference_drawn(gamma, extra, chunk_exp,
                                           interval, depth, obs):
    ref, port = _tuners(gamma=gamma, gamma_max=gamma + extra,
                        chunk=2 ** chunk_exp, interval=interval, depth=depth,
                        depth_min=min(1, depth or 0),
                        depth_max=max(4, depth or 0))
    emitted = rounds = 0
    for live, d_emit, d_rounds, spec in obs:
        emitted += d_emit
        rounds += d_rounds
        for t in (ref, port):
            t.observe(live, 16, emitted if spec else None,
                      rounds if spec else None)
        _same_tuner(ref, port)


def test_autotuner_gauges():
    port = port_pool.KVAutotuner(gamma=3, gamma_max=6, chunk=64, interval=1,
                                 depth=2)
    port.observe(16, 16, spec_emitted=10, spec_round_slots=10)
    gauges = {m.name: m.series()[0][1].get() for m in get_registry().metrics()
              if m.name.startswith("mmlspark_kvpool_autotune_")}
    assert gauges == {"mmlspark_kvpool_autotune_gamma": 2.0,
                      "mmlspark_kvpool_autotune_chunk_budget": 32.0,
                      "mmlspark_kvpool_autotune_pipeline_depth": 1.0}


# ---- the in-place draft step ----

@pytest.mark.parametrize("position", ["rope", "learned"])
def test_inplace_draft_step_bitwise(position):
    cfg = D_CFG._replace(position=position, max_len=40)
    p = port_tf.params_from_numpy(
        ref_tf.init_transformer(REF_D._replace(position=position,
                                               max_len=40), seed=3),
        cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    cache = [{kk: torch.randn(4, 2, 44, 16, generator=g) for kk in "kv"}
             for _ in range(cfg.layers)]
    tokens = torch.tensor([3, 9, 100, 0])
    pos = torch.tensor([0, 17, 43, 41])        # 41 and 43 past the table
    active = torch.tensor([True, False, True, True])
    want, new = port_tf.decode_step_ragged(p, tokens, pos, cache, cfg,
                                           active)
    pool = [{kk: t.clone() for kk, t in c.items()} for c in cache]
    got = port_tf.decode_step_ragged_inplace(p, tokens, pos, pool, cfg,
                                             active)
    assert torch.equal(got, want)
    for c_new, c_pool, c_old in zip(new, pool, cache):
        for kk in "kv":
            assert torch.equal(c_pool[kk], c_new[kk])
            assert torch.equal(c_pool[kk][1], c_old[kk][1])   # inactive


# ---- greedy spec: the port's plain engine and the JAX spec engine ----

def _scenario(eng, name, rng_seed):
    """Drive one engine (either package: same client API) through a named
    scenario; returns every request's tokens."""
    rng = np.random.default_rng(rng_seed)
    if name == "staggered":
        prompts = [rng.integers(0, 128, n) for n in (3, 9, 5, 7)]
        reqs = [eng.submit(prompts[0], 6)]
        eng.step()
        reqs += [eng.submit(p, m) for p, m in zip(prompts[1:], (4, 8, 5))]
    elif name == "prefix":
        sys_prefix = rng.integers(0, 128, 6)
        reqs = [eng.submit(np.concatenate([sys_prefix,
                                           rng.integers(0, 128, 3)]), 5,
                           prefix_key="sys", prefix_len=6)
                for _ in range(3)]
    elif name == "chunked":
        live = eng.submit(rng.integers(0, 128, 4), 12)
        eng.step()
        reqs = [live, eng.submit(rng.integers(0, 128, 29), 6)]
    else:
        prompts = [rng.integers(0, 128, int(rng.integers(3, 10)))
                   for _ in range(6)]
        reqs = [eng.submit(p, m) for p, m in zip(prompts, (6, 2, 9, 4, 1, 7))]
    _drain(eng, reqs)
    return [[int(t) for t in r.tokens] for r in reqs]


# (draft, scenario, engine keywords): the reference's TestSpeculativePool
# cases, k in {1, 2} x gamma in {1, 3}, chunked prompts, the autotuner
_GREEDY = {
    "perfect": ("perfect", "mix", dict(steps_per_dispatch=2, gamma=3)),
    "weak": ("weak", "mix", dict(steps_per_dispatch=2, gamma=3)),
    "staggered": ("weak7", "staggered", dict(steps_per_dispatch=2, gamma=3)),
    "prefix": ("weak", "prefix", dict(steps_per_dispatch=2, gamma=3)),
    "chunked": ("weak", "chunked", dict(page_size=4, prefill_chunk=8,
                                        gamma=3)),
    "k1_gamma1": ("weak", "mix", dict(steps_per_dispatch=1, gamma=1)),
    "k1_gamma3": ("perfect", "staggered", dict(steps_per_dispatch=1,
                                               gamma=3)),
    "k2_gamma1": ("perfect", "mix", dict(steps_per_dispatch=2, gamma=1)),
    "autotune": ("weak", "mix", dict(page_size=4, gamma=2, autotune=True)),
}


@pytest.mark.parametrize("case", list(_GREEDY))
def test_greedy_spec_matches_plain_and_reference(params, case):
    draft_name, scenario, kw = _GREEDY[case]
    draft, (ref_d, port_d) = _drafts(params)[draft_name]
    base = dict(max_slots=2, max_len=48, **kw)
    plain_kw = {k: v for k, v in base.items()
                if k not in ("gamma", "autotune")}
    plain = _scenario(ContinuousDecoder(params, CFG, device="cpu",
                                        **plain_kw), scenario, 42)
    port = ContinuousDecoder(params, CFG, device="cpu", draft_params=draft,
                             draft_cfg=port_d, **base)
    ref = RefEngine(params, REF_CFG, draft_params=draft, draft_cfg=ref_d,
                    **base)
    got = _scenario(port, scenario, 42)
    assert got == plain
    assert got == _scenario(ref, scenario, 42)
    # the acceptance counters, exactly the reference's
    for key in ("spec_emitted", "spec_round_slots", "prefills",
                "prefix_hits"):
        assert port.stats[key] == ref.stats[key], key
    # one verify window a round: k of them every dispatch
    assert port.stats["spec_verify_windows"] == \
        len(port.tick_seconds) * port._k > 0
    if "autotune" in kw:
        assert port._tuner.history == ref._tuner.history
        assert (port._tuner.gamma, port._tuner.chunk) == \
            (ref._tuner.gamma, ref._tuner.chunk)
    if draft_name == "perfect":
        # every round of a perfect draft emits gamma + 1 until the budget
        assert port.stats["spec_emitted"] > port.stats["spec_round_slots"]
    assert port._kv.pages_in_use == ref._kv.pages_in_use


def test_eos_inside_accepted_prefix(params):
    rng = np.random.default_rng(44)
    prompts = [rng.integers(0, 128, 4) for _ in range(3)]
    full = [_want(params, p, 12) for p in prompts]
    eos = full[0][2]
    outs = []
    for eng in (ContinuousDecoder(params, CFG, device="cpu", max_slots=2,
                                  max_len=48, steps_per_dispatch=2, gamma=4,
                                  eos_id=eos, draft_params=params,
                                  draft_cfg=CFG),
                RefEngine(params, REF_CFG, max_slots=2, max_len=48,
                          steps_per_dispatch=2, gamma=4, eos_id=eos,
                          draft_params=params, draft_cfg=REF_CFG)):
        reqs = [eng.submit(p, 12) for p in prompts]
        _drain(eng, reqs)
        outs.append([r.tokens for r in reqs])
    for want, got in zip(full, outs[0]):
        stop = want.index(eos) + 1 if eos in want else 12
        assert got == want[:stop]
    assert outs[0] == [[int(t) for t in r] for r in outs[1]]


def test_acceptance_counters_cover_the_drained_window(params):
    """With the draft identical to the target: 8 tokens after the first in
    two rounds of 4, counted at drain time (tests/test_kv_pool.py:526)."""
    eng = ContinuousDecoder(params, CFG, device="cpu", max_slots=2,
                            max_len=48, page_size=4, draft_params=params,
                            draft_cfg=CFG, gamma=3, pipeline_depth=2)
    prompt = np.random.default_rng(16).integers(1, 128, 5)
    req = eng.submit(prompt, max_new_tokens=9)
    _drain(eng, [req], 200)
    eng.flush()
    assert req.tokens == _want(params, prompt, 9)
    assert eng.stats["spec_emitted"] == 8
    assert eng.stats["spec_round_slots"] == 2


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_page_types_match_reference_engine(params, kv_dtype):
    """bf16 pages (a bf16 model), int8 and fp8 pages: the port's greedy
    spec tokens equal the JAX spec engine's and the port's plain
    engine's."""
    dt = (jnp.bfloat16, torch.bfloat16) if kv_dtype is None else \
        (jnp.float32, torch.float32)
    ref_cfg, cfg = REF_CFG._replace(dtype=dt[0]), CFG._replace(dtype=dt[1])
    draft, (ref_d, port_d) = _drafts(params)["weak"]
    ref_d, port_d = ref_d._replace(dtype=dt[0]), port_d._replace(dtype=dt[1])
    kw = dict(max_slots=2, max_len=48, page_size=4, prefill_chunk=8,
              kv_dtype=kv_dtype, steps_per_dispatch=2)
    ref = RefEngine(params, ref_cfg, draft_params=draft, draft_cfg=ref_d,
                    gamma=3, **kw)
    port = ContinuousDecoder(params, cfg, device="cpu", draft_params=draft,
                             draft_cfg=port_d, gamma=3, **kw)
    plain = ContinuousDecoder(params, cfg, device="cpu", **kw)
    want = _scenario(ref, "chunked", 21)
    assert _scenario(port, "chunked", 21) == want
    assert _scenario(plain, "chunked", 21) == want
    assert port._kv.stats["attn_ticks_kernel"] > 0
    assert port._kv.stats["gather_bytes"] == 0
    if kv_dtype is not None:
        assert port._kv.kv_dtype == kv_dtype


def test_learned_positions_past_the_table(params):
    """prompt + max_new == max_len on a learned-position target: the
    verify windows write gamma + 1 positions past the table, which clamp
    as in the reference (no index error), and the tokens stay the JAX
    spec engine's and generate_cached's."""
    ref_cfg = REF_CFG._replace(position="learned", norm="layernorm",
                               max_len=32)
    cfg = CFG._replace(position="learned", norm="layernorm", max_len=32)
    lp = ref_tf.init_transformer(ref_cfg, seed=4)
    draft = ref_tf.init_transformer(REF_D, seed=99)
    prompt = np.random.default_rng(5).integers(0, 128, 20)
    outs = []
    for eng in (ContinuousDecoder(lp, cfg, device="cpu", max_slots=1,
                                  max_len=32, gamma=3, draft_params=draft,
                                  draft_cfg=D_CFG),
                RefEngine(lp, ref_cfg, max_slots=1, max_len=32, gamma=3,
                          draft_params=draft, draft_cfg=REF_D)):
        req = eng.submit(prompt, 12)
        _drain(eng, [req])
        outs.append([int(t) for t in req.tokens])
    assert outs[0] == outs[1] == _want(lp, prompt, 12, ref_cfg)


def test_validation_matches_reference(params):
    draft = ref_tf.init_transformer(REF_D, seed=1)
    bad_vocab = dict(_DRAFT, vocab=64)
    cases = [
        (dict(draft_params=draft), "draft_cfg"),
        (dict(draft_params=ref_tf.init_transformer(
            ref_tf.TransformerConfig(dtype=jnp.float32, **bad_vocab),
            seed=1), draft_cfg=bad_vocab), "vocab"),
        (dict(draft_params=draft, draft_cfg=dict(_DRAFT, causal=False)),
         "causal and dense"),
        (dict(draft_params=draft, draft_cfg=dict(_DRAFT, moe_experts=2)),
         "causal and dense"),
        (dict(gamma=0), "gamma"),
        (dict(draft_params=draft, draft_cfg=_DRAFT, gamma=0), "gamma"),
    ]
    for kw, match in cases:
        dcfg = kw.pop("draft_cfg", None)
        with pytest.raises(ValueError, match=match):
            RefEngine(params, REF_CFG, max_slots=1, max_len=16, **kw,
                      **({} if dcfg is None else {
                          "draft_cfg": ref_tf.TransformerConfig(
                              dtype=jnp.float32, **dcfg)}))
        with pytest.raises(ValueError, match=match):
            ContinuousDecoder(params, CFG, device="cpu", max_slots=1,
                              max_len=16, **kw,
                              **({} if dcfg is None else {
                                  "draft_cfg": port_tf.TransformerConfig(
                                      dtype=torch.float32, **dcfg)}))
    # the port's own check: a learned draft table shorter than max_len
    learned = D_CFG._replace(position="learned", norm="layernorm",
                             max_len=32)
    with pytest.raises(ValueError, match="draft's learned position"):
        ContinuousDecoder(params, CFG, device="cpu", max_slots=1, max_len=48,
                          draft_params=ref_tf.init_transformer(
                              REF_D._replace(position="learned",
                                             norm="layernorm", max_len=32),
                              seed=1),
                          draft_cfg=learned)
    # sampled submits are served (the per-slot rejection correction)
    eng = ContinuousDecoder(params, CFG, device="cpu", max_slots=1,
                            max_len=32, draft_params=draft, draft_cfg=D_CFG)
    eng.submit(np.asarray([1, 2, 3]), 4, temperature=0.5, top_k=3)
    assert eng._gamma_max == 4 and eng._Lc == 32 + 5


def test_autotune_sizes_for_the_gamma_ceiling(params):
    draft, _ = _drafts(params)["weak"]
    eng = ContinuousDecoder(params, CFG, device="cpu", max_slots=2,
                            max_len=48, page_size=4, steps_per_dispatch=2,
                            draft_params=draft, draft_cfg=D_CFG, gamma=2,
                            autotune=True)
    ref = RefEngine(params, REF_CFG, max_slots=2, max_len=48, page_size=4,
                    steps_per_dispatch=2, draft_params=draft,
                    draft_cfg=REF_D, gamma=2, autotune=True)
    for a in ("_gamma_max", "_Lc", "_P_max", "_max_per_dispatch"):
        assert getattr(eng, a) == getattr(ref, a), a
    assert eng._kv.num_pages == ref._kv.num_pages
    assert eng._need(5, 7) == ref._need(5, 7)
    assert [tuple(c["k"].shape) for c in eng._d_cache] == \
        [tuple(np.shape(c["k"])) for c in ref._d_cache]


# ---- sampled spec rows: distributional ----

V_CFG = dict(vocab=32, layers=2, d_model=32, heads=4, d_ff=64, max_len=64,
             causal=True, norm="rmsnorm", position="rope")
V_DRAFT = dict(V_CFG, layers=1, d_model=16, heads=2, d_ff=32)
TEMP = 1.3
#: the empirical marginals of N = 512 seeds lie within this total
#: variation of the exact ones: at V = 32 the expected TV of 512 draws is
#: at most 0.5 * sum_v sqrt(2 p_v / (pi N)) <= 0.1 (uniform p), so 0.15
#: leaves room for the fluctuation without hiding a wrong distribution
#: (dropping the residual correction moves these marginals by more)
TV_BOUND = 0.15


def _exact_marginals(t_params, prompt, warp):
    """Exact distributions of the first two emitted tokens from the JAX
    reference's forwards, each row warped by ``warp`` (logits → probs)."""
    rcfg = ref_tf.TransformerConfig(dtype=jnp.float32, **V_CFG)
    V = rcfg.vocab
    logits, cache = ref_tf.prefill_cache(
        t_params, jnp.asarray(prompt[None]), jnp.asarray([prompt.size],
                                                         jnp.int32), rcfg, 8)
    p1 = warp(np.asarray(logits, np.float64)[0])
    cache_v = [{k: jnp.repeat(c[k], V, axis=0) for k in ("k", "v")}
               for c in cache]
    l2, _ = ref_tf.decode_step(t_params, jnp.arange(V, dtype=jnp.int32),
                               prompt.size, cache_v, rcfg)
    p2 = p1 @ np.stack([warp(r) for r in np.asarray(l2, np.float64)])
    return p1, p2


def _softmax_t(row, top_k=0):
    scaled = row / TEMP
    keep = (scaled >= np.sort(scaled)[::-1][top_k - 1] if top_k
            else np.ones_like(scaled, bool))
    e = np.where(keep, np.exp(scaled - scaled.max()), 0.0)
    return e / e.sum()


@pytest.mark.parametrize("top_k", [0, 3])
def test_sampled_marginals_match_target(top_k):
    """The first two emitted tokens of 512 seeded requests (the second
    from a spec round, with the draft's proposals and the rejection
    correction) against the target's exact, optionally top-k warped,
    distributions."""
    t_params = ref_tf.init_transformer(
        ref_tf.TransformerConfig(dtype=jnp.float32, **V_CFG), seed=1)
    d_params = ref_tf.init_transformer(
        ref_tf.TransformerConfig(dtype=jnp.float32, **V_DRAFT), seed=7)
    prompt = np.asarray([3, 11, 4, 17], np.int32)
    N = 512
    eng = ContinuousDecoder(
        t_params, port_tf.TransformerConfig(dtype=torch.float32, **V_CFG),
        device="cpu", max_slots=16, max_len=32, steps_per_dispatch=2,
        draft_params=d_params,
        draft_cfg=port_tf.TransformerConfig(dtype=torch.float32, **V_DRAFT),
        gamma=2)
    reqs = [eng.submit(prompt, 2, temperature=TEMP, top_k=top_k, seed=i)
            for i in range(N)]
    _drain(eng, reqs, 4000)
    toks = np.asarray([r.tokens for r in reqs])
    p1, p2 = _exact_marginals(t_params, prompt,
                              lambda row: _softmax_t(row, top_k))
    for j, p in enumerate((p1, p2)):
        emp = np.bincount(toks[:, j], minlength=p.size) / N
        tv = 0.5 * np.abs(emp - p).sum()
        assert tv < TV_BOUND, (j, tv)
        assert set(np.unique(toks[:, j])) <= set(np.nonzero(p)[0])
    assert eng.stats["spec_round_slots"] > 0


@pytest.mark.parametrize("gamma", [1, 3])
def test_spec_accept_corrects_to_the_target(gamma):
    """The verify round's decision on 20,000 rows with a fixed target
    p_t and a draft p_d that overlap partly: the first emitted token
    (the accepted proposal, else the resample) is distributed as p_t.
    Sample noise puts the TV near 0.01; resampling from p_t instead of
    the residual would give min(p_t, p_d) + (1 - sum min) p_t, TV 0.12
    here, and accepting every proposal p_d itself, TV 0.6."""
    from mmlspark_tpu_torch.serving.continuous import _spec_accept
    S, V = 20_000, 8
    p_t = torch.tensor([0.5, 0.3, 0.2, 0, 0, 0, 0, 0], dtype=torch.float64)
    p_d = torch.tensor([0.1, 0.1, 0.2, 0.6, 0, 0, 0, 0], dtype=torch.float64)
    g = torch.Generator().manual_seed(gamma)
    logt = torch.log(p_t.float()).expand(S, gamma + 1, V)
    logd = torch.log(p_d.float()).expand(S, gamma, V)
    drafts = torch.multinomial(p_d.float(), S * gamma, replacement=True,
                               generator=g).reshape(S, gamma).to(torch.int32)
    greedy = torch.zeros(S, gamma + 1, dtype=torch.int32)
    k, final = _spec_accept(greedy, drafts, torch.ones(S), logt, logd,
                            torch.rand(S, gamma, generator=g),
                            torch.rand(S, V, generator=g))
    first = torch.where(k > 0, drafts[:, 0], final)
    emp = torch.bincount(first.long(), minlength=V).double() / S
    assert 0.5 * (emp - p_t).abs().sum() < 0.03
    # greedy rows ignore every draw: accept while drafts match argmax 0
    kg, fg = _spec_accept(greedy, drafts, torch.zeros(S), logt, logd,
                          torch.rand(S, gamma, generator=g),
                          torch.rand(S, V, generator=g))
    want_k = torch.cumprod((drafts == 0).to(torch.int32), 1).sum(1)
    assert torch.equal(kg, want_k.to(torch.int32))
    assert torch.equal(fg, torch.zeros(S, dtype=torch.int32))


def test_mixed_pool_keeps_greedy_bit_exact(params):
    d_cfg = D_CFG
    draft = ref_tf.init_transformer(REF_D, seed=5)
    eng = ContinuousDecoder(params, CFG, device="cpu", max_slots=2,
                            max_len=48, steps_per_dispatch=2,
                            draft_params=draft, draft_cfg=d_cfg, gamma=3)
    rng = np.random.default_rng(51)
    g_prompt = rng.integers(0, 128, 5)
    s_prompt = rng.integers(0, 128, 6)
    g = eng.submit(g_prompt, 7)
    s = eng.submit(s_prompt, 7, temperature=0.9, top_p=0.8, seed=4)
    _drain(eng, [g, s], 200)
    assert eng.result(g) == _want(params, g_prompt, 7)
    assert len(eng.result(s)) == 7
    assert all(0 <= t < 128 for t in s.tokens)
    # the sampled request's tokens depend on its seed, not its neighbour
    alone = ContinuousDecoder(params, CFG, device="cpu", max_slots=2,
                              max_len=48, steps_per_dispatch=2,
                              draft_params=draft, draft_cfg=d_cfg, gamma=3)
    s2 = alone.submit(s_prompt, 7, temperature=0.9, top_p=0.8, seed=4)
    _drain(alone, [s2], 200)
    assert s2.tokens == s.tokens


def test_eos_with_sampled_spec(params):
    draft = ref_tf.init_transformer(REF_D, seed=5)
    eng = ContinuousDecoder(params, CFG, device="cpu", max_slots=1,
                            max_len=48, steps_per_dispatch=2, eos_id=7,
                            draft_params=draft, draft_cfg=D_CFG, gamma=2)
    rng = np.random.default_rng(52)
    req = eng.submit(rng.integers(0, 128, 4), 20, temperature=1.5, seed=9)
    _drain(eng, [req], 200)
    got = eng.result(req)
    assert 1 <= len(got) <= 20
    assert 7 not in got[:-1]


# ---- HTTP ----

def test_generation_engine_with_a_draft(params):
    draft, _ = _drafts(params)["weak"]
    rng = np.random.default_rng(61)
    prompts = [[int(t) for t in rng.integers(0, 128, n)] for n in (5, 11)]
    with GenerationEngine(params, CFG, device="cpu", max_slots=2, max_len=48,
                          draft_params=draft, draft_cfg=D_CFG, gamma=2,
                          autotune=True) as eng:
        assert eng.decoder._spec and eng.decoder._tuner is not None
        for prompt in prompts:
            req = urllib.request.Request(
                eng.address, data=json.dumps({"tokens": prompt,
                                              "max_new": 7}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                assert json.loads(r.read())["tokens"] == \
                    _want(params, prompt, 7)


def test_spec_on_a_mesh_raises(params):
    """Once a refusal, now speculation on a ("dp",) = (2,) mesh: the draft
    replicated, each rank's verify windows over its own slots; every rank
    gives the plain greedy tokens and ran the same rounds."""
    import test_torch_mesh_ranks as ranks
    from mmlspark_tpu_torch.parallel.launch import run_ranks
    d_params, _ = _drafts(params)["weak"]
    rng = np.random.default_rng(71)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (5, 9, 13)]
    res = run_ranks(ranks.spec_dp_engine, 2, args=(params, d_params, prompts),
                    device="cpu", axes={"dp": 2}, threads=1, timeout=300)
    for rank, r in enumerate(res):
        assert r["slot_axis"] == "dp" and r["rows"] == [2 * rank,
                                                        2 * rank + 2]
        assert r["tokens"] == [_want(params, p, 8) for p in prompts]
        assert r["windows"] == res[0]["windows"] > 0


def test_jax_draft_params_accepted(params):
    """``np.asarray`` of the reference's jax arrays loads as a draft too."""
    jd = jax.tree.map(jnp.asarray, ref_tf.init_transformer(REF_D, seed=99))
    eng = ContinuousDecoder(params, CFG, device="cpu", max_slots=1,
                            max_len=32, draft_params=jd, draft_cfg=D_CFG,
                            gamma=2)
    req = eng.submit([4, 5, 6], 5)
    _drain(eng, [req])
    assert eng.result(req) == _want(params, [4, 5, 6], 5)


def test_tick_profile_spec_rehearses_on_the_cpu():
    """``tick_profile --spec``'s engines on the CPU toys: one record each,
    the spec engines emitting at least one token a round."""
    from mmlspark_tpu_torch.serving import tick_profile
    recs = tick_profile._spec_ticks("cpu", 2, gammas=(2, 1))
    assert [r["engine"] for r in recs] == ["plain", "spec_gamma2",
                                           "spec_gamma1"]
    assert all(r["wall_ms_per_tick"] > 0 for r in recs)
    assert all(r["tokens_per_round_slot"] >= 1.0 for r in recs[1:])
