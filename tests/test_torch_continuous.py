"""Port parity: the continuous-batching decoder (``serving/continuous.py``).

The reference invariant (``tests/test_continuous.py:240``): each
request's greedy tokens equal the JAX ``generate_cached`` on its prompt
alone, however requests share the slot pool. The port's engine runs on
the CPU with the reference's seeded weights; its attention goes through
the kernel wrapper (the plain version on CPU tensors) unless a test asks
for the gather path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu_torch.models.zoo import transformer as port_tf
from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder

import test_torch_mesh_ranks as ranks

REF_CFG = ref_tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                                   d_ff=128, max_len=64, causal=True,
                                   norm="rmsnorm", position="rope",
                                   dtype=jnp.float32)
CFG = port_tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                                d_ff=128, max_len=64, causal=True,
                                norm="rmsnorm", position="rope",
                                dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return ref_tf.init_transformer(REF_CFG, seed=0)


def _want(params, prompt, max_new):
    ids = ref_tf.generate_cached(params, np.asarray(prompt)[None], REF_CFG,
                                 max_new_tokens=max_new)
    return [int(t) for t in np.asarray(ids)[0, len(prompt):]]


def _engine(params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 48)
    return ContinuousDecoder(params, CFG, device="cpu", **kw)


def _drain(eng, reqs, limit=400):
    for _ in range(limit):
        if all(r.done for r in reqs):
            break
        eng.step()
    assert all(r.done for r in reqs)


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_single_request_matches_generate_cached(params, impl):
    eng = _engine(params, paged_attn=impl)
    prompt = np.random.default_rng(5).integers(0, 128, 7)
    req = eng.submit(prompt, 9)
    _drain(eng, [req])
    assert eng.result(req) == _want(params, prompt, 9)
    key = "attn_ticks_kernel" if impl == "kernel" else "attn_ticks_gather"
    assert eng._kv.stats[key] > 0
    assert (eng._kv.stats["gather_bytes"] == 0) == (impl == "kernel")


def test_staggered_requests_contending_for_slots(params):
    eng = _engine(params)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 128, n) for n in (3, 9, 5)]
    max_new = [6, 4, 8]
    reqs = [eng.submit(prompts[0], max_new[0])]
    eng.step()
    reqs.append(eng.submit(prompts[1], max_new[1]))
    eng.step()
    reqs.append(eng.submit(prompts[2], max_new[2]))
    _drain(eng, reqs)
    for p, mn, r in zip(prompts, max_new, reqs):
        assert eng.result(r) == _want(params, p, mn)


@pytest.mark.parametrize("k,depth", [(3, 2), (2, 0)])
def test_steps_per_dispatch_and_pipeline_depth(params, k, depth):
    eng = _engine(params, max_slots=3, steps_per_dispatch=k,
                  pipeline_depth=depth)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 128, n) for n in (4, 6, 3, 5)]
    reqs = [eng.submit(p, 7) for p in prompts]
    _drain(eng, reqs)
    for p, r in zip(prompts, reqs):
        assert eng.result(r) == _want(params, p, 7)
    eng.flush()
    assert eng._pending == [] and all(s is None for s in eng._slot_req)


def test_chunked_prompt(params):
    eng = _engine(params, max_len=64, page_size=4, prefill_chunk=8)
    rng = np.random.default_rng(8)
    live = eng.submit(rng.integers(0, 128, 4), 12)
    eng.step()
    prompt = rng.integers(0, 128, 29)
    req = eng.submit(prompt, 6)
    _drain(eng, [live, req])
    assert eng._chunk_trace and max(eng._chunk_trace) <= 8
    assert eng._kv.stats["prefill_chunks"] == len(eng._chunk_trace)
    assert eng.result(req) == _want(params, prompt, 6)


def test_prefix_sharing_pair(params):
    eng = _engine(params, page_size=4)
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 128, 10)
    p_b = np.concatenate([prefix, rng.integers(0, 128, 3)])
    ra = eng.submit(prefix, 6, prefix_key="sys")
    _drain(eng, [ra])
    before = eng._kv.stats["prefix_share_hits"]
    rb = eng.submit(p_b, 6, prefix_key="sys")
    _drain(eng, [rb])
    assert eng._kv.stats["prefix_share_hits"] - before == 2
    assert eng.stats["prefix_hits"] == 1
    assert eng.result(ra) == _want(params, prefix, 6)
    assert eng.result(rb) == _want(params, p_b, 6)
    bad = eng.submit(rng.integers(0, 128, 12), 3, prefix_key="sys")
    _drain(eng, [bad])
    with pytest.raises(ValueError):
        eng.result(bad)


def test_eos_and_defrag_on_retire(params):
    rng = np.random.default_rng(10)
    p_long = rng.integers(0, 128, 9)
    full = _want(params, p_long, 10)
    j = next(j for j in range(1, len(full)) if full[j] not in full[:j])
    eng = _engine(params, page_size=4, defrag_threshold=1, eos_id=full[j])
    rs = eng.submit(rng.integers(0, 128, 5), 2)
    rl = eng.submit(p_long, 10)
    _drain(eng, [rs, rl])
    assert eng.result(rl) == full[:j + 1]
    assert eng._kv.stats["defrag_moves"] > 0
    assert eng._kv.pages_in_use == 0
    assert eng._slot_req == [None, None]


def test_sampled_decoding_is_seeded_per_request(params):
    """Sampled tokens depend on the request's seed, not on its pool
    neighbours: the same request alone and beside others gives the same
    tokens (they are not the reference's threefry draws)."""
    prompt = np.arange(1, 7)
    kw = dict(temperature=0.9, top_k=20, top_p=0.9, seed=42)
    alone = _engine(params)
    r1 = alone.submit(prompt, 8, **kw)
    _drain(alone, [r1])
    busy = _engine(params, max_slots=3, steps_per_dispatch=2)
    others = [busy.submit(np.arange(3, 9), 5, temperature=1.0, seed=7),
              busy.submit(np.arange(2, 5), 6)]
    r2 = busy.submit(prompt, 8, **kw)
    _drain(busy, others + [r2])
    assert r1.tokens == r2.tokens
    assert all(0 <= t < 128 for t in r1.tokens)
    other_seed = _engine(params)
    r3 = other_seed.submit(prompt, 8, **{**kw, "seed": 43})
    _drain(other_seed, [r3])
    assert r3.tokens != r1.tokens


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_scaled_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    S, V = 6, 50
    scaled = rng.normal(0, 2, (S, V)).astype(np.float32)
    top_k = np.array([0, 1, 5, 50, 80, 10], np.int32)
    top_p = np.array([1.0, 0.5, 0.9, 0.3, 1.0, 0.999], np.float32)
    want = np.asarray(ref_tf._warp_scaled_rows(
        jnp.asarray(scaled), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = port_tf._warp_scaled_rows(torch.from_numpy(scaled),
                                    torch.from_numpy(top_k),
                                    torch.from_numpy(top_p)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_submit_validation(params):
    eng = _engine(params)
    for args, kw in (((np.array([], np.int32), 3), {}),
                     (([1, 128], 3), {}),
                     (([1, 2], 0), {}),
                     ((np.arange(40), 9), {}),
                     (([1, 2], 3), {"top_p": 0.0}),
                     (([1, 2], 3), {"prefix_len": 1})):
        with pytest.raises(ValueError):
            eng.submit(*args, **kw)


@pytest.mark.parametrize("kw", [{"draft_params": {}},
                                {"mesh": ranks.StubMesh(dp=2, tp=1)},
                                {"prefill_ahead": 1}, {"prefill_ahead": 2},
                                {"journal": object()}])
def test_unported_options_raise(params, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _engine(params, **kw)


def test_unported_session_calls_raise(params):
    eng = _engine(params)
    with pytest.raises(NotImplementedError):
        eng.checkpoint_session(None)
    with pytest.raises(NotImplementedError):
        eng.restore_session({})


def test_default_device_raises_without_cuda(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ContinuousDecoder(params, CFG)


def test_background_thread_and_cancel(params):
    eng = _engine(params)
    t = eng.start()
    try:
        prompt = np.random.default_rng(11).integers(0, 128, 6)
        req = eng.submit(prompt, 5)
        assert eng.result(req, timeout=60) == _want(params, prompt, 5)
        assert req.first_token_at is not None
    finally:
        eng.stop()
        t.join(timeout=10)
    assert not t.is_alive()
    waiting = eng.submit([1, 2, 3], 4)
    cancelled = eng.cancel_all()
    assert waiting in cancelled and waiting.done


def test_jax_params_tree_accepted(params):
    """``np.asarray`` of the reference's jax arrays loads too."""
    jp = jax.tree.map(jnp.asarray, params)
    eng = ContinuousDecoder(jp, CFG, device="cpu", max_slots=1, max_len=32)
    req = eng.submit([4, 5, 6], 3)
    _drain(eng, [req])
    assert eng.result(req) == _want(params, [4, 5, 6], 3)


# ---- quantized pages: the port's int8 engine against the reference's ----

def _quant_case(eng, case):
    """Drive one engine (the reference's or the port's: same client API)
    through a plain prompt, a chunked prompt beside a live request, or a
    copy-on-write prefix-sharing pair; returns every request's tokens."""
    rng = np.random.default_rng(21)

    def run(reqs):
        for _ in range(400):
            if all(r.done for r in reqs):
                break
            eng.step()
        assert all(r.done for r in reqs)

    def prompt(n):
        return rng.integers(0, 128, n).astype(np.int32)

    if case == "plain":
        reqs = [eng.submit(prompt(7), max_new_tokens=9)]
        run(reqs)
    elif case == "chunked":
        live = eng.submit(prompt(4), max_new_tokens=12)
        eng.step()
        reqs = [live, eng.submit(prompt(29), max_new_tokens=6)]
        run(reqs)
    else:
        prefix = prompt(10)
        reqs = [eng.submit(prefix, max_new_tokens=6, prefix_key="sys")]
        run(reqs)
        reqs.append(eng.submit(np.concatenate([prefix, prompt(3)]),
                               max_new_tokens=6, prefix_key="sys"))
        run(reqs[1:])
    return [[int(t) for t in r.tokens] for r in reqs]


_QUANT_ENGINE = dict(max_slots=2, max_len=48, page_size=4, prefill_chunk=8,
                     quant_probe=1)


@pytest.mark.parametrize("case", ["plain", "chunked", "prefix"])
def test_int8_tokens_match_reference_engine(params, case):
    """Greedy tokens of the int8 engine equal the reference int8 engine's.
    The prefix case copies a boundary page: its scales must move with its
    codes, or the sharer decodes from wrongly scaled keys."""
    from mmlspark_tpu.serving.continuous import ContinuousDecoder as RefEngine
    ref = RefEngine(params, REF_CFG, kv_dtype="int8", **_QUANT_ENGINE)
    want = _quant_case(ref, case)
    eng = _engine(params, kv_dtype="int8", **_QUANT_ENGINE)
    assert _quant_case(eng, case) == want
    assert eng._kv.stats["attn_ticks_kernel"] > 0
    assert eng._kv.stats["gather_bytes"] == 0
    if case == "prefix":
        assert eng.stats["prefix_hits"] == 1
        assert eng._kv.stats["prefix_share_hits"] == 2
    if case == "chunked":
        assert eng._kv.stats["prefill_chunks"] > 1


def test_quant_probe_feeds_error_stats(params):
    """Every quant_probe'th insert of prefill rows measures their
    round-trip error; on one plain request it matches the reference's
    measurement of the same rows (summation order aside)."""
    from mmlspark_tpu.serving.continuous import ContinuousDecoder as RefEngine
    stats = {}
    for name, eng in (
            ("ref", RefEngine(params, REF_CFG, kv_dtype="int8",
                              **_QUANT_ENGINE)),
            ("port", _engine(params, kv_dtype="int8", **_QUANT_ENGINE))):
        _quant_case(eng, "plain")
        stats[name] = eng._kv.stats
    got, want = stats["port"], stats["ref"]
    assert got["quant_error_probes"] == want["quant_error_probes"] == 1
    assert 0.0 < got["quant_error_max"] < 0.02
    np.testing.assert_allclose(got["quant_error_last"],
                               want["quant_error_last"], rtol=1e-3)
    # sampled: with quant_probe=2 the first insert is skipped
    eng = _engine(params, kv_dtype="fp8", **{**_QUANT_ENGINE,
                                             "quant_probe": 2})
    reqs = [eng.submit(np.arange(1, 6), 3)]
    _drain(eng, reqs)
    assert eng._kv.stats["quant_error_probes"] == 0
    reqs = [eng.submit(np.arange(2, 9), 3)]
    _drain(eng, reqs)
    assert eng._kv.stats["quant_error_probes"] == 1
    assert 0.0 < eng._kv.stats["quant_error_last"] < 0.1


@pytest.mark.parametrize("probe", [1, 0])
def test_unquantized_engine_never_probes(params, probe):
    eng = _engine(params, quant_probe=probe)
    prompt = np.random.default_rng(22).integers(0, 128, 6)
    req = eng.submit(prompt, 4)
    _drain(eng, [req])
    assert eng.result(req) == _want(params, prompt, 4)
    assert eng._kv.kv_dtype is None and set(eng._kv.buffers[0]) == {"k", "v"}
    assert eng._kv.stats["quant_error_probes"] == 0
    assert eng._kv.stats["quant_error_last"] is None


@pytest.mark.parametrize("kw", [{"kv_dtype": "int4"}, {"quant_probe": -1},
                                {"kv_dtype": "int8", "quant_probe": -1}])
def test_quant_options_validated(params, kw):
    with pytest.raises(ValueError):
        _engine(params, **kw)


def test_int8_defrag_keeps_survivor_tokens(params):
    """Defrag on retire moves the survivor's pages and their scales
    through one permutation; its greedy tokens stay the reference's."""
    from mmlspark_tpu.serving.continuous import ContinuousDecoder as RefEngine
    rng = np.random.default_rng(23)
    p_short = rng.integers(1, 128, 5).astype(np.int32)
    p_long = rng.integers(1, 128, 9).astype(np.int32)
    outs = []
    for eng in (RefEngine(params, REF_CFG, max_slots=2, max_len=48,
                          page_size=4, kv_dtype="int8", defrag_threshold=1),
                _engine(params, page_size=4, kv_dtype="int8",
                        defrag_threshold=1)):
        rs = eng.submit(p_short, max_new_tokens=3)
        rl = eng.submit(p_long, max_new_tokens=24)
        for _ in range(400):
            if rs.done and rl.done:
                break
            eng.step()
        assert eng._kv.stats["defrag_moves"] > 0
        outs.append([int(t) for t in rl.tokens])
    assert outs[0] == outs[1] and len(outs[1]) == 24


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_prefix_boundary_copy_carries_scales(params, kv_dtype):
    """A prefix hit copies the stored prefix's boundary page into a private
    page: the prefix positions there must arrive with their scales, not
    with whatever scales the reused page held."""
    eng = _engine(params, page_size=4, kv_dtype=kv_dtype)
    rng = np.random.default_rng(24)
    prefix = rng.integers(0, 128, 10)
    _drain(eng, [eng.submit(prefix, 6, prefix_key="sys")])
    rb = eng.submit(np.concatenate([prefix, rng.integers(0, 128, 3)]), 6,
                    prefix_key="sys")
    eng.step()                 # admits rb: 2 shared pages + 1 copied
    stored, plen = eng._kv.lookup_prefix(eng._prefix_store["sys"][1])
    pages = eng._slot_pages[eng._slot_req.index(rb)]
    assert pages[:2] == list(stored[:2]) and pages[2] != stored[2]
    n = plen - 2 * 4           # prefix positions on the boundary page
    for c in eng._kv.buffers:
        for kk, t in c.items():
            raw = t.view(torch.uint8) if t.element_size() == 1 else t
            assert torch.equal(raw[pages[2], :, :n], raw[stored[2], :, :n]), kk
    _drain(eng, [rb])
