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


@pytest.mark.parametrize("kw", [{"draft_params": {}}, {"mesh": object()},
                                {"kv_dtype": "int8"}, {"prefill_ahead": 2},
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
