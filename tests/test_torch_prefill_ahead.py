"""Port parity: prefill-ahead staging (``serving/continuous.py``'s
``prefill_ahead``), the reference's ``tests/test_continuous.py:864-1020``
restated against the JAX engine.

While every slot is occupied, waiting prompts prefill behind the decode
dispatch and park on the device; retiring slots re-fill from them. The
invariant: each request's tokens are the unstaged engine's. Here the
port's staged run must also give the JAX engine's greedy tokens and the
same ``staged_prefills`` count on the same schedule, charge the same
padded rows, keep FIFO order across pad buckets and prefix requests,
put a failed staged prefill's requests back at the front of the queue,
and run beside a draft.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu.serving.continuous import ContinuousDecoder as RefDecoder
from mmlspark_tpu_torch.models.zoo import transformer as port_tf
from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

WIDTHS = dict(vocab=128, layers=2, d_model=64, heads=4, d_ff=128,
              max_len=64, causal=True, norm="rmsnorm", position="rope")
REF_CFG = ref_tf.TransformerConfig(dtype=jnp.float32, **WIDTHS)
CFG = port_tf.TransformerConfig(dtype=torch.float32, **WIDTHS)


@pytest.fixture(scope="module")
def params():
    return ref_tf.init_transformer(REF_CFG, seed=0)


def _make(package, params, **kw):
    kw.setdefault("max_len", 48)
    if package == "jax":
        return RefDecoder(params, REF_CFG, **kw)
    return ContinuousDecoder(params, CFG, device="cpu", **kw)


def _run(package, params, ahead, prompts, maxnews, *, slots=2, k=3,
         depth=2, eos=None, sampling=None, **extra):
    eng = _make(package, params, max_slots=slots, steps_per_dispatch=k,
                pipeline_depth=depth, eos_id=eos, prefill_ahead=ahead,
                **extra)
    reqs = []
    for i, (p, m) in enumerate(zip(prompts, maxnews)):
        kw = dict(sampling or {})
        if sampling:
            kw["seed"] = i
        reqs.append(eng.submit(p, max_new_tokens=m, **kw))
    for _ in range(600):
        if all(r.done for r in reqs):
            break
        eng.step()
    return [eng.result(r, timeout=5) for r in reqs], eng


def test_greedy_tokens_and_staged_count_match_jax(params):
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 128, int(rng.integers(3, 10)))
               for _ in range(7)]
    maxnews = [5, 9, 2, 7, 4, 11, 6]
    want, ref = _run("jax", params, 6, prompts, maxnews)
    base, _ = _run("port", params, 0, prompts, maxnews)
    staged, eng = _run("port", params, 6, prompts, maxnews)
    assert staged == want == base
    assert eng.stats.get("staged_prefills", 0) > 0     # the path ran
    assert eng.stats["staged_prefills"] == ref.stats["staged_prefills"]
    assert not eng._staged


def test_partial_unit_insertion_across_waves(params):
    """A staged unit larger than the freed-slot count inserts across
    several admissions (2 slots, 5 one-bucket prompts, budget 4)."""
    rng = np.random.default_rng(32)
    prompts = [rng.integers(0, 128, 5) for _ in range(5)]
    maxnews = [3, 3, 4, 4, 5]
    want, ref = _run("jax", params, 4, prompts, maxnews)
    got, eng = _run("port", params, 4, prompts, maxnews)
    assert got == want and not eng._staged
    assert eng.stats["staged_prefills"] == ref.stats["staged_prefills"]


def test_sampled_requests_identical_with_staging(params):
    """Sampled draws key on (seed, position), so staging, which moves
    when a request prefills, changes none of them."""
    rng = np.random.default_rng(33)
    prompts = [rng.integers(0, 128, 6) for _ in range(5)]
    maxnews = [6, 5, 7, 4, 6]
    sampling = dict(temperature=0.9, top_k=8)
    base, _ = _run("port", params, 0, prompts, maxnews, sampling=sampling)
    staged, eng = _run("port", params, 5, prompts, maxnews,
                       sampling=sampling)
    assert staged == base and eng.stats.get("staged_prefills", 0) > 0


def test_eos_retirement_with_staging(params):
    rng = np.random.default_rng(34)
    prompts = [rng.integers(0, 128, 4) for _ in range(4)]
    full, _ = _run("jax", params, 0, prompts, [10] * 4, slots=1)
    eos = full[0][2]
    want, ref = _run("jax", params, 4, prompts, [10] * 4, slots=1, eos=eos)
    got, eng = _run("port", params, 4, prompts, [10] * 4, slots=1, eos=eos)
    assert got == want
    assert eng.stats["staged_prefills"] == ref.stats["staged_prefills"]


def test_cancel_all_fails_staged_requests(params):
    rng = np.random.default_rng(35)
    eng = _make("port", params, max_slots=1, prefill_ahead=4)
    reqs = [eng.submit(rng.integers(0, 128, 4), 8) for _ in range(4)]
    eng.step()                      # admit one, stage the rest
    assert eng._staged
    cancelled = eng.cancel_all()
    assert set(map(id, cancelled)) == set(map(id, reqs))
    assert all(r.done for r in reqs) and not eng._staged


def test_prefix_requests_not_staged_and_fifo_holds(params):
    rng = np.random.default_rng(36)
    pre = rng.integers(0, 128, 6)
    plain = [rng.integers(0, 128, 4) for _ in range(2)]
    out = {}
    for package in ("jax", "port"):
        eng = _make(package, params, max_slots=1, prefill_ahead=4)
        reqs = [eng.submit(plain[0], 4), eng.submit(pre, 4, prefix_key="sys"),
                eng.submit(plain[1], 4)]
        for _ in range(200):
            if all(r.done for r in reqs):
                break
            eng.step()
        out[package] = [eng.result(r) for r in reqs]
        stamps = [r.first_token_at for r in reqs]
        assert stamps == sorted(stamps)
    assert out["port"] == out["jax"]


def test_mixed_bucket_fifo_order_preserved(params):
    """Staging stops at a pad-bucket change, so a later-bucket prompt is
    never admitted before an earlier one (first tokens in submission
    order with one slot)."""
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, 128, n) for n in (5, 20, 5, 20)]
    out = {}
    for package in ("jax", "port"):
        eng = _make(package, params, max_slots=1, prefill_ahead=8)
        reqs = [eng.submit(p, 4) for p in prompts]
        for _ in range(400):
            if all(r.done for r in reqs):
                break
            eng.step()
        stamps = [r.first_token_at for r in reqs]
        assert stamps == sorted(stamps)
        out[package] = [eng.result(r) for r in reqs]
    assert out["port"] == out["jax"]


def test_budget_charges_padded_rows(params):
    """A staged unit holds its power-of-two padded rows until it drains:
    5 same-bucket prompts under prefill_ahead=5 stage 4 (a fifth would
    repad to 8), in both packages."""
    rng = np.random.default_rng(38)
    prompts = [rng.integers(0, 128, 5) for _ in range(6)]
    staged = {}
    for package in ("jax", "port"):
        eng = _make(package, params, max_slots=1, prefill_ahead=5)
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.step()          # admit the 1st; stage from the other 5
        staged[package] = [len(u[0]) for u in eng._staged]
        for _ in range(400):
            if all(r.done for r in reqs):
                break
            eng.step()
        staged[package + " tokens"] = [eng.result(r) for r in reqs]
    assert staged["port"] == staged["jax"] == [4]
    assert staged["port tokens"] == staged["jax tokens"]
    assert [ContinuousDecoder._padded_rows(n) for n in (1, 2, 3, 4, 5)] == \
        [RefDecoder._padded_rows(n) for n in (1, 2, 3, 4, 5)] == \
        [1, 2, 4, 4, 8]


def test_negative_budget_rejected(params):
    with pytest.raises(ValueError, match="prefill_ahead"):
        _make("port", params, max_slots=1, prefill_ahead=-1)


def test_failed_staged_prefill_requeues_at_the_front(params):
    """A staged prefill that raises puts its requests back at the head of
    the queue, order intact, so ``cancel_all`` reaches them."""
    rng = np.random.default_rng(39)
    eng = _make("port", params, max_slots=1, prefill_ahead=4)
    reqs = [eng.submit(rng.integers(0, 128, 4), 6) for _ in range(3)]
    real, calls = eng._prefill_group, {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:           # the staging call
            raise RuntimeError("device fell over")
        return real(*a, **kw)

    eng._prefill_group = flaky
    with pytest.raises(RuntimeError, match="fell over"):
        eng.step()
    assert [r.rid for r in eng._waiting] == [reqs[1].rid, reqs[2].rid]
    assert not eng._staged
    cancelled = eng.cancel_all()
    assert all(r.done for r in reqs)
    assert {r.rid for r in cancelled} == {r.rid for r in reqs}


@pytest.mark.parametrize("ahead", [0, 4])
def test_speculative_engine_with_prefill_ahead(params, ahead):
    """The draft's rows stage beside the target's: greedy tokens stay the
    JAX plain engine's with a draft and prefill-ahead together."""
    draft = ref_tf.init_transformer(REF_CFG._replace(layers=1), seed=5)
    d_cfg = CFG._replace(layers=1)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, 128, int(rng.integers(3, 9)))
               for _ in range(5)]
    maxnews = [7, 3, 9, 5, 8]
    want, _ = _run("jax", params, 0, prompts, maxnews, k=2)
    got, eng = _run("port", params, ahead, prompts, maxnews, k=2,
                    draft_params=draft, draft_cfg=d_cfg, gamma=3)
    assert got == want
    assert (eng.stats.get("staged_prefills", 0) > 0) == (ahead > 0)
    assert eng.stats["spec_round_slots"] > 0
