"""Port parity: full-sequence generation of ``models/zoo/transformer.py``
(``generate``, ``generate_cached``, ``generate_beam``, ``init_kv_cache``,
``decode_step``, ``decode_window``, ``_sample_logits``).

The same seeded numpy weights and prompts go through the JAX reference and
the port, in f32 on the CPU, at the JAX tests' tiny configs. Tolerances:

* greedy and beam ids exactly the reference's; beam scores within 1e-5 ·
  max|score| + 1e-6;
* decode logits and caches within 1e-5 (summation order only);
* sampled tokens never match the reference's threefry draws (the port
  hashes (row key, position, purpose)), so sampling is held by
  ``generate`` and ``generate_cached`` agreeing token for token, and by a
  chi-square test of a one-step draw against the warped softmax;
* the filters of the reference's ``_sample_logits`` equal
  ``_warp_scaled_rows``'s (JAX and port) exactly, -inf pattern included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref
from mmlspark_tpu_torch.models.zoo import transformer as port
from mmlspark_tpu_torch.serving import continuous

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

_KW = dict(vocab=64, layers=3, d_model=32, heads=4, d_ff=64, max_len=128,
           causal=True)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(position="rope"):
    norm = "rmsnorm" if position == "rope" else "layernorm"
    return (ref.TransformerConfig(dtype=jnp.float32, position=position,
                                  norm=norm, **_KW),
            port.TransformerConfig(dtype=torch.float32, position=position,
                                   norm=norm, **_KW))


@pytest.fixture(scope="module", params=["rope", "learned"])
def model(request):
    rc, pc = _cfgs(request.param)
    return ref.init_transformer(rc, seed=0), rc, pc


def _prompt(B=2, P=6, seed=2, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (B, P)).astype(
        np.int32)


def _eos_that_fires(ids, P):
    """A token of the first row's continuation (so eos stops it early)."""
    return int(np.asarray(ids)[0, P + 2])


# -- greedy ids ---------------------------------------------------------------

@pytest.mark.parametrize("use_eos", [False, True])
def test_greedy_generate_and_cached_equal_reference(model, use_eos):
    p, rc, pc = model
    prompt = _prompt()
    eos = None
    if use_eos:
        eos = _eos_that_fires(ref.generate(p, prompt, rc, max_new_tokens=12),
                              prompt.shape[1])
    want = np.asarray(ref.generate(p, prompt, rc, max_new_tokens=12,
                                   eos_id=eos))
    want_c = np.asarray(ref.generate_cached(p, prompt, rc,
                                            max_new_tokens=12, eos_id=eos))
    got = port.generate(p, prompt, pc, max_new_tokens=12, eos_id=eos,
                        device="cpu")
    got_c = port.generate_cached(p, prompt, pc, max_new_tokens=12,
                                 eos_id=eos, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got.numpy(), got_c.numpy())
    if use_eos:
        row = got.numpy()[0, prompt.shape[1]:]
        first = list(row).index(eos)
        assert (row[first:] == eos).all()


@pytest.mark.parametrize("use_eos", [False, True])
@pytest.mark.parametrize("W", [2, 4])
def test_beam_equals_reference(model, use_eos, W):
    p, rc, pc = model
    prompt = _prompt(B=3, P=5, seed=4)
    eos = None
    if use_eos:
        eos = _eos_that_fires(ref.generate_cached(p, prompt, rc,
                                                  max_new_tokens=8), 5)
    ids_r, s_r = ref.generate_beam(p, prompt, rc, max_new_tokens=8,
                                   num_beams=W, length_penalty=0.8,
                                   eos_id=eos)
    ids_p, s_p = port.generate_beam(p, prompt, pc, max_new_tokens=8,
                                    num_beams=W, length_penalty=0.8,
                                    eos_id=eos, device="cpu")
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
    s_r = np.asarray(s_r)
    assert np.abs(s_p.numpy() - s_r).max() <= 1e-5 * np.abs(s_r).max() + 1e-6


@pytest.mark.parametrize("use_eos", [False, True])
def test_beam_full_vocab_width_equals_reference(model, use_eos):
    """W = V: the first step keeps every token (and, with eos, banks it
    and loses one live slot); the -inf pools tie everywhere, so the tie
    rule decides which rows survive."""
    p, rc, pc = model
    prompt = _prompt(B=1, P=4, seed=5)
    eos = 3 if use_eos else None
    ids_r, s_r = ref.generate_beam(p, prompt, rc, max_new_tokens=3,
                                   num_beams=rc.vocab, eos_id=eos)
    ids_p, s_p = port.generate_beam(p, prompt, pc, max_new_tokens=3,
                                    num_beams=pc.vocab, eos_id=eos,
                                    device="cpu")
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), **TOL)


def test_beam_of_one_is_greedy(model):
    p, rc, pc = model
    prompt = _prompt(B=2, P=5, seed=6)
    ids, _ = port.generate_beam(p, prompt, pc, max_new_tokens=10,
                                num_beams=1, device="cpu")
    greedy = port.generate_cached(p, prompt, pc, max_new_tokens=10,
                                  device="cpu")
    np.testing.assert_array_equal(ids.numpy(), greedy.numpy())


@pytest.mark.parametrize("position", ["rope", "learned"])
def test_flash_generate_equals_dense(position):
    """``use_flash`` routes generate's forwards through K7's entry (its
    plain version on the CPU; head dim 32, a size K7 takes); greedy and
    sampled ids equal the dense path's."""
    rc, pc = _cfgs(position)
    pc = pc._replace(d_model=64, heads=2)
    p = port.init_transformer(pc, seed=1)
    prompt = _prompt(B=2, P=5, seed=7)
    for kw in (dict(), dict(temperature=1.0, top_k=6, seed=4)):
        dense = port.generate(p, prompt, pc, max_new_tokens=8,
                              device="cpu", **kw)
        flash = port.generate(p, prompt, pc._replace(use_flash=True),
                              max_new_tokens=8, device="cpu", **kw)
        np.testing.assert_array_equal(flash.numpy(), dense.numpy())


# -- the cached decode primitives -----------------------------------------------

def test_decode_step_window_and_cache_match_reference(model):
    p, rc, pc = model
    rng = np.random.default_rng(0)
    B, P, W, L = 2, 5, 4, 32
    prompt = rng.integers(0, 64, (B, P)).astype(np.int32)
    win = rng.integers(0, 64, (B, W)).astype(np.int32)
    _, rcache = ref.prefill_cache(p, jnp.asarray(prompt),
                                  jnp.full((B,), P, jnp.int32), rc, L)
    tp = port.params_from_numpy(p, pc, device="cpu")
    _, pcache = port.prefill_cache(tp, torch.from_numpy(prompt).long(),
                                   torch.full((B,), P), pc, L)
    wl_r, wc_r = ref.decode_window(p, jnp.asarray(win), P, rcache, rc)
    wl_p, wc_p = port.decode_window(tp, torch.from_numpy(win).long(), P,
                                    pcache, pc)
    np.testing.assert_allclose(wl_p.numpy(), np.asarray(wl_r), **TOL)
    for a, b in zip(wc_p, wc_r):
        np.testing.assert_allclose(a["k"].numpy(), np.asarray(b["k"]), **TOL)
    cache = pcache
    for i in range(W):
        lg, cache = port.decode_step(tp, torch.from_numpy(win[:, i]).long(),
                                     P + i, cache, pc)
        np.testing.assert_allclose(lg.numpy(), wl_p[:, i].numpy(), **TOL)
    empty = port.init_kv_cache(pc, 3, 7, device="cpu")
    want = ref.init_kv_cache(rc, 3, 7)
    assert len(empty) == len(want)
    assert tuple(empty[0]["k"].shape) == want[0]["k"].shape
    assert empty[0]["v"].dtype == torch.float32 and not empty[0]["k"].any()


# -- sampling ---------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.6), (1.1, 8, 0.8),
    (0.9, 1000, 1.0)])
def test_sampled_generate_equals_cached(model, temperature, top_k, top_p):
    p, rc, pc = model
    prompt = _prompt(B=3, P=5, seed=8)
    kw = dict(max_new_tokens=10, temperature=temperature, top_k=top_k,
              top_p=top_p, seed=21, device="cpu")
    a = port.generate(p, prompt, pc, **kw)
    b = port.generate_cached(p, prompt, pc, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a.numpy()[:, :5], prompt)
    # keyed by position: a shorter run is a prefix of a longer one, and a
    # new seed draws anew
    c = port.generate_cached(p, prompt, pc, **dict(kw, max_new_tokens=4))
    np.testing.assert_array_equal(c.numpy(), b.numpy()[:, :9])
    d = port.generate_cached(p, prompt, pc, **dict(kw, seed=22))
    if temperature > 0 and top_k != 1:
        assert not np.array_equal(d.numpy(), b.numpy())


def test_sampled_rows_draw_independently(model):
    p, rc, pc = model
    prompt = np.repeat(_prompt(B=1, P=4, seed=9), 32, axis=0)
    out = port.generate_cached(p, prompt, pc, max_new_tokens=4,
                               temperature=1.5, seed=3, device="cpu")
    assert len({tuple(r) for r in out.numpy()[:, 4:]}) > 8
    eos_run = port.generate(p, prompt, pc, max_new_tokens=4,
                            temperature=1.5, seed=3, eos_id=7,
                            device="cpu").numpy()
    for row in eos_run[:, 4:]:
        if 7 in row:
            assert (row[list(row).index(7):] == 7).all()


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (6, 1.0), (0, 0.7)])
def test_one_step_draw_matches_warped_softmax(model, top_k, top_p):
    """N identical rows, one sampled token each: a chi-square test of the
    counts against softmax(_warp_scaled_rows(logits / T)), bins with
    expectation < 5 pooled; the statistic stays under the 0.001 quantile
    of its chi-square law. Nothing outside the kept set is drawn."""
    from scipy.stats import chi2
    p, rc, pc = model
    N, T = 4000, 1.2
    prompt = np.repeat(_prompt(B=1, P=5, seed=10), N, axis=0)
    out = port.generate(p, prompt, pc, max_new_tokens=1, temperature=T,
                        top_k=top_k, top_p=top_p, seed=5, device="cpu")
    toks = out.numpy()[:, -1]
    tp = port.params_from_numpy(p, pc, device="cpu")
    hidden = port.transformer_apply(tp, torch.from_numpy(prompt[:1]).long(),
                                    pc)
    logits = hidden[:, -1].float() @ tp["lm_head"]["w"]
    warped = port._warp_scaled_rows(logits / T,
                                    torch.tensor([top_k]),
                                    torch.tensor([top_p]))
    probs = torch.softmax(warped.double(), dim=-1)[0].numpy()
    counts = np.bincount(toks, minlength=pc.vocab)
    assert counts[probs == 0].sum() == 0
    expect = probs * N
    big = expect >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expect[big], expect[~big].sum())
    keep = exp > 0
    stat = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    dof = int(keep.sum()) - 1
    assert stat < chi2.ppf(0.999, dof), (stat, dof)


@pytest.mark.parametrize("top_k,top_p", [
    (0, 1.0), (5, 1.0), (0, 0.6), (5, 0.6), (1, 0.3), (200, 1.0),
    (3, 0.0)])
def test_sample_logits_filters_equal_warp_scaled_rows(top_k, top_p,
                                                      monkeypatch):
    """The reference's ``_sample_logits`` (its own inline filters) keeps
    exactly the set ``_warp_scaled_rows`` keeps, with the same values:
    JAX against JAX and the port's ``_warp_scaled_rows`` against both."""
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 2, (6, 40)).astype(np.float32)
    logits[0, :5] = 1.25                 # ties at the k-th value
    T = 0.8
    monkeypatch.setattr(ref.jax.random, "categorical",
                        lambda key, lg, axis=-1: lg)
    filtered = np.asarray(ref._sample_logits(
        jnp.asarray(logits), jax.random.PRNGKey(0), T, top_k, top_p))
    n = logits.shape[0]
    scaled = jnp.asarray(logits) / T
    want = np.asarray(ref._warp_scaled_rows(
        scaled, jnp.full((n,), top_k, jnp.int32),
        jnp.full((n,), top_p, jnp.float32)))
    got = port._warp_scaled_rows(torch.from_numpy(logits) / T,
                                 torch.full((n,), top_k),
                                 torch.full((n,), top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(filtered), np.isinf(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(filtered[fin], want[fin], rtol=1e-6)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def test_port_sample_logits_is_gumbel_over_the_warp():
    rng = np.random.default_rng(12)
    logits = torch.from_numpy(rng.normal(0, 2, (5, 30)).astype(np.float32))
    u = port._draws(port._row_seeds(9, 5, "cpu"), 17, 0, 30)
    for k, p in [(0, 1.0), (4, 1.0), (0, 0.5), (4, 0.5)]:
        got = port._sample_logits(logits, u, 0.9, k, p)
        want = port._gumbel_argmax(port._warp_scaled_rows(
            logits / 0.9, torch.full((5,), k), torch.full((5,), p)), u)
        np.testing.assert_array_equal(got.numpy(), want.long().numpy())
    np.testing.assert_array_equal(
        port._sample_logits(logits, None, 0.0, 3, 0.5).numpy(),
        logits.argmax(-1).numpy())


def test_engine_draws_come_from_the_model_layer():
    """The engine's sampler is the model layer's hash, moved, not copied;
    the engine's own tests pin its draws byte for byte."""
    assert continuous._uniforms is port._uniforms
    assert continuous._gumbel_argmax is port._gumbel_argmax
    u = port._uniforms(torch.tensor([5, -3]), torch.tensor([[7, 8], [9, 9]]),
                       2, 3)
    assert u.shape == (2, 2, 3) and bool(((u > 0) & (u < 1)).all())


# -- validation --------------------------------------------------------------

def test_every_value_error_of_the_reference(model):
    p, rc, pc = model
    prompt = _prompt()
    bidir = pc._replace(causal=False)
    rbidir = rc._replace(causal=False)
    for fn, rfn in [(port.generate, ref.generate),
                    (port.generate_cached, ref.generate_cached),
                    (port.generate_beam, ref.generate_beam)]:
        with pytest.raises(ValueError, match="causal"):
            rfn(p, prompt, rbidir)
        with pytest.raises(ValueError, match="causal"):
            fn(p, prompt, bidir, device="cpu")
        with pytest.raises(ValueError, match="prompt token"):
            rfn(p, prompt[:, :0], rc)
        with pytest.raises(ValueError, match="prompt token"):
            fn(p, prompt[:, :0], pc, device="cpu")
        if pc.position == "learned":
            with pytest.raises(ValueError, match="exceeds max_len"):
                rfn(p, prompt, rc, max_new_tokens=200)
            with pytest.raises(ValueError, match="exceeds max_len"):
                fn(p, prompt, pc, max_new_tokens=200, device="cpu")
    for beams, match in [(0, "num_beams must be"), (65, "exceeds vocab")]:
        with pytest.raises(ValueError, match=match):
            ref.generate_beam(p, prompt, rc, num_beams=beams)
        with pytest.raises(ValueError, match=match):
            port.generate_beam(p, prompt, pc, num_beams=beams, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, pc = _cfgs()
    p = port.init_transformer(pc, seed=0)
    for fn in (port.generate, port.generate_cached, port.generate_beam):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(p, _prompt(), pc, max_new_tokens=2)
