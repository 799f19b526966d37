"""Port parity: the decoder subset of ``models/zoo/transformer.py``.

The same seeded weights and inputs (numpy) go through the JAX reference
and ``mmlspark_tpu_torch``'s port, in f32 on the CPU. Where only the
order of summation differs the tolerance is 1e-5; page writes and the
seeded weights are compared bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref
from mmlspark_tpu_torch.models.zoo import transformer as port

REF_CFG = ref.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                                d_ff=128, max_len=96, causal=True,
                                norm="rmsnorm", position="rope",
                                dtype=jnp.float32)
CFG = port.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                             d_ff=128, max_len=96, causal=True,
                             norm="rmsnorm", position="rope",
                             dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(kind):
    if kind == "rope":
        return REF_CFG, CFG
    return (REF_CFG._replace(position="learned", norm="layernorm"),
            CFG._replace(position="learned", norm="layernorm"))


def _params(ref_cfg, cfg):
    p = ref.init_transformer(ref_cfg, seed=0)
    return (jax.tree.map(jnp.asarray, p),
            port.params_from_numpy(p, cfg, device="cpu"))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("kind", ["rope", "learned"])
def test_init_transformer_bitwise(kind):
    ref_cfg, cfg = _cfgs(kind)
    a = ref.init_transformer(ref_cfg, seed=3)
    b = port.init_transformer(cfg, seed=3)
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_params_from_numpy_round_trips():
    p = port.init_transformer(CFG, seed=1)
    t = port.params_from_numpy(p, CFG, device="cpu")
    for x, y in zip(_leaves(p), _leaves(t)):
        assert y.dtype == torch.float32
        assert np.array_equal(x, y.numpy())
    bf = port.params_from_numpy(p, CFG._replace(dtype=torch.bfloat16),
                                device="cpu")
    # matrices cast once to the model dtype; norms and the head stay f32
    assert bf["layers"][0]["qkv"]["w"].dtype == torch.bfloat16
    assert bf["embed"]["tok"].dtype == torch.bfloat16
    assert bf["layers"][0]["ln1"]["scale"].dtype == torch.float32
    assert bf["lm_head"]["w"].dtype == torch.float32


def test_params_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        port.params_from_numpy(port.init_transformer(CFG), CFG)


def test_gelu_is_the_tanh_form():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    got = port.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), rtol=1e-6,
                               atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf).max() > 1e-4


@pytest.mark.parametrize("kind", ["rope", "learned"])
def test_prefill_cache_matches(kind):
    ref_cfg, cfg = _cfgs(kind)
    jp, tp = _params(ref_cfg, cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (3, 16)).astype(np.int32)
    length = np.array([16, 5, 9], np.int32)
    want_l, want_c = ref.prefill_cache(jp, jnp.asarray(ids),
                                       jnp.asarray(length), ref_cfg, 32)
    got_l, got_c = port.prefill_cache(tp, torch.from_numpy(ids),
                                      torch.from_numpy(length), cfg, 32)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    for g, w in zip(got_c, want_c):
        for kk in ("k", "v"):
            np.testing.assert_allclose(g[kk].numpy(), np.asarray(w[kk]),
                                       **TOL)


def _warm_cache(jp, tp, B, L, steps, rng):
    cache_j = ref.init_kv_cache(REF_CFG, B, L)
    toks = rng.integers(0, 128, (steps, B)).astype(np.int32)
    for t in range(steps):
        _, cache_j = ref.decode_step_ragged(
            jp, jnp.asarray(toks[t]), jnp.full((B,), t, jnp.int32),
            cache_j, REF_CFG)
    cache_t = [{kk: torch.from_numpy(np.array(c[kk])) for kk in ("k", "v")}
               for c in cache_j]
    return cache_j, cache_t


def test_decode_step_ragged_matches():
    jp, tp = _params(REF_CFG, CFG)
    rng = np.random.default_rng(1)
    B, L = 3, 16
    cache_j, cache_t = _warm_cache(jp, tp, B, L, 6, rng)
    tok = rng.integers(0, 128, B).astype(np.int32)
    pos = np.array([6, 3, 0], np.int32)
    active = np.array([True, False, True])
    want_l, want_c = ref.decode_step_ragged(
        jp, jnp.asarray(tok), jnp.asarray(pos), cache_j, REF_CFG,
        jnp.asarray(active))
    got_l, got_c = port.decode_step_ragged(
        tp, torch.from_numpy(tok), torch.from_numpy(pos), cache_t, CFG,
        torch.from_numpy(active))
    np.testing.assert_allclose(got_l.numpy()[active],
                               np.asarray(want_l)[active], **TOL)
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g["k"].numpy(), np.asarray(w["k"]), **TOL)


@pytest.mark.parametrize("W", [1, 4, 16])
def test_decode_window_ragged_matches(W):
    jp, tp = _params(REF_CFG, CFG)
    rng = np.random.default_rng(W)
    B, L = 2, 40
    cache_j, cache_t = _warm_cache(jp, tp, B, L, 8, rng)
    toks = rng.integers(0, 128, (B, W)).astype(np.int32)
    pos = np.array([8, 2], np.int32)
    want_l, want_c = ref.decode_window_ragged(
        jp, jnp.asarray(toks), jnp.asarray(pos), cache_j, REF_CFG)
    got_l, got_c = port.decode_window_ragged(
        tp, torch.from_numpy(toks), torch.from_numpy(pos), cache_t, CFG)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g["v"].numpy(), np.asarray(w["v"]), **TOL)


def _pools(rng, n_pages, page):
    shape = (n_pages, 4, page, 16)
    return [{kk: rng.normal(0, 1, shape).astype(np.float32)
             for kk in ("k", "v")} for _ in range(2)]


def test_paged_scatter_rows_bitwise():
    rng = np.random.default_rng(2)
    page, B, L = 4, 2, 10
    pools = _pools(rng, 9, page)
    rows = [{kk: rng.normal(0, 1, (B, 4, L, 16)).astype(np.float32)
             for kk in ("k", "v")} for _ in range(2)]
    bt = np.array([[3, 1, 5, 0], [2, 7, 0, 0]], np.int32)
    want = ref.paged_scatter_rows(
        [{k: jnp.asarray(v) for k, v in c.items()} for c in pools],
        [{k: jnp.asarray(v) for k, v in c.items()} for c in rows],
        jnp.asarray(bt), page)
    got = port.paged_scatter_rows(
        [{k: torch.from_numpy(v.copy()) for k, v in c.items()} for c in pools],
        [{k: torch.from_numpy(v) for k, v in c.items()} for c in rows],
        torch.from_numpy(bt), page)
    for g, w in zip(got, want):
        for kk in ("k", "v"):
            assert np.array_equal(g[kk].numpy()[1:], np.asarray(w[kk])[1:])


def test_paged_writeback_bitwise():
    rng = np.random.default_rng(3)
    page, B, W, L = 4, 3, 3, 12
    pools = _pools(rng, 10, page)
    new = [{kk: rng.normal(0, 1, (B, 4, L, 16)).astype(np.float32)
            for kk in ("k", "v")} for _ in range(2)]
    bt = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    wpos = np.array([[2, 3, 4], [5, 6, 7], [0, 1, 2]], np.int32)
    active = np.array([True, True, False])
    want = ref._paged_writeback(
        [{k: jnp.asarray(v) for k, v in c.items()} for c in pools],
        [{k: jnp.asarray(v) for k, v in c.items()} for c in new],
        jnp.asarray(bt), jnp.asarray(wpos), page, jnp.asarray(active))
    got = port._paged_writeback(
        [{k: torch.from_numpy(v.copy()) for k, v in c.items()} for c in pools],
        [{k: torch.from_numpy(v) for k, v in c.items()} for c in new],
        torch.from_numpy(bt), torch.from_numpy(wpos), page,
        torch.from_numpy(active))
    for g, w, p0 in zip(got, want, pools):
        for kk in ("k", "v"):
            assert np.array_equal(g[kk].numpy()[1:], np.asarray(w[kk])[1:])
            # the inactive row's pages (7..9) are untouched
            assert np.array_equal(g[kk].numpy()[7:], p0[kk][7:])


def test_paged_gather_matches():
    rng = np.random.default_rng(4)
    pools = _pools(rng, 7, 4)
    bt = np.array([[3, 1, 5], [2, 6, 0]], np.int32)
    want = ref.paged_gather(
        [{k: jnp.asarray(v) for k, v in c.items()} for c in pools],
        jnp.asarray(bt), 10)
    got = port.paged_gather(
        [{k: torch.from_numpy(v) for k, v in c.items()} for c in pools],
        torch.from_numpy(bt), 10)
    for g, w in zip(got, want):
        assert np.array_equal(g["k"].numpy(), np.asarray(w["k"]))
