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

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

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


# ---- quantized page pools ----

KV_DTYPES = ["int8", "fp8"]


def _bits(a):
    """Raw bits of a numpy / jax array or a torch tensor (any dtype)."""
    if isinstance(a, torch.Tensor):
        a = a.view({1: torch.uint8, 2: torch.int16,
                    4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _quant_caches(kv_dtype, num_pages, page, seed):
    """The same quantized pools for both packages: the reference's empty
    cache with random codes and scales written by its quantizer."""
    from mmlspark_tpu.ops.kv_quant import kv_store_dtype, quantize_kv
    rng = np.random.default_rng(seed)
    ref_c = ref.init_paged_cache(REF_CFG, num_pages, page, kv_dtype=kv_dtype)
    for c in ref_c:
        for kk in ("k", "v"):
            q, s = quantize_kv(jnp.asarray(rng.normal(0, 1, c[kk].shape),
                                           jnp.float32),
                               kv_store_dtype(kv_dtype))
            c[kk], c[kk + "_scale"] = q, s
    return ref_c, _to_port(ref_c, kv_dtype)


def port_cache_dtype(kv_dtype):
    return torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn


def _to_port(ref_c, kv_dtype):
    """The reference's quantized pools as the port's, bit for bit."""
    return [{kk: torch.from_numpy(_bits(a).copy()).view(
                torch.bfloat16 if kk.endswith("_scale")
                else port_cache_dtype(kv_dtype))
             for kk, a in c.items()} for c in ref_c]


def _same_pools(got, want, skip_trash=True):
    lo = 1 if skip_trash else 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for kk in w:
            assert np.array_equal(_bits(g[kk])[lo:], _bits(w[kk])[lo:]), kk


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quant_init_paged_cache_matches(kv_dtype):
    want = ref.init_paged_cache(REF_CFG, 5, 4, kv_dtype=kv_dtype)
    got = port.init_paged_cache(CFG, 5, 4, device="cpu", kv_dtype=kv_dtype)
    assert got[0]["k"].dtype == port_cache_dtype(kv_dtype)
    assert got[0]["k_scale"].dtype == torch.bfloat16
    assert got[0]["k_scale"].shape == (5, CFG.heads, 4)
    _same_pools(got, want, skip_trash=False)     # code zeros, scale ones
    assert set(port.init_paged_cache(CFG, 5, 4, device="cpu")[0]) == {"k",
                                                                       "v"}


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quant_paged_scatter_rows_bitwise(kv_dtype):
    rng = np.random.default_rng(12)
    page, B, L = 4, 2, 10
    ref_c, port_c = _quant_caches(kv_dtype, 9, page, 0)
    rows = [{kk: rng.normal(0, 1, (B, 4, L, 16)).astype(np.float32)
             for kk in ("k", "v")} for _ in range(2)]
    bt = np.array([[3, 1, 5, 0], [2, 7, 0, 0]], np.int32)
    want = ref.paged_scatter_rows(
        ref_c, [{k: jnp.asarray(v) for k, v in c.items()} for c in rows],
        jnp.asarray(bt), page)
    got = port.paged_scatter_rows(
        port_c, [{k: torch.from_numpy(v) for k, v in c.items()} for c in rows],
        torch.from_numpy(bt), page)
    _same_pools(got, want)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quant_paged_writeback_bitwise(kv_dtype):
    rng = np.random.default_rng(13)
    page, B, W, L = 4, 3, 3, 12
    ref_c, port_c = _quant_caches(kv_dtype, 10, page, 1)
    before = [{kk: t.clone() for kk, t in c.items()} for c in port_c]
    new = [{kk: rng.normal(0, 1, (B, 4, L, 16)).astype(np.float32)
            for kk in ("k", "v")} for _ in range(2)]
    bt = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    wpos = np.array([[2, 3, 4], [5, 6, 7], [0, 1, 2]], np.int32)
    active = np.array([True, True, False])
    want = ref._paged_writeback(
        ref_c, [{k: jnp.asarray(v) for k, v in c.items()} for c in new],
        jnp.asarray(bt), jnp.asarray(wpos), page, jnp.asarray(active))
    got = port._paged_writeback(
        port_c, [{k: torch.from_numpy(v) for k, v in c.items()} for c in new],
        torch.from_numpy(bt), torch.from_numpy(wpos), page,
        torch.from_numpy(active))
    _same_pools(got, want)
    for g, b in zip(got, before):
        for kk in b:       # the inactive row's pages (7..9) are untouched
            assert np.array_equal(_bits(g[kk])[7:], _bits(b[kk])[7:])


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quant_paged_gather_matches(kv_dtype):
    ref_c, port_c = _quant_caches(kv_dtype, 7, 4, 2)
    bt = np.array([[3, 1, 5], [2, 6, 0]], np.int32)
    for out_r, out_p in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = ref.paged_gather(ref_c, jnp.asarray(bt), 10, out_dtype=out_r)
        got = port.paged_gather(port_c, torch.from_numpy(bt), 10,
                                out_dtype=out_p)
        for g, w in zip(got, want):
            for kk in ("k", "v"):
                assert np.array_equal(_bits(g[kk]), _bits(w[kk]))


_ref_step_paged = jax.jit(ref.decode_step_paged,
                          static_argnames=("cfg", "page_size", "length",
                                           "impl"))


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quant_decode_step_paged_kernel_vs_gather(kv_dtype):
    """Template ``tests/test_kv_quant.py:284-354``: a quantized cache
    filled by prefill, then one paged step through the kernel wrapper
    and through the gather path gives the same argmax — and the
    reference's quantized kernel step the same argmax too."""
    jp, tp = _params(REF_CFG, CFG)
    rng = np.random.default_rng(14)
    B, L, page, steps = 3, 16, 4, 8
    ids = rng.integers(0, 128, (B, steps)).astype(np.int32)
    _, rows_j = jax.jit(ref.prefill_cache, static_argnums=(3, 4))(
        jp, jnp.asarray(ids), jnp.full((B,), steps, jnp.int32), REF_CFG, L)
    n_pages = L // page
    bt = (1 + np.arange(B)[:, None] * n_pages
          + np.arange(n_pages)).astype(np.int32)
    pages_j = ref.paged_scatter_rows(
        ref.init_paged_cache(REF_CFG, 1 + B * n_pages, page,
                             kv_dtype=kv_dtype), rows_j, jnp.asarray(bt), page)
    tok = rng.integers(0, 128, B).astype(np.int32)
    pos = np.full(B, steps, np.int32)
    want, want_pages = _ref_step_paged(
        jp, jnp.asarray(tok), jnp.asarray(pos), pages_j, jnp.asarray(bt),
        cfg=REF_CFG, page_size=page, length=L, impl="kernel")
    outs = {}
    for impl in ("kernel", "gather"):
        # the port's pools hold the reference's bytes
        outs[impl] = port.decode_step_paged(
            tp, torch.from_numpy(tok), torch.from_numpy(pos),
            _to_port(pages_j, kv_dtype),
            torch.from_numpy(bt), CFG, page_size=page, length=L, impl=impl)
    lk, pk = outs["kernel"]
    lg, pg = outs["gather"]
    np.testing.assert_allclose(lk.numpy(), lg.numpy(), rtol=1e-4, atol=1e-4)
    assert np.array_equal(lk.numpy().argmax(-1), lg.numpy().argmax(-1))
    assert np.array_equal(lk.numpy().argmax(-1), np.asarray(want).argmax(-1))
    # layer 0's writes: codes and scales bitwise between the port's kernel
    # and gather paths (same inputs, one quantizer)
    for kk in pk[0]:
        assert np.array_equal(_bits(pk[0][kk])[1:], _bits(pg[0][kk])[1:])
