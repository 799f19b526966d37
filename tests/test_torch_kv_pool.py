"""Port parity: the page pool (``serving/kv_pool.py``).

The same alloc / free / prefix / compact sequence runs on the JAX
reference pool and on the port's pool; the host bookkeeping must agree
exactly: the same page ids, refcounts, free lists and ``compact()``
permutation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.zoo.transformer import TransformerConfig as RefCfg
from mmlspark_tpu.serving import kv_pool as ref
from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
from mmlspark_tpu_torch.serving import kv_pool as port

REF_CFG = RefCfg(vocab=128, layers=2, d_model=64, heads=4, d_ff=128,
                 max_len=64, causal=True, norm="rmsnorm", position="rope",
                 dtype=jnp.float32)
CFG = TransformerConfig(vocab=128, layers=2, d_model=64, heads=4, d_ff=128,
                        max_len=64, causal=True, norm="rmsnorm",
                        position="rope", dtype=torch.float32)


def _pools(num_pages=24, page_size=4):
    return (ref.PagedKVPool(REF_CFG, num_pages=num_pages,
                            page_size=page_size, residency=False),
            port.PagedKVPool(CFG, num_pages=num_pages, page_size=page_size,
                             device="cpu"))


def _script(pool):
    """One alloc/free/prefix/compact sequence; returns everything the
    engine would read from the pool along the way."""
    seen = []
    a = pool.alloc(3)
    b = pool.alloc(4)
    c = pool.alloc(2)
    h = pool_hash = port.prefix_hash([5, 6, 7, 8, 9])
    pool.register_prefix(h, b[:2], 5)
    pool.register_prefix(h, b[:2], 5)          # a second key, same tokens
    pages, plen = pool.acquire_prefix(pool_hash, 1)
    seen.append((list(a), list(b), list(c), list(pages), plen))
    pool.free(a)
    pool.free(b)
    d = pool.alloc(5)
    seen.append(list(d))
    pool.free(c)
    pool.free(pages[:1])
    seen.append((pool.fragmentation(), pool.pages_in_use, pool.high_water))
    remap = pool.compact()
    seen.append(None if remap is None else remap.tolist())
    seen.append((sorted(pool._free), pool._refs.tolist(),
                 dict(pool._prefixes), pool.fragmentation()))
    pool.release_prefix(h)
    seen.append(pool.lookup_prefix(h))
    pool.release_prefix(h)
    seen.append((pool.lookup_prefix(h), pool.pages_in_use))
    e = pool.alloc(6)
    seen.append((list(e), pool.compact()))
    return seen


def test_same_sequence_same_bookkeeping():
    r, p = _pools()
    assert _script(r) == _script(p)
    assert r.stats["prefix_share_hits"] == p.stats["prefix_share_hits"]
    assert r.stats["defrag_moves"] == p.stats["defrag_moves"]


def test_prefix_hash_matches_reference():
    toks = np.arange(37, dtype=np.int32)
    assert port.prefix_hash(toks) == ref.prefix_hash(toks)


@pytest.mark.parametrize("n", [0, 1, 7, 23])
def test_exhaustion_and_block_counts_match(n):
    r, p = _pools()
    outs = []
    for pool in (r, p):
        pool.alloc(n)
        try:
            pool.alloc(24 - n)          # one more than is left
            outs.append("ok")
        except (ref.PoolExhausted, port.PoolExhausted):
            outs.append(("exhausted", pool.pages_in_use,
                         pool.stats["alloc_failures"]))
        outs.append(pool.pages_per_slot(4 * n + 1))
    assert outs[:2] == outs[2:]


def test_double_free_and_bad_page_raise():
    _, p = _pools()
    a = p.alloc(2)
    p.free(a)
    with pytest.raises(ValueError):
        p.free(a)
    with pytest.raises(ValueError):
        p.free([0])
    with pytest.raises(ValueError):
        p.incref([5])


def test_buffers_are_zeroed_and_reset():
    _, p = _pools(num_pages=6, page_size=4)
    assert len(p.buffers) == CFG.layers
    assert p.buffers[0]["k"].shape == (6, 4, 4, 16)
    assert all(float(c[kk].abs().sum()) == 0.0
               for c in p.buffers for kk in ("k", "v"))
    p.buffers[0]["k"].fill_(1.0)
    p.alloc(3)
    p.reset()
    assert p.pages_in_use == 0 and float(p.buffers[0]["k"].sum()) == 0.0
    assert p.device_bytes() == 2 * 2 * 6 * 4 * 4 * 16 * 4
    assert p.kernel_aligned_page_size(5) == 5     # no Hopper page rule


def test_stats_keys_kept():
    _, p = _pools()
    for key in ("attn_ticks_kernel", "attn_ticks_gather", "gather_bytes"):
        assert p.stats[key] == 0
    p.note_attn_tick("gather", calls=2, gather_bytes=64)
    p.note_attn_tick("kernel", calls=3)
    assert (p.stats["attn_ticks_gather"], p.stats["attn_ticks_kernel"],
            p.stats["gather_bytes"]) == (2, 3, 64)


# ---- quantized pools ----

@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quant_pool_bytes_match_reference(kv_dtype):
    cfg_r = REF_CFG._replace(d_model=256, dtype=jnp.bfloat16)
    cfg_p = CFG._replace(d_model=256, dtype=torch.bfloat16)  # hd 64
    r = ref.PagedKVPool(cfg_r, num_pages=9, page_size=4, kv_dtype=kv_dtype,
                        residency=False)
    p = port.PagedKVPool(cfg_p, num_pages=9, page_size=4, kv_dtype=kv_dtype,
                         device="cpu")
    assert p.kv_dtype == r.kv_dtype == kv_dtype
    assert p.device_bytes() == r.device_bytes()
    assert p.bytes_per_position() == r.bytes_per_position()
    # what the buffers hold, and 66/128 of the bf16 layout per position
    assert p.device_bytes() == sum(t.numel() * t.element_size()
                                   for c in p.buffers for t in c.values())
    bf16 = port.PagedKVPool(cfg_p, num_pages=9, page_size=4, device="cpu")
    assert p.bytes_per_position() * 128 == bf16.bytes_per_position() * 66
    assert bf16.bytes_per_position() == ref.PagedKVPool(
        cfg_r, num_pages=9, page_size=4, residency=False).bytes_per_position()
    # the engine's pool makes its scale pools as zeros, like the reference's
    assert set(p.buffers[0]) == {"k", "v", "k_scale", "v_scale"}
    for c_p, c_r in zip(p.buffers, r.buffers):
        for kk in c_r:
            assert np.array_equal(c_p[kk].float().numpy(),
                                  np.asarray(c_r[kk], np.float32))


def test_quant_pool_reset_rebuilds_scales():
    p = port.PagedKVPool(CFG, num_pages=8, page_size=4, kv_dtype="int8",
                         device="cpu")
    p.buffers[0]["k_scale"].fill_(3.0)
    p.buffers[1]["v"].fill_(7)
    p.alloc(3)
    p.reset()
    assert p.pages_in_use == 0
    assert set(p.buffers[0]) == {"k", "v", "k_scale", "v_scale"}
    assert p.buffers[0]["k"].dtype == torch.int8
    assert p.buffers[0]["k_scale"].dtype == torch.bfloat16
    assert all(float(t.float().abs().sum()) == 0.0
               for c in p.buffers for t in c.values())


def test_quant_pool_error_stats():
    p = port.PagedKVPool(CFG, num_pages=4, page_size=4, kv_dtype="fp8",
                         device="cpu")
    r = ref.PagedKVPool(REF_CFG, num_pages=4, page_size=4, kv_dtype="fp8",
                        residency=False)
    for pool in (p, r):
        for e in (0.01, 0.03, 0.02):
            pool.note_quant_error(e)
    keys = ("quant_error_probes", "quant_error_last", "quant_error_sum",
            "quant_error_max")
    assert [p.stats[k] for k in keys] == [r.stats[k] for k in keys]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_compact_remaps_scales_with_pages(kv_dtype):
    """The engine's defrag gathers every buffer of a layer through the
    ``compact()`` permutation: a page's codes and its scales land
    together."""
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    eng = ContinuousDecoder(init_transformer(CFG), CFG, device="cpu",
                            max_slots=2, max_len=16, page_size=4,
                            kv_dtype=kv_dtype, defrag_threshold=1)
    pool = eng._kv
    for c in pool.buffers:
        for kk, t in c.items():
            # mark every page with its own id (codes through byte views)
            ids = torch.arange(pool.num_pages, dtype=torch.float32)
            if t.dtype == torch.bfloat16:
                t.copy_(ids[:, None, None].expand_as(t))
            else:
                t.view(torch.uint8).copy_(
                    ids.to(torch.uint8)[:, None, None, None].expand_as(t))
    a = pool.alloc(3)
    b = pool.alloc(3)
    pool.free(a)
    eng._maybe_compact()
    assert pool.stats["defrag_moves"] == 3
    for c in pool.buffers:
        for kk, t in c.items():
            v = t.float() if t.dtype == torch.bfloat16 else \
                t.view(torch.uint8).float()
            for new, old in zip((1, 2, 3), b):
                assert bool((v[new] == old).all()), (kk, new, old)
