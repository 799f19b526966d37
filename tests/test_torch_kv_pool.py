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
