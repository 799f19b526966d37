"""Port parity: serving on a ("dp", "tp") mesh — slots over dp with a
replicated page pool, speculation on the mesh, ``GenerationEngine(mesh=)``
over HTTP, and session export / adopt of a head-sharded pool.

The port runs one process per rank: a dp2 x tp2 world of four gloo CPU
ranks (``tests/test_torch_mesh_ranks.py``'s ``dp_world``, which imports
no JAX), each computing the device rows of its two of four slots for its
two of four heads. Held against the JAX engine on a dp2 x tp2 mesh of
the conftest's host devices (Pallas interpret mode) and against
``generate_cached``, at ``tests/test_mesh_parity.py``'s ``CFG`` and
``D_CFG``:

* f32 greedy tokens through the kernel and the gather paths equal the
  JAX mesh engine's and ``generate_cached``'s on every rank; the two dp
  replicas of each tp rank hold bitwise-equal pools off trash page 0;
* int8 pages: tokens equal the JAX int8 dp2 x tp2 engine's over the JAX
  tests' 4-token horizon, replicas' codes and scales bitwise equal;
* a draft at gamma 4: tokens equal; a mid-stream ``compact()`` keeps the
  survivor's tokens;
* the mounts with rows over dp (window and read-only) against the JAX
  mounts on the same mesh: ctx within 1e-5 (one bf16 ulp with bf16
  queries), pools bitwise off page 0;
* a session exported from the tp = 2 pool: its blob's pages are the
  ranks' shards concatenated by head, bitwise; a single-device decoder
  and a second meshed engine adopt it warm and continue with identical
  f32 tokens, nothing re-prefilled;
* ``GenerationEngine(mesh=)``: rank 0 answers every HTTP request with
  the in-process decoder's tokens, a token id past int32 with 400, and
  a request after that one with the decoder's tokens again; a follower
  whose tick fails ends serving on every rank;
* the dp exchange (``gather_rows``) keeps -0.0 and NaN payloads.
"""

import base64

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu.ops import paged_attention as ref_pa
from mmlspark_tpu.serving.continuous import ContinuousDecoder as RefDecoder
from mmlspark_tpu_torch.parallel.launch import run_ranks
from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder

import test_torch_mesh_ranks as ranks
from test_torch_paged_mesh import (ACTIVE, BF16, F32, LENGTHS, MOUNT_CASES,
                                   POS, _case, _from_wire, _np_bits, _wire)

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

REF_CFG = ref_tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                                   d_ff=128, max_len=96, causal=True,
                                   norm="rmsnorm", position="rope",
                                   dtype=jnp.float32)
REF_D_CFG = REF_CFG._replace(layers=1, d_model=32, heads=2, d_ff=64)
CFG = ranks.CFG
HORIZON = 4
DP, TP = 2, 2


def _prompts(n=5, seed=3):
    """``tests/test_mesh_parity.py``'s prompts (lengths 4, 7, ..., 16)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab, 4 + 3 * i).astype(np.int32)
            for i in range(n)]


def _survivor():
    rng = np.random.default_rng(7)
    return (rng.integers(1, CFG.vocab, 5).astype(np.int32),
            rng.integers(1, CFG.vocab, 9).astype(np.int32))


def _payloads():
    return [{"tokens": [int(t) for t in p], "max_new": 10}
            for p in _prompts()]


def _generate(params, prompt, n):
    ids = ref_tf.generate_cached(params, prompt[None, :], REF_CFG,
                                 max_new_tokens=n)
    return [int(t) for t in np.asarray(ids)[0, len(prompt):]]


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:DP * TP]).reshape(DP, TP),
                ("dp", "tp"))


def _ref_engine(params, ps, max_new, **kw):
    eng = RefDecoder(params, REF_CFG, max_slots=4, max_len=64,
                     mesh=_jax_mesh(), paged_attn="kernel", **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in ps]
    while any(r is not None for r in eng._slot_req) or eng._waiting:
        eng.step()
    return [[int(t) for t in r.tokens] for r in reqs]


def _mount_wire():
    """The mount cases, JAX mounted on the dp2 x tp2 mesh (rows over dp,
    heads over tp) and as the ranks receive them."""
    want, wire = [], []
    for i, (dtype, store) in enumerate(MOUNT_CASES):
        act, pools, bt = _case(20 + i, dtype, store)
        kw = ({"k_scale": pools[2], "v_scale": pools[3]}
              if store is not None else {})
        mkw = dict(mesh=_jax_mesh(), slot_axis="dp", head_axis="tp",
                   interpret=True, **kw)
        ctx, *new_pools = ref_pa.paged_attention_window(
            *act, pools[0], pools[1], jnp.asarray(bt), jnp.asarray(POS),
            active=jnp.asarray(ACTIVE), **mkw)
        read = ref_pa.paged_attention(act[0], pools[0], pools[1],
                                      jnp.asarray(bt), jnp.asarray(LENGTHS),
                                      **mkw)
        want.append({"ctx": np.asarray(ctx.astype(jnp.float32)),
                     "read": np.asarray(read.astype(jnp.float32)),
                     "pools": new_pools, "dtype": act[0]})
        c = {"bt": bt, "pos": POS, "active": ACTIVE, "lengths": LENGTHS,
             "dtypes": {}, "pools": []}
        for name, a in zip(("q", "kn", "vn"), act):
            c[name], c["dtypes"][name] = _wire(a)
        for name, a in zip(("kp", "vp", "ks", "vs"), pools):
            c[name], c["dtypes"][name] = _wire(a)
            c["pools"].append(name)
        wire.append(c)
    return want, wire


@pytest.fixture(scope="module")
def params():
    return ref_tf.init_transformer(REF_CFG, seed=0)


@pytest.fixture(scope="module")
def d_params():
    return ref_tf.init_transformer(REF_D_CFG, seed=1)


@pytest.fixture(scope="module")
def world(params, d_params):
    """The JAX side, then the four ranks' runs (one world for every
    case)."""
    ps = _prompts()
    want, wire = _mount_wire()
    ref = {"generate": [_generate(params, p, 10) for p in ps],
           "mesh": _ref_engine(params, ps, 10),
           "mesh_int8": _ref_engine(params, ps[:4], HORIZON,
                                    kv_dtype="int8"),
           "survivor": _generate(params, _survivor()[1], 24),
           "mounts": want}
    got = run_ranks(ranks.dp_world, DP * TP,
                    args=(params, d_params, ps, _survivor(), _payloads(),
                          wire),
                    device="cpu", axes={"dp": DP, "tp": TP}, threads=1,
                    timeout=300)
    return ref, got


def _replicas(got):
    """(tp rank, dp 0's result, dp 1's result) for each tp rank."""
    by = {(r["dp"], r["tp"]): r for r in got}
    return [(t, by[(0, t)], by[(1, t)]) for t in range(TP)]


def _same_pools(a, b, what):
    for li, (la, lb) in enumerate(zip(a, b)):
        assert set(la) == set(lb)
        for key in la:
            assert np.array_equal(_np_bits(la[key])[1:],
                                  _np_bits(lb[key])[1:]), \
                f"{what}: layer {li} {key} differs off page 0"


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_dp2xtp2_tokens_match_jax_mesh_engine_and_generate_cached(
        world, impl):
    ref, got = world
    assert ref["mesh"] == ref["generate"]
    for res in got:
        assert res[impl]["tokens"] == ref["mesh"]
        assert res[impl]["engine_mesh_shape"] == res["mesh_shape"] == \
            "dp2xtp2"
        assert res[impl]["slot_axis"] == "dp"
        assert res[impl]["rows"] == [2 * res["dp"], 2 * res["dp"] + 2]
    stats = got[0][impl]["stats"]
    if impl == "kernel":
        assert stats["attn_ticks_kernel"] > 0
        assert stats["attn_ticks_gather"] == 0 and stats["gather_bytes"] == 0
    else:
        assert stats["attn_ticks_gather"] > 0


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_dp2xtp2_replicas_hold_bitwise_equal_pages(world, impl):
    _, got = world
    for t, a, b in _replicas(got):
        _same_pools(a[impl]["layers"], b[impl]["layers"], f"tp rank {t}")
        assert a[impl]["layers"][0]["k"].shape[1] == CFG.heads // TP
    # the kernel and gather paths write the same layer-0 bytes (later
    # layers' rows follow attention sums taken in another order)
    for res in got:
        _same_pools(res["kernel"]["layers"][:1], res["gather"]["layers"][:1],
                    "kernel vs gather")
    # the tp ranks hold different heads
    assert not np.array_equal(got[0]["kernel"]["layers"][0]["k"][1:],
                              got[1]["kernel"]["layers"][0]["k"][1:])


def test_dp2xtp2_int8_matches_jax_int8_mesh_engine(world):
    ref, got = world
    for res in got:
        assert res["int8"]["tokens"] == ref["mesh_int8"]
        assert res["int8"]["stats"]["attn_ticks_kernel"] > 0
        assert set(res["int8"]["layers"][0]) == {"k", "v", "k_scale",
                                                 "v_scale"}
    for t, a, b in _replicas(got):
        _same_pools(a["int8"]["layers"], b["int8"]["layers"],
                    f"int8 tp rank {t}")


def test_dp2xtp2_speculation_gamma4_matches(world):
    ref, got = world
    for res in got:
        assert res["spec"]["tokens"] == ref["mesh"][:4] == \
            ref["generate"][:4]
        assert res["spec"]["stats"]["spec_verify_windows"] > 0
        assert res["spec"]["pool"]["gather_bytes"] == 0
    # every rank ran the same rounds
    assert len({r["spec"]["stats"]["spec_verify_windows"]
                for r in got}) == 1


def test_dp2xtp2_compact_midstream_keeps_the_survivor(world):
    ref, got = world
    for res in got:
        assert res["compact"]["tokens"] == ref["survivor"]
        assert res["compact"]["defrag_moves"] > 0
        assert res["compact"]["pages_in_use"] == 0


@pytest.mark.parametrize("i", range(len(MOUNT_CASES)),
                         ids=[f"{jnp.dtype(d).name}-{s or 'plain'}"
                              for d, s in MOUNT_CASES])
def test_window_and_read_mounts_rows_over_dp_match_jax(world, i):
    ref, got = world
    want = ref["mounts"][i]
    tol = F32 if MOUNT_CASES[i][0] == jnp.float32 else BF16
    n, h = want["ctx"].shape[0] // DP, want["ctx"].shape[1] // TP
    for res in got:
        d, t = res["dp"], res["tp"]
        for key in ("ctx", "read"):
            block = _from_wire(res["mount"][i][key], want["dtype"])
            np.testing.assert_allclose(
                block, want[key][d * n:(d + 1) * n, t * h:(t + 1) * h],
                **tol)
        # every dp shard's rows written on this replica: its heads of the
        # JAX mount's pools, bit for bit off the trash page
        for j, w in enumerate(want["pools"]):
            mine = np.asarray(w)[:, t * h:(t + 1) * h]
            assert np.array_equal(_np_bits(res["mount"][i]["pools"][j])[1:],
                                  _np_bits(mine)[1:])


def _blob_pages(blob, key, layer):
    """A blob buffer's bytes as (n_pages, heads, rest) uint8."""
    raw = np.frombuffer(base64.b64decode(blob["data"][layer][key]), np.uint8)
    return raw.reshape(blob["n_pages"], CFG.heads, -1)


def test_tp2_export_blob_is_the_shards_by_head(world):
    _, got = world
    blobs = [r["session"]["checkpoint"]["kv"] for r in got]
    assert all(b == blobs[0] for b in blobs)
    blob = blobs[0]
    assert blob["page_shape"][0] == CFG.heads
    h = CFG.heads // TP
    for res in got:
        t = res["tp"]
        for li, shard in enumerate(res["session"]["shard"]):
            for key, mine in shard.items():
                raw = np.ascontiguousarray(mine).view(np.uint8).reshape(
                    blob["n_pages"], h, -1)
                assert np.array_equal(
                    _blob_pages(blob, key, li)[:, t * h:(t + 1) * h], raw)


def test_tp2_export_adopted_warm_by_single_device_and_mesh(world, params):
    ref, got = world
    ck = got[0]["session"]["checkpoint"]
    eng = ContinuousDecoder(params, CFG, device="cpu", max_slots=4,
                            max_len=64)
    req = eng.restore_session(ck["session"], ck["kv"])
    for _ in range(200):
        if req.done:
            break
        eng.step()
    assert eng.stats["prefills"] == 0
    assert eng.stats["sessions_adopted"] == 1
    for res in got:
        assert res["session"]["uninterrupted"] == ref["survivor"]
        assert res["session"]["adopted_mesh"] == ref["survivor"]
        assert res["session"]["adopted_prefills"] == 0
    assert eng.session_result(req) == ref["survivor"]


def test_generation_engine_on_the_mesh_over_http(world, params):
    _, got = world
    eng = ContinuousDecoder(params, CFG, device="cpu", max_slots=4,
                            max_len=64)
    want = []
    for p in _prompts():
        req = eng.submit(p, 10)
        while not req.done:
            eng.step()
        want.append(eng.result(req))
    lead = [r for r in got if r["http"]["leader"]]
    assert len(lead) == 1 and lead[0]["dp"] == lead[0]["tp"] == 0
    assert [r["http"]["address"] is None for r in got] == [False] + [True] * 3
    replies = lead[0]["http"]["replies"]
    assert [s for s, _ in replies] == [200] * len(want)
    assert [body["tokens"] for _, body in replies] == want


def test_generation_engine_on_the_mesh_refuses_a_token_past_int32(world,
                                                                  params):
    """Rank 0 refuses the request before any rank sees it, so the ranks
    stay in step and the next request is served."""
    _, got = world
    eng = ContinuousDecoder(params, CFG, device="cpu", max_slots=4,
                            max_len=64)
    req = eng.submit(_prompts()[0], 10)
    while not req.done:
        eng.step()
    (bad_status, bad_body), (status, body) = [
        r for r in got if r["http"]["leader"]][0]["http"]["after"]
    assert bad_status == 400 and "int32" in bad_body["error"]
    assert status == 200 and body["tokens"] == eng.result(req)
    for res in got:
        assert res["http"]["after"] is None or res["http"]["leader"]


def test_generation_engine_on_the_mesh_stops_when_a_follower_fails(params):
    """A follower's failed tick is fatal for the world: no rank skips it
    and goes on. The follower leaves its loop, rank 0's next exchange
    fails, and every rank's ``stop()`` raises; nothing hangs."""
    got = run_ranks(ranks.follower_tick_fails, 2, args=(params,),
                    device="cpu", threads=1, timeout=200)
    assert [r["leader"] for r in got] == [True, False]
    assert all(r["ended"] for r in got)
    assert got[1]["raised"] == "serving on the mesh failed <- InjectedFault"
    assert got[0]["raised"].startswith("serving on the mesh failed")


def test_gather_rows_keeps_every_bit(world):
    _, got = world
    want = np.array([[-0.0, np.nan, 1.5], [-0.0, np.nan, 3.0]], np.float32)
    for res in got:
        for g in (res["gathered"], res["gathered_many"][0]):
            assert np.array_equal(np.asarray(g).view(np.uint32),
                                  want.view(np.uint32))
        assert res["gathered_many"][1].tolist() == [[True], [True]]
        assert res["gathered_many"][2].tolist() == [7, 7]
