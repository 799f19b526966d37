"""Port parity: the tensor-parallel continuous-batching engine
(``ContinuousDecoder(mesh=)``) on a tp = 2 world of two gloo CPU ranks.

Every rank runs the same engine on the same submissions and holds its
``shard_params`` slice of the weights and its two-of-four-head shard of
the pool. Held against the JAX engine on a ("tp",) 2-device mesh (Pallas
interpret mode on the conftest's 8 host devices), as
``tests/test_mesh_parity.py`` holds that one:

* greedy tokens (5 prompts, 10 tokens, f32) equal the JAX mesh engine's
  and ``generate_cached``'s, on both ranks, through the kernel and the
  gather paths; each rank's layer-0 shards are bitwise equal between the
  two paths off trash page 0;
* an int8 engine equals the JAX int8 tp2 engine over the JAX tests'
  4-token horizon (``tests/test_mesh_parity.py:208``);
* a mid-stream ``compact()`` keeps the survivor's reference tokens;
* ``shard_params`` slices concatenate back to the full weights bitwise;
  a mesh that does not divide the heads raises ValueError, a dp > 1
  mesh NotImplementedError;
* a one-rank ("dp", "tp") = (1, 1) mesh (the collective on a group of
  one) gives the single-device engine's tokens and pages bit for bit.

The ranks run ``tests/test_torch_mesh_ranks.py``, which imports no JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu.serving.continuous import ContinuousDecoder as RefDecoder
from mmlspark_tpu_torch.models.zoo import transformer as port_tf
from mmlspark_tpu_torch.parallel.launch import run_ranks
from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder

import test_torch_mesh_ranks as ranks

REF_CFG = ref_tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                                   d_ff=128, max_len=96, causal=True,
                                   norm="rmsnorm", position="rope",
                                   dtype=jnp.float32)
CFG = ranks.CFG
HORIZON = 4


def _prompts(n=5, seed=3):
    """``tests/test_mesh_parity.py``'s prompts (lengths 4, 7, ..., 16)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab, 4 + 3 * i).astype(np.int32)
            for i in range(n)]


def _survivor():
    rng = np.random.default_rng(7)
    return (rng.integers(1, CFG.vocab, 5).astype(np.int32),
            rng.integers(1, CFG.vocab, 9).astype(np.int32))


def _generate(params, prompt, n):
    ids = ref_tf.generate_cached(params, prompt[None, :], REF_CFG,
                                 max_new_tokens=n)
    return [int(t) for t in np.asarray(ids)[0, len(prompt):]]


def _ref_engine(params, ps, max_new, **kw):
    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    eng = RefDecoder(params, REF_CFG, max_slots=4, max_len=64, mesh=mesh,
                     paged_attn="kernel", **kw)
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in ps]
    while any(r is not None for r in eng._slot_req) or eng._waiting:
        eng.step()
    return [[int(t) for t in r.tokens] for r in reqs]


@pytest.fixture(scope="module")
def params():
    return ref_tf.init_transformer(REF_CFG, seed=0)


@pytest.fixture(scope="module")
def reference(params):
    """The JAX side, computed once: generate_cached per prompt, the tp2
    mesh engine (f32, and int8 over the horizon), the survivor."""
    ps = _prompts()
    return {"generate": [_generate(params, p, 10) for p in ps],
            "mesh": _ref_engine(params, ps, 10),
            "mesh_int8": _ref_engine(params, ps[:4], HORIZON,
                                     kv_dtype="int8"),
            "survivor": _generate(params, _survivor()[1], 24)}


@pytest.fixture(scope="module")
def tp2(params):
    """Both ranks' engine runs, one world for every case."""
    return run_ranks(ranks.engine_cases, 2,
                     args=(params, _prompts(), _survivor()), device="cpu",
                     threads=1, timeout=300)


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_tp2_tokens_match_jax_mesh_engine_and_generate_cached(
        reference, tp2, impl):
    assert reference["mesh"] == reference["generate"]
    for res in tp2:
        assert res[impl]["tokens"] == reference["mesh"]
        assert res[impl]["engine_mesh_shape"] == res["mesh_shape"] == "tp2"
    stats = tp2[0][impl]["stats"]
    if impl == "kernel":
        assert stats["attn_ticks_kernel"] > 0
        assert stats["attn_ticks_gather"] == 0 and stats["gather_bytes"] == 0
    else:
        assert stats["attn_ticks_gather"] > 0 and stats["gather_bytes"] > 0


def test_tp2_ranks_hold_their_shard_and_paths_agree_bitwise(tp2):
    for rank, res in enumerate(tp2):
        assert res["rank"] == rank
        k, g = res["kernel"], res["gather"]
        assert k["pool_heads"] == CFG.heads // 2
        for key in ("k", "v"):
            assert k["layer0"][key].shape[1] == CFG.heads // 2
            assert np.array_equal(k["layer0"][key][1:], g["layer0"][key][1:])
        # byte figures: the shard's, and the global one named as such
        assert k["bytes_per_position_global"] == 2 * k["bytes_per_position"]
        assert k["device_bytes_global"] == 2 * k["device_bytes"]
    # the gather path moves the bytes one device would: counted globally
    assert tp2[0]["gather"]["stats"] == tp2[1]["gather"]["stats"]
    # the two ranks' shards differ (each holds its own heads)
    assert not np.array_equal(tp2[0]["kernel"]["layer0"]["k"][1:],
                              tp2[1]["kernel"]["layer0"]["k"][1:])


def test_tp2_int8_matches_jax_int8_mesh_engine(reference, tp2):
    for res in tp2:
        assert res["int8"]["tokens"] == reference["mesh_int8"]
        assert res["int8"]["stats"]["attn_ticks_kernel"] > 0
        assert res["int8"]["stats"]["gather_bytes"] == 0
        assert set(res["int8"]["layer0"]) == {"k", "v", "k_scale", "v_scale"}
        assert res["int8"]["layer0"]["k_scale"].shape[1] == CFG.heads // 2


def test_tp2_compact_midstream_keeps_the_survivor(reference, tp2):
    for res in tp2:
        assert res["compact"]["tokens"] == reference["survivor"]
        assert res["compact"]["defrag_moves"] > 0
        assert res["compact"]["pages_in_use"] == 0


def test_tp2_indivisible_heads_raise(tp2):
    for res in tp2:
        assert res["indivisible"] is not None
        assert "not divisible" in res["indivisible"]
    with pytest.raises(ValueError, match="not divisible"):
        port_tf.shard_params(ranks.tf.init_transformer(CFG), CFG, 0, 3)


def test_dp_mesh_raises_not_implemented(params):
    with pytest.raises(NotImplementedError, match="Slice 6 leftovers"):
        ContinuousDecoder(params, CFG, device="cpu",
                          mesh=ranks.StubMesh(dp=2, tp=1))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_params_concatenate_back_bitwise(params, tp):
    full = port_tf.params_from_numpy(params, CFG, "cpu")
    shards = [port_tf.params_from_numpy(
        port_tf.shard_params(params, CFG, r, tp), CFG, "cpu")
        for r in range(tp)]
    d, f = CFG.d_model // tp, CFG.d_ff // tp
    for li, lp in enumerate(full["layers"]):
        parts = [s["layers"][li] for s in shards]
        for key in ("w", "b"):
            qkv = [p["qkv"][key].split(d, dim=-1) for p in parts]
            # q, k and v each keep whole heads: [q_0 .. q_tp | k_0 .. | v_0 ..]
            back = torch.cat([qkv[r][i] for i in range(3) for r in range(tp)],
                             dim=-1)
            assert torch.equal(back, lp["qkv"][key])
            assert torch.equal(torch.cat([p["w1"][key] for p in parts], -1),
                               lp["w1"][key])
        for name in ("out", "w2"):
            assert torch.equal(torch.cat([p[name]["w"] for p in parts], 0),
                               lp[name]["w"])
            # row-parallel biases stay whole on every rank
            assert all(torch.equal(p[name]["b"], lp[name]["b"])
                       for p in parts)
        for name in ("ln1", "ln2"):
            assert all(torch.equal(p[name]["scale"], lp[name]["scale"])
                       for p in parts)
        assert parts[0]["qkv"]["w"].shape[-1] == 3 * d
        assert parts[0]["w1"]["w"].shape[-1] == f
    for s in shards:
        assert torch.equal(s["embed"]["tok"], full["embed"]["tok"])
        assert torch.equal(s["lm_head"]["w"], full["lm_head"]["w"])


def test_tp1_mesh_engine_equals_single_device_engine(params):
    # a ("dp", "tp") = (1, 1) mesh: the 2-D layout with dp = 1 serves too
    res, = run_ranks(ranks.single_rank_engine, 1, args=(params, _prompts()),
                     device="cpu", axes={"dp": 1, "tp": 1}, threads=2,
                     timeout=300)
    assert res["mesh_shape"] == "dp1xtp1"
    assert res["mesh"]["tokens"] == res["single"]["tokens"]
    for key in ("k", "v"):
        assert np.array_equal(res["mesh"]["layer0"][key][1:],
                              res["single"]["layer0"][key][1:])
