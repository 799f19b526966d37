"""The port's transformer ONNX ops (ORT's optimizer output and the ai.onnx
attention family) against the JAX converter on the CPU.

* Every case of ``tests/test_onnx_foreign.py``'s ``TestMicrosoftContribOps``
  and ``TestLlamaEraContribOps`` and its module-level MHA / GQA / ai.onnx
  ``Attention`` tests, plus the ops those tests leave out (ai.onnx
  ``Gelu``, ``Einsum``, ``RelativePositionBias``, the 3-D and ai.onnx
  ``RotaryEmbedding`` forms, the optional inputs), as one parametrised
  test: the same bytes through both converters on seeded numpy inputs.
  Float outputs are held to ``F32``: within 1e-5 · max|ref| + 1e-6 of the
  JAX converter's, ref its output (the two sum attention and matmuls in
  other orders). Integer outputs are held exact. Each case also keeps the
  semantic checks of the reference test it ports (a cap that bites, a
  cache written at its row's position), against the port alone.
* On CPU tensors ``_attention_core`` runs the dense branch, as the JAX
  converter does off the TPU. With the route predicate patched so that CPU
  tensors take K7's wrapper (which runs ``flash_attention_plain`` there),
  the ops that reach ``_attention_core`` are held against the JAX
  package's flash kernel in Pallas interpret mode on the same q/k/v:
  causal, GQA-repeated, and a fully masked row, which is exactly 0 there
  (the dense branch gives the mean of v instead).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mmlspark_tpu.onnx as J
import mmlspark_tpu_torch.onnx as O
from mmlspark_tpu.ops.flash_attention import flash_attention as ref_flash
from mmlspark_tpu_torch.onnx import convert as pconv
from mmlspark_tpu_torch.onnx.convert import UnsupportedOp
from mmlspark_tpu_torch.ops.flash_attention import flash_attention_plain

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

MS = {"domain": "com.microsoft"}


def _model(nodes, feeds, inits=None, outs=("y",), opset=17):
    g = O.make_graph(
        nodes, "t",
        [O.make_tensor_value_info(k, v.dtype, list(v.shape))
         for k, v in feeds.items()],
        [O.make_tensor_value_info(o, np.float32, []) for o in outs],
        initializers=inits or {})
    return O.make_model(g, opset=opset, extra_opsets={"com.microsoft": 1})


def _port(data, feeds, outs):
    pm = O.convert_model(data)
    out = pm({k: torch.from_numpy(v) for k, v in pm.params.items()},
             {k: torch.from_numpy(v.copy()) for k, v in feeds.items()})
    return {o: out[o].numpy() for o in outs}


def _jax(data, feeds, outs):
    jm = J.convert_model(data)
    out = jm(jm.params, {k: jnp.asarray(v) for k, v in feeds.items()})
    return {o: np.asarray(out[o]) for o in outs}


def _f32_close(got, want, what=""):
    """``got`` within 1e-5 · max|want| + 1e-6 of ``want`` (``F32``)."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 1e-5 * float(np.abs(want).max(initial=0.0)) + 1e-6
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    assert err <= tol, f"{what}: max |port - jax| {err} > {tol}"


def _both(nodes, feeds, inits=None, outs=("y",), opset=17):
    """Run one graph through both converters and hold every output: floats
    to ``F32``, integers exact. Returns the port's outputs."""
    data = _model(nodes, feeds, inits, outs, opset)
    got, want = _port(data, feeds, outs), _jax(data, feeds, outs)
    for o in outs:
        if want[o].dtype.kind == "f":
            assert got[o].dtype == np.float32, (o, got[o].dtype)
            _f32_close(got[o], want[o], o)
        else:
            # JAX runs with 64-bit types off: int64 comes back as int32
            assert got[o].dtype.kind == want[o].dtype.kind
            np.testing.assert_array_equal(got[o], want[o])
    return got


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda *shape, s=1.0: r.normal(0, s, shape).astype(np.float32)


def _rope_tables(max_pos, rot_dim):
    half = rot_dim // 2
    inv = 1.0 / (10000.0 ** (np.arange(half) / half))
    ang = np.arange(max_pos)[:, None] * inv[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _heads(t, B, S, nh):
    return t.reshape(B, S, nh, -1).transpose(0, 2, 1, 3)


def _np_attention(q, k, v, mask=None, bias=None, softcap=0.0, smooth=False):
    """Dense numpy attention over (B, H, S, D) with a broadcastable boolean
    mask (masked logits -1e30), additive bias, softcap, smooth softmax."""
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    if softcap:
        s = softcap * np.tanh(s / softcap)
    if mask is not None:
        s = np.where(mask, s, -1e30)
    m = np.maximum(s.max(-1, keepdims=True), 0.0 if smooth else -np.inf)
    e = np.exp(s - m)
    p = e / (e.sum(-1, keepdims=True) + (np.exp(-m) if smooth else 0.0))
    return np.einsum("bhqk,bhkd->bhqd", p, v)


# ---------------------------------------------------------------------------
# the cases: each returns nothing and asserts through ``_both``


def case_fused_matmul_and_gelus():
    n = _rng(0)
    a, b, bias = n(3, 4), n(5, 4), n(5)
    got = _both([O.make_node("FusedMatMul", ["a", "b"], ["mm"], transB=1,
                             alpha=0.5, **MS),
                 O.make_node("BiasGelu", ["mm", "bias"], ["bg"], **MS),
                 O.make_node("FastGelu", ["mm", "bias"], ["fg"], **MS),
                 O.make_node("FastGelu", ["mm"], ["fg0"], **MS),
                 O.make_node("QuickGelu", ["mm"], ["qg"], alpha=1.5, **MS)],
                {"a": a}, {"b": b, "bias": bias},
                ("mm", "bg", "fg", "fg0", "qg"))
    x = 0.5 * (a @ b.T) + bias
    erf = np.vectorize(math.erf)
    np.testing.assert_allclose(got["bg"], x * 0.5 * (1 + erf(x / np.sqrt(2))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["fg"], 0.5 * x * (1 + np.tanh(
        np.sqrt(2 / np.pi) * (x + 0.044715 * x ** 3))), rtol=1e-4, atol=1e-4)


def case_fused_matmul_trans_a():
    n = _rng(20)
    _both([O.make_node("FusedMatMul", ["a", "b"], ["y"], transA=1, **MS)],
          {"a": n(2, 4, 3), "b": n(2, 4, 5)})


def case_gelu_standard():
    # ai.onnx Gelu (opset 20): erf by default, tanh on request
    x = _rng(21)(4, 6, s=2.0)
    got = _both([O.make_node("Gelu", ["x"], ["e"]),
                 O.make_node("Gelu", ["x"], ["t"], approximate="tanh")],
                {"x": x}, outs=("e", "t"), opset=20)
    assert np.abs(got["e"] - got["t"]).max() > 1e-5  # two functions


def case_skip_layernorm():
    n = _rng(1)
    _both([O.make_node("SkipLayerNormalization", ["x", "s", "g", "b", "bi"],
                       ["y", "mu", "inv", "sum"], epsilon=1e-5, **MS)],
          {"x": n(2, 3, 8), "s": n(2, 3, 8)},
          {"g": n(8, s=0.1) + 1, "b": n(8, s=0.1), "bi": n(8, s=0.1)},
          ("y", "mu", "inv", "sum"))


def case_skip_layernorm_no_beta_no_bias():
    n = _rng(22)
    _both([O.make_node("SkipLayerNormalization", ["x", "s", "g"], ["y"],
                       **MS)],
          {"x": n(2, 3, 8), "s": n(2, 3, 8)}, {"g": n(8, s=0.1) + 1})


def case_embed_layernorm():
    r = np.random.default_rng(2)
    V, P, H = 20, 10, 8
    ids = r.integers(0, V, (2, 6)).astype(np.int64)
    seg = r.integers(0, 2, (2, 6)).astype(np.int64)
    mask = np.ones((2, 6), np.int64)
    mask[0, 4:] = 0
    n = _rng(2)
    got = _both([O.make_node("EmbedLayerNormalization",
                             ["ids", "seg", "we", "pe", "se", "g", "b",
                              "mask"], ["y", "mi", "sum"], **MS)],
                {"ids": ids, "seg": seg, "mask": mask},
                {"we": n(V, H), "pe": n(P, H), "se": n(2, H),
                 "g": np.ones(H, np.float32), "b": np.zeros(H, np.float32)},
                ("y", "mi", "sum"))
    np.testing.assert_array_equal(got["mi"], [4, 6])
    assert got["mi"].dtype == np.int32


def case_embed_layernorm_position_ids_no_mask():
    r = np.random.default_rng(23)
    n = _rng(23)
    got = _both([O.make_node("EmbedLayerNormalization",
                             ["ids", "", "we", "pe", "", "g", "b", "",
                              "pos"], ["y", "mi"], epsilon=1e-5, **MS)],
                {"ids": r.integers(0, 9, (3, 5)).astype(np.int64),
                 "pos": r.integers(0, 7, (3, 5)).astype(np.int64)},
                {"we": n(9, 8), "pe": n(7, 8), "g": n(8) + 1, "b": n(8)},
                ("y", "mi"))
    np.testing.assert_array_equal(got["mi"], [5, 5, 5])


def case_fused_attention():
    n = _rng(3)
    B, S, H, heads = 2, 5, 8, 2
    x, w, b = n(B, S, H), n(H, 3 * H, s=0.3), n(3 * H, s=0.1)
    lens = np.array([3, 5], np.int32)   # (B,) right-pad lengths form
    got = _both([O.make_node("Attention", ["x", "w", "b", "lens"], ["y"],
                             num_heads=heads, **MS)],
                {"x": x, "lens": lens}, {"w": w, "b": b})["y"]
    q, k, v = (_heads(t, B, S, heads) for t in np.split(x @ w + b, 3, -1))
    kvm = (np.arange(S)[None, :] < lens[:, None])[:, None, None, :]
    want = _np_attention(q, k, v, kvm).transpose(0, 2, 1, 3).reshape(B, S, H)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def case_fused_attention_2d_mask_unidirectional():
    n = _rng(24)
    B, S, H, heads = 2, 6, 8, 2
    mask = np.ones((B, S), np.int64)
    mask[1, 4:] = 0
    _both([O.make_node("Attention", ["x", "w", "b", "m"], ["y"],
                       num_heads=heads, unidirectional=1, scale=0.3, **MS)],
          {"x": n(B, S, H), "m": mask},
          {"w": n(H, 3 * H, s=0.3), "b": n(3 * H, s=0.1)})


def case_attention_scale_zero_means_default():
    # ORT substitutes 1/sqrt(head_size) when the serialized scale is 0
    n = _rng(7)
    feeds, inits = {"x": n(1, 4, 8)}, {"w": n(8, 24, s=0.3)}
    zero = _both([O.make_node("Attention", ["x", "w"], ["y"], num_heads=2,
                              scale=0.0, **MS)], feeds, inits)["y"]
    unset = _both([O.make_node("Attention", ["x", "w"], ["y"], num_heads=2,
                               **MS)], feeds, inits)["y"]
    np.testing.assert_allclose(zero, unset, rtol=1e-6)


def case_fused_attention_extra_add_qk():
    n = _rng(15)
    B, H, D, S = 1, 2, 4, 5
    hid = H * D
    x, w, ab = n(B, S, hid), n(hid, 3 * hid, s=0.3), n(1, H, S, S)
    got = _both([O.make_node("Attention", ["x", "w", "", "", "", "ab"],
                             ["y"], num_heads=H, **MS)],
                {"x": x, "ab": ab}, {"w": w})["y"]
    q, k, v = (_heads(t, B, S, H) for t in np.split(x @ w, 3, -1))
    want = _np_attention(q, k, v, bias=ab).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, want.reshape(B, S, hid), rtol=1e-4,
                               atol=1e-4)


def case_rms_norm_variants():
    n = _rng(0)
    x, skip, gamma = n(2, 3, 8), n(2, 3, 8), n(8, s=0.1) + 1
    got = _both([O.make_node("SimplifiedLayerNormalization", ["x", "g"],
                             ["a"], epsilon=1e-6),
                 O.make_node("RMSNormalization", ["x", "g"], ["b"],
                             epsilon=1e-6),
                 O.make_node("SkipSimplifiedLayerNormalization",
                             ["x", "s", "g", "bi"], ["c", "", "inv", "sum"],
                             epsilon=1e-6, **MS)],
                {"x": x, "s": skip}, {"g": gamma, "bi": n(8, s=0.1)},
                ("a", "b", "c", "inv", "sum"))

    def rms(t):
        return t / np.sqrt((t * t).mean(-1, keepdims=True) + 1e-6) * gamma

    np.testing.assert_allclose(got["a"], rms(x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["b"], rms(x), rtol=1e-5, atol=1e-5)


def _rotary_case(interleaved):
    n = _rng(1)
    B, NH, S, D = 1, 2, 4, 6
    x = n(B, NH, S, D)
    pos = np.arange(S, dtype=np.int64)[None, :].repeat(B, 0)
    cos_c, sin_c = _rope_tables(16, D)
    got = _both([O.make_node("RotaryEmbedding", ["x", "p", "c", "s"], ["y"],
                             interleaved=interleaved, **MS)],
                {"x": x, "p": pos}, {"c": cos_c, "s": sin_c})["y"]
    cos, sin = cos_c[pos][:, None], sin_c[pos][:, None]
    if interleaved:
        x0, x1 = x[..., 0::2], x[..., 1::2]
        want = np.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                        -1).reshape(x.shape)
    else:
        x0, x1 = x[..., :D // 2], x[..., D // 2:]
        want = np.concatenate([x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def case_rotary_embedding_split_half():
    _rotary_case(0)


def case_rotary_embedding_interleaved():
    _rotary_case(1)


def case_rotary_embedding_3d_partial_and_standard():
    # (B, S, H) input with num_heads, rotating 4 of each head's 8 lanes;
    # the ai.onnx form orders the caches before position_ids
    n = _rng(25)
    r = np.random.default_rng(25)
    B, S, heads, D = 2, 5, 3, 8
    x = n(B, S, heads * D)
    pos = r.integers(0, 12, (B, S)).astype(np.int64)
    cos_c, sin_c = _rope_tables(16, 4)
    _both([O.make_node("RotaryEmbedding", ["x", "p", "c", "s"], ["a"],
                       num_heads=heads, **MS),
           O.make_node("RotaryEmbedding", ["x", "c", "s", "p"], ["b"],
                       num_heads=heads, interleaved=1)],
          {"x": x, "p": pos}, {"c": cos_c, "s": sin_c}, ("a", "b"),
          opset=23)


def case_rotary_offset_form():
    # (1,) position_ids: pos = offset + arange(S)
    n = _rng(4)
    S, NH, D2 = 4, 2, 6
    x = n(1, NH, S, D2)
    cos_c, sin_c = _rope_tables(16, D2)
    got = _both([O.make_node("RotaryEmbedding", ["x", "p", "c", "s"], ["y"],
                             **MS)],
                {"x": x, "p": np.array([3], np.int64)},
                {"c": cos_c, "s": sin_c})["y"]
    pos = (3 + np.arange(S))[None, :]
    cos, sin = cos_c[pos][:, None], sin_c[pos][:, None]
    x0, x1 = x[..., :D2 // 2], x[..., D2 // 2:]
    np.testing.assert_allclose(got, np.concatenate(
        [x0 * cos - x1 * sin, x0 * sin + x1 * cos], -1), rtol=1e-5,
        atol=1e-5)


def case_multi_head_attention():
    n = _rng(2)
    B, S, H, heads = 2, 5, 8, 2
    q, k, v = n(B, S, H), n(B, S, H), n(B, S, H)
    mask = np.ones((B, S), np.int32)
    mask[0, 3:] = 0
    got = _both([O.make_node("MultiHeadAttention", ["q", "k", "v", "", "m"],
                             ["y"], num_heads=heads, **MS)],
                {"q": q, "k": k, "v": v, "m": mask})["y"]
    want = _np_attention(*(_heads(t, B, S, heads) for t in (q, k, v)),
                         mask.astype(bool)[:, None, None, :])
    np.testing.assert_allclose(got, want.transpose(0, 2, 1, 3).reshape(
        B, S, H), rtol=1e-4, atol=1e-4)


def case_mha_unidirectional():
    n = _rng(4)
    B, S, H, heads = 1, 4, 8, 2
    q = n(B, S, H)
    got = _both([O.make_node("MultiHeadAttention", ["q", "q", "q"], ["y"],
                             num_heads=heads, unidirectional=1, **MS)],
                {"q": q})["y"]
    qh = _heads(q, B, S, heads)
    want = _np_attention(qh, qh, qh, np.tril(np.ones((S, S), bool)))
    np.testing.assert_allclose(got, want.transpose(0, 2, 1, 3).reshape(
        B, S, H), rtol=1e-4, atol=1e-4)


def case_mha_packed_bias_lengths():
    n = _rng(26)
    B, Sq, Sk, H, heads = 2, 3, 5, 8, 2
    _both([O.make_node("MultiHeadAttention", ["q", "k", "v", "bias", "lens"],
                       ["y"], num_heads=heads, **MS)],
          {"q": n(B, Sq, H), "k": n(B, Sk, H), "v": n(B, Sk, H),
           "lens": np.array([2, 5], np.int32)}, {"bias": n(3 * H, s=0.2)})


def case_mha_attention_bias_and_past():
    n = _rng(14)
    B, H, D, S, Sp = 2, 2, 4, 3, 2
    hid = H * D
    q2, k2, v2 = n(B, S, hid), n(B, S, hid), n(B, S, hid)
    ab, pk, pv = n(1, H, S, Sp + S), n(B, H, Sp, D), n(B, H, Sp, D)
    got = _both([O.make_node("MultiHeadAttention",
                             ["q", "k", "v", "", "", "ab", "pk", "pv"],
                             ["y", "ok", "ov"], num_heads=H, **MS)],
                {"q": q2, "k": k2, "v": v2, "ab": ab, "pk": pk, "pv": pv},
                outs=("y", "ok", "ov"))
    kc = np.concatenate([pk, _heads(k2, B, S, H)], axis=2)
    np.testing.assert_array_equal(got["ok"], kc)


def case_std_attention_gqa_causal():
    n = _rng(5)
    B, Hq, Hkv, S, D = 1, 4, 2, 6, 4
    q, k, v = n(B, Hq, S, D), n(B, Hkv, S, D), n(B, Hkv, S, D)
    got = _both([O.make_node("Attention", ["q", "k", "v"], ["y"],
                             is_causal=1)], {"q": q, "k": k, "v": v},
                opset=23)["y"]
    # each KV head serves two consecutive query heads (jnp.repeat)
    want = _np_attention(q, np.repeat(k, 2, 1), np.repeat(v, 2, 1),
                         np.tril(np.ones((S, S), bool)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def case_std_attention_pair_mask():
    n = _rng(6)
    S, D = 6, 4
    q4 = n(1, 2, S, D)
    band = np.abs(np.arange(S)[:, None] - np.arange(S)[None, :]) <= 2
    _both([O.make_node("Attention", ["q", "q", "q", "m"], ["y"])],
          {"q": q4, "m": band}, opset=23)


def case_std_attention_softcap():
    q = _rng(12)(1, 2, 5, 4, s=2.0)
    got = _both([O.make_node("Attention", ["q", "q", "q"], ["y"],
                             softcap=0.7)], {"q": q}, opset=23)["y"]
    np.testing.assert_allclose(got, _np_attention(q, q, q, softcap=0.7),
                               rtol=1e-4, atol=1e-4)


def case_std_attention_3d_layout():
    n = _rng(10)
    B, H, D, S = 2, 2, 4, 3
    got = _both([O.make_node("Attention", ["q", "k", "v"], ["y"],
                             q_num_heads=H, kv_num_heads=H, scale=0.25)],
                {"q": n(B, S, H * D), "k": n(B, S, H * D),
                 "v": n(B, S, H * D)}, opset=23)["y"]
    assert got.shape == (B, S, H * D)


def case_std_attention_past():
    n = _rng(11)
    B, H, D, S, Sp = 2, 2, 4, 3, 4
    pk = n(B, H, Sp, D)
    k4 = n(B, H, S, D)
    got = _both([O.make_node("Attention", ["q", "k", "v", "", "pk", "pv"],
                             ["y", "ck", "cv"])],
                {"q": n(B, H, S, D), "k": k4, "v": n(B, H, S, D), "pk": pk,
                 "pv": n(B, H, Sp, D)}, outs=("y", "ck", "cv"), opset=23)
    np.testing.assert_array_equal(got["ck"], np.concatenate([pk, k4], 2))


def _gqa_feeds(seed, B, S, Hq, Hkv, D):
    n = _rng(seed)
    return n(B, S, Hq * D), n(B, S, Hkv * D), n(B, S, Hkv * D)


def _gqa_node(ins, outs=("y",), **attrs):
    return O.make_node("GroupQueryAttention", list(ins), list(outs), **MS,
                       **attrs)


def case_gqa_packed_rows_no_seqlens():
    B, Hq, Hkv, S, D = 1, 4, 2, 6, 4
    q, k, v = _gqa_feeds(5, B, S, Hq, Hkv, D)
    _both([_gqa_node(["q", "k", "v"], num_heads=Hq, kv_num_heads=Hkv)],
          {"q": q, "k": k, "v": v})


def case_gqa_seqlens():
    B, Hq, Hkv, S, D = 2, 4, 2, 6, 4
    q, k, v = _gqa_feeds(6, B, S, Hq, Hkv, D)
    _both([_gqa_node(["q", "k", "v", "", "", "sl", "tl"], num_heads=Hq,
                     kv_num_heads=Hkv)],
          {"q": q, "k": k, "v": v, "sl": np.array([3, 5], np.int32),
           "tl": np.array(S, np.int32)})


def case_gqa_kv_cache_decode():
    """One new token over static past buffers: the new row written at
    position S_past of each row's cache, earlier rows untouched."""
    r = np.random.default_rng(7)
    B, Hq, Hkv, D, S_max, S_past = 2, 4, 2, 4, 8, 5
    q, k, v = (r.normal(0, 1, (B, 1, h * D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    past_k = np.full((B, Hkv, S_max, D), 1e3, np.float32)
    past_v = np.full((B, Hkv, S_max, D), -1e3, np.float32)
    past_k[:, :, :S_past] = r.normal(0, 1, (B, Hkv, S_past, D))
    past_v[:, :, :S_past] = r.normal(0, 1, (B, Hkv, S_past, D))
    got = _both([_gqa_node(["q", "k", "v", "pk", "pv", "sl", "tl"],
                           ("y", "ok", "ov"), num_heads=Hq,
                           kv_num_heads=Hkv)],
                {"q": q, "k": k, "v": v, "pk": past_k, "pv": past_v,
                 "sl": np.full(B, S_past, np.int32),
                 "tl": np.array(S_past + 1, np.int32)},
                outs=("y", "ok", "ov"))
    assert got["ok"].shape == (B, Hkv, S_max, D)
    np.testing.assert_array_equal(got["ok"][:, :, :S_past],
                                  past_k[:, :, :S_past])
    np.testing.assert_array_equal(got["ok"][:, :, S_past],
                                  _heads(k, B, 1, Hkv)[:, :, 0])
    np.testing.assert_array_equal(got["ov"][:, :, S_past + 1:],
                                  past_v[:, :, S_past + 1:])


def case_gqa_decode_ragged_rows_rotary():
    # two new tokens a row, each row at its own past length, fused rotary
    r = np.random.default_rng(27)
    B, Hq, Hkv, D, S_max, S = 3, 4, 1, 8, 12, 2
    q, k, v = (r.normal(0, 1, (B, S, h * D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    cos_c, sin_c = _rope_tables(16, D)
    _both([_gqa_node(["q", "k", "v", "pk", "pv", "sl", "tl", "cc", "sc"],
                     ("y", "ok", "ov"), num_heads=Hq, kv_num_heads=Hkv,
                     do_rotary=1, rotary_interleaved=1)],
          {"q": q, "k": k, "v": v,
           "pk": r.normal(0, 1, (B, Hkv, S_max, D)).astype(np.float32),
           "pv": r.normal(0, 1, (B, Hkv, S_max, D)).astype(np.float32),
           "sl": np.array([2, 6, 11], np.int32),
           "tl": np.array(12, np.int32)},
          {"cc": cos_c, "sc": sin_c}, outs=("y", "ok", "ov"))


def _gqa_packed(softcap):
    r = np.random.default_rng(8)
    B, Hq, Hkv, D, S = 2, 4, 2, 4, 6
    packed = r.normal(0, 1, (B, S, (Hq + 2 * Hkv) * D)).astype(np.float32)
    return _both([_gqa_node(["q", "", "", "", "", "sl", "tl"], num_heads=Hq,
                            kv_num_heads=Hkv, softcap=softcap)],
                 {"q": packed, "sl": np.full(B, S - 1, np.int32),
                  "tl": np.array(S, np.int32)})["y"], packed


def case_gqa_packed_qkv_and_softcap():
    got30, packed = _gqa_packed(30.0)
    got05, _ = _gqa_packed(0.5)
    assert got30.shape == (2, 6, 16)
    assert np.abs(got30 - got05).max() > 1e-3       # the cap bites


def case_gqa_smooth_softmax():
    B, Hq, Hkv, D, S = 2, 2, 1, 4, 5
    q, k, v = _gqa_feeds(11, B, S, Hq, Hkv, D)
    feeds = {"q": q, "k": k, "v": v, "sl": np.full(B, S - 1, np.int32),
             "tl": np.array(S, np.int32)}
    ins = ["q", "k", "v", "", "", "sl", "tl"]
    smooth = _both([_gqa_node(ins, num_heads=Hq, kv_num_heads=Hkv,
                              smooth_softmax=1)], feeds)["y"]
    plain = _both([_gqa_node(ins, num_heads=Hq, kv_num_heads=Hkv)],
                  feeds)["y"]
    assert np.abs(smooth - plain).max() > 1e-3


def case_gqa_rotary_fused():
    B, Hq, Hkv, D, S = 1, 2, 1, 8, 5
    q, k, v = _gqa_feeds(9, B, S, Hq, Hkv, D)
    cos_c, sin_c = _rope_tables(16, D)
    _both([_gqa_node(["q", "k", "v", "", "", "sl", "tl", "cc", "sc"],
                     num_heads=Hq, kv_num_heads=Hkv, do_rotary=1)],
          {"q": q, "k": k, "v": v, "sl": np.full(B, S - 1, np.int32),
           "tl": np.array(S, np.int32)}, {"cc": cos_c, "sc": sin_c})


def case_gqa_right_padded_prefill_positions():
    """A right-padded row's first ``valid`` outputs equal an unpadded run
    of that length: rotary positions do not go negative."""
    B, Hq, Hkv, D, S, valid = 1, 2, 1, 8, 6, 4
    q, k, v = _gqa_feeds(13, B, S, Hq, Hkv, D)
    cos_c, sin_c = _rope_tables(16, D)

    def run(n):
        return _both([_gqa_node(["q", "k", "v", "", "", "sl", "tl", "cc",
                                 "sc"], num_heads=Hq, kv_num_heads=Hkv,
                                do_rotary=1)],
                     {"q": q[:, :n], "k": k[:, :n], "v": v[:, :n],
                      "sl": np.full(B, valid - 1, np.int32),
                      "tl": np.array(n, np.int32)},
                     {"cc": cos_c, "sc": sin_c})["y"]

    np.testing.assert_allclose(run(S)[:, :valid], run(valid), rtol=1e-5,
                               atol=1e-5)


def case_einsum():
    n = _rng(28)
    _both([O.make_node("Einsum", ["a", "b"], ["y"],
                       equation="bhqd,bhkd->bhqk")],
          {"a": n(2, 3, 4, 5), "b": n(2, 3, 6, 5)})


def _rel_pos_case(bidirectional):
    n = _rng(29)
    _both([O.make_node("RelativePositionBias", ["t", "ql", "kl"], ["y"],
                       max_distance=128, is_bidirectional=bidirectional,
                       **MS)],
          {}, {"t": n(32, 3), "ql": np.array(40, np.int64),
               "kl": np.array(200, np.int64)})


def case_relative_position_bias_bidirectional():
    _rel_pos_case(1)


def case_relative_position_bias_causal():
    _rel_pos_case(0)


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transformer_op_matches_reference(case):
    """F32: port within 1e-5 · max|jax| + 1e-6 of the JAX converter."""
    CASES[case]()


@pytest.mark.parametrize("node, feeds", [
    (O.make_node("Attention", ["x", "w", "b", "", "past"], ["y"],
                 num_heads=2, **MS),
     {"x": np.zeros((1, 2, 4), np.float32),
      "past": np.zeros((2, 1, 2, 2, 2), np.float32)}),
    (O.make_node("Attention", ["x", "w"], ["y"], num_heads=2, do_rotary=1,
                 **MS), {"x": np.zeros((1, 2, 4), np.float32)}),
    (O.make_node("GroupQueryAttention", ["x", "x", "x"], ["y"], num_heads=2,
                 kv_num_heads=2, local_window_size=4, **MS),
     {"x": np.zeros((1, 2, 4), np.float32)}),
    (O.make_node("SkipSimplifiedLayerNormalization", ["x", "x", "g"],
                 ["y", "mean"], **MS),
     {"x": np.zeros((1, 2, 4), np.float32)}),
    (O.make_node("Attention", ["x", "x", "x", "m"], ["y"]),
     {"x": np.zeros((1, 2, 3, 4), np.float32),
      "m": np.zeros((1, 3), np.float32)}),
], ids=["attention_past", "attention_rotary", "gqa_local_window",
        "skip_rms_mean", "std_attention_float_mask"])
def test_refused_as_in_the_reference(node, feeds):
    """What the reference refuses, the port refuses too."""
    inits = {"w": np.zeros((4, 12), np.float32),
             "b": np.zeros(12, np.float32),
             "g": np.ones(4, np.float32)}
    data = _model([node], feeds, {k: v for k, v in inits.items()
                                  if k in node.inputs})
    pm, jm = O.convert_model(data), J.convert_model(data)
    with pytest.raises(UnsupportedOp):
        pm(pm.params, {k: torch.from_numpy(v) for k, v in feeds.items()})
    with pytest.raises(NotImplementedError):
        jm(jm.params, {k: jnp.asarray(v) for k, v in feeds.items()})


# ---------------------------------------------------------------------------
# the K7 branch, taken on the CPU by patching the route predicate


@pytest.fixture
def k7_on_cpu(monkeypatch):
    """CPU tensors take K7's wrapper (``flash_attention_plain`` there);
    yields a function returning the plain calls made since the start."""
    monkeypatch.setattr(pconv, "_k7_route", lambda q, k, v, pair_mask: None)
    start = flash_attention_plain.calls
    return lambda: flash_attention_plain.calls - start


def _ref_flash(q, k, v, mask, causal, scale=None):
    return np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                kv_mask=None if mask is None
                                else jnp.asarray(mask), scale=scale,
                                interpret=True))


@pytest.mark.parametrize("causal", [False, True])
def test_attention_core_on_k7_matches_reference_flash(k7_on_cpu, causal):
    """``_attention_core`` through the K7 wrapper against the JAX flash
    kernel in interpret mode (F32), a fully masked row exactly 0."""
    n = _rng(30)
    B, H, S, D = 3, 2, 40, 32
    q, k, v = n(B, H, S, D), n(B, H, S, D), n(B, H, S, D)
    mask = np.arange(S)[None, :] < np.array([S, 17, 0])[:, None]
    got = pconv._attention_core(
        *(torch.from_numpy(t).transpose(2, 3).contiguous().transpose(2, 3)
          for t in (q, k, v)), torch.from_numpy(mask), causal, 0.2)
    assert k7_on_cpu() == 1
    got = got.numpy()
    _f32_close(got, _ref_flash(q, k, v, mask, causal, 0.2))
    assert np.all(got[2] == 0.0)


def test_attention_node_on_k7_fully_masked_row(k7_on_cpu):
    """com.microsoft Attention through K7's wrapper: one launch a node, a
    zero-length row exactly 0 (the reference's TPU path gives 0 too; its
    dense branch gives the mean of v there)."""
    n = _rng(31)
    B, S, heads, D = 2, 24, 2, 32
    hid = heads * D
    x, w, b = n(B, S, hid), n(hid, 3 * hid, s=0.2), n(3 * hid, s=0.1)
    lens = np.array([S, 0], np.int32)
    data = _model([O.make_node("Attention", ["x", "w", "b", "lens"], ["y"],
                               num_heads=heads, **MS)],
                  {"x": x, "lens": lens}, {"w": w, "b": b})
    got = _port(data, {"x": x, "lens": lens}, ["y"])["y"]
    assert k7_on_cpu() == 1
    q, k, v = (_heads(t, B, S, heads) for t in np.split(x @ w + b, 3, -1))
    mask = np.arange(S)[None, :] < lens[:, None]
    want = _ref_flash(q, k, v, mask, False).transpose(0, 2, 1, 3)
    _f32_close(got, want.reshape(B, S, hid))
    assert np.all(got[1] == 0.0)
    dense = _jax(data, {"x": x, "lens": lens}, ["y"])["y"]
    assert np.abs(dense[1]).max() > 0.0        # the dense branch's mean of v


@pytest.mark.parametrize("op", ["mha", "std_causal", "gqa"])
def test_attention_ops_on_k7_match_reference_flash(k7_on_cpu, op):
    """MultiHeadAttention, ai.onnx Attention (4-D, causal, GQA heads) and
    GroupQueryAttention prefill (K/V repeated to the query heads with
    ``repeat_interleave``, causal, key mask from seqlens) through K7's
    wrapper, one call a node, against the JAX flash kernel in interpret
    mode on the same q/k/v (F32)."""
    n = _rng(32)
    B, S, Hq, Hkv, D = 2, 24, 4, 2, 32
    if op == "mha":
        q, k, v = n(B, S, Hq * D), n(B, S, Hq * D), n(B, S, Hq * D)
        m = (np.arange(S)[None, :] < np.array([S, 9])[:, None])
        data = _model([O.make_node("MultiHeadAttention",
                                   ["q", "k", "v", "", "m"], ["y"],
                                   num_heads=Hq, **MS)],
                      {"q": q, "k": k, "v": v, "m": m.astype(np.int32)})
        feeds = {"q": q, "k": k, "v": v, "m": m.astype(np.int32)}
        want = _ref_flash(*(_heads(t, B, S, Hq) for t in (q, k, v)), m,
                          False).transpose(0, 2, 1, 3).reshape(B, S, -1)
    elif op == "std_causal":
        q, k, v = n(B, Hq, S, D), n(B, Hkv, S, D), n(B, Hkv, S, D)
        feeds = {"q": q, "k": k, "v": v}
        data = _model([O.make_node("Attention", ["q", "k", "v"], ["y"],
                                   is_causal=1)], feeds, opset=23)
        want = _ref_flash(q, np.repeat(k, 2, 1), np.repeat(v, 2, 1), None,
                          True)
    else:
        q, k, v = n(B, S, Hq * D), n(B, S, Hkv * D), n(B, S, Hkv * D)
        sl = np.array([S - 1, 10], np.int32)
        feeds = {"q": q, "k": k, "v": v, "sl": sl,
                 "tl": np.array(S, np.int32)}
        data = _model([_gqa_node(["q", "k", "v", "", "", "sl", "tl"],
                                 num_heads=Hq, kv_num_heads=Hkv)], feeds)
        m = np.arange(S)[None, :] <= sl[:, None]
        want = _ref_flash(_heads(q, B, S, Hq),
                          np.repeat(_heads(k, B, S, Hkv), 2, 1),
                          np.repeat(_heads(v, B, S, Hkv), 2, 1), m, True)
        want = want.transpose(0, 2, 1, 3).reshape(B, S, -1)
    got = _port(data, feeds, ["y"])["y"]
    assert k7_on_cpu() == 1
    _f32_close(got, want)


def test_k7_route_rule():
    """The route: CPU tensors run dense (as the reference off the TPU);
    on CUDA tensors only Sq != Sk, a pair mask, a head dim K7 has no
    instantiation for, or a dtype other than f32/bf16 go dense."""
    q = torch.zeros(1, 2, 8, 64)
    assert pconv._k7_route(q, q, q, None) == "host"

    class Cuda:
        """Shape, dtype and device of a CUDA tensor, without a card."""
        def __init__(self, shape, dtype=torch.float32):
            self.shape, self.dtype = torch.Size(shape), dtype
            self.device = torch.device("cuda")

    def route(qs, ks=None, dtype=torch.float32, pair=None, vs=None):
        t = Cuda(qs, dtype)
        return pconv._k7_route(t, Cuda(ks or qs, dtype),
                               Cuda(vs or ks or qs, dtype), pair)

    assert route((2, 12, 512, 64)) is None
    assert route((2, 12, 512, 64), dtype=torch.bfloat16) is None
    assert route((2, 32, 512, 128)) is None
    assert route((2, 4, 1, 64), (2, 4, 9, 64)) == "sq != sk"
    assert route((2, 4, 8, 64), pair=object()) == "pair mask"
    assert route((2, 4, 8, 80)) == "head dim"
    assert route((2, 4, 8, 64), vs=(2, 4, 8, 32)) == "head dim"
    assert route((2, 4, 8, 64), dtype=torch.float16) == "dtype"


def test_dense_on_cuda_is_not_counted_for_host_tensors():
    pconv.dense_on_cuda.clear()
    q = torch.zeros(1, 2, 8, 32)
    pconv._attention_core(q, q, q, None, False, 1.0)
    assert not pconv.dense_on_cuda


@pytest.mark.parametrize("reason", ["head dim", "dtype"])
def test_attention_core_refuses_what_k7_lacks(monkeypatch, reason):
    """An attention the reference gives its flash kernel but K7 has no
    instantiation for raises, naming the ROADMAP item: it never runs the
    dense branch on the card."""
    monkeypatch.setattr(pconv, "_k7_route", lambda q, k, v, pair_mask: reason)
    pconv.dense_on_cuda.clear()
    q = torch.zeros(1, 2, 8, 80)
    with pytest.raises(NotImplementedError, match="second pass 6"):
        pconv._attention_core(q, q, q, None, False, 1.0)
    assert not pconv.dense_on_cuda


def test_gqa_decode_does_not_write_numpy_feeds():
    """GroupQueryAttention decode writes its cache in place: a CPU tensor
    fed as past is the present returned, a numpy array fed as past is
    left as it was."""
    r = np.random.default_rng(11)
    B, Hq, Hkv, D, S_max, S_past = 2, 4, 2, 4, 8, 3
    feeds = {n: r.normal(0, 1, (B, 1, h * D)).astype(np.float32)
             for n, h in (("q", Hq), ("k", Hkv), ("v", Hkv))}
    feeds.update(pk=np.zeros((B, Hkv, S_max, D), np.float32),
                 pv=np.zeros((B, Hkv, S_max, D), np.float32),
                 sl=np.full(B, S_past, np.int32),
                 tl=np.array(S_past + 1, np.int32))
    pm = O.convert_model(_model([_gqa_node(
        ["q", "k", "v", "pk", "pv", "sl", "tl"], ("y", "ok", "ov"),
        num_heads=Hq, kv_num_heads=Hkv)], feeds, outs=("y", "ok", "ov")))
    before = {k: v.copy() for k, v in feeds.items()}
    host = {k: v for k, v in feeds.items() if k not in ("q", "k", "v")}
    out = pm(pm.params, {**host, **{k: torch.from_numpy(feeds[k])
                                    for k in ("q", "k", "v")}})
    assert out["ok"].abs().sum() > 0
    for k, v in before.items():
        np.testing.assert_array_equal(feeds[k], v, err_msg=k)
    pk = torch.from_numpy(feeds["pk"].copy())
    out = pm(pm.params, {**{k: torch.from_numpy(v) for k, v in feeds.items()},
                         "pk": pk})
    assert out["ok"] is pk
