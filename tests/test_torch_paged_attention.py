"""Port parity: fused paged attention (``ops/paged_attention.py``).

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
reference runs its Pallas kernel in interpret mode (as
``tests/test_paged_attention.py`` does). Same numpy inputs, f32: ctx
within 1e-5 (online vs one-shot softmax reorders the sums), pages
bitwise apart from trash page 0. The kernel itself runs only on the
card: the ``cuda`` test below skips without one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu.ops import paged_attention as ref_pa
from mmlspark_tpu_torch.models.zoo import transformer as port_tf
from mmlspark_tpu_torch.ops import paged_attention as port_pa

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, H, W, hd, page, P):
    rng = np.random.default_rng(seed)
    N = 1 + B * P
    kp = rng.normal(0, 1, (N, H, page, hd)).astype(np.float32)
    vp = rng.normal(0, 1, (N, H, page, hd)).astype(np.float32)
    # rows own shuffled pages, so the block table really indirects
    perm = 1 + rng.permutation(B * P)
    bt = perm.reshape(B, P).astype(np.int32)
    q, kn, vn = (rng.normal(0, 1, (B, H, W, hd)).astype(np.float32)
                 for _ in range(3))
    return q, kn, vn, kp, vp, bt


def _run_both(q, kn, vn, kp, vp, bt, pos, active=None):
    want = ref_pa.paged_attention_window(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(bt), jnp.asarray(pos),
        active=None if active is None else jnp.asarray(active),
        interpret=True)
    kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = port_pa.paged_attention_window(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        kp_t, vp_t, torch.from_numpy(bt), torch.from_numpy(pos),
        active=None if active is None else torch.from_numpy(active))
    return want, got


@pytest.mark.parametrize("W", [1, 4, 16])
def test_plain_window_matches_reference(W):
    B, H, hd, page, P = 3, 2, 8, 4, 10
    q, kn, vn, kp, vp, bt = _inputs(W, B, H, W, hd, page, P)
    # mid-page, exact page boundary, and a fresh row at 0
    pos = np.array([7, 16, 0], np.int32)
    (ctx_w, kp_w, vp_w), (ctx_g, kp_g, vp_g) = _run_both(
        q, kn, vn, kp, vp, bt, pos)
    np.testing.assert_allclose(ctx_g.numpy(), np.asarray(ctx_w), **TOL)
    assert np.array_equal(kp_g.numpy()[1:], np.asarray(kp_w)[1:])
    assert np.array_equal(vp_g.numpy()[1:], np.asarray(vp_w)[1:])


def test_pools_update_in_place():
    q, kn, vn, kp, vp, bt = _inputs(5, 2, 2, 3, 8, 4, 3)
    kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    _, kp2, vp2 = port_pa.paged_attention_window(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        kp_t, vp_t, torch.from_numpy(bt), torch.tensor([2, 5], dtype=torch.int32))
    assert kp2 is kp_t and vp2 is vp_t
    assert not np.array_equal(kp_t.numpy(), kp)


def test_inactive_rows_touch_only_trash():
    B, H, W, hd, page, P = 2, 2, 2, 8, 4, 2
    q, kn, vn, kp, vp, bt = _inputs(9, B, H, W, hd, page, P)
    pos = np.array([3, 2], np.int32)
    active = np.array([True, False])
    (_, kp_w, _), (_, kp_g, vp_g) = _run_both(q, kn, vn, kp, vp, bt, pos,
                                              active)
    rows1 = bt[1]
    assert np.array_equal(kp_g.numpy()[rows1], kp[rows1])
    assert np.array_equal(vp_g.numpy()[rows1], vp[rows1])
    assert np.array_equal(kp_g.numpy()[1:], np.asarray(kp_w)[1:])
    assert not np.array_equal(kp_g.numpy()[bt[0]], kp[bt[0]])


def test_garbage_past_pos_never_reaches_ctx():
    """NaN in unwritten page slots (at or past pos) must not leak."""
    B, H, W, hd, page, P = 1, 2, 1, 8, 4, 3
    q, kn, vn, kp, vp, bt = _inputs(11, B, H, W, hd, page, P)
    pos = np.array([5], np.int32)
    kp[bt[0, 1], :, 1:] = np.nan        # positions 5..7
    vp[bt[0, 1], :, 1:] = np.nan
    kp[bt[0, 2]] = np.nan
    vp[bt[0, 2]] = np.nan
    ctx, _, _ = port_pa.paged_attention_window(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(bt),
        torch.from_numpy(pos))
    assert torch.isfinite(ctx).all()


def test_write_range_matches_reference_rule():
    pos = torch.tensor([0, 5, 15, 16], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    wlo, whi = port_pa.write_range(pos, 4, 8, active)
    assert wlo.tolist() == [0, 0, 1, 2] and whi.tolist() == [0, 1, 0, 2]


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "bt"])
def test_wrapper_checks_inputs(bad):
    q, kn, vn, kp, vp, bt = (torch.from_numpy(a) for a in
                             _inputs(1, 2, 2, 3, 8, 4, 3))
    pos = torch.tensor([1, 2], dtype=torch.int32)
    if bad == "dtype":
        kn = kn.double()
    elif bad == "shape":
        vn = vn[:, :, :2]
    elif bad == "contiguous":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        bt = bt[:1]
    with pytest.raises((TypeError, ValueError)):
        port_pa.paged_attention_window(q, kn, vn, kp, vp, bt, pos)


REF_CFG = ref_tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                                   d_ff=128, max_len=96, causal=True,
                                   norm="rmsnorm", position="rope",
                                   dtype=jnp.float32)
CFG = port_tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                                d_ff=128, max_len=96, causal=True,
                                norm="rmsnorm", position="rope",
                                dtype=torch.float32)


# the reference's eager dispatch is slow on the CPU; jit it once per shape
_ref_prefill = jax.jit(ref_tf.prefill_cache, static_argnames=("cfg", "max_len"))
_PAGED_STATIC = ("cfg", "page_size", "length", "impl")
_ref_step = jax.jit(ref_tf.decode_step_paged, static_argnames=_PAGED_STATIC)
_ref_window = jax.jit(ref_tf.decode_window_paged,
                      static_argnames=_PAGED_STATIC)


def _paged_state(B, L, page, steps, seed):
    """A reference prefill of ``steps`` tokens per row, scattered into
    pages."""
    p = ref_tf.init_transformer(REF_CFG, seed=0)
    jp = jax.tree.map(jnp.asarray, p)
    rng = np.random.default_rng(seed)
    ids = jnp.asarray(rng.integers(0, 128, (B, steps)), jnp.int32)
    _, cache = _ref_prefill(jp, ids, jnp.full((B,), steps, jnp.int32),
                            cfg=REF_CFG, max_len=L)
    n_pages = L // page
    bt = (1 + np.arange(B)[:, None] * n_pages
          + np.arange(n_pages)).astype(np.int32)
    pages = ref_tf.paged_scatter_rows(
        ref_tf.init_paged_cache(REF_CFG, 1 + B * n_pages, page), cache,
        jnp.asarray(bt), page)
    pages_np = [{kk: np.array(c[kk]) for kk in ("k", "v")} for c in pages]
    return p, jp, pages, pages_np, bt, rng


def _torch_pages(pages_np):
    return [{kk: torch.from_numpy(c[kk].copy()) for kk in ("k", "v")}
            for c in pages_np]


def test_decode_step_paged_kernel_vs_gather_and_reference():
    B, L, page = 3, 16, 4
    p, jp, pages, pages_np, bt, rng = _paged_state(B, L, page, 5, 0)
    tp = port_tf.params_from_numpy(p, CFG, device="cpu")
    tok = rng.integers(0, 128, B).astype(np.int32)
    pos = np.array([3, 4, 0], np.int32)
    want, want_pages = _ref_step(
        jp, jnp.asarray(tok), jnp.asarray(pos), pages, jnp.asarray(bt),
        cfg=REF_CFG, page_size=page, length=L, impl="kernel")
    outs = {}
    for impl in ("kernel", "gather"):
        outs[impl] = port_tf.decode_step_paged(
            tp, torch.from_numpy(tok), torch.from_numpy(pos),
            _torch_pages(pages_np), torch.from_numpy(bt), CFG,
            page_size=page, length=L, impl=impl)
    lk, pk = outs["kernel"]
    lg, pg = outs["gather"]
    np.testing.assert_allclose(lk.numpy(), lg.numpy(), **TOL)
    np.testing.assert_allclose(lk.numpy(), np.asarray(want), **TOL)
    assert np.array_equal(lk.numpy().argmax(-1), lg.numpy().argmax(-1))
    assert np.array_equal(lk.numpy().argmax(-1), np.asarray(want).argmax(-1))
    # layer 0's page writes: bitwise between the port's kernel and gather
    # paths (same projection inputs); within 1e-5 of the reference, whose
    # matmuls sum in another order; trash page 0 is excluded
    for kk in ("k", "v"):
        assert np.array_equal(pk[0][kk].numpy()[1:], pg[0][kk].numpy()[1:])
        np.testing.assert_allclose(pk[0][kk].numpy()[1:],
                                   np.asarray(want_pages[0][kk])[1:], **TOL)


@pytest.mark.parametrize("W", [1, 4, 16])
def test_decode_window_paged_kernel_vs_gather(W):
    B, L, page = 2, 64, 4
    p, jp, pages, pages_np, bt, rng = _paged_state(B, L, page, 20, W)
    tp = port_tf.params_from_numpy(p, CFG, device="cpu")
    wt = rng.integers(0, 128, (B, W)).astype(np.int32)
    pos = np.array([7, 0], np.int32)
    want, _ = _ref_window(
        jp, jnp.asarray(wt), jnp.asarray(pos), pages, jnp.asarray(bt),
        cfg=REF_CFG, page_size=page, length=L, impl="gather")
    got = {}
    for impl in ("kernel", "gather"):
        got[impl], _ = port_tf.decode_window_paged(
            tp, torch.from_numpy(wt), torch.from_numpy(pos),
            _torch_pages(pages_np), torch.from_numpy(bt), CFG,
            page_size=page, length=L, impl=impl)
    np.testing.assert_allclose(got["kernel"].numpy(), got["gather"].numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["gather"].numpy(), np.asarray(want), **TOL)
    assert np.array_equal(got["kernel"].numpy().argmax(-1),
                          np.asarray(want).argmax(-1))


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        port_tf.decode_step_paged(None, torch.zeros(1, dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32), [], None,
                                  CFG, page_size=4, length=4, impl="xla")


def _assert_window_ctx(got, want, r):
    """The bf16 window kernels (K1/K2 at W > 1, the tensor-core body)
    against their plain version: within 4e-3 + 1e-2 * |want| (the output's
    bf16 rounding, sums reordered) plus 2^-8 * R for the one rounding of
    each P (or P times the V scale) to bf16."""
    err = (got.float() - want.float()).abs()
    assert bool((err <= 4e-3 + 1e-2 * want.float().abs()
                 + 2.0 ** -8 * r).all()), float(err.max())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the hand-written kernel against its plain version at
    a full-width head shape, bf16 pages bitwise, ctx within bf16 rounding
    (plus the tensor-core body's bound: W = 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, H, W, hd, page, P = 4, 12, 8, 64, 16, 8
    q, kn, vn, kp, vp, bt = _inputs(0, B, H, W, hd, page, P)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev, torch.bfloat16)
            for a in (q, kn, vn, kp, vp)]
    bt_d = torch.from_numpy(bt).to(dev)
    pos = torch.tensor([0, 17, 63, 100], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, False, True], device=dev)
    wlo, whi = port_pa.write_range(pos, W, page, active)
    kp2, vp2 = args[3].clone(), args[4].clone()
    want = port_pa.paged_attention_window_plain(
        args[0], args[1], args[2], kp2, vp2, bt_d, pos, wlo, whi,
        1.0 / np.sqrt(hd))
    r = port_pa.paged_rounding_scale(*args, bt_d, pos)
    paw = port_pa.paged_attention_window
    mma0, split0 = paw.launches_mma, paw.launches_split
    got, kp1, vp1 = paw(*args, bt_d, pos, active=active)
    torch.cuda.synchronize()
    _assert_window_ctx(got, want, r)
    assert torch.equal(kp1[1:], kp2[1:]) and torch.equal(vp1[1:], vp2[1:])
    # the library reports the tensor-core body for a bf16 window, the
    # split decode body at W = 1
    assert (paw.launches_mma, paw.launches_split) == (mma0 + 1, split0)
    paw(*(a[:, :, :1].contiguous() for a in args[:3]), kp1, vp1, bt_d,
        pos, active=active)
    assert (paw.launches_mma, paw.launches_split) == (mma0 + 1, split0 + 1)


@pytest.mark.parametrize("quant", [False, True])
def test_cpu_window_counts_no_launch(quant):
    """The plain CPU path is no kernel launch: every counter stays put."""
    B, H, W, hd, page, P = 2, 2, 4, 16, 4, 3
    q, kn, vn, kp, vp, bt = (torch.from_numpy(a) for a in
                             _inputs(0, B, H, W, hd, page, P))
    kw = {}
    if quant:
        kp, ks = port_q.quantize_kv(kp, torch.int8)
        vp, vs = port_q.quantize_kv(vp, torch.int8)
        kw = {"k_scale": ks, "v_scale": vs}
    paw = port_pa.paged_attention_window
    names = ("launches", "launches_q", "launches_mma", "launches_q_mma",
             "launches_split", "launches_q_split", "launches_window",
             "launches_window_q", "launches_window_mma",
             "launches_window_q_mma", "launches_window_split",
             "launches_window_q_split")
    before = [getattr(paw, n) for n in names]
    ctx = paw(q, kn, vn, kp, vp, bt, torch.tensor([0, 5], dtype=torch.int32),
              **kw)[0]
    assert ctx.shape == q.shape and torch.isfinite(ctx).all()
    assert [getattr(paw, n) for n in names] == before


# ---- quantized pages (kv_quant, K2) and the read-only sweep (K3, K4) ----

from mmlspark_tpu.ops import kv_quant as ref_q  # noqa: E402
from mmlspark_tpu_torch.ops import kv_quant as port_q  # noqa: E402

KV_DTYPES = ["int8", "fp8"]


def _to_torch(a):
    """A numpy / jax array → torch, bit for bit (bf16 and fp8 included)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits_np(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _bits_t(t):
    return _bits_np(t.view({1: torch.uint8, 2: torch.int16,
                            4: torch.int32}[t.element_size()]).numpy())


def _quant_rows(kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (64, 3, 16)).astype(np.float32)
    if kind == "zero":
        x[::2] = 0.0
    elif kind == "qmax":
        # rows whose absmax element maps exactly onto the clip bound
        x[:, :, 5] = 127.0 * 2.0
        x[:, :, 6] = -448.0
    return x


@pytest.mark.parametrize("kind", ["random", "zero", "qmax"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quantize_kv_bitwise(kv_dtype, kind):
    x = _quant_rows(kind, 7)
    q_r, s_r = ref_q.quantize_kv(jnp.asarray(x), ref_q.kv_store_dtype(kv_dtype))
    q_p, s_p = port_q.quantize_kv(torch.from_numpy(x),
                                  port_q.kv_store_dtype(kv_dtype))
    assert q_p.dtype == port_q.kv_store_dtype(kv_dtype)
    assert s_p.dtype == port_q.SCALE_DTYPE and s_p.shape == x.shape[:-1]
    assert np.array_equal(_bits_t(q_p), _bits_np(q_r))
    assert np.array_equal(_bits_t(s_p), _bits_np(s_r))
    # the same rows given in bf16 quantize the same too
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    q_r, s_r = ref_q.quantize_kv(xb, ref_q.kv_store_dtype(kv_dtype))
    q_p, s_p = port_q.quantize_kv(_to_torch(xb),
                                  port_q.kv_store_dtype(kv_dtype))
    assert np.array_equal(_bits_t(q_p), _bits_np(q_r))
    assert np.array_equal(_bits_t(s_p), _bits_np(s_r))


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_dequantize_kv_bitwise(kv_dtype):
    q_r, s_r = ref_q.quantize_kv(jnp.asarray(_quant_rows("random", 8)),
                                 ref_q.kv_store_dtype(kv_dtype))
    for dt_r, dt_p in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        want = ref_q.dequantize_kv(q_r, s_r, dt_r)
        got = port_q.dequantize_kv(_to_torch(q_r), _to_torch(s_r), dt_p)
        assert np.array_equal(_bits_t(got), _bits_np(want))


@pytest.mark.parametrize("name", [None, "", "none", "bf16", "BFloat16",
                                  "int8", " INT8 ", "fp8", "float8",
                                  "float8_e4m3fn", "e4m3", "int4", "fp16",
                                  "e5m2"])
def test_resolve_kv_dtype_same_names(name):
    def outcome(mod):
        try:
            return mod.resolve_kv_dtype(name)
        except ValueError:
            return "rejected"
    assert outcome(port_q) == outcome(ref_q)
    canon = outcome(port_q)
    if canon in ("int8", "fp8"):
        store_p, store_r = port_q.kv_store_dtype(canon), \
            ref_q.kv_store_dtype(canon)
        assert port_q.kv_qmax(store_p) == ref_q.kv_qmax(store_r)
        assert (port_q.kv_bytes_per_position(12, 64, store_p, True)
                == ref_q.kv_bytes_per_position(12, 64, store_r, True))
    assert (port_q.kv_bytes_per_position(12, 64, torch.bfloat16, False)
            == ref_q.kv_bytes_per_position(12, 64, jnp.bfloat16, False))


def _quant_pools(seed, N, H, page, hd, kv_dtype):
    """Quantized pools made by the reference quantizer: (codes, scales)
    for K and V as jax arrays."""
    rng = np.random.default_rng(seed)
    store = ref_q.kv_store_dtype(kv_dtype)
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.normal(0, 1, (N, H, page, hd)), jnp.float32)
        out.extend(ref_q.quantize_kv(x, store))
    kp, ks, vp, vs = out
    return kp, vp, ks, vs


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("W", [1, 4, 16])
def test_plain_quant_window_matches_reference(W, kv_dtype):
    B, H, hd, page, P = 3, 2, 8, 8, 5
    q, kn, vn, _, _, bt = _inputs(W, B, H, W, hd, page, P)
    kp, vp, ks, vs = _quant_pools(W + 1, 1 + B * P, H, page, hd, kv_dtype)
    # mid-page, exact page boundary, and a fresh row at 0 (inactive)
    pos = np.array([7, 16, 0], np.int32)
    active = np.array([True, True, False])
    want = ref_pa.paged_attention_window(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), kp, vp,
        jnp.asarray(bt), jnp.asarray(pos), active=jnp.asarray(active),
        k_scale=ks, v_scale=vs, interpret=True)
    pools = [_to_torch(a) for a in (kp, vp, ks, vs)]
    before = [t.clone() for t in pools]
    got = port_pa.paged_attention_window(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        pools[0], pools[1], torch.from_numpy(bt), torch.from_numpy(pos),
        active=torch.from_numpy(active), k_scale=pools[2], v_scale=pools[3])
    assert len(got) == 5 and all(g is p for g, p in zip(got[1:], pools))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(_bits_t(g)[1:], _bits_np(w)[1:])
    # the inactive row touched nothing but (perhaps) the trash page
    rows = bt[2]
    for g, b in zip(pools, before):
        assert np.array_equal(_bits_t(g)[rows], _bits_t(b)[rows])
    # the fresh rows landed quantized, with their scales
    for g, b in zip(pools, before):
        assert not np.array_equal(_bits_t(g)[bt[0]], _bits_t(b)[bt[0]])


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_quant_garbage_past_pos_never_reaches_ctx(kv_dtype):
    """NaN scales (and NaN fp8 codes) at or past pos must not leak."""
    B, H, W, hd, page, P = 1, 2, 1, 8, 4, 3
    q, kn, vn, _, _, bt = _inputs(11, B, H, W, hd, page, P)
    pools = [_to_torch(a) for a in _quant_pools(3, 1 + B * P, H, page, hd,
                                                 kv_dtype)]
    kp, vp, ks, vs = pools
    for s in (ks, vs):
        s[bt[0, 1], :, 1:] = float("nan")           # positions 5..7
        s[bt[0, 2]] = float("nan")
    if kv_dtype == "fp8":
        for c in (kp, vp):
            c.view(torch.uint8)[bt[0, 1], :, 1:] = 0x7F
    ctx = port_pa.paged_attention_window(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        kp, vp, torch.from_numpy(bt), torch.tensor([5], dtype=torch.int32),
        k_scale=ks, v_scale=vs)[0]
    assert torch.isfinite(ctx).all()
    lens = torch.tensor([5], dtype=torch.int32)
    out = port_pa.paged_attention(torch.from_numpy(q), kp, vp,
                                  torch.from_numpy(bt), lens,
                                  k_scale=ks, v_scale=vs)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("kv_dtype", [None] + KV_DTYPES)
@pytest.mark.parametrize("W", [1, 5])
def test_plain_read_matches_reference(W, kv_dtype):
    B, H, hd, page, P = 4, 2, 8, 4, 6
    q, _, _, kp, vp, bt = _inputs(20 + W, B, H, W, hd, page, P)
    lengths = np.array([0, 1, 9, 24], np.int32)      # 0 gives zeros
    if kv_dtype is None:
        pools_j = [jnp.asarray(kp), jnp.asarray(vp)]
        kw_j = {}
    else:
        kp_j, vp_j, ks, vs = _quant_pools(W, 1 + B * P, H, page, hd,
                                          kv_dtype)
        pools_j = [kp_j, vp_j]
        kw_j = {"k_scale": ks, "v_scale": vs}
    want = ref_pa.paged_attention(jnp.asarray(q), *pools_j, jnp.asarray(bt),
                                  jnp.asarray(lengths), interpret=True,
                                  **kw_j)
    kw_t = {k: _to_torch(v) for k, v in kw_j.items()}
    pools_t = [_to_torch(a) for a in pools_j]
    got = port_pa.paged_attention(torch.from_numpy(q), *pools_t,
                                  torch.from_numpy(bt),
                                  torch.from_numpy(lengths), **kw_t)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("bad", ["one_scale", "scale_dtype", "scale_shape",
                                 "pool_dtype", "unscaled_int8"])
def test_quant_wrapper_checks_inputs(bad):
    q, kn, vn, _, _, bt = (torch.from_numpy(a) for a in
                           _inputs(1, 2, 2, 3, 8, 4, 3))
    kp, vp, ks, vs = (_to_torch(a) for a in _quant_pools(1, 7, 2, 4, 8,
                                                         "int8"))
    pos = torch.tensor([1, 2], dtype=torch.int32)
    kw = {"k_scale": ks, "v_scale": vs}
    if bad == "one_scale":
        kw = {"k_scale": ks}
    elif bad == "scale_dtype":
        kw["v_scale"] = vs.float()
    elif bad == "scale_shape":
        kw["k_scale"] = ks[:, :, :2].contiguous()
    elif bad == "pool_dtype":
        kp = kp.float()
    else:
        kw = {}
    with pytest.raises((TypeError, ValueError)):
        port_pa.paged_attention_window(q, kn, vn, kp, vp, bt, pos, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_cuda_quant_kernels_match_plain_version(kv_dtype):
    """On the card: K2 and K4 against their plain versions at a full-width
    head shape, pages and scales bitwise, ctx within bf16 rounding (K2
    plus the tensor-core body's bound: W = 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    B, H, W, hd, page, P = 4, 12, 8, 64, 16, 8
    q, kn, vn, _, _, bt = _inputs(0, B, H, W, hd, page, P)
    dev = torch.device("cuda")
    act = [torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, kn, vn)]
    pools = [_to_torch(a).to(dev) for a in
             _quant_pools(0, 1 + B * P, H, page, hd, kv_dtype)]
    bt_d = torch.from_numpy(bt).to(dev)
    pos = torch.tensor([0, 17, 63, 100], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, False, True], device=dev)
    wlo, whi = port_pa.write_range(pos, W, page, active)
    plain = [t.clone() for t in pools]
    want = port_pa.paged_attention_window_plain(
        *act, plain[0], plain[1], bt_d, pos, wlo, whi, 1.0 / np.sqrt(hd),
        plain[2], plain[3])
    r = port_pa.paged_rounding_scale(*act, pools[0], pools[1], bt_d, pos,
                                     k_scale=pools[2], v_scale=pools[3])
    got = port_pa.paged_attention_window(
        *act, pools[0], pools[1], bt_d, pos, active=active,
        k_scale=pools[2], v_scale=pools[3])
    torch.cuda.synchronize()
    _assert_window_ctx(got[0], want, r)
    for g, w in zip(pools, plain):
        assert np.array_equal(_bits_t(g.cpu())[1:], _bits_t(w.cpu())[1:])
    want = port_pa.paged_attention_plain(act[0], *pools[:2], bt_d, pos,
                                         1.0 / np.sqrt(hd), *pools[2:])
    got = port_pa.paged_attention(act[0], *pools[:2], bt_d, pos,
                                  k_scale=pools[2], v_scale=pools[3])
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=1e-2, atol=4e-3)


# ---- the bf16 window body's error bound (K1, K2 at W > 1) ----------------

STORES = ["bf16"] + KV_DTYPES


def _rounding_inputs(store, seed, W=40, hd=16, page=8):
    """Window inputs on the CPU: f32 q / k_new / v_new holding bf16 values
    (what the card's kernels take), bf16 or quantized pools with NaN
    planted at and past each row's pos, a shuffled block table, rows at
    pos 0, an unaligned pos and a later one, the last row inactive."""
    B, H = 3, 2
    pos = torch.tensor([0, 13, 45], dtype=torch.int32)
    P = (int(pos.max()) + W + page - 1) // page
    q, kn, vn, kp, vp, bt = _inputs(seed, B, H, W, hd, page, P)
    q, kn, vn = (torch.from_numpy(a).bfloat16().float() for a in (q, kn, vn))
    kp, vp, bt = torch.from_numpy(kp), torch.from_numpy(vp), \
        torch.from_numpy(bt)
    if store == "bf16":
        pools = [kp.bfloat16(), vp.bfloat16()]
    else:
        dt = port_q.kv_store_dtype(store)
        (kc, ks), (vc, vs) = port_q.quantize_kv(kp, dt), \
            port_q.quantize_kv(vp, dt)
        pools = [kc, vc, ks, vs]
    for b in range(B):
        dead = torch.arange(P * page) >= int(pos[b])
        pg, off = bt[b, torch.arange(P * page)[dead] // page].long(), \
            torch.arange(P * page)[dead] % page
        for t in pools[2:] if store != "bf16" else pools:
            t[pg, :, off] = float("nan")
    active = torch.tensor([True, True, False])
    return q, kn, vn, pools, bt, pos, active


def _nonneg_v(vn, pools):
    """The same inputs with every V value (fresh rows, cached codes and
    scales) made >= 0."""
    pools = list(pools)
    v = pools[1]
    pools[1] = ((v.view(torch.uint8) & 0x7F).view(v.dtype)
                if v.dtype == torch.float8_e4m3fn else v.abs())
    if len(pools) == 4:
        pools[3] = pools[3].abs()
    return vn.abs(), pools


@pytest.mark.parametrize("store", STORES)
def test_paged_rounding_scale_bounds_ctx(store):
    """R bounds |ctx| elementwise (the plain context with V's signs);
    with every V >= 0 it is the plain context itself, bit for bit. Rows
    at pos 0, at an unaligned pos and inactive included."""
    q, kn, vn, pools, bt, pos, active = _rounding_inputs(store, 50)
    page = pools[0].shape[2]
    wlo, whi = port_pa.write_range(pos, q.shape[2], page, active)
    scale = q.shape[-1] ** -0.5
    before = [t.clone() for t in pools]
    r = port_pa.paged_rounding_scale(q, kn, vn, pools[0], pools[1], bt, pos,
                                     k_scale=(pools[2:] or [None])[0],
                                     v_scale=(pools[3:] or [None])[0])
    assert r.dtype == torch.float32 and r.shape == q.shape
    assert all(np.array_equal(_bits_t(a), _bits_t(b), equal_nan=False)
               for a, b in zip(pools, before))       # pools only read
    plain = [t.clone() for t in pools]
    ctx = port_pa.paged_attention_window_plain(q, kn, vn, plain[0], plain[1],
                                               bt, pos, wlo, whi, scale,
                                               *plain[2:])
    assert torch.isfinite(r).all() and torch.isfinite(ctx).all()
    assert bool((ctx.abs() <= r + 1e-6 * r.max()).all())
    vn_pos, pools_pos = _nonneg_v(vn, pools)
    r_pos = port_pa.paged_rounding_scale(
        q, kn, vn_pos, pools_pos[0], pools_pos[1], bt, pos,
        k_scale=(pools_pos[2:] or [None])[0],
        v_scale=(pools_pos[3:] or [None])[0])
    ctx_pos = port_pa.paged_attention_window_read_plain(
        q, kn, vn_pos, pools_pos[0], pools_pos[1], bt, pos, scale,
        *pools_pos[2:])
    assert torch.equal(r_pos, ctx_pos)


def _bf16_window_emulation(q, kn, vn, pools, bt, pos, scale, tile=32):
    """The tensor-core body's arithmetic in plain PyTorch: an online f32
    softmax over 32-key tiles (the cached keys below pos, then the window
    keys under the causal mask), each tile's p times its keys' V scales
    (1 for bf16 rows) rounded to bf16 once before the product with the V
    rows (codes, for quantized pages); l sums the unrounded p."""
    B, H, W, hd = q.shape
    page = pools[0].shape[2]
    L = bt.shape[1] * page
    key_ok = torch.arange(L)[None] < pos.long()[:, None]          # (B, L)
    scales = pools[2:] or [None, None]
    kc = torch.where(key_ok[:, None, :, None],
                     port_pa._gather_rows(pools[0], scales[0], bt.long()),
                     0.0)
    vcode = torch.where(key_ok[:, None, :, None],
                        port_pa._gather_rows(pools[1], None, bt.long()), 0.0)
    if scales[1] is None:
        sv = torch.ones(B, H, L)
    else:
        g = scales[1][bt.long()].float()                   # (B, P, H, page)
        sv = g.permute(0, 2, 1, 3).reshape(B, H, L)
    sv = torch.where(key_ok[:, None, :], sv, 0.0)
    causal = torch.tril(torch.ones(W, W, dtype=torch.bool))
    parts = [(torch.einsum("bhwd,bhkd->bhwk", q, kc) * scale,
              key_ok[:, None, None, :].expand(B, H, W, L), sv, vcode),
             (torch.einsum("bhwd,bhkd->bhwk", q, kn) * scale,
              causal[None, None].expand(B, H, W, W), torch.ones(B, H, W), vn)]
    m = torch.full((B, H, W, 1), -1e30)
    l_ = torch.zeros(B, H, W, 1)
    acc = torch.zeros(B, H, W, hd)
    for s, ok, svk, vk in parts:
        for k0 in range(0, s.shape[-1], tile):
            st = torch.where(ok[..., k0:k0 + tile], s[..., k0:k0 + tile],
                             -1e30)
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(st - m_new) * ok[..., k0:k0 + tile]
            l_ = corr * l_ + p.sum(-1, keepdim=True)
            pv = (p * svk[:, :, None, k0:k0 + tile]).bfloat16().float()
            acc = corr * acc + pv @ vk[:, :, k0:k0 + tile]
            m = m_new
    return acc / torch.where(l_ == 0, 1.0, l_)


@pytest.mark.parametrize("store", STORES)
def test_bf16_window_rounding_stays_within_the_bound(store):
    """The bf16 window body's rounding, emulated in plain PyTorch: P (K1)
    or P · sv (K2) rounded to bf16 once per 32-key tile stays within
    2^-8 * R (plus 1e-6 * max|ctx| for the f32 sums' order) of the f32
    plain context, and the rounding does move it."""
    q, kn, vn, pools, bt, pos, _ = _rounding_inputs(store, 51)
    scale = q.shape[-1] ** -0.5
    want = port_pa.paged_attention_window_read_plain(
        q, kn, vn, pools[0], pools[1], bt, pos, scale, *pools[2:])
    r = port_pa.paged_rounding_scale(q, kn, vn, pools[0], pools[1], bt, pos,
                                     k_scale=(pools[2:] or [None])[0],
                                     v_scale=(pools[3:] or [None])[0])
    got = _bf16_window_emulation(q, kn, vn, pools, bt, pos, scale)
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= 2.0 ** -8 * r + 1e-6 * want.abs().max()).all()), \
        float(err.max())
    assert float(err.max()) > 0.0       # the rounding did happen
