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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the hand-written kernel against its plain version at
    a full-width head shape, bf16 pages bitwise, ctx within bf16 rounding."""
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
    got, kp1, vp1 = port_pa.paged_attention_window(
        *args, bt_d, pos, active=active)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=1e-2, atol=4e-3)
    assert torch.equal(kp1[1:], kp2[1:]) and torch.equal(vp1[1:], vp2[1:])
