"""The port's flash attention (``mmlspark_tpu_torch/ops/flash_attention.py``)
against the JAX package's, on the CPU.

The same numpy-seeded q/k/v go through the reference's Pallas kernels (in
interpret mode, auto-selected off the TPU, as ``tests/test_flash_attention.py``
runs them) and through the port's public functions, which on CPU tensors
run the plain versions of K7 and K8a/K8b. Forward outputs and the softmax
stats agree within 2e-5 (the reference's own flash tests' tolerance: the
online softmax and the dense plain version sum in another order);
gradients within 2e-4 (its gradient tests' tolerance). The CUDA kernels
are held against the plain versions on the card only (``cuda`` marker).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.ops.flash_attention import flash_attention as ref_flash
from mmlspark_tpu.ops.flash_attention import flash_attention_with_stats as ref_stats
from mmlspark_tpu_torch.ops import flash_attention as port

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, B=2, H=2, S=128, D=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (B, H, S, D)).astype(np.float32)
            for _ in range(3)]


def _mask(seed, B, S, p=0.3):
    return np.random.default_rng(seed).random((B, S)) > p


def _holes(seed, B, S):
    """A non-prefix mask: ``_mask`` with keys 64 ... 127 (one whole 64-key
    tile of the CUDA kernels) masked in every row, and the last row masked
    whole."""
    mask = _mask(seed, B, S)
    mask[:, 64:128] = False
    mask[-1] = False
    return mask


def _case_mask(c, seed, B, p=0.3):
    if c.get("mask") == "holes":
        return _holes(seed, B, c["S"])
    return _mask(seed, B, c["S"], p) if c.get("mask") else None


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


FWD_CASES = {
    "full": dict(S=128, D=32),
    "causal": dict(S=128, D=32, causal=True),
    "kv_mask": dict(S=128, D=32, mask=True),
    "causal_mask": dict(S=128, D=64, causal=True, mask=True),
    "unaligned_200": dict(S=200, D=32, mask=True),
    "short_48_d32": dict(S=48, D=32),
    "holes": dict(S=192, D=32, mask="holes"),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_matches_reference(case):
    c = FWD_CASES[case]
    q, k, v = _qkv(len(case), S=c["S"], D=c["D"])
    causal = c.get("causal", False)
    mask = _case_mask(c, 7, 2)
    want = np.asarray(ref_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask)))
    before = (port.flash_attention.launches,
              port.flash_attention_plain.calls)
    got = port.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               kv_mask=None if mask is None else _t(mask))
    assert got.shape == q.shape and got.dtype == torch.float32
    # the CPU path is the plain version, never a launch
    assert port.flash_attention.launches == before[0]
    assert port.flash_attention_plain.calls == before[1] + 1
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_fully_masked_row_gives_zero_and_zero_stats():
    """A batch element whose keys are all masked: o == 0 exactly (not
    NaN, not the mean of v), l == 0, m == -1e30, as the reference."""
    q, k, v = _qkv(3, S=64)
    mask = _mask(4, 2, 64)
    mask[1] = False
    o = port.flash_attention(_t(q), _t(k), _t(v), kv_mask=_t(mask))
    want = np.asarray(ref_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(mask)))
    assert np.all(o[1].numpy() == 0.0)
    np.testing.assert_allclose(o.numpy(), want, **FWD_TOL)
    _, l, m = port.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask))
    assert np.all(l[1].numpy() == 0.0) and np.all(m[1].numpy() == -1e30)


def test_nan_in_masked_key_rows_stays_out():
    """NaN stored in padded key/value rows changes nothing: forward and
    every gradient stay finite and equal to the clean input's."""
    q, k, v = _qkv(5, S=64)
    mask = np.ones((2, 64), bool)
    mask[:, 50:] = False
    kn, vn = k.copy(), v.copy()
    kn[:, :, 50:] = np.nan
    vn[:, :, 50:] = np.nan
    outs = []
    for kk, vv in ((k, v), (kn, vn)):
        qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, kk, vv))
        o = port.flash_attention(qt, kt, vt, kv_mask=_t(mask))
        (o * _t(q)).sum().backward()
        outs.append([o.detach(), qt.grad, kt.grad[:, :, :50],
                     vt.grad[:, :, :50]])
    for a, b in zip(*outs):
        assert torch.isfinite(b).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_with_stats_matches_reference():
    for seed, (S, D) in enumerate([(128, 32), (200, 64), (48, 32)]):
        q, k, v = _qkv(10 + seed, S=S, D=D)
        wo, wl, wm = (np.asarray(x) for x in ref_stats(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
        o, l, m = port.flash_attention_with_stats(_t(q), _t(k), _t(v))
        assert l.dtype == m.dtype == torch.float32
        assert l.shape == m.shape == q.shape[:3]
        np.testing.assert_allclose(o.numpy(), wo, **FWD_TOL)
        np.testing.assert_allclose(l.numpy(), wl, **FWD_TOL)
        np.testing.assert_allclose(m.numpy(), wm, **FWD_TOL)


GRAD_CASES = {
    "full": dict(S=128, D=32),
    "causal_mask": dict(S=128, D=32, causal=True, mask=True),
    "mask": dict(S=128, D=32, mask=True),
    "unaligned_mask": dict(S=200, D=32, mask=True),
    "causal_unaligned_d64": dict(S=72, D=64, causal=True),
    "holes": dict(S=192, D=32, mask="holes", B=2),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradients_match_reference(case):
    """jax.grad through the reference's custom VJP (Pallas dK/dV and dQ
    kernels in interpret mode) against torch.autograd through the port's
    (plain K8a/K8b on the CPU)."""
    c = GRAD_CASES[case]
    B = c.get("B", 1)
    q, k, v = _qkv(20 + len(case), B=B, S=c["S"], D=c["D"])
    causal = c.get("causal", False)
    mask = _case_mask(c, 21, B, 0.2)
    ct = np.random.default_rng(22).normal(0, 1, q.shape).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jnp.sum(ref_flash(q, k, v, causal=causal,
                                           kv_mask=jmask) * ct)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    before = port.flash_attention_bwd_plain.calls
    o = port.flash_attention(*ts, causal=causal,
                             kv_mask=None if mask is None else _t(mask))
    (o * _t(ct)).sum().backward()
    assert port.flash_attention_bwd_plain.calls == before + 1
    for t, w, name in zip(ts, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **GRAD_TOL)


def test_bwd_plain_matches_autograd_of_plain_forward():
    """The blockwise recompute equals autograd through the plain forward
    (f32, ragged mask with one fully masked row, causal), for any key
    block size."""
    q, k, v = (_t(a) for a in _qkv(30, B=2, S=96, D=32))
    mask = _t(_mask(31, 2, 96))
    mask[1] = False
    do = _t(np.random.default_rng(32).normal(size=q.shape).astype(
        np.float32))
    for causal in (False, True):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o, l, m = port.flash_attention_plain(*ts, mask, causal=causal)
        grads = torch.autograd.grad((o * do).sum(), ts)
        for bk in (32, 40, 512):
            got = port.flash_attention_bwd_plain(
                q, k, v, mask, o.detach(), l.detach(), m.detach(), do,
                causal=causal, block_k=bk)
            for a, b in zip(got, grads):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        # the fully masked batch element gets exactly zero gradients
        assert all(float(g[1].abs().max()) == 0.0 for g in got)


def test_bf16_rounding_scale_bounds_the_plain_outputs():
    """R of the bf16 bound is each output over absolute values: it bounds
    |o|, |dQ|, |dK| and |dV| elementwise, equals o where v >= 0 and dV
    where dO >= 0, and is 0 on a fully masked row."""
    q, k, v = (_t(a) for a in _qkv(33, B=2, S=96, D=32))
    mask = _t(_holes(34, 2, 96))
    do = _t(np.random.default_rng(35).normal(size=q.shape).astype(
        np.float32))
    for causal in (False, True):
        o, l, m = port.flash_attention_plain(q, k, v, mask, causal=causal)
        dq, dk, dv = port.flash_attention_bwd_plain(q, k, v, mask, o, l, m,
                                                    do, causal=causal)
        r_o, r_dq, r_dk, r_dv = port.bf16_rounding_scale(
            q, k, v, mask, o, l, m, do, causal=causal)
        for r, x in ((r_o, o), (r_dq, dq), (r_dk, dk), (r_dv, dv)):
            assert r.dtype == torch.float32
            assert bool((x.abs() <= r * (1 + 1e-6) + 1e-7).all())
            assert float(r[1].abs().max()) == 0.0
        pos_o = port.flash_attention_plain(q, k, v.abs(), mask,
                                           causal=causal)[0]
        r_o2 = port.bf16_rounding_scale(q, k, v.abs(), mask, o, l, m, do,
                                        causal=causal)[0]
        torch.testing.assert_close(r_o2, pos_o, rtol=0, atol=0)
        dv_pos = port.flash_attention_bwd_plain(q, k, v, mask, o, l, m,
                                                do.abs(), causal=causal)[2]
        torch.testing.assert_close(r_dv, dv_pos, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_dq_with_bf16_ds_stays_within_the_bound(causal):
    """The bf16 K8b's rounding, emulated in plain PyTorch: dS rounded to
    bf16 once per key block before ``dS @ K`` stays within 2^-8 * r_dq
    (plus 1e-6 * max|dq| for the f32 sums' order) of the f32 dQ, with a
    non-prefix mask and a fully masked row; that row's dQ is exactly 0."""
    q, k, v = (_t(a) for a in _qkv(36, B=2, S=192, D=32))
    mask = _t(_holes(37, 2, 192))
    do = _t(np.random.default_rng(38).normal(size=q.shape).astype(
        np.float32))
    o, l, m = port.flash_attention_plain(q, k, v, mask, causal=causal)
    want = port.flash_attention_bwd_plain(q, k, v, mask, o, l, m, do,
                                          causal=causal)[0]
    r_dq = port.bf16_rounding_scale(q, k, v, mask, o, l, m, do,
                                    causal=causal)[1]
    got = torch.zeros_like(want)
    for _, _, _, _, kj, _, ds in port._bwd_blocks(
            q, k, v, mask, o, l, m, do, causal, 32 ** -0.5, 64):
        got += ds.to(torch.bfloat16).float() @ kj
    err = (got - want).abs()
    assert bool((err <= 2.0 ** -8 * r_dq
                 + 1e-6 * want.abs().max()).all()), float(err.max())
    assert float(err.max()) > 0.0       # the rounding did happen
    assert float(got[1].abs().max()) == 0.0


def test_bf16_io_keeps_dtype():
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(40, S=64))
    o = port.flash_attention(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16
    want = port.flash_attention(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(o.float(), want, rtol=1e-2, atol=1e-2)
    qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    port.flash_attention(*qs).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in qs)


def test_no_grad_forward_skips_the_vjp():
    """Without grad the forward runs once without stats; with grad the
    autograd function saves the stats for the backward."""
    q, k, v = (_t(a) for a in _qkv(41, S=64))
    o = port.flash_attention(q, k, v)
    assert o.grad_fn is None
    qg = q.clone().requires_grad_(True)
    o2 = port.flash_attention(qg, k, v)
    assert type(o2.grad_fn).__name__ == "_FlashBackward"
    torch.testing.assert_close(o, o2.detach(), rtol=0, atol=0)
    with torch.no_grad():
        assert port.flash_attention(qg, k, v).grad_fn is None


@pytest.mark.parametrize("bad", ["head_dim", "dtype_mix", "dtype_f16",
                                 "noncontig", "mask_shape", "mask_float",
                                 "shape", "block_q", "block_k_bool"])
def test_check_rejects_what_the_kernels_do_not_take(bad):
    q, k, v = (_t(a) for a in _qkv(50, S=32))
    kw = {}
    if bad == "head_dim":
        q, k, v = (_t(a) for a in _qkv(50, S=32, D=48))
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif bad == "dtype_f16":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "noncontig":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "mask_shape":
        kw["kv_mask"] = torch.ones(2, 31, dtype=torch.bool)
    elif bad == "mask_float":
        kw["kv_mask"] = torch.ones(2, 32)
    elif bad == "shape":
        v = v[:, :, :16].contiguous()
    elif bad == "block_q":
        kw["block_q"] = 0
    else:
        kw["block_k"] = True
    with pytest.raises((TypeError, ValueError)):
        port.flash_attention(q, k, v, **kw)


def test_integer_mask_and_block_args_are_accepted():
    q, k, v = (_t(a) for a in _qkv(51, S=48))
    mask = _t(_mask(52, 2, 48))
    a = port.flash_attention(q, k, v, kv_mask=mask, block_q=16, block_k=96)
    b = port.flash_attention(q, k, v, kv_mask=mask.to(torch.int32))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sharded_is_not_ported():
    q, k, v = (_t(a) for a in _qkv(53, S=32))
    with pytest.raises(NotImplementedError, match="slice 6"):
        port.flash_attention_sharded(q, k, v, mesh=None)


def test_attention_pairs_counts_valid_pairs():
    mask = torch.tensor([[1, 1, 0, 1], [0, 0, 0, 0]], dtype=torch.bool)
    assert port.attention_pairs(None, 2, 4, False) == 2 * 16
    assert port.attention_pairs(None, 1, 4, True) == 10
    assert port.attention_pairs(mask, 2, 4, False) == 3 * 4
    # causal: query i sees valid keys j <= i: 1 + 2 + 2 + 3
    assert port.attention_pairs(mask, 2, 4, True) == 8


def _within_bf16_bound(got, want, rel=None):
    """bf16 ``got`` against the f32 plain result ``want``: within 2 bf16
    ulps of ``want`` plus 1e-5 * max|want|, plus 2^-8 * ``rel`` where
    given (``bf16_rounding_scale``: the bf16 K7, K8a and K8b round each P
    and dS to bf16 once before a tensor-core product, and 2^-8 is bf16's
    unit roundoff)."""
    want = want.float()
    mag = want.abs().clamp_min(2.0 ** -126)
    allowed = (2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
               + 1e-5 * want.abs().max())
    if rel is not None:
        allowed = allowed + 2.0 ** -8 * rel
    bad = (got.float() - want).abs() > allowed
    assert torch.isfinite(got).all() and not bad.any(), int(bad.sum())


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: K7 (with and without stats), K8a and K8b against their
    plain versions, f32 and bf16, head dims 32/64/128, causal and masked,
    unaligned S, a fully masked row and NaN past the mask, non-prefix
    masks with a whole masked 64-key tile (the bf16 kernels skip it), and
    the training path's unmasked, non-causal bf16 case. f32 within 1e-5
    (forward) and 1e-4 (gradients); bf16 within ``_within_bf16_bound`` of
    the plain versions run in f32 on the same values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for seed, (B, H, S, D, causal, dt, masked) in enumerate(
            [(2, 3, 200, 32, False, torch.float32, "random"),
             (2, 2, 256, 64, True, torch.bfloat16, "random"),
             (1, 2, 130, 128, False, torch.float32, "random"),
             (2, 2, 128, 64, True, torch.float32, "random"),
             (2, 3, 192, 64, False, torch.bfloat16, None),
             (2, 2, 192, 64, False, torch.bfloat16, "holes"),
             (3, 2, 200, 128, True, torch.bfloat16, "holes"),
             (2, 2, 130, 32, True, torch.bfloat16, "random")]):
        g = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=dev)
                       .to(dt) for _ in range(4))
        mask = None
        if masked:
            mask = torch.rand(B, S, generator=g, device=dev) > 0.2
            if masked == "holes":
                mask[:, 64:128] = False
            mask[-1] = False
            for b in range(B):
                k[b, :, ~mask[b]] = float("nan")
                v[b, :, ~mask[b]] = float("nan")
        before = (port.flash_attention.launches,
                  port.flash_attention.launches_dkv,
                  port.flash_attention.launches_dq)
        o, l, m = port._fwd_kernel(q, k, v, mask, causal, D ** -0.5, True)
        o0 = port.flash_attention(q, k, v, kv_mask=mask, causal=causal)
        torch.testing.assert_close(o0, o, rtol=0, atol=0)
        f32 = [t.float() for t in (q, k, v)]
        wo, wl, wm = port.flash_attention_plain(*f32, mask, causal=causal)
        torch.testing.assert_close(l, wl, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(m, wm, rtol=1e-5, atol=1e-5)
        assert not masked or float(o[-1].float().abs().max()) == 0.0
        got = port._bwd_kernel(q, k, v, mask, o, l, m, do, causal,
                               D ** -0.5)
        want = port.flash_attention_bwd_plain(
            *f32, mask, o.float(), l, m, do.float(), causal=causal)
        for a in got:
            assert torch.isfinite(a).all()
        if dt == torch.float32:
            torch.testing.assert_close(o, wo, rtol=1e-5, atol=1e-5)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        else:
            r_o, r_dq, r_dk, r_dv = port.bf16_rounding_scale(
                *f32, mask, o.float(), l, m, do.float(), causal=causal)
            _within_bf16_bound(o, wo, r_o)
            _within_bf16_bound(got[0], want[0], r_dq)
            _within_bf16_bound(got[1], want[1], r_dk)
            _within_bf16_bound(got[2], want[2], r_dv)
        torch.cuda.synchronize()
        assert (port.flash_attention.launches,
                port.flash_attention.launches_dkv,
                port.flash_attention.launches_dq) == (
                    before[0] + 2, before[1] + 1, before[2] + 1)
