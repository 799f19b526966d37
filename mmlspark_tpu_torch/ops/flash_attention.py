"""Flash attention (counterpart of ``ops/flash_attention.py``).

Streaming-softmax attention over (B, H, S, D) q/k/v with an optional
(B, S) key-validity mask (True = attend; one row per batch element,
broadcast over heads) and an optional causal mask. A query row whose keys
are all masked gives 0, not NaN, and its stats are l = 0, m = -1e30.

=============================  =========================================
:func:`flash_attention`         differentiable; K7 forward and K8a/K8b
                                backward on CUDA tensors (hand-written
                                CUDA C++, ``csrc/flash_attention.cu``),
                                the plain versions on CPU tensors
:func:`flash_attention_with_stats`  forward only, also returning the
                                softmax stats (o, l, m)
:func:`flash_attention_plain`   plain PyTorch version of K7: dense f32
                                scores, ``where(valid, s, -1e30)``,
                                probabilities multiplied by ``valid``,
                                the l == 0 guard, stats included
:func:`flash_attention_bwd_plain`  plain version of K8a + K8b: the port
                                of ``_fa_reference_block_bwd``, a loop
                                over key blocks batched over (B, H)
:func:`bf16_rounding_scale`     the outputs over absolute values, which
                                scale the bf16 kernels' error bound
=============================  =========================================

In bfloat16, K7 and K8a run on the tensor cores and round each
probability P (K8a also each dS) to bf16 once before it enters a
product, so their outputs lie within 2⁻⁸ · :func:`bf16_rounding_scale`
(plus the rounding of the output itself) of the plain versions run in
f32; K8b and the float32 kernels keep f32 P.

Launches are counted in ``flash_attention.launches`` (K7),
``flash_attention.launches_dkv`` (K8a) and ``flash_attention.launches_dq``
(K8b); the plain versions never count as launches and count their own
calls in ``.calls``. A CUDA tensor never reaches a plain version: the
wrapper launches the kernel or raises.

The backward follows the reference's custom VJP: the forward saves
(q, k, v, mask, o, l, m), the backward computes delta = rowsum(dO * O)
in f32 outside the kernels, then K8a writes dK/dV and K8b writes dQ. The
two kernels use no atomics, so the gradients are the same from run to
run. Key rows that are masked out (and keys past S) never reach the
arithmetic: the kernels zero-fill them on load and the plain versions
zero them first, so a NaN stored in a padded key row stays out of the
result and of every gradient.

``block_q``/``block_k`` are accepted for the reference's signature and
checked; they do not set the CUDA tiles (64 queries by 64 keys). The
sequence is not padded: the kernels mask keys past S themselves.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

__all__ = ["flash_attention", "flash_attention_with_stats",
           "flash_attention_sharded", "flash_attention_plain",
           "flash_attention_bwd_plain", "bf16_rounding_scale",
           "attention_pairs", "HEAD_DIMS"]

_NEG = -1e30
#: head dims the kernels are built for
HEAD_DIMS = (32, 64, 128)
#: io dtype -> the C entry points' dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_blocks(block_q, block_k):
    for name, b in (("block_q", block_q), ("block_k", block_k)):
        if isinstance(b, bool) or not isinstance(b, int) or b <= 0:
            raise ValueError(f"{name} must be a positive int, got {b!r}")


def _check(q, k, v, kv_mask):
    """Device, dtype, head dim, contiguity and the mask's shape and dtype;
    raises on anything the kernels do not take."""
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, H, S, D)")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must all be float32 or all bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, _, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError("q/k/v must lie on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, S):
            raise ValueError(f"kv_mask {tuple(kv_mask.shape)} must be "
                             f"(B, S) = {(B, S)}")
        if kv_mask.dtype.is_floating_point or kv_mask.dtype.is_complex:
            raise TypeError(f"kv_mask must be bool or integer, got "
                            f"{kv_mask.dtype}")
        if kv_mask.device != dev:
            raise ValueError("kv_mask must lie on q's device")


def _mask_bytes(kv_mask):
    """(B, S) mask -> contiguous bool (True = attend), or None."""
    if kv_mask is None:
        return None
    m = kv_mask if kv_mask.dtype == torch.bool else kv_mask != 0
    return m.contiguous()


def _scale(scale, D):
    return 1.0 / float(D) ** 0.5 if scale is None else float(scale)


# ---- plain versions ---------------------------------------------------------

def _key_ok(kv_mask, B, S, device):
    """(B, S) bool key validity (all True without a mask)."""
    if kv_mask is None:
        return torch.ones((B, S), dtype=torch.bool, device=device)
    return kv_mask if kv_mask.dtype == torch.bool else kv_mask != 0


def _zero_masked(t, key_ok):
    """f32 copy of (B, H, S, D) ``t`` with masked key rows zeroed (what the
    kernels' zero-filled loads see)."""
    return torch.where(key_ok[:, None, :, None], t.float(), 0.0)


def flash_attention_plain(q, k, v, kv_mask=None, *, causal: bool = False,
                          scale: Optional[float] = None):
    """Plain PyTorch version of K7 → (o in q's dtype, l, m f32 (B, H, S)).

    The same function as the kernel, not the reference's dense attention:
    dense f32 scores times ``scale``, ``where(valid, s, -1e30)``,
    probabilities multiplied by ``valid``, ``o = (p @ v) / l`` with l == 0
    giving 0. Never a launch; counts ``flash_attention_plain.calls``."""
    flash_attention_plain.calls += 1
    B, H, S, D = q.shape
    scale = _scale(scale, D)
    key_ok = _key_ok(kv_mask, B, S, q.device)
    kf, vf = _zero_masked(k, key_ok), _zero_masked(v, key_ok)
    s = (q.float() @ kf.transpose(-1, -2)) * scale          # (B, H, S, S)
    valid = key_ok[:, None, None, :]
    if causal:
        idx = torch.arange(S, device=q.device)
        valid = valid & (idx[:, None] >= idx[None, :])
    s = torch.where(valid, s, _NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * valid
    l = p.sum(dim=-1)
    o = (p @ vf) / torch.where(l == 0.0, 1.0, l)[..., None]
    return o.to(q.dtype), l, m


flash_attention_plain.calls = 0


def _delta(do, o):
    """rowsum(dO * O) in f32, (B, H, S): computed outside the backward
    kernels, as the reference computes it outside its Pallas calls."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_blocks(q, k, v, kv_mask, o, l, m, do, causal, scale, block_k):
    """The plain backward's recompute, one key block at a time: yields
    (j0, j1, qf, dof, kj, p, ds) with p and ds (B, H, S, j1 - j0) f32."""
    B, H, S, D = q.shape
    key_ok = _key_ok(kv_mask, B, S, q.device)
    qf, dof = q.float(), do.float()
    kf, vf = _zero_masked(k, key_ok), _zero_masked(v, key_ok)
    linv = torch.where(l == 0.0, 0.0, 1.0 / l)[..., None]
    delta = _delta(do, o)[..., None]
    rows = torch.arange(S, device=q.device)
    for j0 in range(0, S, block_k):
        j1 = min(S, j0 + block_k)
        kj, vj = kf[:, :, j0:j1], vf[:, :, j0:j1]
        s = (qf @ kj.transpose(-1, -2)) * scale             # (B, H, S, bk)
        valid = key_ok[:, None, None, j0:j1]
        if causal:
            valid = valid & (rows[:, None] >= rows[None, j0:j1])
        p = torch.exp(torch.where(valid, s, _NEG) - m[..., None]) * \
            valid * linv
        dp = dof @ vj.transpose(-1, -2)
        ds = p * (dp - delta) * scale
        yield j0, j1, qf, dof, kj, p, ds


def flash_attention_bwd_plain(q, k, v, kv_mask, o, l, m, do, *,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              block_k: int = 512):
    """Plain version of K8a + K8b → (dq, dk, dv) in q/k/v's dtypes.

    The port of ``_fa_reference_block_bwd``: p is recomputed from the saved
    (m, l) per key block, p = exp(where(valid, s, -1e30) - m) * valid *
    linv with linv = 0 where l == 0, ds = p * (dp - delta) * scale; the
    reference's ``lax.scan`` over key blocks is a Python loop, batched
    over (B, H). Counts ``flash_attention_bwd_plain.calls``."""
    flash_attention_bwd_plain.calls += 1
    scale = _scale(scale, q.shape[-1])
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    for j0, j1, qf, dof, kj, p, ds in _bwd_blocks(
            q, k, v, kv_mask, o, l, m, do, causal, scale, block_k):
        dq += ds @ kj
        dk[:, :, j0:j1] = ds.transpose(-1, -2) @ qf
        dv[:, :, j0:j1] = p.transpose(-1, -2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_bwd_plain.calls = 0


def bf16_rounding_scale(q, k, v, kv_mask, o, l, m, do, *,
                        causal: bool = False,
                        scale: Optional[float] = None,
                        block_k: int = 512):
    """R of the bf16 kernels' error bound → (r_o, r_dk, r_dv), f32.

    The bf16 K7 rounds each probability P, and the bf16 K8a each P and
    dS, to bf16 once before it enters a tensor-core product. One rounding
    of each x moves a sum of x·y by at most 2⁻⁸ · sum |x||y| (2⁻⁸ is
    bf16's unit roundoff). R is each such output taken over absolute
    values, with the plain versions' arithmetic: r_o = sum P |v| / l (the
    plain forward over |v|, exact since P ≥ 0), r_dv = Pᵀ |dO|, r_dk =
    |dS|ᵀ |Q|."""
    r_o = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                kv_mask, causal=causal, scale=scale)[0]
    scale = _scale(scale, q.shape[-1])
    r_dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    r_dv = torch.empty_like(r_dk)
    for j0, j1, qf, dof, _, p, ds in _bwd_blocks(
            q, k, v, kv_mask, o, l, m, do, causal, scale, block_k):
        r_dk[:, :, j0:j1] = ds.abs().transpose(-1, -2) @ qf.abs()
        r_dv[:, :, j0:j1] = p.transpose(-1, -2) @ dof.abs()
    return r_o, r_dk, r_dv


def attention_pairs(kv_mask, B: int, S: int, causal: bool) -> int:
    """(query, key) pairs of one head that this input needs: the key is
    valid and, when causal, not after the query. Each pair costs 2 D
    flops per matrix product: the forward does 2 products (s, p v), K8a
    4 (s, dp, dv, dk) and K8b 3 (s, dp, dq)."""
    ok = _key_ok(kv_mask, B, S, "cpu").cpu().to(torch.int64)
    if causal:
        return int(ok.cumsum(-1).sum())     # valid keys at or before each query
    return int(ok.sum()) * S


# ---- kernels ------------------------------------------------------------------

def _library():
    from ..utils.cuda_build import load_library
    lib = load_library("flash_attention")
    if lib.mmlspark_fa_fwd.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mmlspark_fa_fwd.argtypes = ([ci, ci] + [vp] * 7
                                        + [ci, ci, ci, cf, ci, vp])
        lib.mmlspark_fa_bwd_dkv.argtypes = ([ci, ci] + [vp] * 10
                                            + [ci, ci, ci, cf, ci, vp])
        lib.mmlspark_fa_bwd_dq.argtypes = ([ci, ci] + [vp] * 9
                                           + [ci, ci, ci, cf, ci, vp])
        for f in (lib.mmlspark_fa_fwd, lib.mmlspark_fa_bwd_dkv,
                  lib.mmlspark_fa_bwd_dq):
            f.restype = ci
        lib.mmlspark_fa_error_string.argtypes = [ci]
        lib.mmlspark_fa_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.mmlspark_fa_error_string(err).decode()
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"{msg}")


def _check_cuda(*tensors):
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("CUDA inputs must be 16-byte aligned")


def _fwd_kernel(q, k, v, mask, causal, scale, with_stats):
    B, H, S, D = q.shape
    _check_cuda(q, k, v)
    o = torch.empty_like(q)
    l = m = None
    if with_stats:
        l = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        m = torch.empty_like(l)
    if q.numel() == 0:
        return o, l, m
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mmlspark_fa_fwd(
            _DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(mask), o.data_ptr(), _ptr(l), _ptr(m), B * H, H, S,
            scale, int(causal), stream)
    _raise_on(lib, err, "forward")
    flash_attention.launches += 1
    return o, l, m


def _bwd_kernel(q, k, v, mask, o, l, m, do, causal, scale):
    B, H, S, D = q.shape
    do = do.to(q.dtype).contiguous()
    delta = _delta(do, o)
    _check_cuda(q, k, v, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    lib = _library()
    code = _DTYPES[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                  do.data_ptr(), m.data_ptr(), l.data_ptr(),
                  delta.data_ptr())
        err = lib.mmlspark_fa_bwd_dkv(code, D, *common, dk.data_ptr(),
                                      dv.data_ptr(), B * H, H, S, scale,
                                      int(causal), stream)
        _raise_on(lib, err, "dK/dV")
        flash_attention.launches_dkv += 1
        err = lib.mmlspark_fa_bwd_dq(code, D, *common, dq.data_ptr(),
                                     B * H, H, S, scale, int(causal), stream)
        _raise_on(lib, err, "dQ")
        flash_attention.launches_dq += 1
    return dq, dk, dv


def _forward(q, k, v, mask, causal, scale, with_stats):
    """K7 on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cpu":
        o, l, m = flash_attention_plain(q, k, v, mask, causal=causal,
                                        scale=scale)
        return (o, l, m) if with_stats else (o, None, None)
    return _fwd_kernel(q, k, v, mask, causal, scale, with_stats)


def _backward(q, k, v, mask, o, l, m, do, causal, scale):
    """K8a + K8b on CUDA tensors, their plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, o, l, m, do,
                                         causal=causal, scale=scale)
    return _bwd_kernel(q, k, v, mask, o, l, m, do, causal, scale)


class _Flash(torch.autograd.Function):
    """The reference's custom VJP ``_flash``: K7 with stats forward,
    delta + K8a + K8b backward; no gradient for the mask."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        o, l, m = _forward(q, k, v, mask, causal, scale, True)
        ctx.save_for_backward(q, k, v, mask, o, l, m)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, mask, o, l, m = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, mask, o, l, m, do.contiguous(),
                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 1024):
    """Streaming-softmax attention, (B, H, S, D) layout → o in q's dtype.

    Differentiable through ``torch.autograd`` (K8a/K8b backward) when any
    of q/k/v requires grad; otherwise K7 runs without stats. ``kv_mask``
    is a (B, S) bool or integer key mask (nonzero = attend). q/k/v are
    contiguous, float32 or bfloat16 alike, head dim 32, 64 or 128.
    ``block_q``/``block_k`` are checked but do not set the CUDA tiles."""
    _check_blocks(block_q, block_k)
    _check(q, k, v, kv_mask)
    scale = _scale(scale, q.shape[-1])
    mask = _mask_bytes(kv_mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, mask, bool(causal), scale)
    return _forward(q, k, v, mask, bool(causal), scale, False)[0]


#: K7 / K8a / K8b launches since the last reset; plain calls never count
flash_attention.launches = 0
flash_attention.launches_dkv = 0
flash_attention.launches_dq = 0


def flash_attention_with_stats(q, k, v, *, scale: Optional[float] = None,
                               block_q: int = 512, block_k: int = 1024):
    """Forward-only flash attention with the softmax stats → (o, l, m): o
    (B, H, S, D) in q's dtype, l = sum exp(s - m) and m = the row max, f32
    (B, H, S). No mask, not causal; no gradient flows through it (the
    reference defines no VJP for it either)."""
    _check_blocks(block_q, block_k)
    _check(q, k, v, None)
    with torch.no_grad():
        return _forward(q, k, v, None, False, _scale(scale, q.shape[-1]),
                        True)


def flash_attention_sharded(q, k, v, mesh, **kwargs):
    """Per-shard flash attention on a device mesh: not ported yet."""
    raise NotImplementedError(
        "flash_attention_sharded needs a device mesh: ROADMAP.md slice 6 "
        "(multi-device)")

