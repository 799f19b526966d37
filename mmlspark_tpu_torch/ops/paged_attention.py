"""Fused paged attention over the KV page pool (counterpart of
``ops/paged_attention.py:944-1045``, the single-device non-quantized
branch of ``paged_attention_window``).

Three parts, as for every kernel of the port:

* :func:`paged_attention_window_plain` — the plain PyTorch version of
  the function. CPU tensors take it; the card's kernel is held against it.
* ``csrc/paged_attention.cu`` — the hand-written Hopper kernel that
  replaces the TPU's ``_pa_fused_kernel``: queries attend the cached keys
  read in place through the block table plus the window's own keys, and
  the fresh K/V rows are written into their pages in the same launch.
* :func:`paged_attention_window` — the wrapper: the plain version for
  CPU tensors, the kernel for CUDA tensors (or an error; there is no
  fallback), with a launch count in ``paged_attention_window.launches``.

The page pools are updated IN PLACE (the JAX package aliases them onto
its outputs, which is the same thing for a caller that rebinds).

Page-size rule on Hopper: none. The kernel tiles the logical key space
in 32-key tiles and looks each key's page up on its own, so any
``page_size >= 1`` runs; the TPU's sublane rounding
(``aligned_page_size``) has no counterpart here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

__all__ = ["paged_attention_window", "paged_attention_window_plain",
           "write_range"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64,)


def write_range(pos: torch.Tensor, W: int, page: int,
                active: Optional[torch.Tensor] = None):
    """(wlo, whi) logical-page write range per row, as the JAX package
    computes it (``paged_attention.py:1026-1032``): inactive rows get the
    empty range (1, 0) and write nothing."""
    wlo = torch.div(pos, page, rounding_mode="floor")
    whi = torch.div(pos + (W - 1), page, rounding_mode="floor")
    if active is not None:
        wlo = torch.where(active, wlo, torch.ones_like(wlo))
        whi = torch.where(active, whi, torch.zeros_like(whi))
    return wlo.to(torch.int32), whi.to(torch.int32)


def paged_attention_window_plain(q, k_new, v_new, k_pages, v_pages,
                                 block_tables, pos, wlo, whi, scale: float):
    """Plain PyTorch version of the fused kernel, same arguments and the
    same in-place page update. Returns ctx (B, H, W, hd) in ``q.dtype``.

    Cached keys at or past ``pos[b]`` are masked AND zeroed before use,
    so garbage in unwritten page slots never reaches ``p · v``."""
    B, H, W, hd = q.shape
    page = k_pages.shape[2]
    P = block_tables.shape[1]
    dev = q.device
    bt = block_tables.long()
    posl = pos.long()
    L = P * page
    # (B, P, H, page, hd) -> (B, H, L, hd)
    kc = k_pages[bt].permute(0, 2, 1, 3, 4).reshape(B, H, L, hd).float()
    vc = v_pages[bt].permute(0, 2, 1, 3, 4).reshape(B, H, L, hd).float()
    key_ok = torch.arange(L, device=dev)[None] < posl[:, None]      # (B, L)
    kc = torch.where(key_ok[:, None, :, None], kc, 0.0)
    vc = torch.where(key_ok[:, None, :, None], vc, 0.0)
    qf = q.float()
    s_c = torch.einsum("bhwd,bhkd->bhwk", qf, kc) * scale
    s_w = torch.einsum("bhwd,bhkd->bhwk", qf, k_new.float()) * scale
    causal = torch.tril(torch.ones(W, W, dtype=torch.bool, device=dev))
    valid = torch.cat([key_ok[:, None, None, :].expand(B, 1, W, L),
                       causal[None, None].expand(B, 1, W, W)], dim=-1)
    s = torch.where(valid, torch.cat([s_c, s_w], dim=-1), _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l_ = p.sum(dim=-1, keepdim=True)
    v_all = torch.cat([vc, v_new.float()], dim=2)
    ctx = torch.einsum("bhwk,bhkd->bhwd", p, v_all)
    ctx = (ctx / torch.where(l_ == 0, 1.0, l_)).to(q.dtype)
    # the scatter: window row j of an active row lands at position pos+j
    t = posl[:, None] + torch.arange(W, device=dev)[None]            # (B, W)
    lp = torch.div(t, page, rounding_mode="floor")
    ok = (lp >= wlo.long()[:, None]) & (lp <= whi.long()[:, None]) & (lp < P)
    rows, cols = ok.nonzero(as_tuple=True)
    if rows.numel():
        phys = bt[rows, lp[rows, cols]]
        off = t[rows, cols] % page
        k_pages[phys, :, off] = k_new[rows, :, cols].to(k_pages.dtype)
        v_pages[phys, :, off] = v_new[rows, :, cols].to(v_pages.dtype)
    return ctx


def _library():
    from ..utils.cuda_build import load_library
    lib = load_library("paged_attention")
    fn = lib.mmlspark_pa_window_fused
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                       ci, ci, ci, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
        lib.mmlspark_cuda_error_string.argtypes = [ci]
        lib.mmlspark_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_new, v_new, k_pages, v_pages, block_tables, pos):
    B, H, W, hd = q.shape
    N, Hp, page, hdp = k_pages.shape
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(f"k_new {tuple(k_new.shape)} / v_new "
                         f"{tuple(v_new.shape)} must match q {tuple(q.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if (Hp, hdp) != (H, hd):
        raise ValueError(f"pools (N, {Hp}, page, {hdp}) do not match q's "
                         f"heads {H} / head dim {hd}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} must be "
                         f"(B={B}, P)")
    if pos.shape != (B,):
        raise ValueError(f"pos {tuple(pos.shape)} must be (B={B},)")
    dts = {t.dtype for t in (q, k_new, v_new, k_pages, v_pages)}
    if len(dts) != 1 or q.dtype not in _DTYPES:
        raise TypeError(f"q, k_new, v_new and the pools must share one "
                        f"dtype in (float32, bfloat16); got {dts}")
    devs = {t.device for t in (q, k_new, v_new, k_pages, v_pages,
                               block_tables, pos)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must lie on one device; got {devs}")
    if block_tables.dtype not in (torch.int32, torch.int64) or \
            pos.dtype not in (torch.int32, torch.int64):
        raise TypeError("block_tables and pos must be integer tensors")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.is_cuda and t.data_ptr() % 16:
            # the kernel reads key rows as 16-byte vectors
            raise ValueError(f"{name} must start on a 16-byte boundary")


def paged_attention_window(q, k_new, v_new, k_pages, v_pages, block_tables,
                           pos, *, active=None,
                           scale: Optional[float] = None):
    """Fused decode-window attention + page scatter.

    Row ``b``'s W queries ``q`` (B, H, W, hd) sit at absolute positions
    ``pos[b] .. pos[b]+W-1``; they attend every cached key strictly
    below ``pos[b]`` (read in place from the (N, H, page, hd) pools
    through ``block_tables`` (B, P)) plus the window's own keys
    ``k_new``/``v_new`` under the in-window causal mask. The fresh K/V
    rows are written into their pages — **in place**, ``k_pages`` and
    ``v_pages`` are mutated — except for rows where ``active`` is False,
    which write nothing. Returns ``(ctx, k_pages, v_pages)``; ctx is
    (B, H, W, hd) in ``q.dtype``, the pools are the same tensors that
    were passed in.

    CPU tensors run :func:`paged_attention_window_plain`. CUDA tensors
    launch the hand-written kernel (``csrc/paged_attention.cu``) on the
    current stream and count the launch in
    ``paged_attention_window.launches``; anything the kernel does not
    take raises."""
    _check(q, k_new, v_new, k_pages, v_pages, block_tables, pos)
    B, H, W, hd = q.shape
    page = k_pages.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    pos = pos.to(torch.int32)
    bt = block_tables.to(torch.int32).contiguous()
    wlo, whi = write_range(pos, W, page, active)
    if q.device.type == "cpu":
        ctx = paged_attention_window_plain(q, k_new, v_new, k_pages, v_pages,
                                           bt, pos, wlo, whi, float(scale))
        return ctx, k_pages, v_pages
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {_HEAD_DIMS}, "
                         f"got {hd}")
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mmlspark_pa_window_fused(
            _DTYPES[q.dtype], hd, q.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            bt.data_ptr(), pos.contiguous().data_ptr(), wlo.data_ptr(),
            whi.data_ptr(), out.data_ptr(), B, H, W, bt.shape[1], page,
            float(scale), stream)
    if err != 0:
        msg = lib.mmlspark_cuda_error_string(err).decode()
        raise RuntimeError(f"paged attention kernel launch failed: {msg}")
    paged_attention_window.launches += 1
    return out, k_pages, v_pages


#: kernel launches since the last reset (the plain CPU path never counts)
paged_attention_window.launches = 0
