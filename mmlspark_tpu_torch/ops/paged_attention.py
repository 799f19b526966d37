"""Paged attention over the KV page pool (counterpart of
``ops/paged_attention.py``): the fused decode-window kernel with its
in-launch page scatter, the read-only sweep, and the mesh mount's
window read whose page writes run outside the kernel, each on plain or
quantized pages.

Six kernels, each with its plain PyTorch version beside it and its own
launch count; all are written by hand in ``csrc/paged_attention.cu``:

============  ==============================  ================================
kernel        wrapper (launch count)          replaces (``mmlspark_tpu/ops/
                                              paged_attention.py``)
============  ==============================  ================================
K1            :func:`paged_attention_window`  ``_pa_fused_kernel``
              (``.launches``; tensor-core
              body ``.launches_mma``, split
              decode body
              ``.launches_split``)
K2            :func:`paged_attention_window`  ``_pa_fused_kernel_q``
              with scales (``.launches_q``;
              ``.launches_q_mma``,
              ``.launches_q_split``)
K3            :func:`paged_attention`         ``_pa_read_kernel``
              (``.launches``; split body
              ``.launches_split``)
K4            :func:`paged_attention` with    ``_pa_read_kernel_q``
              scales (``.launches_q``;
              ``.launches_q_split``)
K5a           :func:`paged_attention_window`  ``_pa_window_kernel``
              with ``mesh=``
              (``.launches_window``;
              ``.launches_window_mma``,
              ``.launches_window_split``)
K5b           the same with scales            ``_pa_window_kernel_q``
              (``.launches_window_q``;
              ``.launches_window_q_mma``,
              ``.launches_window_q_split``)
============  ==============================  ================================

* :func:`paged_attention_window_plain`,
  :func:`paged_attention_window_read_plain` and
  :func:`paged_attention_plain` are the plain versions. CPU tensors take
  them; the card's kernels are held against them.
* The wrappers run the plain version for CPU tensors and the kernel for
  CUDA tensors, or raise; there is no fallback.
* :func:`paged_rounding_scale` is the window attention over absolute
  values, which scales the bf16 window kernels' error bound.

Three bodies serve the six kernels, and the C entries report which one
ran (counted in the ``_mma`` / ``_split`` counters above):

* the tensor-core body: K1, K2, K5a and K5b with bfloat16 queries and
  W > 1 (chunked-prefill chunks, prefix-suffix windows). It rounds each
  probability P (K1, K5a), or P times the key's V scale (K2, K5b), to
  bf16 once before it enters the P·V product, so its context lies within
  2⁻⁸ · :func:`paged_rounding_scale` (plus the rounding of the output
  itself) of the plain version run in f32;
* the split body: K1, K2, K5a and K5b at W = 1 (the decode tick,
  single-device or meshed) and the read-only sweep K3/K4, f32 or bf16
  queries. Each (row, head)'s keys are cut into fixed chunks, one block
  each (the sweep's W queries also into groups of 4, a block each, one
  query a block at W = 1), and the last block to finish merges the
  partial softmax states in the same launch, through a workspace and
  per-(row, head, group) counters that :func:`_split_workspace`
  allocates once per device and caches (zeroed once; every launch leaves
  them zero). K1/K2's page scatter runs in the block of the row's last
  live chunk, the one that reads the fresh key. Its math is f32, so its
  context differs from the plain version's only in the order of its
  sums;
* the f32 FMA body: float32 windows (K1, K2, K5a, K5b at W > 1), also
  within the order of its sums.

The page pools (and scale pools) are updated IN PLACE (the JAX package
aliases them onto its outputs, which is the same thing for a caller that
rebinds). Quantized pools hold int8 or ``float8_e4m3fn`` codes with one
bf16 scale per (page, head, position); reads dequantize as
``f32(code) * f32(scale)`` and the fused scatter quantizes each fresh row
by the rules of :func:`~mmlspark_tpu_torch.ops.kv_quant.quantize_kv`.

The mesh mount (``mesh=``): JAX mounts the kernel with ``shard_map``
over global arrays; the port runs one process per rank, so the caller
passes its RANK-LOCAL q / k_new / v_new — its ``B / dp`` rows when
``slot_axis`` names the ``dp`` axis, its ``H / tp`` heads over
``head_axis`` — with those rows' block-table rows, ``pos`` and
``active``, and its head shard of the pools (every rank of a ``tp``
group holds ``H / tp`` heads of every page; the pools replicate over
``dp``). The window op reads the rank's rows through K5a/K5b, then
writes the fresh rows with :func:`_pool_write_rows` /
:func:`_pool_write_rows_quant` outside the kernel, bytes identical to
the fused scatter's. With rows over ``dp`` every replica must write
EVERY shard's rows, so first one
:func:`~mmlspark_tpu_torch.parallel.mesh.gather_rows_many` over the dp
group brings in k_new, v_new, the block-table rows, ``pos`` and
``active`` (the all-gather GSPMD inserts before the JAX package's
``_pool_write_rows``); that is the only collective here. The read-only
op runs K3/K4 on the rank's rows and heads as they are.

Page-size rule on Hopper: none. The kernels tile the logical key space
in 32-key tiles and look each key's page up on its own, so any
``page_size >= 1`` runs; the TPU's sublane rounding
(``aligned_page_size``) and window padding (``Wp``) have no counterpart.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..parallel.mesh import axis_size, gather_rows_many, mesh_shape
from .kv_quant import SCALE_DTYPE, quantize_kv

__all__ = ["paged_attention", "paged_attention_plain",
           "paged_attention_window", "paged_attention_window_plain",
           "paged_attention_window_read_plain", "paged_rounding_scale",
           "write_range"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STORES = {torch.int8: 0}
if hasattr(torch, "float8_e4m3fn"):
    _STORES[torch.float8_e4m3fn] = 1
_HEAD_DIMS = (64,)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A quantized pool as its raw bytes: gathers and scatters of fp8
    codes go through a uint8 view, which every device indexes."""
    return t.view(torch.uint8) if t.dtype in _STORES else t


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


def _gather_rows(pages, scales, bt):
    """Each row's cached keys (or values) as (B, H, P * page, hd) f32,
    dequantized through their scales when ``scales`` is given."""
    B, P = bt.shape
    _, H, page, hd = pages.shape
    g = _bits(pages)[bt].view(pages.dtype).float()     # (B, P, H, page, hd)
    if scales is not None:
        g = g * scales[bt].float()[..., None]
    return g.permute(0, 2, 1, 3, 4).reshape(B, H, P * page, hd)


def _softmax_ctx(s, valid, v, out_dtype):
    """Masked f32 softmax over the last axis and ``p · v``; a row with no
    valid key gives zeros (-1e30 masks, l == 0 guarded)."""
    s = torch.where(valid, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l_ = p.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bhwk,bhkd->bhwd", p, v)
    return (ctx / torch.where(l_ == 0, 1.0, l_)).to(out_dtype)


def paged_attention_window_read_plain(q, k_new, v_new, k_pages, v_pages,
                                      block_tables, pos, scale: float,
                                      k_scale=None, v_scale=None):
    """Plain PyTorch version of the window read (K5a; K5b with scales):
    the fused kernels' attention with nothing written. Returns ctx
    (B, H, W, hd) in ``q.dtype``; the pools are only read.

    Cached keys at or past ``pos[b]`` are masked AND zeroed after the
    dequant, so garbage codes or scales in unwritten slots never reach
    ``p · v``. The window's own rows are attended unquantized."""
    B, H, W, hd = q.shape
    page = k_pages.shape[2]
    P = block_tables.shape[1]
    dev = q.device
    bt = block_tables.long()
    L = P * page
    key_ok = torch.arange(L, device=dev)[None] < pos.long()[:, None]  # (B, L)
    kc = torch.where(key_ok[:, None, :, None],
                     _gather_rows(k_pages, k_scale, bt), 0.0)
    vc = torch.where(key_ok[:, None, :, None],
                     _gather_rows(v_pages, v_scale, bt), 0.0)
    qf = q.float()
    s_c = torch.einsum("bhwd,bhkd->bhwk", qf, kc) * scale
    s_w = torch.einsum("bhwd,bhkd->bhwk", qf, k_new.float()) * scale
    causal = torch.tril(torch.ones(W, W, dtype=torch.bool, device=dev))
    valid = torch.cat([key_ok[:, None, None, :].expand(B, 1, W, L),
                       causal[None, None].expand(B, 1, W, W)], dim=-1)
    return _softmax_ctx(torch.cat([s_c, s_w], dim=-1), valid,
                        torch.cat([vc, v_new.float()], dim=2), q.dtype)


def paged_attention_window_plain(q, k_new, v_new, k_pages, v_pages,
                                 block_tables, pos, wlo, whi, scale: float,
                                 k_scale=None, v_scale=None):
    """Plain PyTorch version of the fused kernels (K1; K2 with scales),
    same arguments and the same in-place page (and scale) update:
    :func:`paged_attention_window_read_plain`'s context, then each row's
    fresh rows scattered into the pages of its write range [wlo, whi]
    (empty for an inactive row). Returns ctx (B, H, W, hd) in
    ``q.dtype``."""
    W = q.shape[2]
    page = k_pages.shape[2]
    P = block_tables.shape[1]
    dev = q.device
    bt = block_tables.long()
    posl = pos.long()
    ctx = paged_attention_window_read_plain(q, k_new, v_new, k_pages,
                                            v_pages, block_tables, pos,
                                            scale, k_scale, v_scale)
    # the scatter: window row j of an active row lands at position pos+j
    t = posl[:, None] + torch.arange(W, device=dev)[None]            # (B, W)
    lp = torch.div(t, page, rounding_mode="floor")
    ok = (lp >= wlo.long()[:, None]) & (lp <= whi.long()[:, None]) & (lp < P)
    rows, cols = ok.nonzero(as_tuple=True)
    if rows.numel():
        phys = bt[rows, lp[rows, cols]]
        off = t[rows, cols] % page
        for pages, scales, new in ((k_pages, k_scale, k_new),
                                   (v_pages, v_scale, v_new)):
            vals = new[rows, :, cols]                                # (n, H, hd)
            if scales is None:
                pages[phys, :, off] = vals.to(pages.dtype)
            else:
                codes, sc = quantize_kv(vals, pages.dtype)
                _bits(pages)[phys, :, off] = _bits(codes)
                scales[phys, :, off] = sc
    return ctx


def paged_rounding_scale(q, k_new, v_new, k_pages, v_pages, block_tables,
                         pos, scale: Optional[float] = None, k_scale=None,
                         v_scale=None):
    """R of the bf16 window kernels' error bound → (B, H, W, hd) f32.

    The tensor-core K1 rounds each probability p, and K2 each p · sv, to
    bf16 once before the P·V product. One rounding of each term moves
    sum p·v / l by at most 2⁻⁸ · sum p·|v| / l (2⁻⁸ is bf16's unit
    roundoff). R is that sum: the plain window attention
    (:func:`paged_attention_window_read_plain`, in f32) with ``v_new``
    and the cached V — dequantized through ``v_scale`` — replaced by
    their absolute values. The pools are only read (|V| is built on
    copies); ``pos`` bounds the cached keys as in the window kernels."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if v_scale is None:
        v_abs, vs_abs = v_pages.float().abs(), None
    else:
        # |code · scale| = |code| · |scale|: a sign bit cleared on each
        # (int8 codes are clipped to ±127, so |code| never overflows)
        v_abs = (_bits(v_pages) & 0x7F).view(v_pages.dtype) \
            if v_pages.dtype != torch.int8 else v_pages.abs()
        vs_abs = v_scale.abs()
    return paged_attention_window_read_plain(
        q.float(), k_new.float(), v_new.float().abs(), k_pages, v_abs,
        block_tables, pos, float(scale), k_scale, vs_abs)


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths,
                          scale: float, k_scale=None, v_scale=None):
    """Plain PyTorch version of the read-only sweep (K3; K4 with scales):
    row ``b``'s W queries all attend its first ``lengths[b]`` cached keys
    (no window, no causal mask among the queries). ``lengths[b] == 0``
    gives zeros. Returns (B, H, W, hd) in ``q.dtype``."""
    B, H, W, hd = q.shape
    L = block_tables.shape[1] * k_pages.shape[2]
    bt = block_tables.long()
    key_ok = (torch.arange(L, device=q.device)[None]
              < lengths.long()[:, None])                            # (B, L)
    kc = torch.where(key_ok[:, None, :, None],
                     _gather_rows(k_pages, k_scale, bt), 0.0)
    vc = torch.where(key_ok[:, None, :, None],
                     _gather_rows(v_pages, v_scale, bt), 0.0)
    s = torch.einsum("bhwd,bhkd->bhwk", q.float(), kc) * scale
    return _softmax_ctx(s, key_ok[:, None, None, :], vc, q.dtype)


def _row_slots(block_tables, pos, W: int, page: int, active):
    """(physical page, offset) of each row's W window positions, flat in
    (row, j) order, as the JAX writers compute them: the page through
    the block table, the offset ``(pos + j) % page``. Inactive rows, and
    positions past the block table's width, go to trash page 0."""
    P = block_tables.shape[1]
    wpos = pos.long()[:, None] + torch.arange(W, device=pos.device)  # (B, W)
    lp = torch.div(wpos, page, rounding_mode="floor")
    phys = torch.gather(block_tables.long(), 1, lp.clamp(max=P - 1))
    keep = lp < P
    if active is not None:
        keep = keep & active[:, None]
    phys = torch.where(keep, phys, torch.zeros_like(phys))
    return phys.reshape(-1), (wpos % page).reshape(-1)


def _put_rows(pool, rows, pf, of):
    """``pool[pf, :, of] = rows`` for (B, H, W, hd) rows flattened in
    (row, j) order, in the pool's dtype."""
    B, H, W, hd = rows.shape
    pool[pf, :, of] = rows.transpose(1, 2).reshape(B * W, H, hd).to(
        pool.dtype)


def _put_rows_quant(pool, scales, rows, pf, of):
    """:func:`_put_rows` through
    :func:`~mmlspark_tpu_torch.ops.kv_quant.quantize_kv`: codes into the
    pool, the per-head scales into the (N, H, page) scale pool."""
    B, H, W, hd = rows.shape
    codes, sc = quantize_kv(rows.transpose(1, 2).reshape(B * W, H, hd),
                            pool.dtype)
    _bits(pool)[pf, :, of] = _bits(codes)
    scales[pf, :, of] = sc.to(scales.dtype)


def _pool_write_rows(pool, rows, block_tables, pos, active):
    """Scatter each row's W fresh K/V rows (B, H, W, hd) into their pages
    IN PLACE — the mesh path's page write, outside the kernel (JAX
    ``_pool_write_rows``). The bytes equal the fused kernel's in-launch
    scatter and the gather path's writeback; inactive rows write trash
    page 0. Returns ``pool``."""
    _put_rows(pool, rows, *_row_slots(block_tables, pos, rows.shape[2],
                                      pool.shape[2], active))
    return pool


def _pool_write_rows_quant(pool, scales, rows, block_tables, pos, active):
    """Quantizing twin of :func:`_pool_write_rows` (JAX
    ``_pool_write_rows_quant``): each (H, hd) row goes through
    :func:`~mmlspark_tpu_torch.ops.kv_quant.quantize_kv` and its per-head
    scale lands in the (N, H, page) scale pool at the same (page,
    offset). Both pools are updated IN PLACE; returns (pool, scales)."""
    _put_rows_quant(pool, scales, rows, *_row_slots(
        block_tables, pos, rows.shape[2], pool.shape[2], active))
    return pool, scales


def _gather_fresh(tensors, active, mesh, slot_axis):
    """What a write into a pool replicated over ``slot_axis`` needs: every
    dp shard's ``tensors`` (rows on dim 0: the fresh K/V rows, the
    block-table rows, the positions) and ``active`` (None: every row
    live), gathered in one collective. Without a slot axis of size > 1
    they are returned as given. Returns (tensors, active)."""
    if slot_axis is None or axis_size(mesh, slot_axis) == 1:
        return list(tensors), active
    act = (torch.ones(tensors[0].shape[0], dtype=torch.bool,
                      device=tensors[0].device)
           if active is None else active.to(torch.bool))
    *got, act = gather_rows_many(list(tensors) + [act], mesh, slot_axis)
    return got, act


def _mount_writes(k_new, v_new, pools, block_tables, pos, active, mesh=None,
                  slot_axis=None):
    """The mesh mount's page writes after the window read: the K and V
    rows (codes and scales when ``pools`` holds scale pools too) at one
    set of (page, offset) slots — :func:`_pool_write_rows(_quant)
    <_pool_write_rows>` for K and for V, with the slots computed once.
    With ``slot_axis`` (rows over ``dp``) every dp shard's rows are
    gathered first (:func:`_gather_fresh`) and all of them written: each
    replica of the pool receives the same bytes."""
    (k_new, v_new, block_tables, pos), active = _gather_fresh(
        [k_new, v_new, block_tables, pos], active, mesh, slot_axis)
    pf, of = _row_slots(block_tables, pos, k_new.shape[2], pools[0].shape[2],
                        active)
    if len(pools) == 4:
        _put_rows_quant(pools[0], pools[2], k_new, pf, of)
        _put_rows_quant(pools[1], pools[3], v_new, pf, of)
    else:
        _put_rows(pools[0], k_new, pf, of)
        _put_rows(pools[1], v_new, pf, of)


def _check_mount(mesh, B: int, H: int, slot_axis, head_axis):
    """The mesh's axes must divide the GLOBAL heads ``H`` (``head_axis``)
    and rows ``B`` (``slot_axis``), as in the JAX mount; callers that
    know the global shapes (the model's layer loops, the engine) check
    here."""
    if head_axis is not None:
        tp = axis_size(mesh, head_axis)
        if H % tp:
            raise ValueError(
                f"heads {H} not divisible by mesh {head_axis}={tp}")
    if slot_axis is not None:
        dp = axis_size(mesh, slot_axis)
        if B % dp:
            raise ValueError(
                f"batch {B} not divisible by mesh {slot_axis}={dp}")


def _check_mesh_axes(mesh, slot_axis, head_axis) -> None:
    """What the port's mount takes: a slot axis and a head axis that the
    mesh names (either may be None), and not the same axis twice."""
    names = tuple(mesh.mesh_dim_names or ())
    for name in (slot_axis, head_axis):
        if name is not None and name not in names:
            raise ValueError(f"mesh {mesh_shape(mesh)} has no axis {name!r}")
    if slot_axis is not None and slot_axis == head_axis:
        raise ValueError(f"slot_axis and head_axis are both {slot_axis!r}")


def _library():
    from ..utils.cuda_build import load_library
    lib = load_library("paged_attention")
    if lib.mmlspark_pa_window_fused.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [ci, ci, ci, ci, ci, cf, vp]      # B, H, W, P, page, scale, stream
        body = [ctypes.POINTER(ci)]     # 1: the mma body ran, 2: the split one
        lib.mmlspark_pa_window_fused.argtypes = [ci, ci] + [vp] * 12 + shape \
            + body
        lib.mmlspark_pa_window_fused_q.argtypes = [ci, ci, ci] + [vp] * 14 \
            + shape + body
        lib.mmlspark_pa_read.argtypes = [ci, ci] + [vp] * 8 + shape + body
        lib.mmlspark_pa_read_q.argtypes = [ci, ci, ci] + [vp] * 10 + shape \
            + body
        lib.mmlspark_pa_window_read.argtypes = [ci, ci] + [vp] * 10 + shape \
            + body
        lib.mmlspark_pa_window_read_q.argtypes = [ci, ci, ci] + [vp] * 12 \
            + shape + body
        lib.mmlspark_pa_split_chunk.argtypes = []
        lib.mmlspark_pa_read_group.argtypes = [ci]     # W -> queries a block
        for fn in (lib.mmlspark_pa_window_fused, lib.mmlspark_pa_window_fused_q,
                   lib.mmlspark_pa_read, lib.mmlspark_pa_read_q,
                   lib.mmlspark_pa_window_read,
                   lib.mmlspark_pa_window_read_q, lib.mmlspark_pa_split_chunk,
                   lib.mmlspark_pa_read_group):
            fn.restype = ci
        lib.mmlspark_cuda_error_string.argtypes = [ci]
        lib.mmlspark_cuda_error_string.restype = ctypes.c_char_p
        lib.split_chunk = lib.mmlspark_pa_split_chunk()   # keys a block
    return lib


def _check(q, k_pages, v_pages, block_tables, ints, *, k_new=None,
           v_new=None, k_scale=None, v_scale=None):
    """What every wrapper checks before its plain version or kernel runs:
    shapes, dtypes, one device, contiguity, 16-byte alignment on the card.
    ``ints`` is ``pos`` (fused) or ``lengths`` (read-only)."""
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, H, W, hd)")
    B, H, W, hd = q.shape
    if k_pages.dim() != 4:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} must be "
                         f"(N, H, page, hd)")
    N, Hp, page, hdp = k_pages.shape
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t is not None and t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match q "
                             f"{tuple(q.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    if (Hp, hdp) != (H, hd):
        raise ValueError(f"pools (N, {Hp}, page, {hdp}) do not match q's "
                         f"heads {H} / head dim {hd}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} must be "
                         f"(B={B}, P)")
    if ints.shape != (B,):
        raise ValueError(f"pos / lengths {tuple(ints.shape)} must be "
                         f"(B={B},)")
    acts = [t for t in (q, k_new, v_new) if t is not None]
    dts = {t.dtype for t in acts}
    if len(dts) != 1 or q.dtype not in _DTYPES:
        raise TypeError(f"q, k_new and v_new must share one dtype in "
                        f"(float32, bfloat16); got {dts}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    pools = [k_pages, v_pages]
    if k_scale is None:
        if {k_pages.dtype, v_pages.dtype} != {q.dtype}:
            raise TypeError(f"unquantized pools must be in q's dtype "
                            f"{q.dtype}; got {k_pages.dtype}/{v_pages.dtype}"
                            f" (quantized pools need k_scale/v_scale)")
    else:
        if k_pages.dtype not in _STORES or v_pages.dtype != k_pages.dtype:
            raise TypeError(f"quantized pools must share one dtype in "
                            f"{sorted(map(str, _STORES))}; got "
                            f"{k_pages.dtype}/{v_pages.dtype}")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != SCALE_DTYPE or s.shape != (N, H, page):
                raise TypeError(f"{name} must be {SCALE_DTYPE} "
                                f"(N={N}, H={H}, page={page}); got "
                                f"{s.dtype} {tuple(s.shape)}")
            if not s.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        pools += [k_scale, v_scale]
    devs = {t.device for t in acts + pools + [block_tables, ints]}
    if len(devs) != 1:
        raise ValueError(f"all tensors must lie on one device; got {devs}")
    if block_tables.dtype not in (torch.int32, torch.int64) or \
            ints.dtype not in (torch.int32, torch.int64):
        raise TypeError("block_tables and pos / lengths must be integer "
                        "tensors")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("k_pages", k_pages), ("v_pages", v_pages)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.is_cuda and t.data_ptr() % 16:
            # the kernels read key rows as 16-byte vectors
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _cuda_ready(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head dims {_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.mmlspark_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


#: CUDA device -> (workspace, counters) of the split body, grown to the
#: largest call so far and reused by every split launch on the device:
#: K1/K2 decode (:func:`_fused_window`), K5a/K5b decode
#: (:func:`_window_read`) and K3/K4 (:func:`paged_attention`) share them.
#: The counters are zeroed once, when allocated; every launch leaves them
#: zero. Reuse across calls assumes one stream per device (the engine's,
#: where the launches run one after another): two split launches in
#: flight on two streams of one device would share the buffers.
_split_buffers: dict = {}


def _split_workspace(device, B: int, H: int, P: int, page: int, hd: int,
                     chunk: int, groups: int = 1, group: int = 1):
    """The split body's scratch for a (B, H) call over a block table of
    ``P`` pages whose W queries a row go in ``groups`` groups of
    ``group`` queries a block (one group of one at a decode tick): at
    least (B, H, groups, ceil(P * page / chunk), group, hd + 2) f32
    partials and (B, H, groups) int32 arrival counters, from the device's
    cached buffers (a larger call reallocates them; no call launches a
    memset but one that grows the counters). Returns ``(work,
    counters)``."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n_cnt = B * H * groups
    n_work = n_cnt * (-(-P * page // chunk)) * group * (hd + 2)
    work, cnt = _split_buffers.get(device, (None, None))
    if work is None or work.numel() < n_work or cnt.numel() < n_cnt:
        if work is None or work.numel() < n_work:
            work = torch.empty(n_work, dtype=torch.float32, device=device)
        if cnt is None or cnt.numel() < n_cnt:
            cnt = torch.zeros(n_cnt, dtype=torch.int32, device=device)
        _split_buffers[device] = (work, cnt)
    return work, cnt


def _scratch(lib, out, P: int, page: int, group: int):
    """``(out, work, counters)`` pointers of a launch over a block table
    of ``P`` pages: the split body's cached workspace when it runs with
    ``group`` queries a block (ceil(W / group) groups a row), none when
    ``group`` is 0 (a window on another body)."""
    if not group:
        return out.data_ptr(), None, None
    B, H, W, hd = out.shape
    work, cnt = _split_workspace(out.device, B, H, P, page, hd,
                                 lib.split_chunk, -(-W // group), group)
    return out.data_ptr(), work.data_ptr(), cnt.data_ptr()


def _window_read(q, k_new, v_new, k_pages, v_pages, bt, pos, scale: float,
                 k_scale=None, v_scale=None):
    """The window read (K5a; K5b with scales) on checked, int32,
    contiguous arguments: :func:`paged_attention_window_read_plain` for
    CPU tensors, the kernel for CUDA tensors, counted in
    ``paged_attention_window.launches_window`` (K5a) or
    ``.launches_window_q`` (K5b), and by the body the library reports:
    ``.launches_window(_q)_mma`` (bf16 windows, W > 1, the tensor-core
    body) or ``.launches_window(_q)_split`` (decode, W = 1, the split
    body). One launch a call; the pools are only read."""
    if q.device.type == "cpu":
        return paged_attention_window_read_plain(
            q, k_new, v_new, k_pages, v_pages, bt, pos, scale, k_scale,
            v_scale)
    _cuda_ready(q)
    B, H, W, hd = q.shape
    lib = _library()
    out = torch.empty_like(q)
    scratch = _scratch(lib, out, bt.shape[1], k_pages.shape[2], int(W == 1))
    shape = (B, H, W, bt.shape[1], k_pages.shape[2], float(scale))
    body = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if k_scale is not None:
            err = lib.mmlspark_pa_window_read_q(
                _DTYPES[q.dtype], _STORES[k_pages.dtype], hd, q.data_ptr(),
                k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                bt.data_ptr(), pos.data_ptr(), *scratch, *shape, stream,
                ctypes.byref(body))
        else:
            err = lib.mmlspark_pa_window_read(
                _DTYPES[q.dtype], hd, q.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                bt.data_ptr(), pos.data_ptr(), *scratch, *shape, stream,
                ctypes.byref(body))
    _raise_on(lib, err, "window paged attention")
    paw = paged_attention_window
    if k_scale is not None:
        paw.launches_window_q += 1
        paw.launches_window_q_mma += int(body.value == 1)
        paw.launches_window_q_split += int(body.value == 2)
    else:
        paw.launches_window += 1
        paw.launches_window_mma += int(body.value == 1)
        paw.launches_window_split += int(body.value == 2)
    return out


def _fused_window(q, k_new, v_new, k_pages, v_pages, bt, pos, wlo, whi,
                  scale: float, k_scale=None, v_scale=None):
    """The fused window (K1; K2 with scales) on checked, int32, contiguous
    arguments: :func:`paged_attention_window_plain` for CPU tensors, the
    kernel for CUDA tensors, counted in ``paged_attention_window.launches``
    (K1) or ``.launches_q`` (K2), and by the body the library reports:
    ``.launches(_q)_mma`` (bf16 windows, W > 1, the tensor-core body) or
    ``.launches(_q)_split`` (decode, W = 1, the split body). One launch a
    call; the pools (and scale pools) are updated in place. Returns ctx."""
    if q.device.type == "cpu":
        return paged_attention_window_plain(q, k_new, v_new, k_pages,
                                            v_pages, bt, pos, wlo, whi,
                                            scale, k_scale, v_scale)
    _cuda_ready(q)
    B, H, W, hd = q.shape
    lib = _library()
    out = torch.empty_like(q)
    scratch = _scratch(lib, out, bt.shape[1], k_pages.shape[2], int(W == 1))
    shape = (B, H, W, bt.shape[1], k_pages.shape[2], float(scale))
    body = ctypes.c_int(0)
    ints = (bt.data_ptr(), pos.data_ptr(), wlo.data_ptr(), whi.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if k_scale is not None:
            err = lib.mmlspark_pa_window_fused_q(
                _DTYPES[q.dtype], _STORES[k_pages.dtype], hd, q.data_ptr(),
                k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                *ints, *scratch, *shape, stream, ctypes.byref(body))
        else:
            err = lib.mmlspark_pa_window_fused(
                _DTYPES[q.dtype], hd, q.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                *ints, *scratch, *shape, stream, ctypes.byref(body))
    _raise_on(lib, err, "fused paged attention")
    paw = paged_attention_window
    if k_scale is not None:
        paw.launches_q += 1
        paw.launches_q_mma += int(body.value == 1)
        paw.launches_q_split += int(body.value == 2)
    else:
        paw.launches += 1
        paw.launches_mma += int(body.value == 1)
        paw.launches_split += int(body.value == 2)
    return out


def paged_attention_window(q, k_new, v_new, k_pages, v_pages, block_tables,
                           pos, *, active=None, k_scale=None, v_scale=None,
                           scale: Optional[float] = None, mesh=None,
                           slot_axis: Optional[str] = None,
                           head_axis: Optional[str] = None):
    """Fused decode-window attention + page scatter.

    Row ``b``'s W queries ``q`` (B, H, W, hd) sit at absolute positions
    ``pos[b] .. pos[b]+W-1``; they attend every cached key strictly
    below ``pos[b]`` (read in place from the (N, H, page, hd) pools
    through ``block_tables`` (B, P)) plus the window's own keys
    ``k_new``/``v_new`` under the in-window causal mask. The fresh K/V
    rows are written into their pages — **in place**, the pools are
    mutated — except for rows where ``active`` is False, which write
    nothing. Returns ``(ctx, k_pages, v_pages)``; ctx is (B, H, W, hd)
    in ``q.dtype``, the pools are the tensors that were passed in.

    With ``k_scale``/``v_scale`` (the (N, H, page) bf16 scale pools) the
    pools hold int8 or fp8 codes: reads dequantize, the fresh rows are
    quantized (codes and scales written in place) and the return grows to
    ``(ctx, k_pages, v_pages, k_scale, v_scale)``.

    CPU tensors run :func:`paged_attention_window_plain`. CUDA tensors
    launch the hand-written kernel (K1, or K2 with scales) on the current
    stream and count the launch in ``paged_attention_window.launches``
    (K1) or ``.launches_q`` (K2), and by the body the library reports, as
    :func:`_fused_window` says; anything the kernel does not take
    raises.

    With ``mesh=`` (a ``DeviceMesh``; heads over ``head_axis``, rows over
    ``slot_axis``) the arguments are this rank's: its rows and heads of
    q / k_new / v_new, those rows' ``block_tables`` / ``pos`` /
    ``active``, and its head shard of the pools. The attention then runs
    READ-ONLY (K5a, or K5b with scales, counted in ``.launches_window`` /
    ``.launches_window_q`` and by body, as :func:`_window_read` says; the
    window-read plain version on the CPU) and the fresh rows are written
    after it by :func:`_pool_write_rows` / :func:`_pool_write_rows_quant`,
    the same bytes the fused scatter writes; inactive rows write trash
    page 0. With ``slot_axis`` of size > 1 every dp shard's rows are
    gathered first and all of them written (:func:`_mount_writes`), so
    the pool's dp replicas stay equal; ctx holds this rank's rows."""
    _check(q, k_pages, v_pages, block_tables, pos, k_new=k_new, v_new=v_new,
           k_scale=k_scale, v_scale=v_scale)
    B, H, W, hd = q.shape
    page = k_pages.shape[2]
    quant = k_scale is not None
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    pos = pos.to(torch.int32).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    pools = (k_pages, v_pages) + ((k_scale, v_scale) if quant else ())
    if mesh is not None:
        _check_mesh_axes(mesh, slot_axis, head_axis)
        ctx = _window_read(q, k_new, v_new, k_pages, v_pages, bt, pos,
                           float(scale), k_scale, v_scale)
        _mount_writes(k_new, v_new, pools, bt, pos, active, mesh, slot_axis)
        return (ctx,) + pools
    wlo, whi = write_range(pos, W, page, active)
    ctx = _fused_window(q, k_new, v_new, k_pages, v_pages, bt, pos, wlo, whi,
                        float(scale), k_scale, v_scale)
    return (ctx,) + pools


#: kernel launches since the last reset: K1 (``launches``), K2
#: (``launches_q``), K5a (``launches_window``) and K5b
#: (``launches_window_q``); of each, those the library reports it ran on
#: the tensor-core body (``launches_mma``, ``launches_q_mma``,
#: ``launches_window_mma``, ``launches_window_q_mma``) and on the split
#: decode body (``launches_split``, ``launches_q_split``,
#: ``launches_window_split``, ``launches_window_q_split``); the plain CPU
#: path never counts
paged_attention_window.launches = 0
paged_attention_window.launches_q = 0
paged_attention_window.launches_mma = 0
paged_attention_window.launches_q_mma = 0
paged_attention_window.launches_split = 0
paged_attention_window.launches_q_split = 0
paged_attention_window.launches_window = 0
paged_attention_window.launches_window_q = 0
paged_attention_window.launches_window_mma = 0
paged_attention_window.launches_window_q_mma = 0
paged_attention_window.launches_window_split = 0
paged_attention_window.launches_window_q_split = 0


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    k_scale=None, v_scale=None,
                    scale: Optional[float] = None, mesh=None,
                    slot_axis: Optional[str] = None,
                    head_axis: Optional[str] = None):
    """Read-only paged attention: queries ``q`` (B, H, W, hd) attend the
    first ``lengths[b]`` cached keys of row ``b``, read in place from the
    (N, H, page, hd) pools through ``block_tables`` (B, P); every query of
    a row sees the same keys. A row with ``lengths[b] == 0`` gives zeros.
    With ``k_scale``/``v_scale`` the pools hold quantized codes and are
    dequantized as they are read. Returns (B, H, W, hd) in ``q.dtype``;
    nothing is written.

    CPU tensors run :func:`paged_attention_plain`. CUDA tensors launch
    the hand-written kernel (K3, or K4 with scales) on the current stream
    and count it in ``paged_attention.launches`` (K3) or ``.launches_q``
    (K4), and by the body the library reports: ``.launches(_q)_split``
    (the split body, over the cached workspace of
    :func:`_split_workspace`, one query a block at W = 1 and groups of 4
    at W > 1); anything the kernel does not take raises.

    With ``mesh=`` the arguments are this rank's: q's rows over
    ``slot_axis`` and heads over ``head_axis``, those rows' block tables
    and lengths, and the pools' heads over ``head_axis``; the sweep runs
    on them as they are, with no collective (it writes nothing)."""
    _check(q, k_pages, v_pages, block_tables, lengths, k_scale=k_scale,
           v_scale=v_scale)
    if mesh is not None:
        _check_mesh_axes(mesh, slot_axis, head_axis)
    B, H, W, hd = q.shape
    page = k_pages.shape[2]
    quant = k_scale is not None
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    lengths = lengths.to(torch.int32).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, bt, lengths,
                                     float(scale), k_scale, v_scale)
    _cuda_ready(q)
    lib = _library()
    out = torch.empty_like(q)
    scratch = _scratch(lib, out, bt.shape[1], page,
                       lib.mmlspark_pa_read_group(W))
    shape = (B, H, W, bt.shape[1], page, float(scale))
    body = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quant:
            err = lib.mmlspark_pa_read_q(
                _DTYPES[q.dtype], _STORES[k_pages.dtype], hd, q.data_ptr(),
                k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), bt.data_ptr(), lengths.data_ptr(),
                *scratch, *shape, stream, ctypes.byref(body))
        else:
            err = lib.mmlspark_pa_read(
                _DTYPES[q.dtype], hd, q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), bt.data_ptr(), lengths.data_ptr(),
                *scratch, *shape, stream, ctypes.byref(body))
    _raise_on(lib, err, "read-only paged attention")
    pa = paged_attention
    if quant:
        pa.launches_q += 1
        pa.launches_q_split += int(body.value == 2)
    else:
        pa.launches += 1
        pa.launches_split += int(body.value == 2)
    return out


#: kernel launches since the last reset: K3 (``launches``) and K4
#: (``launches_q``); of each, those the library reports it ran on the
#: split body (``launches_split``, ``launches_q_split``); the plain CPU
#: path never counts
paged_attention.launches = 0
paged_attention.launches_q = 0
paged_attention.launches_split = 0
paged_attention.launches_q_split = 0
