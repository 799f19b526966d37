"""Port parity: the mesh mount of paged attention (``ops/paged_attention.py``
with ``mesh=``) and the window read-only kernels' plain versions.

* K5a/K5b's plain version (``paged_attention_window_read_plain``)
  against the JAX ``_pa_window_read_call`` / ``_pa_window_read_call_q``
  in Pallas interpret mode: ctx within 1e-5 in f32 (online vs one-shot
  softmax reorders the sums), within one bf16 ulp (2**-7 relative) with
  bf16 queries; pools never written.
* The mesh path's page writers ``_pool_write_rows(_quant)`` against the
  JAX ones, bitwise (pages, codes, scales, trash page 0 included), and
  against the port's fused plain scatter off page 0.
* The mount on a tp = 2 gloo world of two CPU ranks (each holding two of
  four heads) against the JAX mount on a ("tp",) 2-device mesh: ctx
  all-gathered over heads within 1e-5 (one bf16 ulp with bf16
  queries), pools bitwise off page 0.
* The card's two K5 bodies emulated in plain PyTorch against the plain
  version: the tensor-core body (bf16 windows, W > 1: P or P · sv
  rounded to bf16 once, no scatter) within 2⁻⁸ · R plus the output's
  rounding; the split decode body (W = 1: chunked partial (m, l, acc),
  then the merge) within 1e-6 in f32; and the split body's cached
  workspace. The same split body with K1/K2's page scatter in the last
  live chunk's block against the fused plain version: ctx within 1e-6,
  pages and scales bitwise, inactive rows' pages untouched.

JAX runs on the conftest's 8 host devices; the ranks run
``tests/test_torch_mesh_ranks.py``, which imports no JAX.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mmlspark_tpu.ops import kv_quant as ref_q
from mmlspark_tpu.ops import paged_attention as ref_pa
from mmlspark_tpu_torch.ops import kv_quant as port_q
from mmlspark_tpu_torch.ops import paged_attention as port_pa
from mmlspark_tpu_torch.parallel import distributed as port_dist
from mmlspark_tpu_torch.parallel import mesh as port_mesh
from mmlspark_tpu_torch.parallel.launch import run_ranks

import test_torch_mesh_ranks as ranks
from test_torch_paged_attention import (STORES, _bf16_window_emulation,
                                        _rounding_inputs)

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

F32 = dict(rtol=1e-5, atol=1e-5)
#: bf16 outputs round one f32 value each: at most one bf16 ulp apart
BF16 = dict(rtol=2.0 ** -7, atol=1e-6)

B, H, HD, PAGE, P, W = 4, 4, 8, 4, 4, 4
#: a row at pos 0, windows crossing a page boundary, an inactive row
POS = np.array([0, 6, 9, 3], np.int32)
ACTIVE = np.array([True, True, False, True])
LENGTHS = np.array([0, 5, 16, 9], np.int32)


def _np_bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _t_bits(t):
    """A tensor's raw bits as a numpy copy (a snapshot: later in-place
    writes to ``t`` do not show in it)."""
    return _np_bits(t.view({1: torch.uint8, 2: torch.int16,
                            4: torch.int32}[t.element_size()]).numpy().copy())


def _to_torch(a):
    """A numpy / jax array → torch, bit for bit (bf16 and fp8 included)."""
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return ranks.to_torch(a.view({2: np.int16, 1: np.uint8}[a.itemsize]),
                              a.dtype.name)
    return torch.from_numpy(a.copy())


def _wire(a):
    """A jax / numpy array as the ranks receive it: raw bits + dtype."""
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return a.view({2: np.int16, 1: np.uint8}[a.itemsize]), a.dtype.name
    return a, None


def _from_wire(bits, like):
    """Raw bits back from a rank, as float32 values of ``like``'s dtype."""
    return np.asarray(bits).view(np.asarray(like).dtype).astype(np.float32)


def _case(seed, dtype, store, W=W):
    """Seeded inputs: q / k_new / v_new (B, H, W, HD) in ``dtype``; pools
    in ``dtype`` or quantized by the reference quantizer to ``store``; a
    shuffled block table."""
    rng = np.random.default_rng(seed)
    N = 1 + B * P
    act = [jnp.asarray(rng.normal(0, 1, (B, H, W, HD)), dtype)
           for _ in range(3)]
    raw = [jnp.asarray(rng.normal(0, 1, (N, H, PAGE, HD)), jnp.float32)
           for _ in range(2)]
    if store is None:
        pools = [r.astype(dtype) for r in raw]
    else:
        st = ref_q.kv_store_dtype(store)
        (kp, ks), (vp, vs) = (ref_q.quantize_kv(r, st) for r in raw)
        pools = [kp, vp, ks, vs]
    bt = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    return act, pools, bt


def _jax_window_read(act, pools, bt, pos):
    q, kn, vn = act
    W = q.shape[2]
    Wp = ref_pa._round_up(W, ref_pa.sublane_multiple(q.dtype))
    pad = [ref_pa._pad_window(t, Wp) for t in act]
    kw = dict(W=W, scale=float(1 / np.sqrt(HD)), interpret=True)
    if len(pools) == 4:
        out = ref_pa._pa_window_read_call_q(*pad, *pools, jnp.asarray(bt),
                                            jnp.asarray(pos), **kw)
    else:
        out = ref_pa._pa_window_read_call(*pad, *pools, jnp.asarray(bt),
                                          jnp.asarray(pos), **kw)
    return np.asarray(out[:, :, :W].astype(jnp.float32))


CASES = [(jnp.float32, None), (jnp.bfloat16, None), (jnp.float32, "int8"),
         (jnp.bfloat16, "int8"), (jnp.float32, "fp8"), (jnp.bfloat16, "fp8")]


@pytest.mark.parametrize("dtype,store", CASES,
                         ids=[f"{jnp.dtype(d).name}-{s or 'plain'}"
                              for d, s in CASES])
def test_window_read_plain_matches_reference(dtype, store):
    act, pools, bt = _case(1, dtype, store)
    want = _jax_window_read(act, pools, bt, POS)
    pools_t = [_to_torch(p) for p in pools]
    before = [t.clone() for t in pools_t]
    got = port_pa.paged_attention_window_read_plain(
        *[_to_torch(a) for a in act], pools_t[0], pools_t[1],
        torch.from_numpy(bt), torch.from_numpy(POS), float(1 / np.sqrt(HD)),
        *pools_t[2:])
    assert got.dtype == _to_torch(act[0]).dtype and got.shape == (B, H, W, HD)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32 if dtype == jnp.float32 else BF16))
    # read-only: every pool bit unchanged
    for a, b in zip(pools_t, before):
        assert np.array_equal(_t_bits(a), _t_bits(b))


@pytest.mark.parametrize("dtype,store", CASES,
                         ids=[f"{jnp.dtype(d).name}-{s or 'plain'}"
                              for d, s in CASES])
def test_window_read_plain_decode_matches_reference(dtype, store):
    """The decode tick's shape (W = 1, what the split body computes on
    the card): a row at pos 0, one mid-page, one past a page boundary,
    one at the block table's last key."""
    act, pools, bt = _case(6, dtype, store, W=1)
    pos = np.array([0, 6, 9, P * PAGE - 1], np.int32)
    want = _jax_window_read(act, pools, bt, pos)
    pools_t = [_to_torch(p) for p in pools]
    got = port_pa.paged_attention_window_read_plain(
        *[_to_torch(a) for a in act], pools_t[0], pools_t[1],
        torch.from_numpy(bt), torch.from_numpy(pos), float(1 / np.sqrt(HD)),
        *pools_t[2:])
    assert got.shape == (B, H, 1, HD)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32 if dtype == jnp.float32 else BF16))


WINDOW_COUNTERS = ("launches_window", "launches_window_q",
                   "launches_window_mma", "launches_window_q_mma",
                   "launches_window_split", "launches_window_q_split")


def _cpu_window_read_counts(w):
    """The window read wrapper at window ``w`` on CPU tensors: returns
    (its ctx equals the plain version's, the counters it moved)."""
    act, pools, bt = _case(2, jnp.float32, None, W=w)
    args = [_to_torch(a) for a in act] + [_to_torch(p) for p in pools]
    paw = port_pa.paged_attention_window
    for name in WINDOW_COUNTERS:
        setattr(paw, name, 0)
    got = port_pa._window_read(*args, torch.from_numpy(bt),
                               torch.from_numpy(POS), float(1 / np.sqrt(HD)))
    want = port_pa.paged_attention_window_read_plain(
        *args, torch.from_numpy(bt), torch.from_numpy(POS),
        float(1 / np.sqrt(HD)))
    return torch.equal(got, want), [getattr(paw, n) for n in WINDOW_COUNTERS]


def test_window_read_wrapper_runs_plain_on_cpu_and_never_counts():
    assert _cpu_window_read_counts(W) == (True, [0] * 6)


def test_window_read_decode_wrapper_runs_plain_on_cpu_and_never_counts():
    """W = 1 (the split body's shape on the card): the plain version, no
    count, and no split workspace allocated on the CPU."""
    assert _cpu_window_read_counts(1) == (True, [0] * 6)
    assert torch.device("cpu") not in port_pa._split_buffers


# ---- the card's K5 bodies, emulated on the CPU -----------------------------

@pytest.mark.parametrize("store", STORES)
def test_window_read_mma_emulation_within_bound(store):
    """K5a/K5b at W > 1 with bf16 queries run the tensor-core body: P
    (K5a) or P · sv (K5b) rounded to bf16 once a 32-key tile, no
    scatter, the output rounded to bf16. Emulated in plain PyTorch, that
    stays within 2^-8 * R plus the output's own rounding (2^-8 of it)
    of the window read's plain version in f32, on every row (the
    engine's inactive one too: the read computes every row); the NaN
    planted at and past pos stays out and the pools are only read."""
    q, kn, vn, pools, bt, pos, _ = _rounding_inputs(store, 52)
    scale = q.shape[-1] ** -0.5
    before = [_t_bits(t) for t in pools]
    want = port_pa.paged_attention_window_read_plain(
        q, kn, vn, pools[0], pools[1], bt, pos, scale, *pools[2:])
    r = port_pa.paged_rounding_scale(q, kn, vn, pools[0], pools[1], bt, pos,
                                     k_scale=(pools[2:] or [None])[0],
                                     v_scale=(pools[3:] or [None])[0])
    emul = _bf16_window_emulation(q, kn, vn, pools, bt, pos, scale)
    got = emul.bfloat16().float()
    err = (got - want).abs()
    bound = 2.0 ** -8 * (r + emul.abs()) + 1e-6 * want.abs().max()
    assert torch.isfinite(got).all()
    assert bool((err <= bound).all()), float((err - bound).max())
    assert float((emul - want).abs().max()) > 0.0   # P was rounded
    assert all(np.array_equal(_t_bits(t), b) for t, b in zip(pools, before))


#: the split body's geometry (csrc/paged_attention.cu): 32-key tiles, 4
#: warps a block, 2 tiles a warp, so a block reads a chunk of 256 keys
SPLIT_TILE, SPLIT_WARPS, SPLIT_TILES = 32, 4, 2


def _quant_row(x, store):
    """The split body's ``quant_row`` on one (hd,) f32 row: amax, the
    scale rounded to bf16 (1 for an all-zero row), x / f32(scale) as an
    IEEE division, then int8 rint-and-clip or fp8 clip-and-round."""
    qmax = 127.0 if store == torch.int8 else 448.0
    amax = x.abs().max()
    s16 = torch.where(amax > 0, amax / qmax, torch.ones(())).to(
        torch.bfloat16)
    y = torch.clamp(x / s16.float(), -qmax, qmax)
    return (torch.round(y) if store == torch.int8 else y).to(store), s16


def _split_decode_emulation(q, kn, vn, pools, bt, pos, scale, write=None):
    """The split decode body's algorithm in plain PyTorch, f32, W = 1.
    Row b's cached keys [0, pos) (never past the block table) are cut into
    chunks of SPLIT_WARPS * SPLIT_TILES * SPLIT_TILE keys, the first
    max(1, ceil(pos / chunk)) of them live; in each, warp w walks tiles w,
    w + SPLIT_WARPS, ... with an online softmax, warp 0 of the last live
    chunk then takes the row's fresh key, the warps' (m, l, acc) merge
    into the chunk's partial, and the partials merge into ctx. Only keys
    below pos are gathered: what lies past it is never read.

    ``write=(wlo, whi)`` adds K1/K2's scatter (MODE kFused): the block of
    each (row, head)'s last live chunk writes the fresh K and V rows at
    pos into their page, in place, copied in the pool dtype or quantized
    by :func:`_quant_row`, when the page lies in [wlo, whi] (empty for an
    inactive row) and inside the block table."""
    B, H, _, hd = q.shape
    out = torch.zeros(B, H, 1, hd)
    for b in range(B):
        k, v = _live_rows(pools, bt, b, int(pos[b]))
        qb = q[b, :, 0].float()
        chunks = _split_chunks(k.shape[0])
        parts = []
        for c, (lo, hi) in enumerate(chunks):
            warps = [_warp_walk(qb, k, v, lo, hi, w, scale)
                     for w in range(SPLIT_WARPS)]
            if c == len(chunks) - 1:
                # warp 0 of the last live chunk takes the fresh key
                s = (qb * kn[b, :, 0].float()).sum(-1)[:, None] * scale
                warps[0] = _online(warps[0], s, vn[b, :, 0].float()[None])
            parts.append(_merge(warps))
            if write is not None and c == len(chunks) - 1:
                _split_scatter(kn, vn, pools, bt, b, int(pos[b]),
                               int(write[0][b]), int(write[1][b]))
        _, l_, acc = _merge(parts)
        out[b, :, 0] = acc / torch.where(l_ == 0, 1.0, l_)[:, None]
    return out


def _merge(states):
    """Softmax states (m, l, acc) merged: m (H, ...), acc (H, ..., hd)."""
    m = torch.stack([s[0] for s in states]).amax(0)
    c = [torch.exp(s[0] - m) for s in states]
    return (m, sum(s[1] * ci for s, ci in zip(states, c)),
            sum(s[2] * ci[..., None] for s, ci in zip(states, c)))


def _online(state, s, v):
    """One tile (or key) folded into a state: s (H, ..., k), v (k, H, hd)."""
    m, l_, acc = state
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    return (m_new, corr * l_ + p.sum(-1),
            corr[..., None] * acc + torch.einsum("h...k,khd->h...d", p, v))


def _live_rows(pools, bt, b, bound):
    """Row ``b``'s cached K and V below ``bound`` (never past the block
    table) as (n, H, hd) f32, dequantized through their scales: only
    these keys are gathered, so what lies past the bound is never
    read."""
    page, P = pools[0].shape[2], bt.shape[1]
    keys = torch.arange(max(0, min(bound, P * page)))
    pg, off = bt[b, keys // page].long(), keys % page
    k, v = (pools[i][pg, :, off].float() for i in (0, 1))
    if len(pools) == 4:
        k = k * pools[2][pg, :, off].float()[..., None]
        v = v * pools[3][pg, :, off].float()[..., None]
    return k, v


def _split_chunks(n):
    """The live chunks [lo, hi) of a row of ``n`` keys: max(1, ceil(n /
    chunk)), the one of an empty row holding no key."""
    chunk = SPLIT_WARPS * SPLIT_TILES * SPLIT_TILE
    return [(c * chunk, min((c + 1) * chunk, n))
            for c in range(max(1, -(-n // chunk)))]


def _warp_walk(qs, k, v, lo, hi, w, scale):
    """Warp ``w``'s state over chunk [lo, hi): its tiles w, w +
    SPLIT_WARPS, ... with an online softmax; ``qs`` (H, hd) or (H, QG,
    hd), the state's m and l shaped like its scores less the key axis."""
    lead = qs.shape[:-1]
    st = (torch.full(lead, -1e30), torch.zeros(lead),
          torch.zeros(qs.shape))
    for t in range(w, SPLIT_WARPS * SPLIT_TILES, SPLIT_WARPS):
        t0 = lo + t * SPLIT_TILE
        if t0 < hi:
            t1 = min(t0 + SPLIT_TILE, hi)
            s = torch.einsum("h...d,khd->h...k", qs, k[t0:t1]) * scale
            st = _online(st, s, v[t0:t1])
    return st


def _split_read_emulation(q, pools, bt, lengths, scale, group):
    """The split body's read-only sweep (K3/K4, MODE kRead) in plain
    PyTorch, f32: row b's keys [0, min(lengths[b], P * page)) are cut
    into the live chunks of :func:`_split_chunks` and its W queries into
    groups of ``group`` (1 at W = 1, 4 on the card at W > 1), the slots
    past W zero; for each group and chunk the warps walk their tiles
    (:func:`_warp_walk`), their states merge into the chunk's partial,
    and the partials merge in chunk order into the group's context, of
    which only the queries inside W are written. No fresh key, nothing
    written but the output; a row with no key gives exactly 0."""
    B, H, W, hd = q.shape
    out = torch.zeros(B, H, W, hd)
    for b in range(B):
        k, v = _live_rows(pools, bt, b, int(lengths[b]))
        for g0 in range(0, W, group):
            nq = min(group, W - g0)
            qs = torch.zeros(H, group, hd)
            qs[:, :nq] = q[b, :, g0:g0 + nq].float()
            parts = [_merge([_warp_walk(qs, k, v, lo, hi, w, scale)
                             for w in range(SPLIT_WARPS)])
                     for lo, hi in _split_chunks(k.shape[0])]
            _, l_, acc = _merge(parts)
            ctx = acc / torch.where(l_ == 0, 1.0, l_)[..., None]
            out[b, :, g0:g0 + nq] = ctx[:, :nq]
    return out


def _split_scatter(kn, vn, pools, bt, b, pos, wlo, whi):
    """The last live chunk's ``fused_scatter`` for row ``b``, every head:
    its fresh K and V rows into the slot at ``pos``, in place."""
    page, P = pools[0].shape[2], bt.shape[1]
    lp = pos // page
    if wlo > whi or not wlo <= lp <= whi or lp >= P:
        return
    pg, off = int(bt[b, lp]), pos % page
    for h in range(kn.shape[1]):
        for i, new in enumerate((kn, vn)):
            row = new[b, h, 0]
            if len(pools) == 2:
                pools[i][pg, h, off] = row.to(pools[i].dtype)
            else:
                codes, s16 = _quant_row(row.float(), pools[i].dtype)
                port_pa._bits(pools[i])[pg, h, off] = port_pa._bits(codes)
                pools[2 + i][pg, h, off] = s16


def _split_inputs(store, page, pos, seed):
    """f32 decode inputs (H = 2, hd = 64) over a shuffled block table at
    least 1032 keys wide, with f32, int8 or fp8 pools and NaN planted at
    and past each row's pos (values, or the scales of quantized pools)."""
    rng = np.random.default_rng(seed)
    H_, hd = 2, 64
    P_ = -(-1032 // page)
    B_ = pos.numel()
    raw = [torch.from_numpy(rng.normal(0, 1, (1 + B_ * P_, H_, page, hd)
                                       ).astype(np.float32))
           for _ in range(2)]
    q, kn, vn = (torch.from_numpy(rng.normal(0, 1, (B_, H_, 1, hd)
                                             ).astype(np.float32))
                 for _ in range(3))
    bt = torch.from_numpy((1 + rng.permutation(B_ * P_)).reshape(B_, P_)
                          .astype(np.int32))
    if store is None:
        pools = raw
    else:
        dt = port_q.kv_store_dtype(store)
        (kc, ks), (vc, vs) = (port_q.quantize_kv(r, dt) for r in raw)
        pools = [kc, vc, ks, vs]
    keys = torch.arange(P_ * page)
    for b in range(B_):
        dead = keys >= int(pos[b])
        pg, off = bt[b, keys[dead] // page].long(), keys[dead] % page
        for t in (pools[:2] if store is None else pools[2:]):
            t[pg, :, off] = float("nan")
    return q, kn, vn, pools, bt


@pytest.mark.parametrize("page", [16, 1, 24])
@pytest.mark.parametrize("store", [None, "int8", "fp8"])
def test_split_decode_emulation_matches_plain(store, page):
    """The split decode body's chunked partials and merge equal the plain
    window read in f32 to 1e-6 of the largest |ctx|. Rows: pos 0 (the
    fresh key alone), 255 / 256 (one chunk, full or one key short), 300
    (a second chunk; at page 24 the chunk boundary 256 falls inside a
    page), 1000 (four chunks), and the block table's last key; the table
    is 1032 keys wide, so the short rows' later chunks are empty. The
    engine's inactive row (the third) is computed like any other, and
    the NaN planted at and past each pos stays out."""
    P_ = -(-1032 // page)
    pos = torch.tensor([0, 255, 256, 300, 1000, P_ * page - 1],
                       dtype=torch.int32)
    q, kn, vn, pools, bt = _split_inputs(store, page, pos, 7)
    scale = 64 ** -0.5
    want = port_pa.paged_attention_window_read_plain(
        q, kn, vn, pools[0], pools[1], bt, pos, scale, *pools[2:])
    got = _split_decode_emulation(q, kn, vn, pools, bt, pos, scale)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0.0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("page", [16, 1, 24])
@pytest.mark.parametrize("store", [None, "int8", "fp8"])
def test_split_fused_emulation_matches_plain(store, page):
    """K1/K2 at W = 1 on the split body (MODE kFused): the chunked
    partials and merge, plus the fresh row's page write by the block of
    the last live chunk, against the fused plain version: ctx within
    1e-6 of the largest |ctx|, every page and scale bitwise. Rows at pos
    0 (the fresh key alone), 255 / 256 / 257 (around the first chunk
    boundary), 511 / 512 and 1023 (the table's 1024th key, three chunks
    on); two inactive rows (at 256 and 700) compute their context and
    leave every one of their pages untouched, NaN planted at pos
    included."""
    pos = torch.tensor([0, 255, 256, 257, 511, 512, 1023, 256, 700],
                       dtype=torch.int32)
    active = torch.tensor([True] * 7 + [False] * 2)
    q, kn, vn, pools, bt = _split_inputs(store, page, pos, 11)
    wlo, whi = port_pa.write_range(pos, 1, page, active)
    scale = 64 ** -0.5
    before = [_t_bits(t) for t in pools]
    plain = [t.clone() for t in pools]
    want = port_pa.paged_attention_window_plain(
        q, kn, vn, plain[0], plain[1], bt, pos, wlo, whi, scale, *plain[2:])
    got = _split_decode_emulation(q, kn, vn, pools, bt, pos, scale,
                                  write=(wlo, whi))
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0.0,
                               atol=1e-6 * float(want.abs().max()))
    for t, w, b0 in zip(pools, plain, before):
        assert np.array_equal(_t_bits(t), _t_bits(w))
        assert not np.array_equal(_t_bits(t), b0)     # the rows were written
    for b in (7, 8):
        rows = bt[b].long().numpy()
        assert all(np.array_equal(_t_bits(t)[rows], b0[rows])
                   for t, b0 in zip(pools, before))


#: the read emulation's rows: no key, one, around the first chunk
#: boundary (255 / 256 / 257), the table's 1023rd key, and past the table
READ_LENGTHS = [0, 1, 255, 256, 257, 1023, 1100]
READ_CASES = [(d, s) for d in (jnp.float32, jnp.bfloat16)
              for s in (None, "int8", "fp8")]


@functools.lru_cache(maxsize=None)
def _read_case(dtype, store, page):
    """Seeded sweep inputs (H = 2, hd = 64, 9 queries a row) over a
    shuffled block table of 1032 keys or more, the JAX ``paged_attention``
    (interpret mode) on them, and the port's copies with NaN planted past
    each row's length: in the values of plain pools, in the scales (and,
    fp8, the codes) of quantized ones. A row's queries are independent,
    so a call at W < 9 takes the first W of each row, ctx included.
    Returns (q, pools, bt, lengths, JAX ctx in f32), the first three
    torch."""
    rng = np.random.default_rng(31)
    B_, H_, W_, hd = len(READ_LENGTHS), 2, 9, 64
    P_ = -(-1032 // page)
    q = jnp.asarray(rng.normal(0, 1, (B_, H_, W_, hd)), dtype)
    raw = [jnp.asarray(rng.normal(0, 1, (1 + B_ * P_, H_, page, hd)),
                       jnp.float32) for _ in range(2)]
    if store is None:
        pools = [r.astype(dtype) for r in raw]
        kw = {}
    else:
        st = ref_q.kv_store_dtype(store)
        (kp, ks), (vp, vs) = (ref_q.quantize_kv(r, st) for r in raw)
        pools, kw = [kp, vp], {"k_scale": ks, "v_scale": vs}
    bt = (1 + rng.permutation(B_ * P_)).reshape(B_, P_).astype(np.int32)
    lengths = np.array(READ_LENGTHS, np.int32)
    want = ref_pa.paged_attention(q, *pools, jnp.asarray(bt),
                                  jnp.asarray(lengths), interpret=True, **kw)
    pools_t = [_to_torch(a) for a in pools + list(kw.values())]
    keys = torch.arange(P_ * page)
    for b, n in enumerate(READ_LENGTHS):
        dead = keys >= n
        pg, off = (torch.from_numpy(bt)[b, keys[dead] // page].long(),
                   keys[dead] % page)
        for t in (pools_t[:2] if store is None else pools_t[2:]):
            t[pg, :, off] = float("nan")
        if store == "fp8":
            for t in pools_t[:2]:
                t.view(torch.uint8)[pg, :, off] = 0x7F
    return (_to_torch(q), pools_t, torch.from_numpy(bt),
            torch.from_numpy(lengths), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("W", [1, 4, 5, 9])
@pytest.mark.parametrize("page", [16, 1])
@pytest.mark.parametrize("dtype,store", READ_CASES,
                         ids=[f"{jnp.dtype(d).name}-{s or 'plain'}"
                              for d, s in READ_CASES])
def test_split_read_emulation_matches_plain_and_reference(dtype, store,
                                                          page, W):
    """K3/K4 on the split body (MODE kRead), one query a block at W = 1
    and groups of 4 at W > 1 (W = 5 and 9 leave a group with one query
    and three empty slots): the chunked partials and their merge, in f32,
    equal the plain version to 1e-6 of the largest |ctx| and the JAX
    ``paged_attention`` in interpret mode within the file's F32 (BF16
    with bf16 queries, both rounded once) tolerance. The NaN planted past
    every length stays out, the row with no key is exactly 0, and the
    pools are only read."""
    q9, pools, bt, lengths, want9 = _read_case(dtype, store, page)
    q = q9[:, :, :W].contiguous()
    scale = 64 ** -0.5
    before = [_t_bits(t) for t in pools]
    group = 1 if W == 1 else 4
    got = _split_read_emulation(q, pools, bt, lengths, scale, group)
    plain = port_pa.paged_attention_plain(q.float(), pools[0], pools[1], bt,
                                          lengths, scale, *pools[2:])
    assert torch.isfinite(got).all() and torch.isfinite(plain).all()
    torch.testing.assert_close(got, plain, rtol=0.0,
                               atol=1e-6 * float(plain.abs().max()))
    assert float(got[0].abs().max()) == 0.0
    np.testing.assert_allclose(got.to(q.dtype).float().numpy(),
                               want9[:, :, :W],
                               **(F32 if dtype == jnp.float32 else BF16))
    assert all(np.array_equal(_t_bits(t), b0) for t, b0 in zip(pools, before))


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("store", [None, "int8"])
def test_read_wrapper_runs_plain_on_cpu_and_never_counts(store, W):
    """``paged_attention`` on CPU tensors is the plain version, bitwise,
    and no launch of any body: every K3/K4 counter stays put and no split
    workspace is allocated on the CPU."""
    q9, pools, bt, lengths, _ = _read_case(jnp.float32, store, 16)
    q = q9[:, :, :W].contiguous()
    pa = port_pa.paged_attention
    names = ("launches", "launches_q", "launches_split", "launches_q_split")
    before = [getattr(pa, n) for n in names]
    kw = {"k_scale": pools[2], "v_scale": pools[3]} if store else {}
    got = pa(q, pools[0], pools[1], bt, lengths, **kw)
    want = port_pa.paged_attention_plain(q, pools[0], pools[1], bt, lengths,
                                         64 ** -0.5, *pools[2:])
    assert torch.equal(got, want)
    assert [getattr(pa, n) for n in names] == before
    assert torch.device("cpu") not in port_pa._split_buffers


def test_split_workspace_is_cached_and_grows():
    """The split body's scratch: (B, H, groups, chunks, group, hd + 2) f32
    partials and (B, H, groups) counters, zeroed once when allocated,
    reused by calls that fit (a decode tick's one group of one, or a
    sweep's groups of 4), reallocated (counters zeroed again) by one that
    does not, including a sweep with more groups than any call before."""
    dev = torch.device("cpu")
    port_pa._split_buffers.pop(dev, None)
    try:
        work, cnt = port_pa._split_workspace(dev, 16, 12, 64, 16, 64, 256)
        assert work.numel() == 16 * 12 * 4 * 66 and work.dtype == torch.float32
        assert cnt.numel() == 16 * 12 and not cnt.any()
        cnt[3] = 1      # a launch leaves them 0; this marks the buffer
        w2, c2 = port_pa._split_workspace(dev, 4, 6, 33, 16, 64, 256)
        assert w2 is work and c2 is cnt          # fits: reused as is
        w3, c3 = port_pa._split_workspace(dev, 16, 12, 128, 16, 64, 256)
        assert w3.numel() == 16 * 12 * 8 * 66 and c3 is cnt
        w4, c4 = port_pa._split_workspace(dev, 32, 12, 64, 16, 64, 256)
        assert c4.numel() == 32 * 12 and not c4.any() and w4 is w3
        cached = port_pa._split_buffers[dev]
        assert cached[0] is w4 and cached[1] is c4
        # the sweep at W = 4: one group of 4 a (row, head), 4 x the
        # partials of a decode tick over the same table, same counters
        c4[5] = 1
        w5, c5 = port_pa._split_workspace(dev, 16, 12, 64, 16, 64, 256, 1, 4)
        assert w5.numel() == 16 * 12 * 4 * 4 * 66 and c5 is c4
        # W = 9: three groups; more counters than any call before
        w6, c6 = port_pa._split_workspace(dev, 16, 12, 64, 16, 64, 256, 3, 4)
        assert w6.numel() == 16 * 12 * 3 * 4 * 4 * 66
        assert c6.numel() == 16 * 12 * 3 and not c6.any()
        # a decode tick after it fits both
        assert port_pa._split_workspace(dev, 16, 12, 64, 16, 64,
                                        256) == (w6, c6)
        # scratch pointers: the split body's buffers when it runs with
        # ``group`` queries a block, none for another body
        lib = types.SimpleNamespace(split_chunk=256)
        out = torch.empty(16, 12, 9, 64)
        assert port_pa._scratch(lib, out, 64, 16, 0) == (out.data_ptr(),
                                                          None, None)
        assert port_pa._scratch(lib, out, 64, 16, 4) == (
            out.data_ptr(), w6.data_ptr(), c6.data_ptr())
    finally:
        port_pa._split_buffers.pop(dev, None)


WRITER_CASES = [(jnp.float32, None), (jnp.bfloat16, None),
                (jnp.float32, "int8"), (jnp.bfloat16, "int8"),
                (jnp.float32, "fp8")]


@pytest.mark.parametrize("dtype,store", WRITER_CASES,
                         ids=[f"{jnp.dtype(d).name}-{s or 'plain'}"
                              for d, s in WRITER_CASES])
def test_pool_writers_bitwise_vs_reference(dtype, store):
    act, pools, bt = _case(3, dtype, store)
    _, kn, vn = act
    pos_j, bt_j, act_j = (jnp.asarray(x) for x in (POS, bt, ACTIVE))
    pos_t, bt_t, act_t = (torch.from_numpy(x) for x in (POS, bt, ACTIVE))
    mine = [_to_torch(p) for p in pools]
    fused = [t.clone() for t in mine]
    if store is None:
        want = [ref_pa._pool_write_rows(pools[0], kn, bt_j, pos_j, act_j),
                ref_pa._pool_write_rows(pools[1], vn, bt_j, pos_j, act_j)]
        got = [port_pa._pool_write_rows(mine[0], _to_torch(kn), bt_t,
                                        pos_t, act_t),
               port_pa._pool_write_rows(mine[1], _to_torch(vn), bt_t,
                                        pos_t, act_t)]
    else:
        (kp, ks), (vp, vs) = (
            ref_pa._pool_write_rows_quant(pools[i], pools[i + 2], rows,
                                          bt_j, pos_j, act_j)
            for i, rows in ((0, kn), (1, vn)))
        want = [kp, vp, ks, vs]
        k_out = port_pa._pool_write_rows_quant(mine[0], mine[2],
                                               _to_torch(kn), bt_t, pos_t,
                                               act_t)
        v_out = port_pa._pool_write_rows_quant(mine[1], mine[3],
                                               _to_torch(vn), bt_t, pos_t,
                                               act_t)
        got = [k_out[0], v_out[0], k_out[1], v_out[1]]
    # in place, and bitwise the reference's, trash page 0 included (one
    # inactive row and W <= page: its trash writes never collide)
    assert all(g is m for g, m in zip(got, mine))
    for g, w in zip(got, want):
        assert np.array_equal(_t_bits(g), _np_bits(w))
    # the fused plain scatter writes the same bytes everywhere but page 0
    wlo, whi = port_pa.write_range(pos_t, W, PAGE, act_t)
    port_pa.paged_attention_window_plain(
        *[_to_torch(a) for a in act], fused[0], fused[1], bt_t, pos_t, wlo,
        whi, float(1 / np.sqrt(HD)), *fused[2:])
    for f, g in zip(fused, got):
        assert np.array_equal(_t_bits(f)[1:], _t_bits(g)[1:])


MOUNT_CASES = [(jnp.float32, None), (jnp.float32, "int8"),
               (jnp.bfloat16, "fp8")]


@pytest.fixture(scope="module")
def mounts():
    """Both mounts, JAX on a ("tp",) 2-device mesh and the port on a
    tp = 2 world of two gloo ranks, over the same inputs."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    want, wire = [], []
    for i, (dtype, store) in enumerate(MOUNT_CASES):
        act, pools, bt = _case(10 + i, dtype, store)
        kw = ({"k_scale": pools[2], "v_scale": pools[3]}
              if store is not None else {})
        ctx, *new_pools = ref_pa.paged_attention_window(
            *act, pools[0], pools[1], jnp.asarray(bt), jnp.asarray(POS),
            active=jnp.asarray(ACTIVE), mesh=mesh, head_axis="tp",
            interpret=True, **kw)
        read = ref_pa.paged_attention(
            act[0], pools[0], pools[1], jnp.asarray(bt),
            jnp.asarray(LENGTHS), mesh=mesh, head_axis="tp", interpret=True,
            **kw)
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
    got = run_ranks(ranks.mount_cases, 2, args=(wire,), device="cpu",
                    threads=1, timeout=300)
    return want, got


@pytest.mark.parametrize("i", range(len(MOUNT_CASES)),
                         ids=[f"{jnp.dtype(d).name}-{s or 'plain'}"
                              for d, s in MOUNT_CASES])
def test_window_mount_matches_reference_tp2(mounts, i):
    want, got = mounts
    tol = F32 if MOUNT_CASES[i][0] == jnp.float32 else BF16
    for rank in (0, 1):
        ctx = _from_wire(got[rank][i]["ctx"], want[i]["dtype"])
        np.testing.assert_allclose(ctx, want[i]["ctx"], **tol)
    # each rank holds its two heads of every page; together, off the
    # trash page, they are the JAX mount's pools bit for bit
    for j, w in enumerate(want[i]["pools"]):
        full = np.concatenate([got[r][i]["pools"][j] for r in (0, 1)],
                              axis=1)
        assert np.array_equal(_np_bits(full)[1:], _np_bits(w)[1:])


@pytest.mark.parametrize("i", range(len(MOUNT_CASES)),
                         ids=[f"{jnp.dtype(d).name}-{s or 'plain'}"
                              for d, s in MOUNT_CASES])
def test_read_mount_matches_reference_tp2(mounts, i):
    want, got = mounts
    tol = F32 if MOUNT_CASES[i][0] == jnp.float32 else BF16
    for rank in (0, 1):
        read = _from_wire(got[rank][i]["read"], want[i]["dtype"])
        np.testing.assert_allclose(read, want[i]["read"], **tol)
        # lengths == 0 gives zeros under the mount too
        assert np.all(read[0] == 0.0)


#: the card test's shapes: (W, pos per row, the body the library must
#: report: 1 tensor-core, 2 split)
CUDA_SHAPES = {"window8": (8, [0, 17, 63, 100], 1),
               "decode": (1, [0, 17, 255, 256, 1000, 1023], 2),
               "extend": (256, [384], 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("store", [None, "int8", "fp8"])
def test_cuda_window_read_matches_plain_version(store):
    """On the card: K5a (K5b with scales) against its plain version at a
    head dim the kernels take, bf16 queries, 6 heads, at each of
    ``CUDA_SHAPES``: a window of 8, the decode tick with rows past 1000
    keys (the split body) and a 256-key extend (the tensor-core body).
    ctx within bf16 rounding (plus 2^-8 * R on the tensor-core body),
    the body the library reports, and every pool bit untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for shape, (Wc, pos_l, body) in CUDA_SHAPES.items():
        _cuda_window_read_case(store, Wc, pos_l, body)


def _cuda_window_read_case(store, Wc, pos_l, body):
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    Bc, Hc, hd, page = len(pos_l), 6, 64, 16
    Pc = -(-(max(pos_l) + Wc) // page)
    act = [torch.from_numpy(rng.normal(0, 1, (Bc, Hc, Wc, hd))).to(
        dev, torch.bfloat16) for _ in range(3)]
    raw = [torch.from_numpy(rng.normal(0, 1, (1 + Bc * Pc, Hc, page, hd))
                            ).to(dev, torch.float32) for _ in range(2)]
    if store is None:
        pools = [r.to(torch.bfloat16) for r in raw]
    else:
        (kp, ks), (vp, vs) = (port_q.quantize_kv(r, port_q.kv_store_dtype(
            store)) for r in raw)
        pools = [kp, vp, ks, vs]
    bt = torch.from_numpy((1 + rng.permutation(Bc * Pc)).reshape(Bc, Pc)
                          ).to(dev, torch.int32)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    before = [p.clone() for p in pools]
    want = port_pa.paged_attention_window_read_plain(
        *act, pools[0], pools[1], bt, pos, 0.125, *pools[2:])
    r = port_pa.paged_rounding_scale(*act, pools[0], pools[1], bt, pos,
                                     0.125, *pools[2:])
    paw = port_pa.paged_attention_window
    sfx = "" if store is None else "_q"
    n0 = [getattr(paw, f"launches_window{sfx}{b}") for b in ("_mma", "_split")]
    got = port_pa._window_read(*act, pools[0], pools[1], bt, pos, 0.125,
                               *pools[2:])
    torch.cuda.synchronize()
    n1 = [getattr(paw, f"launches_window{sfx}{b}") for b in ("_mma", "_split")]
    assert [b - a for a, b in zip(n0, n1)] == [int(body == 1),
                                               int(body == 2)]
    err = (got.float() - want.float()).abs()
    bound = 4e-3 + 1e-2 * want.float().abs() + (
        2.0 ** -8 * r if body == 1 else 0.0)
    assert torch.isfinite(got).all() and bool((err <= bound).all())
    for a, b in zip(pools, before):
        assert torch.equal(port_pa._bits(a), port_pa._bits(b))


def test_mount_rejects_indivisible_axes():
    # the template's case: 3 rows over dp = 4 ...
    with pytest.raises(ValueError, match="divisible"):
        port_pa._check_mount(ranks.StubMesh(dp=4, tp=2), 3, 4, "dp", "tp")
    # ... and 4 heads over tp = 3
    with pytest.raises(ValueError, match="divisible"):
        port_pa._check_mount(ranks.StubMesh(tp=3), 2, 4, None, "tp")
    port_pa._check_mount(ranks.StubMesh(dp=4, tp=2), 8, 4, "dp", "tp")


def test_mount_refuses_slot_sharding_and_unknown_axes():
    """Slot sharding, once refused, now mounts: the read-only op (no
    collective) on dp rank 0's rows of a dp = 2 mesh equals those rows of
    the unmounted read. Unknown axes, and one axis named for both, still
    raise ValueError."""
    act, pools, bt = _case(4, jnp.float32, None)
    q, kp, vp = _to_torch(act[0]), _to_torch(pools[0]), _to_torch(pools[1])
    lens = torch.from_numpy(LENGTHS)
    bt = torch.from_numpy(bt)
    whole = port_pa.paged_attention(q, kp, vp, bt, lens)
    n = B // 2
    mine = port_pa.paged_attention(q[:n].contiguous(), kp, vp, bt[:n],
                                   lens[:n], mesh=ranks.StubMesh(dp=2, tp=1),
                                   slot_axis="dp", head_axis="tp")
    assert torch.equal(mine, whole[:n])
    with pytest.raises(ValueError, match="no axis"):
        port_pa.paged_attention(q, kp, vp, bt, lens,
                                mesh=ranks.StubMesh(tp=1), head_axis="heads")
    with pytest.raises(ValueError, match="both"):
        port_pa.paged_attention(q, kp, vp, bt, lens,
                                mesh=ranks.StubMesh(dp=2), slot_axis="dp",
                                head_axis="dp")


def test_mesh_helpers_without_a_world():
    assert port_mesh.mesh_shape(None) == "single"
    assert port_mesh.mesh_shape(ranks.StubMesh(dp=1, tp=2)) == "dp1xtp2"
    assert port_mesh.axis_size(ranks.StubMesh(dp=1, tp=2), "tp") == 2
    assert port_mesh.axis_size(ranks.StubMesh(tp=2), "dp") == 1
    assert port_mesh.axis_size(None, "tp") == 1
    assert port_dist.choose_backend(2, "cpu") == "gloo"
    assert 0 < port_dist.find_open_port() < 65536
    assert port_dist.world_info()["process_count"] == 1
    with pytest.raises(RuntimeError, match="initialize"):
        port_mesh.make_mesh({"tp": 1}, "cpu")


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="failed on purpose"):
        run_ranks(ranks.fails, 1, device="cpu", threads=1,
                  timeout=120)
