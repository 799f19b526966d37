"""The port's per-level GBDT histogram (``mmlspark_tpu_torch/ops/
histogram.py``) against the JAX package: the plain version bitwise
against ``segment_sum`` (the reference's fallback), and against the
Pallas kernel in interpret mode within its own tests' tolerance (rtol
1e-5, atol 1e-4: the one-hot matmul sums in another order). The CUDA
kernel K6 is checked against the plain version on the card only; its
launch plan (``hist_launch_plan``: which block sums which features,
slots and rows) is checked here, and an emulation of the kernel's
algorithm over that plan (per-block partials, then the flush) is held
against the plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.ops.pallas_kernels import level_histogram_pallas
from mmlspark_tpu_torch.ops import histogram as port

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

SHAPES = [(700, 5, 1, 16),      # root level, ragged row count
          (1024, 3, 4, 32),     # mid level
          (333, 2, 8, 256),     # full default bin budget
          (400, 2, 32, 32)]     # a 32-node level


def _reference_hist(xb, node_rel, g, h, w, n_nodes, n_bins):
    """The reference's segment_sum branch (``trees.py:86-95``)."""
    data = jnp.stack([jnp.asarray(g), jnp.asarray(h), jnp.asarray(w)],
                     axis=-1)

    def per_feature(bins_col):
        seg = jnp.asarray(node_rel) * n_bins + bins_col.astype(jnp.int32)
        return jax.ops.segment_sum(data, seg, num_segments=n_nodes * n_bins)

    hist = jax.vmap(per_feature, in_axes=1)(jnp.asarray(xb))
    return np.transpose(np.asarray(hist).reshape(xb.shape[1], n_nodes,
                                                 n_bins, 3), (1, 0, 2, 3))


def _inputs(seed, n, F, n_nodes, n_bins, bin_dtype=np.uint8):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, n_bins, (n, F)).astype(bin_dtype)
    node = rng.integers(0, n_nodes, n).astype(np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    w = (rng.random(n) > 0.1).astype(np.float32)    # some bagged-out rows
    g, h = g * w, h * w
    return xb, node, g, h, w


def _port_args(xb, node, g, h, w):
    return (port.prepare_bins_columns(xb, "cpu"), torch.from_numpy(node),
            torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w))


@pytest.mark.parametrize("n,F,n_nodes,n_bins", SHAPES)
def test_plain_bitwise_vs_segment_sum(n, F, n_nodes, n_bins):
    xb, node, g, h, w = _inputs(n, n, F, n_nodes, n_bins)
    want = _reference_hist(xb, node, g, h, w, n_nodes, n_bins)
    got = port.level_histogram_plain(*_port_args(xb, node, g, h, w),
                                     n_nodes, n_bins)
    assert got.shape == (n_nodes, F, n_bins, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,F,n_nodes,n_bins", SHAPES)
def test_public_entry_vs_pallas_interpret(n, F, n_nodes, n_bins):
    """``level_histogram`` on CPU tensors runs the plain version (never a
    counted launch) and agrees with the reference's Pallas kernel."""
    xb, node, g, h, w = _inputs(n + 1, n, F, n_nodes, n_bins)
    want = np.asarray(level_histogram_pallas(
        jnp.asarray(xb.astype(np.int32)), jnp.asarray(node), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(w), n_nodes, n_bins, row_block=256,
        interpret=True))
    before = port.level_histogram.launches
    got = port.level_histogram(*_port_args(xb, node, g, h, w), n_nodes,
                               n_bins)
    assert port.level_histogram.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_bf16_stats_match_pallas_interpret():
    """stats_dtype=bfloat16: stats rounded to bf16 before f32 sums, as the
    reference's kernel does. Counts bitwise; g/h differ from the
    reference only in summation order."""
    n, F, n_nodes, n_bins = 900, 4, 4, 32
    xb, node, g, h, w = _inputs(3, n, F, n_nodes, n_bins)
    want = np.asarray(level_histogram_pallas(
        jnp.asarray(xb.astype(np.int32)), jnp.asarray(node), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(w), n_nodes, n_bins, row_block=256,
        interpret=True, stats_dtype="bfloat16"))
    args = _port_args(xb, node, g, h, w)
    got = port.level_histogram(*args, n_nodes, n_bins,
                               stats_dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=1e-5,
                               atol=1e-5)
    exact = port.level_histogram(*args, n_nodes, n_bins).numpy()
    np.testing.assert_array_equal(got[..., 2], exact[..., 2])
    np.testing.assert_allclose(got[..., :2], exact[..., :2], rtol=2e-2,
                               atol=2e-2)                 # bf16 rounding
    assert not np.array_equal(got[..., :2], exact[..., :2])


def test_uint16_bins_bitwise_vs_segment_sum():
    """uint16 bins (n_bins > 256) travel as their raw int16 bits; values
    at and above 2**15 must come back unsigned."""
    n, F, n_nodes, n_bins = 600, 3, 2, 40000
    xb, node, g, h, w = _inputs(4, n, F, n_nodes, n_bins, np.uint16)
    xb[:5, 0] = [0, 32767, 32768, 39999, 65535 % n_bins]
    cols = port.prepare_bins_columns(xb, "cpu")
    assert cols.dtype == torch.int16 and cols.shape == (F, n)
    np.testing.assert_array_equal(port.bins_as_int(cols).numpy(),
                                  xb.T.astype(np.int32))
    want = _reference_hist(xb, node, g, h, w, n_nodes, n_bins)
    got = port.level_histogram(cols, *_port_args(xb, node, g, h, w)[1:],
                               n_nodes, n_bins)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prepare_bins_columns_layout():
    xb = np.arange(24, dtype=np.uint8).reshape(6, 4)
    cols = port.prepare_bins_columns(xb, "cpu")
    assert cols.dtype == torch.uint8 and cols.is_contiguous()
    np.testing.assert_array_equal(cols.numpy(), xb.T)
    again = port.prepare_bins_columns(torch.from_numpy(xb))
    assert torch.equal(again, cols)
    with pytest.raises(TypeError):
        port.prepare_bins_columns(xb.astype(np.int32))


def test_float64_stats_give_float64_plain_histogram():
    """The card's check holds K6 against the plain version in float64."""
    n, F, n_nodes, n_bins = 500, 3, 2, 16
    xb, node, g, h, w = _inputs(5, n, F, n_nodes, n_bins)
    args = _port_args(xb, node, g, h, w)
    got = port.level_histogram_plain(args[0], args[1], args[2].double(),
                                     args[3].double(), args[4].double(),
                                     n_nodes, n_bins)
    assert got.dtype == torch.float64
    f32 = port.level_histogram_plain(*args, n_nodes, n_bins)
    np.testing.assert_array_equal(got[..., 2].numpy(), f32[..., 2].numpy())
    np.testing.assert_allclose(got.numpy(), f32.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bad", ["bins_dtype", "node_dtype", "stat_dtype",
                                 "shape", "noncontig", "n_bins", "stats"])
def test_check_rejects_what_the_kernel_does_not_take(bad):
    n, F, n_nodes, n_bins = 64, 3, 2, 16
    xb, node, g, h, w = _inputs(6, n, F, n_nodes, n_bins)
    cols, nd, gt, ht, wt = _port_args(xb, node, g, h, w)
    kw = {}
    if bad == "bins_dtype":
        cols = cols.to(torch.int32)
    elif bad == "node_dtype":
        nd = nd.long()
    elif bad == "stat_dtype":
        gt = gt.double()
    elif bad == "shape":
        ht = ht[:-1]
    elif bad == "noncontig":
        cols = torch.from_numpy(xb).t()
    elif bad == "n_bins":
        n_bins = 257
    else:
        kw = {"stats_dtype": torch.float16}
    with pytest.raises((TypeError, ValueError)):
        port.level_histogram(cols, nd, gt, ht, wt, n_nodes, n_bins, **kw)


def test_hist_bytes_at_higgs_scale():
    """The bound's byte count at the slice's deepest level: ~485 MB."""
    nbytes = port.hist_bytes(11_000_000, 28, 1, 16, 255)
    assert nbytes == 11_000_000 * 28 + 11_000_000 * 16 + 16 * 28 * 255 * 12
    assert 480e6 < nbytes < 490e6


#: the H100's opt-in shared memory per block and SM count
H100 = (232_448, 132)

#: (n, F, n_nodes, n_bins, bin_bytes) -> the plan's (body, width, blocks,
#: smem, group, groups, chunk_slots, chunks, rows_per_block, row_blocks)
#: on the
#: H100: the HIGGS run's level shapes (11M x 28, 255 bins, 1-16 nodes) and
#: phase 8a's 64-node, 256-node and uint16 cases
PINNED = {
    (11_000_000, 28, 1, 255, 1):
        ("lanes", 32, 264, 97920, 28, 1, 255, 1, 41696, 264),
    (11_000_000, 28, 2, 255, 1):
        ("lanes", 32, 132, 195840, 28, 1, 510, 1, 83360, 132),
    (11_000_000, 28, 4, 255, 1):
        ("lanes", 16, 132, 195840, 14, 2, 1020, 1, 166688, 66),
    (11_000_000, 28, 8, 255, 1):
        ("table", 1, 259, 97920, 4, 7, 2040, 1, 297300, 37),
    (11_000_000, 28, 16, 255, 1):
        ("table", 1, 252, 97920, 2, 14, 4080, 1, 611112, 18),
    (11_000_000, 28, 64, 255, 1):
        ("table", 1, 112, 195840, 1, 28, 16320, 1, 2750000, 4),
    (1_000_003, 28, 256, 255, 1):
        ("direct", 1, 245, 0, 28, 1, 65280, 1, 4096, 245),
    (1_000_003, 28, 4, 1024, 2):
        ("table", 1, 252, 98304, 2, 14, 4096, 1, 55556, 18),
}

PLAN_SHAPES = list(PINNED) + [
    (1, 1, 1, 1, 1), (7, 3, 1, 2, 1), (100, 5, 3, 17, 1),
    (1000, 40, 1, 256, 1), (1000, 40, 1, 256, 2), (50_000, 100, 64, 255, 1),
    (11_000_000, 28, 128, 255, 1), (11_000_000, 28, 4096, 255, 1),
    (600, 3, 2, 40000, 2), (600, 3, 2, 65536, 2),
    (10 ** 9, 28, 16, 255, 1), (1000, 70_000, 1, 16, 1)]


def _block_ranges(plan, n, F, n_slots):
    """Each block's (features, slots, rows) as half-open ranges, decoded
    from its index as the kernel decodes ``blockIdx.x``."""
    for i in range(plan.blocks):
        gi, rest = i % plan.groups, i // plan.groups
        ci, rb = rest % plan.chunks, rest // plan.chunks
        f0, s0, r0 = (gi * plan.group, ci * plan.chunk_slots,
                      rb * plan.rows_per_block)
        yield ((f0, min(F, f0 + plan.group)),
               (s0, min(n_slots, s0 + plan.chunk_slots)),
               (r0, min(n, r0 + plan.rows_per_block)))


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_launch_plan_within_limits(shape):
    """Shared memory per block within the opt-in limit and equal to the
    body's tables, 1024 threads, a 1-D grid within CUDA's 2^31 - 1,
    feature groups balanced (at most W features for the lanes body),
    rows cut into 4-row (32-row for lanes) multiples, every block with
    work, and the tables' row blocks one wave of resident blocks or less:
    two an SM when the tables take at most half its shared memory less
    the 1 KB each block reserves, else one."""
    n, F, n_nodes, n_bins, bin_bytes = shape
    optin, sms = H100
    plan = port.hist_launch_plan(*shape, optin, sms)
    n_slots = n_nodes * n_bins
    assert plan.threads == 1024 and plan.grid == (plan.blocks, 1, 1)
    assert plan.body in port.HIST_BODIES and plan.smem <= optin
    assert plan.smem == {"direct": 0,
                         "table": plan.group * plan.chunk_slots * 12,
                         "lanes": plan.width * n_slots * 12}[plan.body]
    assert 1 <= plan.blocks <= 2 ** 31 - 1 and plan.groups <= 65535
    assert plan.blocks == plan.groups * plan.chunks * plan.row_blocks
    assert plan.group * (plan.groups - 1) < F <= plan.group * plan.groups
    assert (plan.chunk_slots * (plan.chunks - 1) < n_slots
            <= plan.chunk_slots * plan.chunks)
    assert (plan.rows_per_block * (plan.row_blocks - 1) < n
            <= plan.rows_per_block * plan.row_blocks)
    assert plan.rows_per_block % (32 if plan.body == "lanes" else 4) == 0
    if plan.body == "lanes":
        assert bin_bytes == 1 and plan.width in (32, 16)
        assert plan.group <= plan.width and plan.chunks == 1
    else:
        assert plan.width == 1
    if plan.body == "direct":
        assert plan.chunks == 1 and plan.groups == 1
    else:
        per_wave = (2 if plan.smem <= (optin - 1024) // 2 else 1) * sms
        if plan.groups * plan.chunks <= per_wave:
            assert plan.blocks <= per_wave


@pytest.mark.parametrize("shape", [
    (1, 1, 1, 1, 1), (7, 3, 1, 2, 1), (100, 5, 3, 17, 1),
    (300, 40, 2, 256, 1), (600, 3, 2, 40000, 2), (97, 4, 300, 255, 1)],
    ids=str)
def test_launch_plan_covers_each_feature_slot_row_once(shape):
    """Every (feature, slot, row) is summed by exactly one block: counted
    over the whole triple space at small shapes."""
    n, F, n_nodes, n_bins, _ = shape
    plan = port.hist_launch_plan(*shape, *H100)
    n_slots = n_nodes * n_bins
    seen = np.zeros((F, n_slots, n), dtype=np.int32)
    for (f0, f1), (s0, s1), (r0, r1) in _block_ranges(plan, n, F, n_slots):
        assert f0 < f1 and s0 < s1 and r0 < r1, "a block without work"
        seen[f0:f1, s0:s1, r0:r1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", list(PINNED), ids=str)
def test_launch_plan_pinned_at_higgs_shapes(shape):
    plan = port.hist_launch_plan(*shape, *H100)
    n, F, n_nodes, n_bins, _ = shape
    assert (plan.body, plan.width, plan.blocks, plan.smem, plan.group,
            plan.groups, plan.chunk_slots, plan.chunks, plan.rows_per_block,
            plan.row_blocks) == PINNED[shape]
    # each axis cut into disjoint ranges that cover it (the triple check
    # above, by axis, at sizes too large to enumerate)
    ranges = list(_block_ranges(plan, n, F, n_nodes * n_bins))
    for axis, size in enumerate((F, n_nodes * n_bins, n)):
        cuts = sorted({r[axis] for r in ranges})
        assert cuts[0][0] == 0 and cuts[-1][1] == size
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))


@pytest.mark.parametrize("bad", [(0, 3, 1, 16, 1), (10, 3, 1, 300, 1),
                                 (10, 3, 1, 16, 3), (10, 3, 2 ** 16, 2 ** 15,
                                                     2)])
def test_launch_plan_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        port.hist_launch_plan(*bad, *H100)


def _plan_emulation(bins_cols, node, g, h, w, n_nodes, n_bins, plan,
                    stats_dtype=None):
    """K6's algorithm over ``plan`` in plain PyTorch: every block sums its
    features' rows of its row block into its chunk's slots (the rows of
    weight 1 counted as integers, other weights and g and h in f32; rows
    whose node id or bin is out of range, or whose g, h and w are all 0,
    add nothing), then adds its non-zero partials into the zeroed output
    in f32, block by block."""
    F, n = bins_cols.shape
    if stats_dtype is not None:
        g, h, w = (t.to(stats_dtype).float() for t in (g, h, w))
    n_slots = n_nodes * n_bins
    out = torch.zeros(n_nodes, F, n_bins, 3)
    for (f0, f1), (s0, s1), (r0, r1) in _block_ranges(plan, n, F, n_slots):
        nd = node[r0:r1].long()
        live = ((nd >= 0) & (nd < n_nodes)
                & ((g[r0:r1] != 0) | (h[r0:r1] != 0) | (w[r0:r1] != 0)))
        for f in range(f0, f1):
            b = port.bins_as_int(bins_cols[f, r0:r1]).long()
            slot = nd * n_bins + b
            ok = live & (b < n_bins) & (slot >= s0) & (slot < s1)
            idx = slot[ok] - s0
            gh = torch.zeros(s1 - s0, 2).index_add_(
                0, idx, torch.stack([g[r0:r1][ok], h[r0:r1][ok]], -1))
            wk = w[r0:r1][ok]
            cnt = torch.zeros(s1 - s0, dtype=torch.int64).index_add_(
                0, idx, (wk == 1).long())
            other = torch.zeros(s1 - s0).index_add_(
                0, idx, torch.where((wk == 1) | (wk == 0), 0.0, wk))
            part = torch.cat([gh, (cnt.float() + other)[:, None]], -1)
            s = torch.arange(s0, s1)
            out[s // n_bins, f, s % n_bins] += part
    return out


def _within_bound(got, bins_cols, node, g, h, w, n_nodes, n_bins):
    ref = port.level_histogram_plain(bins_cols, node, g.double(), h.double(),
                                     w.double(), n_nodes, n_bins)
    mag = port.level_histogram_plain(bins_cols, node, g.abs().double(),
                                     h.abs().double(), w.double(), n_nodes,
                                     n_bins)
    err = (got[..., :2].double() - ref[..., :2]).abs()
    return bool((err <= 2e-6 * mag[..., :2] + 1e-7).all())


@pytest.mark.parametrize("n,F,n_nodes,n_bins,limits,stats,body", [
    (5000, 6, 1, 255, H100, None, "lanes"),       # W = 32, 32-row blocks
    (3000, 40, 1, 16, H100, "bf16", "lanes"),     # two groups of 20
    (4000, 20, 2, 32, (24_000, 4), None, "lanes"),    # W = 16
    (4000, 7, 8, 32, (24_000, 8), "bf16", "table"),   # groups of 3
    (3001, 5, 40, 63, (24_000, 4), None, "table"),    # 3 chunks of nodes
    (2000, 3, 2, 1500, (24_000, 4), None, "table"),   # chunks of bins
    (9000, 5, 64, 63, (24_000, 4), None, "direct"),   # 5 chunks: direct
])
def test_plan_emulation_matches_plain(n, F, n_nodes, n_bins, limits, stats,
                                      body):
    """The kernel's per-block partials and flush over its launch plan give
    the plain version's counts bitwise and g/h within the card's bound
    (2e-6 * sum|stat| + 1e-7 of a float64 sum), with a 2-valued column
    and bagged-out rows in the data, for each body. Small shared-memory
    limits force feature groups, slot chunks and row blocks at test
    sizes."""
    bin_dtype = np.uint16 if n_bins > 256 else np.uint8
    xb, node, g, h, w = _inputs(n + n_bins, n, F, n_nodes, n_bins,
                                bin_dtype)
    xb[:, 0] = xb[:, 0] % 2                      # a 2-valued feature
    cols, nd, gt, ht, wt = _port_args(xb, node, g, h, w)
    plan = port.hist_launch_plan(n, F, n_nodes, n_bins, xb.itemsize,
                                 *limits)
    assert plan.body == body and plan.blocks > 1
    sd = torch.bfloat16 if stats else None
    got = _plan_emulation(cols, nd, gt, ht, wt, n_nodes, n_bins, plan, sd)
    plain = port.level_histogram_plain(cols, nd, gt, ht, wt, n_nodes,
                                       n_bins, stats_dtype=sd)
    assert torch.equal(got[..., 2], plain[..., 2])
    if sd is not None:
        gt, ht, wt = (t.to(sd).float() for t in (gt, ht, wt))
    assert _within_bound(got, cols, nd, gt, ht, wt, n_nodes, n_bins)


def test_plan_emulation_drops_out_of_range_rows():
    """Node ids outside [0, n_nodes) and bins outside [0, n_bins) add
    nothing, and a count weight of 0.5 is added as itself: the emulation
    equals the plain version over the other rows (counts bitwise: halves
    sum exactly in any order)."""
    n, F, n_nodes, n_bins = 3000, 4, 8, 200
    xb, node, g, h, w = _inputs(9, n, F, n_nodes, n_bins)
    node[::7] = -1
    node[3::11] = n_nodes
    xb[5::13, 2] = 250                            # bins past n_bins
    w[1::17] = 0.5
    cols, nd, gt, ht, wt = _port_args(xb, node, g, h, w)
    plan = port.hist_launch_plan(n, F, n_nodes, n_bins, 1, 12_000, 4)
    assert plan.body == "table" and plan.chunks == 4
    got = _plan_emulation(cols, nd, gt, ht, wt, n_nodes, n_bins, plan)
    keep = (node >= 0) & (node < n_nodes)
    xk, nk, gk, hk, wk = (a[keep] for a in (xb, node, g, h, w))
    bad = xk[:, 2] >= n_bins                     # feature 2 drops these
    xk[bad, 2] = 0
    want = port.level_histogram_plain(*_port_args(xk, nk, gk, hk, wk),
                                      n_nodes, n_bins)
    want[:, 2] = port.level_histogram_plain(*_port_args(
        xk[~bad], nk[~bad], gk[~bad], hk[~bad], wk[~bad]), n_nodes,
        n_bins)[:, 2]
    assert torch.equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: K6 against its plain version at a few level shapes
    that take each body (lanes at W = 32 and 16, the table one chunk and
    chunked, direct), uint8 and uint16 bins, bf16-rounded stats, and
    rows the kernel must drop or whose count weight is not 0 or 1.
    Counts bitwise (within the bound where a weight is fractional); g/h
    within the f32 atomic-order bound of a float64 sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    cases = [(100_003, 6, 1, 255, np.uint8, None, "lanes"),
             (100_003, 40, 4, 255, np.uint8, torch.bfloat16, "lanes"),
             (100_003, 6, 16, 255, np.uint8, None, "table"),
             (100_001, 3, 80, 255, np.uint8, None, "table"),
             (50_001, 3, 256, 255, np.uint8, None, "direct"),
             (50_001, 3, 4, 1024, np.uint16, torch.bfloat16, "table"),
             (30_001, 5, 8, 200, np.uint8, "odd rows", "table")]
    for seed, (n, F, n_nodes, n_bins, dt, kind, body) in enumerate(cases):
        xb, node, g, h, w = _inputs(seed, n, F, n_nodes, n_bins, dt)
        sd = kind if isinstance(kind, torch.dtype) else None
        if kind == "odd rows":
            node[::97] = n_nodes                  # dropped by the kernel
            w[::89] = 0.5                         # a fractional count
        cols = port.prepare_bins_columns(xb, dev)
        nd, gt, ht, wt = (torch.from_numpy(a).to(dev)
                          for a in (node, g, h, w))
        plan = port.hist_launch_plan(n, F, n_nodes, n_bins, xb.itemsize,
                                     *port._device_limits(dev))
        assert plan.body == body
        before = port.level_histogram.launches
        got = port.level_histogram(cols, nd, gt, ht, wt, n_nodes, n_bins,
                                   stats_dtype=sd)
        torch.cuda.synchronize()
        assert port.level_histogram.launches == before + 1
        if kind == "odd rows":                    # the plain version's rows
            keep = torch.from_numpy(node < n_nodes).to(dev)
            cols, nd, gt, ht, wt = (cols[:, keep].contiguous(), nd[keep],
                                    gt[keep], ht[keep], wt[keep])
        if sd is not None:
            gt, ht, wt = (t.to(sd).float() for t in (gt, ht, wt))
        plain = port.level_histogram_plain(cols, nd, gt, ht, wt, n_nodes,
                                           n_bins)
        ref = port.level_histogram_plain(cols, nd, gt.double(), ht.double(),
                                         wt.double(), n_nodes, n_bins)
        mag = port.level_histogram_plain(cols, nd, gt.abs().double(),
                                         ht.abs().double(), wt.double(),
                                         n_nodes, n_bins)
        if kind == "odd rows":
            err = (got[..., 2].double() - ref[..., 2]).abs()
            assert bool((err <= 2e-6 * mag[..., 2] + 1e-7).all())
        else:
            assert torch.equal(got[..., 2], plain[..., 2])
        err = (got[..., :2].double() - ref[..., :2]).abs()
        assert bool((err <= 2e-6 * mag[..., :2] + 1e-7).all())


# -- the class axis (multiclass: one launch a level for all K classes) -------

def _class_inputs(seed, n, F, n_nodes, n_bins, K, bin_dtype=np.uint8):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, n_bins, (n, F)).astype(bin_dtype)
    node = rng.integers(0, n_nodes, (K, n)).astype(np.int32)
    g = rng.normal(size=(K, n)).astype(np.float32)
    h = rng.random((K, n)).astype(np.float32)
    w = (rng.random(n) > 0.1).astype(np.float32)
    return xb, node, g * w, h * w, w


@pytest.mark.parametrize("n,F,n_nodes,n_bins", SHAPES)
@pytest.mark.parametrize("K", [1, 3])
def test_class_batched_plain_equals_single_class_calls(n, F, n_nodes,
                                                       n_bins, K):
    """(K, n) node ids, g and h give (K, n_nodes, F, n_bins, 3), class k
    bitwise the single-class call on row k; the public entry on CPU
    tensors is the plain version, and either counts one call."""
    xb, node, g, h, w = _class_inputs(n + K, n, F, n_nodes, n_bins, K)
    cols = port.prepare_bins_columns(xb, "cpu")
    args = (cols, torch.from_numpy(node), torch.from_numpy(g),
            torch.from_numpy(h), torch.from_numpy(w))
    before = port.level_histogram_plain.calls
    got = port.level_histogram_plain(*args, n_nodes, n_bins)
    assert port.level_histogram_plain.calls == before + 1
    assert got.shape == (K, n_nodes, F, n_bins, 3)
    for k in range(K):
        one = port.level_histogram_plain(cols, args[1][k], args[2][k],
                                         args[3][k], args[4], n_nodes,
                                         n_bins)
        assert torch.equal(got[k], one)
        np.testing.assert_array_equal(
            one.numpy(), _reference_hist(xb, node[k], g[k], h[k], w,
                                         n_nodes, n_bins))
    assert torch.equal(port.level_histogram(*args, n_nodes, n_bins), got)
    sd = port.level_histogram(*args, n_nodes, n_bins,
                              stats_dtype=torch.bfloat16)
    assert torch.equal(sd[K - 1], port.level_histogram_plain(
        cols, args[1][K - 1], args[2][K - 1], args[3][K - 1], args[4],
        n_nodes, n_bins, stats_dtype=torch.bfloat16))


@pytest.mark.parametrize("bad", ["w_classes", "node_flat", "g_rows",
                                 "h_dtype", "too_many_classes"])
def test_check_rejects_mismatched_class_axes(bad):
    n, F, K = 64, 3, 3
    xb, node, g, h, w = _class_inputs(0, n, F, 2, 16, K)
    args = [port.prepare_bins_columns(xb, "cpu"), torch.from_numpy(node),
            torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w)]
    if bad == "w_classes":
        args[4] = args[4].expand(K, n).contiguous()
    elif bad == "node_flat":
        args[1] = args[1][0]
    elif bad == "g_rows":
        args[2] = args[2][:2]
    elif bad == "h_dtype":
        args[3] = args[3].double()
    else:
        args[1] = torch.zeros(70_000, n, dtype=torch.int32)
        args[2] = args[3] = torch.zeros(70_000, n)
    with pytest.raises((TypeError, ValueError)):
        port.level_histogram(*args, 2, 16)


def test_hist_bytes_counts_each_class_once_and_the_bins_once():
    assert port.hist_bytes(581_012, 54, 1, 4, 255, 7) == (
        581_012 * 54 + 581_012 * (4 + 12 * 7) + 7 * 4 * 54 * 255 * 12)
    assert port.hist_bytes(100, 2, 2, 3, 16) == \
        port.hist_bytes(100, 2, 2, 3, 16, classes=1)


#: (n, F, n_nodes, n_bins, bin_bytes, classes) -> the plan's (body, width,
#: blocks a class, group, groups, chunks, rows_per_block) on the H100:
#: phase 8a's class-batched cases (Covertype's 581,012 x 54)
PINNED_CLASSES = {
    (581_012, 54, 1, 255, 1, 7): ("lanes", 32, 36, 27, 2, 1, 32288),
    (581_012, 54, 4, 255, 1, 7): ("lanes", 16, 16, 14, 4, 1, 145280),
    (581_012, 54, 16, 255, 1, 7): ("table", 1, 27, 2, 27, 1, 581012),
    (581_012, 54, 4, 1024, 2, 3): ("table", 1, 81, 2, 27, 1, 193672),
}


@pytest.mark.parametrize("shape", list(PINNED_CLASSES) + [
    (1000, 40, 1, 256, 1, 2), (7, 3, 1, 2, 1, 5), (9000, 5, 64, 63, 1, 3),
    (11_000_000, 28, 16, 255, 1, 7), (600, 3, 2, 40000, 2, 4)], ids=str)
def test_launch_plan_with_classes(shape):
    """Every class runs the single-class plan's body and cuts on its own
    plane of the grid, (blocks, classes, 1); the planes share one wave
    of resident blocks (at least one row block a class)."""
    *one, K = shape
    optin, sms = H100
    plan = port.hist_launch_plan(*one, optin, sms, K)
    single = port.hist_launch_plan(*one, optin, sms)
    assert plan.classes == K and plan.grid == (plan.blocks, K, 1)
    assert (plan.body, plan.width, plan.smem, plan.group, plan.groups,
            plan.chunk_slots, plan.chunks) == (
        single.body, single.width, single.smem, single.group, single.groups,
        single.chunk_slots, single.chunks)
    assert plan.blocks == plan.groups * plan.chunks * plan.row_blocks
    assert plan.row_blocks <= single.row_blocks
    if plan.body != "direct":
        per_wave = (2 if plan.smem <= (optin - 1024) // 2 else 1) * sms
        if plan.groups * plan.chunks * K <= per_wave:
            assert plan.blocks * K <= per_wave
    if shape in PINNED_CLASSES:
        assert (plan.body, plan.width, plan.blocks, plan.group, plan.groups,
                plan.chunks, plan.rows_per_block) == PINNED_CLASSES[shape]
    with pytest.raises(ValueError):
        port.hist_launch_plan(*one, optin, sms, 0)
    with pytest.raises(ValueError):
        port.hist_launch_plan(*one, optin, sms, 65536)


def test_class_plan_emulation_matches_plain():
    """K6's algorithm over a class-batched plan, one plane a class, gives
    each class the plain version's counts bitwise and g/h within the
    card's bound."""
    n, F, n_nodes, n_bins, K = 4000, 7, 8, 32, 3
    xb, node, g, h, w = _class_inputs(5, n, F, n_nodes, n_bins, K)
    cols = port.prepare_bins_columns(xb, "cpu")
    plan = port.hist_launch_plan(n, F, n_nodes, n_bins, 1, 24_000, 8, K)
    assert plan.body == "table" and plan.classes == K and plan.blocks > 1
    nd, gt, ht, wt = (torch.from_numpy(a) for a in (node, g, h, w))
    plain = port.level_histogram_plain(cols, nd, gt, ht, wt, n_nodes, n_bins)
    for k in range(K):
        got = _plan_emulation(cols, nd[k], gt[k], ht[k], wt, n_nodes, n_bins,
                              plan)
        assert torch.equal(got[..., 2], plain[k][..., 2])
        assert _within_bound(got, cols, nd[k], gt[k], ht[k], wt, n_nodes,
                             n_bins)


@pytest.mark.cuda
def test_cuda_class_batched_kernel_matches_plain_version():
    """On the card: one K6 launch for K classes against the plain
    version, on each body, with n % 4 != 0 (class rows not 16-byte
    aligned: the kernel's scalar loads). Counts bitwise, g/h within the
    f32 atomic-order bound of a float64 sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for seed, (n, F, n_nodes, n_bins, K, dt) in enumerate([
            (100_003, 6, 1, 255, 7, np.uint8),
            (100_000, 40, 4, 255, 3, np.uint8),
            (100_001, 6, 16, 255, 7, np.uint8),
            (50_001, 3, 256, 255, 2, np.uint8),
            (50_002, 3, 4, 1024, 3, np.uint16)]):
        xb, node, g, h, w = _class_inputs(seed, n, F, n_nodes, n_bins, K, dt)
        cols = port.prepare_bins_columns(xb, dev)
        nd, gt, ht, wt = (torch.from_numpy(a).to(dev)
                          for a in (node, g, h, w))
        before = port.level_histogram.launches
        got = port.level_histogram(cols, nd, gt, ht, wt, n_nodes, n_bins)
        torch.cuda.synchronize()
        assert port.level_histogram.launches == before + 1
        plain = port.level_histogram_plain(cols, nd, gt, ht, wt, n_nodes,
                                           n_bins)
        assert torch.equal(got[..., 2], plain[..., 2])
        for k in range(K):
            ok = _within_bound(got[k].cpu(), cols.cpu(), nd[k].cpu(),
                               gt[k].cpu(), ht[k].cpu(), wt.cpu(), n_nodes,
                               n_bins)
            assert ok
