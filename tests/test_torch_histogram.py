"""The port's per-level GBDT histogram (``mmlspark_tpu_torch/ops/
histogram.py``) against the JAX package: the plain version bitwise
against ``segment_sum`` (the reference's fallback), and against the
Pallas kernel in interpret mode within its own tests' tolerance (rtol
1e-5, atol 1e-4: the one-hot matmul sums in another order). The CUDA
kernel K6 is checked against the plain version on the card only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.ops.pallas_kernels import level_histogram_pallas
from mmlspark_tpu_torch.ops import histogram as port

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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: K6 against its plain version at a few level shapes,
    uint8 and uint16 bins. Counts bitwise; g/h within the f32 atomic-order
    bound of a float64 sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for seed, (n, F, n_nodes, n_bins, dt) in enumerate(
            [(100_003, 6, 1, 255, np.uint8), (100_003, 6, 16, 255, np.uint8),
             (50_001, 3, 256, 255, np.uint8),
             (50_001, 3, 4, 1024, np.uint16)]):
        xb, node, g, h, w = _inputs(seed, n, F, n_nodes, n_bins, dt)
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
        ref = port.level_histogram_plain(cols, nd, gt.double(), ht.double(),
                                         wt.double(), n_nodes, n_bins)
        mag = port.level_histogram_plain(cols, nd, gt.abs().double(),
                                         ht.abs().double(), wt.double(),
                                         n_nodes, n_bins)
        err = (got[..., :2].double() - ref[..., :2]).abs()
        assert bool((err <= 2e-6 * mag[..., :2] + 1e-7).all())
