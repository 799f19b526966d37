"""Per-level GBDT histograms (counterpart of ``ops/pallas_kernels.py``).

One tree level of histogram GBDT needs, for every (node, feature, bin),
the sums of the rows' gradient, hessian and count:

    hist[node, f, bin, s] = sum of stat_s(row) over the rows whose node is
                            ``node`` and whose bin for feature f is ``bin``

with s in (g, h, count). The JAX package builds it with a Pallas kernel
that turns the scatter into a one-hot matmul on the TPU's matrix unit
(``_hist_kernel``); its fallback is ``segment_sum``. The port writes the
scatter as the scatter it is:

=========================  ===========================================
:func:`level_histogram`     K6 on CUDA tensors (hand-written CUDA C++,
                            ``csrc/histogram.cu``; launches counted in
                            ``level_histogram.launches``), the plain
                            version on CPU tensors
:func:`level_histogram_plain`  ``index_add_`` over the flattened
                            ``node * n_bins + bin`` ids, one feature at
                            a time: the port of the ``segment_sum``
                            branch (``models/gbdt/trees.py:86-95``)
:func:`prepare_bins_columns`  the (F, n) feature-major bin layout the
                            kernel reads, made once per run
=========================  ===========================================

Bins are uint8, or uint16 carried as its raw 2-byte ``int16`` view
(``torch.uint16`` has no CPU gather or comparison ops). The TPU's
``pallas_preferred`` crossovers and ``MMLSPARK_TPU_PALLAS`` switch have no
counterpart: on CUDA, K6 runs on every level.

K6 adds g and h with atomics, in an order that changes from run to run,
so its g/h sums are not bitwise reproducible (counts are: they are
integers below 2**24). The plain version sums in row order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["level_histogram", "level_histogram_plain",
           "prepare_bins_columns", "bins_as_int", "hist_bytes"]

#: bin dtypes the kernel takes -> bytes per bin (uint16 travels as int16)
_BIN_DTYPES = {torch.uint8: 1, torch.int16: 2}


def prepare_bins_columns(xb, device=None) -> torch.Tensor:
    """(n, F) uint8 / uint16 bins (numpy or torch) -> the (F, n)
    feature-major layout on ``device``: uint8, or the raw bits of uint16
    as int16. Made once per run (the counterpart of
    ``prepare_bins_lanes``, without its row-block padding and at 1 or 2
    bytes per bin instead of int32). The transpose runs on the device.
    ``device=None`` keeps a tensor where it is and puts a numpy array on
    the CUDA card (raising without one)."""
    if isinstance(xb, np.ndarray):
        if xb.dtype == np.uint16:
            xb = xb.view(np.int16)
        elif xb.dtype != np.uint8:
            raise TypeError(f"bins must be uint8 or uint16, got {xb.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(xb))
        dev = resolve_device(device)
    else:
        t = xb
        if t.dtype == torch.uint16:
            t = t.view(torch.int16)
        if t.dtype not in _BIN_DTYPES:
            raise TypeError(f"bins must be uint8 or uint16, got {t.dtype}")
        dev = t.device if device is None else resolve_device(device)
    if t.dim() != 2:
        raise ValueError(f"bins {tuple(t.shape)} must be (n, F)")
    return t.to(dev).t().contiguous()


def bins_as_int(col: torch.Tensor) -> torch.Tensor:
    """Bins of one layout as int32 values (int16 holds uint16 bits)."""
    v = col.to(torch.int32)
    return v & 0xFFFF if col.dtype == torch.int16 else v


def _stats(g, h, w_count, stats_dtype):
    """(n, 3) stats; with ``stats_dtype`` bfloat16 each value is rounded
    to bf16 first and carried in f32, as ``pallas_kernels.py:219-226``
    rounds them before its kernel (f32 accumulation either way)."""
    data = torch.stack([g, h, w_count], dim=-1)
    if stats_dtype is not None:
        if stats_dtype != torch.bfloat16:
            raise ValueError(f"stats_dtype must be None or torch.bfloat16, "
                             f"got {stats_dtype}")
        data = data.to(torch.bfloat16).to(torch.float32)
    return data


def level_histogram_plain(bins_cols, node_rel, g, h, w_count, n_nodes: int,
                          n_bins: int, *, stats_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of K6: one ``index_add_`` per feature over
    the ``node * n_bins + bin`` ids, rows in order. Returns
    (n_nodes, F, n_bins, 3) in the stats' dtype (float64 stats give a
    float64 histogram, the reference the card's check uses). Never
    counted as a launch; ``level_histogram_plain.calls`` counts calls."""
    level_histogram_plain.calls += 1
    F = bins_cols.shape[0]
    data = _stats(g, h, w_count, stats_dtype)
    out = torch.zeros((F, n_nodes * n_bins, 3), dtype=data.dtype,
                      device=data.device)
    node_off = node_rel.to(torch.int64) * n_bins
    for f in range(F):
        out[f].index_add_(0, node_off + bins_as_int(bins_cols[f]), data)
    return out.view(F, n_nodes, n_bins, 3).permute(1, 0, 2, 3).contiguous()


#: calls of the plain version since the last reset (not kernel launches)
level_histogram_plain.calls = 0


def hist_bytes(n: int, F: int, bin_bytes: int, n_nodes: int,
               n_bins: int) -> int:
    """Bytes K6 must move: each input read once (bins, node ids, g, h, w)
    and the histogram written once."""
    return n * F * bin_bytes + n * (4 + 12) + n_nodes * F * n_bins * 12


def _check(bins_cols, node_rel, g, h, w_count, n_nodes, n_bins):
    """Device, dtype, shape and contiguity; raises on anything K6 does
    not take. Values are not read (that would stall the card): node ids
    outside [0, n_nodes) and bins outside [0, n_bins) are dropped by the
    kernel and rejected by ``index_add_``."""
    if bins_cols.dim() != 2:
        raise ValueError(f"bins_cols {tuple(bins_cols.shape)} must be (F, n)")
    if bins_cols.dtype not in _BIN_DTYPES:
        raise TypeError(f"bins_cols must be uint8 or int16 (uint16 bits), "
                        f"got {bins_cols.dtype}")
    F, n = bins_cols.shape
    if node_rel.shape != (n,) or node_rel.dtype != torch.int32:
        raise TypeError(f"node_rel must be int32 ({n},); got "
                        f"{node_rel.dtype} {tuple(node_rel.shape)}")
    for name, t in (("g", g), ("h", h), ("w_count", w_count)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 ({n},); got {t.dtype} "
                            f"{tuple(t.shape)}")
    devs = {t.device for t in (bins_cols, node_rel, g, h, w_count)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must lie on one device; got {devs}")
    for name, t in (("bins_cols", bins_cols), ("node_rel", node_rel),
                    ("g", g), ("h", h), ("w_count", w_count)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    max_bins = 256 if bins_cols.dtype == torch.uint8 else 65536
    if not 1 <= n_bins <= max_bins:
        raise ValueError(f"n_bins {n_bins} outside [1, {max_bins}] for "
                         f"{bins_cols.dtype} bins")
    if n_nodes < 1 or n_nodes * n_bins >= 2 ** 31:
        raise ValueError(f"n_nodes {n_nodes} x n_bins {n_bins} out of range")


def _library():
    from ..utils.cuda_build import load_library
    lib = load_library("histogram")
    if lib.mmlspark_level_histogram.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mmlspark_level_histogram.argtypes = (
            [ci] + [vp] * 6 + [ctypes.c_longlong, ci, ci, ci, vp])
        lib.mmlspark_level_histogram.restype = ci
        lib.mmlspark_hist_error_string.argtypes = [ci]
        lib.mmlspark_hist_error_string.restype = ctypes.c_char_p
    return lib


def level_histogram(bins_cols, node_rel, g, h, w_count, n_nodes: int,
                    n_bins: int, *, stats_dtype=None) -> torch.Tensor:
    """(F, n) bins x per-row (g, h, count) -> (n_nodes, F, n_bins, 3) f32,
    the reference's layout (``pallas_kernels.py:246-248``).

    ``bins_cols`` comes from :func:`prepare_bins_columns`; ``node_rel``
    (n,) int32 in [0, n_nodes); g, h, w_count (n,) float32.
    ``stats_dtype=torch.bfloat16`` rounds g/h/w to bf16 before the sums
    (LightGBM's quantized-gradient analog); sums stay f32.

    CPU tensors run :func:`level_histogram_plain`. CUDA tensors launch
    K6 on the current stream and count it in ``level_histogram.launches``;
    anything the kernel does not take raises."""
    _check(bins_cols, node_rel, g, h, w_count, n_nodes, n_bins)
    if bins_cols.device.type == "cpu":
        return level_histogram_plain(bins_cols, node_rel, g, h, w_count,
                                     n_nodes, n_bins, stats_dtype=stats_dtype)
    if bins_cols.device.type != "cuda":
        raise ValueError(f"unsupported device {bins_cols.device}")
    if stats_dtype is not None:
        g, h, w_count = _stats(g, h, w_count, stats_dtype).unbind(-1)
        g, h, w_count = g.contiguous(), h.contiguous(), w_count.contiguous()
    F, n = bins_cols.shape
    out = torch.zeros((n_nodes, F, n_bins, 3), dtype=torch.float32,
                      device=bins_cols.device)
    if n == 0 or F == 0:
        return out
    lib = _library()
    with torch.cuda.device(bins_cols.device):
        stream = torch.cuda.current_stream(bins_cols.device).cuda_stream
        err = lib.mmlspark_level_histogram(
            _BIN_DTYPES[bins_cols.dtype], bins_cols.data_ptr(),
            node_rel.data_ptr(), g.data_ptr(), h.data_ptr(),
            w_count.data_ptr(), out.data_ptr(), n, F, n_nodes, n_bins,
            stream)
    if err != 0:
        msg = lib.mmlspark_hist_error_string(err).decode()
        raise RuntimeError(f"level histogram kernel launch failed: {msg}")
    level_histogram.launches += 1
    return out


#: K6 launches since the last reset; the plain CPU path never counts
level_histogram.launches = 0
