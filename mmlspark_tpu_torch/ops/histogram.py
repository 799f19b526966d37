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
:func:`hist_launch_plan`    K6's launch plan: which block sums which
                            features, slots and rows (pure Python, so
                            the CPU tests check it)
=========================  ===========================================

A multiclass level has K such histograms, one a class: each class has
its own node ids, g and h over the same bins and count weights. The JAX
package ``vmap``s its tree build over the classes, which puts a class
axis on the kernel's grid; here one call takes node ids, g and h of
shape (K, n) and returns (K, n_nodes, F, n_bins, 3), one launch for all
K classes on CUDA.

Bins are uint8, or uint16 carried as its raw 2-byte ``int16`` view
(``torch.uint16`` has no CPU gather or comparison ops). The TPU's
``pallas_preferred`` crossovers and ``MMLSPARK_TPU_PALLAS`` switch have no
counterpart: on CUDA, K6 runs on every level.

K6 adds g and h with atomics, in an order that changes from run to run,
so its g/h sums are not bitwise reproducible. Counts are: a row of
count weight 1 is counted as an integer (other weights, not used by the
trainer, are added in f32). The plain version sums in row order.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["level_histogram", "level_histogram_plain",
           "prepare_bins_columns", "bins_as_int", "hist_bytes",
           "HistPlan", "HIST_BODIES", "hist_launch_plan"]

#: bin dtypes the kernel takes -> bytes per bin (uint16 travels as int16)
_BIN_DTYPES = {torch.uint8: 1, torch.int16: 2}
#: the counters' read-modify-write under threads that fit at once (the
#: tuner's trials)
_COUNT_LOCK = threading.Lock()


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
    float64 histogram, the reference the card's check uses); with
    node_rel, g and h of shape (K, n), (K, n_nodes, F, n_bins, 3), each
    class's histogram computed as one single-class call computes it.
    Never counted as a launch; ``level_histogram_plain.calls`` counts
    calls."""
    with _COUNT_LOCK:
        level_histogram_plain.calls += 1
    if g.dim() == 1:
        return _plain_one(bins_cols, node_rel, g, h, w_count, n_nodes,
                          n_bins, stats_dtype)
    return torch.stack([_plain_one(bins_cols, node_rel[k], g[k], h[k],
                                   w_count, n_nodes, n_bins, stats_dtype)
                        for k in range(g.shape[0])])


def _plain_one(bins_cols, node_rel, g, h, w_count, n_nodes, n_bins,
               stats_dtype):
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
               n_bins: int, classes: int = 1) -> int:
    """Bytes K6 must move: each input read once (bins and w once, each
    class's node ids, g and h) and each class's histogram written once."""
    return (n * F * bin_bytes + n * (4 + 12 * classes)
            + classes * n_nodes * F * n_bins * 12)


#: K6's block size (``kThreads`` in ``csrc/histogram.cu``)
HIST_THREADS = 1024
#: shared-memory bytes of one slot: (g, h) as two f32, the count as int32
HIST_SLOT_BYTES = 12
#: the lanes body's widths W, widest first (narrower ones lost to the
#: table body on the card: PERF.md §6, K6)
_LANE_WIDTHS = (32, 16)
#: the most slot chunks the table body takes: each chunk re-reads every
#: row, and past about four chunks adding every row into the output
#: directly costs less (PERF.md §6, K6)
_MAX_TABLE_CHUNKS = 4
#: shared memory the card reserves per block beside its dynamic share
#: (Hopper: an SM holds the opt-in limit plus 1 KB)
_RESERVED_SMEM = 1024


#: K6's bodies, as the C entry numbers them
HIST_BODIES = {"direct": 0, "table": 1, "lanes": 2}


class HistPlan(NamedTuple):
    """K6's launch plan. A slot is one (node, bin) pair of one feature,
    ``slot = node * n_bins + bin``. Block ``i`` of the 1-D grid sums
    feature group ``i % groups`` (features ``[g * group, g * group +
    group)``, the last group shorter), slot chunk ``(i // groups) %
    chunks`` (slots ``[c * chunk_slots, (c + 1) * chunk_slots)``) over
    row block ``i // (groups * chunks)`` (rows ``[r * rows_per_block,
    (r + 1) * rows_per_block)``), each cut at its end.

    ``body``: ``"lanes"`` and ``"table"`` sum into shared-memory tables
    (``smem`` bytes a block) and flush them into the output at the
    block's end; ``"direct"`` adds every row into the output.
    ``width``: the lanes body's W (features a warp sums side by side),
    else 1. ``classes``: the grid's second axis, one class a plane of
    ``blocks`` blocks (each class's plane reads the bins again)."""
    body: str
    width: int
    blocks: int
    threads: int
    smem: int
    group: int
    groups: int
    chunk_slots: int
    chunks: int
    rows_per_block: int
    row_blocks: int
    classes: int = 1

    @property
    def grid(self):
        return (self.blocks, self.classes, 1)


def hist_launch_plan(n: int, F: int, n_nodes: int, n_bins: int,
                     bin_bytes: int, smem_optin: int, sms: int,
                     classes: int = 1) -> HistPlan:
    """The launch plan of K6 for one level of ``classes`` classes, from
    the shapes and the card (its opt-in shared memory per block and its
    SM count) alone. Every class runs the same plan on its own plane of
    the grid (``blockIdx.y``), and the planes share the wave: the row
    blocks are cut so that all classes' blocks together fill it.

    What it answers (``PERF.md`` §6, K6): shared-memory traffic sets
    K6's pace (each f32 add a CAS loop; random slots meet in banks),
    then the latency of each row's loads; at 256 nodes the first body's
    re-reads of every row by every slot chunk cost more than one
    ``index_add_``. Blocks have 1024 threads. A block's tables take at
    most half an SM's shared memory where they fit (two blocks, 64
    warps, share an SM), else all of it, and row blocks fill one wave
    of resident blocks and no more (each adds one flush of every slot).
    The body, by how many slots (node, bin pairs) a level has:

    * ``lanes`` (uint8 bins; the slots fit W = 32 or 16 times over: 1,
      2 and 4 nodes at 255 bins): lane l of a warp sums feature l % W
      of a group of up to W for row l // W, into tables laid out
      [slot][W], so the 32 adds of a warp meet in a bank at most 32 / W
      at a time;
    * ``table`` (one feature's slots fit, or at most
      ``_MAX_TABLE_CHUNKS`` chunks of whole nodes do): a block sums as
      many features as their tables fit, spread evenly over the groups
      (at 255 bins and 28 features 4 at 8 nodes, 2 at 16), a thread 4
      rows at a time, so a row's node id and stats are read once per
      group, not once per feature; a chunked level sums one feature a
      block;
    * ``direct`` (more chunks than that): every row and feature is added
      into the output, each input read once.
    """
    if bin_bytes not in (1, 2):
        raise ValueError(f"bin_bytes must be 1 or 2, got {bin_bytes}")
    if min(n, F, n_nodes, n_bins, sms) < 1:
        raise ValueError(f"empty plan: n={n} F={F} n_nodes={n_nodes} "
                         f"n_bins={n_bins} sms={sms}")
    if not 1 <= classes <= 65535:
        raise ValueError(f"classes {classes} outside [1, 65535] (the "
                         f"grid's second axis)")
    if n_bins > 256 ** bin_bytes:
        raise ValueError(f"n_bins {n_bins} exceeds {bin_bytes}-byte bins")
    n_slots = n_nodes * n_bins
    if n_slots >= 2 ** 31 or n >= 2 ** 40:
        raise ValueError(f"{n_nodes} x {n_bins} slots or n {n} too large")
    half = (smem_optin - _RESERVED_SMEM) // 2          # two blocks an SM

    def cap(nbytes):            # the tables' room: half an SM, else all
        return next((c for c in (half, smem_optin) if nbytes <= c), 0)

    feature = n_slots * HIST_SLOT_BYTES                 # one feature's table
    width, chunk_slots, chunks, tile = 1, n_slots, 1, 4
    lanes = [wd for wd in _LANE_WIDTHS if cap(wd * feature)]
    if bin_bytes == 1 and lanes:
        body, width, tile = "lanes", lanes[0], 32
        groups = -(-F // width)
        group = -(-F // groups)
        smem = width * feature
    elif cap(feature):
        body = "table"
        group = min(F, cap(feature) // feature)
        groups = -(-F // group)
        group = -(-F // groups)                 # balanced groups
        smem = group * feature
    else:
        body, group, groups = "table", 1, F
        max_slots = half // HIST_SLOT_BYTES
        if n_bins <= max_slots:                 # chunks of whole nodes
            chunks = -(-n_nodes // (max_slots // n_bins))
            chunk_slots = -(-n_nodes // chunks) * n_bins
        else:                                   # chunks of one node's bins
            chunks = -(-n_slots // max_slots)
            chunk_slots = -(-n_slots // chunks)
        chunks = -(-n_slots // chunk_slots)
        smem = chunk_slots * HIST_SLOT_BYTES
        if chunks > _MAX_TABLE_CHUNKS:
            body, smem = "direct", 0
            group, groups, chunk_slots, chunks = F, 1, n_slots, 1
    if groups > 65535:
        raise ValueError(f"{F} features need {groups} groups (> 65535)")
    if body == "direct":
        rows_per_block = 4 * HIST_THREADS       # 4 rows a thread
    else:
        tiles = -(-n // tile)
        per_wave = (2 if smem <= half else 1) * sms
        row_blocks = max(1, min(per_wave // (groups * chunks * classes),
                                tiles))
        rows_per_block = tile * -(-tiles // row_blocks)
    row_blocks = -(-n // rows_per_block)
    blocks = groups * chunks * row_blocks
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"{blocks} blocks exceed the grid's limit")
    return HistPlan(body=body, width=width, blocks=blocks,
                    threads=HIST_THREADS, smem=smem, group=group,
                    groups=groups, chunk_slots=chunk_slots, chunks=chunks,
                    rows_per_block=rows_per_block, row_blocks=row_blocks,
                    classes=classes)


def _check(bins_cols, node_rel, g, h, w_count, n_nodes, n_bins):
    """Device, dtype, shape and contiguity; raises on anything K6 does
    not take. node_rel, g and h are all (n,) or all (K, n); w_count is
    (n,). Values are not read (that would stall the card): node ids
    outside [0, n_nodes) and bins outside [0, n_bins) are dropped by the
    kernel and rejected by ``index_add_``."""
    if bins_cols.dim() != 2:
        raise ValueError(f"bins_cols {tuple(bins_cols.shape)} must be (F, n)")
    if bins_cols.dtype not in _BIN_DTYPES:
        raise TypeError(f"bins_cols must be uint8 or int16 (uint16 bits), "
                        f"got {bins_cols.dtype}")
    F, n = bins_cols.shape
    rows = (n,) if g.dim() == 1 else (g.shape[0], n)
    if len(rows) == 2 and not 1 <= rows[0] <= 65535:
        raise ValueError(f"{rows[0]} classes outside [1, 65535]")
    if node_rel.shape != rows or node_rel.dtype != torch.int32:
        raise TypeError(f"node_rel must be int32 {rows}; got "
                        f"{node_rel.dtype} {tuple(node_rel.shape)}")
    for name, t, shape in (("g", g, rows), ("h", h, rows),
                           ("w_count", w_count, (n,))):
        if t.shape != shape or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 {shape}; got {t.dtype} "
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
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mmlspark_level_histogram.argtypes = (
            [ci] * 4 + [vp] * 6 + [ll] + [ci] * 7 + [ll, ll, ci, ci, vp])
        lib.mmlspark_level_histogram.restype = ci
        lib.mmlspark_hist_error_string.argtypes = [ci]
        lib.mmlspark_hist_error_string.restype = ctypes.c_char_p
    return lib


_LIMITS = {}


def _device_limits(device):
    """(opt-in shared memory per block, SM count) of a CUDA device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _LIMITS:
        props = torch.cuda.get_device_properties(idx)
        _LIMITS[idx] = (props.shared_memory_per_block_optin,
                        props.multi_processor_count)
    return _LIMITS[idx]


def level_histogram(bins_cols, node_rel, g, h, w_count, n_nodes: int,
                    n_bins: int, *, stats_dtype=None) -> torch.Tensor:
    """(F, n) bins x per-row (g, h, count) -> (n_nodes, F, n_bins, 3) f32,
    the reference's layout (``pallas_kernels.py:246-248``).

    ``bins_cols`` comes from :func:`prepare_bins_columns`; ``node_rel``
    (n,) int32 in [0, n_nodes); g, h, w_count (n,) float32, w_count a
    row's count weight (0/1 from bagging). Multiclass: node_rel, g and h
    (K, n), one row a class, w_count (n,) shared, and the result (K,
    n_nodes, F, n_bins, 3): one launch for all K classes (the grid's
    second axis), each class's blocks reading the bins again.
    ``stats_dtype=torch.bfloat16`` rounds g/h/w to bf16 before the sums
    (LightGBM's quantized-gradient analog; the kernel rounds on load);
    sums stay f32.

    CPU tensors run :func:`level_histogram_plain`. CUDA tensors launch
    K6 on the current stream with :func:`hist_launch_plan`'s plan and
    count it in ``level_histogram.launches``; anything the kernel does
    not take raises."""
    _check(bins_cols, node_rel, g, h, w_count, n_nodes, n_bins)
    if stats_dtype not in (None, torch.bfloat16):
        raise ValueError(f"stats_dtype must be None or torch.bfloat16, got "
                         f"{stats_dtype}")
    if bins_cols.device.type == "cpu":
        return level_histogram_plain(bins_cols, node_rel, g, h, w_count,
                                     n_nodes, n_bins, stats_dtype=stats_dtype)
    if bins_cols.device.type != "cuda":
        raise ValueError(f"unsupported device {bins_cols.device}")
    for name, t in (("node_rel", node_rel), ("g", g), ("h", h),
                    ("w_count", w_count)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned on CUDA (K6 "
                             f"loads four rows at once)")
    F, n = bins_cols.shape
    classes = 1 if g.dim() == 1 else g.shape[0]
    out = torch.zeros(g.shape[:-1] + (n_nodes, F, n_bins, 3),
                      dtype=torch.float32, device=bins_cols.device)
    if n == 0 or F == 0:
        return out
    bin_bytes = _BIN_DTYPES[bins_cols.dtype]
    plan = hist_launch_plan(n, F, n_nodes, n_bins, bin_bytes,
                            *_device_limits(bins_cols.device), classes)
    lib = _library()
    with torch.cuda.device(bins_cols.device):
        stream = torch.cuda.current_stream(bins_cols.device).cuda_stream
        err = lib.mmlspark_level_histogram(
            HIST_BODIES[plan.body], plan.width, bin_bytes,
            int(stats_dtype is not None),
            bins_cols.data_ptr(),
            node_rel.data_ptr(), g.data_ptr(), h.data_ptr(),
            w_count.data_ptr(), out.data_ptr(), n, F, n_nodes, n_bins,
            plan.group, plan.groups, plan.chunk_slots, plan.chunks,
            plan.rows_per_block, plan.blocks, plan.classes, plan.smem,
            stream)
    if err != 0:
        msg = lib.mmlspark_hist_error_string(err).decode()
        raise RuntimeError(f"level histogram kernel launch failed: {msg}")
    with _COUNT_LOCK:
        level_histogram.launches += 1
    return out


#: K6 launches since the last reset; the plain CPU path never counts
level_histogram.launches = 0
