"""Histogram tree construction and prediction (counterpart of
``models/gbdt/trees.py``, single device).

Trees grow depth-wise as complete binary trees of static depth, so every
level is fixed-shape: one histogram per level (K6, ``ops/histogram.py``),
one vectorized split search, one gather-based row routing. Early-stopped
nodes route all their rows left with a sentinel split (``feat = -1``,
``thr_bin = n_bins``), so leaf values computed at the bottom level are
right for stopped subtrees too. Nothing in :func:`build_tree` reads a
device value on the host: a tree's arrays stay on the card until the
caller materializes them.

Multiclass trees (one per class an iteration) grow together: the JAX
package ``vmap``s :func:`build_tree` over the classes; here g and h carry
a class axis, each level's K histograms come from one K6 launch, and the
split search runs once over all K x nodes histograms.

Prefix sums over the bin axis (:func:`_prefix_sum`) associate their adds
as the reference's XLA lowering of ``jnp.cumsum`` does (blocks of 16), so
that split gains computed from the same histogram are bit-identical to
the reference's.

Left out in this slice (the JAX package has them): the monotone,
``cand_mask`` (extra_trees), ``path_smooth`` and interaction-constraint
branches of the split search, EFB debundling, voting-parallel splits, the
data-parallel ``psum`` and linear leaves.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops.histogram import bins_as_int, level_histogram, \
    level_histogram_plain

__all__ = ["TreeArrays", "build_tree", "predict_trees",
           "predict_leaf_indices", "map_rows"]

_SCAN_BLOCK = 16


class TreeArrays(NamedTuple):
    """One fitted tree in complete-binary-tree layout (depth D).

    feat: (2^D - 1,) int32 — split feature per internal node, -1 = leaf/stub
    thr_bin: (2^D - 1,) int32 — split bin (left iff bin <= thr_bin)
    thr_raw: (2^D - 1,) float32 — raw threshold (left iff x <= thr or NaN)
    leaf_value: (2^D,) float32 — values at bottom level
    """
    feat: torch.Tensor
    thr_bin: torch.Tensor
    thr_raw: torch.Tensor
    leaf_value: torch.Tensor


def _prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim``, with the adds associated as the
    reference's XLA CPU lowering of ``jnp.cumsum`` associates them:
    sequential within blocks of 16, the block totals scanned the same way,
    each block then offset by the total of the blocks before it."""
    return _scan_last(x.movedim(dim, -1)).movedim(-1, dim)


def _scan_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, dim=-1)
    nb = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    within = _scan_last(xp.reshape(x.shape[:-1] + (nb, _SCAN_BLOCK)))
    totals = _scan_last(within[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]],
                       dim=-1)
    return (within + before[..., None]).reshape(xp.shape)[..., :n]


def _split_gains(hist, lam, min_gain, min_child_weight, min_data_in_leaf,
                 feature_mask):
    """hist (nodes, F, B, 3) -> masked split gains (nodes, F, B); invalid
    candidates are -inf. ``feature_mask`` may be (F,) or (nodes, F).
    Python-float hyperparameters act as f32 values, as the reference's
    traced scalars do (torch rounds a scalar to the tensor's dtype)."""
    GL, HL, CL = _prefix_sum(hist, 2).unbind(-1)
    Gt, Ht, Ct = GL[..., -1:], HL[..., -1:], CL[..., -1:]
    GR, HR, CR = Gt - GL, Ht - HL, Ct - CL

    def score(g, h):
        return (g * g) / (h + lam)

    gain = 0.5 * (score(GL, HL) + score(GR, HR) - score(Gt, Ht))
    valid = ((HL >= min_child_weight) & (HR >= min_child_weight)
             & (CL >= min_data_in_leaf) & (CR >= min_data_in_leaf)
             & (gain > min_gain))
    if feature_mask is not None:
        fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None, :]
        valid = valid & fm[:, :, None]
    return torch.where(valid, gain, -torch.inf)


def _find_splits(hist, lam, min_gain, min_child_weight, min_data_in_leaf,
                 feature_mask):
    """hist (nodes, F, B, 3) -> best (feat, bin, gain) per node; a node
    with no valid candidate gets the stub split (-1, n_bins, 0)."""
    gain = _split_gains(hist, lam, min_gain, min_child_weight,
                        min_data_in_leaf, feature_mask)
    flat = gain.reshape(gain.shape[0], -1)           # (nodes, F*B)
    best = torch.argmax(flat, dim=-1)                # first max on ties
    best_gain = flat.gather(1, best[:, None])[:, 0]
    n_bins = hist.shape[2]
    best_feat = torch.div(best, n_bins, rounding_mode="floor").to(torch.int32)
    best_bin = (best % n_bins).to(torch.int32)
    ok = torch.isfinite(best_gain)
    return (torch.where(ok, best_feat, -1),
            torch.where(ok, best_bin, n_bins),       # sentinel: all rows left
            torch.where(ok, best_gain, 0.0))


def build_tree(bins_cols: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
               sample_weight_count: torch.Tensor, depth: int, n_bins: int,
               lam: float = 1e-3, alpha: float = 0.0, min_gain: float = 0.0,
               min_child_weight: float = 1e-3, min_data_in_leaf: float = 1.0,
               feature_mask: Optional[torch.Tensor] = None,
               hist_dtype: Optional[torch.dtype] = None,
               hist_impl: str = "kernel"):
    """Grow one depth-``depth`` tree on the tensors' device, or one tree
    per class when g and h have a class axis.

    bins_cols: (F, n) bins from :func:`~mmlspark_tpu_torch.ops.histogram.
    prepare_bins_columns`; g/h: (n,) f32 gradients/hessians (already
    weighted), or (K, n) contiguous, one row a class; sample_weight_count:
    (n,) f32, 1.0 for live rows and 0.0 for bagged-out ones, shared by the
    classes. ``hist_dtype=torch.bfloat16`` rounds the histogram's stats to
    bf16 (sums stay f32). ``hist_impl`` "kernel" builds each level's
    histograms with :func:`level_histogram` (K6 on CUDA, one launch a
    level for all classes; its plain version on CPU); "plain" forces the
    plain version on any device (the card's checks compare the two).

    Returns (feat, thr_bin, leaf_value, node_rel, gains, covers), all on
    the device: (2^D-1,) int32, (2^D-1,) int32, (2^D,) f32, (n,) int32
    leaf index per row, (2^D-1,) f32, (2^(D+1)-1,) f32; with (K, n) g/h
    each gains a leading class axis of K."""
    if hist_impl not in ("kernel", "plain"):
        raise ValueError(f"hist_impl must be 'kernel' or 'plain', got "
                         f"{hist_impl!r}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    hist_fn = level_histogram if hist_impl == "kernel" else \
        level_histogram_plain
    batched = g.dim() == 2
    K = g.shape[0] if batched else 1
    F, n = bins_cols.shape
    dev = bins_cols.device
    n_internal = 2 ** depth - 1
    feats = torch.full((K, n_internal), -1, dtype=torch.int32, device=dev)
    thrs = torch.full((K, n_internal), n_bins, dtype=torch.int32, device=dev)
    gains = torch.zeros((K, n_internal), dtype=torch.float32, device=dev)
    covers = torch.zeros((K, 2 ** (depth + 1) - 1), dtype=torch.float32,
                         device=dev)
    node_rel = torch.zeros((K, n), dtype=torch.int32, device=dev)
    leaf_stats = None
    for d in range(depth):
        n_nodes = 2 ** d
        m = K * n_nodes                     # the level's nodes, class-major
        off = 2 ** d - 1
        hist = hist_fn(bins_cols, node_rel if batched else node_rel[0], g, h,
                       sample_weight_count, n_nodes, n_bins,
                       stats_dtype=hist_dtype).reshape(m, F, n_bins, 3)
        level_cover = hist[:, 0, :, 2].sum(dim=-1)       # counts per node
        bf, bb, bg = _find_splits(hist, lam, min_gain, min_child_weight,
                                  min_data_in_leaf, feature_mask)
        if d == depth - 1:
            # bottom-level leaf stats from the last histogram: left child =
            # prefix sum at the split bin, right = node total minus left;
            # stubs (thr = n_bins, clipped to the last bin) keep all rows
            f_sel = bf.clamp(0, F - 1).to(torch.int64)
            sel = hist.gather(1, f_sel[:, None, None, None].expand(
                m, 1, n_bins, 3))[:, 0]                  # (nodes, B, 3)
            cs = _prefix_sum(sel, 1)
            b_sel = bb.clamp(0, n_bins - 1).to(torch.int64)
            left = cs.gather(1, b_sel[:, None, None].expand(
                m, 1, 3))[:, 0]                          # (nodes, 3)
            right = cs[:, -1] - left
            leaf_stats = torch.stack([left, right], dim=1).reshape(
                K, 2 * n_nodes, 3)
        covers[:, off:off + n_nodes] = level_cover.view(K, n_nodes)
        feats[:, off:off + n_nodes] = bf.view(K, n_nodes)
        thrs[:, off:off + n_nodes] = bb.view(K, n_nodes)
        gains[:, off:off + n_nodes] = bg.view(K, n_nodes)
        # route rows: bin <= thr -> left; stub splits (thr = n_bins) -> left
        node_idx = node_rel if K == 1 else node_rel + torch.arange(
            0, m, n_nodes, dtype=torch.int32, device=dev)[:, None]
        node_idx = node_idx.view(-1)
        row_feat = bf.index_select(0, node_idx).clamp(0, F - 1).view(K, n)
        row_bin = bins_as_int(bins_cols.gather(0, row_feat.to(torch.int64)))
        go_right = row_bin > bb.index_select(0, node_idx).view(K, n)
        node_rel = node_rel * 2 + go_right.to(torch.int32)

    G, H, C = leaf_stats.unbind(-1)
    G_reg = torch.sign(G) * torch.clamp_min(G.abs() - alpha, 0.0)  # L1 shrink
    leaf_value = -G_reg / (H + lam)
    leaf_value = torch.where(H.abs() > 0, leaf_value, 0.0)
    covers[:, 2 ** depth - 1:] = C
    out = (feats, thrs, leaf_value, node_rel, gains, covers)
    return out if batched else tuple(t[0] for t in out)


def _descend(f, t, X, depth: int) -> torch.Tensor:
    """Leaf index (n,) int64 of every row of X in one tree; NaN goes left,
    as does every row at a stub node (feat < 0)."""
    n, F = X.shape
    idx = torch.zeros(n, dtype=torch.int64, device=X.device)
    for _ in range(depth):
        nf = f[idx]
        nt = t[idx]
        x = X.gather(1, nf.clamp(0, F - 1).to(torch.int64)[:, None])[:, 0]
        go_left = (nf < 0) | (x <= nt) | torch.isnan(x)
        idx = 2 * idx + 2 - go_left.to(torch.int64)
    return idx - (2 ** depth - 1)


def predict_trees(feats, thr_raw, leaf_values, X, depth: int) -> torch.Tensor:
    """Sum of tree outputs for raw features, trees added in order.

    feats (T, 2^D-1) int32, thr_raw (T, 2^D-1) f32, leaf_values (T, 2^D)
    or (T, K, 2^D) f32; X (n, F) f32, all on one device. Returns (n,) or
    (n, K) f32."""
    n = X.shape[0]
    multi = leaf_values.dim() == 3
    out = torch.zeros((n, leaf_values.shape[1]) if multi else (n,),
                      dtype=torch.float32, device=X.device)
    for t in range(feats.shape[0]):
        leaf = _descend(feats[t], thr_raw[t], X, depth)
        lv = leaf_values[t]
        out = out + (lv[:, leaf].T if multi else lv[leaf])
    return out


def predict_leaf_indices(feats, thr_raw, X, depth: int) -> torch.Tensor:
    """Leaf index per (row, tree), (n, T) int32 — LightGBM predictLeaf."""
    cols = [_descend(feats[t], thr_raw[t], X, depth)
            for t in range(feats.shape[0])]
    if not cols:
        return torch.zeros((X.shape[0], 0), dtype=torch.int32,
                           device=X.device)
    return torch.stack(cols, dim=1).to(torch.int32)


#: rows of a scipy-sparse X densified at a time on the host; dense X
#: crosses to the device in one pass
SPARSE_ROWS = 1 << 16


def map_rows(fn, X, device, dim: int = 0) -> torch.Tensor:
    """``fn(rows)`` over the rows of X as dense float32 tensors on
    ``device``, the results concatenated along ``dim``: dense X in one
    pass, scipy-sparse X densified ``SPARSE_ROWS`` rows at a time so that
    peak host memory is O(SPARSE_ROWS x F). Nothing comes back to the
    host."""
    from .binning import is_sparse
    if not is_sparse(X):
        return fn(torch.from_numpy(np.ascontiguousarray(
            X, dtype=np.float32)).to(device))
    X = X.tocsr()
    return torch.cat([fn(torch.from_numpy(
        X[lo:lo + SPARSE_ROWS].toarray().astype(np.float32)).to(device))
        for lo in range(0, max(X.shape[0], 1), SPARSE_ROWS)], dim=dim)
