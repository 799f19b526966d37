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
split search runs once over all K x nodes histograms (every per-node
state below, bounds, parent outputs, compatible groups, is laid out
class-major the same way).

The split search takes the JAX package's options: monotone constraints
(per-node value bounds carried down the tree, violating candidates
masked, leaves clamped), ``path_smooth`` (node outputs pulled toward the
parent's), interaction constraints (per-node compatible feature groups)
and EFB bundles (the level's histogram built in bundle space by K6 at
``n_bundle_bins`` and debundled to features, :func:`_debundle`).
Linear leaves (``linear_tree``) fit a ridge model per leaf over the
leaf's path features after the tree is built (:func:`fit_linear_leaves`).

``extra_trees`` (one random candidate bin per node x feature) and
``feature_fraction_bynode`` (a random feature subset per node) draw from
the JAX package's threefry stream (:mod:`...utils.prng`, bit for bit
``jax.random``), keyed per level as the reference keys them, so both
packages grow the same randomized trees.

Prefix sums over the bin axis (:func:`_prefix_sum`) and reductions
(:func:`_reduce_sum`) associate their adds as the reference's XLA
lowerings of ``jnp.cumsum`` and ``jnp.sum`` do, so that split gains
computed from the same histogram are bit-identical to the reference's.

Left out (the JAX package has them): voting-parallel splits and the
data-parallel ``psum`` (slice 6).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops.histogram import bins_as_int, level_histogram, \
    level_histogram_plain
from ...utils import prng

__all__ = ["TreeArrays", "BundleTables", "build_tree", "predict_trees",
           "predict_leaf_indices", "map_rows", "path_features",
           "fit_linear_leaves", "predict_trees_linear"]

_SCAN_BLOCK = 16
#: the window XLA's CPU tree-reduction rewrite cuts a long reduced axis
#: into
_REDUCE_WINDOW = 32


class BundleTables(NamedTuple):
    """EFB decode tables (``bundling.FeatureBundler``), each (F,) int64
    on the device: feature -> its bundle, its slot offset in the bundle,
    its bin count, and its default (zero-value) bin."""
    bundle_of: torch.Tensor
    offset_of: torch.Tensor
    width_of: torch.Tensor
    zero_bin: torch.Tensor

    @staticmethod
    def from_bundler(bundler, device) -> "BundleTables":
        return BundleTables(*(torch.as_tensor(
            np.asarray(a, dtype=np.int64)).to(device) for a in (
                bundler.bundle_of, bundler.offset_of, bundler.width_of,
                bundler.zero_bin)))


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


def _reduce_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim``, with the adds associated as the reference's XLA
    CPU lowering of ``jnp.sum`` associates them: an axis of at most 32
    adds in order from zero; a longer one is padded with zeros to a
    multiple of 32 (half the padding in front, the odd one behind), each
    window of 32 summed in order, and the window sums reduced the same
    way."""
    return _reduce_last(x.movedim(dim, -1))


def _reduce_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= _REDUCE_WINDOW:
        acc = torch.zeros_like(x[..., 0])
        for j in range(n):
            acc = acc + x[..., j]
        return acc
    nw = -(-n // _REDUCE_WINDOW)
    pad = nw * _REDUCE_WINDOW - n
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return _reduce_last(_reduce_last(
        xp.reshape(x.shape[:-1] + (nw, _REDUCE_WINDOW))))


def _debundle(hist_b: torch.Tensor, bundles: BundleTables,
              n_bins: int) -> torch.Tensor:
    """Bundled histogram (nodes, n_bundles, B_bundle, 3) -> the
    per-feature histogram (nodes, F, n_bins, 3).

    A feature's non-default bins are a gather of its slot range; its
    default bin is the node total (the sum of any one bundle's bins:
    every row lands in exactly one bin of each bundle) less its
    non-default stats. Exact for conflict-free bundles; a conflict row is
    counted at the losing feature's default bin, the EFB
    approximation."""
    dev = hist_b.device
    ar = torch.arange(n_bins, device=dev)
    pos = (bundles.offset_of[:, None] + ar[None, :]).clamp(
        0, hist_b.shape[2] - 1)                                   # (F, B)
    gathered = hist_b[:, bundles.bundle_of[:, None], pos, :]  # (nodes,F,B,3)
    validpos = ar[None, :] < bundles.width_of[:, None]            # (F, B)
    gathered = gathered * validpos[None, :, :, None]
    total = _reduce_sum(hist_b[:, 0, :, :], 1)                    # (nodes, 3)
    default = total[:, None, :] - _reduce_sum(gathered, 2)        # (nodes,F,3)
    zslot = ar[None, :] == bundles.zero_bin[:, None]              # (F, B)
    return torch.where(zslot[None, :, :, None], default[:, :, None, :],
                       gathered)


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32, as the reference's XLA CPU
    backend contracts a multiply that feeds an add: the product of two
    float32 values is exact in float64, and the float64 sum rounds to
    float32 (a second rounding that differs from one only when the
    float64 sum lands on a float32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def _smooth(raw, cnt, parent, path_smooth: float, fuse_parent=False):
    """LightGBM path smoothing: pull a node's output toward its parent's
    with ``path_smooth`` pseudo-counts (the root smooths toward 0).

    ``t raw + (1 - t) parent`` with one product fused into the add, as
    the reference's XLA CPU backend compiles it: the raw side's product
    where the parent is a per-node vector, the parent's where it is
    broadcast over (feature, bin) in the split search
    (``fuse_parent``)."""
    t = cnt / torch.clamp_min(cnt + path_smooth, 1e-12)
    if fuse_parent:
        return _fma(1.0 - t, parent, t * raw)
    return _fma(t, raw, (1.0 - t) * parent)


def _dot_rows(a, b):
    """Row sums of ``a * b`` (n, k), k <= 32, as the reference's fused
    reduce forms them: a chain of fused multiply-adds from zero."""
    acc = torch.zeros_like(a[:, 0])
    for j in range(a.shape[1]):
        acc = _fma(a[:, j], b[:, j], acc)
    return acc


def _clip(x, lo, hi):
    """``jnp.clip``: NaN propagates, as through maximum then minimum."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _find_splits(hist, *args, **kw):
    """hist (nodes, F, B, 3) -> best (feat, bin, gain) per node
    (:func:`_prefix_splits` of its prefix sums)."""
    return _prefix_splits(_prefix_sum(hist, 2), *args, **kw)


def _prefix_gains(cs, lam, min_gain, min_child_weight, min_data_in_leaf,
                  feature_mask, monotone=None, bounds=None, path_smooth=0.0,
                  parent_value=None, cand_mask=None):
    """Prefix sums ``cs`` (nodes, F, B, 3) of a level's histogram ->
    masked split gains (nodes, F, B); invalid candidates are -inf.
    ``feature_mask`` may be (F,) or (nodes, F). ``monotone`` (F,) in
    {-1, 0, +1} with ``bounds`` (lo, hi) each (nodes,) masks candidates
    whose bound-clamped child values violate the feature's direction.
    With ``path_smooth > 0`` the gains are taken at the smoothed child
    outputs (``parent_value`` (nodes,), each node's own smoothed output).
    ``cand_mask`` (nodes, F, B) restricts the threshold candidates
    (extra_trees' one drawn bin per node x feature). Python-float
    hyperparameters act as f32 values, as the reference's traced scalars
    do (torch rounds a scalar to the tensor's dtype)."""
    GL, HL, CL = cs.unbind(-1)
    Gt, Ht, Ct = GL[..., -1:], HL[..., -1:], CL[..., -1:]
    GR, HR, CR = Gt - GL, Ht - HL, Ct - CL

    def score(g, h):
        return (g * g) / (h + lam)

    if path_smooth > 0.0:
        # the gain at the smoothed outputs: lg(g, h, w) = -(g w + (h +
        # lam) w^2 / 2), which at w = -g / (h + lam) is the closed form
        pv = parent_value[:, None, None]
        wL = _smooth(-GL / (HL + lam), CL, pv, path_smooth, True)
        wR = _smooth(-GR / (HR + lam), CR, pv, path_smooth, True)

        def lg(g, h, w):
            return -_fma(g, w, 0.5 * (h + lam) * w * w)

        gain = lg(GL, HL, wL) + lg(GR, HR, wR) - lg(Gt, Ht, pv)
    else:
        gain = 0.5 * (score(GL, HL) + score(GR, HR) - score(Gt, Ht))
    valid = ((HL >= min_child_weight) & (HR >= min_child_weight)
             & (CL >= min_data_in_leaf) & (CR >= min_data_in_leaf)
             & (gain > min_gain))
    if feature_mask is not None:
        fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None, :]
        valid = valid & fm[:, :, None]
    if cand_mask is not None:
        valid = valid & cand_mask
    if monotone is not None:
        lo, hi = (b[:, None, None] for b in bounds)
        vL = _clip(-GL / (HL + lam), lo, hi)
        vR = _clip(-GR / (HR + lam), lo, hi)
        m = monotone[None, :, None].to(torch.float32)
        valid = valid & (m * (vR - vL) >= 0)
    return torch.where(valid, gain, -torch.inf)


def _prefix_splits(cs, lam, min_gain, min_child_weight, min_data_in_leaf,
                   feature_mask, **kw):
    """Prefix sums (nodes, F, B, 3) -> best (feat, bin, gain) per node; a
    node with no valid candidate gets the stub split (-1, n_bins, 0)."""
    gain = _prefix_gains(cs, lam, min_gain, min_child_weight,
                         min_data_in_leaf, feature_mask, **kw)
    flat = gain.reshape(gain.shape[0], -1)           # (nodes, F*B)
    best = torch.argmax(flat, dim=-1)                # first max on ties
    best_gain = flat.gather(1, best[:, None])[:, 0]
    n_bins = cs.shape[2]
    best_feat = torch.div(best, n_bins, rounding_mode="floor").to(torch.int32)
    best_bin = (best % n_bins).to(torch.int32)
    ok = torch.isfinite(best_gain)
    return (torch.where(ok, best_feat, -1),
            torch.where(ok, best_bin, n_bins),       # sentinel: all rows left
            torch.where(ok, best_gain, 0.0))


def _chosen(cs, bf, bb):
    """Prefix sums (nodes, F, B, 3) at each node's chosen (feat, bin):
    (left (nodes, 3), total (nodes, 3)). Stubs (thr = n_bins, clipped to
    the last bin) keep all rows left."""
    m, F, B, _ = cs.shape
    f_sel = bf.clamp(0, F - 1).to(torch.int64)
    sel = cs.gather(1, f_sel[:, None, None, None].expand(m, 1, B, 3))[:, 0]
    b_sel = bb.clamp(0, B - 1).to(torch.int64)
    left = sel.gather(1, b_sel[:, None, None].expand(m, 1, 3))[:, 0]
    return left, sel[:, -1]


def build_tree(bins_cols: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
               sample_weight_count: torch.Tensor, depth: int, n_bins: int,
               lam: float = 1e-3, alpha: float = 0.0, min_gain: float = 0.0,
               min_child_weight: float = 1e-3, min_data_in_leaf: float = 1.0,
               feature_mask: Optional[torch.Tensor] = None,
               hist_dtype: Optional[torch.dtype] = None,
               hist_impl: str = "kernel",
               bundles: Optional[BundleTables] = None,
               n_bundle_bins: int = 0,
               monotone: Optional[torch.Tensor] = None,
               path_smooth: float = 0.0,
               ic_groups: Optional[torch.Tensor] = None,
               rng: Optional[torch.Tensor] = None,
               extra_trees: bool = False, ff_bynode: float = 1.0,
               feat_bins: Optional[torch.Tensor] = None):
    """Grow one depth-``depth`` tree on the tensors' device, or one tree
    per class when g and h have a class axis.

    bins_cols: (F, n) bins from :func:`~mmlspark_tpu_torch.ops.histogram.
    prepare_bins_columns` — or, with ``bundles``, the (n_bundles, n) EFB
    matrix whose histograms (K6 at ``n_bundle_bins``) are debundled to
    the original features before the split search; g/h: (n,) f32
    gradients/hessians (already weighted), or (K, n) contiguous, one row
    a class; sample_weight_count: (n,) f32, 1.0 for live rows and 0.0 for
    bagged-out ones, shared by the classes. ``hist_dtype=torch.bfloat16``
    rounds the histogram's stats to bf16 (sums stay f32). ``hist_impl``
    "kernel" builds each level's histograms with :func:`level_histogram`
    (K6 on CUDA, one launch a level for all classes; its plain version
    on CPU); "plain" forces the plain version on any device (the card's
    checks compare the two).

    ``monotone``: (F,) int32 in {-1, 0, +1}, LightGBM's
    monotone_constraints. ``path_smooth``: pseudo-counts pulling each
    node's output toward its parent's. ``ic_groups``: (G, F) bool, the
    allowed feature groups of LightGBM's interaction_constraints (a
    branch only combines features that share a group; features in no
    group are never used). ``rng``: the tree's threefry key (2,), or
    one key a class (K, 2) (:mod:`...utils.prng`), for the per-level
    draws of ``extra_trees`` (one candidate bin per node x feature,
    uniform over the feature's ``feat_bins`` (F,) populated bins, the
    missing bin included) and ``ff_bynode`` < 1 (each node keeps the top
    ``round(F * ff_bynode)`` draws of the features its mask allows).

    Returns (feat, thr_bin, leaf_value, node_rel, gains, covers), all on
    the device: (2^D-1,) int32, (2^D-1,) int32, (2^D,) f32, (n,) int32
    leaf index per row, (2^D-1,) f32, (2^(D+1)-1,) f32; with (K, n) g/h
    each gains a leading class axis of K."""
    if (extra_trees or ff_bynode < 1.0) and rng is None:
        raise ValueError("extra_trees / ff_bynode < 1 need an rng key")
    if hist_impl not in ("kernel", "plain"):
        raise ValueError(f"hist_impl must be 'kernel' or 'plain', got "
                         f"{hist_impl!r}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    hist_fn = level_histogram if hist_impl == "kernel" else \
        level_histogram_plain
    batched = g.dim() == 2
    K = g.shape[0] if batched else 1
    n = bins_cols.shape[1]
    F = bundles.bundle_of.shape[0] if bundles is not None \
        else bins_cols.shape[0]
    kbins = n_bundle_bins if bundles is not None else n_bins
    dev = bins_cols.device
    n_internal = 2 ** depth - 1
    feats = torch.full((K, n_internal), -1, dtype=torch.int32, device=dev)
    thrs = torch.full((K, n_internal), n_bins, dtype=torch.int32, device=dev)
    gains = torch.zeros((K, n_internal), dtype=torch.float32, device=dev)
    covers = torch.zeros((K, 2 ** (depth + 1) - 1), dtype=torch.float32,
                         device=dev)
    node_rel = torch.zeros((K, n), dtype=torch.int32, device=dev)
    # per-node state carried down the tree, one entry per class-major node:
    # the monotone value bounds (lo, hi), the parent's smoothed output,
    # the interaction groups still compatible with the path
    lo = hi = pp = compat = None
    if monotone is not None:
        lo = torch.full((K,), -torch.inf, device=dev)
        hi = torch.full((K,), torch.inf, device=dev)
    if path_smooth > 0.0:
        pp = torch.zeros(K, device=dev)
    if ic_groups is not None:
        compat = torch.ones((K, ic_groups.shape[0]), dtype=torch.bool,
                            device=dev)
    draws = None
    if extra_trees or ff_bynode < 1.0:
        # every level's draws at once (uniform(fold_in(key, 2d)) for the
        # candidate bins, 2d + 1 for the feature subsets): a draw of
        # (n_nodes, F) is the first n_nodes rows of the same key's draw at
        # the bottom level's (2^(depth-1), F), element for element
        keys = rng.to(dev).reshape(-1, 2).expand(K, 2)   # one per class
        draws = prng.uniform(prng.fold_in(keys[:, None, :], torch.arange(
            2 * depth, device=dev)), (2 ** (depth - 1), F))
    leaf_stats = None
    for d in range(depth):
        n_nodes = 2 ** d
        m = K * n_nodes                     # the level's nodes, class-major
        off = 2 ** d - 1
        hist = hist_fn(bins_cols, node_rel if batched else node_rel[0], g, h,
                       sample_weight_count, n_nodes, kbins,
                       stats_dtype=hist_dtype).reshape(
                           m, bins_cols.shape[0], kbins, 3)
        if bundles is not None:
            hist = _debundle(hist, bundles, n_bins)
        level_cover = hist[:, 0, :, 2].sum(dim=-1)       # counts per node
        # the level's draws: keys fold in the level, so every level redraws
        cand = None
        if extra_trees:
            # one candidate bin per node x feature, within the feature's
            # own populated range (feat_bins, the missing bin included)
            u = draws[:, 2 * d, :n_nodes].reshape(m, F)
            bin_hi = (feat_bins - 1).clamp_min(1)[None, :] \
                if feat_bins is not None else torch.full(
                    (1, F), max(n_bins - 1, 1), dtype=torch.int32,
                    device=dev)
            r = torch.minimum((u * bin_hi).to(torch.int32), bin_hi - 1)
            cand = torch.arange(n_bins, device=dev)[None, None, :] \
                == r[:, :, None]
        fm_level = feature_mask
        if compat is not None:
            allowed = (compat[:, :, None] & ic_groups[None, :, :]).any(dim=1)
            if fm_level is not None:
                allowed = allowed & (fm_level if fm_level.dim() == 2
                                     else fm_level[None, :])
            fm_level = allowed                           # (m, F)
        if ff_bynode < 1.0:
            # each node keeps the top draws among the features its mask
            # allows (the masked ones draw -1)
            kk = max(1, int(round(F * ff_bynode)))
            u = draws[:, 2 * d + 1, :n_nodes].reshape(m, F)
            fm_b = None
            if fm_level is not None:
                fm_b = fm_level if fm_level.dim() == 2 else fm_level[None, :]
                u = torch.where(fm_b, u, -1.0)
            kth = torch.topk(u, kk, dim=1).values[:, -1:]
            node_mask = u >= kth
            fm_level = node_mask if fm_b is None else node_mask & fm_b
        node_val = None
        if pp is not None:
            # each node's own smoothed output: the raw optimum over its
            # totals (feature 0's bins partition its rows), smoothed toward
            # the carried parent output
            Gt = _reduce_sum(hist[:, 0, :, 0], -1)
            Ht = _reduce_sum(hist[:, 0, :, 1], -1)
            node_val = _smooth(-Gt / (Ht + lam), level_cover, pp, path_smooth)
        cs = _prefix_sum(hist, 2)
        bf, bb, bg = _prefix_splits(cs, lam, min_gain, min_child_weight,
                                    min_data_in_leaf, fm_level,
                                    monotone=monotone,
                                    bounds=(lo, hi) if lo is not None
                                    else None,
                                    path_smooth=path_smooth,
                                    parent_value=node_val, cand_mask=cand)
        left, total = _chosen(cs, bf, bb)
        if d == depth - 1:
            # bottom-level leaf stats from the last histogram: left child =
            # prefix sum at the split bin, right = node total minus left
            leaf_stats = torch.stack([left, total - left], dim=1).reshape(
                K, 2 * n_nodes, 3)
        covers[:, off:off + n_nodes] = level_cover.view(K, n_nodes)
        feats[:, off:off + n_nodes] = bf.view(K, n_nodes)
        thrs[:, off:off + n_nodes] = bb.view(K, n_nodes)
        gains[:, off:off + n_nodes] = bg.view(K, n_nodes)
        # route rows: bin <= thr -> left; stub splits (thr = n_bins) -> left
        node_idx = node_rel if K == 1 else node_rel + torch.arange(
            0, m, n_nodes, dtype=torch.int32, device=dev)[:, None]
        node_idx = node_idx.view(-1)
        row_feat = bf.index_select(0, node_idx).clamp(0, F - 1).view(
            K, n).to(torch.int64)
        if bundles is None:
            row_bin = bins_as_int(bins_cols.gather(0, row_feat))
        else:
            # the split feature's bin from its bundle column: inside its
            # slot range the offset-shifted bin, else its default bin
            rel = bins_as_int(bins_cols.gather(
                0, bundles.bundle_of[row_feat])) - bundles.offset_of[row_feat]
            row_bin = torch.where((rel >= 0) & (rel < bundles.width_of[
                row_feat]), rel, bundles.zero_bin[row_feat])
        go_right = row_bin > bb.index_select(0, node_idx).view(K, n)
        node_rel = node_rel * 2 + go_right.to(torch.int32)
        if lo is not None:
            # children tighten around the chosen split's mid value
            GL, HL = left[:, 0], left[:, 1]
            vL = _clip(-GL / (HL + lam), lo, hi)
            vR = _clip(-(total[:, 0] - GL) / ((total[:, 1] - HL) + lam),
                       lo, hi)
            mid = 0.5 * (vL + vR)
            m_node = torch.where(bf >= 0, monotone[bf.clamp(0, F - 1).to(
                torch.int64)], 0)
            left_lo = torch.where(m_node < 0, torch.maximum(lo, mid), lo)
            left_hi = torch.where(m_node > 0, torch.minimum(hi, mid), hi)
            right_lo = torch.where(m_node > 0, torch.maximum(lo, mid), lo)
            right_hi = torch.where(m_node < 0, torch.minimum(hi, mid), hi)
            lo = torch.stack([left_lo, right_lo], dim=1).reshape(-1)
            hi = torch.stack([left_hi, right_hi], dim=1).reshape(-1)
        if pp is not None:
            # both children smooth toward this node's output next level
            pp = node_val.repeat_interleave(2)
        if compat is not None:
            # children keep only the groups holding the chosen feature;
            # stubs pass their set through unchanged
            contains = ic_groups[:, bf.clamp(0, F - 1).to(torch.int64)].T
            compat = torch.where((bf >= 0)[:, None], compat & contains,
                                 compat).repeat_interleave(2, dim=0)

    G, H, C = leaf_stats.unbind(-1)
    G_reg = torch.sign(G) * torch.clamp_min(G.abs() - alpha, 0.0)  # L1 shrink
    leaf_value = -G_reg / (H + lam)
    leaf_value = torch.where(H.abs() > 0, leaf_value, 0.0)
    if pp is not None:
        # empty leaves (count 0) land exactly on the parent's output
        leaf_value = _smooth(leaf_value, C, pp.view(K, -1), path_smooth)
    if lo is not None:
        # each leaf clamps into its inherited interval
        leaf_value = _clip(leaf_value, lo.view(K, -1), hi.view(K, -1))
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


def path_features(feats_np: np.ndarray, depth: int) -> np.ndarray:
    """(2^D - 1,) split features -> (2^D, D) features on each leaf's path
    (host numpy): leaf l's linear model regresses on the features its
    root-to-leaf path split on. A feature repeated on a path keeps its
    first slot only (later ones -1), so a leaf's design matrix never
    carries collinear copies; stub levels give -1 (a masked column)."""
    n_leaf = 2 ** depth
    pf = np.full((n_leaf, depth), -1, dtype=np.int32)
    for leaf in range(n_leaf):
        idx = 0
        seen = set()
        for d in range(depth):
            f = int(feats_np[idx])
            if f >= 0 and f not in seen:
                pf[leaf, d] = f
                seen.add(f)
            bit = (leaf >> (depth - 1 - d)) & 1
            idx = 2 * idx + 1 + bit
    return pf


def _leaf_design(X, leaf_idx, pf):
    """Per-row linear-leaf design matrix [x at the path features, 1],
    (n, D+1); masked slots (pf = -1) and missing values give 0."""
    pfl = pf[leaf_idx]                                        # (n, D)
    xsel = X.gather(1, pfl.clamp(0, X.shape[1] - 1).to(torch.int64))
    xsel = torch.where((pfl >= 0) & ~torch.isnan(xsel), xsel, 0.0)
    return torch.cat([xsel, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                       device=X.device)], dim=1)


def _ridge_solve(Mr: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the batched systems Mr x = b, (L, k, k) and (L, k) f32. On
    the card one ``torch.linalg.solve_ex`` (no error check, so no host
    sync: a singular system gives non-finite values). On CPU tensors each
    system goes through LAPACK's ``sgetrf`` and two ``strsm`` (scipy's),
    the reference's CPU lowering of ``jnp.linalg.solve``, so the CPU
    results are bitwise the reference's."""
    if Mr.device.type != "cpu":
        return torch.linalg.solve_ex(Mr, b[..., None])[0][..., 0]
    from scipy.linalg import blas, lapack
    out = np.empty(tuple(b.shape), np.float32)
    for i, (a, r) in enumerate(zip(Mr.numpy(), b.numpy())):
        lu, piv, _ = lapack.sgetrf(a)
        perm = np.arange(len(r))
        for k, pk in enumerate(piv):
            perm[[k, pk]] = perm[[pk, k]]
        x = blas.strsm(1.0, lu, r[perm][:, None], lower=1, diag=1)
        out[i] = blas.strsm(1.0, lu, x)[:, 0]
    return torch.from_numpy(out)


def fit_linear_leaves(X, leaf_idx, g, h, live, pf, n_leaf: int,
                      lam_lin: float, lam: float):
    """One hessian-weighted ridge model per leaf (LightGBM
    ``linear_tree``): every leaf's normal equations accumulate with one
    scatter-add of (D+1) x (D+1) outer products and solve together, on
    the tensors' device.

    Minimizes sum_i g_i (b . a_i) + h_i (b . a_i)^2 / 2 + lam_lin |w|^2 / 2
    + lam c^2 / 2 per leaf (a_i = [x_path, 1], b = [w, c]), the
    second-order boosting objective, so a leaf whose features carry no
    signal recovers the constant leaf value -G / (H + lam). The solve is
    :func:`_ridge_solve`. A degenerate
    leaf (fewer live rows than D + 2, or a non-finite solve) falls back
    to that constant.

    X (n, F) f32; leaf_idx (n,) int64; g, h, live (n,) f32; pf (n_leaf,
    D) int. Returns (beta (n_leaf, D+1), per-row contribution (n,))."""
    D = pf.shape[1]
    dev = X.device
    A = _leaf_design(X, leaf_idx, pf)                         # (n, D+1)
    # the sums: float64 on the card, where index_add_'s atomics add a
    # leaf's rows one at a time (in float32 a 350,000-row leaf's sums
    # drift by 1e-4 of their size); float32 in row order on CPU tensors,
    # the reference's segment_sum order
    acc = torch.float32 if dev.type == "cpu" else torch.float64
    M = torch.zeros((n_leaf, D + 1, D + 1), dtype=acc, device=dev).index_add_(
        0, leaf_idx, (A[:, :, None] * A[:, None, :]
                      * h[:, None, None]).to(acc)).float()
    v = torch.zeros((n_leaf, D + 1), dtype=acc, device=dev).index_add_(
        0, leaf_idx, (A * g[:, None]).to(acc)).float()
    cnt = torch.zeros(n_leaf, dtype=torch.float32, device=dev).index_add_(
        0, leaf_idx, live)
    reg = torch.diag(torch.cat([
        torch.full((D,), lam_lin + 1e-6, dtype=torch.float32, device=dev),
        torch.full((1,), lam, dtype=torch.float32, device=dev)]))
    beta = _ridge_solve(M + reg[None], -v)
    const = -v[:, D] / (M[:, D, D] + lam)      # bias only: the constant leaf
    const = torch.where(M[:, D, D] > 0, const, 0.0)
    bad = (cnt < D + 2) | ~torch.isfinite(beta).all(dim=1)
    fallback = torch.cat([torch.zeros((n_leaf, D), dtype=torch.float32,
                                      device=dev), const[:, None]], dim=1)
    beta = torch.where(bad[:, None], fallback, beta)
    contrib = _dot_rows(A, beta[leaf_idx])
    return beta, contrib


def predict_trees_linear(feats, thr_raw, coefs, pf, X, depth: int,
                         num_class: int = 1) -> torch.Tensor:
    """Sum of linear-tree outputs, trees added in order: each row descends
    as usual, then its leaf's linear model is evaluated on the path
    features. feats / thr_raw (T, 2^D-1); coefs (T, 2^D, D+1); pf (T,
    2^D, D); X (n, F) f32, all on one device. Returns (n,) f32, or (n,
    num_class) when ``num_class`` > 1, tree t adding into column
    t % num_class (trees are class-major within an iteration)."""
    n = X.shape[0]
    K = max(int(num_class), 1)
    out = torch.zeros((n, K), dtype=torch.float32, device=X.device)
    for t in range(feats.shape[0]):
        leaf = _descend(feats[t], thr_raw[t], X, depth)
        A = _leaf_design(X, leaf, pf[t])
        out[:, t % K] += _dot_rows(A, coefs[t][leaf])
    return out if K > 1 else out[:, 0]


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
