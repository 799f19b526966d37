"""Path-dependent TreeSHAP (Lundberg & Lee) on the samples' device,
batched over trees and leaves (counterpart of ``models/gbdt/treeshap.py``).

The reference recursion walks a tree's nodes carrying the "unique path"
m = [(feature, zero_fraction, one_fraction, weight), ...]: EXTEND at each
split, UNWIND when a split repeats a feature higher on the path (its
element leaves and comes back with the fractions multiplied), and at each
leaf the unwound sums give every path element's contribution. Its cost is
O(nodes * depth^2) small vector ops a tree, each a kernel launch on the
card: about 2,400 launches a depth-5 tree.

Here the recursion runs on the host over the sample-independent state
only: for every leaf (or stub) it reaches, the distinct features on its
path, each with its zero fraction (the product of the cover ratios of
the splits on that feature, in path order, as the reference forms it) and
the splits whose branch indicators multiply into its one fraction. The
one fractions, the weights and phi are float64 tensors on the device, and
all the leaves of a group of trees go through EXTEND and the unwound sums
together, each path padded to the group's longest with null elements
(zero and one fraction 1). A null element is a feature the leaf's value
does not depend on, so it moves no other element's Shapley value (the
reference's own root element is one), and its contribution, (o - z) = 0,
is exactly zero. The weights of a path are symmetric in its elements, so
extending the final elements directly gives the reference's weights; the
two agree to float64 rounding, not bitwise.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["tree_paths", "node_values", "shap_trees"]

_F64 = torch.float64


def tree_paths(feats: np.ndarray, cover: np.ndarray, depth: int
               ) -> List[Tuple[int, list]]:
    """The nodes the reference's recursion ends at (leaves, and stubs with
    feat < 0), in its order, each with its path's distinct elements in
    the reference's order: [(feature, zero fraction, [(split node,
    went left), ...]), ...]. A split of cover <= 0 ends its subtree with
    no contribution, as in the reference."""
    n_int = 2 ** depth - 1
    cover = np.asarray(cover, np.float64)
    out: List[Tuple[int, list]] = []

    def walk(node, elems):
        if node >= n_int or feats[node] < 0:
            out.append((node, elems))
            return
        c_node = cover[node]
        if c_node <= 0:
            return
        f = int(feats[node])
        prev = next((e for e in elems if e[0] == f), None)
        rest = [e for e in elems if e[0] != f]
        iz, conds = (prev[1], prev[2]) if prev is not None else (1.0, [])
        for child, left in ((2 * node + 1, True), (2 * node + 2, False)):
            walk(child, rest + [(f, float(iz * cover[child] / c_node),
                                 conds + [(node, left)])])

    walk(0, [])
    return out


def node_values(leaf_value: np.ndarray, cover: np.ndarray,
                depth: int) -> np.ndarray:
    """Cover-weighted mean value of every node (heap order), float64."""
    n_int = 2 ** depth - 1
    cover = np.asarray(cover, np.float64)
    val = np.zeros(2 ** (depth + 1) - 1)
    val[n_int:] = leaf_value
    for i in range(n_int - 1, -1, -1):
        cl, cr = cover[2 * i + 1], cover[2 * i + 2]
        tot = cl + cr
        val[i] = ((cl * val[2 * i + 1] + cr * val[2 * i + 2]) / tot
                  if tot > 0 else val[2 * i + 1])
    return val


def _to(device, a, dtype):
    """A host table on the device, copied from pinned memory on CUDA
    without waiting for the device."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _group(jobs, feats, thr, depth, F, device):
    """One group of (tree, class, node values, paths) jobs as device
    tables: every path end's padded elements (their phi columns, zero
    fractions, the branch indicators of their one fractions) and value.
    None when no path has an element."""
    n_int = 2 ** depth - 1
    ends = [(i, k, float(vals[node]), elems)
            for i, (t, k, vals, paths) in enumerate(jobs)
            for node, elems in paths]
    P = max([len(e[3]) for e in ends] + [0])
    if P == 0:
        return None
    B = len(ends)
    ones_col = 2 * len(jobs) * n_int             # the all-ones indicator
    col = np.zeros((B, P), np.int64)
    z = np.ones((B, P), np.float64)
    v = np.zeros(B, np.float64)
    cond = np.full((B, P, depth), ones_col, np.int64)
    for b, (i, k, val, elems) in enumerate(ends):
        v[b] = val
        col[b] = k * (F + 1)                     # padding adds exact zeros
        for p, (f, zf, conds) in enumerate(elems):
            col[b, p] = k * (F + 1) + f
            z[b, p] = zf
            for d, (node, left) in enumerate(conds):
                cond[b, p, d] = 2 * (i * n_int + node) + (0 if left else 1)
    split_feat = np.stack([feats[t] for t, *_ in jobs]).reshape(-1)
    split_thr = np.stack([thr[t] for t, *_ in jobs]).reshape(-1)
    return dict(
        P=P, B=B,
        split_feat=_to(device, np.clip(split_feat, 0, None), torch.int64),
        split_thr=_to(device, split_thr, torch.float32),
        col=_to(device, col.reshape(-1), torch.int64),
        z=_to(device, z, _F64),
        z_safe=_to(device, np.where(z != 0, z, 1.0), _F64),
        z_nonzero=_to(device, z != 0, torch.bool),
        v=_to(device, v, _F64),
        cond=_to(device, cond.reshape(-1), torch.int64))


def _group_phi(X, g, phi2):
    """Add one group's contributions for the rows X (n, F) into phi2 (n,
    K * (F + 1)), a view of those rows."""
    n = X.shape[0]
    B, P = g["B"], g["P"]
    dev = X.device
    xs = X.index_select(1, g["split_feat"])                  # (n, splits)
    left = (xs <= g["split_thr"]) | torch.isnan(xs)
    ind = torch.cat([torch.stack([left, ~left], dim=2).reshape(n, -1),
                     torch.ones((n, 1), dtype=torch.bool, device=dev)],
                    dim=1)
    o = ind.index_select(1, g["cond"]).reshape(n, B, P, -1).all(dim=3) \
        .to(_F64)                                            # (n, B, P)
    z = g["z"]                                               # (B, P)
    # EXTEND: the root's null element (w = [1]), then the P elements:
    # new[j] = z * w[j] * (l - j) / (l + 1) + o * w[j - 1] * j / (l + 1)
    w = torch.ones((n, B, 1), dtype=_F64, device=dev)
    for e in range(P):
        l = w.shape[2]
        ar = torch.arange(l, dtype=_F64, device=dev)
        keep = z[:, e:e + 1] * w * (l - ar) / (l + 1)        # j = 0 .. l-1
        up = o[:, :, e:e + 1] * w * (ar + 1) / (l + 1)       # j = 1 .. l
        w = torch.cat([keep[..., :1], keep[..., 1:] + up[..., :-1],
                       up[..., -1:]], dim=2)
    # the unwound sums of every element at once (the reference's
    # recurrence over subset sizes); o is 0 or 1, so its o-divisor is 1
    # wherever the o != 0 branch is taken
    l = P
    total_one = total_zero = 0.0
    nxt = w[..., l:l + 1]
    for j in range(l - 1, -1, -1):
        t = nxt * (l + 1) / (j + 1)
        total_one = total_one + t
        nxt = w[..., j:j + 1] - t * z * (l - j) / (l + 1)
        total_zero = total_zero + w[..., j:j + 1] * (l + 1) / (
            g["z_safe"] * (l - j))
    total_zero = torch.where(g["z_nonzero"], total_zero, 0.0)
    s = torch.where(o != 0, total_one, total_zero)
    contrib = s * (o - z) * g["v"][:, None]
    phi2.index_add_(1, g["col"], contrib.reshape(n, B * P))


def shap_trees(feats, thr, leaf_values, covers, depth: int, num_class: int,
               base_score: float, X: torch.Tensor,
               budget: int = 1 << 25) -> torch.Tensor:
    """TreeSHAP of a booster's trees for the rows X (n, F) float32 on the
    device: (K, n, F + 1) float64 there (K = 1 for a single-output
    model), the expected value plus ``base_score`` in the last column.

    Trees (for multiclass, each class row with a nonzero leaf) go in
    groups whose (rows, path ends, path elements) tensors stay near
    ``budget`` elements; rows are split too when one tree exceeds it."""
    n, F = X.shape
    K = max(num_class, 1)
    dev = X.device
    jobs = []
    expected = [0.0] * K
    for t in range(len(feats)):
        paths = tree_paths(feats[t], covers[t], depth)
        for k in range(K):
            lv = leaf_values[t][k] if num_class > 1 else leaf_values[t]
            if num_class > 1 and not np.any(lv):
                # a class row this tree does not score: its terms are all
                # exact zeros
                continue
            vals = node_values(lv, covers[t], depth)
            # the reference adds each tree's root value in this order
            expected[k] += float(vals[0])
            jobs.append((t, k, vals, paths))
    phi2 = torch.zeros((n, K * (F + 1)), dtype=_F64, device=dev)
    per_tree = 2 ** depth * depth
    per_group = max(1, budget // (per_tree * max(n, 1)))
    rows = max(n, 1) if per_group > 1 else max(1, budget // per_tree)
    for lo in range(0, len(jobs), per_group):
        g = _group(jobs[lo:lo + per_group], feats, thr, depth, F, dev)
        if g is None:
            continue
        for r in range(0, n, rows):
            _group_phi(X[r:r + rows], g, phi2[r:r + rows])
    phi = phi2.reshape(n, K, F + 1).permute(1, 0, 2).contiguous()
    phi[:, :, F] = _to(dev, np.array([e + base_score for e in expected]),
                       _F64)[:, None]
    return phi
