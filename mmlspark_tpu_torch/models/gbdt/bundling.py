"""Exclusive Feature Bundling (EFB) for sparse input (counterpart of
``models/gbdt/bundling.py``; the port's own copy, host numpy).

Features that are (almost) never non-default together share one
histogram column, so a level's histogram reads n x n_bundles bins
instead of n x F:

* **encode**: every feature belongs to exactly one bundle; member ``f``
  owns the slots ``[offset_f, offset_f + width_f)`` of its bundle's bin
  space, a row stores bundle bin ``offset_f + bin_f`` where ``f`` is
  non-default, and a row with every member at its default stores bundle
  bin 0. The (n, n_bundles) uint8/uint16 matrix is the only per-row
  artifact; on the card K6 reads it with ``n_bins = n_bundle_bins``.
* **debundle** (``trees._debundle``): each feature's histogram is a
  gather of its slots, its default bin the node total less its other
  bins, so the split search, the masks and the thresholds speak original
  features.
* **route** (``trees.build_tree``): a row's bin for the split feature is
  decoded from its bundle column.

With ``max_conflict_rate=0`` (the default, as LightGBM's) bundling is
lossless. A positive rate lets bundles collide on at most ``rate x n``
rows; a colliding row keeps the last member's value (its other members
read as default there), the EFB approximation.

Conflicts are counted on a sample of ``plan_sample_cnt`` rows drawn by
``np.random.default_rng(seed)``: the JAX package's draw, so both plan the
same bundles.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .binning import BinMapper, is_sparse

__all__ = ["FeatureBundler", "plan_bundles"]


def _csc_fingerprint(X) -> tuple:
    """Cheap identity check for reusing fit-time binning at transform time:
    shape + nnz + head/tail samples of the value and index buffers. Not a
    cryptographic guarantee — a collision needs a same-shape, same-nnz
    matrix agreeing on 64 sampled entries, at which point the caller is
    actively trying to be wrong."""
    d, i = X.data, X.indices
    return (X.shape, X.nnz,
            d[:32].tobytes(), d[-32:].tobytes(),
            i[:32].tobytes(), i[-32:].tobytes())


def plan_bundles(nondefault_rows: List[np.ndarray], n_rows: int,
                 widths: np.ndarray, max_conflict_rate: float = 0.0,
                 max_bundle_bins: int = 4096) -> List[List[int]]:
    """Greedy first-fit bundling (the EFB paper's graph-coloring heuristic).

    ``nondefault_rows[f]`` = sorted row indices where feature ``f`` is
    non-default; ``widths[f]`` = f's bin count. Features are visited in
    descending non-default count (densest first — they are hardest to
    place); a feature joins the first bundle where (a) added conflicts
    stay within the bundle's remaining budget and (b) the bin span stays
    under ``max_bundle_bins`` (a huge bundle would pad every bundle's
    histogram to its width — ragged-to-static cost).
    """
    F = len(nondefault_rows)
    budget = int(max_conflict_rate * n_rows)
    order = np.argsort([-len(r) for r in nondefault_rows], kind="stable")
    bundles: List[List[int]] = []
    occupied: List[np.ndarray] = []     # bool (n_rows,) per bundle
    remaining: List[int] = []
    span: List[int] = []
    for f in order:
        rows = nondefault_rows[f]
        placed = False
        for b in range(len(bundles)):
            if span[b] + int(widths[f]) > max_bundle_bins:
                continue
            conflicts = int(occupied[b][rows].sum()) if len(rows) else 0
            if conflicts <= remaining[b]:
                bundles[b].append(int(f))
                occupied[b][rows] = True
                remaining[b] -= conflicts
                span[b] += int(widths[f])
                placed = True
                break
        if not placed:
            bundles.append([int(f)])
            occ = np.zeros(n_rows, dtype=bool)
            occ[rows] = True
            occupied.append(occ)
            remaining.append(budget)
            span.append(1 + int(widths[f]))
    return bundles


class FeatureBundler:
    """Plans bundles from a fitted :class:`BinMapper` + sparse matrix and
    encodes the bundled bin matrix.

    Tables (all (F,) int32, consumed by ``trees.build_tree``):
      ``bundle_of`` — bundle index per original feature;
      ``offset_of`` — the feature's slot offset inside its bundle;
      ``width_of``  — the feature's bin count (bins land in
      ``[offset, offset + width)``);
      ``zero_bin``  — the feature's default (zero-value) bin.
    """

    def __init__(self, max_conflict_rate: float = 0.0,
                 max_bundle_bins: int = 4096,
                 plan_sample_cnt: int = 100_000, seed: int = 0):
        self.max_conflict_rate = float(max_conflict_rate)
        self.max_bundle_bins = int(max_bundle_bins)
        self.plan_sample_cnt = int(plan_sample_cnt)
        self.seed = seed
        self.bundles: List[List[int]] = []
        self.bundle_of: Optional[np.ndarray] = None
        self.offset_of: Optional[np.ndarray] = None
        self.width_of: Optional[np.ndarray] = None
        self.zero_bin: Optional[np.ndarray] = None
        self.n_bundle_bins: int = 0
        self._bin_cache = None          # (fingerprint, [(rows, bins)] per f)

    # -- planning ------------------------------------------------------------
    def fit(self, X, mapper: BinMapper) -> "FeatureBundler":
        if not is_sparse(X):
            raise ValueError("FeatureBundler.fit expects a scipy sparse "
                             "matrix (bundling is a sparse-data device)")
        X = X.tocsc()
        n, F = X.shape
        widths = np.array([1 + len(b) for b in mapper.upper_bounds],
                          dtype=np.int64)     # bins incl. the missing bin 0
        self.zero_bin = np.array(
            [int(np.searchsorted(b, 0.0, side="left")) + 1
             for b in mapper.upper_bounds], dtype=np.int32)
        nondefault: List[np.ndarray] = []
        cache: List[tuple] = []
        for j in range(F):
            lo, hi = X.indptr[j], X.indptr[j + 1]
            vals = X.data[lo:hi]
            rows = X.indices[lo:hi]
            bins = np.searchsorted(mapper.upper_bounds[j], vals,
                                   side="left") + 1
            if vals.dtype.kind == "f":
                bins = np.where(np.isnan(vals), 0, bins)
            # stored values that bin into the zero bin ARE default
            keep = bins != self.zero_bin[j]
            nondefault.append(np.sort(rows[keep]))
            cache.append((rows[keep], bins[keep]))
        # binning every stored value is the expensive part of both fit and
        # transform — keep it for transform (same X → no recompute)
        self._bin_cache = (_csc_fingerprint(X), cache)
        # conflict counting runs on a bounded row sample: exact counting
        # keeps an O(n)-bool occupancy map per bundle, which at HIGGS-scale
        # n dwarfs the sparse data itself (LightGBM samples here too); a
        # sampled miss can bundle a pair conflicting slightly above budget
        # — the standard EFB approximation
        if n > self.plan_sample_cnt:
            rng = np.random.default_rng(self.seed)
            sample = np.sort(rng.choice(n, self.plan_sample_cnt,
                                        replace=False))
            plan_rows = []
            for r in nondefault:
                in_sample = r[np.isin(r, sample, assume_unique=True)]
                plan_rows.append(np.searchsorted(sample, in_sample))
            plan_n = self.plan_sample_cnt
        else:
            plan_rows, plan_n = nondefault, n
        self.bundles = plan_bundles(plan_rows, plan_n, widths,
                                    self.max_conflict_rate,
                                    self.max_bundle_bins)
        self.bundle_of = np.zeros(F, dtype=np.int32)
        self.offset_of = np.zeros(F, dtype=np.int32)
        self.width_of = widths.astype(np.int32)
        spans = []
        for b, members in enumerate(self.bundles):
            off = 1                       # slot 0 = the all-default bin
            for f in members:
                self.bundle_of[f] = b
                self.offset_of[f] = off
                off += int(widths[f])
            spans.append(off)
        self.n_bundle_bins = int(max(spans)) if spans else 1
        return self

    @property
    def n_bundles(self) -> int:
        return len(self.bundles)

    def worthwhile(self, F: int) -> bool:
        """Bundling pays when it actually shrinks the histogram work; a
        near-1:1 plan would only add the debundle gather."""
        return self.n_bundles <= max(1, int(0.75 * F))

    # -- encoding ------------------------------------------------------------
    def transform(self, X, mapper: BinMapper) -> np.ndarray:
        """Sparse matrix → (n, n_bundles) bundled bin matrix.

        Cost ∝ nnz: per column, binned non-default entries scatter into
        the member's slot range; conflict rows resolve last-member-wins
        (members are visited in bundle order, so the resolution is
        deterministic)."""
        if not is_sparse(X):
            raise ValueError("FeatureBundler.transform expects sparse input")
        X = X.tocsc()
        n, F = X.shape
        cached = (self._bin_cache[1]
                  if self._bin_cache is not None
                  and self._bin_cache[0] == _csc_fingerprint(X) else None)
        dtype = np.uint16 if self.n_bundle_bins > 256 else np.uint8
        out = np.zeros((n, self.n_bundles), dtype=dtype)
        for b, members in enumerate(self.bundles):
            for f in members:
                if cached is not None:
                    rows_nd, bins_nd = cached[f]
                else:
                    lo, hi = X.indptr[f], X.indptr[f + 1]
                    vals = X.data[lo:hi]
                    rows = X.indices[lo:hi]
                    bins = np.searchsorted(mapper.upper_bounds[f], vals,
                                           side="left") + 1
                    if vals.dtype.kind == "f":
                        bins = np.where(np.isnan(vals), 0, bins)
                    keep = bins != self.zero_bin[f]
                    rows_nd, bins_nd = rows[keep], bins[keep]
                out[rows_nd, b] = (self.offset_of[f]
                                   + bins_nd).astype(dtype)
        return out
