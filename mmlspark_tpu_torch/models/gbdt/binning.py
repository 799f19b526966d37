"""Feature binning for histogram GBDT (counterpart of
``models/gbdt/binning.py``; the port's own copy, on the host).

Continuous features are quantile-discretized into at most ``max_bin``
integer bins, so tree training runs on a dense uint8/uint16 matrix. Bin 0
is reserved for missing values (NaN). Bin upper bounds are stored so
fitted models split on raw thresholds and prediction never needs the
mapper. Sparse input (scipy CSR/CSC) bins column by column without
materializing the dense float matrix.

Bins are bitwise those of the JAX package: the same quantiles, the same
``searchsorted(bounds, x, "left") + 1``. The dense float transform runs
the port's native loop (``mmlspark_tpu_torch/native``, built with g++ at
first use; a failed build raises), as the JAX package's does; the numpy
loop :func:`bin_columns_plain` is its plain version. Both count their
calls on :func:`bin_columns` (``native_calls`` / ``plain_calls``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

try:                                    # scipy is in the image; guarded so a
    import scipy.sparse as _sp          # trimmed env degrades to dense-only
except Exception:                       # pragma: no cover
    _sp = None

from ... import native

__all__ = ["BinMapper", "MAX_BIN_DEFAULT", "is_sparse", "bin_columns",
           "bin_columns_plain"]

MAX_BIN_DEFAULT = 255


def is_sparse(X) -> bool:
    """True when X is a scipy sparse matrix (and scipy is available)."""
    return _sp is not None and _sp.issparse(X)


def bin_columns(X: np.ndarray, bounds: np.ndarray, lengths: np.ndarray,
                want_u16: bool) -> np.ndarray:
    """Quantile-bin a float32/float64 matrix in the native loop:
    ``searchsorted(bounds_j, x, "left") + 1`` per element with NaN -> bin
    0. ``bounds`` is the (F, L) padded table, ``lengths`` the per-feature
    bound counts. Counted in ``bin_columns.native_calls``."""
    bin_columns.native_calls += 1
    return native.bin_columns(X, bounds, lengths, want_u16)


def bin_columns_plain(X: np.ndarray, bounds: np.ndarray, lengths: np.ndarray,
                      want_u16: bool) -> np.ndarray:
    """The numpy loop that :func:`bin_columns` replaces, one
    ``searchsorted`` pass per column, bitwise the same bins. Counted in
    ``bin_columns.plain_calls``."""
    bin_columns.plain_calls += 1
    n, f = X.shape
    dtype = np.uint16 if want_u16 else np.uint8
    out = np.zeros((n, f), dtype=dtype)
    is_float = X.dtype.kind == "f"
    for j in range(f):
        col = X[:, j]
        binned = np.searchsorted(bounds[j, :lengths[j]], col,
                                 side="left") + 1
        if is_float:
            binned = np.where(np.isnan(col), 0, binned)
        out[:, j] = binned.astype(dtype)
    return out


#: calls of the native loop and of the numpy loop since the last reset
bin_columns.native_calls = 0
bin_columns.plain_calls = 0


class BinMapper:
    """Per-feature quantile binning. Fit on (a sample of) the data."""

    def __init__(self, max_bin: int = MAX_BIN_DEFAULT,
                 sample_cnt: int = 200_000, seed: int = 0):
        if not 2 <= max_bin <= 65535:
            raise ValueError(f"max_bin must be in [2, 65535], got {max_bin}")
        self.max_bin = int(max_bin)
        self.sample_cnt = sample_cnt
        self.seed = seed
        self.upper_bounds: List[np.ndarray] = []  # per feature, ascending
        self.n_features: Optional[int] = None
        self._table = None

    def fit(self, X) -> "BinMapper":
        sparse = is_sparse(X)
        if not sparse:
            X = np.asarray(X)
        n, f = X.shape
        self.n_features = f
        self._table = None
        if n > self.sample_cnt:
            # sample row indices first so only the sample is copied / upcast
            rng = np.random.default_rng(self.seed)
            rows = np.sort(rng.choice(n, self.sample_cnt, replace=False))
            X = X.tocsr()[rows] if sparse else X[rows]
        if sparse:
            X = X.tocsc()
        else:
            X = np.asarray(X, dtype=np.float64)
        self.upper_bounds = []
        for j in range(f):
            if sparse:
                # implicit zeros are genuine 0.0 values in the quantiles
                col = np.zeros(X.shape[0], dtype=np.float64)
                lo, hi = X.indptr[j], X.indptr[j + 1]
                col[X.indices[lo:hi]] = X.data[lo:hi]
            else:
                col = X[:, j]
            col = col[~np.isnan(col)]
            if col.size == 0:
                self.upper_bounds.append(np.array([np.inf]))
                continue
            uniq = np.unique(col)
            if len(uniq) <= self.max_bin - 1:
                # exact: one bin per distinct value; bound = midpoint
                mids = (uniq[:-1] + uniq[1:]) / 2
                bounds = np.append(mids, np.inf)
            else:
                qs = np.quantile(col, np.linspace(0, 1, self.max_bin),
                                 method="linear")
                bounds = np.unique(qs[1:-1])
                bounds = np.append(bounds, np.inf)
            self.upper_bounds.append(bounds.astype(np.float64))
        return self

    @property
    def n_bins(self) -> int:
        """Max bins over features incl. the missing bin (index 0)."""
        return 1 + max((len(b) for b in self.upper_bounds), default=1)

    def transform(self, X) -> np.ndarray:
        """Bin a matrix. Dense float input goes through the native loop
        (f16 and longdouble upcast to f64 first, the widths it takes);
        integer input bins column by column. Sparse input bins only the
        stored values over each column's zero-value bin."""
        if is_sparse(X):
            return self._transform_sparse(X.tocsc())
        X = np.asarray(X)
        n, f = X.shape
        if f != self.n_features:
            raise ValueError(f"expected {self.n_features} features, got {f}")
        want_u16 = self.n_bins > 256
        if X.dtype.kind == "f":
            if X.dtype not in (np.float32, np.float64):
                X = X.astype(np.float64)
            table, lengths = self.bounds_table()
            return bin_columns(X, table, lengths, want_u16)
        dtype = np.uint16 if want_u16 else np.uint8
        out = np.zeros((n, f), dtype=dtype)
        for j in range(f):
            col = X[:, j]
            # bins 1..len(bounds); searchsorted gives 0-based interval index
            binned = np.searchsorted(self.upper_bounds[j], col, side="left") + 1
            out[:, j] = binned.astype(dtype)
        return out

    def _transform_sparse(self, X) -> np.ndarray:
        """CSC -> dense binned matrix; per-column scatter of binned nonzeros
        over the column's zero-value bin."""
        n, f = X.shape
        if f != self.n_features:
            raise ValueError(f"expected {self.n_features} features, got {f}")
        dtype = np.uint8 if self.n_bins <= 256 else np.uint16
        out = np.empty((n, f), dtype=dtype)
        is_float = X.data.dtype.kind == "f"
        for j in range(f):
            bounds = self.upper_bounds[j]
            zero_bin = np.searchsorted(bounds, 0.0, side="left") + 1
            out[:, j] = dtype(zero_bin)
            lo, hi = X.indptr[j], X.indptr[j + 1]
            vals = X.data[lo:hi]
            binned = np.searchsorted(bounds, vals, side="left") + 1
            if is_float:
                binned = np.where(np.isnan(vals), 0, binned)
            out[X.indices[lo:hi], j] = binned.astype(dtype)
        return out

    def fit_transform(self, X) -> np.ndarray:
        return self.fit(X).transform(X)

    def bounds_table(self):
        """Padded (n_features, max_len) bounds matrix + per-feature lengths,
        for vectorized bin -> threshold lookups (cached)."""
        if self._table is None:
            lengths = np.array([len(b) for b in self.upper_bounds],
                               dtype=np.int64)
            L = int(lengths.max()) if len(lengths) else 1
            table = np.full((max(1, len(self.upper_bounds)), L), np.inf)
            for j, b in enumerate(self.upper_bounds):
                table[j, :len(b)] = b
            self._table = (table, lengths)
        return self._table

    def bin_threshold_value(self, feature: int, bin_idx: int) -> float:
        """Raw-value threshold for "go left if x <= threshold" at this bin."""
        bounds = self.upper_bounds[feature]
        i = min(max(int(bin_idx) - 1, 0), len(bounds) - 1)
        return float(bounds[i])

    def to_dict(self) -> dict:
        return {"max_bin": self.max_bin,
                "upper_bounds": [b.tolist() for b in self.upper_bounds]}

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        bm = BinMapper(max_bin=d["max_bin"])
        bm.upper_bounds = [np.asarray(b) for b in d["upper_bounds"]]
        bm.n_features = len(bm.upper_bounds)
        return bm
