"""VowpalWabbitFeaturizer / VowpalWabbitInteractions equivalents.

Parity surface: ``vw/.../VowpalWabbitFeaturizer.scala`` (+ the 11 typed
featurizers under ``vw/.../featurizer/*.scala``) and
``VowpalWabbitInteractions.scala``. Each input column is a *namespace*; its
values are hashed into a shared 2^num_bits index space:

* numeric scalar  → one feature: ``h(column)``, value = x (zeros skipped,
  as ``featurizer/NumericFeaturizer.scala`` does)
* bool            → feature ``h(column)`` with value 1.0 when true
* str             → feature ``h(column ␟ value)`` with value 1.0
  (``featurizer/StringFeaturizer.scala``)
* list/array of str → one feature per element
  (``featurizer/StringArrayFeaturizer.scala``)
* numeric ndarray → position-indexed features ``(ns_seed + i) & mask``
  (``featurizer/VectorFeaturizer.scala`` uses in-namespace indices)
* dict            → ``h(column ␟ key)`` → float(value)
  (``featurizer/MapFeaturizer.scala``)

The output column holds ``(indices uint32[nnz], values float32[nnz])`` per
row — the framework's sparse-vector convention for the VW learners, which
pad these to static ``[batch, max_nnz]`` device arrays.

The port's copy of ``mmlspark_tpu/vw/featurizer.py``: hashing is host
work in both packages (string columns in one native ``murmur3_batch``
call per column), so the indices are bitwise the JAX package's.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import HasInputCols, HasOutputCol, Param
from ..core.pipeline import Transformer
from .murmur import combine_hashes, namespace_seed

__all__ = ["VowpalWabbitFeaturizer", "VowpalWabbitInteractions",
           "NUM_BITS_KEY", "sparse_column", "max_nnz"]

#: column-metadata key carrying the hash-space size
NUM_BITS_KEY = "vw_num_bits"

_SEP = "\x1f"  # namespace/value separator fed to the hash


def sparse_column(rows: List) -> np.ndarray:
    out = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        out[i] = r
    return out


def max_nnz(col: np.ndarray) -> int:
    return max((len(r[0]) for r in col), default=0)


def _is_string_col(col: np.ndarray) -> bool:
    if col.dtype.kind == "U":
        return True
    if col.dtype == object:
        return all(v is None or isinstance(v, str) for v in col)
    return False


def _dedupe_sum(idx: np.ndarray, val: np.ndarray):
    """Sum values of colliding indices (``sumCollisions`` in the reference)."""
    if len(idx) < 2:
        return idx, val
    uniq, inv = np.unique(idx, return_inverse=True)
    if len(uniq) == len(idx):
        return idx, val
    summed = np.zeros(len(uniq), dtype=np.float32)
    np.add.at(summed, inv, val)
    return uniq.astype(np.uint32), summed


class VowpalWabbitFeaturizer(Transformer, HasInputCols, HasOutputCol):
    """Hash arbitrary columns into one sparse feature namespace column."""

    num_bits = Param(int, default=18, doc="log2 size of the hashed feature space")
    sum_collisions = Param(bool, default=True,
                           doc="sum values of colliding feature indices "
                               "(vs keep duplicates)")
    string_split_cols = Param((list, str), default=[],
                              doc="string columns to whitespace-split into "
                                  "multiple token features")
    seed = Param(int, default=0, doc="base murmur seed")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(output_col="features")

    def _featurize_value(self, v, col: str, ns_seed: int, mask: int,
                         split: bool, idx_out: list, val_out: list):
        from .murmur import murmur3_32
        if v is None:
            return
        if isinstance(v, (bool, np.bool_)):
            if v:
                idx_out.append(ns_seed & mask)
                val_out.append(1.0)
        elif isinstance(v, (int, float, np.integer, np.floating)):
            if v != 0:
                idx_out.append(ns_seed & mask)
                val_out.append(float(v))
        elif isinstance(v, str):
            tokens = v.split() if split else [v]
            for t in tokens:
                idx_out.append(
                    murmur3_32((col + _SEP + t).encode("utf-8"), ns_seed) & mask)
                val_out.append(1.0)
        elif isinstance(v, dict):
            for k, x in v.items():
                fx = float(x)
                if fx != 0:
                    idx_out.append(
                        murmur3_32((col + _SEP + str(k)).encode("utf-8"),
                                   ns_seed) & mask)
                    val_out.append(fx)
        elif isinstance(v, (list, tuple, np.ndarray)):
            arr = np.asarray(v)
            if arr.dtype.kind in "iuf":
                nz = np.nonzero(arr.ravel())[0]
                for i in nz:
                    idx_out.append((ns_seed + int(i)) & mask)
                    val_out.append(float(arr.ravel()[i]))
            else:
                for t in arr.ravel():
                    self._featurize_value(t, col, ns_seed, mask, split,
                                          idx_out, val_out)
        else:
            raise TypeError(f"cannot featurize {type(v).__name__} in column {col!r}")

    def _transform(self, df: DataFrame) -> DataFrame:
        cols = self.get("input_cols")
        if not cols:
            raise ValueError("input_cols must be set")
        bits = self.get("num_bits")
        mask = (1 << bits) - 1
        split_cols = set(self.get("string_split_cols"))
        seeds = {c: namespace_seed(c, self.get("seed")) for c in cols}
        n = len(df)
        idx_rows: list = [[] for _ in range(n)]
        val_rows: list = [[] for _ in range(n)]
        for c in cols:
            col = df[c]
            split = c in split_cols
            if _is_string_col(col):
                # column-major batch hash through the native fast path —
                # the host-side equivalent of VW's C++ example parser
                from ..native import murmur3_batch
                toks_per_row = [[] if v is None else
                                (v.split() if split else [v]) for v in col]
                flat = [(c + _SEP + t).encode("utf-8")
                        for toks in toks_per_row for t in toks]
                hashed = murmur3_batch(flat, seeds[c], mask)
                off = 0
                for r, toks in enumerate(toks_per_row):
                    k = len(toks)
                    if k:
                        idx_rows[r].append(hashed[off:off + k])
                        val_rows[r].append(np.ones(k, np.float32))
                    off += k
            else:
                for r in range(n):
                    io: list = []
                    vo: list = []
                    self._featurize_value(col[r], c, seeds[c], mask, split,
                                          io, vo)
                    if io:
                        idx_rows[r].append(np.asarray(io, dtype=np.uint32))
                        val_rows[r].append(np.asarray(vo, dtype=np.float32))
        rows = []
        for r in range(n):
            idx = (np.concatenate(idx_rows[r]).astype(np.uint32)
                   if idx_rows[r] else np.array([], dtype=np.uint32))
            val = (np.concatenate(val_rows[r])
                   if val_rows[r] else np.array([], dtype=np.float32))
            if self.get("sum_collisions"):
                idx, val = _dedupe_sum(idx, val)
            rows.append((idx, val))
        out = df.with_column(self.get("output_col"), sparse_column(rows))
        return out.with_column_metadata(self.get("output_col"),
                                        {NUM_BITS_KEY: bits})


class VowpalWabbitInteractions(Transformer, HasInputCols, HasOutputCol):
    """Cross N sparse namespaces into interaction features.

    Parity: ``VowpalWabbitInteractions.scala`` — the cartesian product of the
    listed namespaces, combined with VW's FNV multiply-xor hash, value =
    product of the crossed feature values.
    """

    num_bits = Param(int, default=18, doc="log2 size of the hashed feature space")
    sum_collisions = Param(bool, default=True,
                           doc="sum values of colliding interaction indices")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(output_col="interactions")

    def _transform(self, df: DataFrame) -> DataFrame:
        cols = self.get("input_cols")
        if len(cols) < 2:
            raise ValueError("interactions need >= 2 input namespaces")
        mask = (1 << self.get("num_bits")) - 1
        n = len(df)
        rows = []
        for r in range(n):
            idx, val = df[cols[0]][r]
            idx = np.asarray(idx, dtype=np.uint32)
            val = np.asarray(val, dtype=np.float32)
            for c in cols[1:]:
                i2, v2 = df[c][r]
                i2 = np.asarray(i2, dtype=np.uint32)
                v2 = np.asarray(v2, dtype=np.float32)
                # cartesian cross of the accumulated namespace with the next
                ia = np.repeat(idx, len(i2))
                ib = np.tile(i2, len(idx))
                idx = combine_hashes(ia, ib, mask)
                val = np.repeat(val, len(v2)) * np.tile(v2, len(val))
            if self.get("sum_collisions"):
                idx, val = _dedupe_sum(idx, val)
            rows.append((idx, val))
        out = df.with_column(self.get("output_col"), sparse_column(rows))
        return out.with_column_metadata(self.get("output_col"),
                                        {NUM_BITS_KEY: self.get("num_bits")})
