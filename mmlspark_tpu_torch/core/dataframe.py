"""Columnar DataFrame — the host-side data plane of the framework (the
port's copy of ``mmlspark_tpu/core/dataframe.py``).

A thin partitioned wrapper over numpy arrays:

* dense numeric columns → ``np.ndarray`` (1-D, or n-D for tensor columns)
* strings / ragged / struct values → object arrays
* partitions are row-ranges, not separate allocations, so repartitioning is
  free and device feeds stay contiguous.

Transformers operate on whole columns (vectorized) or via
``map_partitions`` when they need per-partition device pinning.

Columns can also be **device-resident** (see :mod:`.residency`): a column
staged with :meth:`DataFrame.device_put` lives on device (as
``torch.Tensor`` chunks) across pipeline stages —
``filter``/``take``/``sort_values``/``repartition``/``head`` and partition
traversal all stay on device, so a Transformer chain pays one h2d at
ingest and one d2h at the sink. A device-born column (a stage output
attached via :meth:`DataFrame.with_device_column`) is represented on the
host side by a lazy :class:`~.residency.HostMirror`; touching its data
materializes it once, with the transfer counted in
``mmlspark_residency_*`` metrics.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

from ..observability.tracing import propagate as _propagate
from .residency import DeviceColumn, HostMirror, is_device_array, record_hit

__all__ = ["DataFrame", "concat", "object_col"]


# Shared partition-mapping pools, keyed by worker count. A serving loop calls
# `transform` per request batch, and a fresh ThreadPoolExecutor per call put
# thread spawn/teardown on every one of them — the pool now amortizes to
# zero per call. Keyed (not single) so an explicit `max_workers` bound still
# bounds concurrency; never shut down (Python's atexit hook joins the idle
# workers at interpreter exit).
_POOLS: Dict[int, "object"] = {}
_POOLS_LOCK = threading.Lock()
_IN_POOL = threading.local()


def _shared_pool(max_workers: int):
    from concurrent.futures import ThreadPoolExecutor
    with _POOLS_LOCK:
        ex = _POOLS.get(max_workers)
        if ex is None:
            ex = _POOLS[max_workers] = ThreadPoolExecutor(
                max_workers=max_workers,
                thread_name_prefix="mmlspark-partitions")
        return ex


def object_col(values) -> np.ndarray:
    """Build a 1-D object column without numpy coercing nested sequences."""
    values = list(values) if not isinstance(values, (list, np.ndarray)) else values
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _as_column(values) -> np.ndarray:
    if isinstance(values, np.ndarray):
        return values
    if isinstance(values, HostMirror):
        return values  # lazy device-born facade; never list() a tensor
    if hasattr(values, "to_numpy"):
        return values.to_numpy()
    values = list(values)
    if values and isinstance(values[0], (str, bytes, dict, list, tuple, np.ndarray)):
        arr = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            arr[i] = v
        return arr
    return np.asarray(values)


class DataFrame:
    """An immutable-ish columnar table with logical partitions."""

    def __init__(self, columns: Dict[str, Union[np.ndarray, Sequence]],
                 npartitions: int = 1, metadata: Optional[Dict[str, dict]] = None,
                 partition_sizes: Optional[Sequence[int]] = None,
                 device_columns: Optional[Dict[str, DeviceColumn]] = None):
        self._columns: Dict[str, np.ndarray] = {}
        self._metadata: Dict[str, dict] = dict(metadata or {})
        self._device: Dict[str, DeviceColumn] = {}
        device_columns = dict(device_columns or {})
        n = None
        for name, col in columns.items():
            if col is None and name in device_columns:
                self._columns[name] = None  # placeholder: mirror comes below
                continue
            if isinstance(col, DeviceColumn):
                device_columns.setdefault(name, col)
                self._columns[name] = None  # placeholder keeps column order
                continue
            if is_device_array(col):
                # a raw tensor is a device-born column, not host data —
                # never round-trip it through list()/np.asarray
                device_columns.setdefault(name, DeviceColumn.from_device([col]))
                self._columns[name] = None
                continue
            arr = _as_column(col)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"column {name!r} has {len(arr)} rows, expected {n}")
            self._columns[name] = arr
        for name, dcol in device_columns.items():
            if n is None:
                n = dcol.nrows
            elif dcol.nrows != n:
                raise ValueError(
                    f"device column {name!r} has {dcol.nrows} rows, "
                    f"expected {n}")
            self._device[name] = dcol
            host = self._columns.get(name)
            # keep a real host array (ingest-staged: host view is free) or an
            # existing mirror of this very column (preserves its cache);
            # otherwise install a fresh lazy mirror
            if not (isinstance(host, np.ndarray)
                    or (isinstance(host, HostMirror) and host.source is dcol)):
                self._columns[name] = HostMirror(dcol)
        self._nrows = n if n is not None else 0
        # explicit (possibly uneven) partition sizes — e.g. parquet row
        # groups — override the equal-range split
        self._partition_sizes: Optional[List[int]] = None
        if partition_sizes is not None:
            sizes = [int(s) for s in partition_sizes]
            if sum(sizes) != self._nrows or any(s < 0 for s in sizes):
                raise ValueError(
                    f"partition_sizes {sizes} do not sum to {self._nrows}")
            self._partition_sizes = sizes
            self._npartitions = max(1, len(sizes))
        else:
            self._npartitions = max(1, min(int(npartitions),
                                           max(1, self._nrows)))

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_pandas(pdf, npartitions: int = 1) -> "DataFrame":
        return DataFrame({c: pdf[c].to_numpy() for c in pdf.columns}, npartitions)

    @staticmethod
    def from_arrow(table, npartitions: int = 1) -> "DataFrame":
        import pyarrow as pa
        cols = {}
        for name in table.column_names:
            col = table.column(name)
            typ = col.type
            if pa.types.is_fixed_size_list(typ):
                # dense tensor columns round-trip as FixedSizeList; restore
                # the (N, k) block zero-copy (inverse of to_arrow)
                chunk = col.combine_chunks()
                flat = chunk.values.to_numpy(zero_copy_only=False)
                cols[name] = flat.reshape(len(chunk), typ.list_size)
                continue
            try:
                cols[name] = col.to_numpy(zero_copy_only=False)
            except Exception:
                cols[name] = _as_column(col.to_pylist())
        return DataFrame(cols, npartitions)

    @staticmethod
    def from_rows(rows: Iterable[dict], npartitions: int = 1) -> "DataFrame":
        rows = list(rows)
        if not rows:
            return DataFrame({}, npartitions)
        keys = list(rows[0].keys())
        return DataFrame({k: _as_column([r[k] for r in rows]) for k in keys},
                         npartitions)

    def to_pandas(self):
        import pandas as pd
        # object and n-D tensor columns become per-row lists of arrays;
        # self[k] materializes device-born columns (counted)
        cols = {k: self[k] for k in self._columns}
        return pd.DataFrame({k: list(v) if (v.dtype == object or v.ndim > 1)
                             else v for k, v in cols.items()})

    def to_arrow(self):
        """Columnar handoff to pyarrow.

        Dense 2-D tensor columns go zero-copy as FixedSizeList (restored to
        a dense block by :meth:`from_arrow`); object columns (ragged/None/
        higher-rank cells) fall back to per-row list values."""
        import pyarrow as pa

        arrays, names = [], []
        for name in self._columns:
            col = self[name]  # materializes device-born columns (counted)
            if col.dtype != object and col.ndim == 2:
                flat = pa.array(np.ascontiguousarray(col).reshape(-1))
                arrays.append(pa.FixedSizeListArray.from_arrays(
                    flat, col.shape[1]))
            elif col.dtype == object or col.ndim > 2:
                vals = [None if v is None
                        else (v.tolist() if isinstance(v, np.ndarray) else v)
                        for v in col]
                arrays.append(pa.array(vals))
            else:
                arrays.append(pa.array(col))
            names.append(name)
        return pa.table(dict(zip(names, arrays)))

    # -- basic properties ---------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    @property
    def npartitions(self) -> int:
        return self._npartitions

    def __len__(self) -> int:
        return self._nrows

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._columns:
            raise KeyError(f"no column {name!r}; have {self.columns}")
        col = self._columns[name]
        if isinstance(col, HostMirror):
            return col.materialize()  # counted d2h, once per mirror
        return col

    def column(self, name: str) -> np.ndarray:
        return self[name]

    # -- device residency ---------------------------------------------------
    def device_put(self, names: Optional[Sequence[str]] = None,
                   put=None) -> "DataFrame":
        """Stage columns on device (idempotent — already-resident columns
        count a residency *hit* and move no bytes; each newly staged column
        is one counted ``site="ingest"`` h2d + one *miss*).

        ``names=None`` stages every dense numeric column. ``put`` overrides
        the transfer (:func:`~.residency.make_put`; the default puts on
        the CUDA card).
        """
        if names is None:
            names = [k for k, v in self._columns.items()
                     if k in self._device
                     or getattr(v, "dtype", None) != np.dtype(object)]
        dev = dict(self._device)
        for n in names:
            if n in dev:
                record_hit()
                continue
            arr = self[n]
            dev[n] = DeviceColumn.from_host(arr, self.partition_bounds(),
                                            put=put)
        return DataFrame(self._columns, self._npartitions, self._metadata,
                         partition_sizes=self._partition_sizes,
                         device_columns=dev)

    def with_device_column(self, name: str, dcol) -> "DataFrame":
        """Attach a device-born column (a :class:`DeviceColumn` or a raw
        ``torch.Tensor``) without any transfer; the host side becomes a lazy
        mirror."""
        if not isinstance(dcol, DeviceColumn):
            dcol = DeviceColumn.from_device([dcol])
        cols = {k: v for k, v in self._columns.items() if k != name}
        cols[name] = HostMirror(dcol)
        dev = {k: v for k, v in self._device.items() if k != name}
        dev[name] = dcol
        return DataFrame(cols, self._npartitions, self._metadata,
                         partition_sizes=self._partition_sizes,
                         device_columns=dev)

    def device_column(self, name: str) -> DeviceColumn:
        if name not in self._device:
            raise KeyError(f"column {name!r} is not device-resident; "
                           f"resident: {self.resident_columns}")
        return self._device[name]

    def is_resident(self, name: str) -> bool:
        return name in self._device

    @property
    def resident_columns(self) -> List[str]:
        return list(self._device)

    def to_host(self, names: Optional[Sequence[str]] = None) -> "DataFrame":
        """The sink: drop device residency, materializing device-born
        columns in one counted ``site="sink"`` d2h each. Ingest-staged
        columns still hold their host array, so their exit is free."""
        names = list(self._device) if names is None else list(names)
        cols = dict(self._columns)
        dev = dict(self._device)
        for n in names:
            if n not in dev:
                continue
            dev.pop(n)
            host = cols.get(n)
            if isinstance(host, HostMirror):
                cols[n] = host.fetch(site="sink")
        return DataFrame(cols, self._npartitions, self._metadata,
                         partition_sizes=self._partition_sizes,
                         device_columns=dev)

    # -- column metadata (parity: Spark column Metadata / Categoricals) -----
    def column_metadata(self, name: str) -> dict:
        return dict(self._metadata.get(name, {}))

    def with_column_metadata(self, name: str, meta: dict) -> "DataFrame":
        md = dict(self._metadata)
        md[name] = {**md.get(name, {}), **meta}
        return DataFrame(self._columns, self._npartitions, md,
                         partition_sizes=self._partition_sizes,
                         device_columns=self._device)

    def _meta_for(self, names) -> Dict[str, dict]:
        return {k: v for k, v in self._metadata.items() if k in names}

    def schema(self) -> Dict[str, str]:
        out = {}
        for k, v in self._columns.items():
            if v.dtype == object and len(v):
                out[k] = type(v[0]).__name__
            else:
                out[k] = str(v.dtype)
        return out

    # -- transformations (all return new DataFrames) ------------------------
    def with_column(self, name: str, values) -> "DataFrame":
        if isinstance(values, DeviceColumn) or is_device_array(values):
            return self.with_device_column(name, values)
        cols = dict(self._columns)
        cols[name] = _as_column(values)  # host overwrite drops residency
        dev = {k: v for k, v in self._device.items() if k != name}
        return DataFrame(cols, self._npartitions, self._metadata,
                         partition_sizes=self._partition_sizes,
                         device_columns=dev)

    def with_columns(self, new: Dict[str, Union[np.ndarray, Sequence]]) -> "DataFrame":
        out = self
        for k, v in new.items():
            out = out.with_column(k, v)
        return out

    def select(self, names: Sequence[str]) -> "DataFrame":
        return DataFrame({n: self._columns[n] for n in names},
                         self._npartitions, self._meta_for(names),
                         partition_sizes=self._partition_sizes,
                         device_columns={n: self._device[n] for n in names
                                         if n in self._device})

    def drop(self, *names: str) -> "DataFrame":
        keep = [k for k in self._columns if k not in names]
        return DataFrame({k: self._columns[k] for k in keep}, self._npartitions,
                         self._meta_for(keep),
                         partition_sizes=self._partition_sizes,
                         device_columns={k: self._device[k] for k in keep
                                         if k in self._device})

    def rename(self, mapping: Dict[str, str]) -> "DataFrame":
        md = {mapping.get(k, k): v for k, v in self._metadata.items()}
        return DataFrame({mapping.get(k, k): v for k, v in self._columns.items()},
                         self._npartitions, md,
                         partition_sizes=self._partition_sizes,
                         device_columns={mapping.get(k, k): v
                                         for k, v in self._device.items()})

    def _gather(self, host_op, device_op, npartitions=None) -> "DataFrame":
        """Shared row-gather: resident columns gather on device (no
        round-trip), host columns on host."""
        cols, dev = {}, {}
        for k, v in self._columns.items():
            if k in self._device:
                dev[k] = device_op(self._device[k])
                cols[k] = None
            else:
                cols[k] = host_op(v)
        return DataFrame(cols, npartitions or self._npartitions,
                         self._metadata, device_columns=dev)

    def filter(self, mask: np.ndarray) -> "DataFrame":
        mask = np.asarray(mask)
        if mask.dtype != bool:
            raise TypeError("filter expects a boolean mask")
        return self._gather(lambda v: v[mask], lambda d: d.compress(mask))

    def take(self, indices) -> "DataFrame":
        idx = np.asarray(indices)
        return self._gather(lambda v: v[idx], lambda d: d.take(idx))

    def head(self, n: int) -> "DataFrame":
        return self._gather(lambda v: v[:n], lambda d: d.slice_rows(0, n),
                            npartitions=1)

    def repartition(self, npartitions: int) -> "DataFrame":
        # DeviceColumn chunking is alignment-agnostic: residency rides along
        return DataFrame(self._columns, npartitions, self._metadata,
                         device_columns=self._device)

    def sort_values(self, by: str, ascending: bool = True) -> "DataFrame":
        if by in self._device:
            # argsort on device: only the index vector crosses the bus,
            # never the key column's payload
            order = self._device[by].device_array().argsort(
                dim=-1, stable=True).cpu().numpy()
            if order.ndim > 1:  # tensor column: sort by first component
                order = order[:, 0]
        else:
            order = np.argsort(self[by], kind="stable")
        if not ascending:
            order = order[::-1]
        return self.take(order)

    def sample(self, frac: float, seed: int = 0, replace: bool = False) -> "DataFrame":
        rng = np.random.default_rng(seed)
        k = int(round(frac * self._nrows))
        idx = rng.choice(self._nrows, size=k, replace=replace)
        return self.take(idx)

    def shuffle(self, seed: int = 0) -> "DataFrame":
        rng = np.random.default_rng(seed)
        return self.take(rng.permutation(self._nrows))

    def cache(self) -> "DataFrame":
        return self  # materialized already; parity no-op (stages/Cacher)

    # -- partition machinery ------------------------------------------------
    def partition_bounds(self) -> List[tuple]:
        if self._partition_sizes is not None:
            bounds, start = [], 0
            for size in self._partition_sizes:
                bounds.append((start, start + size))
                start += size
            return bounds
        n, p = self._nrows, self._npartitions
        base, rem = divmod(n, p)
        bounds, start = [], 0
        for i in range(p):
            size = base + (1 if i < rem else 0)
            bounds.append((start, start + size))
            start += size
        return bounds

    def partitions(self) -> Iterator["DataFrame"]:
        for lo, hi in self.partition_bounds():
            cols, dev = {}, {}
            for k, v in self._columns.items():
                if k in self._device:
                    # slice on device; chunks covered exactly are shared, so
                    # per-partition views cost no transfer and no LRU churn
                    dev[k] = self._device[k].slice_rows(lo, hi)
                    cols[k] = None
                else:
                    cols[k] = v[lo:hi]
            yield DataFrame(cols, 1, self._metadata, device_columns=dev)

    def map_partitions(self, fn: Callable[["DataFrame", int], "DataFrame"],
                       max_workers: Optional[int] = None) -> "DataFrame":
        """Apply ``fn(part_df, part_index)`` to each partition and concat.

        The moral equivalent of Spark ``mapPartitions`` — the unit at which
        device pinning and batching happen. Partitions run **concurrently**
        on a thread pool (Spark runs one task per core the same way,
        ``ONNXModel.scala:499-508``): numpy and PyTorch release the GIL
        during heavy work and CUDA launches are asynchronous. Thread-local
        state (``torch.inference_mode``) must be entered inside ``fn``. Results preserve partition order;
        the first exception propagates. ``max_workers=1`` forces the
        sequential path; env ``MMLSPARK_TPU_PARTITION_THREADS`` overrides
        the default pool size. Pools are module-level and reused across
        calls (serving loops invoke ``transform`` per request batch, and a
        per-call executor made every one pay thread spawn/teardown); a
        ``map_partitions`` issued from inside a pool worker runs
        sequentially instead of queueing on its own pool, which could
        deadlock.
        """
        parts = list(self.partitions())
        if max_workers is None:
            max_workers = int(os.environ.get("MMLSPARK_TPU_PARTITION_THREADS", "0")) \
                or min(len(parts), 8)
        if len(parts) <= 1 or max_workers <= 1 \
                or getattr(_IN_POOL, "active", False):
            results = [fn(p, i) for i, p in enumerate(parts)]
        else:
            def wrapped(p, i):
                _IN_POOL.active = True
                try:
                    return fn(p, i)
                finally:
                    _IN_POOL.active = False
            ex = _shared_pool(max_workers)
            # pool threads start with an empty context: propagate() carries
            # the active trace and SpanTracer into each partition's call
            results = list(ex.map(_propagate(wrapped), parts,
                                  range(len(parts))))
        out = concat(results, npartitions=self._npartitions)
        # per-partition result sizes become the output boundaries, so uneven
        # splits (parquet row groups) survive a map_partitions round
        if len(results) > 1:
            out = DataFrame(dict(out._columns), metadata=out._metadata,
                            partition_sizes=[len(r) for r in results],
                            device_columns=out._device)
        return out

    # -- row view (for HTTP/serving paths that are row-oriented) ------------
    def iter_rows(self) -> Iterator[dict]:
        names = self.columns
        cols = [self._columns[n] for n in names]
        for i in range(self._nrows):
            yield {n: c[i] for n, c in zip(names, cols)}

    def to_rows(self) -> List[dict]:
        return list(self.iter_rows())

    def __repr__(self):
        return (f"DataFrame({self._nrows} rows x {len(self._columns)} cols, "
                f"{self._npartitions} partitions: {self.schema()})")


def concat(dfs: Sequence[DataFrame], npartitions: Optional[int] = None) -> DataFrame:
    dfs = [d for d in dfs if len(d.columns) > 0 or len(d) > 0]
    if not dfs:
        return DataFrame({})
    names = dfs[0].columns
    for d in dfs[1:]:
        if d.columns != names:
            raise ValueError(f"column mismatch in concat: {names} vs {d.columns}")
    cols, dev = {}, {}
    for n in names:
        if all(d.is_resident(n) for d in dfs):
            # resident everywhere: stitch the chunk lists, zero transfers
            dev[n] = DeviceColumn.concatenate([d._device[n] for d in dfs])
            hosts = [d._columns[n] for d in dfs]
            if all(isinstance(h, np.ndarray) for h in hosts):
                cols[n] = np.concatenate(hosts)  # host views are free
            else:
                cols[n] = None  # lazy mirror of the combined column
            continue
        # np.concatenate promotes mixed parts to object dtype on its own;
        # d[n] materializes any mirrors (counted) — concat off-device is a
        # genuine host exit for device-born parts
        cols[n] = np.concatenate([d[n] for d in dfs])
    md = {}
    for d in dfs:
        md.update(d._metadata)
    return DataFrame(cols, npartitions or dfs[0].npartitions, md,
                     device_columns=dev)
