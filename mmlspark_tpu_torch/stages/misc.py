"""Pipeline utility transformers.

Parity surface: the ~20 utility stages under ``core/.../stages/`` in the
reference (``Cacher``, ``ClassBalancer:25``, ``DropColumns``,
``EnsembleByKey:20``, ``Explode``, ``Lambda:22``, ``MultiColumnAdapter:19``,
``PartitionConsolidator:21-137``, ``RenameColumn``, ``Repartition``,
``SelectColumns``, ``StratifiedRepartition:31``, ``SummarizeData:101``,
``TextPreprocessor:98``, ``Timer:55``, ``UDFTransformer:26``,
``UnicodeNormalize:22``). All are host-side column ops — cheap next to device
compute — so they stay vectorized numpy over the columnar DataFrame.

The port's copy of ``mmlspark_tpu/stages/misc.py`` (numpy only, host work).
"""

from __future__ import annotations

import time
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasInputCol, HasLabelCol, HasOutputCol, HasSeed, Param
from ..core.pipeline import Estimator, Model, Transformer

__all__ = [
    "Cacher", "DropColumns", "SelectColumns", "RenameColumn", "Repartition",
    "Explode", "Lambda", "UDFTransformer", "MultiColumnAdapter",
    "ClassBalancer", "ClassBalancerModel", "EnsembleByKey",
    "StratifiedRepartition", "SummarizeData", "TextPreprocessor",
    "UnicodeNormalize", "Timer", "TimerModel", "PartitionConsolidator",
]


class Cacher(Transformer):
    """Materialization hint (reference ``stages/Cacher.scala``). Our frames
    are already materialized columns, so this is the identity."""

    def _transform(self, df: DataFrame) -> DataFrame:
        return df.cache()


class DropColumns(Transformer):
    cols = Param((list, str), default=[], doc="columns to drop")

    def __init__(self, cols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if cols is not None:
            self.set(cols=list(cols))

    def _transform(self, df: DataFrame) -> DataFrame:
        return df.drop(*self.get("cols"))


class SelectColumns(Transformer):
    cols = Param((list, str), default=[], doc="columns to keep")

    def __init__(self, cols: Optional[Sequence[str]] = None, **kw):
        super().__init__(**kw)
        if cols is not None:
            self.set(cols=list(cols))

    def _transform(self, df: DataFrame) -> DataFrame:
        return df.select(self.get("cols"))


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    def _transform(self, df: DataFrame) -> DataFrame:
        return df.rename({self.get("input_col"): self.get("output_col")})


class Repartition(Transformer):
    n = Param(int, default=1, doc="target partition count")
    disable = Param(bool, default=False, doc="no-op switch")

    def _transform(self, df: DataFrame) -> DataFrame:
        if self.get("disable"):
            return df
        return df.repartition(self.get("n"))


class Explode(Transformer, HasInputCol, HasOutputCol):
    """One output row per element of a list-valued column
    (reference ``stages/Explode.scala``)."""

    def _transform(self, df: DataFrame) -> DataFrame:
        src = df[self.get("input_col")]
        counts = np.array([len(v) for v in src])
        idx = np.repeat(np.arange(len(df)), counts)
        out = df.take(idx)
        flat = np.empty(int(counts.sum()), dtype=object)
        k = 0
        for v in src:
            for item in v:
                flat[k] = item
                k += 1
        return out.with_column(self.get("output_col"), flat)


class Lambda(Transformer):
    """Arbitrary DataFrame→DataFrame function as a stage
    (reference ``stages/Lambda.scala:22``). The callable is transient for
    serialization — re-attach after load."""

    transform_fn = ComplexParam(default=None, doc="DataFrame -> DataFrame")

    def __init__(self, transform_fn: Optional[Callable] = None, **kw):
        super().__init__(**kw)
        if transform_fn is not None:
            self.set(transform_fn=transform_fn)

    def _transform(self, df: DataFrame) -> DataFrame:
        fn = self.get("transform_fn")
        if fn is None:
            raise ValueError("Lambda.transform_fn is not set (transient after load)")
        return fn(df)


class UDFTransformer(Transformer, HasInputCol, HasOutputCol):
    """Apply a per-row (or vectorized) function to one or more columns
    (reference ``stages/UDFTransformer.scala:26``)."""

    udf = ComplexParam(default=None, doc="row function; transient on save")
    input_cols = Param((list, str), default=[], doc="multi-input mode columns")
    vectorized = Param(bool, default=False,
                       doc="if true, udf receives whole column arrays")

    def __init__(self, udf: Optional[Callable] = None, **kw):
        super().__init__(**kw)
        if udf is not None:
            self.set(udf=udf)

    def _transform(self, df: DataFrame) -> DataFrame:
        fn = self.get("udf")
        if fn is None:
            raise ValueError("UDFTransformer.udf is not set (transient after load)")
        cols = self.get("input_cols") or [self.get("input_col")]
        arrays = [df[c] for c in cols]
        if self.get("vectorized"):
            result = fn(*arrays)
        else:
            result = np.empty(len(df), dtype=object)
            for i in range(len(df)):
                result[i] = fn(*(a[i] for a in arrays))
            # collapse to numeric when possible
            try:
                result = np.asarray([r for r in result])
            except Exception:
                pass
        return df.with_column(self.get("output_col"), result)


class MultiColumnAdapter(Transformer):
    """Run a single-column stage over many column pairs
    (reference ``stages/MultiColumnAdapter.scala:19``)."""

    base_stage = ComplexParam(default=None, doc="stage with input_col/output_col")
    input_cols = Param((list, str), default=[], doc="input columns")
    output_cols = Param((list, str), default=[], doc="output columns")

    def _transform(self, df: DataFrame) -> DataFrame:
        base = self.get("base_stage")
        ins, outs = self.get("input_cols"), self.get("output_cols")
        if len(ins) != len(outs):
            raise ValueError("input_cols and output_cols must align")
        cur = df
        for i, o in zip(ins, outs):
            stage = base.copy({"input_col": i, "output_col": o})
            cur = stage.transform(cur)
        return cur


class ClassBalancer(Estimator, HasInputCol, HasOutputCol):
    """Compute inverse-frequency weights per label value
    (reference ``stages/ClassBalancer.scala:25``)."""

    broadcast_join = Param(bool, default=True, doc="parity flag; unused here")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(input_col="label", output_col="weight")

    def _fit(self, df: DataFrame) -> "ClassBalancerModel":
        labels = df[self.get("input_col")]
        values, counts = np.unique(labels, return_counts=True)
        weights = counts.max() / counts.astype(np.float64)
        m = ClassBalancerModel()
        m.set(input_col=self.get("input_col"), output_col=self.get("output_col"),
              values=[v.item() if isinstance(v, np.generic) else v for v in values],
              weights=[float(w) for w in weights])
        return m


class ClassBalancerModel(Model, HasInputCol, HasOutputCol):
    values = Param(list, default=[], doc="distinct label values")
    weights = Param(list, default=[], doc="weight per label value")

    def _transform(self, df: DataFrame) -> DataFrame:
        table = dict(zip(self.get("values"), self.get("weights")))
        labels = df[self.get("input_col")]
        w = np.array([table[l.item() if isinstance(l, np.generic) else l]
                      for l in labels])
        return df.with_column(self.get("output_col"), w)


class EnsembleByKey(Transformer):
    """Group rows by key columns and average the value columns
    (reference ``stages/EnsembleByKey.scala:20``). Vector columns average
    elementwise."""

    keys = Param((list, str), default=[], doc="grouping key columns")
    cols = Param((list, str), default=[], doc="columns to average")
    col_names = Param((list, str), default=[], doc="output names (default mean(col))")
    collapse_group = Param(bool, default=True,
                           doc="one row per key if true, else broadcast back")
    strategy = Param(str, default="mean", choices=["mean"], doc="aggregation")

    def _transform(self, df: DataFrame) -> DataFrame:
        keys, cols = self.get("keys"), self.get("cols")
        names = self.get("col_names") or [f"mean({c})" for c in cols]
        key_rows = list(zip(*(df[k] for k in keys)))
        order: Dict = {}
        for i, kr in enumerate(key_rows):
            order.setdefault(kr, []).append(i)
        groups = list(order.items())
        agg: Dict[str, list] = {k: [] for k in keys}
        means: Dict[str, list] = {n: [] for n in names}
        for kr, idxs in groups:
            for k, kv in zip(keys, kr):
                agg[k].append(kv)
            for c, n in zip(cols, names):
                vals = df[c][idxs]
                if vals.dtype == object:
                    means[n].append(np.mean(np.stack([np.asarray(v) for v in vals]),
                                            axis=0))
                else:
                    means[n].append(float(np.mean(vals)))
        if self.get("collapse_group"):
            return DataFrame({**agg, **means})
        expanded: Dict[str, np.ndarray] = {}
        lookup = {kr: gi for gi, (kr, _) in enumerate(groups)}
        gidx = np.array([lookup[kr] for kr in key_rows])
        for n in names:
            col = means[n]
            if col and isinstance(col[0], np.ndarray):
                arr = np.empty(len(df), dtype=object)
                for i, g in enumerate(gidx):
                    arr[i] = col[g]
            else:
                arr = np.asarray(col)[gidx]
            expanded[n] = arr
        return df.with_columns(expanded)


class StratifiedRepartition(Transformer, HasLabelCol, HasSeed):
    """Reorder rows so every partition sees every label value
    (reference ``stages/StratifiedRepartition.scala:31``). With range
    partitions, round-robin interleaving by label achieves the equal-spread
    mode."""

    mode = Param(str, default="equal", choices=["equal", "original", "mixed"],
                 doc="spread strategy")

    def _transform(self, df: DataFrame) -> DataFrame:
        if self.get("mode") == "original":
            return df
        import collections
        labels = df[self.get("label_col")]
        rng = np.random.default_rng(self.get("seed"))
        queues = [collections.deque(rng.permutation(np.flatnonzero(labels == v)))
                  for v in np.unique(labels)]
        caps = [hi - lo for lo, hi in df.partition_bounds()]
        parts: List[List[int]] = [[] for _ in caps]
        # phase 1: one row of every label to every partition (while supplies
        # last) — the actual contract of the reference's equal mode
        for q in queues:
            for p in range(len(parts)):
                if q and len(parts[p]) < caps[p]:
                    parts[p].append(int(q.popleft()))
        # phase 2: fill remaining capacity cycling the label queues
        li = 0
        for p in range(len(parts)):
            while len(parts[p]) < caps[p]:
                for k in range(len(queues)):
                    q = queues[(li + k) % len(queues)]
                    if q:
                        parts[p].append(int(q.popleft()))
                        li = (li + k + 1) % len(queues)
                        break
        order = [i for part in parts for i in part]
        return df.take(np.array(order))


class SummarizeData(Transformer):
    """Per-column summary statistics table
    (reference ``stages/SummarizeData.scala:101``: counts/percentiles/basic)."""

    counts = Param(bool, default=True, doc="emit count/unique/missing")
    basic = Param(bool, default=True, doc="emit mean/std/min/max")
    percentiles = Param(bool, default=True, doc="emit p25/p50/p75")
    error_threshold = Param(float, default=0.0, doc="parity: percentile error")

    def _transform(self, df: DataFrame) -> DataFrame:
        rows = []
        for name in df.columns:
            col = df[name]
            row: Dict = {"feature": name}
            numeric = col.dtype != object and np.issubdtype(col.dtype, np.number)
            if self.get("counts"):
                row["count"] = len(col)
                if numeric:
                    row["unique_value_count"] = len(np.unique(col)) if len(col) else 0
                    row["missing_value_count"] = int(np.isnan(
                        col.astype(np.float64)).sum())
                else:
                    # object columns can hold None / unhashable values
                    # (e.g. feature vectors); key by bytes/repr in that case
                    seen = set()
                    for v in col:
                        if isinstance(v, np.ndarray):
                            seen.add(v.tobytes())
                        else:
                            try:
                                seen.add(v)
                            except TypeError:
                                seen.add(repr(v))
                    row["unique_value_count"] = len(seen)
                    row["missing_value_count"] = sum(v is None for v in col)
            if self.get("basic"):
                if numeric and len(col):
                    f = col.astype(np.float64)
                    row.update(mean=float(np.nanmean(f)), stddev=float(np.nanstd(f)),
                               min=float(np.nanmin(f)), max=float(np.nanmax(f)))
                else:
                    row.update(mean=np.nan, stddev=np.nan, min=np.nan, max=np.nan)
            if self.get("percentiles"):
                if numeric and len(col):
                    f = col.astype(np.float64)
                    p = np.nanpercentile(f, [25, 50, 75])
                    row.update(p25=float(p[0]), median=float(p[1]), p75=float(p[2]))
                else:
                    row.update(p25=np.nan, median=np.nan, p75=np.nan)
            rows.append(row)
        return DataFrame.from_rows(rows)


class _Trie:
    """Longest-match token replacement (reference ``TextPreprocessor``'s Trie,
    ``stages/TextPreprocessor.scala:98``)."""

    def __init__(self, mapping: Dict[str, str]):
        self.root: Dict = {}
        for k, v in mapping.items():
            node = self.root
            for ch in k:
                node = node.setdefault(ch, {})
            node["\0"] = v

    def translate(self, text: str) -> str:
        out, i, n = [], 0, len(text)
        while i < n:
            node, j, best, best_j = self.root, i, None, i
            while j < n and text[j] in node:
                node = node[text[j]]
                j += 1
                if "\0" in node:
                    best, best_j = node["\0"], j
            if best is not None:
                out.append(best)
                i = best_j
            else:
                out.append(text[i])
                i += 1
        return "".join(out)


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    map = Param(dict, default={}, doc="substring -> replacement map")
    normalize_func = Param(str, default=None,
                           doc="optional pre-normalization: lower|upper")

    def _transform(self, df: DataFrame) -> DataFrame:
        trie = _Trie(self.get("map"))
        norm = self.get("normalize_func")
        src = df[self.get("input_col")]
        out = np.empty(len(src), dtype=object)
        for i, text in enumerate(src):
            t = str(text)
            if norm == "lower":
                t = t.lower()
            elif norm == "upper":
                t = t.upper()
            out[i] = trie.translate(t)
        return df.with_column(self.get("output_col"), out)


class UnicodeNormalize(Transformer, HasInputCol, HasOutputCol):
    form = Param(str, default="NFKD", choices=["NFC", "NFD", "NFKC", "NFKD"],
                 doc="unicode normal form")
    lower = Param(bool, default=True, doc="lowercase after normalization")

    def _transform(self, df: DataFrame) -> DataFrame:
        src = df[self.get("input_col")]
        out = np.empty(len(src), dtype=object)
        for i, text in enumerate(src):
            t = unicodedata.normalize(self.get("form"), str(text))
            out[i] = t.lower() if self.get("lower") else t
        return df.with_column(self.get("output_col"), out)


class Timer(Estimator):
    """Wrap a stage and record its wall time
    (reference ``stages/Timer.scala:55``)."""

    stage = ComplexParam(default=None, doc="inner stage to time")
    log_to_scala = Param(bool, default=True, doc="parity flag; logs via python")
    disable_materialization = Param(bool, default=False, doc="parity flag")

    last_fit_seconds: Optional[float] = None

    def _fit(self, df: DataFrame) -> "TimerModel":
        inner = self.get("stage")
        # no synchronize: the ported learners hand back host arrays, so a
        # fit or transform on the card has synchronized before it returns
        t0 = time.perf_counter()
        if isinstance(inner, Estimator):
            fitted = inner.fit(df)
        else:
            fitted = inner
        self.last_fit_seconds = time.perf_counter() - t0
        m = TimerModel()
        m.set(stage=fitted)
        return m


class TimerModel(Model):
    stage = ComplexParam(default=None, doc="inner fitted transformer")

    last_transform_seconds: Optional[float] = None

    def _transform(self, df: DataFrame) -> DataFrame:
        t0 = time.perf_counter()
        out = self.get("stage").transform(df)
        self.last_transform_seconds = time.perf_counter() - t0
        return out


class PartitionConsolidator(Transformer, HasInputCol, HasOutputCol):
    """Funnel all partitions' rows into a single partition
    (reference ``stages/PartitionConsolidator.scala:21-137`` — used so
    rate-limited services see one worker per host). Row-range partitions make
    this a repartition-to-1."""

    concurrency = Param(int, default=1, doc="parity: downstream concurrency")
    concurrent_timeout = Param(float, default=None, doc="parity flag")

    def _transform(self, df: DataFrame) -> DataFrame:
        return df.repartition(1)
