"""Append-only observation store for the autotuner.

One observation = one measured fact about the data plane: "model ``sig``
on placement ``p`` moved ``rows`` rows through bucket ``b`` under config
``(mini_batch_size, prefetch_depth, ladder)`` in ``seconds``, paying
``compiles`` compiles". :class:`~mmlspark_tpu_torch.models.runner.BatchRunner`
emits them at drain time; the TVM-style measured sweep emits them per
probe; :func:`import_bench_records` backfills them from historical
``BENCH_r0*.json`` records, so the cost model's training set is the
repo's own perf trajectory.

Storage is one JSONL file (``observations.jsonl``) under
``MMLSPARK_TPU_TUNING_DIR`` — append-only and crash-tolerant by
construction: a torn final line (process killed mid-write) is counted and
skipped on load, never propagated. With no directory configured the store
is in-memory only: same-process decisions still work, nothing persists.

The port's copy of ``mmlspark_tpu/tuning/observations.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

from ..observability import counter as _metric_counter
from ..observability import gauge as _metric_gauge

__all__ = ["TUNING_DIR_ENV", "Observation", "ObservationStore", "get_store",
           "set_store", "reset_store", "import_bench_records",
           "harvest_samples", "harvest_scorecard", "harvest_costs",
           "harvest_collectives"]

#: environment variable naming the persisted-observation directory (the
#: tuning analogue of ``MMLSPARK_TPU_COMPILE_CACHE_DIR``)
TUNING_DIR_ENV = "MMLSPARK_TPU_TUNING_DIR"

STORE_FILENAME = "observations.jsonl"

M_OBSERVATIONS = _metric_counter(
    "mmlspark_tuning_observations_total",
    "Autotuning observations recorded, by origin", ("source",))
M_CORRUPT_LINES = _metric_counter(
    "mmlspark_tuning_corrupt_lines_total",
    "Store lines skipped on load (torn writes, foreign garbage)")
M_STORE_ROWS = _metric_gauge(
    "mmlspark_tuning_store_rows",
    "Observations held by the process-global store (memory + disk)")

#: every observation row carries at least these keys
_REQUIRED = ("sig", "source")


class Observation(dict):
    """One measured sample (a dict with a validating constructor).

    Keys (``None`` where not applicable):

    * ``sig`` — model signature (content hash / import path);
    * ``placement`` — placement key string (chip, mesh, or ``default``);
    * ``source`` — ``runner`` (harvested from live traffic), ``probe``
      (measured sweep), or ``bench`` (imported bench record);
    * ``config`` — ``{"mini_batch_size", "prefetch_depth", "buckets"}``;
    * ``bucket`` / ``rows`` / ``batches`` — padded size, valid rows, and
      batch count of a per-bucket sample (``bucket=None`` for whole-run
      samples, which instead carry ``rows_per_sec``);
    * ``seconds`` / ``prep_seconds`` / ``compile_seconds`` / ``compiles``
      — where the time went;
    * ``t`` — unix timestamp.
    """

    def __init__(self, *, sig: str, source: str,
                 placement: str = "default",
                 config: Optional[dict] = None,
                 bucket: Optional[int] = None,
                 rows: int = 0, batches: int = 0,
                 seconds: float = 0.0, prep_seconds: float = 0.0,
                 compile_seconds: float = 0.0, compiles: int = 0,
                 rows_per_sec: Optional[float] = None,
                 t: Optional[float] = None):
        super().__init__(
            sig=str(sig), source=str(source), placement=str(placement),
            config=dict(config or {}),
            bucket=None if bucket is None else int(bucket),
            rows=int(rows), batches=int(batches),
            seconds=float(seconds), prep_seconds=float(prep_seconds),
            compile_seconds=float(compile_seconds), compiles=int(compiles),
            rows_per_sec=(None if rows_per_sec is None
                          else float(rows_per_sec)),
            t=float(t) if t is not None else time.time())


def _parse_line(line: str) -> Optional[dict]:
    line = line.strip()
    if not line:
        return None
    try:
        row = json.loads(line)
    except ValueError:
        raise
    if not isinstance(row, dict) or any(k not in row for k in _REQUIRED):
        raise ValueError("not an observation row")
    return row


class ObservationStore:
    """Append-only JSONL observation log with corrupt-line tolerance.

    ``path`` is a directory (the JSONL file lives inside it) or ``None``
    for a memory-only store. ``record`` appends one row (and one line,
    when persistent); ``rows`` filters by model signature / placement /
    source. Thread-safe: drains from concurrent partitions interleave at
    line granularity.
    """

    def __init__(self, path: Optional[str] = None):
        self.dir = path
        self._file = (os.path.join(path, STORE_FILENAME)
                      if path is not None else None)
        self._lock = threading.Lock()
        self._rows: List[dict] = []
        self.corrupt_lines = 0
        self._heal_newline = False
        if self._file is not None:
            os.makedirs(path, exist_ok=True)
            self._load()
        M_STORE_ROWS.set(len(self._rows))

    def _load(self) -> None:
        if not os.path.exists(self._file):
            return
        # a torn final line (no trailing newline) must not swallow the
        # next append — heal with a newline before the first write
        with open(self._file, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            if fh.tell() > 0:
                fh.seek(-1, os.SEEK_END)
                self._heal_newline = fh.read(1) != b"\n"
        with open(self._file, encoding="utf-8", errors="replace") as fh:
            for line in fh:
                try:
                    row = _parse_line(line)
                except ValueError:
                    # a torn tail or foreign garbage: count it, keep going
                    # — an append-only log must never be poisoned by one
                    # bad line
                    self.corrupt_lines += 1
                    M_CORRUPT_LINES.inc()
                    continue
                if row is not None:
                    self._rows.append(row)

    def record(self, obs: dict) -> None:
        if any(k not in obs for k in _REQUIRED):
            raise ValueError(f"observation missing one of {_REQUIRED}")
        row = dict(obs)
        with self._lock:
            self._rows.append(row)
            if self._file is not None:
                with open(self._file, "a", encoding="utf-8") as fh:
                    if self._heal_newline:
                        fh.write("\n")
                        self._heal_newline = False
                    fh.write(json.dumps(row, sort_keys=True) + "\n")
            M_STORE_ROWS.set(len(self._rows))
        M_OBSERVATIONS.inc(source=str(row.get("source", "unknown")))

    def record_many(self, observations: Iterable[dict]) -> int:
        n = 0
        for obs in observations:
            self.record(obs)
            n += 1
        return n

    def rows(self, sig: Optional[str] = None,
             placement: Optional[str] = None,
             source: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = list(self._rows)
        if sig is not None:
            out = [r for r in out if r.get("sig") == sig]
        if placement is not None:
            out = [r for r in out if r.get("placement") == placement]
        if source is not None:
            out = [r for r in out if r.get("source") == source]
        return out

    def signatures(self) -> List[str]:
        with self._lock:
            return sorted({r.get("sig") for r in self._rows})

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)


# -- the process-global store -------------------------------------------------

_store_lock = threading.Lock()
_store: Optional[ObservationStore] = None


def get_store() -> ObservationStore:
    """The process-global store, created on first use. Persistent when
    ``MMLSPARK_TPU_TUNING_DIR`` names a directory, memory-only otherwise
    (decisions still work within the process; nothing survives it)."""
    global _store
    with _store_lock:
        if _store is None:
            _store = ObservationStore(os.environ.get(TUNING_DIR_ENV) or None)
        return _store


def set_store(store: Optional[ObservationStore]) -> None:
    """Install a specific store (tests, embedding apps)."""
    global _store
    with _store_lock:
        _store = store


def reset_store() -> None:
    """Drop the global store so the next :func:`get_store` re-resolves the
    environment (test hook — mirrors ``observability.reset_all``)."""
    set_store(None)


# -- bench-record backfill ----------------------------------------------------

def _bench_observation(parsed: dict, source_file: str) -> Optional[dict]:
    """One whole-run observation from a bench JSON record (either the raw
    ``bench.py`` line or the driver wrapper holding it under ``parsed``)."""
    value = parsed.get("value")
    if not isinstance(value, (int, float)) or value <= 0:
        return None
    # headline bench config: BENCH_BATCH/BENCH_ROWS defaults unless the
    # record carries explicit fields (older records don't)
    cfg = {"mini_batch_size": int(parsed.get("batch", 512)),
           "prefetch_depth": int(parsed.get("prefetch_depth", 2)),
           "buckets": None}
    compile_s = 0.0
    compiles = 0
    stages = parsed.get("stage_counters") or {}
    if isinstance(stages.get("compile"), dict):
        compile_s = float(stages["compile"].get("seconds", 0.0))
        compiles = int(stages["compile"].get("calls", 0))
    return Observation(
        sig=str(parsed.get("metric", "bench")),
        source="bench",
        placement=str(parsed.get("device") or parsed.get("platform")
                      or "default"),
        config=cfg, rows_per_sec=float(value),
        compile_seconds=compile_s, compiles=compiles,
        t=os.path.getmtime(source_file)
        if os.path.exists(source_file) else None)


def _generation_observation(parsed: dict, source_file: str,
                            phase: str = "generation") -> Optional[dict]:
    """One observation from a bench record's ``generation`` phase (or the
    ``multichip_generation`` phase via ``phase=``).

    Carries ``paged_attn_impl`` (the attention implementation the engine
    decoded with — ``kernel`` or ``gather``) so the cost model can
    compare the two per signature across the trajectory, and
    ``mesh_shape`` (``"single"`` or ``"dp4xtp2"``-style) so a ladder
    learned on one chip topology is never transferred onto another."""
    gen = parsed.get(phase)
    if not isinstance(gen, dict):
        return None
    tps = gen.get("tok_per_sec")
    if not isinstance(tps, (int, float)) or tps <= 0:
        return None
    pa = gen.get("paged_attn") if isinstance(gen.get("paged_attn"),
                                             dict) else {}
    mesh = str(gen.get("mesh_shape") or "single")
    obs = Observation(
        sig="generation",
        source="bench",
        placement=str(parsed.get("device") or parsed.get("platform")
                      or "default"),
        config={"paged_attn_impl": pa.get("impl"),
                "kv_dtype": pa.get("kv_dtype"),
                "mesh_shape": mesh,
                "mini_batch_size": None, "prefetch_depth": None,
                "buckets": None},
        rows=int(gen.get("tokens", 0)),
        seconds=float(gen.get("wall_s", 0.0)),
        rows_per_sec=float(tps),
        t=os.path.getmtime(source_file)
        if os.path.exists(source_file) else None)
    # top-level for cheap grouping without digging into config
    obs["paged_attn_impl"] = pa.get("impl")
    obs["kv_dtype"] = pa.get("kv_dtype")
    obs["mesh_shape"] = mesh
    return obs


def import_bench_records(paths: Sequence[str],
                         store: Optional[ObservationStore] = None) -> int:
    """Backfill the store from ``BENCH_r0*.json`` records.

    Accepts both formats on disk: the driver wrapper
    (``{"rc", "tail", "parsed": {...}}``) and a raw ``bench.py`` record.
    Records without a positive headline value (crashed/truncated rounds)
    are skipped. Returns the number of observations imported; importing
    the same file twice appends twice — callers dedupe by wiping the
    store dir or importing once at bootstrap.
    """
    store = store if store is not None else get_store()
    n = 0
    for path in paths:
        try:
            with open(path, encoding="utf-8") as fh:
                raw = json.load(fh)
        except (OSError, ValueError):
            continue
        parsed = raw.get("parsed") if isinstance(raw.get("parsed"), dict) \
            else (raw if "value" in raw else None)
        if not parsed:
            continue
        obs = _bench_observation(parsed, path)
        if obs is not None:
            store.record(obs)
            n += 1
        for phase in ("generation", "multichip_generation"):
            gen = _generation_observation(parsed, path, phase=phase)
            if gen is not None:
                store.record(gen)
                n += 1
    return n


def harvest_samples(sig: str, placement: str, config: Dict,
                    samples: Iterable[dict],
                    store: Optional[ObservationStore] = None,
                    source: str = "runner") -> int:
    """Turn :class:`BatchRunner` per-bucket samples into store rows.

    ``samples`` is the runner's drain-time summary: one dict per bucket
    with ``bucket/rows/batches/seconds/prep_seconds/compile_seconds/
    compiles``. Shared by the live harvest and the measured sweep."""
    store = store if store is not None else get_store()
    n = 0
    for s in samples:
        store.record(Observation(
            sig=sig, source=source, placement=placement, config=config,
            bucket=s.get("bucket"), rows=s.get("rows", 0),
            batches=s.get("batches", 0), seconds=s.get("seconds", 0.0),
            prep_seconds=s.get("prep_seconds", 0.0),
            compile_seconds=s.get("compile_seconds", 0.0),
            compiles=s.get("compiles", 0),
            rows_per_sec=s.get("rows_per_sec")))
        n += 1
    return n


def harvest_scorecard(scorecard: dict,
                      store: Optional[ObservationStore] = None,
                      placement: str = "default") -> int:
    """Land an SLO scorecard (``observability.slo.SloTracker.scorecard``)
    in the store as one ``source="slo_scorecard"`` row per workload class.

    The cost model reads the same store, so quality facts (p99 under
    load, availability, burn rate) sit next to throughput facts and a
    config that wins on rows/sec but blows the latency objective can be
    penalised from data, not intuition. ``rows`` carries the class's
    cumulative request count and ``rows_per_sec`` its windowed request
    rate; the quality numbers ride under the extra ``slo`` key (the store
    accepts any JSON-safe extras beyond the required schema)."""
    store = store if store is not None else get_store()
    n = 0
    for cls in scorecard.get("classes", []):
        win = cls.get("window") or {}
        sig = "slo:{}/{}/{}".format(cls.get("transport", "?"),
                                    cls.get("route", "?"),
                                    cls.get("model", "?"))
        tenant = str(cls.get("tenant", "default"))
        if tenant != "default":
            # non-default tenants get their own sig; the default rides the
            # historical 3-part form so trajectories stay joinable
            sig += "@" + tenant
        obs = Observation(
            sig=sig,
            source="slo_scorecard", placement=placement,
            rows=int(cls.get("total", 0)),
            seconds=float(scorecard.get("window_seconds", 0.0)),
            rows_per_sec=win.get("rps"),
            t=scorecard.get("t"))
        obs["tenant"] = tenant
        # registry-resolved classes carry "name@version"; split so rows
        # are queryable by version and the cost model can tell a canary's
        # trajectory from its incumbent's
        model = str(cls.get("model", "?"))
        obs["model"] = model.partition("@")[0]
        obs["model_version"] = model.partition("@")[2] or None
        obs["slo"] = {
            "p50": cls.get("p50"), "p99": cls.get("p99"),
            "p999": cls.get("p999"),
            "availability": cls.get("availability"),
            "error_budget_burn": cls.get("error_budget_burn"),
            "errors_total": cls.get("errors_total"),
            "shed_total": cls.get("shed_total"),
            "p99_ok": cls.get("p99_ok"),
            "availability_ok": cls.get("availability_ok"),
        }
        store.record(obs)
        n += 1
    return n


def harvest_costs(snapshot: dict,
                  store: Optional[ObservationStore] = None,
                  placement: str = "default") -> int:
    """Land a cost-ledger snapshot (``observability.ledger.CostLedger.
    snapshot``) in the store as one ``source="cost_ledger"`` row per
    workload class.

    The cost model reads the same store, so attributed cost truth
    (device-seconds, transfer bytes, KV page-holds per class) sits next
    to throughput and SLO facts. ``rows`` carries the class's cumulative
    charge count and ``seconds`` its attributed device-seconds; the full
    per-resource breakdown rides under the extra ``cost`` key."""
    store = store if store is not None else get_store()
    n = 0
    for cls in snapshot.get("classes", []):
        res = cls.get("resources") or {}
        sig = "cost:{}/{}/{}".format(cls.get("transport", "?"),
                                     cls.get("route", "?"),
                                     cls.get("model", "?"))
        tenant = str(cls.get("tenant", "default"))
        if tenant != "default":
            sig += "@" + tenant
        obs = Observation(
            sig=sig, source="cost_ledger", placement=placement,
            rows=int(cls.get("charges", 0)),
            seconds=float(res.get("device_seconds", 0.0)),
            compile_seconds=float(res.get("compile_seconds", 0.0)),
            t=snapshot.get("t"))
        obs["tenant"] = tenant
        model = str(cls.get("model", "?"))
        obs["model"] = model.partition("@")[0]
        obs["model_version"] = model.partition("@")[2] or None
        obs["cost"] = dict(res)
        obs["weighted_cost"] = cls.get("weighted_cost")
        store.record(obs)
        n += 1
    return n


def harvest_collectives(table: dict,
                        store: Optional[ObservationStore] = None,
                        placement: str = "default") -> int:
    """Land a collective-audit table (``parallel.collective_audit.
    CollectiveAuditor.table``) in the store as one
    ``source="collective_audit"`` row per audited program.

    The cost model's ``collective_ms_per_tick_est`` so far extrapolated
    from mesh shape alone; these rows give it a *measured* per-program
    op-count basis — compiled-HLO truth, not topology arithmetic.
    ``rows`` carries the number of audited argument signatures; the
    per-kind ops/bytes breakdown rides under the extra ``collectives``
    key with ``ops_total``/``bytes_total`` roll-ups beside it."""
    store = store if store is not None else get_store()
    n = 0
    for prog in sorted(table):
        row = table[prog]
        kinds = {k: dict(v) for k, v in (row.get("kinds") or {}).items()}
        obs = Observation(sig="collective:" + prog,
                          source="collective_audit", placement=placement,
                          rows=int(row.get("sigs", 0)))
        obs["prog"] = prog
        obs["collectives"] = kinds
        obs["ops_total"] = sum(v.get("ops", 0) for v in kinds.values())
        obs["bytes_total"] = sum(v.get("bytes", 0)
                                 for v in kinds.values())
        store.record(obs)
        n += 1
    return n
