"""Fitted cost model + measured sweep: choose the data-plane config.

The model is deliberately small and stdlib-fitted (no solver deps): the
quantity that decides every knob is *seconds per dispatched batch as a
function of its padded size*, and the repo's own counters measure it
directly. Per observed bucket the store holds (rows, batches, seconds);
a least-squares line through ``(bucket, seconds/batch)`` gives

* ``alpha`` — the per-dispatch intercept (host sync + launch overhead:
  why fewer, larger batches win when the card is fast), and
* ``beta`` — the per-padded-row slope (compute + transfer: why padding a
  66-row batch to 128 costs real time — the pad-overhead term).

Add a per-valid-row host-prep rate (coerce+pad, overlappable by
``prefetch_depth``) and a per-compile cost (amortized over the warm-up
vocabulary a candidate ladder implies) and every candidate
``(bucket ladder, mini_batch_size, prefetch_depth)`` gets a predicted
wall-clock for a given row-size histogram — "A Learned Performance Model
for TPUs" (arXiv:2008.01040) scoped down to the three knobs this data
plane actually exposes.

Where the store is cold the model abstains and
:func:`measured_sweep` runs the TVM loop (arXiv:1802.04799) instead:
propose a bounded candidate set, run each through the *real*
:class:`~mmlspark_tpu_torch.models.runner.BatchRunner`, record every probe as
an observation — so the sweep both answers now and trains the model for
next time. Direct probe measurements of a config always outrank the
fitted prediction for that config.

The port's copy of ``mmlspark_tpu/tuning/cost_model.py``: Python float
arithmetic, so on the same observation store its decisions equal the JAX
package's exactly.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..observability import counter as _metric_counter
from ..observability import tracing as _tracing
from ..ops.padding import bucket_size
from .observations import ObservationStore, get_store

__all__ = ["CostModel", "TuningDecision", "candidate_configs",
           "compare_kv_dtype", "compare_paged_attn", "measured_sweep",
           "predecessor_signature", "probe_budget", "resolve_tuning",
           "PROBE_BUDGET_ENV"]

#: bounds the measured sweep: at most this many candidate configs are run
PROBE_BUDGET_ENV = "MMLSPARK_TPU_TUNING_PROBES"
DEFAULT_PROBE_BUDGET = 6

M_DECISIONS = _metric_counter(
    "mmlspark_tuning_decisions_total",
    "Tuning decisions issued, by how they were reached", ("source",))
M_PROBES = _metric_counter(
    "mmlspark_tuning_probes_total",
    "Measured-sweep probe runs executed through the runner")

#: default compile cost (seconds) assumed before any compile was observed
_DEFAULT_COMPILE_COST = 0.05


def probe_budget() -> int:
    try:
        return max(1, int(os.environ.get(PROBE_BUDGET_ENV,
                                         DEFAULT_PROBE_BUDGET)))
    except ValueError:
        return DEFAULT_PROBE_BUDGET


def _config_key(mini_batch_size: int, prefetch_depth: int,
                buckets: Optional[Sequence[int]]) -> tuple:
    return (int(mini_batch_size), int(prefetch_depth),
            None if buckets is None else tuple(int(b) for b in buckets))


def _batch_sizes(n: int, m: int) -> List[int]:
    """Valid-row sizes of the batches a run of ``n`` rows produces."""
    if n <= 0:
        return []
    full, tail = divmod(n, m)
    return [m] * full + ([tail] if tail else [])


class TuningDecision:
    """The chosen config plus the evidence trail behind it."""

    def __init__(self, *, mini_batch_size: int, prefetch_depth: int,
                 buckets: Optional[Tuple[int, ...]],
                 warm_up_sizes: Tuple[int, ...],
                 vocabulary: Tuple[int, ...],
                 predicted_seconds: float,
                 predicted_rows_per_sec: Optional[float],
                 source: str, details: Optional[dict] = None):
        self.mini_batch_size = int(mini_batch_size)
        self.prefetch_depth = int(prefetch_depth)
        self.buckets = None if buckets is None \
            else tuple(int(b) for b in buckets)
        #: the batch sizes warm-up should request (valid-row sizes)
        self.warm_up_sizes = tuple(int(s) for s in warm_up_sizes)
        #: the padded buckets those sizes land in — the compile vocabulary
        self.vocabulary = tuple(int(v) for v in vocabulary)
        self.predicted_seconds = float(predicted_seconds)
        self.predicted_rows_per_sec = (
            None if predicted_rows_per_sec is None
            else float(predicted_rows_per_sec))
        self.source = str(source)   # "model" | "probe" | "default"
        self.details = dict(details or {})

    def as_dict(self) -> dict:
        return {"mini_batch_size": self.mini_batch_size,
                "prefetch_depth": self.prefetch_depth,
                "buckets": (None if self.buckets is None
                            else list(self.buckets)),
                "warm_up_sizes": list(self.warm_up_sizes),
                "vocabulary": list(self.vocabulary),
                "predicted_seconds": round(self.predicted_seconds, 6),
                "predicted_rows_per_sec": (
                    None if self.predicted_rows_per_sec is None
                    else round(self.predicted_rows_per_sec, 2)),
                "source": self.source}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"TuningDecision(m={self.mini_batch_size}, "
                f"d={self.prefetch_depth}, buckets={self.buckets}, "
                f"source={self.source!r})")


def candidate_configs(histogram: Dict[int, int],
                      defaults: Tuple[int, int] = (64, 2),
                      depths: Sequence[int] = (0, 1, 2, 4),
                      ) -> List[Tuple[int, int, Optional[Tuple[int, ...]]]]:
    """The bounded candidate set ``[(mini_batch_size, depth, ladder)]``.

    Batch sizes: powers of two from 16 up to the largest run, the largest
    run itself (the no-split config), and the default. Ladders per batch
    size: ``None`` (power-of-two buckets) and the *exact* ladder — the
    sorted distinct batch sizes the config produces, i.e. zero padding.
    Deterministic order, so a fixed probe budget always sweeps the same
    prefix.
    """
    n_max = max((int(n) for n in histogram if int(n) > 0), default=64)
    sizes = {int(defaults[0]), n_max}
    m = 16
    while m < n_max:
        sizes.add(m)
        m <<= 1
    out: List[Tuple[int, int, Optional[Tuple[int, ...]]]] = []
    for size in sorted(sizes):
        produced = sorted({s for n, c in histogram.items() if c
                           for s in _batch_sizes(int(n), size)})
        exact = tuple(produced) if produced else None
        for depth in depths:
            out.append((size, int(depth), None))
            if exact is not None:
                out.append((size, int(depth), exact))
    return out


class CostModel:
    """Per-bucket linear throughput model fitted from store rows."""

    def __init__(self, *, alpha: float, beta: float, prep_rate: float,
                 compile_cost: float,
                 direct: Optional[Dict[tuple, float]] = None,
                 n_samples: int = 0):
        self.alpha = max(0.0, float(alpha))          # sec / dispatch
        self.beta = max(0.0, float(beta))            # sec / padded row
        self.prep_rate = max(0.0, float(prep_rate))  # sec / valid row
        self.compile_cost = max(0.0, float(compile_cost))
        #: config-key -> measured rows/sec (probe/bench rows): the ground
        #: truth that outranks the fit for configs that were actually run
        self.direct = dict(direct or {})
        self.n_samples = int(n_samples)

    # -- fitting -------------------------------------------------------------

    @classmethod
    def fit(cls, rows: Iterable[dict]) -> "CostModel":
        """Least-squares ``sec/batch = alpha + beta * bucket`` over the
        per-bucket samples, plus prep/compile rates and the direct
        config->rows/s table. Pure arithmetic — reproducible from the
        persisted rows alone."""
        per_bucket: Dict[int, Dict[str, float]] = {}
        prep_s = prep_rows = 0.0
        compile_s, compiles = 0.0, 0
        direct: Dict[tuple, List[float]] = {}
        n = 0
        for r in rows:
            n += 1
            compile_s += float(r.get("compile_seconds") or 0.0)
            compiles += int(r.get("compiles") or 0)
            rps = r.get("rows_per_sec")
            if rps:
                cfg = r.get("config") or {}
                key = _config_key(cfg.get("mini_batch_size", 0) or 0,
                                  cfg.get("prefetch_depth", 0) or 0,
                                  cfg.get("buckets"))
                direct.setdefault(key, []).append(float(rps))
            b = r.get("bucket")
            if b is None or not r.get("batches"):
                continue
            s = per_bucket.setdefault(
                int(b), {"seconds": 0.0, "batches": 0.0, "rows": 0.0})
            s["seconds"] += float(r.get("seconds") or 0.0)
            s["batches"] += float(r.get("batches") or 0)
            s["rows"] += float(r.get("rows") or 0)
            prep_s += float(r.get("prep_seconds") or 0.0)
            prep_rows += float(r.get("rows") or 0)
        pts = [(b, s["seconds"] / s["batches"], s["batches"])
               for b, s in sorted(per_bucket.items()) if s["batches"] > 0]
        alpha, beta = cls._weighted_lsq(pts)
        return cls(
            alpha=alpha, beta=beta,
            prep_rate=(prep_s / prep_rows) if prep_rows else 0.0,
            compile_cost=(compile_s / compiles) if compiles
            else _DEFAULT_COMPILE_COST,
            direct={k: sum(v) / len(v) for k, v in direct.items()},
            n_samples=n)

    @staticmethod
    def _weighted_lsq(pts: List[Tuple[float, float, float]]
                      ) -> Tuple[float, float]:
        """Weighted least squares of ``y = a + b x`` over (x, y, w);
        degenerate inputs degrade gracefully (one point: pure slope)."""
        if not pts:
            return 0.0, 0.0
        if len(pts) == 1:
            x, y, _ = pts[0]
            return 0.0, (y / x if x else 0.0)
        sw = sum(w for _, _, w in pts)
        mx = sum(w * x for x, _, w in pts) / sw
        my = sum(w * y for _, y, w in pts) / sw
        sxx = sum(w * (x - mx) ** 2 for x, _, w in pts)
        sxy = sum(w * (x - mx) * (y - my) for x, y, w in pts)
        if sxx <= 0.0:
            return 0.0, (my / mx if mx else 0.0)
        beta = sxy / sxx
        alpha = my - beta * mx
        if beta < 0.0:
            # noise-dominated: fall back to a flat per-dispatch cost
            return my, 0.0
        if alpha < 0.0:
            return 0.0, my / mx if mx else beta
        return alpha, beta

    # -- prediction ----------------------------------------------------------

    def predict_seconds(self, histogram: Dict[int, int],
                        mini_batch_size: int, prefetch_depth: int,
                        buckets: Optional[Sequence[int]] = None,
                        compile_weight: float = 1.0) -> float:
        """Predicted wall-clock to move the histogram's rows through a
        candidate config, warm-up compiles included at ``compile_weight``
        (lower it when the vocabulary amortizes over many processes via
        the persistent compile cache)."""
        direct = self.direct.get(
            _config_key(mini_batch_size, prefetch_depth, buckets))
        total_rows = sum(int(n) * int(c) for n, c in histogram.items())
        if direct and total_rows:
            return total_rows / direct
        m = max(1, int(mini_batch_size))
        d = max(0, int(prefetch_depth))
        total = 0.0
        vocab = set()
        for n, cnt in histogram.items():
            cnt = int(cnt)
            if cnt <= 0:
                continue
            run = 0.0
            for s in _batch_sizes(int(n), m):
                p = bucket_size(s, buckets)
                vocab.add(p)
                dev = self.alpha + self.beta * p
                prep = self.prep_rate * s
                # pipeline overlap: depth 0 serializes prep and device
                # work; each extra prepared batch hides more of the
                # smaller term, asymptoting to max(dev, prep)
                run += max(dev, prep) + min(dev, prep) / (d + 1.0)
            total += run * cnt
        total += compile_weight * self.compile_cost * len(vocab)
        return total

    def choose(self, histogram: Dict[int, int],
               defaults: Tuple[int, int] = (64, 2),
               candidates: Optional[List[tuple]] = None,
               compile_weight: float = 1.0) -> TuningDecision:
        """The best candidate config for the histogram (deterministic:
        ties break toward the earlier candidate, and the candidate list
        itself is deterministically ordered)."""
        cands = candidates if candidates is not None \
            else candidate_configs(histogram, defaults)
        total_rows = sum(int(n) * int(c) for n, c in histogram.items())
        best = None
        for m, d, ladder in cands:
            sec = self.predict_seconds(histogram, m, d, ladder,
                                       compile_weight=compile_weight)
            if best is None or sec < best[0]:
                best = (sec, m, d, ladder)
        sec, m, d, ladder = best
        sizes = sorted({s for n, c in histogram.items() if int(c) > 0
                        for s in _batch_sizes(int(n), m)})
        vocab = sorted({bucket_size(s, ladder) for s in sizes})
        key = _config_key(m, d, ladder)
        return TuningDecision(
            mini_batch_size=m, prefetch_depth=d, buckets=ladder,
            warm_up_sizes=tuple(sizes), vocabulary=tuple(vocab),
            predicted_seconds=sec,
            predicted_rows_per_sec=(total_rows / sec) if sec > 0 else None,
            source="probe" if key in self.direct else "model",
            details={"alpha": self.alpha, "beta": self.beta,
                     "prep_rate": self.prep_rate,
                     "compile_cost": self.compile_cost,
                     "n_samples": self.n_samples,
                     "n_candidates": len(cands)})


def compare_paged_attn(store: Optional[ObservationStore] = None,
                       sig: str = "generation") -> Dict[str, dict]:
    """Kernel-vs-gather generation throughput per placement.

    Groups the harvested ``generation`` observations (each stamped with
    ``paged_attn_impl`` by :func:`import_bench_records`) by placement and
    implementation, and reports mean tok/s plus the kernel/gather
    speedup where both impls have samples — the per-signature evidence
    ROADMAP item 4's cross-signature transfer will generalize from.
    Placements with no impl-stamped rows are omitted."""
    store = store if store is not None else get_store()
    by_placement: Dict[str, Dict[str, List[float]]] = {}
    for r in store.rows(sig=sig):
        impl = r.get("paged_attn_impl") or (r.get("config")
                                            or {}).get("paged_attn_impl")
        tps = r.get("rows_per_sec")
        if impl is None or not isinstance(tps, (int, float)) or tps <= 0:
            continue
        by_placement.setdefault(str(r.get("placement", "default")),
                                {}).setdefault(str(impl), []).append(
                                    float(tps))
    out: Dict[str, dict] = {}
    for placement, impls in by_placement.items():
        row = {impl: {"n": len(v),
                      "tok_per_sec_mean": round(sum(v) / len(v), 2)}
               for impl, v in impls.items()}
        k = row.get("kernel", {}).get("tok_per_sec_mean")
        g = row.get("gather", {}).get("tok_per_sec_mean")
        row["kernel_vs_gather_speedup"] = (
            round(k / g, 4) if k and g else None)
        out[placement] = row
    return out


def compare_kv_dtype(store: Optional[ObservationStore] = None,
                     sig: str = "generation") -> Dict[str, dict]:
    """Quantized-vs-bf16 KV-plane generation throughput per placement.

    The ``kv_dtype`` twin of :func:`compare_paged_attn`: groups the
    harvested generation observations by placement and the KV store
    dtype the engine decoded with (``int8``/``fp8``, or ``bf16`` when
    unstamped/None — the full-precision pool), and reports mean tok/s
    plus the quantized/bf16 speedup where both have samples. This is
    the evidence a CostModel candidate sweep over ``kv_dtype`` reads:
    on HBM-bound decode the ~2x byte reduction should show up here as
    realized tok/s, not just the counter-asserted byte ratio."""
    store = store if store is not None else get_store()
    by_placement: Dict[str, Dict[str, List[float]]] = {}
    for r in store.rows(sig=sig):
        dt = r.get("kv_dtype") or (r.get("config") or {}).get("kv_dtype")
        dt = str(dt) if dt else "bf16"
        tps = r.get("rows_per_sec")
        if not isinstance(tps, (int, float)) or tps <= 0:
            continue
        by_placement.setdefault(str(r.get("placement", "default")),
                                {}).setdefault(dt, []).append(float(tps))
    out: Dict[str, dict] = {}
    for placement, dts in by_placement.items():
        row = {dt: {"n": len(v),
                    "tok_per_sec_mean": round(sum(v) / len(v), 2)}
               for dt, v in dts.items()}
        q = (row.get("int8") or row.get("fp8")
             or {}).get("tok_per_sec_mean")
        b = row.get("bf16", {}).get("tok_per_sec_mean")
        row["quant_vs_bf16_speedup"] = (
            round(q / b, 4) if q and b else None)
        out[placement] = row
    return out


def predecessor_signature(sig: str,
                          known: Iterable[str]) -> Optional[str]:
    """The nearest sibling signature for a cold *versioned* model: a
    known signature naming the same model but a different ``@version``
    (sigs shaped ``cost:{transport}/{route}/{name@version}[@tenant]``).
    A freshly rolled-out version seeds its tuning decision from its
    predecessor's rows — the transfer move of "A Learned Performance
    Model for TPUs" (arXiv:2008.01040): variants of one workload share
    cost structure, so starting from the predecessor's fit beats
    starting cold. Picks the candidate sharing the longest common
    prefix with ``sig`` (ties: lexicographically greatest, i.e. the
    newest version string). None when ``sig`` is unversioned."""
    segment = sig.rsplit("/", 1)[-1]
    if "@" not in segment:
        return None
    # everything through the model name's '@' — siblings differ past it
    base = sig[:sig.rfind("/") + 1 + segment.index("@") + 1]
    cands = [s for s in known if s != sig and s.startswith(base)]
    if not cands:
        return None

    def common(a: str, b: str) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    cands.sort(key=lambda s: (common(s, sig), s))
    return cands[-1]


def _row_mesh(row: dict) -> str:
    """A stored row's mesh-shape stamp (``"single"`` when unstamped —
    every pre-mesh observation was measured on one card)."""
    return str(row.get("mesh_shape")
               or (row.get("config") or {}).get("mesh_shape")
               or "single")


def resolve_tuning(sig: str, placement: str, histogram: Dict[int, int],
                   defaults: Tuple[int, int] = (64, 2),
                   store: Optional[ObservationStore] = None,
                   compile_weight: float = 1.0,
                   mesh_shape: Optional[str] = None
                   ) -> Optional[TuningDecision]:
    """Consult the store for ``sig`` and return a decision, or ``None``
    when the model is cold (no rows for this signature) — the caller
    keeps its defaults or runs :func:`measured_sweep`.

    Placement-matched rows are preferred; with none, every row of the
    signature trains the fit (a card and its neighbor share cost
    structure — better than abstaining). When ``mesh_shape`` is given
    (``"single"``, ``"dp4xtp2"``, ...), only rows stamped with the SAME
    mesh shape train the fit — a single-card ladder must never transfer
    onto a sharded engine (its per-tick cost surface includes
    collectives a single card never pays), and vice versa. A cold
    *versioned* signature (``name@version``) falls back to its
    :func:`predecessor_signature`'s rows before abstaining, preferring
    predecessor candidates whose rows match the mesh shape; such
    decisions carry ``source="transfer"`` and name the seed in
    ``details["seeded_from"]``."""
    store = store if store is not None else get_store()

    def _rows_for(s: str) -> list:
        got = (store.rows(sig=s, placement=placement)
               or store.rows(sig=s))
        if mesh_shape is not None:
            got = [r for r in got if _row_mesh(r) == mesh_shape]
        return got

    rows = _rows_for(sig)
    seeded_from = None
    if not rows:
        known = list(store.signatures())
        remaining = set(known)
        # walk predecessor candidates nearest-first until one has rows
        # (under a mesh_shape filter the nearest sibling may hold only
        # other-topology rows — the next-nearest can still seed)
        while remaining:
            pred = predecessor_signature(sig, remaining)
            if pred is None:
                break
            remaining.discard(pred)
            rows = _rows_for(pred)
            if rows:
                seeded_from = pred
                break
    if not rows:
        M_DECISIONS.inc(source="default")
        return None
    decision = CostModel.fit(rows).choose(histogram, defaults,
                                          compile_weight=compile_weight)
    if seeded_from is not None:
        decision.source = "transfer"
        decision.details["seeded_from"] = seeded_from
    if mesh_shape is not None:
        decision.details["mesh_shape"] = mesh_shape
    M_DECISIONS.inc(source=decision.source)
    _tracing.add_event("tuning_decision", sig=sig,
                       mini_batch_size=decision.mini_batch_size,
                       prefetch_depth=decision.prefetch_depth,
                       source=decision.source)
    return decision


def measured_sweep(make_runner: Callable, n_rows: int, *, sig: str,
                   placement: str = "default",
                   histogram: Optional[Dict[int, int]] = None,
                   candidates: Optional[List[tuple]] = None,
                   budget: Optional[int] = None,
                   store: Optional[ObservationStore] = None,
                   defaults: Tuple[int, int] = (64, 2),
                   ) -> TuningDecision:
    """TVM-style bounded sweep for a cold model: propose → run → record.

    ``make_runner(mini_batch_size, prefetch_depth, buckets)`` builds a
    :class:`BatchRunner` (over a representative workload) whose
    ``run_and_drain(n_rows)`` executes one probe; each probe's wall-clock
    lands in the store as a ``source="probe"`` observation (every probe
    is a future observation), and the decision is re-derived from the
    store through the normal fit — so deleting the model and re-fitting
    reproduces the same pick from the persisted rows alone.
    """
    import time as _time

    store = store if store is not None else get_store()
    histogram = histogram or {int(n_rows): 1}
    cands = candidates if candidates is not None \
        else candidate_configs(histogram, defaults)
    budget = budget if budget is not None else probe_budget()
    with _tracing.start_span("tuning.sweep", sig=sig,
                             candidates=min(len(cands), budget)):
        for m, d, ladder in cands[:max(1, int(budget))]:
            runner = make_runner(m, d, ladder)
            t0 = _time.perf_counter()
            runner.run_and_drain(int(n_rows))
            elapsed = _time.perf_counter() - t0
            M_PROBES.inc()
            store.record({
                "sig": sig, "source": "probe", "placement": placement,
                "config": {"mini_batch_size": int(m),
                           "prefetch_depth": int(d),
                           "buckets": (None if ladder is None
                                       else list(ladder))},
                "bucket": None, "rows": int(n_rows), "batches": 0,
                "seconds": elapsed, "prep_seconds": 0.0,
                "compile_seconds": 0.0, "compiles": 0,
                "rows_per_sec": (int(n_rows) / elapsed) if elapsed > 0
                else None,
                "t": _time.time()})
    decision = CostModel.fit(store.rows(sig=sig)).choose(
        histogram, defaults)
    M_DECISIONS.inc(source="probe")
    return decision
