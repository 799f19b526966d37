"""Per-bucket warm-up and the feed/drain stage counters (counterpart of
``mmlspark_tpu/ops/compile_cache.py``: ``StageCounters``,
``resolve_input_specs`` and ``warm_up_jitted`` / ``warm_up_model``).

The JAX package compiles one XLA executable per padding bucket and warms
each before traffic so that no request pays a compile. Eager PyTorch
compiles nothing, but the first batch of each shape still pays for
cuDNN's algorithm choice, CUDA's lazy module loading and the caching
allocator's growth. Warm-up here runs one zero batch per bucket through
the graph on its device, outside any timed section, and puts those costs
where XLA's compile was. The JAX package's persistent executable cache
and collective audit have no counterpart.

:class:`StageCounters` instruments the batch runner's feed/drain
pipeline (coerce / pad / h2d / dispatch / d2h, and warm-up as
``compile``); every ``add`` also feeds the process-global
``mmlspark_runner_stage_*`` counters.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability.registry import counter as _metric_counter
from .padding import bucket_size

__all__ = ["StageCounters", "warm_up_jitted", "warm_up_model",
           "resolve_input_specs"]

M_STAGE_SECONDS = _metric_counter(
    "mmlspark_runner_stage_seconds_total",
    "Cumulative feed/drain pipeline wall-clock by stage", ("stage",))
M_STAGE_CALLS = _metric_counter(
    "mmlspark_runner_stage_calls_total",
    "Feed/drain pipeline stage invocations", ("stage",))
M_STAGE_BYTES = _metric_counter(
    "mmlspark_runner_stage_bytes_total",
    "Bytes crossing the host<->device boundary by stage", ("stage",))
M_WARMUP_BUCKETS = _metric_counter(
    "mmlspark_compile_cache_warmup_buckets_total",
    "Padding buckets executed ahead of traffic by warm_up")
M_WARMUP_SECONDS = _metric_counter(
    "mmlspark_compile_cache_warmup_seconds_total",
    "Wall-clock spent in warm-up")


class StageCounters:
    """Lightweight per-stage timing/byte counters for the feed/drain pipeline.

    Stages are free-form strings; the runner uses ``coerce``, ``pad``,
    ``h2d``, ``dispatch``, ``d2h`` and warm-up ``compile``. Thread-safe
    (partitions run concurrently). ``dispatch`` is host time to issue a
    batch's kernels, not device time: CUDA launches return before the
    device finishes, and the device's time settles in the ``d2h`` wait.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: Dict[str, Dict[str, float]] = {}

    def add(self, stage: str, seconds: float, nbytes: int = 0,
            count: int = 1) -> None:
        with self._lock:
            s = self._stages.setdefault(
                stage, {"calls": 0, "seconds": 0.0, "bytes": 0})
            s["calls"] += count
            s["seconds"] += seconds
            s["bytes"] += nbytes
        M_STAGE_SECONDS.inc(seconds, stage=stage)
        M_STAGE_CALLS.inc(count, stage=stage)
        if nbytes:
            M_STAGE_BYTES.inc(nbytes, stage=stage)

    class _Timer:
        __slots__ = ("_c", "_stage", "_nbytes", "_t0")

        def __init__(self, counters, stage, nbytes):
            self._c, self._stage, self._nbytes = counters, stage, nbytes

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._c.add(self._stage, time.perf_counter() - self._t0,
                        self._nbytes)
            return False

    def timer(self, stage: str, nbytes: int = 0) -> "StageCounters._Timer":
        return self._Timer(self, stage, nbytes)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"calls": int(v["calls"]),
                        "seconds": round(float(v["seconds"]), 6),
                        "bytes": int(v["bytes"])}
                    for k, v in sorted(self._stages.items())}

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()

    def total_seconds(self, stage: str) -> float:
        with self._lock:
            s = self._stages.get(stage)
            return float(s["seconds"]) if s else 0.0


def resolve_input_specs(inputs: Iterable, feed: Dict[str, str],
                        transpose: Dict[str, Sequence[int]],
                        overrides: Optional[Dict[str, tuple]] = None
                        ) -> Dict[str, Tuple[np.dtype, tuple]]:
    """Per-row (dtype, shape) of each *fed* model input, for warm-up zeros.

    ``inputs`` are converted-model value infos (``.name``, ``.numpy_dtype``,
    ``.shape``). Inputs routed through ``transpose_dict`` are fed in the
    column's layout, so the declared (post-transpose) shape is run backwards
    through the permutation. ``overrides`` ({name: (dtype, row_shape)}) wins
    outright — required when the declared shape is symbolic, or when the
    column's dtype differs from the graph's (uint8 images into a float
    input).
    """
    overrides = dict(overrides or {})
    specs: Dict[str, Tuple[np.dtype, tuple]] = {}
    for vi in inputs:
        if vi.name not in feed:
            continue
        if vi.name in overrides:
            dt, shape = overrides[vi.name]
            specs[vi.name] = (np.dtype(dt), tuple(shape))
            continue
        declared = list(vi.shape)
        perm = transpose.get(vi.name)
        if perm is not None:
            if len(perm) != len(declared):
                raise ValueError(
                    f"transpose_dict[{vi.name!r}] permutes {len(perm)} axes "
                    f"but the input declares {len(declared)}")
            fed = [None] * len(declared)
            for i, p in enumerate(perm):
                fed[p] = declared[i]
            declared = fed
        row_shape = declared[1:]
        if any(not isinstance(d, int) for d in row_shape):
            raise ValueError(
                f"input {vi.name!r} has symbolic per-row shape {row_shape}; "
                f"pass input_specs={{{vi.name!r}: (dtype, row_shape)}} to "
                f"warm_up")
        specs[vi.name] = (np.dtype(vi.numpy_dtype), tuple(row_shape))
    return specs


def warm_up_jitted(fn: Callable, params, specs: Dict[str, Tuple[np.dtype,
                                                                tuple]],
                   batch_sizes: Sequence[int], device: torch.device,
                   shards: int = 1,
                   counters: Optional[StageCounters] = None,
                   buckets: Optional[Sequence[int]] = None) -> dict:
    """Run one zero batch of every padding-bucket shape through ``fn``.

    For each requested batch size the *padded* feed size is derived exactly
    as the runner derives it (``bucket_size`` over the active ladder, then
    rounded up to a multiple of ``shards``); zero feeds are made on
    ``device`` and run through ``fn(params, feeds)`` once, and the host
    waits for the device after each bucket, so the time counted is the
    warm-up's own.

    Returns ``{"buckets": [padded sizes], "compiles": n, "seconds": s}``,
    where ``compiles`` is the number of buckets run (the JAX package's
    count of XLA compiles).
    """
    ladder = None if not buckets else tuple(sorted({int(b)
                                                    for b in buckets}))
    sizes = sorted({-(-bucket_size(int(b), ladder) // max(1, shards))
                    * max(1, shards) for b in batch_sizes if int(b) > 0})
    t_start = time.perf_counter()
    with torch.inference_mode():
        for size in sizes:
            feeds = {name: torch.zeros((size,) + tuple(shape),
                                       dtype=torch.from_numpy(
                                           np.zeros(0, dt)).dtype,
                                       device=device)
                     for name, (dt, shape) in specs.items()}
            fn(params, feeds)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t_start
    if counters is not None and sizes:
        counters.add("compile", elapsed, count=len(sizes))
    if sizes:
        M_WARMUP_BUCKETS.inc(len(sizes))
        M_WARMUP_SECONDS.inc(elapsed)
    return {"buckets": sizes, "compiles": len(sizes),
            "seconds": round(elapsed, 4)}


def warm_up_model(model, fn: Callable, specs, batch_sizes,
                  background: bool = False,
                  buckets: Optional[Sequence[int]] = None):
    """Warm every placement a model's traffic can hit.

    ``model`` supplies ``_placement_params(pidx)`` → (placement, params),
    ``_n_placements()`` and its ``stage_counters``; placements with the
    same key are warmed once. ``background=True`` runs on a daemon thread
    and returns it; otherwise returns aggregated
    ``{"buckets", "compiles", "seconds", "placements"}``.
    """
    def _warm():
        stats = {"buckets": [], "compiles": 0, "seconds": 0.0,
                 "placements": 0}
        seen = set()
        for pidx in range(model._n_placements()):
            placement, params = model._placement_params(pidx)
            if placement.key in seen:
                continue
            seen.add(placement.key)
            s = warm_up_jitted(fn, params, specs, batch_sizes,
                               placement.device, shards=placement.shards,
                               counters=model.stage_counters,
                               buckets=buckets)
            stats["buckets"] = sorted(set(stats["buckets"])
                                      | set(s["buckets"]))
            stats["compiles"] += s["compiles"]
            stats["seconds"] = round(stats["seconds"] + s["seconds"], 4)
            stats["placements"] += 1
        return stats

    if background:
        # run-once warm-up over a finite placement list: a crash leaves the
        # shapes cold (the first real batch pays) and is not restarted
        t = threading.Thread(target=_warm, daemon=True,
                             name=f"warmup-{model.uid}")
        t.start()
        return t
    return _warm()
