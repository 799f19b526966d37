"""Measurement-driven tuning (counterpart of ``mmlspark_tpu/tuning/``).

Ported so far: :mod:`.observations`, the append-only store of measured
samples that ``/debug/slo`` and ``/debug/costs`` harvest into. The cost
model that turns them into a chosen ``(ladder, mini_batch_size,
prefetch_depth)`` (``tuning="auto"``) is not ported yet (ROADMAP.md queue
item 24).
"""

from .observations import (TUNING_DIR_ENV, Observation, ObservationStore,
                           get_store, harvest_costs, harvest_scorecard,
                           import_bench_records, reset_store, set_store)

__all__ = [
    "TUNING_DIR_ENV",
    "Observation",
    "ObservationStore",
    "get_store",
    "set_store",
    "reset_store",
    "import_bench_records",
    "harvest_scorecard",
    "harvest_costs",
]
