"""Measurement-driven tuning (counterpart of ``mmlspark_tpu/tuning/``).

* :mod:`.observations` — the append-only store of measured samples
  (per-bucket throughput, pad waste, compile cost), harvested from every
  :class:`~mmlspark_tpu_torch.models.runner.BatchRunner` drain and from
  ``/debug/slo`` and ``/debug/costs``;
* :mod:`.cost_model` — the fitted per-bucket linear cost model that,
  given a row-size histogram, picks ``(ladder, mini_batch_size,
  prefetch_depth)``, and the bounded measured sweep a cold store runs
  instead.

Wiring: ``BatchRunner``, ``ONNXModel``, ``TorchModel`` and
``ServingEngine`` accept ``tuning="auto"``; ``warm_up`` runs exactly the
chosen vocabulary.
"""

from .cost_model import (CostModel, TuningDecision, candidate_configs,
                         compare_kv_dtype, compare_paged_attn,
                         measured_sweep, probe_budget, resolve_tuning)
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
    "CostModel",
    "TuningDecision",
    "candidate_configs",
    "compare_kv_dtype",
    "compare_paged_attn",
    "measured_sweep",
    "probe_budget",
    "resolve_tuning",
]
