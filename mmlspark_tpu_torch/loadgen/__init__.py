"""Open-loop load generation: arrival processes, declarative scenarios,
chaos composition, and SLO scorecards the tuner can learn from.

The package exists because closed-loop benches (send → wait → send) hide
queueing collapse: a slow server throttles its own load generator, so
p99 stays flat while real users would be stacking up — coordinated
omission. Everything here measures latency from each request's
*scheduled* send instant instead, drives traffic through the same
admission/breaker/fault machinery production requests hit, and emits one
BENCH-style scorecard per scenario (mirrored to ``mmlspark_scenario_*``
metrics and harvested into the ``ObservationStore``).

* :mod:`.arrivals` — seeded Poisson/diurnal arrivals, heavy-tailed
  sizes, multi-tenant mix with Zipf prefix-sharing skew.
* :mod:`.scenarios` — :class:`~.scenarios.Scenario` registry, the
  open-loop runner, chaos scripts, closed-loop probe.
* :mod:`.scorecard` — scorecard assembly, fairness error, counter
  reconciliation, metric mirrors, ObservationStore harvest.
* :mod:`.sessions` — journal-backed long-decode session drill: worker
  kills mid-decode, recovery over the real ``/_adopt`` hop, token-parity
  accounting (``sessions_lost``/``sessions_recovered``/
  ``recovery_p99_ms`` in the scorecard).
* :mod:`.progress` — the live snapshot behind ``GET /debug/scenario``.

The port's copy of ``mmlspark_tpu/loadgen/__init__.py``.
"""

from .arrivals import (Arrival, TenantMix, diurnal_offsets,
                       heavy_tail_rows, interarrivals, poisson_offsets,
                       weighted_choice)
from .progress import ScenarioProgress, get_progress, reset_progress
from .scenarios import (SCENARIOS, Scenario, closed_loop_probe,
                        cluster_echo_engine, get_scenario, plan,
                        run_scenario)
from .scorecard import (build_scorecard, counters_snapshot, fairness_error,
                        harvest_slo, merged_requests_total, quantiles_ms)
from .sessions import SessionDrill, session_token

__all__ = [
    "Arrival", "SCENARIOS", "Scenario", "ScenarioProgress", "SessionDrill",
    "TenantMix",
    "build_scorecard", "closed_loop_probe", "cluster_echo_engine",
    "counters_snapshot", "diurnal_offsets", "fairness_error",
    "get_progress", "get_scenario", "harvest_slo", "heavy_tail_rows",
    "interarrivals", "merged_requests_total", "plan", "poisson_offsets",
    "quantiles_ms", "reset_progress", "run_scenario", "session_token",
    "weighted_choice",
]
