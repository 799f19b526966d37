"""Reliability substrate for the serving stack (the port's copy of
``mmlspark_tpu/reliability/``).

Five cooperating pieces:

- :mod:`.policy` — :class:`RetryPolicy` (budgeted exponential backoff with
  full jitter) and :class:`Deadline` (monotonic remaining-budget object,
  propagated across worker hops via the ``X-Mmlspark-Deadline`` header).
- :mod:`.breaker` — per-peer :class:`CircuitBreaker`
  (closed → open → half-open, failure-ratio over a sliding window), state
  exported as ``mmlspark_breaker_state{peer}``.
- :mod:`.faults` — deterministic, seedable :class:`FaultInjector` with
  named sites (``peer_http``, ``heartbeat``, ``device_run``, ``enqueue``)
  driven programmatically or by the ``MMLSPARK_TPU_FAULTS`` env spec.
- :mod:`.loops` — :func:`run_supervised`/:func:`start_supervised`, the
  crash-contained daemon-loop harness (backoff + restart accounting into
  ``mmlspark_supervised_loop_restarts_total{loop}``) that heartbeat and
  sweeper threads run under.
- :mod:`.lock_sanitizer` — opt-in (``MMLSPARK_TPU_LOCK_SANITIZER=1``)
  instrumented lock factory: dynamic lock-order-cycle detection with both
  stacks, hold-time budgets into ``mmlspark_lock_held_seconds{site}``, and
  the watchdog bundle's locks-held-per-thread table.
"""

from .breaker import (BreakerOpen, CircuitBreaker, breaker_for,
                      open_breakers, reset_breakers)
from .faults import FaultInjector, InjectedFault, get_injector
from .lock_sanitizer import (cycle_reports, held_by_thread, new_condition,
                             new_lock, new_rlock)
from .loops import run_supervised, start_supervised
from .policy import (DEADLINE_HEADER, Deadline, DeadlineExceeded, RetryPolicy,
                     record_retry)

__all__ = [
    "BreakerOpen",
    "CircuitBreaker",
    "breaker_for",
    "open_breakers",
    "reset_breakers",
    "FaultInjector",
    "InjectedFault",
    "get_injector",
    "cycle_reports",
    "held_by_thread",
    "new_condition",
    "new_lock",
    "new_rlock",
    "run_supervised",
    "start_supervised",
    "DEADLINE_HEADER",
    "Deadline",
    "DeadlineExceeded",
    "RetryPolicy",
    "record_retry",
]
