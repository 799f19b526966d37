"""Reliability pieces the serving stack uses (counterpart of
``mmlspark_tpu/reliability/``): :mod:`.policy` (:class:`Deadline` for
the ``X-Mmlspark-Deadline`` header, :class:`RetryPolicy`), :mod:`.faults`
(the seedable :class:`FaultInjector` with its named sites) and
:mod:`.lock_sanitizer` (the opt-in instrumented lock factory the server,
the journal, the decode engine and the time-series store take their
locks from). The circuit breakers and supervised loops belong to the
distributed serving plane, which the port does not have yet (ROADMAP.md
queue item 33)."""

from .faults import FaultInjector, InjectedFault, get_injector
from .lock_sanitizer import (cycle_reports, held_by_thread, new_condition,
                             new_lock, new_rlock)
from .policy import (DEADLINE_HEADER, Deadline, DeadlineExceeded, RetryPolicy,
                     record_retry)

__all__ = ["FaultInjector", "InjectedFault", "get_injector",
           "cycle_reports", "held_by_thread", "new_condition", "new_lock",
           "new_rlock", "DEADLINE_HEADER", "Deadline", "DeadlineExceeded",
           "RetryPolicy", "record_retry"]
