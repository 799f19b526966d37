"""Reliability pieces the serving stack uses (counterpart of
``mmlspark_tpu/reliability/``): :mod:`.policy` (:class:`Deadline` for
the ``X-Mmlspark-Deadline`` header, :class:`RetryPolicy`) and
:mod:`.faults` (the seedable :class:`FaultInjector` with its named
sites). The circuit breakers and supervised loops belong to the
distributed serving plane, which the port does not have yet; the lock
sanitizer is a debugging aid the port leaves out (it uses plain
``threading`` locks)."""

from .faults import FaultInjector, InjectedFault, get_injector
from .policy import (DEADLINE_HEADER, Deadline, DeadlineExceeded, RetryPolicy,
                     record_retry)

__all__ = ["FaultInjector", "InjectedFault", "get_injector",
           "DEADLINE_HEADER", "Deadline", "DeadlineExceeded", "RetryPolicy",
           "record_retry"]
