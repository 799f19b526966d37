"""Retry policy (budgeted backoff + full jitter) and deadline propagation
(the port's copy of ``mmlspark_tpu/reliability/policy.py``).

Every knob that touches time is injectable (``clock``/``sleep``/``rng``) so
the unit tests in tests/test_reliability.py run on a fake clock and are
fully deterministic. :class:`Deadline` carries the *remaining* budget — not
an absolute timestamp — across process hops (monotonic clocks do not
transfer between processes), gRPC ``grpc-timeout`` style.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from ..observability import tracing as _tracing
from ..observability.registry import counter as _metric_counter

__all__ = ["DEADLINE_HEADER", "Deadline", "DeadlineExceeded", "RetryPolicy",
           "record_retry"]

#: Cross-hop header carrying the caller's remaining budget in seconds
#: (decimal string, e.g. ``"2.350"``). A forwarded request must never wait
#: longer than what is left of the client's ``reply_timeout``.
DEADLINE_HEADER = "X-Mmlspark-Deadline"

_M_RETRIES = _metric_counter(
    "mmlspark_retry_attempts_total",
    "Re-attempts after a failed first try, by logical call site",
    ("site",))


class DeadlineExceeded(TimeoutError):
    """The operation's remaining budget reached zero before it completed."""


def record_retry(site: str, attempt: int, delay: float, error: str) -> None:
    """Account one re-attempt: bump the site counter and note it on the
    active trace span (no-ops when no span is active)."""
    _M_RETRIES.inc(site=site)
    _tracing.add_event("retry", site=site, attempt=attempt,
                       delay=round(delay, 6), error=error)


class Deadline:
    """Monotonic remaining-budget object.

    Constructed from a total budget (``Deadline.after(2.5)``) or from the
    wire header of an upstream hop (``Deadline.from_header(value)``).
    ``cap(timeout)`` clamps any local wait to the remaining budget.
    """

    __slots__ = ("_expires_at", "_clock")

    def __init__(self, budget: float,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._expires_at = clock() + float(budget)

    @classmethod
    def after(cls, budget: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(budget, clock=clock)

    @classmethod
    def from_header(cls, value: object,
                    clock: Callable[[], float] = time.monotonic
                    ) -> Optional["Deadline"]:
        """Parse a ``X-Mmlspark-Deadline`` header value; ``None`` on garbage
        (a malformed header must degrade to "no deadline", never to a 500)."""
        try:
            budget = float(str(value).strip())
        except (TypeError, ValueError):
            return None
        if budget != budget or budget in (float("inf"), float("-inf")):
            return None
        return cls(budget, clock=clock)

    def remaining(self) -> float:
        return self._expires_at - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def cap(self, timeout: float) -> float:
        """Clamp ``timeout`` to the remaining budget (may be <= 0)."""
        return min(float(timeout), self.remaining())

    def header_value(self) -> str:
        return f"{max(0.0, self.remaining()):.3f}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(remaining={self.remaining():.3f}s)"


class RetryPolicy:
    """Exponential backoff with full jitter and explicit budgets.

    ``max_attempts`` bounds the per-call attempt count; ``total_budget``
    bounds wall-clock spent across *all* attempts (sleep included); an
    optional :class:`Deadline` bounds the call to the caller's remaining
    budget. Backoff for re-attempt *n* is drawn uniformly from
    ``[0, min(max_delay, base_delay * 2**(n-1))]`` (full jitter — decorrelates
    a thundering herd of workers retrying the same dead peer).
    """

    def __init__(self,
                 max_attempts: int = 3,
                 base_delay: float = 0.05,
                 max_delay: float = 2.0,
                 total_budget: Optional[float] = None,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 giveup: Optional[Callable[[BaseException], bool]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.total_budget = total_budget
        self.retry_on = retry_on
        self.giveup = giveup
        self.clock = clock
        self.sleep = sleep
        self.rng = rng if rng is not None else random.Random()

    def backoff(self, attempt: int) -> float:
        """Jittered delay before re-attempt number ``attempt`` (1-based)."""
        ceiling = min(self.max_delay,
                      self.base_delay * (2.0 ** (attempt - 1)))
        return self.rng.uniform(0.0, ceiling)

    def call(self, fn: Callable[[], object], *, site: str = "default",
             deadline: Optional[Deadline] = None):
        """Run ``fn`` under this policy; re-raises the last error once the
        attempt count, total budget, or deadline is exhausted."""
        start = self.clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except self.retry_on as exc:
                if self.giveup is not None and self.giveup(exc):
                    raise
                if attempt >= self.max_attempts:
                    raise
                delay = self.backoff(attempt)
                if (self.total_budget is not None
                        and self.clock() - start + delay > self.total_budget):
                    raise
                if deadline is not None and deadline.remaining() <= delay:
                    raise
                record_retry(site, attempt, delay, type(exc).__name__)
                self.sleep(delay)
