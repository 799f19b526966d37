"""Per-peer circuit breaker: closed → open → half-open.

A breaker trips OPEN when the failure ratio over a sliding window of
recent calls crosses a threshold; while open, ``allow()`` fails fast so a
dead peer costs one dict lookup instead of a connect timeout. After
``open_seconds`` the breaker admits a single HALF-OPEN probe — success
closes it, failure re-opens it. State is exported as
``mmlspark_breaker_state{peer}`` (0=closed, 1=open, 2=half-open) and every
transition bumps ``mmlspark_breaker_transitions_total{peer,to}`` and lands
as a span event on the active trace.

The port's copy of ``mmlspark_tpu/reliability/breaker.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List

from ..observability import counter as _metric_counter
from ..observability import gauge as _metric_gauge
from ..observability import tracing as _tracing

from .lock_sanitizer import new_lock

__all__ = ["BreakerOpen", "CircuitBreaker", "breaker_for", "reset_breakers",
           "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

_M_STATE = _metric_gauge(
    "mmlspark_breaker_state",
    "Circuit state per peer: 0=closed, 1=open, 2=half_open",
    ("peer",))
_M_TRANSITIONS = _metric_counter(
    "mmlspark_breaker_transitions_total",
    "Circuit state transitions per peer, by target state",
    ("peer", "to"))


class BreakerOpen(ConnectionError):
    """Raised (or used as a fail-fast signal) when a peer's circuit is open."""

    def __init__(self, peer: str):
        super().__init__(f"circuit open for peer {peer}")
        self.peer = peer


class CircuitBreaker:
    """Sliding-window failure-ratio breaker for one peer.

    ``window`` recent outcomes are kept; once at least ``min_calls`` are
    recorded and the failure ratio reaches ``failure_ratio``, the breaker
    opens for ``open_seconds``. The clock is injectable for tests.
    """

    def __init__(self, peer: str = "", window: int = 20, min_calls: int = 5,
                 failure_ratio: float = 0.5, open_seconds: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.peer = peer
        self.min_calls = int(min_calls)
        self.failure_ratio = float(failure_ratio)
        self.open_seconds = float(open_seconds)
        self._clock = clock
        self._outcomes = deque(maxlen=int(window))  # True = success
        self._state = CLOSED
        self._opened_at = 0.0
        self._probe_inflight = False
        self._lock = new_lock("reliability.breaker.CircuitBreaker._lock")
        _M_STATE.set(0.0, peer=peer)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call to this peer proceed right now? A ``True`` answer in
        HALF_OPEN claims the single probe slot."""
        with self._lock:
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.open_seconds:
                    return False
                self._transition(HALF_OPEN)
                self._probe_inflight = True
                return True
            if self._state == HALF_OPEN:
                if self._probe_inflight:
                    return False
                self._probe_inflight = True
                return True
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._state in (HALF_OPEN, OPEN):
                # probe (or late straggler) succeeded: peer is back
                self._outcomes.clear()
                self._probe_inflight = False
                self._transition(CLOSED)
                return
            self._outcomes.append(True)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = False
                self._opened_at = self._clock()
                self._transition(OPEN)
                return
            if self._state == OPEN:
                return
            self._outcomes.append(False)
            n = len(self._outcomes)
            if n >= self.min_calls:
                failures = sum(1 for ok in self._outcomes if not ok)
                if failures / n >= self.failure_ratio:
                    self._opened_at = self._clock()
                    self._transition(OPEN)

    # -- internal (lock held) ----------------------------------------------
    def _transition(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        _M_STATE.set(_STATE_VALUE[to], peer=self.peer)
        _M_TRANSITIONS.inc(peer=self.peer, to=to)
        _tracing.add_event("breaker_transition", peer=self.peer, to=to)


_BREAKERS: Dict[str, CircuitBreaker] = {}
_BREAKERS_LOCK = new_lock("reliability.breaker._BREAKERS_LOCK")


def breaker_for(peer: str, **kwargs) -> CircuitBreaker:
    """Process-wide breaker registry, one breaker per peer address.

    Keyed by *address* rather than worker id so a worker that re-registers
    on a fresh port starts with a clean circuit (the old incarnation's
    failures do not poison the new one)."""
    with _BREAKERS_LOCK:
        brk = _BREAKERS.get(peer)
        if brk is None:
            brk = _BREAKERS[peer] = CircuitBreaker(peer, **kwargs)
        return brk


def reset_breakers() -> None:
    """Test hook: drop all registered breakers (metric series are cleaned
    up by ``observability.reset_all``)."""
    with _BREAKERS_LOCK:
        _BREAKERS.clear()


def open_breakers() -> List[str]:
    """Peers whose circuit is currently open — the /healthz degraded
    check (half-open circuits are probing their way back and don't count
    as degraded)."""
    with _BREAKERS_LOCK:
        brks = list(_BREAKERS.values())
    return sorted(b.peer for b in brks if b.state == OPEN)
