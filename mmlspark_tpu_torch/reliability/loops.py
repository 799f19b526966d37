"""Supervised daemon loops: crash containment for background threads.

Every long-lived daemon thread in the serving stack (heartbeats, the
driver's liveness sweeper, engine ticks) shares one failure mode: an
unhandled exception silently kills the thread, and the process limps on
with its heartbeat/engine/sweeper gone. This module is the sanctioned
fix: :func:`run_supervised` wraps the loop body with catch + backoff +
restart accounting, and :func:`start_supervised` packages that into a
named daemon thread. ``ContinuousDecoder.serve_forever`` implements the
same contract inline (bounded consecutive failures, exponential backoff);
loops that route through here inherit it for free.

Restarts are visible, not silent: each contained crash increments
``mmlspark_supervised_loop_restarts_total{loop}`` and logs a
``supervised_loop_crash`` event with the exception repr.

The port's copy of ``mmlspark_tpu/reliability/loops.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..observability import counter as _metric_counter
from ..observability import log_event

__all__ = ["run_supervised", "start_supervised"]

M_LOOP_RESTARTS = _metric_counter(
    "mmlspark_supervised_loop_restarts_total",
    "Background-loop crashes contained and restarted, by loop name",
    ("loop",))


def run_supervised(tick: Callable[[], None], *, name: str,
                   stop: threading.Event,
                   interval: float = 0.0,
                   backoff: float = 0.05,
                   max_backoff: float = 2.0,
                   max_failures: Optional[int] = None) -> None:
    """Run ``tick()`` every ``interval`` seconds until ``stop`` is set.

    A tick that raises is contained: the crash is counted and logged, the
    loop sleeps an exponentially growing backoff (reset by the next clean
    tick), and ticking resumes. ``max_failures`` bounds *consecutive*
    failures — exceeding it ends the loop (logged as
    ``supervised_loop_gave_up``) rather than spinning on a permanently
    broken dependency; ``None`` retries forever (a heartbeat must outlive
    any driver outage).
    """
    delay = backoff
    failures = 0
    while not stop.wait(interval):
        try:
            tick()
            failures = 0
            delay = backoff
        except Exception as exc:
            failures += 1
            M_LOOP_RESTARTS.inc(loop=name)
            log_event("supervised_loop_crash", loop=name, error=repr(exc),
                      consecutive=failures)
            if max_failures is not None and failures >= max_failures:
                log_event("supervised_loop_gave_up", loop=name,
                          consecutive=failures)
                return
            if stop.wait(delay):
                return
            delay = min(delay * 2, max_backoff)


def start_supervised(tick: Callable[[], None], *, name: str,
                     stop: threading.Event,
                     interval: float = 0.0,
                     backoff: float = 0.05,
                     max_backoff: float = 2.0,
                     max_failures: Optional[int] = None) -> threading.Thread:
    """Start :func:`run_supervised` on a named daemon thread and return
    it (callers join it on shutdown after setting ``stop``)."""
    t = threading.Thread(
        target=run_supervised, name=name, daemon=True,
        kwargs=dict(tick=tick, name=name, stop=stop, interval=interval,
                    backoff=backoff, max_backoff=max_backoff,
                    max_failures=max_failures))
    t.start()
    return t
