"""Retry / timeout helpers.

Parity surface: ``FaultToleranceUtils.retryWithTimeout``
(``core/.../core/utils/FaultToleranceUtils.scala:10-22``) and the exponential
backoff used around LightGBM network init (``TrainUtils.scala:280-296``,
constants ``LightGBMConstants.scala:49-56``).

The port's copy of ``mmlspark_tpu/utils/fault.py``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional, Sequence, TypeVar

T = TypeVar("T")

__all__ = ["retry_with_timeout", "retry_with_backoff"]

DEFAULT_WAITS_MS = (0, 100, 500, 1000, 3000, 5000)


def retry_with_timeout(fn: Callable[[], T], timeout_s: float,
                       retries: int = 3) -> T:
    """Run ``fn`` with a wall-clock timeout, retrying on failure/timeout."""
    # Bare daemon threads, not ThreadPoolExecutor: its atexit hook joins
    # worker threads, so a permanently hung fn would block interpreter exit
    # even after the timeout fired here.
    err: Optional[Exception] = None
    for _ in range(max(1, retries)):
        box: "queue.Queue" = queue.Queue(1)

        def run():
            try:
                box.put(("ok", fn()))
            except Exception as e:  # noqa: BLE001 — shipped to the caller
                box.put(("err", e))

        threading.Thread(target=run, daemon=True).start()
        try:
            kind, payload = box.get(timeout=timeout_s)
        except queue.Empty:
            err = TimeoutError(f"call exceeded {timeout_s}s")
            continue
        if kind == "ok":
            return payload
        err = payload
    raise err  # type: ignore[misc]


def retry_with_backoff(fn: Callable[[], T],
                       waits_ms: Sequence[int] = DEFAULT_WAITS_MS) -> T:
    """Retry with fixed backoff schedule (reference default waits)."""
    err: Optional[Exception] = None
    for wait in waits_ms:
        if wait:
            time.sleep(wait / 1e3)
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            err = e
    raise err  # type: ignore[misc]
