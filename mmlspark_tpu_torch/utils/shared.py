"""Per-process lazy singletons.

Parity surface: ``SharedVariable``/``SharedSingleton``
(``core/.../io/http/SharedVariable.scala:18,37``) — the reference's idiom for
non-serializable state (HTTP clients, native handles) shared by all tasks in a
JVM. Here: shared by all threads in the process, created once under a lock.

The port's copy of ``mmlspark_tpu/utils/shared.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Generic, TypeVar

T = TypeVar("T")

__all__ = ["SharedVariable", "SharedSingleton", "StopWatch"]


class SharedVariable(Generic[T]):
    """Lazily-constructed process-wide value."""

    def __init__(self, factory: Callable[[], T]):
        self._factory = factory
        self._lock = threading.Lock()
        self._value: T = None  # type: ignore[assignment]
        self._created = False

    def get(self) -> T:
        if not self._created:
            with self._lock:
                if not self._created:
                    self._value = self._factory()
                    self._created = True
        return self._value

    def clear(self) -> None:
        with self._lock:
            self._created = False
            self._value = None  # type: ignore[assignment]


class SharedSingleton:
    """Keyed registry of shared values (reference keys by constructor site)."""

    _instances: Dict[str, SharedVariable] = {}
    _lock = threading.Lock()

    @classmethod
    def get(cls, key: str, factory: Callable[[], T]) -> T:
        with cls._lock:
            if key not in cls._instances:
                cls._instances[key] = SharedVariable(factory)
        return cls._instances[key].get()

    @classmethod
    def reset(cls, key: str = None) -> None:
        with cls._lock:
            if key is None:
                cls._instances.clear()
            else:
                cls._instances.pop(key, None)


class StopWatch:
    """Accumulating wall-clock timer (reference: ``core/utils/StopWatch.scala``,
    feeding VW's per-partition ``TrainingStats``)."""

    def __init__(self):
        self.elapsed_ns = 0
        self._start = None

    def start(self) -> None:
        import time
        self._start = time.perf_counter_ns()

    def stop(self) -> None:
        import time
        if self._start is not None:
            # reference-parity wall timer:
            # VW's TrainingStats consumes elapsed_ns directly (per
            # partition, reported through the model's own stats surface);
            # callers needing fleet visibility time at their own call
            # sites via mmlspark_tpu_torch.observability
            self.elapsed_ns += time.perf_counter_ns() - self._start
            self._start = None

    def measure(self, fn: Callable[[], T]) -> T:
        self.start()
        try:
            return fn()
        finally:
            self.stop()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def elapsed_s(self) -> float:
        return self.elapsed_ns / 1e9
