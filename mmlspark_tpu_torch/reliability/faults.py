"""Deterministic, seedable fault injection for chaos tests and drills
(the port's copy of ``mmlspark_tpu/reliability/faults.py``; the same
``MMLSPARK_TPU_FAULTS`` spec drives both packages).

Faults attach to named *sites* — ``peer_http``, ``heartbeat``,
``device_run``, ``enqueue`` — and can ``error`` (raise
:class:`InjectedFault`), ``delay`` (sleep), or ``corrupt`` (mangle the
payload) on a schedule. Scheduling is deterministic: each rule owns a
``random.Random(seed)`` and a call counter guarded by a lock, so a given
(spec, seed, call-order) triple always injects the same faults —
the chaos test in tests/test_serving_distributed.py relies on this.

The injector is a no-op passthrough when disabled: hot paths guard with
``if injector.enabled: injector.fire(site)`` and pay a single attribute
check in production.

Env spec (``MMLSPARK_TPU_FAULTS``), ``;``-separated rules of
``site:kind[:key=value...]``::

    peer_http:error:p=0.3:seed=42
    heartbeat:delay:every=3:seconds=0.05
    enqueue:error:times=2

Keys: ``p`` (probability, default 1.0), ``every`` (every Nth call),
``times`` (cap on total fires), ``seconds`` (delay duration),
``seed`` (rng seed, default 0).
"""

from __future__ import annotations

import os
import threading
import time
from random import Random
from typing import Dict, List, Optional

from ..observability.events import log_event as _log_event
from ..observability.registry import counter as _metric_counter

__all__ = ["FaultInjector", "FaultRule", "InjectedFault", "get_injector",
           "SITES"]

#: Named injection sites wired through the serving stack.
SITES = ("peer_http", "heartbeat", "device_run", "enqueue")

_KINDS = ("error", "delay", "corrupt")

_M_FAULTS = _metric_counter(
    "mmlspark_faults_injected_total",
    "Faults fired by the injector, by site and kind",
    ("site", "kind"))


class InjectedFault(ConnectionError):
    """Raised by an ``error`` rule. Subclasses ConnectionError so injected
    network faults take the same retry/breaker path as real ones."""

    def __init__(self, site: str, kind: str = "error"):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site
        self.kind = kind


class FaultRule:
    """One scheduled fault. ``decide()`` is called once per matching
    ``fire`` and is deterministic given the seed and call order."""

    def __init__(self, site: str, kind: str = "error", p: float = 1.0,
                 every: Optional[int] = None, times: Optional[int] = None,
                 seconds: float = 0.0, seed: int = 0):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (want {_KINDS})")
        self.site = site
        self.kind = kind
        self.p = float(p)
        self.every = int(every) if every is not None else None
        self.times = int(times) if times is not None else None
        self.seconds = float(seconds)
        self.seed = int(seed)
        self.calls = 0
        self.fires = 0
        self._rng = Random(self.seed)
        self._lock = threading.Lock()

    def decide(self) -> bool:
        with self._lock:
            self.calls += 1
            if self.times is not None and self.fires >= self.times:
                return False
            if self.every is not None and self.calls % self.every != 0:
                return False
            if self.p < 1.0 and self._rng.random() >= self.p:
                return False
            self.fires += 1
            return True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultRule({self.site}:{self.kind} p={self.p} "
                f"every={self.every} times={self.times} fires={self.fires})")


def _corrupt(payload):
    """Mangle a payload in a type-preserving, detectable way."""
    if payload is None:
        return None
    if isinstance(payload, dict):
        return {**payload, "_corrupted": True}
    if isinstance(payload, (bytes, bytearray)):
        return bytes(payload[:-1]) if payload else b"\x00"
    if isinstance(payload, str):
        return payload[:-1] if payload else "\x00"
    return payload


class FaultInjector:
    """Registry of :class:`FaultRule` keyed by site.

    ``enabled`` is a plain bool kept in sync with the rule table so the
    disabled fast path is one attribute read, no lock.
    """

    def __init__(self, sleep=time.sleep):
        self.enabled = False
        self._sleep = sleep
        self._rules: Dict[str, List[FaultRule]] = {}
        self._lock = threading.Lock()

    # -- configuration -----------------------------------------------------
    def add(self, site: str, kind: str = "error", **kwargs) -> FaultRule:
        rule = FaultRule(site, kind, **kwargs)
        with self._lock:
            self._rules.setdefault(site, []).append(rule)
            self.enabled = True
        return rule

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()
            self.enabled = False

    def configure(self, spec: str) -> None:
        """Parse an ``MMLSPARK_TPU_FAULTS``-style spec (see module doc).
        Raises ValueError on bad grammar."""
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            if len(parts) < 2:
                raise ValueError(f"fault spec entry {entry!r}: "
                                 "want site:kind[:key=value...]")
            site, kind, kwargs = parts[0], parts[1], {}
            for field in parts[2:]:
                key, sep, value = field.partition("=")
                if not sep or key not in ("p", "every", "times",
                                          "seconds", "seed"):
                    raise ValueError(
                        f"fault spec entry {entry!r}: bad field {field!r}")
                try:
                    kwargs[key] = (float(value) if key in ("p", "seconds")
                                   else int(value))
                except ValueError:
                    raise ValueError(f"fault spec entry {entry!r}: "
                                     f"non-numeric value in {field!r}")
            self.add(site, kind, **kwargs)

    def rules(self, site: Optional[str] = None) -> List[FaultRule]:
        with self._lock:
            if site is not None:
                return list(self._rules.get(site, ()))
            return [r for rs in self._rules.values() for r in rs]

    # -- hot path ----------------------------------------------------------
    def fire(self, site: str, payload=None):
        """Apply all matching rules at ``site``; returns the (possibly
        corrupted) payload or raises :class:`InjectedFault`."""
        if not self.enabled:
            return payload
        with self._lock:
            rules = list(self._rules.get(site, ()))
        for rule in rules:
            if not rule.decide():
                continue
            _M_FAULTS.inc(site=site, kind=rule.kind)
            if rule.kind == "error":
                raise InjectedFault(site)
            if rule.kind == "delay":
                self._sleep(rule.seconds)
            else:
                payload = _corrupt(payload)
        return payload


_INJECTOR = FaultInjector()


def get_injector() -> FaultInjector:
    """The process-wide injector (configured from ``MMLSPARK_TPU_FAULTS``
    at import, if set)."""
    return _INJECTOR


_spec = os.environ.get("MMLSPARK_TPU_FAULTS", "")
if _spec:
    try:
        _INJECTOR.configure(_spec)
    except ValueError as exc:
        # a typo'd drill spec must not take the worker down with it
        _log_event("fault_spec_invalid", spec=_spec, error=str(exc))
del _spec
