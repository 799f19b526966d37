"""Structured JSON event log on top of stdlib logging (the port's copy of
``mmlspark_tpu/observability/events.py``).

One event = one JSON object on one log line, under the
``mmlspark_tpu_torch.events`` logger. The journal, the shed path and the
serving loops emit through :func:`log_event`; the HTTP access lines go
here at DEBUG, so raising the logger's level shows them without a code
edit.

Every emit also increments ``mmlspark_events_total{level=...}`` — even
when the logger level filters the line out — so tests and /metrics see
event traffic without configuring logging handlers. The reference
stamps the active trace and request ids onto each record; the port has
no tracing spans yet (ROADMAP.md queue item 11).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

from .registry import counter as _counter

LOGGER_NAME = "mmlspark_tpu_torch.events"

__all__ = ["LOGGER_NAME", "EventLog", "get_event_log", "log_event"]

_M_EVENTS = _counter(
    "mmlspark_events_total",
    "Structured events emitted through the JSON event log",
    ("level",))


class EventLog:
    """Emit structured events as single-line JSON log records."""

    def __init__(self, logger: Optional[logging.Logger] = None) -> None:
        self._logger = logger or logging.getLogger(LOGGER_NAME)

    def emit(self, event: str, level: int = logging.INFO,
             **fields: object) -> None:
        """Log ``{"event": ..., "ts": ..., **fields}`` at ``level``. Never
        raises: telemetry must not take down the component emitting it
        (e.g. an HTTP handler mid-response)."""
        try:
            _M_EVENTS.inc(level=logging.getLevelName(level).lower())
            if not self._logger.isEnabledFor(level):
                return
            record = {"event": event, "ts": time.time()}
            record.update(fields)
            self._logger.log(level, "%s",
                             json.dumps(record, sort_keys=True, default=str))
        except Exception:
            pass


_EVENT_LOG = EventLog()


def get_event_log() -> EventLog:
    return _EVENT_LOG


def log_event(event: str, level: int = logging.INFO,
              **fields: object) -> None:
    _EVENT_LOG.emit(event, level, **fields)
