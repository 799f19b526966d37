"""Structured JSON event log on top of stdlib logging (the port's copy of
``mmlspark_tpu/observability/events.py``).

One event = one JSON object on one log line, under the
``mmlspark_tpu_torch.events`` logger. Components emit through `log_event`
instead of ad-hoc ``print``/silenced handlers — notably the serving
plane's HTTP access lines (serving/server.py routes its suppressed
``log_message`` here at DEBUG, so request errors stay diagnosable by
raising the logger level rather than editing code).

Every emit also increments ``mmlspark_events_total{level=...}`` — even
when the logger level filters the line out — so tests and /metrics can
see event traffic without configuring logging handlers.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

from .registry import counter as _counter
from .tracing import (current_request_id as _current_request_id,
                      current_trace_id as _current_trace_id)

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
        """Log ``{"event": ..., "ts": ..., **fields}`` at `level`.

        When a trace context is active, ``trace_id``/``request_id`` are
        stamped onto the record (explicit fields win), so event lines join
        against /debug/traces span trees and journal entries.

        Never raises — telemetry must not take down the component
        emitting it (e.g. an HTTP handler mid-response).
        """
        try:
            _M_EVENTS.inc(level=logging.getLevelName(level).lower())
            if not self._logger.isEnabledFor(level):
                return
            record = {"event": event, "ts": time.time()}
            trace_id = _current_trace_id()
            if trace_id is not None:
                record["trace_id"] = trace_id
                request_id = _current_request_id()
                if request_id is not None:
                    record["request_id"] = request_id
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
