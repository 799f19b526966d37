"""Telemetry for the port (counterpart of ``mmlspark_tpu/observability/``).

Ported so far: the metrics registry, the structured event log
(:mod:`.events`) and the Prometheus exposition (:mod:`.exposition`); the
ledger charges, tracing spans, SLO tracker, time-series sampler and
watchdog of the JAX package are not (ROADMAP queue item 11).
"""

from .events import log_event
from .exposition import CONTENT_TYPE, render, render_prometheus
from .registry import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry, counter, gauge, get_registry,
                       histogram, reset_all, snapshot)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS", "counter", "gauge", "histogram",
           "get_registry", "snapshot", "reset_all", "log_event",
           "CONTENT_TYPE", "render", "render_prometheus"]
