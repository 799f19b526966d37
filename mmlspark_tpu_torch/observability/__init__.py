"""Telemetry for the port (counterpart of ``mmlspark_tpu/observability/``).

Only the metrics registry is ported so far; the ledger charges, tracing
spans and watchdog of the JAX package are not (ROADMAP queue item 11).
"""

from .registry import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry, counter, gauge, get_registry,
                       histogram, reset_all, snapshot)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS", "counter", "gauge", "histogram",
           "get_registry", "snapshot", "reset_all"]
