"""Prometheus text exposition (format version 0.0.4) for the registry
(the port's copy of ``mmlspark_tpu/observability/exposition.py``).

Stdlib-only renderer for `MetricsRegistry` — the serving plane returns
its output from ``GET /metrics``. Histogram buckets are rendered
cumulatively with an explicit ``+Inf`` bucket, ``_sum`` and ``_count``,
per the exposition spec.

When exemplars are enabled (``tracing.set_exemplars(True)`` installs a
registry-level provider), histogram bucket lines additionally carry the
OpenMetrics exemplar suffix ``# {trace_id="..."} value`` — the join key
from an aggregate latency bucket to the per-request span tree in the
flight recorder. With the provider unset (the default) the output is
byte-identical to plain 0.0.4 text.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

__all__ = ["CONTENT_TYPE", "render_prometheus"]


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f != f:  # NaN
        return "NaN"
    if f.is_integer() and abs(f) < 1e17:
        return str(int(f))
    return repr(f)


def _labelstr(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _exemplar_suffix(exemplars: Dict[int, Tuple[str, float]],
                     i: int) -> str:
    ex: Optional[Tuple[str, float]] = exemplars.get(i)
    if ex is None:
        return ""
    trace_id, value = ex
    return (f' # {{trace_id="{_escape_label(trace_id)}"}} '
            f"{_fmt_value(value)}")


def render_prometheus(registry) -> str:
    """Render every metric in `registry` as Prometheus text exposition."""
    from .registry import exemplar_provider
    with_exemplars = exemplar_provider() is not None
    lines = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for labels, series in m.series():
            if m.kind == "histogram":
                counts, total, count = series.get()
                exemplars = series.exemplars() if with_exemplars else {}
                acc = 0
                for i, (upper, c) in enumerate(zip(m.buckets, counts)):
                    acc += c
                    le = f'le="{_fmt_value(upper)}"'
                    lines.append(f"{m.name}_bucket{_labelstr(labels, le)} "
                                 f"{acc}{_exemplar_suffix(exemplars, i)}")
                inf_le = 'le="+Inf"'
                lines.append(f"{m.name}_bucket{_labelstr(labels, inf_le)} "
                             f"{count}"
                             f"{_exemplar_suffix(exemplars, len(m.buckets))}")
                lines.append(f"{m.name}_sum{_labelstr(labels)} "
                             f"{_fmt_value(total)}")
                lines.append(f"{m.name}_count{_labelstr(labels)} {count}")
            else:
                lines.append(f"{m.name}{_labelstr(labels)} "
                             f"{_fmt_value(series.get())}")
    return "\n".join(lines) + "\n" if lines else ""
