"""Prometheus text exposition (format version 0.0.4) for the registry
(the port's copy of ``mmlspark_tpu/observability/exposition.py``,
without the OpenMetrics exemplars, which need tracing spans: ROADMAP.md
queue item 11).

The serving plane returns :func:`render` from ``GET /metrics``.
Histogram buckets are rendered cumulatively with an explicit ``+Inf``
bucket, ``_sum`` and ``_count``, per the exposition spec.
"""

from __future__ import annotations

from typing import Dict

from .registry import get_registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

__all__ = ["CONTENT_TYPE", "render", "render_prometheus"]


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


def render_prometheus(registry) -> str:
    """Render every metric in ``registry`` as Prometheus text exposition."""
    lines = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for labels, series in m.series():
            if m.kind == "histogram":
                counts, total, count = series.get()
                acc = 0
                for upper, c in zip(m.buckets, counts):
                    acc += c
                    le = f'le="{_fmt_value(upper)}"'
                    lines.append(f"{m.name}_bucket{_labelstr(labels, le)} "
                                 f"{acc}")
                inf_le = 'le="+Inf"'
                lines.append(f"{m.name}_bucket{_labelstr(labels, inf_le)} "
                             f"{count}")
                lines.append(f"{m.name}_sum{_labelstr(labels)} "
                             f"{_fmt_value(total)}")
                lines.append(f"{m.name}_count{_labelstr(labels)} {count}")
            else:
                lines.append(f"{m.name}{_labelstr(labels)} "
                             f"{_fmt_value(series.get())}")
    return "\n".join(lines) + "\n" if lines else ""


def render() -> str:
    """The process registry as Prometheus text."""
    return render_prometheus(get_registry())
