"""Host-side telemetry of the port: the metrics registry, the span tracer,
the solver-health monitor (pulse), the Prometheus text of a snapshot
(``prom``), the SLO engine (``slo``), and trace summaries and stitching
(``summary``, ``stitch``), each the port's own copy of the JAX package's
module of the same name.  Stdlib only: the host-only verbs
(``checkpoints``, ``postmortem``, ``telemetry``, ``watch``) import it
without touching torch."""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    metrics_registry,
)
from .pulse import (
    HEALTH_FIELDS,
    HEALTH_WIDTH,
    POSTMORTEM_FORMAT,
    FlightRecorder,
    PulseMonitor,
    analyze,
    flip_summary,
    load_postmortem,
    pulse,
    render_postmortem,
)
from .prom import parse_prometheus_text, render_prometheus
from .slo import Objective, SloEngine, load_slo_file, parse_objective
from .stitch import flow_stats, stitch_traces
from .summary import (
    decimate_series,
    format_summary,
    load_trace,
    summarize_events,
    summarize_trace,
    validate_events,
)
from .tracing import Span, Tracer, traced, tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metrics_registry",
    "Span",
    "Tracer",
    "traced",
    "tracer",
    "HEALTH_FIELDS",
    "HEALTH_WIDTH",
    "POSTMORTEM_FORMAT",
    "FlightRecorder",
    "PulseMonitor",
    "analyze",
    "flip_summary",
    "load_postmortem",
    "pulse",
    "render_postmortem",
    "parse_prometheus_text",
    "render_prometheus",
    "Objective",
    "SloEngine",
    "load_slo_file",
    "parse_objective",
    "flow_stats",
    "stitch_traces",
    "decimate_series",
    "format_summary",
    "load_trace",
    "summarize_events",
    "summarize_trace",
    "validate_events",
]
