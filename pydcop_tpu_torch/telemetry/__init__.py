"""Host-side telemetry of the port: the metrics registry, the span tracer
and the solver-health monitor (pulse), each the port's own copy of the
JAX package's module of the same name.  Stdlib only: the host-only verbs
(``checkpoints``, ``postmortem``) import it without touching torch."""

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
]
