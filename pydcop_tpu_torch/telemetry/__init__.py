"""Host-side telemetry of the port: the metrics registry, the span tracer,
the solver-health monitor (pulse), the Prometheus text of a snapshot
(``prom``), the SLO engine (``slo``), trace summaries and stitching
(``summary``, ``stitch``), fleet federation (``federate``), the memory
plane (``memplane``), each the port's own copy of the JAX package's
module of the same name; and profiling: the capture census, the
``torch.profiler`` session and its device annotations (``profiling``),
the per-op kernel blocks (``kernelprof``) and the capture bundles with
their regression diff (``perfdiff``); and the agent runtime's event bus
to metrics (``bridge``).  Stdlib only at import: the host-only verbs (``checkpoints``,
``postmortem``, ``telemetry``, ``watch``, ``capture diff``) import it
without touching torch."""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    metrics_registry,
)
from .tracing import Span, Tracer, traced, tracer
from .summary import (
    decimate_series,
    format_summary,
    load_trace,
    summarize_events,
    summarize_trace,
    validate_events,
)
from .prom import parse_prometheus_text, render_prometheus
from .slo import Objective, SloEngine, load_slo_file, parse_objective
from .federate import (
    FleetCollector,
    FleetSlo,
    FleetTarget,
    clamped_rate,
    targets_from_args,
    targets_from_fleet_file,
    targets_from_manifest,
)
from .kernelprof import ell_kernel_block, hbm_peak_gbps, mgm2_phase_block
from .perfdiff import (
    attribution_state,
    diff_records,
    diff_sides,
    format_attribution,
    format_diff,
    load_side,
)
from .pulse import (
    HEALTH_FIELDS,
    HEALTH_WIDTH,
    POSTMORTEM_FORMAT,
    FlightRecorder,
    PulseMonitor,
    analyze,
    analyze as analyze_pulse,
    flip_summary,
    load_postmortem,
    pulse,
    render_postmortem,
)
from .memplane import (
    DEVICE_GENERATIONS,
    MemoryBudgetExceeded,
    ProblemShape,
    device_limit_bytes,
    hbm_capacity_bytes,
    max_batch_k,
    max_vars_per_device,
    memguard,
    memory_status,
    predict_solve_bytes,
    sample_device_memory,
    shape_of,
    synthetic_shape,
)
from .stitch import flow_stats, stitch_traces
from .bridge import EventBusBridge, attach_event_bridge
from .profiling import (
    device_annotation,
    profiling,
    start_profiling,
    stop_profiling,
)

__all__ = [
    "EventBusBridge",
    "attach_event_bridge",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metrics_registry",
    "Span",
    "Tracer",
    "traced",
    "tracer",
    "format_summary",
    "load_trace",
    "summarize_events",
    "summarize_trace",
    "validate_events",
    "decimate_series",
    "render_prometheus",
    "parse_prometheus_text",
    "Objective",
    "SloEngine",
    "load_slo_file",
    "parse_objective",
    "FleetCollector",
    "FleetSlo",
    "FleetTarget",
    "clamped_rate",
    "targets_from_args",
    "targets_from_fleet_file",
    "targets_from_manifest",
    "flow_stats",
    "stitch_traces",
    "device_annotation",
    "profiling",
    "start_profiling",
    "stop_profiling",
    "HEALTH_FIELDS",
    "HEALTH_WIDTH",
    "POSTMORTEM_FORMAT",
    "FlightRecorder",
    "PulseMonitor",
    "analyze",
    "analyze_pulse",
    "flip_summary",
    "load_postmortem",
    "pulse",
    "render_postmortem",
    "telemetry_off",
    "ell_kernel_block",
    "hbm_peak_gbps",
    "mgm2_phase_block",
    "attribution_state",
    "diff_records",
    "diff_sides",
    "format_attribution",
    "format_diff",
    "load_side",
    "DEVICE_GENERATIONS",
    "MemoryBudgetExceeded",
    "ProblemShape",
    "device_limit_bytes",
    "hbm_capacity_bytes",
    "max_batch_k",
    "max_vars_per_device",
    "memguard",
    "memory_status",
    "predict_solve_bytes",
    "sample_device_memory",
    "shape_of",
    "synthetic_shape",
]


def telemetry_off() -> None:
    """Disable the singletons and clear their state: a test teardown
    helper (the registry keeps metric definitions, so held references
    stay live)."""
    tracer.enabled = False
    tracer.stream_to(None)
    tracer.service = None
    tracer.reset()
    metrics_registry.enabled = False
    metrics_registry.reset()
    pulse.enabled = False
    pulse.stream_close()
    pulse.reset()
