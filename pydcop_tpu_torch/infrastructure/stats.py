"""Dormant per-step trace logging.

The port's copy of ``pydcop_tpu/infrastructure/stats.py``: a CSV trace
of per-computation steps (duration, message counts and sizes, and the
operation counts ``op_count``/``nc_op_count``), switched off unless a
stats file is set, and the metrics registry's twins of its columns.
The device solve has no per-step Python bookkeeping; ``torch.profiler``
sessions (``telemetry/profiling.py``) cover the device's view.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, TextIO

from ..telemetry.metrics import metrics_registry

__all__ = [
    "columns",
    "set_stats_file",
    "trace_computation",
    "stats_enabled",
    "trace_active",
]

# Registry twins of the CSV columns (handles created once at import; every
# write is flag-gated).  A row is routed to BOTH sinks independently: the
# CSV needs set_stats_file, the metrics need metrics_registry.enabled.
_m_steps = metrics_registry.counter(
    "stats.steps", "computation steps traced, by computation"
)
_m_step_seconds = metrics_registry.histogram(
    "stats.step_seconds", "per-step handler duration, by computation"
)
_m_msg_count = metrics_registry.counter(
    "stats.msg_count", "messages handled in traced steps, by computation"
)
_m_msg_size = metrics_registry.counter(
    "stats.msg_size", "message bytes handled in traced steps, by computation"
)
_m_op_count = metrics_registry.counter(
    "stats.op_count", "constraint-check operations, by computation"
)
_m_nc_op_count = metrics_registry.counter(
    "stats.nc_op_count", "non-concurrent operations, by computation"
)

columns: List[str] = [
    "time",
    "computation",
    "cycle",
    "duration",
    "msg_count",
    "msg_size",
    "op_count",
    "nc_op_count",
]

_lock = threading.Lock()
_file: Optional[TextIO] = None
logging_enabled = False


def stats_enabled() -> bool:
    return logging_enabled


def trace_active() -> bool:
    """True when a trace_computation row would reach ANY sink — callers use
    this to decide whether to pay for per-step timing."""
    return logging_enabled or metrics_registry.enabled


def set_stats_file(path: Optional[str]) -> None:
    """Open ``path`` for trace rows (CSV, header written once); ``None``
    disables tracing."""
    global _file, logging_enabled
    with _lock:
        if _file is not None:
            _file.close()
            _file = None
        if path is None:
            logging_enabled = False
            return
        _file = open(path, "w", encoding="utf-8")
        _file.write(",".join(columns) + "\n")
        logging_enabled = True


def trace_computation(
    computation: str,
    cycle: int,
    duration: float,
    msg_count: int = 0,
    msg_size: int = 0,
    op_count: int = 0,
    nc_op_count: int = 0,
) -> None:
    if metrics_registry.enabled:
        _m_steps.inc(computation=computation)
        _m_step_seconds.observe(duration, computation=computation)
        if msg_count:
            _m_msg_count.inc(msg_count, computation=computation)
        if msg_size:
            _m_msg_size.inc(msg_size, computation=computation)
        if op_count:
            _m_op_count.inc(op_count, computation=computation)
        if nc_op_count:
            _m_nc_op_count.inc(nc_op_count, computation=computation)
    if not logging_enabled:
        return
    row = [
        f"{time.time():.6f}",
        computation,
        str(cycle),
        f"{duration:.6f}",
        str(msg_count),
        str(msg_size),
        str(op_count),
        str(nc_op_count),
    ]
    with _lock:
        if _file is not None:
            _file.write(",".join(row) + "\n")
            _file.flush()
