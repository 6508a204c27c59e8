"""Trace-file loading, schema validation and summarization.

The port's own copy of ``pydcop_tpu/telemetry/summary.py``, unchanged:
the port's ``telemetry`` verb summarizes a trace of either package.

Backs the ``pydcop_tpu telemetry`` CLI verb and ``make trace-smoke``:
reads a Chrome trace-event JSON (``{"traceEvents": [...]}``) or a JSONL
stream (one event per line), checks the event schema, and aggregates spans
per name (count / total / mean / max duration) so "where did the
wall-clock go?" has a one-command answer without opening Perfetto.

Stdlib-only, same constraint as ``telemetry.metrics``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

__all__ = [
    "load_trace",
    "validate_events",
    "summarize_events",
    "summarize_trace",
    "format_summary",
    "decimate_series",
]


def decimate_series(values, points: int) -> list:
    """Stride-decimate a series to at most ``points`` (+1) entries,
    always keeping the LAST point — for an anytime cost curve the final
    entry is the current incumbent, which decimation must never drop.
    The one implementation behind the bench-record curve, the ``/status``
    payload and the ``watch`` sparkline, so their boundary behavior
    cannot drift apart."""
    vals = list(values)
    if len(vals) <= points:
        return vals
    step = (len(vals) + points - 1) // points
    out = vals[::step]
    if (len(vals) - 1) % step:
        out.append(vals[-1])
    return out

# phases this exporter emits; validation rejects events outside this set so
# trace-smoke catches format drift the moment an instrumentation site changes
# ("s"/"t"/"f" are the graftwatch message-flow events, telemetry.tracing)
_KNOWN_PHASES = {"X", "i", "M", "s", "t", "f"}
_FLOW_PHASES = {"s", "t", "f"}


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Events from a Chrome trace JSON object, a bare JSON event array, or
    a JSONL stream; raises ValueError on anything else."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    stripped = text.lstrip()
    if not stripped:
        raise ValueError(f"{path}: empty trace file")
    if stripped[0] in "[{":
        try:
            payload = json.loads(text)
        except json.JSONDecodeError:
            payload = None
        if isinstance(payload, dict):
            events = payload.get("traceEvents")
            if isinstance(events, list):
                return events
            if "ph" in payload:  # a one-line JSONL stream
                return [payload]
            raise ValueError(
                f"{path}: JSON object without a traceEvents array"
            )
        if isinstance(payload, list):
            return payload
    # JSONL: one JSON object per line.  A truncated FINAL line is
    # tolerated — a streaming process (tracer.stream_to) that died
    # mid-write is exactly the crash-diagnosis case the stream exists
    # for, and the intact events before it are the evidence
    lines = [
        (i, ln.strip())
        for i, ln in enumerate(text.splitlines(), 1)
        if ln.strip()
    ]
    events = []
    for pos, (i, line) in enumerate(lines):
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError as e:
            if pos == len(lines) - 1 and events:
                break  # partial trailing line from an interrupted stream
            raise ValueError(f"{path}:{i}: not valid JSON[L]: {e}") from e
    return events


def validate_events(events: List[Dict[str, Any]]) -> List[str]:
    """Schema errors (empty list = valid Chrome trace events)."""
    errors: List[str] = []
    if not events:
        return ["trace contains no events"]
    for i, e in enumerate(events):
        where = f"event {i}"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _KNOWN_PHASES:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e.get("name"):
            errors.append(f"{where}: missing name")
        if ph == "M":
            continue  # metadata events carry no timestamps
        if ph in _FLOW_PHASES and e.get("id") is None:
            errors.append(f"{where} ({e.get('name')}): flow event without id")
        for key in ("ts",) + (("dur",) if ph == "X" else ()):
            v = e.get(key)
            if not isinstance(v, (int, float)) or v < 0:
                errors.append(f"{where} ({e.get('name')}): bad {key}: {v!r}")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                errors.append(
                    f"{where} ({e.get('name')}): bad {key}: {e.get(key)!r}"
                )
        if len(errors) >= 20:
            errors.append("... (further errors suppressed)")
            break
    return errors


def summarize_events(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-name aggregates over complete spans + instant counts."""
    spans: Dict[str, Dict[str, Any]] = {}
    instants: Dict[str, int] = {}
    t_min, t_max = float("inf"), float("-inf")
    for e in events:
        if not isinstance(e, dict):
            continue
        ph = e.get("ph")
        name = e.get("name")
        if not isinstance(name, str):
            continue  # malformed: validate_events reports it
        if ph == "X":
            ts, dur = e.get("ts"), e.get("dur")
            if not isinstance(ts, (int, float)) or not isinstance(
                dur, (int, float)
            ):
                continue  # malformed: validate_events reports it
            ts, dur = float(ts), float(dur)
            t_min = min(t_min, ts)
            t_max = max(t_max, ts + dur)
            s = spans.setdefault(
                name,
                {"count": 0, "total_ms": 0.0, "max_ms": 0.0},
            )
            s["count"] += 1
            s["total_ms"] += dur / 1000.0
            s["max_ms"] = max(s["max_ms"], dur / 1000.0)
        elif ph == "i":
            instants[name] = instants.get(name, 0) + 1
            ts = e.get("ts")
            if isinstance(ts, (int, float)):
                t_min = min(t_min, float(ts))
                t_max = max(t_max, float(ts))
    wall_ms = (t_max - t_min) / 1000.0 if t_max > t_min else 0.0
    for s in spans.values():
        s["mean_ms"] = s["total_ms"] / s["count"]
        s["wall_pct"] = (
            100.0 * s["total_ms"] / wall_ms if wall_ms > 0 else None
        )
    out = {
        "events": len(events),
        "wall_ms": wall_ms,
        "spans": dict(
            sorted(
                spans.items(),
                key=lambda kv: kv[1]["total_ms"],
                reverse=True,
            )
        ),
        "instants": dict(sorted(instants.items())),
    }
    from .stitch import flow_stats

    flows = flow_stats(events)
    if flows["sends"]:
        out["flows"] = flows
    return out


def summarize_trace(path: str) -> Tuple[Dict[str, Any], List[str]]:
    """(summary, schema_errors) for a trace file.  Validation runs first
    and summarization skips whatever it flagged, so a malformed trace is
    reported, never fatal."""
    events = load_trace(path)
    errors = validate_events(events)
    return summarize_events(events), errors


def format_summary(summary: Dict[str, Any], top: int = 20) -> str:
    """Human-readable table, heaviest span names first."""
    lines = [
        f"events: {summary['events']}   wall: {summary['wall_ms']:.2f} ms",
        "",
        f"{'span':<40} {'count':>7} {'total ms':>10} {'mean ms':>9} "
        f"{'max ms':>9} {'% wall':>7}",
    ]
    for name, s in list(summary["spans"].items())[:top]:
        pct = f"{s['wall_pct']:.1f}" if s["wall_pct"] is not None else "-"
        lines.append(
            f"{name:<40} {s['count']:>7} {s['total_ms']:>10.3f} "
            f"{s['mean_ms']:>9.3f} {s['max_ms']:>9.3f} {pct:>7}"
        )
    if summary["instants"]:
        lines.append("")
        lines.append(f"{'instant':<40} {'count':>7}")
        for name, n in list(summary["instants"].items())[:top]:
            lines.append(f"{name:<40} {n:>7}")
    flows = summary.get("flows")
    if flows:
        lines.append("")
        lines.append(
            f"message flows: {flows['sends']} sent, "
            f"{flows['consumed']} consumed, "
            f"{flows['matched']} matched"
            + (
                f" ({flows['match_pct']:.1f}%)"
                if flows["match_pct"] is not None
                else ""
            )
        )
    return "\n".join(lines)
