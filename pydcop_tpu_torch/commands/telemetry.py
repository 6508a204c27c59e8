"""``telemetry``: summarize, validate or stitch traces; convert metrics.

Counterpart of ``pydcop_tpu/commands/telemetry.py``, with its output and
exit codes: over a trace of ``solve --trace-out`` (or the ``serve``
spans), the count, total, mean and max duration of each span name, the
instant-event and flow counts, and Chrome trace-event schema validation
(``--validate`` exits 1 on an error).

- ``telemetry stitch -o merged.json a.json b.json ...`` merges
  per-process trace files into one timeline (``telemetry/stitch.py``); a
  directory argument expands to its trace files, unreadable ones skipped
  and named;
- ``telemetry --prom snapshot.json [--openmetrics]`` converts a
  ``--metrics-out`` snapshot to Prometheus text, the formatter the live
  ``/metrics`` serves;
- ``telemetry --metrics snapshot.json`` prints its reliability,
  compile/device, SLO/serve and memory sections.

Host-only: it imports no torch and needs no card.
"""

from __future__ import annotations

import logging
import sys

from ._utils import write_output

logger = logging.getLogger("pydcop_tpu_torch.cli.telemetry")


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "telemetry",
        help="summarize, validate or stitch traces; convert metrics",
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "trace_file", nargs="*", default=[],
        help="Chrome trace-event JSON or JSONL file (from --trace-out); "
        "or `stitch FILE... -o merged.json` to merge per-process trace "
        "files into one timeline (list the files before -o; a directory "
        "expands to its *.json/*.jsonl files, unreadable ones skipped)",
    )
    parser.add_argument(
        "-o", "--out", default=None, metavar="FILE",
        help="output file: the stitched trace (stitch mode) or the "
        "Prometheus text (--prom); stdout otherwise",
    )
    parser.add_argument(
        "--prom", default=None, metavar="FILE",
        help="convert a --metrics-out JSON snapshot to Prometheus text "
        "format (written to -o/--out or stdout)",
    )
    parser.add_argument(
        "--openmetrics", action="store_true",
        help="with --prom: emit OpenMetrics 1.0 (exemplars, # EOF "
        "terminator) instead of classic text 0.0.4",
    )
    parser.add_argument(
        "--metrics", default=None, metavar="FILE",
        help="metrics snapshot JSON (from --metrics-out): prints a "
        "reliability section (send failures, retries, dead letters, "
        "injected chaos events), a compile/device section (device "
        "windows), an SLO/serve section and a memory section (live "
        "gauges, predicted bytes, refusal counters)",
    )
    parser.add_argument(
        "--top", type=int, default=20,
        help="how many span names to list (heaviest first)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the summary as JSON instead of a table",
    )
    parser.add_argument(
        "--validate", action="store_true",
        help="exit non-zero when the trace fails schema validation",
    )


#: metrics whose non-zero values mean messages were lost, retried or
#: injected — the counters an operator checks after a bad run
RELIABILITY_METRICS = (
    "comms.send_failures",
    "comms.retry_attempts",
    "comms.dead_letters",
    "comms.parked_depth",
    "chaos.events",
)


def _load_snapshot(metrics_file: str) -> dict:
    import json

    with open(metrics_file, "r", encoding="utf-8") as f:
        return json.load(f)


def _label_join(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _compile_summary(snapshot: dict):
    """Compile and device rows of a --metrics-out snapshot: every
    ``compile.*``, ``device.*`` and ``mesh.*`` series (counters and gauges
    as they are, histograms as count and total)."""
    rows = []
    for name in sorted(snapshot.get("metrics", {})):
        if not name.startswith(("compile.", "device.", "mesh.")):
            continue
        m = snapshot["metrics"][name]
        for entry in m.get("values", []):
            labels = _label_join(entry.get("labels", {}))
            v = entry.get("value")
            if m.get("kind") == "histogram" and isinstance(v, dict):
                rows.append({
                    "metric": name, "labels": labels,
                    "value": int(v.get("count", 0)),
                    "total": round(float(v.get("sum", 0.0)), 6),
                })
            else:
                rows.append(
                    {"metric": name, "labels": labels, "value": v}
                )
    return rows


def _slo_summary(snapshot: dict):
    """SLO and serve rows of a --metrics-out snapshot: every ``slo.*``
    series plus the serve saturation gauges, so budget/burn/alert state
    reads straight off a dumped snapshot."""
    rows = []
    for name in sorted(snapshot.get("metrics", {})):
        if not name.startswith(("slo.", "serve.")):
            continue
        m = snapshot["metrics"][name]
        for entry in m.get("values", []):
            labels = _label_join(entry.get("labels", {}))
            v = entry.get("value")
            if m.get("kind") == "histogram" and isinstance(v, dict):
                rows.append({
                    "metric": name, "labels": labels,
                    "value": int(v.get("count", 0)),
                    "total": round(float(v.get("sum", 0.0)), 6),
                })
            else:
                rows.append(
                    {"metric": name, "labels": labels, "value": v}
                )
    return rows


def _memory_summary(snapshot: dict):
    """Memory rows of a --metrics-out snapshot: every ``mem.*``
    series (live-plane gauges, predicted bytes, refusal / degradation
    counters), so "did it fit, and who got refused?" reads straight off
    the summary."""
    rows = []
    for name in sorted(snapshot.get("metrics", {})):
        if not name.startswith("mem."):
            continue
        m = snapshot["metrics"][name]
        for entry in m.get("values", []):
            labels = _label_join(entry.get("labels", {}))
            v = entry.get("value")
            if m.get("kind") == "histogram" and isinstance(v, dict):
                rows.append({
                    "metric": name, "labels": labels,
                    "value": int(v.get("count", 0)),
                    "total": round(float(v.get("sum", 0.0)), 6),
                })
            else:
                rows.append(
                    {"metric": name, "labels": labels, "value": v}
                )
    return rows


def _reliability_summary(snapshot: dict):
    """(rows, total_failures) from a --metrics-out snapshot: one row per
    (metric, labels) of the reliability set."""
    metrics = snapshot.get("metrics", {})
    rows = []
    failures = 0
    for name in RELIABILITY_METRICS:
        m = metrics.get(name)
        if not m:
            continue
        for entry in m.get("values", []):
            labels = ",".join(
                f"{k}={v}" for k, v in sorted(entry["labels"].items())
            )
            rows.append(
                {"metric": name, "labels": labels, "value": entry["value"]}
            )
            if name in ("comms.send_failures", "comms.dead_letters"):
                failures += int(entry["value"])
    return rows, failures


def _stitch_cmd(args) -> int:
    """``telemetry stitch -o OUT file-or-dir...``: merge per-process
    traces.  A directory argument expands to its trace files (sorted
    ``*.json`` + ``*.jsonl`` — the per-agent ``trace.json.<agent>.json``
    family a multi-process run leaves behind); unreadable files are
    skipped and reported rather than aborting the stitch."""
    import glob as _glob
    import json
    import os

    from ..telemetry.stitch import stitch_traces

    inputs = []
    for p in args.trace_file[1:]:
        if os.path.isdir(p):
            found = sorted(
                _glob.glob(os.path.join(p, "*.json"))
                + _glob.glob(os.path.join(p, "*.jsonl"))
            )
            if not found:
                print(
                    f"error: no *.json / *.jsonl trace files in {p}",
                    file=sys.stderr,
                )
                return 2
            inputs += found
        else:
            inputs.append(p)
    if not inputs:
        print("error: stitch needs at least one trace file", file=sys.stderr)
        return 2
    if not args.out:
        print(
            "error: stitch needs -o/--out for the merged trace",
            file=sys.stderr,
        )
        return 2
    try:
        trace, report = stitch_traces(inputs, skip_unreadable=True)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for s in report.get("skipped", []):
        print(f"skipped {s['path']}: {s['error']}", file=sys.stderr)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(trace, f)
        f.write("\n")
    if args.as_json:
        write_output(args, report)
    else:
        for entry in report["files"]:
            print(
                f"{entry['path']}: {entry['events']} events"
                f"{' (' + entry['service'] + ')' if entry['service'] else ''}"
                f", epoch shift {entry['epoch_shift_us']:.0f} us"
                f", clock offset {entry['clock_offset_us']:.0f} us"
            )
        flows = report["flows"]
        pct = flows["match_pct"]
        print(
            f"flows: {flows['sends']} sends, {flows['matched']} matched"
            + (f" ({pct:.1f}%)" if pct is not None else "")
        )
        print(f"stitched trace -> {args.out}")
    return 0


def _prom_cmd(args) -> int:
    """``telemetry --prom FILE``: metrics snapshot -> Prometheus text."""
    import json

    from ..telemetry.prom import render_prometheus

    try:
        with open(args.prom, "r", encoding="utf-8") as f:
            snapshot = json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    text = render_prometheus(snapshot, openmetrics=args.openmetrics)
    # -o/--out (subparser) or the global --output both name a file;
    # stdout otherwise
    output = args.out or getattr(args, "output", None)
    if output:
        with open(output, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def run_cmd(args, timeout: float = None) -> int:
    from ..telemetry import format_summary, summarize_trace

    if args.trace_file and args.trace_file[0] == "stitch":
        return _stitch_cmd(args)
    if args.prom is not None:
        return _prom_cmd(args)
    if len(args.trace_file) > 1:
        print(
            "error: one trace file at a time (use `telemetry stitch` to "
            "merge several)", file=sys.stderr,
        )
        return 2
    trace_file = args.trace_file[0] if args.trace_file else None
    if trace_file is None and args.metrics is None:
        print(
            "error: nothing to summarize — give a trace file and/or "
            "--metrics FILE", file=sys.stderr,
        )
        return 2
    if args.validate and trace_file is None:
        print(
            "error: --validate needs a trace file to validate",
            file=sys.stderr,
        )
        return 2

    out = {}
    rc = 0
    if args.metrics is not None:
        try:
            snapshot = _load_snapshot(args.metrics)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        rows, failures = _reliability_summary(snapshot)
        out["reliability"] = {"rows": rows, "message_failures": failures}
        out["compile"] = _compile_summary(snapshot)
        slo_rows = _slo_summary(snapshot)
        if slo_rows:
            out["slo"] = slo_rows
        mem_rows = _memory_summary(snapshot)
        if mem_rows:
            out["memory"] = mem_rows

    summary = errors = None
    if trace_file is not None:
        try:
            summary, errors = summarize_trace(trace_file)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        out["summary"] = summary
        out["schema_errors"] = errors

    if args.as_json:
        write_output(args, out)
    else:
        if summary is not None:
            print(format_summary(summary, top=args.top))
            if errors:
                print(f"\nschema errors ({len(errors)}):", file=sys.stderr)
                for err in errors[:10]:
                    print(f"  {err}", file=sys.stderr)
        if "reliability" in out:
            rel = out["reliability"]
            print(f"\n{'reliability metric':<40} {'value':>10}")
            for row in rel["rows"]:
                label = f"{row['metric']}{{{row['labels']}}}"
                print(f"{label:<40} {row['value']:>10g}")
            if not rel["rows"]:
                print("  (no reliability metrics recorded)")
            print(f"message failures (lost/abandoned): {rel['message_failures']}")
        if "compile" in out:
            print(f"\n{'compile/device metric':<56} {'value':>12}")
            for row in out["compile"]:
                label = row["metric"]
                if row["labels"]:
                    label += "{" + row["labels"] + "}"
                extra = (
                    f"  (total {row['total']:g})" if "total" in row else ""
                )
                print(f"{label:<56} {row['value']:>12g}{extra}")
            if not out["compile"]:
                print("  (no compile/device metrics recorded — "
                      "produce the snapshot with --metrics-out)")
        if out.get("slo"):
            print(f"\n{'slo/serve metric':<56} {'value':>12}")
            for row in out["slo"]:
                label = row["metric"]
                if row["labels"]:
                    label += "{" + row["labels"] + "}"
                extra = (
                    f"  (total {row['total']:g})" if "total" in row else ""
                )
                print(f"{label:<56} {row['value']:>12g}{extra}")
        if out.get("memory"):
            print(f"\n{'memory metric':<56} {'value':>12}")
            for row in out["memory"]:
                label = row["metric"]
                if row["labels"]:
                    label += "{" + row["labels"] + "}"
                extra = (
                    f"  (total {row['total']:g})" if "total" in row else ""
                )
                print(f"{label:<56} {row['value']:>12g}{extra}")
    if args.validate and errors:
        rc = 1
    return rc
