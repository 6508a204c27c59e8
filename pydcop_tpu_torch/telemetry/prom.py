"""Prometheus / OpenMetrics text exposition of a metrics-registry snapshot.

The port's own copy of ``pydcop_tpu/telemetry/prom.py``, unchanged: the
serve front's ``/metrics`` and the ``telemetry --prom`` verb render the
JAX package's text byte for byte.

ONE formatter feeds both surfaces: the live orchestrator ``/metrics``
endpoint (``infrastructure/ui.py:MetricsHttpServer``) and the offline
``pydcop_tpu telemetry --prom FILE`` converter for ``--metrics-out``
snapshots — so a dashboard built against a live run scrapes the exact
series a post-mortem file replays.

Mapping (classic text format version 0.0.4, the default):

- metric names are sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (dots in the
  registry's dotted names become underscores);
- counters gain the conventional ``_total`` suffix;
- histograms expose cumulative ``_bucket{le=...}`` series (the registry
  stores per-bucket counts; the running sum is taken here) plus ``_sum``
  and ``_count``.

``openmetrics=True`` switches to OpenMetrics 1.0 (graftslo): counter
*families* drop the ``_total`` suffix while their samples keep it, the
output terminates with ``# EOF``, and histogram buckets carry their
recorded **exemplars** (``# {trace_id="..."} value ts`` — the request
trace id ``Histogram.observe(exemplar_=...)`` attached), so an alerting
dashboard can jump from a latency bucket straight to the trace that
landed there.  The live endpoint negotiates the format from the scrape's
``Accept`` header; classic text stays the default everywhere.

:func:`parse_prometheus_text` reads BOTH formats back (the round-trip is
unit-tested in tests/test_slo.py) — it is what the mid-batch scrape
consistency tests and the smoke tooling use to assert on live output.

Stdlib-only, same constraint as ``telemetry.metrics``.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "OPENMETRICS_CONTENT_TYPE",
    "PROMETHEUS_CONTENT_TYPE",
    "parse_prometheus_text",
    "render_prometheus",
]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _name(raw: str) -> str:
    out = _NAME_OK.sub("_", raw)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape(v: Any) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        parts.append(f'{_name(k)}="{_escape(v)}"')
    return "{" + ",".join(parts) + "}"


def _num(v: Any) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _exemplar_suffix(
    entry: Dict[str, Any], idx: int, openmetrics: bool
) -> str:
    """The `` # {trace_id="..."} value ts`` tail of a bucket line, when
    this bucket recorded an exemplar (OpenMetrics output only — classic
    0.0.4 parsers reject exemplar syntax)."""
    if not openmetrics:
        return ""
    ex = (entry.get("exemplars") or {}).get(str(idx))
    if not ex:
        return ""
    ts = ex.get("ts")
    return (
        f' # {{trace_id="{_escape(ex.get("trace_id", ""))}"}} '
        f"{_num(ex.get('value', 0.0))}"
        + (f" {float(ts):.3f}" if ts is not None else "")
    )


def render_prometheus(
    snapshot: Dict[str, Any], openmetrics: bool = False
) -> str:
    """Text exposition of a ``MetricsRegistry.snapshot()`` dict (also the
    schema of a ``--metrics-out`` file).  ``openmetrics=True`` emits
    OpenMetrics 1.0 instead of classic 0.0.4 (see module docstring)."""
    lines: List[str] = []
    for raw_name, metric in sorted(snapshot.get("metrics", {}).items()):
        kind = metric.get("kind", "untyped")
        pname = _name(raw_name)
        if kind == "counter" and not pname.endswith("_total"):
            # counters gain the conventional suffix, but never doubled —
            # a registry name already ending in _total (compile.flops_total)
            # is exposed as-is, like the official prometheus clients do
            pname += "_total"
        # OpenMetrics names the counter FAMILY without the suffix; the
        # samples keep it (prometheus.io/docs/instrumenting/exposition_formats)
        family = (
            pname[: -len("_total")]
            if openmetrics and kind == "counter" and pname.endswith("_total")
            else pname
        )
        help_text = metric.get("help") or ""
        om_kind = kind if kind in ("counter", "gauge", "histogram") else (
            "unknown" if openmetrics else "untyped"
        )
        if help_text:
            lines.append(f"# HELP {family} {_escape(help_text)}")
        lines.append(f"# TYPE {family} {om_kind}")
        if kind == "histogram":
            bounds = metric.get("bucket_bounds", [])
            for entry in metric.get("values", []):
                labels = entry.get("labels", {})
                v = entry.get("value", {})
                cum = 0
                for idx, (bound, count) in enumerate(
                    zip(bounds, v.get("buckets", []))
                ):
                    cum += count
                    le = "+Inf" if bound == "+Inf" else _num(bound)
                    lines.append(
                        f"{pname}_bucket"
                        f"{_label_str({**labels, 'le': le})} {cum}"
                        + _exemplar_suffix(v, idx, openmetrics)
                    )
                lines.append(
                    f"{pname}_sum{_label_str(labels)} "
                    f"{_num(v.get('sum', 0.0))}"
                )
                lines.append(
                    f"{pname}_count{_label_str(labels)} "
                    f"{int(v.get('count', 0))}"
                )
        else:
            for entry in metric.get("values", []):
                lines.append(
                    f"{pname}{_label_str(entry.get('labels', {}))} "
                    f"{_num(entry.get('value', 0.0))}"
                )
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# parsing (the round-trip half: tests + smoke tooling read live output)
# ---------------------------------------------------------------------------


def _parse_labels(text: str) -> Tuple[Dict[str, str], str]:
    """Labels out of ``{k="v",...}rest`` -> (labels, rest).  Handles the
    exposition escapes (backslash, quote, newline)."""
    if not text.startswith("{"):
        return {}, text
    labels: Dict[str, str] = {}
    i = 1
    n = len(text)
    while i < n and text[i] != "}":
        eq = text.index("=", i)
        key = text[i:eq].strip().lstrip(",").strip()
        if text[eq + 1] != '"':
            raise ValueError(f"unquoted label value at {text[i:]!r}")
        j = eq + 2
        out: List[str] = []
        while j < n:
            c = text[j]
            if c == "\\" and j + 1 < n:
                nxt = text[j + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                break
            out.append(c)
            j += 1
        labels[key] = "".join(out)
        i = j + 1
    return labels, text[i + 1 :]


def _parse_value(token: str) -> float:
    if token == "+Inf":
        return math.inf
    if token == "-Inf":
        return -math.inf
    return float(token)


def parse_prometheus_text(text: str) -> Dict[str, Any]:
    """Parse classic-Prometheus or OpenMetrics exposition text.

    Returns ``{"types": {family: kind}, "help": {family: text},
    "samples": [{"name", "labels", "value", "exemplar"}], "eof": bool}``
    — enough structure to assert a render round-trips and that a live
    scrape is internally consistent.  Raises ``ValueError`` on lines
    that are neither comments nor well-formed samples."""
    types: Dict[str, str] = {}
    help_: Dict[str, str] = {}
    samples: List[Dict[str, Any]] = []
    saw_eof = False
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            elif len(parts) >= 3 and parts[1] == "HELP":
                help_[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        # sample: name[{labels}] value [ts] [# {exemplar-labels} v [ts]]
        exemplar: Optional[Dict[str, Any]] = None
        if " # " in line:
            line, ex_text = line.split(" # ", 1)
            ex_labels, ex_rest = _parse_labels(ex_text.strip())
            ex_tokens = ex_rest.split()
            if not ex_tokens:
                raise ValueError(f"line {lineno}: exemplar without value")
            exemplar = {
                "labels": ex_labels,
                "value": _parse_value(ex_tokens[0]),
            }
            if len(ex_tokens) > 1:
                exemplar["ts"] = float(ex_tokens[1])
        m = re.match(r"([a-zA-Z_:][a-zA-Z0-9_:]*)", line)
        if not m:
            raise ValueError(f"line {lineno}: no metric name in {line!r}")
        name = m.group(1)
        labels, rest = _parse_labels(line[m.end():])
        tokens = rest.split()
        if not tokens:
            raise ValueError(f"line {lineno}: sample without value")
        samples.append(
            {
                "name": name,
                "labels": labels,
                "value": _parse_value(tokens[0]),
                "exemplar": exemplar,
            }
        )
    return {
        "types": types,
        "help": help_,
        "samples": samples,
        "eof": saw_eof,
    }
