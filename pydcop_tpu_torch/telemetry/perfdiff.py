"""Capture bundles and the per-op regression diff.

The port's copy of ``pydcop_tpu/telemetry/perfdiff.py``: the same bundle
and diff formats, thresholds and text, so ``capture diff`` gives the
JAX package's JSON, table and exit code on the same bundles.

A *capture bundle* is a self-describing directory: ``manifest.json``
(device, versions, commit, clock, the per-config index, the budget
block), ``records/config_<k>.json`` (one record of
``tools/capture_configs.py``: ``compile``, ``roofline``, ``kernel``,
``telemetry``, ``census`` blocks), plus the CUDA-graph dumps and the
profiler traces the ``capture`` verb drops next to them.

The *diff* half attributes a wall-time delta per op and per phase via
the kernelprof marginal-prefix rows (``ell.pair_gather``) and the MGM-2
phase blocks (``mgm2.offer``), flags dispatch/readback census changes
and recompiles, reads the roofline shift (bytes/cycle, achieved GB/s),
and renders both a ranked human table and machine JSON.

Host-only module: stdlib imports only, no torch, so ``capture diff``
runs on a host without a card.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import platform as _platform
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "BUNDLE_FORMAT",
    "DIFF_FORMAT",
    "append_record",
    "attribution_state",
    "capture_environment",
    "diff_records",
    "diff_sides",
    "format_attribution",
    "format_diff",
    "load_side",
    "new_manifest",
    "op_rows",
    "write_manifest",
]

BUNDLE_FORMAT = "pydcop_tpu.capture/1"
DIFF_FORMAT = "pydcop_tpu.perfdiff/1"

# significance thresholds: relative drift AND an absolute floor, so
# micro-jitter on sub-millisecond ops never reads as a regression
WALL_TOL_PCT = 25.0
WALL_ABS_S = 0.02
OP_TOL_PCT = 25.0
OP_ABS_MS = 0.05
GBPS_TOL_PCT = 25.0
# graftmem drift: predicted/measured device bytes growing this much
# between captures is a footprint regression worth naming (an absolute
# floor keeps small-problem noise out, same discipline as the walls)
MEM_TOL_PCT = 10.0
MEM_ABS_BYTES = 1 << 20


# ---------------------------------------------------------------------------
# bundle writing
# ---------------------------------------------------------------------------


def capture_environment(extra: Optional[Dict[str, Any]] = None) -> Dict:
    """Host-side provenance for a bundle manifest (stdlib only: the
    capture verb merges device/backend facts from torch via ``extra``)."""
    env: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": _platform.platform(),
        "hostname": _platform.node(),
    }
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))
            )),
        )
        if commit.returncode == 0:
            env["commit"] = commit.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    if extra:
        env.update(extra)
    return env


def new_manifest(
    environment: Optional[Dict] = None,
    created: Optional[str] = None,
    partial: bool = False,
    notes: Optional[str] = None,
) -> Dict:
    manifest: Dict[str, Any] = {
        "format": BUNDLE_FORMAT,
        "environment": environment or {},
        "configs": {},
        "warnings": [],
    }
    if created:
        manifest["created"] = created
    if partial:
        manifest["partial"] = True
    if notes:
        manifest["notes"] = notes
    return manifest


def write_manifest(out_dir: str, manifest: Dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "manifest.json")
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def append_record(
    out_dir: str,
    record: Dict,
    manifest: Dict,
    warnings: Optional[List[str]] = None,
) -> str:
    """Write one bench record into the bundle and re-write the manifest
    (per-config, not at the end: a crashed capture window still leaves a
    valid partial bundle behind)."""
    key = str(record.get("config", record.get("metric", "unknown")))
    rec_dir = os.path.join(out_dir, "records")
    os.makedirs(rec_dir, exist_ok=True)
    rel = os.path.join("records", f"config_{key}.json")
    with open(os.path.join(out_dir, rel), "w") as fh:
        json.dump(record, fh, indent=2, sort_keys=True)
        fh.write("\n")
    manifest["configs"][key] = {
        "metric": record.get("metric"),
        "file": rel,
        "value": record.get("value"),
        "unit": record.get("unit"),
        "device": record.get("device"),
        "attribution": attribution_state(record),
    }
    if warnings:
        manifest["warnings"].extend(warnings)
    write_manifest(out_dir, manifest)
    return rel


# ---------------------------------------------------------------------------
# loading comparands (bundle dir / BENCH file / trajectory glob)
# ---------------------------------------------------------------------------


def _iter_records(path: str):
    """Yield bench records from a BENCH_*.json file: a bare JSON-lines
    stream, a JSON list, or the bench.py wrapper record whose ``tail``
    carries the record lines."""
    with open(path) as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, list):
        for rec in doc:
            if isinstance(rec, dict):
                yield rec
        return
    if isinstance(doc, dict):
        if "metric" in doc:
            yield doc
            return
        tail = doc.get("tail")
        if isinstance(tail, list):
            text = "\n".join(str(ln) for ln in tail)
        elif isinstance(tail, str):
            text = tail
        else:
            return
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "metric" in rec:
            yield rec


def _side(label: str, kind: str, records: Dict[str, Dict],
          manifest: Optional[Dict] = None) -> Dict:
    return {
        "label": label, "kind": kind,
        "records": records, "manifest": manifest,
    }


def load_bundle(path: str) -> Dict:
    mpath = os.path.join(path, "manifest.json")
    manifest = None
    if os.path.exists(mpath):
        with open(mpath) as fh:
            manifest = json.load(fh)
    records: Dict[str, Dict] = {}
    for rec_path in sorted(
        _glob.glob(os.path.join(path, "records", "config_*.json"))
    ):
        with open(rec_path) as fh:
            rec = json.load(fh)
        if isinstance(rec, dict) and rec.get("metric"):
            records[rec["metric"]] = rec
    return _side(path.rstrip("/"), "bundle", records, manifest)


def _median_record(recs: List[Dict]) -> Dict:
    ordered = sorted(recs, key=lambda r: float(r["value"]))
    return ordered[len(ordered) // 2]


def trajectory_side(paths: List[str], device: Optional[str] = None) -> Dict:
    """Median-value record per metric across a BENCH history — the same
    drift-normalized anchor bench_gate compares against.  Same-device
    records only: mixing CPU and card walls makes the median garbage."""
    by_metric: Dict[str, List[Dict]] = {}
    for path in sorted(paths):
        for rec in _iter_records(path):
            if rec.get("value") is None:
                continue
            by_metric.setdefault(rec["metric"], []).append(rec)
    records: Dict[str, Dict] = {}
    for metric, recs in by_metric.items():
        if device:
            same = [r for r in recs if r.get("device") == device]
        else:
            # majority device wins when the caller does not pin one
            counts: Dict[str, int] = {}
            for r in recs:
                counts[str(r.get("device"))] = (
                    counts.get(str(r.get("device")), 0) + 1
                )
            major = max(counts, key=lambda d: counts[d]) if counts else None
            same = [r for r in recs if str(r.get("device")) == major]
        if same:
            records[metric] = _median_record(same)
    label = f"trajectory-median({len(paths)} files"
    label += f", device={device})" if device else ")"
    return _side(label, "trajectory", records)


def load_side(spec: str, device: Optional[str] = None) -> Dict:
    """Resolve one diff comparand: a bundle directory, a BENCH_*.json
    records file, or a glob matching a BENCH history (2+ files ->
    trajectory median)."""
    if os.path.isdir(spec):
        return load_bundle(spec)
    if os.path.isfile(spec):
        records = {
            rec["metric"]: rec
            for rec in _iter_records(spec)
            if rec.get("metric")
        }
        return _side(spec, "records", records)
    matches = [p for p in sorted(_glob.glob(spec)) if os.path.isfile(p)]
    if len(matches) > 1:
        return trajectory_side(matches, device=device)
    if len(matches) == 1:
        return load_side(matches[0], device=device)
    raise FileNotFoundError(
        f"{spec}: not a bundle dir, records file, or matching glob"
    )


# ---------------------------------------------------------------------------
# attribution extraction
# ---------------------------------------------------------------------------


def attribution_state(record: Dict) -> str:
    """'ok', or why this record carries no per-op attribution — capture
    warns loudly on anything that is not 'ok' (a capture window must
    never be silently under-instrumented again)."""
    kernel = record.get("kernel")
    if kernel is None:
        return "missing"
    if not isinstance(kernel, dict):
        return "malformed"
    if "error" in kernel:
        return f"error: {kernel['error']}"[:160]
    if "skipped" in kernel:
        return f"skipped: {kernel['skipped']}"[:160]
    return "ok"


def op_rows(record: Dict) -> Dict[str, Dict]:
    """Flatten a kernel block into ``{op_name: {ms, share_pct, gbps}}``
    rows — ELL ops prefix with the layout (``ell.pair_gather``), mgm2
    phases with the algo (``mgm2.offer``)."""
    kernel = record.get("kernel")
    if attribution_state(record) != "ok":
        return {}
    rows: Dict[str, Dict] = {}
    ops = kernel.get("ops")
    if isinstance(ops, dict):
        prefix = kernel.get("layout", "kernel")
        for name, op in ops.items():
            if isinstance(op, dict) and op.get("ms") is not None:
                rows[f"{prefix}.{name}"] = {
                    "ms": float(op["ms"]),
                    "share_pct": op.get("share_pct"),
                    "gbps": op.get("gbps"),
                }
    phases = kernel.get("phases")
    if isinstance(phases, dict):
        prefix = kernel.get("algo", "kernel")
        for name, ph in phases.items():
            if isinstance(ph, dict) and ph.get("ms") is not None:
                rows[f"{prefix}.{name}"] = {
                    "ms": float(ph["ms"]),
                    "share_pct": ph.get("share_pct"),
                    "gbps": None,
                }
    return rows


def _pct(base: float, fresh: float) -> Optional[float]:
    if not base:
        return None
    return round(100.0 * (fresh - base) / base, 1)


def _jit_census(record: Dict) -> Dict[str, Dict]:
    census = record.get("census")
    if isinstance(census, dict) and isinstance(census.get("jit"), dict):
        return census["jit"]
    return {}


# ---------------------------------------------------------------------------
# diffing
# ---------------------------------------------------------------------------


def _diff_ops(base: Dict, fresh: Dict) -> List[Dict]:
    base_rows, fresh_rows = op_rows(base), op_rows(fresh)
    names = sorted(set(base_rows) | set(fresh_rows))
    out = []
    for name in names:
        b = base_rows.get(name, {}).get("ms")
        f = fresh_rows.get(name, {}).get("ms")
        delta_ms = (f - b) if (b is not None and f is not None) else None
        delta_pct = _pct(b, f) if (b is not None and f is not None) else None
        significant = bool(
            delta_ms is not None
            and abs(delta_ms) >= OP_ABS_MS
            and delta_pct is not None
            and abs(delta_pct) >= OP_TOL_PCT
        )
        out.append({
            "op": name,
            "base_ms": b,
            "fresh_ms": f,
            "delta_ms": round(delta_ms, 4) if delta_ms is not None else None,
            "delta_pct": delta_pct,
            "base_share_pct": base_rows.get(name, {}).get("share_pct"),
            "fresh_share_pct": fresh_rows.get(name, {}).get("share_pct"),
            "significant": significant,
        })
    out.sort(
        key=lambda r: abs(r["delta_ms"]) if r["delta_ms"] is not None else -1,
        reverse=True,
    )
    return out


def _diff_census(base: Dict, fresh: Dict, flags: List[str]) -> Dict:
    bj, fj = _jit_census(base), _jit_census(fresh)
    jit: Dict[str, Dict] = {}
    for label in sorted(set(bj) | set(fj)):
        b = bj.get(label, {})
        f = fj.get(label, {})
        row = {
            "base_dispatches": b.get("dispatches"),
            "fresh_dispatches": f.get("dispatches"),
            "fresh_compiles": f.get("compiles"),
        }
        jit[label] = row
        if (
            b.get("dispatches") is not None
            and f.get("dispatches") is not None
            and b["dispatches"] != f["dispatches"]
        ):
            flags.append(
                f"dispatches: {label} "
                f"{b['dispatches']} -> {f['dispatches']}"
            )
        if f.get("compiles"):
            flags.append(
                f"recompile in timed run: {label} x{f['compiles']}"
            )
    bt = base.get("telemetry") or {}
    ft = fresh.get("telemetry") or {}
    for field in ("windows", "readback_bytes"):
        b, f = bt.get(field), ft.get(field)
        if b is not None and f is not None and b != f:
            flags.append(f"{field}: {b} -> {f}")
    bc = (base.get("compile") or {}).get("jit_compiles")
    fc = (fresh.get("compile") or {}).get("jit_compiles")
    if bc is not None and fc is not None and bc != fc:
        flags.append(f"programs compiled (warm-up): {bc} -> {fc}")
    return {
        "jit": jit,
        "windows": [bt.get("windows"), ft.get("windows")],
        "readback_bytes": [
            bt.get("readback_bytes"), ft.get("readback_bytes")
        ],
    }


def _diff_roofline(base: Dict, fresh: Dict, flags: List[str]) -> Dict:
    br = base.get("roofline") or {}
    fr = fresh.get("roofline") or {}
    out = {}
    for field in (
        "traffic_bytes_per_cycle", "achieved_gbps", "hbm_peak_pct",
        "achieved_gflops",
    ):
        b, f = br.get(field), fr.get(field)
        if b is not None or f is not None:
            out[field] = [b, f]
    gb, gf = br.get("achieved_gbps"), fr.get("achieved_gbps")
    if gb and gf:
        pct = _pct(gb, gf)
        if pct is not None and abs(pct) >= GBPS_TOL_PCT:
            flags.append(f"achieved GB/s: {gb} -> {gf} ({pct:+.0f}%)")
    tb = br.get("traffic_bytes_per_cycle")
    tf = fr.get("traffic_bytes_per_cycle")
    if tb and tf and tb != tf:
        flags.append(f"traffic bytes/cycle: {tb} -> {tf}")
    return out


def _diff_memory(base: Dict, fresh: Dict, flags: List[str]) -> Dict:
    """graftmem drift between two records' ``memory`` blocks: the
    model's predicted bytes and the measured memory_analysis() peak —
    a solve quietly growing its device footprint is flagged before it
    becomes an OOM on the next problem size up."""
    bm = base.get("memory") or {}
    fm = fresh.get("memory") or {}
    out = {}
    for field in (
        "predicted_bytes", "measured_peak_bytes", "limit_bytes",
        "headroom_pct",
    ):
        b, f = bm.get(field), fm.get(field)
        if b is not None or f is not None:
            out[field] = [b, f]
    for field, label in (
        ("predicted_bytes", "predicted bytes"),
        ("measured_peak_bytes", "measured peak bytes"),
    ):
        b, f = bm.get(field), fm.get(field)
        if not (b and f):
            continue
        pct = _pct(b, f)
        if (
            pct is not None
            and abs(pct) >= MEM_TOL_PCT
            and abs(f - b) >= MEM_ABS_BYTES
        ):
            flags.append(f"memory {label}: {b} -> {f} ({pct:+.0f}%)")
    return out


def _verdict(md: Dict) -> str:
    """One-phrase attribution for a significant wall delta, in priority
    order: recompiles beat dispatch growth beat memory-bound drift beat
    an op-level shift — the first cause in that chain explains the rest."""
    flags = md["flags"]
    if not md["significant"]:
        return "no significant wall change"
    direction = "regression" if (md["delta_pct"] or 0) > 0 else "improvement"
    if any(f.startswith("recompile in timed run") for f in flags) or any(
        f.startswith("programs compiled") for f in flags
    ):
        return f"recompile drift ({direction})"
    if any(f.startswith("dispatches:") or f.startswith("windows:")
           for f in flags):
        return f"dispatch-count change ({direction})"
    gbps_down = any(
        f.startswith("achieved GB/s") and "-" in f.split("(")[-1]
        for f in flags
    )
    traffic_same = not any(
        f.startswith("traffic bytes/cycle") for f in flags
    )
    if gbps_down and traffic_same and direction == "regression":
        return "memory-bound drift (achieved GB/s fell, traffic unchanged)"
    top = next((r for r in md["ops"] if r["significant"]), None)
    if top is not None:
        return (
            f"op-level shift: {top['op']} "
            f"{top['delta_pct']:+.0f}% ({direction})"
        )
    if (
        md["attribution"]["base"] != "ok"
        or md["attribution"]["fresh"] != "ok"
    ):
        return f"unattributed (no per-op block) ({direction})"
    return f"unattributed ({direction})"


def diff_records(base: Dict, fresh: Dict) -> Dict:
    """Per-metric diff: wall delta, ranked per-op rows, census +
    roofline flags, and a one-phrase verdict."""
    bv, fv = base.get("value"), fresh.get("value")
    delta_pct = _pct(bv, fv) if (bv and fv) else None
    significant = bool(
        bv and fv
        and abs(fv - bv) >= WALL_ABS_S
        and delta_pct is not None
        and abs(delta_pct) >= WALL_TOL_PCT
    )
    flags: List[str] = []
    md: Dict[str, Any] = {
        "metric": fresh.get("metric") or base.get("metric"),
        "base_value": bv,
        "fresh_value": fv,
        "unit": fresh.get("unit") or base.get("unit"),
        "delta_pct": delta_pct,
        "significant": significant,
        "device": {
            "base": base.get("device"),
            "fresh": fresh.get("device"),
        },
        "attribution": {
            "base": attribution_state(base),
            "fresh": attribution_state(fresh),
        },
        "ops": _diff_ops(base, fresh),
        "census": _diff_census(base, fresh, flags),
        "roofline": _diff_roofline(base, fresh, flags),
        "memory": _diff_memory(base, fresh, flags),
        "flags": flags,
    }
    if base.get("device") != fresh.get("device"):
        flags.insert(
            0,
            f"device changed: {base.get('device')} -> "
            f"{fresh.get('device')} (walls not comparable)",
        )
    md["verdict"] = _verdict(md)
    return md


def _budget_flags(base: Dict, fresh: Dict) -> List[str]:
    """Bundle-level dispatch/readback *site* drift: compare the static
    AST censuses the two manifests embedded at capture time, plus any
    check_budget problems the fresh capture recorded against
    tools/perf_budget.json."""
    flags: List[str] = []
    bm = (base.get("manifest") or {}).get("budget") or {}
    fm = (fresh.get("manifest") or {}).get("budget") or {}
    bc, fc = bm.get("census") or {}, fm.get("census") or {}
    for key in sorted(set(bc) & set(fc)):
        if key == "chunk_schedule":
            continue
        for field in ("dispatch_sites", "readback_sites"):
            b = (bc[key] or {}).get(field)
            f = (fc[key] or {}).get(field)
            if b is not None and f is not None and b != f:
                flags.append(f"budget: {key}.{field} {b} -> {f}")
    for problem in fm.get("problems") or []:
        flags.append(f"budget violation (fresh): {problem}")
    return flags


def diff_sides(base: Dict, fresh: Dict) -> Dict:
    """Full diff of two comparands from load_side(): per-metric diffs
    ranked worst-first, bundle-level budget flags, coverage gaps."""
    metrics = sorted(set(base["records"]) | set(fresh["records"]))
    diffs, only_base, only_fresh = [], [], []
    for metric in metrics:
        b, f = base["records"].get(metric), fresh["records"].get(metric)
        if b is None:
            only_fresh.append(metric)
            continue
        if f is None:
            only_base.append(metric)
            continue
        diffs.append(diff_records(b, f))

    def _rank(md):
        # significant regressions first (worst on top), then significant
        # improvements, then the quiet rows
        pct = md["delta_pct"] or 0.0
        if md["significant"] and pct > 0:
            return (0, -pct)
        if md["significant"]:
            return (1, pct)
        return (2, -abs(pct))

    diffs.sort(key=_rank)
    return {
        "format": DIFF_FORMAT,
        "base": base["label"],
        "fresh": fresh["label"],
        "metrics": diffs,
        "significant": sum(1 for d in diffs if d["significant"]),
        "flags": _budget_flags(base, fresh),
        "only_in_base": only_base,
        "only_in_fresh": only_fresh,
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _fmt_ms(v) -> str:
    return f"{v:.3f}" if isinstance(v, (int, float)) else "-"


def _headline(md: Dict) -> str:
    """The one-sentence story: 'mgm2 wall +95%: phase mgm2.offer +88%,
    dispatches unchanged, achieved GB/s halved -> memory-bound drift'."""
    parts = []
    if md["delta_pct"] is not None:
        parts.append(f"{md['metric']} wall {md['delta_pct']:+.0f}%")
    else:
        parts.append(f"{md['metric']} wall {md['base_value']} -> "
                     f"{md['fresh_value']}")
    clauses = []
    top = next((r for r in md["ops"] if r["significant"]), None)
    if top is not None and top["delta_pct"] is not None:
        clauses.append(f"op {top['op']} {top['delta_pct']:+.0f}%")
    census_flags = [
        f for f in md["flags"]
        if f.startswith(("dispatches:", "recompile", "programs compiled"))
    ]
    clauses.append(census_flags[0] if census_flags
                   else "dispatches unchanged")
    gbps = [f for f in md["flags"] if f.startswith("achieved GB/s")]
    if gbps:
        clauses.append(gbps[0])
    return f"{parts[0]}: " + ", ".join(clauses) + f" -> {md['verdict']}"


def format_attribution(md: Dict, limit: int = 8) -> str:
    """Compact per-op attribution block (what bench_gate appends to a
    REGRESSION/WAIVED row's failure output)."""
    lines = [_headline(md)]
    header = (
        f"  {'op':<24} {'base ms':>9} {'fresh ms':>9} "
        f"{'delta':>8} {'drift':>7}"
    )
    rows = [r for r in md["ops"] if r["base_ms"] is not None
            or r["fresh_ms"] is not None]
    if rows:
        lines.append(header)
        for r in rows[:limit]:
            drift = (
                f"{r['delta_pct']:+.0f}%" if r["delta_pct"] is not None
                else "-"
            )
            mark = " <-- " if r["significant"] else "     "
            lines.append(
                f"  {r['op']:<24} {_fmt_ms(r['base_ms']):>9} "
                f"{_fmt_ms(r['fresh_ms']):>9} "
                f"{_fmt_ms(r['delta_ms']):>8} {drift:>7}{mark.rstrip()}"
            )
    else:
        lines.append(
            "  (no per-op rows: attribution "
            f"base={md['attribution']['base']}, "
            f"fresh={md['attribution']['fresh']})"
        )
    for flag in md["flags"]:
        lines.append(f"  ! {flag}")
    return "\n".join(lines)


def format_diff(diff: Dict, all_metrics: bool = False) -> str:
    """Human rendering of a diff_sides() result: ranked per-metric
    blocks (significant ones expanded, quiet ones one-lined)."""
    lines = [
        f"perfdiff: {diff['base']}  vs  {diff['fresh']}",
        f"  {diff['significant']} significant metric delta(s)",
    ]
    for flag in diff["flags"]:
        lines.append(f"  ! {flag}")
    for name in diff["only_in_base"]:
        lines.append(f"  - only in base: {name}")
    for name in diff["only_in_fresh"]:
        lines.append(f"  + only in fresh: {name}")
    lines.append("")
    for md in diff["metrics"]:
        if md["significant"] or all_metrics:
            lines.append(format_attribution(md))
            lines.append("")
        else:
            pct = (
                f"{md['delta_pct']:+.1f}%" if md["delta_pct"] is not None
                else "n/a"
            )
            lines.append(
                f"  ok {md['metric']:<28} "
                f"{md['base_value']} -> {md['fresh_value']} ({pct})"
            )
    return "\n".join(lines).rstrip() + "\n"
