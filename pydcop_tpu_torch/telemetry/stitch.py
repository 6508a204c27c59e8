"""Cross-process trace stitching: merge per-agent trace files into one
Perfetto-loadable timeline.

The port's own copy of ``pydcop_tpu/telemetry/stitch.py``, unchanged:
the port's ``telemetry stitch`` merges traces of either package.

A multi-process run (``solve -m process``, standalone ``pydcop_tpu agent``
processes) produces one trace file per process, each with timestamps
relative to its own tracer epoch.  Stitching aligns them on one time axis
in two steps:

1. **Epoch alignment** — every exported file carries its absolute
   wall-clock epoch (``metadata.epoch_unix_s``, captured atomically with
   the perf_counter epoch); each file's events are shifted by its epoch
   delta to the earliest file's.
2. **Clock-offset estimation** — wall clocks across machines (or a long
   lived interpreter whose perf_counter drifted from its wall clock)
   still disagree by an offset.  The orchestrator handshake traffic gives
   message flows in BOTH directions between the orchestrator and every
   agent, so the classic symmetric-delay estimator applies: with
   ``d_ab = recv_ts(b) - send_ts(a)`` the offset of b relative to a is
   ``(median(d_ab) - median(d_ba)) / 2`` (transport delay cancels).  For
   process pairs with one-directional traffic only, the offset is clamped
   so no message arrives before it was sent.

Flow events (phases ``s``/``t``/``f``, see ``telemetry.tracing``) provide
the send/recv samples; their process-unique ids make the pairing exact.

Stdlib-only, same constraint as ``telemetry.metrics``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["flow_stats", "load_trace_file", "stitch_traces"]

#: minimum one-way delay (us) enforced when clamping a one-directional
#: pair: a stitched arrow of exactly zero length renders ambiguously
_MIN_DELAY_US = 1.0


def load_trace_file(path: str) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """(events, metadata) from a Chrome trace JSON object; JSONL streams
    and bare arrays load with empty metadata (no epoch → the file aligns
    at the stitch base)."""
    from .summary import load_trace

    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped[:1] == "{":
        try:
            payload = json.loads(text)
        except json.JSONDecodeError:
            payload = None
        if isinstance(payload, dict) and isinstance(
            payload.get("traceEvents"), list
        ):
            meta = payload.get("metadata")
            return payload["traceEvents"], meta if isinstance(meta, dict) else {}
    return load_trace(path), {}


def flow_stats(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Pairing census over flow events: how many message sends (``s``)
    found their delivery (``t``) and consume (``f``) counterparts.  The
    watch-smoke gate asserts ``match_pct >= 95``."""
    sends, steps, finishes = set(), set(), set()
    for e in events:
        if not isinstance(e, dict):
            continue
        ph = e.get("ph")
        if ph not in ("s", "t", "f"):
            continue
        fid = e.get("id")
        if fid is None:
            continue
        (sends if ph == "s" else steps if ph == "t" else finishes).add(fid)
    matched = sends & (finishes | steps)
    return {
        "sends": len(sends),
        "delivered": len(sends & steps),
        "consumed": len(sends & finishes),
        "matched": len(matched),
        "match_pct": (
            round(100.0 * len(matched) / len(sends), 2) if sends else None
        ),
    }


def _flow_points(
    events_per_file: List[List[Dict[str, Any]]],
) -> Tuple[Dict[Any, Tuple[int, float]], Dict[Any, Tuple[int, float]]]:
    """Per flow id: (file index, epoch-aligned ts) of the send point and
    of the earliest receive point (delivery step preferred over consume —
    it is closest to transport arrival, before any queue wait)."""
    send_pt: Dict[Any, Tuple[int, float]] = {}
    recv_pt: Dict[Any, Tuple[int, float]] = {}
    for i, events in enumerate(events_per_file):
        for e in events:
            ph = e.get("ph")
            if ph not in ("s", "t", "f"):
                continue
            fid, ts = e.get("id"), e.get("ts")
            if fid is None or not isinstance(ts, (int, float)):
                continue
            if ph == "s":
                send_pt[fid] = (i, float(ts))
            else:
                prev = recv_pt.get(fid)
                # a "t" at any ts beats an "f"; earlier beats later
                rank = (0 if ph == "t" else 1, float(ts))
                if prev is None or rank < prev[2]:
                    recv_pt[fid] = (i, float(ts), rank)
    return send_pt, {k: (v[0], v[1]) for k, v in recv_pt.items()}


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def _estimate_offsets(
    events_per_file: List[List[Dict[str, Any]]],
) -> Dict[int, float]:
    """Per-file clock offset (us, to SUBTRACT from that file's ts) from
    cross-file flow samples, anchored at file 0 (the orchestrator's file
    in a stitch of a run — it talks to every agent, so the offset graph
    is connected through it)."""
    send_pt, recv_pt = _flow_points(events_per_file)
    # directed delay samples between file pairs
    deltas: Dict[Tuple[int, int], List[float]] = {}
    for fid, (si, sts) in send_pt.items():
        rp = recv_pt.get(fid)
        if rp is None or rp[0] == si:
            continue
        deltas.setdefault((si, rp[0]), []).append(rp[1] - sts)

    offsets: Dict[int, float] = {0: 0.0}
    pending = set(range(1, len(events_per_file)))
    progressed = True
    while pending and progressed:
        progressed = False
        for j in sorted(pending):
            for i in sorted(offsets):
                fwd = deltas.get((i, j))
                rev = deltas.get((j, i))
                if fwd and rev:
                    # symmetric-delay (NTP-style): transport delay cancels
                    theta = (_median(fwd) - _median(rev)) / 2.0
                elif fwd:
                    # one-way only: clamp causality (never arrive early)
                    worst = min(fwd)
                    theta = min(0.0, worst - _MIN_DELAY_US)
                elif rev:
                    worst = min(rev)
                    theta = -min(0.0, worst - _MIN_DELAY_US)
                else:
                    continue
                # theta ≈ clock(j) - clock(i), in file-i-aligned time
                offsets[j] = offsets[i] + theta
                pending.discard(j)
                progressed = True
                break
    for j in pending:  # unconnected file: epoch alignment only
        offsets[j] = 0.0
    return offsets


def stitch_traces(
    paths: List[str],
    skip_unreadable: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Merge per-process trace files into one Chrome trace object.

    Returns ``(trace, report)``: the Perfetto-loadable trace (pids
    preserved — one process group per input file — with colliding pids
    remapped) and a report with the applied epoch shifts, estimated clock
    offsets and the flow-pairing census of the merged timeline.

    With ``skip_unreadable`` a file that fails to load (missing, not
    JSON, truncated mid-write by a crashed agent) is dropped from the
    stitch instead of aborting it, and named in ``report["skipped"]`` —
    the directory form of ``telemetry stitch`` globs whatever a run left
    behind, which legitimately includes partial files."""
    if len(paths) < 1:
        raise ValueError("stitch needs at least one trace file")
    skipped: List[Dict[str, str]] = []
    if skip_unreadable:
        loaded_ok, kept = [], []
        for p in paths:
            try:
                loaded_ok.append(load_trace_file(p))
                kept.append(p)
            except (OSError, ValueError) as e:
                skipped.append({"path": p, "error": str(e)})
        if not kept:
            raise ValueError(
                "stitch: no readable trace files ("
                + "; ".join(f"{s['path']}: {s['error']}" for s in skipped)
                + ")"
            )
        paths, loaded = kept, loaded_ok
    else:
        loaded = [load_trace_file(p) for p in paths]
    epochs = [
        float(meta.get("epoch_unix_s") or 0.0) for _events, meta in loaded
    ]
    known = [e for e in epochs if e > 0.0]
    base = min(known) if known else 0.0

    # epoch alignment (files without an epoch align at the base)
    events_per_file: List[List[Dict[str, Any]]] = []
    shifts_us: List[float] = []
    for (events, _meta), epoch in zip(loaded, epochs):
        shift = ((epoch - base) * 1e6) if epoch > 0.0 else 0.0
        shifts_us.append(shift)
        shifted = []
        for e in events:
            if not isinstance(e, dict):
                continue
            if shift and isinstance(e.get("ts"), (int, float)):
                e = dict(e)
                e["ts"] = e["ts"] + shift
            shifted.append(e)
        events_per_file.append(shifted)

    offsets = _estimate_offsets(events_per_file)

    # pid collision remap: two files exporting the same pid (e.g. traces
    # from different machines) must not interleave on one track group
    used_pids: Dict[int, int] = {}
    merged: List[Dict[str, Any]] = []
    for i, events in enumerate(events_per_file):
        off = offsets.get(i, 0.0)
        remap: Dict[int, int] = {}
        for e in events:
            pid = e.get("pid")
            if isinstance(pid, int):
                if pid not in remap:
                    if pid in used_pids and used_pids[pid] != i:
                        new = pid
                        while new in used_pids:
                            new += 1_000_000
                        remap[pid] = new
                    else:
                        used_pids.setdefault(pid, i)
                        remap[pid] = pid
                    used_pids[remap[pid]] = i
                e = dict(e)
                e["pid"] = remap[pid]
            elif off:
                e = dict(e)
            if off and isinstance(e.get("ts"), (int, float)):
                e["ts"] = e["ts"] - off
            merged.append(e)

    # normalize: a negative clock offset can push the earliest events
    # below zero, which the schema validator (and some viewers) reject —
    # re-zero the merged axis and move the epoch anchor the same amount
    ts_min = min(
        (
            e["ts"]
            for e in merged
            if isinstance(e.get("ts"), (int, float))
        ),
        default=0.0,
    )
    if ts_min < 0:
        for e in merged:
            if isinstance(e.get("ts"), (int, float)):
                e["ts"] = e["ts"] - ts_min
        base = base + ts_min / 1e6 if base else base

    report = {
        "files": [
            {
                "path": p,
                "events": len(ev),
                "epoch_unix_s": epoch or None,
                "epoch_shift_us": round(shift, 1),
                "clock_offset_us": round(offsets.get(i, 0.0), 1),
                "service": meta.get("service"),
            }
            for i, (p, (ev, meta), epoch, shift) in enumerate(
                zip(paths, loaded, epochs, shifts_us)
            )
        ],
        "flows": flow_stats(merged),
        "skipped": skipped,
    }
    trace = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "epoch_unix_s": base,
            "exporter": "pydcop_tpu.telemetry.stitch",
            "stitched_from": list(paths),
            "clock_offsets_us": {
                paths[i]: round(v, 1) for i, v in offsets.items()
            },
        },
    }
    return trace, report
