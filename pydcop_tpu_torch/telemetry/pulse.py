"""graftpulse: solver-health telemetry, diagnosis, and the flight recorder.

The port's own copy of ``pydcop_tpu/telemetry/pulse.py``, unchanged: the
same schema, diagnoses and postmortem format, so a dump of either package
renders in the other.  On the card the health vector is computed inside
the captured chunk graph (``pydcop_tpu_torch/algorithms/base.py``).

The systems substrate (graftscope/graftwatch/graftprof) observes the
*machinery* — queues, readbacks, compiles.  graftpulse observes the
*algorithm*: every solver cycle contributes one fixed-width **health
vector**, computed ON DEVICE inside the scan loop (``algorithms/base.py``)
and read back riding the readbacks that already happen — the fused solve's
single packed byte array, or the timeout path's per-chunk host sync.  The
reference pyDCOP exposes nothing comparable: its inner loops are opaque
per-agent Python dicts (PAPER.md), so when a solve plateaus nobody can say
whether DSA is thrashing, MaxSum messages are oscillating, or the anytime
curve genuinely converged.

Host side (this module, stdlib-only like ``telemetry.metrics`` — it is
imported by host-only verbs: ``watch``, ``postmortem``, the bench parent):

- :data:`HEALTH_FIELDS` — the health-vector schema shared with the device
  pack in ``algorithms/base.py`` (widths must match; pinned by
  ``tests/test_pulse.py``).
- :func:`analyze` — turn a health stream into a named diagnosis
  (``converged`` / ``stalled-plateau`` / ``oscillating(period=k)`` /
  ``still-improving``).
- :class:`FlightRecorder` — bounded ring of the last K health vectors plus
  a config fingerprint, auto-dumped as ``postmortem.json`` on chaos
  divergence, solve timeout, or ``Agent.crash()``.
- :class:`PulseMonitor` (singleton ``pulse``) — the enable flag, the
  ``--pulse-out`` JSONL stream, the ``solve.pulse.*`` metrics, and the
  ``/status`` pulse block the ``watch`` verb renders.

Disabled by default, zero-cost-when-off to the same standard as
graftscope: the solver hot path checks ``pulse.enabled`` once per solve
(not per cycle) and compiles the exact same device program as before when
it is off.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import metrics_registry

__all__ = [
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

#: The health-vector schema: one float32 per field, one vector per cycle.
#: The DEVICE side (``algorithms/base.py:_health_vec``) packs in exactly
#: this order — the two sides share this tuple the same way the fused
#: readback shares ``_pack_layout``, so they cannot drift.
#:
#: - ``cost``       this cycle's total (internal min-form) cost
#: - ``best_cost``  running anytime-best cost after this cycle
#: - ``flips``      variables whose value changed this cycle
#: - ``churn``      flips / live variable count
#: - ``flipback``   of the flipped variables, the fraction that returned
#:                  to their value of two cycles ago — the on-device
#:                  period-2 oscillation indicator (damping/thrash)
#: - ``residual``   algorithm-specific: MaxSum max-abs v2f message
#:                  residual, local-search max available gain, DBA weight
#:                  churn, GDBA modifier churn (docs/usage/algo_ref.md)
#: - ``aux``        second algorithm-specific slot (f2v residual, mean
#:                  gain, frozen fraction, ... — see algo_ref.md)
#: - ``violations`` constraint entries in the BIG forbidden-cost band at
#:                  the current assignment (hard-constraint violations)
HEALTH_FIELDS = (
    "cost",
    "best_cost",
    "flips",
    "churn",
    "flipback",
    "residual",
    "aux",
    "violations",
)
HEALTH_WIDTH = len(HEALTH_FIELDS)

_F = {name: i for i, name in enumerate(HEALTH_FIELDS)}

POSTMORTEM_FORMAT = "pydcop_tpu.postmortem/1"

#: diagnosis names with a fixed label set (the ``solve.pulse.state``
#: gauge enumerates these; ``oscillating`` carries its period separately)
DIAGNOSES = (
    "no-data",
    "still-improving",
    "converged",
    "oscillating",
    "stalled-plateau",
)


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


def _rel_tol(scale: float, tol: float) -> float:
    return tol * max(abs(scale), 1.0)


def _detect_period(series: Sequence[float], tol: float) -> Optional[int]:
    """Smallest k >= 2 such that the tail series is k-periodic (every
    entry matches the entry k steps earlier within tolerance), requiring
    at least two full periods of evidence.  A constant series is NOT
    periodic here (period detection runs only after the constant case —
    ``converged``/``stalled`` — has been ruled out by churn)."""
    n = len(series)
    # tolerance keyed to the series' DYNAMIC RANGE, not its magnitude: a
    # BIG-hard-constraint run oscillates by ~10 on a ~1e9 base, and a
    # magnitude-anchored eps (1e4) would both hide the oscillation and
    # defeat the degenerate-match rejection below
    scale = (max(series) - min(series)) if series else 0.0
    eps = _rel_tol(scale, tol)
    for k in range(2, n // 2 + 1):
        if all(abs(series[i] - series[i - k]) <= eps for i in range(k, n)):
            # reject the degenerate all-equal match: that is a plateau
            if any(
                abs(series[i] - series[i - 1]) > eps for i in range(1, n)
            ):
                return k
    return None


def analyze(
    rows: Sequence[Sequence[float]],
    tail: int = 32,
    tol: float = 1e-5,
) -> Dict[str, Any]:
    """Diagnose a health stream (``[cycles, HEALTH_WIDTH]`` rows).

    Returns a dict with ``diagnosis`` (one of :data:`DIAGNOSES`),
    ``diagnosis_full`` (``oscillating(period=k)`` when a period was
    found), ``period``, and the tail-window statistics the call judged
    from.  Pure host-side; safe on any sequence of float sequences.

    The taxonomy, over the last ``tail`` cycles:

    - ``still-improving`` — the anytime-best cost moved down within the
      window: leave it running.
    - ``converged``       — best flat AND nothing moves NOW (churn over
      the last quarter of the window ~ 0 and the last residual ~ 0): the
      fixpoint is real.  Judged on the recent tail, not the whole
      window, so a run that settled early in the window is not
      misread as churning.
    - ``oscillating``     — best flat, variables still flipping, and the
      per-cycle cost series is k-periodic (or the on-device flipback
      indicator shows period-2 value cycling): raise damping / lower p.
    - ``stalled-plateau`` — best flat, still churning, no detectable
      period: a local minimum being thrashed against; add noise or
      restart.
    """
    n = len(rows)
    if n == 0:
        return {
            "diagnosis": "no-data",
            "diagnosis_full": "no-data",
            "period": None,
            "cycles": 0,
        }
    w = [list(map(float, r)) for r in rows[max(0, n - tail):]]
    best0, best1 = w[0][_F["best_cost"]], w[-1][_F["best_cost"]]
    churn_max = max(r[_F["churn"]] for r in w)
    resid_max = max(abs(r[_F["residual"]]) for r in w)
    flipback_mean = sum(r[_F["flipback"]] for r in w) / len(w)
    out: Dict[str, Any] = {
        "cycles": n,
        "window": len(w),
        "best_cost": best1,
        "best_delta": best0 - best1,
        "churn": churn_max,
        "residual": resid_max,
        "flipback": flipback_mean,
        "violations": w[-1][_F["violations"]],
        "period": None,
    }
    # convergence is a statement about NOW: a settled run keeps old churn
    # in the window, so judge the last quarter (and the last residual)
    q = max(1, len(w) // 4)
    churn_now = max(r[_F["churn"]] for r in w[-q:])
    # settled means NO variable flipped, not "few relative to n": churn
    # is flips/n_live, so on a 100k-variable solve one variable flipping
    # every cycle reads churn 1e-5 — inside any fixed fractional
    # tolerance yet plainly not converged.  The flips count is absolute
    # and exact in float32 far beyond any real variable count.
    flips_now = max(r[_F["flips"]] for r in w[-q:])
    resid_now = abs(w[-1][_F["residual"]])
    out["churn_now"] = churn_now
    out["residual_now"] = resid_now
    # anchor on the window's cost dynamic range, not |cost|: on a BIG
    # hard-constraint (~1e9) or 1M-variable cost base, a magnitude
    # tolerance (tol*|best|) swallows all soft-cost dynamics and every
    # run reads stalled
    dyn = (
        max(r[_F["cost"]] for r in w) - min(r[_F["cost"]] for r in w)
    )
    improving = (best0 - best1) > _rel_tol(dyn, tol)
    if improving and len(w) > 1:
        out["diagnosis"] = "still-improving"
    elif flips_now == 0.0 and resid_now <= _rel_tol(dyn, tol):
        out["diagnosis"] = "converged"
    else:
        period = _detect_period([r[_F["cost"]] for r in w], tol)
        flipback_now = sum(r[_F["flipback"]] for r in w[-q:]) / q
        if period is None and flipback_now > 0.5:
            # values cycle A->B->A even though the total cost stays flat
            # (symmetric swaps): the device-side indicator catches what
            # the cost series cannot.  Judged over the same recent tail
            # as churn_now — a run that oscillated EARLIER in the window
            # but is now thrashing aperiodically is a stalled plateau
            # (needs noise/restart), not an oscillation (needs damping)
            period = 2
        if period is not None:
            out["diagnosis"] = "oscillating"
            out["period"] = period
        else:
            out["diagnosis"] = "stalled-plateau"
    out["diagnosis_full"] = (
        f"oscillating(period={out['period']})"
        if out["diagnosis"] == "oscillating"
        else out["diagnosis"]
    )
    return out


def flip_summary(
    flip_count: Sequence[float], cycles: int, top: int = 5
) -> Dict[str, Any]:
    """Frozen-vs-churning per-variable summary from the device-side
    per-variable flip counters: how much of the problem has settled, and
    which variables are doing the thrashing."""
    counts = [int(c) for c in flip_count]
    n = len(counts)
    cycles = max(int(cycles), 1)
    frozen = sum(1 for c in counts if c == 0)
    churning = sum(1 for c in counts if c * 2 > cycles)
    ranked = sorted(range(n), key=lambda i: -counts[i])[:top]
    return {
        "n_vars": n,
        "frozen": frozen,
        "frozen_frac": (frozen / n) if n else 1.0,
        "churning": churning,
        "top_churners": [
            {"var": i, "flips": counts[i]} for i in ranked if counts[i] > 0
        ],
    }


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def _fingerprint(meta: Dict[str, Any]) -> str:
    blob = json.dumps(meta, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha1(blob).hexdigest()[:16]


class FlightRecorder:
    """Bounded ring buffer of the last ``capacity`` health vectors plus the
    run's config fingerprint — cheap enough to leave armed for a week-long
    solve, complete enough to diagnose the crash after the fact.

    ``maybe_dump`` writes ``postmortem.json`` (see
    :data:`POSTMORTEM_FORMAT`); it is the hook behind chaos divergence,
    solve timeout, and ``Agent.crash()``.  Dumps are best-effort by design
    (a failing disk must not mask the crash being recorded) and at most
    one per reason class per run (``agent-crash:a1``/``agent-crash:a2``
    share a slot), so a cascade of crashing agents does not rewrite the
    file with progressively emptier rings.
    """

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._rows: List[List[float]] = []
        self._start_cycle = 0  # absolute cycle index of _rows[0]
        self._meta: Dict[str, Any] = {}
        self._flips: Optional[Dict[str, Any]] = None
        self._dumped: set = set()

    def reset(self, meta: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            self._rows = []
            self._start_cycle = 0
            self._meta = dict(meta or {})
            self._flips = None
            self._dumped = set()

    def record(
        self, rows: Sequence[Sequence[float]], start_cycle: int
    ) -> None:
        """Append ``rows`` (cycle ``start_cycle`` onward); keep the tail."""
        if not len(rows):
            return
        with self._lock:
            self._rows.extend([float(v) for v in r] for r in rows)
            overflow = len(self._rows) - self.capacity
            if overflow > 0:
                del self._rows[:overflow]
            end = start_cycle + len(rows)
            self._start_cycle = end - len(self._rows)

    def set_flip_summary(self, summary: Dict[str, Any]) -> None:
        with self._lock:
            self._flips = summary

    def rows(self) -> List[List[float]]:
        """Copy of the ring's rows only — the per-chunk publish path uses
        this instead of :meth:`snapshot` so it doesn't pay for a diagnosis
        it is about to recompute."""
        with self._lock:
            return [list(r) for r in self._rows]

    def ring(self) -> Tuple[List[List[float]], int]:
        """(rows, absolute start cycle) — what a graftdur checkpoint
        carries so a resumed run's postmortem still shows the pre-kill
        history (docs/durability.md)."""
        with self._lock:
            return [list(r) for r in self._rows], self._start_cycle

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            rows = [list(r) for r in self._rows]
            doc = {
                "format": POSTMORTEM_FORMAT,
                "time": time.time(),
                "meta": dict(self._meta),
                "fingerprint": _fingerprint(self._meta),
                "fields": list(HEALTH_FIELDS),
                "start_cycle": self._start_cycle,
                "rows": rows,
            }
            if self._flips is not None:
                doc["flip_summary"] = dict(self._flips)
        doc["diagnosis"] = analyze(rows)
        return doc

    def maybe_dump(
        self, reason: str, path: Optional[str] = None
    ) -> Optional[str]:
        """Write the postmortem (once per reason CLASS per run — the part
        before ``:``, so ``agent-crash:a1`` and ``agent-crash:a2`` share
        one slot and a crash cascade keeps the FIRST agent's context
        instead of each rewrite leaving only the last) when pulse is
        enabled.  Returns the path written, or None."""
        if not pulse.enabled:
            return None
        kind = reason.split(":", 1)[0]
        with self._lock:
            if kind in self._dumped:
                return None
            self._dumped.add(kind)
        doc = self.snapshot()
        doc["reason"] = reason
        out = path or pulse.postmortem_path
        try:
            with open(out, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, sort_keys=True, default=str)
                f.write("\n")
        except OSError:
            # release the slot: a transient failure (full disk, vanished
            # state dir) must not suppress a later dump of this class —
            # the ring still holds the data
            with self._lock:
                self._dumped.discard(kind)
            return None
        return out


# ---------------------------------------------------------------------------
# the monitor singleton
# ---------------------------------------------------------------------------

_g_churn = metrics_registry.gauge(
    "solve.pulse.churn", "fraction of variables that flipped last cycle"
)
_g_residual = metrics_registry.gauge(
    "solve.pulse.residual", "algorithm-specific health residual, last cycle"
)
_g_violations = metrics_registry.gauge(
    "solve.pulse.violations",
    "hard-constraint entries in the forbidden band, last cycle",
)
_g_frozen = metrics_registry.gauge(
    "solve.pulse.frozen_frac",
    "fraction of variables that never flipped this run",
)
_g_period = metrics_registry.gauge(
    "solve.pulse.period", "detected oscillation period (0 = none)"
)
_c_flips = metrics_registry.counter(
    "solve.pulse.flips", "total variable value flips across cycles"
)
_g_state = metrics_registry.gauge(
    "solve.pulse.state",
    "1 on the row matching the current diagnosis, 0 elsewhere",
)


class PulseMonitor:
    """Process-wide pulse state, mirroring ``metrics_registry``'s pattern.

    The solver loop (``algorithms/base.py:run_cycles``) checks ``enabled``
    once per solve; when on it calls ``begin_run`` / ``publish`` /
    ``finish_run`` with the device-computed health rows.  Everything here
    is host-side bookkeeping: metrics, the JSONL stream, the flight
    recorder, and the rolling series ``/status`` serves.
    """

    #: churn/diagnosis history kept for the /status block (decimation is
    #: the watch client's job; this bounds the payload at the source)
    STATUS_SERIES = 120

    def __init__(self) -> None:
        self.enabled = False
        self.postmortem_path = "postmortem.json"
        self.recorder = FlightRecorder()
        self._lock = threading.Lock()
        self._stream = None
        self._stream_path: Optional[str] = None
        self._meta: Dict[str, Any] = {}
        self._churn_series: List[float] = []
        self._best_series: List[float] = []
        self._cycles = 0
        self._last_row: Optional[List[float]] = None
        self._last_analysis: Optional[Dict[str, Any]] = None
        self.last_report: Optional[Dict[str, Any]] = None

    # -- configuration -------------------------------------------------

    def stream_open(self, path: str) -> None:
        self.stream_close()
        with self._lock:
            self._stream = open(path, "w", encoding="utf-8")
            self._stream_path = path

    def stream_close(self) -> None:
        with self._lock:
            if self._stream is not None:
                try:
                    self._stream.close()
                except OSError:
                    pass
            self._stream = None
            self._stream_path = None

    def reset(self) -> None:
        with self._lock:
            self._meta = {}
            self._churn_series = []
            self._best_series = []
            self._cycles = 0
            self._last_row = None
            self._last_analysis = None
            self.last_report = None
        self.recorder.reset()

    # -- the run lifecycle (called by run_cycles) ----------------------

    def begin_run(self, meta: Dict[str, Any]) -> None:
        with self._lock:
            self._meta = dict(meta)
            self._churn_series = []
            self._best_series = []
            self._cycles = 0
            self._last_row = None
            self._last_analysis = None
        self.recorder.reset(meta)
        self._emit({"event": "begin", "meta": meta})

    def publish(self, rows: Sequence[Sequence[float]], start_cycle: int) -> None:
        """One batch of health rows (a chunk, or the whole fused solve)."""
        if not len(rows):
            return
        self.recorder.record(rows, start_cycle)
        flips_total = 0.0
        with self._lock:
            for r in rows:
                self._churn_series.append(float(r[_F["churn"]]))
                self._best_series.append(float(r[_F["best_cost"]]))
                flips_total += float(r[_F["flips"]])
            del self._churn_series[: -self.STATUS_SERIES]
            del self._best_series[: -self.STATUS_SERIES]
            self._cycles = start_cycle + len(rows)
            self._last_row = [float(v) for v in rows[-1]]
        analysis = analyze(self.recorder.rows())
        with self._lock:
            self._last_analysis = analysis
            last = self._last_row
        _g_churn.set(last[_F["churn"]])
        _g_residual.set(last[_F["residual"]])
        _g_violations.set(last[_F["violations"]])
        _g_period.set(float(analysis.get("period") or 0))
        _c_flips.inc(flips_total)
        for name in DIAGNOSES:
            _g_state.set(
                1.0 if name == analysis["diagnosis"] else 0.0,
                diagnosis=name,
            )
        # one buffered write + flush for the whole batch: a fused solve
        # publishes every cycle's row at once, and per-row flushes would
        # put O(n_cycles) synchronous syscalls on the solve's host path
        # (live tailing granularity is per-publish either way)
        self._emit_many(
            {
                "cycle": start_cycle + i + 1,
                **{
                    name: float(r[j])
                    for j, name in enumerate(HEALTH_FIELDS)
                },
            }
            for i, r in enumerate(rows)
        )

    def finish_run(
        self, flip_count: Optional[Sequence[float]] = None
    ) -> Dict[str, Any]:
        """Close out a run: final diagnosis + frozen/churning summary.
        Returns the report (also kept as ``last_report`` for bench_all)."""
        with self._lock:
            cycles = self._cycles
        analysis = analyze(self.recorder.rows())
        report: Dict[str, Any] = {
            "diagnosis": analysis["diagnosis_full"],
            "cycles": cycles,
            "analysis": analysis,
        }
        if flip_count is not None and len(flip_count):
            summary = flip_summary(flip_count, cycles)
            report["flip_summary"] = summary
            self.recorder.set_flip_summary(summary)
            _g_frozen.set(summary["frozen_frac"])
        with self._lock:
            self._last_analysis = analysis
            self.last_report = report
        self._emit({"event": "diagnosis", **report})
        return report

    # -- surfaces ------------------------------------------------------

    def status_block(self) -> Optional[Dict[str, Any]]:
        """The ``pulse`` block of the orchestrator's ``/status`` payload
        (None until a run published) — read-only, scrape-thread safe."""
        with self._lock:
            if self._last_row is None:
                return None
            analysis = self._last_analysis or {}
            return {
                "diagnosis": analysis.get("diagnosis_full", "no-data"),
                "cycle": self._cycles,
                "churn": self._last_row[_F["churn"]],
                "residual": self._last_row[_F["residual"]],
                "violations": self._last_row[_F["violations"]],
                "best_cost": self._last_row[_F["best_cost"]],
                "churn_series": list(self._churn_series),
            }

    def _emit(self, obj: Dict[str, Any]) -> None:
        self._emit_many((obj,))

    def _emit_many(self, objs) -> None:
        # racy fast-path read, re-checked under the lock before writing:
        # skips the whole-batch serialization when no stream is open
        if self._stream is None:  # graftlint: disable=lock-unguarded-read
            return
        # serialize OUTSIDE the lock: a fused solve publishes all
        # n_cycles rows at once, and holding the lock through the encode
        # would stall concurrent /status scrapes (status_block) for the
        # whole batch
        text = "".join(
            json.dumps(o, sort_keys=True, default=str) + "\n" for o in objs
        )
        with self._lock:
            if self._stream is None:
                return
            try:
                self._stream.write(text)
                self._stream.flush()
            except OSError:
                pass


#: Process-wide singleton, mirroring ``metrics_registry`` / ``event_bus``.
pulse = PulseMonitor()


# ---------------------------------------------------------------------------
# postmortem rendering (the ``pydcop_tpu postmortem`` verb)
# ---------------------------------------------------------------------------


def load_postmortem(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    fmt = doc.get("format") if isinstance(doc, dict) else None
    if fmt != POSTMORTEM_FORMAT:
        raise ValueError(
            f"{path}: not a pydcop_tpu postmortem "
            f"(format={fmt!r}, expected {POSTMORTEM_FORMAT!r})"
        )
    return doc


def render_postmortem(doc: Dict[str, Any], window: int = 16) -> str:
    """Human-readable diagnosis timeline of a postmortem document."""
    lines: List[str] = []
    meta = doc.get("meta", {})
    lines.append(
        f"postmortem: {doc.get('reason', '?')}  "
        f"fingerprint={doc.get('fingerprint', '?')}"
    )
    if meta:
        lines.append(
            "run: "
            + "  ".join(f"{k}={meta[k]}" for k in sorted(meta))
        )
    slo = doc.get("slo")
    if slo:
        # graftslo: the postmortem of a tripped burn-rate alert names the
        # violated objective and the burn state that tripped it
        lines.append(
            f"slo violated: {slo.get('objective', '?')} "
            f"({slo.get('describe', '?')})  severity={slo.get('severity')}"
        )
        lines.append(
            f"burn: long={slo.get('burn_long')} "
            f"short={slo.get('burn_short')} "
            f"threshold={slo.get('threshold')}  "
            f"budget_remaining={slo.get('budget_remaining')}"
        )
        for tr in slo.get("transitions", []):
            lines.append(
                f"  t={tr.get('t'):>8}s {tr.get('state'):<9} "
                f"{tr.get('objective')}/{tr.get('severity')} "
                f"burn_long={tr.get('burn_long')}"
            )
        bad = slo.get("bad_requests", [])
        if bad:
            lines.append(f"recent bad requests ({len(bad)}):")
            for r in bad[-8:]:
                lines.append(
                    f"  t={r.get('t'):>8}s {r.get('tenant'):<12} "
                    f"{r.get('status'):<7} "
                    f"latency={r.get('latency_s')}s"
                    + (
                        f"  trace={r['trace']}" if r.get("trace") else ""
                    )
                )
    rows = doc.get("rows", [])
    start = int(doc.get("start_cycle", 0))
    if not rows:
        lines.append("no health rows recorded before the failure")
        return "\n".join(lines)
    lines.append(
        f"{len(rows)} health vectors, cycles {start + 1}..{start + len(rows)}"
    )
    lines.append("")
    lines.append(
        f"{'cycles':<14} {'diagnosis':<26} {'best_cost':>12} "
        f"{'churn':>7} {'residual':>10} {'viol':>6}"
    )
    for i in range(0, len(rows), window):
        w = rows[i:i + window]
        a = analyze(w, tail=len(w))
        lines.append(
            f"{start + i + 1:>5}..{start + i + len(w):<7} "
            f"{a['diagnosis_full']:<26} {a['best_cost']:>12.6g} "
            f"{a['churn']:>7.3f} {a['residual']:>10.4g} "
            f"{int(a['violations']):>6}"
        )
    final = doc.get("diagnosis") or analyze(rows)
    lines.append("")
    lines.append(f"overall: {final.get('diagnosis_full', '?')}")
    fs = doc.get("flip_summary")
    if fs:
        lines.append(
            f"variables: {fs['frozen']}/{fs['n_vars']} frozen "
            f"({100.0 * fs['frozen_frac']:.1f}%), "
            f"{fs['churning']} churning (>50% of cycles)"
        )
        if fs.get("top_churners"):
            tops = ", ".join(
                f"#{t['var']}x{t['flips']}" for t in fs["top_churners"]
            )
            lines.append(f"top churners: {tops}")
    return "\n".join(lines)
