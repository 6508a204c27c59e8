"""``watch``: a live terminal view of a running server or solve.

Counterpart of ``pydcop_tpu/commands/watch.py``: polls a live metrics
surface (``/status`` and ``/metrics.json``: the ``serve`` verb's port, or
a JAX package orchestrator's) and renders, in place, the run status,
the anytime cost (a ``cost_curve`` sparkline), the pulse, SLO,
durability, replication and memory blocks, the device windows, per-agent
queues and message rates (from counter deltas between polls) and the
reliability counters.  Host-only: it imports no torch and
needs no card, so it runs from a second terminal beside a solve.

``--once`` prints one frame and exits (non-zero when nothing answers);
``--json`` writes the merged status and metrics document instead of the
view; ``--interval`` and ``--duration`` pace and end the polling.

``--fleet URL`` points the watch at a federation surface (the ``fleet``
verb's, or the ``router``'s) instead of one worker: the frame becomes the
live per-worker table — up/down, scrape age, queue depth + watermark,
solves and solves/s (from ``fleet.worker_solves_total`` counter deltas
between polls, clamped at 0 across worker restarts), batch occupancy,
memory, pulse digest, burn rate — plus the fleet totals and fleet SLO
lines.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional, Tuple

from ..telemetry.federate import clamped_rate
from ._utils import write_output

logger = logging.getLogger("pydcop_tpu_torch.cli.watch")

#: terminal statuses: once the run reports one of these, stop polling
_TERMINAL = {"FINISHED", "STOPPED", "ERROR", "TIMEOUT"}

_SPARK = "▁▂▃▄▅▆▇█"


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "watch", help="live terminal view of a running solve's metrics"
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "url", nargs="?", default=None,
        help="base URL of the live metrics surface "
        "(default http://127.0.0.1:PORT from --port)",
    )
    parser.add_argument(
        "--port", type=int, default=9001,
        help="metrics port when no URL is given (default 9001)",
    )
    parser.add_argument(
        "--host", default="127.0.0.1",
        help="metrics host when no URL is given",
    )
    parser.add_argument(
        "--interval", type=float, default=1.0,
        help="seconds between polls (default 1.0)",
    )
    parser.add_argument(
        "--duration", type=float, default=None,
        help="stop watching after this many seconds",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="print one frame and exit (non-zero if unreachable)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the merged status+metrics JSON instead of the view",
    )
    parser.add_argument(
        "--fleet", default=None, metavar="URL",
        help="watch a federation surface (the fleet or router verb's) "
        "instead of a single worker: renders the per-worker table",
    )


def _fetch_json(base: str, path: str) -> Optional[Dict[str, Any]]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=2.0) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except (urllib.error.URLError, OSError, ValueError, TimeoutError):
        return None


def _metric_values(
    metrics: Dict[str, Any], name: str
) -> Dict[Tuple[Tuple[str, str], ...], float]:
    m = metrics.get(name)
    if not m:
        return {}
    out = {}
    for entry in m.get("values", []):
        value = entry.get("value")
        if isinstance(value, dict):  # histogram: use the count
            value = value.get("count", 0)
        out[tuple(sorted(entry.get("labels", {}).items()))] = float(value)
    return out


def _total(metrics: Dict[str, Any], name: str) -> float:
    return sum(_metric_values(metrics, name).values())


def sparkline(values, width: int = 60) -> str:
    """Unicode sparkline of a numeric series, decimated to ``width``."""
    from ..telemetry.summary import decimate_series

    vals = [float(v) for v in values if v is not None]
    if not vals:
        return ""
    vals = decimate_series(vals, width)
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK[min(len(_SPARK) - 1, int((v - lo) / span * (len(_SPARK) - 1)))]
        for v in vals
    )


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n:.0f}B"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _render_frame(
    status: Dict[str, Any],
    metrics: Dict[str, Any],
    rates: Dict[str, Dict[str, float]],
) -> str:
    lines = []
    best = status.get("best_cost")
    lines.append(
        f"status: {status.get('status', '?'):<10} "
        f"t={status.get('time', 0.0):>7.2f}s  "
        f"cycle={status.get('cycle', 0)}  "
        f"cost={status.get('cost')}  "
        f"best={best if best is not None else '-'}"
        + (
            f" (cycle {int(status['cycles_to_best'])})"
            if status.get("cycles_to_best") is not None
            else ""
        )
    )
    curve = status.get("cost_curve")
    if curve:
        lines.append(f"anytime cost  {sparkline(curve)}")
        lines.append(
            f"              {curve[0]:.6g} -> {curve[-1]:.6g} "
            f"({len(curve)} points)"
        )
    pulse_b = status.get("pulse")
    if pulse_b:
        # the pulse block: one diagnosis line + the churn
        # sparkline (fraction of variables flipping per cycle)
        lines.append(
            f"pulse: {pulse_b.get('diagnosis', '?'):<24} "
            f"cycle={pulse_b.get('cycle', 0)}  "
            f"churn={pulse_b.get('churn', 0.0):.3f}  "
            f"residual={pulse_b.get('residual', 0.0):.4g}  "
            f"violations={int(pulse_b.get('violations', 0))}"
        )
        churn_series = pulse_b.get("churn_series")
        if churn_series:
            lines.append(f"churn         {sparkline(churn_series)}")
    slo_b = status.get("slo")
    if slo_b:
        # SLOs: one line per objective — budget left, the fast-window
        # burn rate, and the firing alert if any (the actionable part)
        for name, ob in sorted(
            (slo_b.get("objectives") or {}).items()
        ):
            alert = ob.get("alert")
            lines.append(
                f"slo: {name:<18} budget={100.0 * ob.get('budget_remaining', 1.0):6.1f}%  "
                f"burn={ob.get('burn_fast', 0.0):6.2f}  "
                f"good/bad={int(ob.get('good', 0))}/{int(ob.get('bad', 0))}"
                + (f"  ALERT[{alert}]" if alert else "")
            )
    dura_b = status.get("durability")
    if dura_b:
        # durability: where the checkpoints land + how far the trail goes
        resumed = dura_b.get("resumed_from") or {}
        cursor = (dura_b.get("extra") or {}).get("scenario_cursor")
        lines.append(
            f"durability: {int(dura_b.get('checkpoints', 0))} "
            f"checkpoint(s) in {dura_b.get('directory', '?')}"
            + (
                f"  every={dura_b.get('every_cycles')}cyc"
                if dura_b.get("every_cycles") else ""
            )
            + (
                f" resumed@{resumed.get('cycle')}" if resumed else ""
            )
            + (f"  scenario_cursor={cursor}" if cursor else "")
        )
    rep_b = status.get("replication")
    if rep_b:
        # replication: k-resilience health — protocol counters plus the
        # computations still below the k-target (the actionable part)
        below = rep_b.get("below_target") or []
        lines.append(
            f"replication: mode={rep_b.get('mode', '?')} "
            f"k={rep_b.get('ktarget', '?')}  "
            f"visits={int(rep_b.get('visits', 0))}  "
            f"refusals={int(rep_b.get('refusals', 0))}  "
            f"retractions={int(rep_b.get('retractions', 0))}"
            + (f"  BELOW TARGET: {', '.join(below)}" if below else "")
        )
    device_cycles = _total(metrics, "solve.device_cycles")
    windows = _total(metrics, "solve.windows")
    if windows:
        lines.append(
            f"device: {int(device_cycles)} cycles over {int(windows)} "
            f"readback windows, "
            f"{int(_total(metrics, 'solve.readback_bytes'))} B read back"
        )
    mem_b = status.get("memory")
    if mem_b and (
        mem_b.get("limit_bytes") is not None
        or mem_b.get("bytes_in_use") is not None
        or (mem_b.get("guard") or {}).get("enabled")
    ):
        # memory: the live memory line — allocator gauges (degraded
        # backends show '-'), the model's prediction, guard + refusals
        guard = mem_b.get("guard") or {}
        headroom = mem_b.get("headroom_pct")
        predicted = _metric_values(metrics, "mem.predicted_bytes")
        pred = max(predicted.values()) if predicted else None
        lines.append(
            f"memory: in_use={_fmt_bytes(mem_b.get('bytes_in_use'))}  "
            f"peak={_fmt_bytes(mem_b.get('peak_bytes'))}  "
            f"limit={_fmt_bytes(mem_b.get('limit_bytes'))}  "
            f"headroom="
            + (f"{headroom:.1f}%" if headroom is not None else "-")
            + f"  predicted={_fmt_bytes(pred)}"
            + (
                f"  guard=on({guard.get('reserve_pct', 0):g}%)"
                if guard.get("enabled") else "  guard=off"
            )
            + (
                f"  refusals={int(mem_b['refusals_total'])}"
                if mem_b.get("refusals_total") else ""
            )
        )
    agents = status.get("agents") or {}
    sent = _metric_values(metrics, "comms.messages_sent")
    recv = _metric_values(metrics, "comms.messages_received")
    if agents or sent:
        lines.append("")
        lines.append(
            f"{'agent':<16} {'queue':>6} {'parked':>7} {'dead':>5} "
            f"{'sent':>8} {'recv':>8} {'msg/s':>8}"
        )
        names = sorted(
            set(agents)
            | {dict(k).get("agent", "?") for k in sent}
            | {dict(k).get("agent", "?") for k in recv}
        )
        for name in names:
            a = agents.get(name, {})
            key = (("agent", name),)
            rate = rates.get(name, {}).get("msg_s")
            lines.append(
                f"{name:<16} {a.get('queue', '-'):>6} "
                f"{a.get('parked', '-'):>7} {a.get('dead_letters', '-'):>5} "
                f"{int(sent.get(key, 0)):>8} {int(recv.get(key, 0)):>8} "
                f"{(f'{rate:.1f}' if rate is not None else '-'):>8}"
            )
    reliability = []
    for name in (
        "comms.send_failures", "comms.dead_letters", "comms.retry_attempts",
        "chaos.events", "telemetry.dispatch_errors",
    ):
        total = _total(metrics, name)
        if total:
            reliability.append(f"{name}={int(total)}")
    if reliability or status.get("dead_letters"):
        lines.append("")
        lines.append(
            "reliability: "
            + (" ".join(reliability) if reliability else "ok")
            + (
                f"  dead_letters={status['dead_letters']}"
                if status.get("dead_letters")
                else ""
            )
        )
    return "\n".join(lines)


def _render_fleet_frame(
    status: Dict[str, Any],
    rates: Dict[str, float],
) -> str:
    """The ``--fleet`` view: one row per worker + fleet totals + the
    fleet SLO lines (per-worker engines summarized by their alerts)."""
    lines = []
    fl = status.get("fleet") or {}
    lines.append(
        f"fleet: {status.get('workers_up', 0)}/"
        f"{status.get('workers_total', 0)} workers up  "
        f"solves={fl.get('solves', 0)}  "
        f"queue={fl.get('queue_depth', 0)}  "
        f"dead_letters={fl.get('dead_letters', 0)}  "
        f"solves/s={fl.get('solves_s', 0.0)}"
    )
    workers = status.get("workers") or {}
    if workers:
        lines.append("")
        lines.append(
            f"{'worker':<18} {'up':>4} {'age':>6} {'queue':>6} {'hwm':>5} "
            f"{'solves':>8} {'sol/s':>7} {'occ%':>5} {'mem':>9} "
            f"{'hdrm%':>6} {'pulse':<18} {'burn':>6} alert"
        )
        for name in sorted(workers):
            w = workers[name]
            age = w.get("age_s")
            rate = rates.get(name, w.get("solves_s"))
            burn = w.get("burn_fast")
            mem_h = w.get("mem_headroom_pct")
            lines.append(
                f"{name:<18} {('UP' if w.get('up') else 'DOWN'):>4} "
                f"{(f'{age:.1f}' if age is not None else '-'):>6} "
                f"{w.get('queue_depth', '-'):>6} "
                f"{w.get('queue_watermark', '-'):>5} "
                f"{w.get('solves', '-'):>8} "
                f"{(f'{rate:.1f}' if rate is not None else '-'):>7} "
                f"{w.get('occupancy_pct', '-'):>5} "
                f"{_fmt_bytes(w.get('mem_bytes_in_use')):>9} "
                f"{(f'{mem_h:.1f}' if mem_h is not None else '-'):>6} "
                f"{(w.get('pulse') or '-'):<18} "
                f"{(f'{burn:.2f}' if burn is not None else '-'):>6} "
                f"{w.get('alert', '')}"
                + (
                    f" mem_refused={w['mem_refusals']}"
                    if w.get("mem_refusals") else ""
                )
                + ("  STALE" if w.get("stale") else "")
            )
    slo_b = (status.get("slo") or {}).get("fleet")
    if slo_b:
        lines.append("")
        for name, ob in sorted((slo_b.get("objectives") or {}).items()):
            alert = ob.get("alert")
            worst = ob.get("worst_worker")
            lines.append(
                f"fleet slo: {name:<18} "
                f"budget={100.0 * ob.get('budget_remaining', 1.0):6.1f}%  "
                f"burn={ob.get('burn_fast', 0.0):6.2f}  "
                f"good/bad={int(ob.get('good', 0))}/{int(ob.get('bad', 0))}"
                + (f"  ALERT[{alert}] worst={worst}" if alert else "")
            )
    return "\n".join(lines)


def run_cmd(args, timeout: float = None) -> int:
    # embedders call run_cmd with hand-built namespaces predating --fleet
    fleet = getattr(args, "fleet", None)
    base = fleet or args.url or f"http://{args.host}:{args.port}"
    base = base.rstrip("/")
    status_path = "/fleet/status" if fleet else "/status"
    deadline = (
        time.perf_counter() + args.duration if args.duration else None
    )
    if timeout is not None:
        t_cli = time.perf_counter() + timeout
        deadline = min(deadline, t_cli) if deadline else t_cli

    prev_sent: Dict[str, float] = {}
    prev_t: Optional[float] = None
    seen_ok = False
    frames = 0
    while True:
        status = _fetch_json(base, status_path)
        snapshot = _fetch_json(base, "/metrics.json")
        if status is None or snapshot is None:
            if args.once or not seen_ok:
                print(
                    f"error: no metrics surface at {base} — start the "
                    + ("fleet verb first" if fleet else
                       "serve verb (or a solve with a live surface) first"),
                    file=sys.stderr,
                )
                return 1
            # the run (and its endpoint) ended between polls: that is the
            # normal way a watch of a finishing solve terminates
            print(f"\n{base} gone — run ended", file=sys.stderr)
            return 0
        seen_ok = True
        metrics = snapshot.get("metrics", {})

        now = time.perf_counter()
        # rates from counter deltas between our polls, clamped at 0 and
        # re-baselined when the scraped counter reset (a worker restart):
        # the federated collector's rule (telemetry/federate.py)
        rate_metric, rate_label = (
            ("fleet.worker_solves_total", "worker") if fleet
            else ("comms.messages_sent", "agent")
        )
        sent_now = {
            dict(k).get(rate_label, "?"): v
            for k, v in _metric_values(metrics, rate_metric).items()
        }
        rates: Dict[str, Any] = {}
        if prev_t is not None and now > prev_t:
            for name, v in sent_now.items():
                r = clamped_rate(prev_sent.get(name, 0.0), v, now - prev_t)
                rates[name] = {"msg_s": r} if not fleet else r
        prev_sent, prev_t = sent_now, now

        if args.as_json:
            write_output(args, {"status": status, "metrics": metrics})
        else:
            frame = (
                _render_fleet_frame(status, rates) if fleet
                else _render_frame(status, metrics, rates)
            )
            if frames and sys.stdout.isatty():
                # repaint in place; scrolling output otherwise
                print("\x1b[2J\x1b[H", end="")
            print(frame)
            sys.stdout.flush()
        frames += 1

        if args.once:
            return 0
        if status.get("status") in _TERMINAL:
            return 0
        if deadline is not None and time.perf_counter() >= deadline:
            return 0
        time.sleep(max(0.05, args.interval))
