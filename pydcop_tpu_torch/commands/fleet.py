"""``fleet``: the federation plane over N serve workers.

Counterpart of ``pydcop_tpu/commands/fleet.py``: a
:class:`~pydcop_tpu_torch.telemetry.federate.FleetCollector` polls N
worker endpoints (``/metrics.json`` + ``/status``) and re-serves the
merged, ``worker=``-labeled registry on its own live metrics surface:

- ``GET /metrics``       federated series, classic Prometheus text or
  OpenMetrics by the usual Accept negotiation (prom.py);
- ``GET /metrics.json``  the federated snapshot document;
- ``GET /status`` and ``GET /fleet/status``  the per-worker table
  (up/down, scrape age, queue depth + watermark, solves + solves/s,
  batch occupancy, pulse digest, burn rate) ``watch --fleet`` renders;
- ``GET /fleet/slo``     the fleet SLO report (with ``--slo``).

Targets come from positional ``URL`` / ``NAME=URL`` args, ``--fleet-file
YAML``, or ``--manifest`` pointing at the workers' ``fleet-manifest.json``
files (or a directory of per-worker state dirs).  ``--slo`` /
``--slo-file`` attach fleet-wide SLOs: the same objective grammar as
``serve --slo``, evaluated per worker AND fleet-aggregate over the
federated ``slo.events`` counters; fleet alerts name the worst worker.
``--port 0`` picks a free port, announced on stdout as
``FLEET_PORT=<n>``; ``--once`` polls once and prints the fleet status.

Host-only: it imports no torch and needs no card.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Any, Dict

from ._utils import write_output

logger = logging.getLogger("pydcop_tpu_torch.cli.fleet")


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "fleet",
        help="federate worker metrics into one fleet surface",
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "targets", nargs="*", default=[], metavar="URL",
        help="worker endpoints: URL or NAME=URL (composes with "
        "--fleet-file / --manifest)",
    )
    parser.add_argument(
        "--fleet-file", default=None, metavar="FILE",
        help="YAML fleet file with a workers: section (name -> url)",
    )
    parser.add_argument(
        "--manifest", default=None, metavar="PATH",
        help="a serve worker's fleet-manifest.json (or a directory searched for "
        "them): workers federate from their recorded endpoints",
    )
    parser.add_argument(
        "--port", type=int, default=9020,
        help="HTTP port of the fleet surface (default 9020; 0 = "
        "ephemeral, printed on stdout)",
    )
    parser.add_argument(
        "--host", default="127.0.0.1", help="bind address"
    )
    parser.add_argument(
        "--interval", type=float, default=1.0,
        help="seconds between worker scrapes (default 1.0)",
    )
    parser.add_argument(
        "--stale-after", type=float, default=10.0,
        help="drop a dead worker's series after this many seconds "
        "without a successful scrape (default 10)",
    )
    parser.add_argument(
        "--slo", action="append", default=[], metavar="SPEC",
        help="fleet SLO objective (repeatable, serve --slo grammar): "
        "evaluated per worker and fleet-aggregate over federated "
        "slo.events; fleet alerts name the worst worker",
    )
    parser.add_argument(
        "--slo-file", default=None, metavar="FILE",
        help="YAML file of objectives (serve --slo-file format); "
        "composes with --slo",
    )
    parser.add_argument(
        "--duration", type=float, default=None,
        help="federate for this many seconds, then exit "
        "(default: until SIGINT/SIGTERM)",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="poll every worker once, print the fleet status JSON, exit "
        "(non-zero when every worker is down)",
    )


def _collect_targets(args):
    from ..telemetry.federate import (
        targets_from_args,
        targets_from_fleet_file,
        targets_from_manifest,
    )

    targets = list(targets_from_args(args.targets))
    if args.fleet_file:
        targets += targets_from_fleet_file(args.fleet_file)
    if args.manifest:
        targets += targets_from_manifest(args.manifest)
    return targets


def run_cmd(args, timeout: float = None) -> int:
    import sys

    if timeout and not args.duration:
        args.duration = max(1.0, timeout - 5.0)
    from ..telemetry.federate import FleetCollector, FleetSlo

    try:
        targets = _collect_targets(args)
        if not targets:
            print(
                "error: no fleet targets — give worker URLs, "
                "--fleet-file or --manifest", file=sys.stderr,
            )
            return 2
        collector = FleetCollector(
            targets,
            interval_s=args.interval,
            stale_after_s=args.stale_after,
        )
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    fleet_slo = None
    if args.slo or args.slo_file:
        from ..telemetry.slo import load_slo_file, parse_objective

        objectives, options = (
            load_slo_file(args.slo_file) if args.slo_file else ([], {})
        )
        objectives += [parse_objective(s) for s in args.slo]
        options.pop("eval_interval_s", None)  # ticks ride the poll loop
        fleet_slo = FleetSlo(collector, objectives, **options)
        for o in objectives:
            logger.warning("fleet slo objective: %s = %s", o.name, o.describe())

    if args.once:
        collector.poll()
        if fleet_slo is not None:
            fleet_slo.evaluate()
        status = collector.status()
        if fleet_slo is not None:
            status["slo"] = fleet_slo.status_block()
        write_output(args, status)
        return 0 if status["workers_up"] > 0 else 1

    def _status() -> Dict[str, Any]:
        status = collector.status()
        if fleet_slo is not None:
            status["slo"] = fleet_slo.status_block()
        return status

    def _snapshot() -> Dict[str, Any]:
        snap = collector.snapshot()
        if fleet_slo is not None:
            snap["metrics"].update(fleet_slo.metrics_block())
        return snap

    def _http_fleet_status(path: str, body: bytes):
        return 200, _status()

    def _http_fleet_slo(path: str, body: bytes):
        if fleet_slo is None:
            return 404, {"error": "no fleet SLOs configured"}
        return 200, fleet_slo.status_block()

    from ..infrastructure.ui import MetricsHttpServer

    http = MetricsHttpServer(
        port=args.port,
        host=args.host,
        status_cb=_status,
        snapshot_cb=_snapshot,
        routes={
            ("GET", "/fleet/status"): _http_fleet_status,
            ("GET", "/fleet/slo"): _http_fleet_slo,
        },
    )
    # machine-parseable, like serve's SERVE_PORT=
    print(f"FLEET_PORT={http.port}", flush=True)
    logger.warning(
        "fleet surface on http://%s:%s (%d worker(s), %.1fs interval)",
        args.host, http.port, len(targets), args.interval,
    )
    collector.start(
        on_tick=(fleet_slo.evaluate if fleet_slo is not None else None)
    )
    stop = threading.Event()

    def _sig(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    deadline = (
        time.monotonic() + args.duration
        if args.duration is not None else None
    )
    while not stop.is_set():
        if deadline is not None and time.monotonic() >= deadline:
            break
        stop.wait(0.2)
    collector.stop()
    http.shutdown()
    status = _status()
    payload: Dict[str, Any] = {
        "workers_total": status["workers_total"],
        "workers_up": status["workers_up"],
        "fleet": status["fleet"],
        "workers": status["workers"],
    }
    if fleet_slo is not None:
        payload["slo"] = status["slo"]
    write_output(args, payload)
    return 0
