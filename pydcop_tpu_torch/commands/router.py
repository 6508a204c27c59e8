"""``router``: the HA serve fleet.

Counterpart of ``pydcop_tpu/commands/router.py``: N ``python -m
pydcop_tpu_torch serve`` workers behind one
:class:`~pydcop_tpu_torch.serve.router.Router` that places tenants by
bucket affinity (``distribution/tpu_part``), sheds/defers on fast-burn
SLO alerts, and fails a killed worker's tenants over onto survivors.

Endpoints (on ``--port``, next to the federated /metrics + /status):

- ``POST /solve``  serve-compatible body plus an optional
  ``"priority": "high"|"normal"|"low"`` — 200 forwarded, 202 deferred,
  structured 503 (+ ``Retry-After`` + live peers) when shed;
- ``GET  /result/<tenant>``  router-cached terminal result, or a live
  proxy to the owning worker;
- ``GET  /status``, ``GET /fleet/status``  placement map, admission
  counters, structured event tail, per-worker fleet table;
- ``GET  /healthz``  router readiness; ``GET /slo`` / ``GET /fleet/slo``
  the router-local and fleet SLO reports;
- ``POST /shutdown``  graceful drain (flush deferred, wait for
  in-flight tenants, write the router ownership manifest).

Workers come from the same sources as ``fleet`` (positional
``NAME=URL``, ``--fleet-file``, ``--manifest``) or are SPAWNED:
``--spawn N`` starts N ``sys.executable -m pydcop_tpu_torch --device D
serve`` subprocesses, ``D`` the router's own global ``--device`` (the
card unless ``--device cpu``), checkpointing into ``--state-dir`` — each
announced as a machine-parseable ``ROUTER_WORKER name=.. pid=..
port=..`` line so a chaos script can SIGKILL one mid-run and restart it
in place.  A worker that exits before it announces its port (no card
and no ``--device cpu``) makes the router exit nonzero.  The router
itself is host-only: it imports no torch.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Any, Dict, List, Tuple

from ._utils import write_output

logger = logging.getLogger("pydcop_tpu_torch.cli.router")


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "router",
        help="HA serve fleet: SLO-driven router over N workers",
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "targets", nargs="*", default=[], metavar="URL",
        help="worker endpoints: URL or NAME=URL (composes with "
        "--fleet-file / --manifest / --spawn)",
    )
    parser.add_argument(
        "--fleet-file", default=None, metavar="FILE",
        help="YAML fleet file with a workers: section (name -> url)",
    )
    parser.add_argument(
        "--manifest", default=None, metavar="PATH",
        help="a serve worker's fleet-manifest.json (or a directory searched for "
        "them): adopt workers from their recorded endpoints",
    )
    parser.add_argument(
        "--spawn", type=int, default=0, metavar="N",
        help="spawn N serve worker subprocesses (each checkpointing "
        "into --state-dir/wI, announced as ROUTER_WORKER lines)",
    )
    parser.add_argument(
        "--state-dir", default=None, metavar="DIR",
        help="shared state directory: spawned workers checkpoint into "
        "DIR/wI, the router reads victim manifests from it on failover "
        "and writes its own router-manifest.json there "
        "(default $PYDCOP_TPU_STATE_DIR or .bench_state)",
    )
    parser.add_argument(
        "--port", type=int, default=9030,
        help="HTTP port of the router surface (default 9030; 0 = "
        "ephemeral, printed on stdout)",
    )
    parser.add_argument(
        "--host", default="127.0.0.1", help="bind address"
    )
    parser.add_argument(
        "--placement", choices=("affinity", "round_robin"),
        default="affinity",
        help="tenant placement: affinity (default) lays shape buckets "
        "onto workers via distribution/tpu_part so warm executables are "
        "shared; round_robin sprays (the A/B baseline)",
    )
    parser.add_argument(
        "--interval", type=float, default=0.5,
        help="control-loop tick + worker scrape interval (default 0.5s)",
    )
    parser.add_argument(
        "--stale-after", type=float, default=10.0,
        help="drop a dead worker's series after this many seconds "
        "without a successful scrape (default 10)",
    )
    parser.add_argument(
        "--slo", action="append", default=[], metavar="SPEC",
        help="fleet SLO objective (repeatable, serve --slo grammar), "
        "evaluated over the workers' federated slo.events; fast-burn "
        "alerts gate admission",
    )
    parser.add_argument(
        "--slo-file", default=None, metavar="FILE",
        help="YAML file of fleet objectives; composes with --slo",
    )
    parser.add_argument(
        "--router-slo", action="append", default=[], metavar="SPEC",
        help="router-local objective (repeatable, same grammar) "
        "classified over FORWARD outcomes — the burn signal a worker "
        "kill produces even when the dead worker can no longer report; "
        "fast-burn alerts gate admission too",
    )
    parser.add_argument(
        "--worker-slo", action="append", default=[], metavar="SPEC",
        help="objective handed to every SPAWNED worker's --slo",
    )
    parser.add_argument(
        "--retry-attempts", type=int, default=3,
        help="forward RetryPolicy attempts per worker (default 3)",
    )
    parser.add_argument(
        "--tenant-deadline", type=float, default=120.0,
        help="per-tenant deadline in seconds: retries, deferrals and "
        "failover must finish inside it (default 120)",
    )
    parser.add_argument(
        "--defer-max", type=float, default=15.0,
        help="longest a normal-priority tenant stays deferred under "
        "sustained burn before being released anyway (default 15s)",
    )
    parser.add_argument(
        "--window-ms", type=float, default=25.0,
        help="workers' base micro-batch window; the router widens it "
        "up to --window-max-factor x when queues idle (default 25)",
    )
    parser.add_argument(
        "--window-max-factor", type=float, default=4.0,
        help="idle-widening cap on the batch window (default 4x)",
    )
    parser.add_argument(
        "--duration", type=float, default=None,
        help="route for this many seconds, then drain and exit "
        "(default: until SIGINT/SIGTERM or POST /shutdown)",
    )


def _spawn_workers(
    args, state_dir: str
) -> Tuple[List[Any], List[Tuple[str, str]]]:
    """Start ``--spawn`` serve subprocesses; returns (procs, targets).
    Each worker checkpoints into ``state_dir/wI`` (the manifests the
    router adopts terminal results from on failover) and is announced
    as a ``ROUTER_WORKER name=.. pid=.. port=..`` line."""
    import subprocess
    import sys

    procs: List[Any] = []
    targets: List[Tuple[str, str]] = []
    for i in range(args.spawn):
        name = f"w{i}"
        ckpt = os.path.join(state_dir, name)
        cmd = [
            sys.executable, "-m", "pydcop_tpu_torch",
            "--device", args.device, "serve",
            "--port", "0", "--host", args.host,
            "--window-ms", str(args.window_ms),
            "--checkpoint", ckpt,
        ]
        for spec in args.worker_slo:
            cmd += ["--slo", spec]
        proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
        )
        port = None
        deadline = time.time() + 180
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
            if line.startswith("SERVE_PORT="):
                port = int(line.strip().split("=", 1)[1])
                break
        if port is None:
            proc.kill()
            raise RuntimeError(f"spawned worker {name} never announced")
        # keep the pipe drained so the worker's final report never blocks
        threading.Thread(
            target=lambda p=proc: [None for _ in p.stdout],
            daemon=True,
        ).start()
        url = f"http://{args.host}:{port}"
        print(
            f"ROUTER_WORKER name={name} pid={proc.pid} port={port}",
            flush=True,
        )
        procs.append(proc)
        targets.append((name, url))
    return procs, targets


def run_cmd(args, timeout: float = None) -> int:
    import sys

    if timeout and not args.duration:
        args.duration = max(1.0, timeout - 5.0)
    from ..infrastructure.retry import RetryPolicy
    from ..telemetry.federate import (
        FleetTarget,
        targets_from_args,
        targets_from_fleet_file,
        targets_from_manifest,
    )
    from ..telemetry.metrics import metrics_registry
    from ..telemetry.slo import load_slo_file, parse_objective

    metrics_registry.enabled = True
    state_dir = args.state_dir or (
        os.environ.get("PYDCOP_TPU_STATE_DIR") or ".bench_state"
    )
    procs: List[Any] = []
    try:
        targets = list(targets_from_args(args.targets))
        if args.fleet_file:
            targets += targets_from_fleet_file(args.fleet_file)
        if args.manifest:
            targets += targets_from_manifest(args.manifest)
        if args.spawn:
            os.makedirs(state_dir, exist_ok=True)
            procs, spawned = _spawn_workers(args, state_dir)
            targets += [FleetTarget(n, u) for n, u in spawned]
        if not targets:
            print(
                "error: no workers — give worker URLs, --fleet-file, "
                "--manifest or --spawn N", file=sys.stderr,
            )
            return 2
        objectives, options = (
            load_slo_file(args.slo_file) if args.slo_file else ([], {})
        )
        objectives += [parse_objective(s) for s in args.slo]
        options.pop("eval_interval_s", None)  # ticks ride the loop
        router_objectives = [
            parse_objective(s) for s in args.router_slo
        ]
        from ..serve.router import Router

        router = Router(
            targets,
            port=args.port,
            host=args.host,
            placement=args.placement,
            interval_s=args.interval,
            stale_after_s=args.stale_after,
            objectives=objectives,
            router_objectives=router_objectives,
            retry=RetryPolicy(
                max_attempts=max(1, args.retry_attempts),
                base_delay=0.05, max_delay=0.5, jitter="full",
            ),
            tenant_deadline_s=args.tenant_deadline,
            defer_max_s=args.defer_max,
            window_base_ms=args.window_ms,
            window_max_factor=args.window_max_factor,
            state_dir=state_dir,
            **options,
        )
    except (OSError, RuntimeError, ValueError) as e:
        for proc in procs:
            proc.kill()
        print(f"error: {e}", file=sys.stderr)
        return 2

    for o in objectives:
        logger.warning("fleet slo objective: %s = %s", o.name, o.describe())
    for o in router_objectives:
        logger.warning(
            "router slo objective: %s = %s", o.name, o.describe()
        )
    # machine-parseable, like serve's SERVE_PORT=
    print(f"ROUTER_PORT={router.http.port}", flush=True)
    logger.warning(
        "router on http://%s:%s (%d worker(s), %s placement)",
        args.host, router.http.port, len(targets), args.placement,
    )
    router.start()
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
        if router.status()["state"] != "serving":
            break  # POST /shutdown drains the router itself
        stop.wait(0.2)
    st_before = router.status()
    drained = (
        router.shutdown(drain=True)
        if st_before["state"] == "serving"
        else st_before["state"] == "drained"
    )
    # drain spawned workers AFTER the router: in-flight tenants finish
    import urllib.request

    for t, proc in zip(targets[-len(procs):] if procs else [], procs):
        try:
            req = urllib.request.Request(
                t.url + "/shutdown", data=b"{}", method="POST"
            )
            urllib.request.urlopen(req, timeout=10).read()
        except OSError:
            pass
    for proc in procs:
        try:
            proc.wait(timeout=120)
        except Exception:  # noqa: BLE001 — a stuck worker is killed
            proc.kill()
    final = router.status()
    payload: Dict[str, Any] = {
        "drained": bool(drained),
        "state": final["state"],
        "placement": final["placement"],
        "admission": final["admission"],
        "tenant_counts": final["tenant_counts"],
        "workers_up": final["workers_up"],
        "workers_total": final["workers_total"],
        "fleet": final["fleet"],
        "events": final["events"],
    }
    if "slo" in final:
        payload["slo"] = final["slo"]
    if "router_slo" in final:
        payload["router_slo"] = final["router_slo"]
        if router.engine is not None:
            payload["router_slo_transitions"] = router.engine.transitions
    write_output(args, payload)
    metrics_registry.enabled = False
    return 0 if drained else 1
