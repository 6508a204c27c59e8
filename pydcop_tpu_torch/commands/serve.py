"""``serve``: the many-tenant batched solve server on the card.

Counterpart of ``pydcop_tpu/commands/serve.py``: an HTTP front end
(``serve.server.ServeServer``) where tenants POST DCOPs and one device
solves them in shape-bucketed batches.  On ``--port`` (0 picks a free
one, announced on stdout as ``SERVE_PORT=<n>``):

- ``POST /solve``, body ``{"dcop_yaml": "...", "algo": "dsa", "params":
  {...}, "n_cycles": 100, "seed": 0, "tenant": "optional-id"}``, answers
  ``{"tenant": id}``;
- ``GET /result/<tenant>``: its state, and its cost and assignment once
  done;
- ``GET /status``: the server's state, queue depth, queue latency and
  the ``memory`` block;
- ``POST /shutdown``: a graceful drain, then the process exits.

It drains on SIGINT and SIGTERM too, or after ``--duration`` seconds, and
writes the drain's summary as JSON.  Pulse health rows are on by default
(``--no-pulse`` turns them off): each done tenant's ``/status`` row and
``/result`` carry its pulse block.  ``--checkpoint [DIR]`` writes the
fleet checkpoint at the drain (``DIR``, or ``default_checkpoint_dir()``).
``--fault-schedule FILE`` loads a chaos schedule into the server: timed
kills match tenant ids (a killed tenant is a dead letter, its batch's
other tenants untouched) and ``delay`` rules hold the matching tenants
alone.  ``--mem-guard`` (or ``--mem-reserve-pct``, ``--mem-limit-bytes``)
arms the admission guard: a tenant predicted not to fit is answered 503
with the breach under ``mem``.  The JAX verb's SLO objectives and peers
are parsed and refused as not ported yet.
"""

from __future__ import annotations

import logging
import signal
import sys
import threading
import time
from typing import Any, Dict

from ._utils import (
    add_memguard_arguments,
    configure_memguard,
    write_output,
)

logger = logging.getLogger("pydcop_tpu_torch.cli.serve")

# (flags, argparse keywords, what the option belongs to): options of the
# JAX package's ``serve`` that the port does not run yet
_NOT_PORTED = (
    (("--slo",), dict(action="append", default=[]), "SLO objectives"),
    (("--slo-file",), dict(default=None), "SLO objectives"),
    (("--slo-interval",), dict(type=float, default=None), "SLO objectives"),
    (("--peer",), dict(action="append", default=[]), "the HA fleet"),
)


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "serve", help="serve many tenant solves in batches on the device"
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "--port", type=int, default=9010,
        help="HTTP port for /solve, /result, /status (default 9010; 0 = "
        "a free one, printed on stdout)",
    )
    parser.add_argument("--host", default="127.0.0.1", help="bind address")
    parser.add_argument(
        "--window-ms", type=float, default=25.0,
        help="micro-batching window: how long the first queued request "
        "waits for co-batchable tenants (default 25 ms)",
    )
    parser.add_argument(
        "--max-batch", type=int, default=32,
        help="max tenants per batch (default 32)",
    )
    parser.add_argument(
        "--batch-mode", choices=("vmap", "fused"), default="vmap",
        help="vmap (default): each tenant gets the bits of its own solo "
        "solve, one batch per shape bucket; fused: the tenants as one "
        "block-diagonal union solve from one fleet seed",
    )
    parser.add_argument(
        "--no-pulse", action="store_true",
        help="disable the per-tenant pulse health rows (on by default)",
    )
    parser.add_argument(
        "--checkpoint", nargs="?", const="", default=None, metavar="DIR",
        help="a graceful drain writes a fleet checkpoint (the tenant "
        "census and terminal results) into DIR (default "
        "$PYDCOP_TPU_STATE_DIR/checkpoints)",
    )
    parser.add_argument(
        "--fault-schedule", default=None, metavar="FILE",
        help="chaos YAML schedule: timed kills match tenant ids, delay "
        "rules hold the matching tenants",
    )
    parser.add_argument(
        "--duration", type=float, default=None,
        help="serve for this many seconds, then drain and exit (default: "
        "until SIGINT/SIGTERM or POST /shutdown)",
    )
    add_memguard_arguments(parser)
    for flags, kwargs, _what in _NOT_PORTED:
        parser.add_argument(*flags, help="not ported yet", **kwargs)


def _refused_option(args):
    for flags, kwargs, what in _NOT_PORTED:
        dest = flags[-1].lstrip("-").replace("-", "_")
        if getattr(args, dest) != kwargs.get("default", False):
            return flags[-1], what
    return None


def run_cmd(args, timeout: float = None) -> int:
    refused = _refused_option(args)
    if refused is not None:
        flag, what = refused
        print(f"error: serve {flag} ({what}) is not ported yet",
              file=sys.stderr)
        return 2
    # the global -t timeout maps onto --duration: serve then drains
    # instead of being killed by the alarm mid-batch
    if timeout and not args.duration:
        args.duration = max(1.0, timeout - 5.0)
    from ..serve import ServeServer
    from ..telemetry.pulse import pulse

    if configure_memguard(args):
        from ..telemetry.memplane import memguard

        logger.warning(
            "memory admission guard armed (reserve %.1f%%%s)",
            memguard.reserve_pct,
            f", limit override {memguard.limit_bytes} B"
            if memguard.limit_bytes else "",
        )
    schedule = None
    if args.fault_schedule:
        from ..chaos.schedule import load_fault_schedule

        schedule = load_fault_schedule(args.fault_schedule)
    checkpoint_dir = args.checkpoint
    if checkpoint_dir == "":
        from ..durability import default_checkpoint_dir

        checkpoint_dir = default_checkpoint_dir()
    srv = ServeServer(
        port=args.port, host=args.host, window_ms=args.window_ms,
        max_batch=args.max_batch, mode=args.batch_mode, device=args.device,
        checkpoint_dir=checkpoint_dir, fault_schedule=schedule,
    )
    if not args.no_pulse:
        pulse.reset()
        pulse.enabled = True
    print(f"SERVE_PORT={srv.http.port}", flush=True)
    logger.warning(
        "serving on http://%s:%s (window %.0f ms, max batch %d, %s)",
        args.host, srv.http.port, args.window_ms, args.max_batch,
        srv.device,
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
    # POST /shutdown drains the server itself: watch its state too
    while not stop.is_set():
        if deadline is not None and time.monotonic() >= deadline:
            break
        if srv.status()["state"] != "serving":
            break
        stop.wait(0.2)
    if srv.status()["state"] == "serving":
        drained = srv.shutdown(drain=True)
    else:
        drained = srv.wait_drained(120.0)
    final = srv.status()
    payload: Dict[str, Any] = {
        "drained": bool(drained),
        "solves": final["solves"],
        "batches": final["batches"],
        "dead_letters": final["dead_letters"],
        "degraded": final["degraded"],
        "tenant_counts": final["tenant_counts"],
        "queue_ms": final["queue_ms"],
    }
    if srv.fleet_checkpoint_path:
        payload["fleet_checkpoint"] = srv.fleet_checkpoint_path
    write_output(args, payload)
    pulse.enabled = False
    return 0 if drained else 1
