"""``solve``: a static DCOP from YAML files, solved on the device.

Counterpart of ``pydcop_tpu/commands/solve.py`` in its ``--mode direct``:
load the problem, compile it, solve it on the card (or the CPU with the
global ``--device cpu``) and print the result JSON, the same schema and
the same text as the JAX package's.  ``--pulse-out`` streams the solve's
per-cycle health rows as JSONL (and arms the flight recorder, which
dumps ``postmortem.json`` when a ``--timeout`` runs out);
``--checkpoint``/``--resume`` and their cadence flags make the solve
durable, and ``--fault-schedule`` arms a schedule's process kills
(``kill_process``: ``os._exit`` at its time, the crash that a
``--resume`` recovers from) around the solve, as the JAX package's
direct mode does; ``--run_metrics``/``--end_metrics`` write the CSV
metrics; ``--trace-out`` writes the engine's window and read-back spans
as a Chrome trace (or JSONL for a ``.jsonl`` path) and ``--metrics-out``
the metrics registry's snapshot as JSON, with the JAX package's names.
``--mem-guard``, ``--mem-reserve-pct`` and ``--mem-limit-bytes`` arm the
memory guard: a solve predicted not to fit is refused before anything is
uploaded, with an ``ERROR`` result that carries the breach (``mem``).
The options of its other modes (the thread/process agent runtime, the
other telemetry flags) are parsed, so a command written for the JAX
package gets a clear refusal naming the option instead of a usage
error.
"""

from __future__ import annotations

import csv
import logging
import os
import sys
import time

from ..constants import INFINITY
from ..dcop.yamldcop import load_dcop_from_file
from ._utils import (
    add_chaos_arguments,
    add_csvio_arguments,
    add_durability_arguments,
    add_memguard_arguments,
    build_algo_def,
    build_chaos_controller,
    configure_memguard,
    finish_durability,
    finish_telemetry,
    start_durability,
    start_telemetry,
    write_output,
)

logger = logging.getLogger("pydcop_tpu_torch.cli.solve")

# (flags, argparse keywords, what the option belongs to): options of the
# JAX package's ``solve`` that the port does not run yet.  Each refuses
# when given a value other than its default.
_NOT_PORTED = (
    (("-m", "--mode"), dict(choices=["direct", "thread", "process"],
                            default="direct"), "the agent runtime"),
    (("-c", "--collect_on"),
     dict(choices=["value_change", "cycle_change", "period"],
          default="value_change"), "the agent runtime"),
    (("--period",), dict(type=float, default=None), "the agent runtime"),
    (("--delay",), dict(type=float, default=None), "the agent runtime"),
    (("--uiport",), dict(type=int, default=None), "the agent runtime"),
    (("--profile",), dict(default=None), "telemetry"),
    (("--metrics-port",), dict(type=int, default=None), "telemetry"),
    (("--profile-out",), dict(default=None), "telemetry"),
    (("--dump-hlo",), dict(default=None), "telemetry"),
)


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "solve", help="solve a static DCOP on the device"
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    parser.add_argument(
        "-a", "--algo", required=True, help="algorithm name"
    )
    parser.add_argument(
        "-p",
        "--algo_params",
        action="append",
        default=None,
        help="algorithm parameter as name:value (repeatable)",
    )
    parser.add_argument(
        "-d",
        "--distribution",
        default="oneagent",
        help="distribution method, reported in the result",
    )
    parser.add_argument(
        "-n", "--n_cycles", type=int, default=100,
        help="number of synchronous cycles to run",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--collect_curve", action="store_true",
        help="include the per-cycle cost curve in the result",
    )
    parser.add_argument(
        "-i", "--infinity", type=float, default=INFINITY,
        help="value standing in for symbolic infinity when reporting "
        f"hard-constraint costs (default {INFINITY})",
    )
    parser.add_argument(
        "--pulse-out", default=None, metavar="FILE",
        help="compute per-cycle health vectors in the cycle loop and "
        "stream them to FILE as JSONL; arms the flight recorder "
        "(postmortem.json on a timeout)",
    )
    parser.add_argument(
        "--trace-out", default=None, metavar="FILE",
        help="record spans (the engine's readback windows and read-backs) "
        "and write a Chrome trace to FILE (JSONL for a .jsonl path)",
    )
    parser.add_argument(
        "--metrics-out", default=None, metavar="FILE",
        help="enable the metrics registry and write its JSON snapshot to "
        "FILE at exit",
    )
    add_csvio_arguments(parser)
    add_chaos_arguments(parser)
    add_durability_arguments(parser)
    add_memguard_arguments(parser)
    for flags, kwargs, _what in _NOT_PORTED:
        parser.add_argument(*flags, help="not ported yet", **kwargs)


def _refused_option(args):
    """(flag, what it belongs to) of the first option given that the port
    does not run, or None."""
    for flags, kwargs, what in _NOT_PORTED:
        dest = flags[-1].lstrip("-").replace("-", "_")
        default = kwargs.get("default", False)
        if getattr(args, dest) != default:
            return flags[-1], what
    return None


def _dump_run_metrics(path: str, curve, offset: int = 0) -> None:
    """Per-cycle cost CSV; ``offset`` is the absolute cycle the curve
    starts after (a ``--resume`` run's curve covers the resumed cycles
    only)."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["cycle", "cost"])
        for i, c in enumerate(curve or []):
            w.writerow([offset + i + 1, c])


def run_cmd(args, timeout: float = None) -> int:
    refused = _refused_option(args)
    if refused is not None:
        flag, what = refused
        print(
            f"error: solve {flag} ({what}) is not ported yet; the port runs "
            f"--mode direct only",
            file=sys.stderr,
        )
        return 2
    start_telemetry(args)
    manager = start_durability(args)
    configure_memguard(args)
    try:
        return _run_cmd(args, timeout)
    finally:
        # a failed or timed-out solve keeps the checkpoints it wrote
        finish_durability(args, manager)
        finish_telemetry(args)


def _arm_process_kills(args):
    """The --fault-schedule controller with its timeline started, or None
    when the schedule has no process kill.  Agent kills, message rules
    and device faults need the agent runtime: logged and ignored."""
    chaos = build_chaos_controller(args)
    if chaos is None:
        return None
    sched = chaos.schedule
    if sched.kills or sched.rules or sched.device_faults:
        logger.warning(
            "--fault-schedule: agent kills / message rules / device "
            "faults need the agent runtime; direct mode ignores them "
            "(the port runs --mode direct only)"
        )
    if not sched.process_kills:
        return None
    # whole-process kills need no agents: arm the timeline around the
    # device solve
    chaos.start(None)
    return chaos


def _run_cmd(args, timeout: float = None) -> int:
    t_load = time.perf_counter()
    dcop = load_dcop_from_file(args.dcop_files)
    logger.info(
        "loaded %s in %.3fs", args.dcop_files,
        time.perf_counter() - t_load,
    )
    algo_def = build_algo_def(
        args.algo, args.algo_params, mode=dcop.objective
    )
    from ..api import solve_result
    from ..telemetry.memplane import MemoryBudgetExceeded

    chaos = _arm_process_kills(args)
    try:
        result = solve_result(
            dcop,
            algo_def,
            distribution=args.distribution,
            n_cycles=args.n_cycles,
            seed=args.seed,
            collect_curve=bool(args.collect_curve or args.run_metrics),
            timeout=timeout,
            infinity=args.infinity,
            device=args.device,
        )
    except MemoryBudgetExceeded as e:
        # the guard's refusal, before anything was uploaded: its numbers
        # in the result, as the JAX package's CLI writes them
        logger.error("%s", e)
        result = {"status": "ERROR", "error": str(e), "mem": e.breach}
    if chaos is not None:
        # the fault timeline is part of the run: a process kill due at t
        # fires even when the solve returned early, or the same schedule
        # would exercise different faults depending on machine speed
        pending = max(
            (k.at for k in chaos.schedule.process_kills), default=0.0
        )
        chaos.wait_timeline(timeout=pending + 10.0)
        chaos.stop()
    if args.run_metrics:
        offset = 0
        if getattr(args, "resume", None):
            # a resumed solve's curve starts at the checkpoint's cycle:
            # label the CSV in absolute cycles
            from ..durability import durability

            offset = int(
                (durability.last_resume or {}).get("cycle") or 0
            )
        _dump_run_metrics(
            args.run_metrics, result.get("cost_curve"), offset
        )
    if not args.collect_curve:
        result.pop("cost_curve", None)
    if args.end_metrics:
        exists = os.path.exists(args.end_metrics)
        with open(args.end_metrics, "a", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            if not exists:
                w.writerow(
                    ["time", "status", "cost", "violation", "cycle",
                     "msg_count", "msg_size"]
                )
            w.writerow(
                [result.get(k) for k in
                 ("time", "status", "cost", "violation", "cycle",
                  "msg_count", "msg_size")]
            )
    write_output(args, result)
    # TIMEOUT exits 0: the anytime incumbent is a usable result
    return 0 if result.get("status") in ("FINISHED", "TIMEOUT") else 1
