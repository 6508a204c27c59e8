"""``run``: a dynamic DCOP run with a scenario, replication and repair.

Counterpart of ``pydcop_tpu/commands/run.py``: like ``solve -m thread``
plus ``-s/--scenario`` (timed agent removals and arrivals),
``-k/--ktarget`` with ``--replication-mode`` (k-resilient replica
placement before the run: the distributed negotiation or the local UCS
oracle) and ``--replication_method``.  The orchestrator solves on the
card (or the CPU with the global ``--device cpu``), and so does each
removal's repair.  ``--fault-schedule`` runs a schedule's process and
agent kills and device faults; its message rules are refused (exit 2,
ROADMAP Queue 1 item 1), as is a ``-d`` method the port does not have
yet (exit 2, Queue 1 item 2).  ``--resume`` of a scenario run skips the
events the killed run already played (the ``scenario_cursor`` of the
checkpoint's manifest).  The result JSON is the JAX package's.
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Dict

from ..dcop.yamldcop import load_dcop_from_file, load_scenario_from_file
from ._utils import (
    add_chaos_arguments,
    add_csvio_arguments,
    add_durability_arguments,
    add_runtime_arguments,
    add_telemetry_arguments,
    build_algo_def,
    build_chaos_controller,
    chaos_report,
    finish_durability,
    finish_telemetry,
    start_durability,
    start_telemetry,
    write_output,
)

logger = logging.getLogger("pydcop_tpu_torch.cli.run")


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "run", help="run a dynamic DCOP (scenario + resilience)"
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument("dcop_files", nargs="+")
    parser.add_argument("-a", "--algo", required=True)
    parser.add_argument(
        "-p", "--algo_params", action="append", default=None
    )
    parser.add_argument("-d", "--distribution", default="oneagent")
    parser.add_argument("-s", "--scenario", default=None)
    parser.add_argument(
        "--replication_method", default="dist_ucs_hostingcosts"
    )
    parser.add_argument("-k", "--ktarget", type=int, default=None)
    parser.add_argument(
        "--replication-mode", choices=["distributed", "local"],
        default="distributed",
        help="replica placement: the negotiation protocol (distributed, "
        "default) or the centralized UCS oracle (local)",
    )
    parser.add_argument(
        "-c", "--collect_on",
        choices=["value_change", "cycle_change", "period"],
        default="value_change",
    )
    parser.add_argument("--period", type=float, default=None)
    parser.add_argument("-n", "--n_cycles", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    add_csvio_arguments(parser)
    add_runtime_arguments(parser)
    add_telemetry_arguments(parser)
    add_chaos_arguments(parser)
    add_durability_arguments(parser)


def run_cmd(args, timeout: float = None) -> int:
    from ..infrastructure.run import distribution_refusal, fault_refusal

    # refusals first: exit 2 with no telemetry or checkpoint side effects
    chaos = None
    refusal = distribution_refusal(args.distribution)
    if refusal is None:
        chaos = build_chaos_controller(args)
        refusal = fault_refusal(chaos)
    if refusal is not None:
        print(f"error: run: {refusal}", file=sys.stderr)
        return 2
    bridge = start_telemetry(args)
    manager = start_durability(args)
    try:
        return _run_cmd(args, timeout, chaos)
    finally:
        finish_durability(args, manager)
        finish_telemetry(args, bridge)


def _resumed_scenario(scenario, resume: str):
    """``scenario`` without the events the killed run already played:
    its checkpoint's manifest records how many (the orchestrator's
    cursor), so the timeline continues after them instead of replaying
    removals and arrivals onto a topology they already changed."""
    from ..durability import durability, read_manifest, resolve_checkpoint_path

    man = read_manifest(resolve_checkpoint_path(resume))
    cursor = int((man.get("extra") or {}).get("scenario_cursor", 0))
    if not cursor:
        return scenario
    from ..dcop.scenario import Scenario

    events = scenario.events
    logger.info(
        "resume: skipping %d already-played scenario event(s) "
        "(recorded cursor, checkpoint cycle %s)",
        min(cursor, len(events)), man.get("cycle"),
    )
    # the cursor base: checkpoints of this run keep counting in
    # full-scenario coordinates, so a second kill and resume does not
    # slice by a relative cursor
    durability.note_extra(scenario_cursor=cursor)
    return Scenario(events[cursor:])


def _run_cmd(args, timeout: float = None, chaos=None) -> int:
    from ..infrastructure.run import run_local_thread_dcop

    dcop = load_dcop_from_file(args.dcop_files)
    logger.info("loaded %s", args.dcop_files)
    algo_def = build_algo_def(
        args.algo, args.algo_params, mode=dcop.objective
    )
    scenario = (
        load_scenario_from_file(args.scenario) if args.scenario else None
    )
    if scenario is not None and getattr(args, "resume", None):
        scenario = _resumed_scenario(scenario, args.resume)

    extra = {}
    if args.uiport is not None:
        extra["ui_port"] = args.uiport
    if args.delay is not None:
        extra["delay"] = args.delay
    if args.metrics_port is not None:
        extra["metrics_port"] = args.metrics_port
    orchestrator = run_local_thread_dcop(
        algo_def,
        dcop,
        args.distribution,
        n_cycles=args.n_cycles,
        seed=args.seed,
        collect_moment=args.collect_on,
        collect_period=args.period,
        infinity=args.infinity,
        chaos=chaos,
        replication_mode=args.replication_mode,
        device=args.device,
        **extra,
    )
    try:
        orchestrator.deploy_computations()
        logger.info("deployed; %d agents", len(dcop.agents))
        if args.ktarget:
            levels = orchestrator.start_replication(args.ktarget)
            logger.info("replicated k=%d: %d computations", args.ktarget,
                        len(levels))
        orchestrator.run(scenario=scenario, timeout=timeout)
        result: Dict[str, Any] = orchestrator.end_metrics()
        if chaos is not None:
            result["chaos"] = chaos_report(chaos, orchestrator)
        write_output(args, result)
        return 0 if result.get("status") in ("FINISHED", "TIMEOUT") else 1
    finally:
        try:
            orchestrator.stop_agents()
        finally:
            orchestrator.stop()
