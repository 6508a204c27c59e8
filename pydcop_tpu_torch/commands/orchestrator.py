"""``orchestrator``: a standalone orchestrator for multi-machine runs.

Counterpart of ``pydcop_tpu/commands/orchestrator.py``: load a DCOP,
start an HTTP orchestrator, wait for remote agents (started with the
``agent`` verb) to register, deploy, run the device solve on the card
(or the CPU with the global ``--device cpu``), print the result JSON and
stop everyone.  This verb owns the card; its agents never touch it.
``-s/--scenario`` plays a scenario's removals (each repaired on the
orchestrator's device) and ``-k/--ktarget`` replicates every
computation k times before the run; a scenario's arrivals are only
logged here, as in the JAX package (an agent joins by starting its own
``agent`` process).  A ``-d`` method the port does not have yet is
refused (exit 2).
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Dict

from ..dcop.yamldcop import load_dcop_from_file, load_scenario_from_file
from ._utils import build_algo_def, write_output

logger = logging.getLogger("pydcop_tpu_torch.cli.orchestrator")


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "orchestrator", help="start a standalone orchestrator over HTTP"
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument("dcop_files", nargs="+")
    parser.add_argument("-a", "--algo", required=True)
    parser.add_argument(
        "-p", "--algo_params", action="append", default=None
    )
    parser.add_argument("-d", "--distribution", default="oneagent")
    parser.add_argument("-s", "--scenario", default=None)
    parser.add_argument("--port", type=int, default=9000)
    parser.add_argument("--address", default="0.0.0.0")
    parser.add_argument("-k", "--ktarget", type=int, default=None)
    parser.add_argument(
        "--replication-mode", choices=["distributed", "local"],
        default="distributed",
        help="replica placement: the negotiation protocol (distributed, "
        "default) or the centralized UCS oracle (local)",
    )
    parser.add_argument("-n", "--n_cycles", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--register_timeout", type=float, default=120,
        help="how long to wait for agents to register",
    )


def run_cmd(args, timeout=None) -> int:
    from ..infrastructure.communication import HttpCommunicationLayer
    from ..infrastructure.orchestrator import Orchestrator
    from ..infrastructure.run import _build, distribution_refusal

    refusal = distribution_refusal(args.distribution)
    if refusal is not None:
        print(f"error: orchestrator: {refusal}", file=sys.stderr)
        return 2
    dcop = load_dcop_from_file(args.dcop_files)
    algo_def = build_algo_def(
        args.algo, args.algo_params, mode=dcop.objective
    )
    algo_def, cg, distribution = _build(dcop, algo_def, args.distribution)
    scenario = (
        load_scenario_from_file(args.scenario) if args.scenario else None
    )

    comm = HttpCommunicationLayer((args.address, args.port))
    orchestrator = Orchestrator(
        algo_def,
        cg,
        list(dcop.agents.values()),
        dcop,
        distribution=distribution,
        comm=comm,
        n_cycles=args.n_cycles,
        seed=args.seed,
        replication_mode=args.replication_mode,
        device=args.device,
    )
    orchestrator.start()
    logger.info(
        "orchestrator on %s:%s, waiting for %d agents",
        args.address, comm.address[1], len(dcop.agents),
    )
    try:
        orchestrator.deploy_computations(timeout=args.register_timeout)
        if args.ktarget:
            orchestrator.start_replication(args.ktarget)
        orchestrator.run(scenario=scenario, timeout=timeout)
        result: Dict[str, Any] = orchestrator.end_metrics()
        write_output(args, result)
        return 0 if result.get("status") in ("FINISHED", "TIMEOUT") else 1
    finally:
        try:
            orchestrator.stop_agents(timeout=10)
        finally:
            orchestrator.stop()
