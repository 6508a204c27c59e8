"""``agent``: standalone agents joining a remote orchestrator.

Counterpart of ``pydcop_tpu/commands/agent.py``: start ``--names`` agents
in this process, each with its own HTTP port (incrementing from
``--port``), connected to the orchestrator at ``--orchestrator ip:port``;
optional ``--restart`` daemon loop and ``--capacity``.  Host only: an
agent keeps the books of the computations deployed on it and never
touches the card, so the verb imports no torch and needs no
``--device``.  ``--address`` is the interface the agents bind (the JAX
verb binds ``0.0.0.0``, the default here too).
"""

from __future__ import annotations

import logging
import time

logger = logging.getLogger("pydcop_tpu_torch.cli.agent")


def set_parser(subparsers) -> None:
    parser = subparsers.add_parser(
        "agent", help="start standalone agents over HTTP"
    )
    parser.set_defaults(func=run_cmd)
    parser.add_argument(
        "-n", "--names", nargs="+", required=True, help="agent names"
    )
    parser.add_argument("-p", "--port", type=int, default=9001)
    parser.add_argument(
        "--address", default="0.0.0.0",
        help="interface the agents' HTTP servers bind",
    )
    parser.add_argument(
        "-o", "--orchestrator", required=True, help="orchestrator ip:port"
    )
    parser.add_argument("--capacity", type=int, default=100)
    parser.add_argument(
        "--restart", action="store_true",
        help="restart agents when they stop (daemon mode)",
    )
    parser.add_argument(
        "--ui_port", type=int, default=None,
        help="first websocket UI port (one per agent, incrementing)",
    )


def _start_agents(args):
    from ..dcop.objects import AgentDef
    from ..infrastructure.communication import HttpCommunicationLayer
    from ..infrastructure.orchestratedagents import OrchestratedAgent

    host, port_s = args.orchestrator.split(":")
    orchestrator_address = (host, int(port_s))
    agents = []
    for i, name in enumerate(args.names):
        comm = HttpCommunicationLayer(
            (args.address, args.port + i if args.port else 0)
        )
        agent = OrchestratedAgent(
            name,
            comm,
            orchestrator_address,
            agent_def=AgentDef(name, capacity=args.capacity),
            ui_port=(args.ui_port + i) if args.ui_port else None,
        )
        agent.start()
        logger.info("agent %s started on port %s", name, comm.address[1])
        agents.append(agent)
    return agents


def run_cmd(args, timeout=None) -> int:
    while True:
        agents = _start_agents(args)
        while any(a.is_running for a in agents):
            time.sleep(0.2)
        if not args.restart:
            return 0
        logger.info("agents stopped; restarting (--restart)")
        time.sleep(1.0)
