"""Deployment topologies: one-call solve, threads, processes.

The port's copy of ``pydcop_tpu/infrastructure/run.py``: ``solve`` (one
call from a DCOP and an algorithm name to a solved assignment through the
full runtime), ``run_local_thread_dcop`` (orchestrator + in-process
agents) and ``run_local_process_dcop`` (HTTP communication, one spawned
OS process per agent, optional per-agent ``--trace-out`` files for
``telemetry stitch``).

In every topology the device solve runs under the orchestrator, on its
``device`` (the card unless the caller asks for the CPU): one
``api.solve_result`` for the whole DCOP.  What the topology changes is
where the control-plane agents live.  A spawned agent process imports
no torch: it keeps the books of its computations and never touches the
card.  ``_build`` imports the computation-graph module that the
algorithm's ``GRAPH_TYPE`` names and the distribution method, so every
solver of the port runs through the runtime.
"""

from __future__ import annotations

import logging
import multiprocessing
import time
from typing import Any, Dict, List, Optional, Union

from ..algorithms import AlgorithmDef, load_algorithm_module
from ..constants import INFINITY
from ..dcop.dcop import DCOP
from ..dcop.objects import AgentDef
from ..utils.simple_repr import from_repr, simple_repr
from .communication import HttpCommunicationLayer, InProcessCommunicationLayer
from .orchestratedagents import OrchestratedAgent
from .orchestrator import NOT_PORTED, Orchestrator

__all__ = [
    "solve",
    "run_local_thread_dcop",
    "run_local_process_dcop",
    "INFINITY",
]

logger = logging.getLogger("pydcop_tpu_torch.run")

_PACKAGE = __name__.rsplit(".", 2)[0]

#: the distribution methods the port has (``-d``); the JAX package's
#: others (gh_cgdp, the ILP methods, ...) are ROADMAP Queue 1, item 2
DISTRIBUTIONS = ("adhoc", "oneagent", "tpu_part")


def distribution_refusal(distribution) -> Optional[str]:
    """The named refusal of a distribution method the port does not have
    yet, or None (a ported method, or a Distribution object)."""
    if not isinstance(distribution, str) or distribution in DISTRIBUTIONS:
        return None
    return (
        f"distribution method {distribution!r} is not ported yet (the "
        f"port has {', '.join(DISTRIBUTIONS)}; the JAX package's other "
        f"methods are ROADMAP Queue 1, item 2)"
    )


def fault_refusal(chaos) -> Optional[str]:
    """The named refusal of a fault schedule whose message rules need the
    JAX package's ``ChaosCommunicationLayer``, or None: process and agent
    kills and device faults run."""
    if chaos is not None and chaos.schedule.rules:
        return f"fault schedule message rules: {NOT_PORTED}"
    return None


def _build(dcop: DCOP, algo_def, distribution):
    """Graph + distribution from names.  Loading the algorithm module
    imports torch: this runs in the orchestrator's process, which owns
    the card, never in an agent's.  A distribution method the port does
    not have yet raises ``NotImplementedError`` naming its queue item."""
    refusal = distribution_refusal(distribution)
    if refusal is not None:
        raise NotImplementedError(refusal)
    if isinstance(algo_def, str):
        algo_def = AlgorithmDef.build_with_default_param(
            algo_def, mode=dcop.objective
        )
    algo_module = load_algorithm_module(algo_def.algo)
    import importlib

    graph_module = importlib.import_module(
        f"{_PACKAGE}.computations_graph.{algo_module.GRAPH_TYPE}"
    )
    cg = graph_module.build_computation_graph(dcop)
    if isinstance(distribution, str):
        dist_module = importlib.import_module(
            f"{_PACKAGE}.distribution.{distribution}"
        )
        distribution = dist_module.distribute(
            cg,
            list(dcop.agents.values()),
            hints=getattr(dcop, "dist_hints", None),
            computation_memory=getattr(
                algo_module, "computation_memory", None
            ),
            communication_load=getattr(
                algo_module, "communication_load", None
            ),
        )
    return algo_def, cg, distribution


def run_local_thread_dcop(
    algo_def: Union[str, AlgorithmDef],
    dcop: DCOP,
    distribution: Union[str, Any] = "oneagent",
    n_cycles: int = 100,
    seed: int = 0,
    collector=None,
    collect_moment: str = "value_change",
    collect_period: Optional[float] = None,
    ui_port: Optional[int] = None,
    delay: float = 0.0,
    infinity: float = 10000,
    chaos=None,
    metrics_port: Optional[int] = None,
    replication_mode: str = "distributed",
    device="cuda",
    compiled=None,
) -> Orchestrator:
    """Orchestrator + one in-process agent per AgentDef.
    Returns the started orchestrator with all agents registered; call
    ``deploy_computations`` / ``run`` / ``stop_agents`` / ``stop`` on it.

    ``chaos``: a ``ChaosController`` (chaos/controller.py): its kill
    events crash the in-process agents (then repaired as a removal), its
    device faults fail a device-solve attempt, and the barriers degrade
    gracefully instead of raising on partial completion.  Message rules
    need the JAX package's ``ChaosCommunicationLayer``, which is not
    ported yet: such a schedule raises ``NotImplementedError`` before
    anything starts.

    ``metrics_port``: serve the live surface (``/metrics``,
    ``/metrics.json``, ``/status``) from the orchestrator on this port
    (0 = ephemeral) for the ``watch`` verb and Prometheus scrapes.

    ``device``: where the orchestrator's device solve runs (the card by
    default; refused when none is present); ``compiled``: the problem
    already compiled, whose captured graphs the solve reuses."""
    refusal = fault_refusal(chaos)
    if refusal is not None:
        raise NotImplementedError(refusal)
    algo_def, cg, distribution = _build(dcop, algo_def, distribution)
    agent_defs = list(dcop.agents.values())
    orchestrator = Orchestrator(
        algo_def,
        cg,
        agent_defs,
        dcop,
        distribution=distribution,
        collector=collector,
        collect_moment=collect_moment,
        collect_period=collect_period,
        n_cycles=n_cycles,
        seed=seed,
        infinity=infinity,
        degrade_on_timeout=chaos is not None,
        metrics_port=metrics_port,
        replication_mode=replication_mode,
        device=device,
        compiled=compiled,
    )
    orchestrator.chaos = chaos
    orchestrator.start()
    for i, a in enumerate(agent_defs):
        comm = InProcessCommunicationLayer()
        agent = OrchestratedAgent(
            a.name,
            comm,
            orchestrator.address,
            agent_def=a,
            ui_port=(ui_port + i) if ui_port else None,
            delay=delay,
        )
        agent.start()
        orchestrator._local_agents[a.name] = agent
    return orchestrator


def _run_process_agent(
    names: List[str],
    ports: List[int],
    orchestrator_host: str,
    orchestrator_port: int,
    agent_def_reprs: List[Any],
    trace_path: Optional[str] = None,
) -> None:
    """Agent process entry point: hosts one or more agents over HTTP
    until they are stopped.  It imports no torch.

    ``trace_path``: enable span tracing in this process and export a
    Chrome trace file on exit — one file per agent process, merged into a
    single cross-process timeline by the ``telemetry stitch`` verb
    (the freshly captured epoch pair in this new interpreter is what the
    stitcher aligns on)."""
    if trace_path is not None:
        from ..telemetry.tracing import tracer

        tracer.service = names[0] if len(names) == 1 else ",".join(names)
        tracer.reset()
        tracer.enabled = True
    agents = []
    for name, port, ad_repr in zip(names, ports, agent_def_reprs):
        comm = HttpCommunicationLayer(("127.0.0.1", port))
        agent = OrchestratedAgent(
            name,
            comm,
            (orchestrator_host, orchestrator_port),
            agent_def=from_repr(ad_repr),
        )
        agent.start()
        agents.append(agent)
    while any(a.is_running for a in agents):
        time.sleep(0.1)
    if trace_path is not None:
        from ..telemetry.tracing import tracer

        tracer.enabled = False
        try:
            tracer.export_chrome(trace_path)
        except OSError:
            logger.exception("could not write agent trace %s", trace_path)


def run_local_process_dcop(
    algo_def: Union[str, AlgorithmDef],
    dcop: DCOP,
    distribution: Union[str, Any] = "oneagent",
    n_cycles: int = 100,
    seed: int = 0,
    collector=None,
    collect_moment: str = "value_change",
    collect_period: Optional[float] = None,
    port: int = 9000,
    infinity: float = 10000,
    metrics_port: Optional[int] = None,
    trace_out: Optional[str] = None,
    replication_mode: str = "distributed",
    device="cuda",
) -> Orchestrator:
    """Orchestrator over HTTP + one OS process per agent.  Ports:
    orchestrator on ``port``, agents on ``port+1...``; ``port=0`` binds
    free ports for all of them (each agent registers the address it
    bound).  Uses the spawn start method like pyDCOP's process mode.

    ``trace_out``: the parent's ``--trace-out`` path; each agent process
    then traces itself and writes ``<trace_out>.<agent>.json``, so a
    multi-process run yields one trace file per process; the
    ``telemetry stitch`` verb merges them into one timeline.  ``device``
    is the orchestrator's, where the device solve runs."""
    algo_def, cg, distribution = _build(dcop, algo_def, distribution)
    agent_defs = list(dcop.agents.values())
    comm = HttpCommunicationLayer(("127.0.0.1", port))
    orchestrator = Orchestrator(
        algo_def,
        cg,
        agent_defs,
        dcop,
        distribution=distribution,
        comm=comm,
        collector=collector,
        collect_moment=collect_moment,
        collect_period=collect_period,
        n_cycles=n_cycles,
        seed=seed,
        infinity=infinity,
        metrics_port=metrics_port,
        replication_mode=replication_mode,
        device=device,
    )
    orchestrator.start()
    ctx = multiprocessing.get_context("spawn")
    procs = []
    agent_traces = []
    for i, a in enumerate(agent_defs):
        trace_path = f"{trace_out}.{a.name}.json" if trace_out else None
        if trace_path:
            agent_traces.append(trace_path)
        p = ctx.Process(
            target=_run_process_agent,
            args=(
                [a.name],
                [port + 1 + i if port else 0],
                "127.0.0.1",
                comm.address[1],
                [simple_repr(a)],
                trace_path,
            ),
            name=f"agent-{a.name}",
            daemon=True,
        )
        p.start()
        procs.append(p)
    orchestrator._agent_processes = procs
    orchestrator._agent_trace_files = agent_traces
    return orchestrator


def solve(
    dcop: DCOP,
    algo_def: Union[str, AlgorithmDef],
    distribution: Union[str, Any] = "oneagent",
    timeout: Optional[float] = None,
    n_cycles: int = 100,
    seed: int = 0,
    device="cuda",
) -> Dict[str, Any]:
    """One-call solve through the FULL runtime: orchestrator, agents,
    deployment, device solve, metrics.  Returns the final assignment.
    ``api.solve`` is the faster direct path (no control plane); this one
    exists for parity and for tests of the runtime itself."""
    orchestrator = run_local_thread_dcop(
        algo_def, dcop, distribution, n_cycles=n_cycles, seed=seed,
        device=device,
    )
    try:
        orchestrator.deploy_computations()
        orchestrator.run(timeout=timeout)
        assignment, _ = orchestrator.current_solution()
        return assignment
    finally:
        orchestrator.stop_agents()
        orchestrator.stop()
