"""Orchestrator: bootstrap, deployment, run control, metrics sink,
scenario player and repair coordinator.

The port's copy of ``pydcop_tpu/infrastructure/orchestrator.py``:
``Orchestrator`` (an Agent named "orchestrator" hosting the Directory and
an ``AgentsMgt`` management computation; ``start``,
``deploy_computations``, ``run``, ``stop_agents``, ``current_solution``,
``end_metrics``, ``watch_status``, ``start_replication``,
``set_agent_capacity``, ``kill_agent``, scenario play) and ``AgentsMgt``
(registration barriers, deploy fan-out, value/cycle/metric collection,
the replication barrier and the repair handshake), with pyDCOP's
management message taxonomy.

pyDCOP's agents compute and its orchestrator coordinates.  Here the
orchestrator also owns the card: ``run()`` starts a ``device-solve``
thread that runs the whole DCOP as one ``api.solve_result`` on the
orchestrator's ``device``, then posts the per-cycle costs and one value
read-back a computation to the hosting agents, so the rest of the
control plane (metrics modes, UI, discovery) observes what pyDCOP's
would.  Every CUDA call of a run is on that thread: the agents, the UI,
a ``/metrics`` scrape and the ``--period`` poll read host state only, so
nothing touches the card while the solve captures its graphs.

A removal's repair (``AgentsMgt.repair_orphans``) solves its repair
DCOP with MGM-2 on the same ``device``, on the thread that plays the
scenario, while the main solve may still run on ``device-solve``: the
engine keeps the two solves' captures apart (``base.capture_lock``) and
the repair away from the run's checkpoints.  ``run``'s timeout stops
the device solve at its next look (``utils/solve_control.py``) and
joins its thread, so no solve is left inside torch when the process
exits.  The device solve's and each repair's launches (by kernel,
counted on their own threads) and wall spans are kept
(``device_solve_launches``, ``device_solve_span``, ``repair_runs``).
Message rules (the JAX package's ``ChaosCommunicationLayer``) are not
ported yet: ``run.py`` refuses them, naming ``NOT_PORTED``'s item.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..algorithms import AlgorithmDef, ComputationDef
from ..dcop.dcop import DCOP
from ..distribution.objects import Distribution
from .agents import Agent
from .communication import (
    CommunicationLayer,
    InProcessCommunicationLayer,
    MSG_MGT,
    MSG_VALUE,
)
from .computations import (
    Message,
    MessagePassingComputation,
    message_type,
    register,
)
from ..telemetry.tracing import tracer
from .discovery import DirectoryComputation
from .events import event_bus

__all__ = ["Orchestrator", "AgentsMgt", "ORCHESTRATOR", "NOT_PORTED"]

logger = logging.getLogger("pydcop_tpu.orchestrator")

ORCHESTRATOR = "orchestrator"
ORCHESTRATOR_MGT = "_mgt_orchestrator"

#: the valid replica-placement paths (the negotiation vs the centralized
#: UCS oracle), as in the JAX package
REPLICATION_MODES = ("distributed", "local")

#: what the parts of the runtime that are not ported yet say when called
NOT_PORTED = (
    "not ported yet: message rules (chaos/layer.py's "
    "ChaosCommunicationLayer) and the chaos verb come next (ROADMAP, "
    "Queue 1, item 1)"
)

# -- management message taxonomy (pyDCOP orchestrator.py:385-438) --------

DeployMessage = message_type("deploy", ["comp_def"])
RunAgentMessage = message_type("run_computations", ["computations"])
PauseMessage = message_type("pause_computations", ["computations"])
ResumeMessage = message_type("resume_computations", ["computations"])
StopAgentMessage = message_type("stop_agent", ["forced"])
AgentRemovedMessage = message_type("agent_removed", ["reason"])
RegisterAgentMessage = message_type("register_agent", ["agent", "address"])
DeployedMessage = message_type("deployed", ["agent", "computations"])
ValueChangeMessage = message_type(
    "value_change", ["computation", "value", "cost", "cycle"]
)
CycleChangeMessage = message_type("cycle_change", ["cycle", "cost"])
MetricsMessage = message_type("metrics", ["agent", "metrics"])
ComputationFinishedMessage = message_type(
    "computation_finished", ["computation"]
)
AgentStoppedMessage = message_type("agent_stopped", ["agent", "metrics"])
# ``mode`` selects the replication path ("distributed" = the
# negotiation, "local" = the centralized UCS oracle); ``agent_defs`` ships
# serialized AgentDefs (hosting costs, capacities) ONLY in local mode —
# the distributed protocol discovers both by visiting.  ``round`` is the
# barrier's epoch: the ack echoes it so a stale round's ack (late after a
# barrier timeout, or chaos-duplicated) can never release the NEXT
# round's barrier
ReplicateComputationsMessage = message_type(
    "replication", ["k", "agents", "mode", "agent_defs", "round"]
)
ComputationReplicatedMessage = message_type(
    "replicated", ["agent", "replica_hosts", "round"]
)
# the repair handshake is epoch'd exactly like replication: ``round``
# (shipped inside repair_info, echoed by both acks) stops a straggler's
# late repair_ready from a timed-out episode releasing the NEXT
# episode's barrier — the same stale-ack class proto-stale-guard exists
# to catch
SetupRepairMessage = message_type("setup_repair", ["repair_info"])
RepairReadyMessage = message_type(
    "repair_ready", ["agent", "computations", "round"]
)
RepairRunMessage = message_type("repair_run", [])
RepairDoneMessage = message_type(
    "repair_done", ["agent", "selected", "round"]
)
MetricsRequestMessage = message_type("metrics_request", [])


def replication_timeout_detail(
    timeout: float,
    expected: set,
    acked: set,
    levels: Dict[str, int],
    k: int,
) -> str:
    """The replication-barrier diagnostic: WHO never acked and WHICH
    computations sit below the k-target."""
    missing = sorted(expected - acked)
    below = {c: n for c, n in sorted(levels.items()) if n < k}
    detail = (
        f"replication did not complete within {timeout}s: no "
        f"ReplicateComputations ack from {len(missing)} agent(s) "
        f"{missing} (acked: {sorted(acked)})"
    )
    if below:
        detail += (
            f"; {len(below)} computation(s) below the k-target "
            f"{k}: {below}"
        )
    return detail


class Orchestrator:
    """Control plane for one DCOP run.

    ``device`` is where the device solve runs: the card (``"cuda"``, the
    default; refused at construction when none is present) or the CPU
    when the caller asks for it.  ``compiled`` hands over an already
    compiled problem (``compile.core.compile_dcop`` of ``dcop``), whose
    cached uploads and captured graphs the solve then reuses; without
    it the solve compiles ``dcop`` itself, as the JAX package's does."""

    def __init__(
        self,
        algo: AlgorithmDef,
        cg,
        agent_defs: List[Any],
        dcop: DCOP,
        distribution: Optional[Distribution] = None,
        comm: Optional[CommunicationLayer] = None,
        collector: Optional[Callable[[Dict[str, Any]], None]] = None,
        collect_moment: str = "value_change",
        collect_period: Optional[float] = None,
        n_cycles: int = 100,
        seed: int = 0,
        infinity: float = 10000,
        degrade_on_timeout: bool = False,
        metrics_port: Optional[int] = None,
        replication_mode: str = "distributed",
        device="cuda",
        compiled=None,
    ) -> None:
        from ..compile.kernels import resolve_device

        # refuse a card that is not there before any agent starts
        resolve_device(device)
        self.device = device
        self.compiled = compiled
        self.algo = algo
        self.cg = cg
        self.dcop = dcop
        self.agent_defs = list(agent_defs)
        self.distribution = distribution
        self.collector = collector
        self.collect_moment = collect_moment
        self.collect_period = collect_period
        self.n_cycles = n_cycles
        self.seed = seed
        self.infinity = infinity
        # barrier policy under injected faults: strict (default) raises on
        # a missed deployment barrier; degraded mode reports WHO missed
        # it, proceeds with what arrived and still returns the best-known
        # assignment (fault-injected runs set this)
        self.degrade_on_timeout = degrade_on_timeout
        # how start_replication places replicas: "distributed" runs the
        # visit/accept/refuse negotiation (resilience/), "local" keeps the
        # centralized UCS as a verifiable oracle (replication/)
        if replication_mode not in REPLICATION_MODES:
            raise ValueError(
                f"replication_mode must be one of {REPLICATION_MODES}, "
                f"got {replication_mode!r}"
            )
        self.replication_mode = replication_mode
        # the standing k-target: set by start_replication, reused by the
        # elasticity path (an agent ARRIVAL re-replicates onto the newcomer)
        self.ktarget: Optional[int] = None
        # a ChaosController (chaos/controller.py) driving kills and device
        # faults and, on thread topologies, the local agent objects so
        # kill events can crash them abruptly
        self.chaos = None
        self._local_agents: Dict[str, Any] = {}

        self._comm = comm or InProcessCommunicationLayer()
        self._agent = Agent(ORCHESTRATOR, self._comm)
        self.directory = DirectoryComputation()
        self._agent.add_computation(self.directory, publish=False)
        self.mgt = AgentsMgt(self)
        self._agent.add_computation(self.mgt, publish=False)

        self.start_time: Optional[float] = None
        self.status = "NOT_STARTED"
        self._result_lock = threading.Lock()
        # serializes whole removals (pause -> repair -> resume): a fault
        # kill fires on the timeline thread and may race a scenario
        # removal on the caller's thread; concurrent repair_orphans would
        # each rewrite self.distribution and lose the other's re-hosting
        self._repair_lock = threading.Lock()
        # set when run()'s timeout runs out: the device solve stops at its
        # next look and its thread is joined
        self._stop_solve = threading.Event()
        self._assignment: Dict[str, Any] = {}
        self._cost: Optional[float] = None
        self._violation: Optional[int] = None
        self._cycle = 0
        self._cost_curve: Optional[List[float]] = None
        self._solve_thread: Optional[threading.Thread] = None
        self._solve_done = threading.Event()
        self._repair_metrics: List[Dict[str, Any]] = []
        self.solve_msg_count = 0
        self.solve_msg_size = 0
        # the device solve's two stages, timed apart (seconds): the solve
        # (orchestrator.device_solve) and the posting of its cycle costs
        # and value read-backs (orchestrator.readback)
        self.device_solve_s: Optional[float] = None
        self.readback_s: Optional[float] = None
        # the device solve's launches by kernel and its wall span
        # (perf_counter seconds), and one record a repair: its solve's
        # span, launches by kernel and metrics (on the card's runs, what
        # shows a repair's solve beside the main solve)
        self.device_solve_launches: Dict[str, int] = {}
        self.device_solve_span: Optional[tuple] = None
        self.repair_runs: List[Dict[str, Any]] = []
        # graftwatch live surface: /metrics (Prometheus), /metrics.json,
        # /status — started with the orchestrator when a port is given
        # (0 = ephemeral; the bound port is on .metrics_server.port)
        self.metrics_port = metrics_port
        self.metrics_server = None

    # ------------------------------------------------------------------
    # public API (pyDCOP orchestrator.py:170-330)
    # ------------------------------------------------------------------

    @property
    def address(self) -> Any:
        return self._comm.address

    def start(self) -> "Orchestrator":
        self._agent.start()
        self._agent.computation(self.directory.name).start()
        self._agent.computation(self.mgt.name).start()
        if self.metrics_port is not None:
            from .ui import MetricsHttpServer

            self.metrics_server = MetricsHttpServer(
                self.metrics_port, status_cb=self.watch_status
            )
        self.status = "STARTED"
        return self

    def deploy_computations(self, timeout: float = 10.0) -> None:
        """Wait for all agents to register, then ship every ComputationDef to
        its hosting agent's management computation (pyDCOP :203,:915)."""
        with tracer.span(
            "orchestrator.deploy", cat="lifecycle",
            n_agents=len(self.agent_defs), n_computations=len(self.cg.nodes),
        ):
            if not self.mgt.all_registered.wait(timeout):
                missing = set(a.name for a in self.agent_defs) - set(
                    self.mgt.registered_agents
                )
                raise TimeoutError(
                    f"agents failed to register in {timeout}s: "
                    f"{sorted(missing)}"
                )
            if self.distribution is None:
                raise ValueError("no distribution to deploy")
            for agent_name in self.distribution.agents:
                comp_defs = []
                for comp_name in self.distribution.computations_hosted(
                    agent_name
                ):
                    node = self.cg.computation(comp_name)
                    comp_defs.append(ComputationDef(node, self.algo))
                for cd in comp_defs:
                    self.mgt.post_msg(
                        f"_mgt_{agent_name}", DeployMessage(comp_def=cd),
                        MSG_MGT,
                    )

    def start_replication(
        self, k: int, timeout: float = 10.0, mode: Optional[str] = None
    ) -> Dict[str, int]:
        """Ask every agent to replicate its computations k times (pyDCOP
        :223); blocks until the replication barrier passes and returns
        the achieved replication level per computation.

        ``mode`` overrides the orchestrator's ``replication_mode`` for
        this round.  When fewer than k hosts can accept (capacity, too few
        agents), agents ack at *partial k*: the achieved level is
        recorded in ``AgentsMgt.replication_levels`` instead of hanging
        the barrier.  A missed barrier names the agents that never acked
        and the computations below target; with ``degrade_on_timeout``
        the run proceeds on the replicas that did land.  Re-invocations
        re-negotiate: a larger candidate set (agent arrival) can move
        replicas onto cheaper hosts and a smaller ``k`` retracts the
        surplus."""
        mode = mode or self.replication_mode
        if mode not in REPLICATION_MODES:
            raise ValueError(f"unknown replication mode {mode!r}")
        self.ktarget = int(k)
        targets = list(self.distribution.agents)
        self.mgt.expect_replication(set(targets), k=int(k), mode=mode)
        agent_defs = None
        if mode == "local":
            from ..utils.simple_repr import simple_repr

            agent_defs = {
                a.name: simple_repr(a) for a in self.agent_defs
            }
        known = dict(self.mgt.agent_addresses)
        for agent_name in targets:
            self.mgt.post_msg(
                f"_mgt_{agent_name}",
                ReplicateComputationsMessage(
                    k=k, agents=known, mode=mode, agent_defs=agent_defs,
                    round=self.mgt.replication_round,
                ),
                MSG_MGT,
            )
        if not self.mgt.all_replicated.wait(timeout):
            detail = replication_timeout_detail(
                timeout,
                expected=self.mgt.expected_replication_agents,
                acked=self.mgt.replicated_agents,
                levels=self.mgt.replication_levels,
                k=int(k),
            )
            if not self.degrade_on_timeout:
                raise TimeoutError(detail)
            logger.error(
                "%s — proceeding with partial replication "
                "(degrade_on_timeout)", detail,
            )
        else:
            partial = {
                c: n
                for c, n in self.mgt.replication_levels.items()
                if n < k
            }
            if partial:
                logger.warning(
                    "replication completed at partial k for %d "
                    "computation(s): %s (k-target %d)",
                    len(partial), partial, k,
                )
        return dict(self.mgt.replication_levels)

    def set_agent_capacity(self, agent_name: str, capacity: float) -> None:
        """Tell ``agent_name`` its effective capacity changed (elastic
        resize, operator action).  The agent's replication ledger re-checks
        and sheds its most expensive replicas until it fits again: the
        retraction's capacity-loss trigger."""
        from ..resilience.messages import CapacityMessage
        from ..resilience.negotiation import replication_name

        addr = self.mgt.agent_addresses.get(agent_name)
        if addr is not None:
            self._agent.messaging.register_route(
                replication_name(agent_name), agent_name, addr
            )
        self.mgt.post_msg(
            replication_name(agent_name),
            CapacityMessage(capacity=capacity),
            MSG_MGT,
        )

    def run(
        self,
        scenario=None,
        timeout: Optional[float] = None,
        repair_only: bool = False,
        ready_timeout: Optional[float] = None,
    ) -> None:
        """Start the computations, play ``scenario`` (its removals
        repaired, its arrivals joined) and drive the device solve to
        completion (pyDCOP :245).  Blocks until finished / timeout; at
        the timeout the device solve is stopped and its thread joined.

        ``ready_timeout`` bounds the wait for deployment confirmations;
        the default scales with the number of computations (each is one
        round-trip through the management plane — measured ~1ms each, so
        10k computations need more than a fixed 10s).
        """
        if ready_timeout is None:
            ready_timeout = 10.0 + 0.005 * len(self.cg.nodes)
        if not self.mgt.ready_to_run.wait(ready_timeout):
            # _pending_deploy stays None until the FIRST ack arrives —
            # distinguish "some stragglers" from "nothing acked at all"
            if self.mgt._pending_deploy is None:
                detail = (
                    f"deployment did not complete within {ready_timeout}s:"
                    f" no deploy ack received at all (0 of "
                    f"{len(self.cg.nodes)} computations confirmed)"
                )
            else:
                pending = sorted(self.mgt._pending_deploy)
                detail = (
                    f"deployment did not complete within {ready_timeout}s:"
                    f" {len(pending)} computation(s) unconfirmed "
                    f"(e.g. {pending[:5]})"
                )
            if not self.degrade_on_timeout:
                raise TimeoutError(detail)
            logger.error(
                "%s — proceeding with partial deployment "
                "(degrade_on_timeout)", detail,
            )
        self.start_time = time.perf_counter()
        self.status = "RUNNING"
        metrics_poll = None
        if self.collect_period and self.collect_moment == "period":
            # periodic metric collection mode (pyDCOP orchestrator
            # period mode): poll every agent's metrics on the configured
            # cadence; replies stream through the 'metrics' handler into
            # the collector.  The bound method is kept so the removal in
            # the finally below targets the SAME callback object —
            # re-reading self.request_agent_metrics would bind a fresh
            # one and the identity-based removal would miss.
            metrics_poll = self.request_agent_metrics
            self.mgt.add_periodic_action(self.collect_period, metrics_poll)
        for agent_name in self.distribution.agents:
            self.mgt.post_msg(
                f"_mgt_{agent_name}",
                RunAgentMessage(
                    computations=self.distribution.computations_hosted(
                        agent_name
                    )
                ),
                MSG_MGT,
            )
        self._solve_thread = threading.Thread(
            target=self._device_solve, name="device-solve", daemon=True
        )
        self._solve_thread.start()

        if self.chaos is not None:
            self.chaos.start(self.kill_agent)
        t_run = time.perf_counter()
        try:
            if scenario is not None:
                self._play_scenario(scenario)

            budget = None if timeout is None else timeout
            finished = self._solve_done.wait(budget)
            if not finished:
                self.status = "TIMEOUT"
                self._stop_device_solve()
            elif self.status == "RUNNING":
                self.status = "FINISHED"
        finally:
            if metrics_poll is not None:
                # a finished run must stop polling: agents are about to
                # stop and every further MetricsRequest would only park
                # and dead-letter; removal also keeps a second run()
                # from stacking a double-rate poll
                self.mgt.remove_periodic_action(metrics_poll)
            if self.chaos is not None:
                # the fault timeline is part of the run: a solve that
                # returns before a scheduled kill still gets killed,
                # otherwise the same schedule would exercise
                # different faults depending on machine speed.  What is
                # LEFT of the run's timeout bounds the wait (the whole
                # call must not exceed ~timeout); without one, 60s does.
                if timeout is None:
                    grace = 60.0
                else:
                    grace = max(
                        0.0, timeout - (time.perf_counter() - t_run)
                    )
                if not self.chaos.wait_timeline(timeout=grace):
                    logger.warning(
                        "chaos timeline still running at shutdown; "
                        "cancelling remaining events"
                    )
                self.chaos.stop()

    #: how long a timed-out run waits for its stopped device solve: a
    #: solve stops at its next look, which comes after at most one run
    #: of chunks (``base.MAX_CHUNK`` cycles) or one launch of a kernel
    STOP_JOIN_S = 30.0

    def _stop_device_solve(self) -> None:
        """The run's timeout ran out: ask the device solve to stop and
        join its thread, so no solve is left inside torch when the
        process exits (the interpreter's teardown under a thread inside
        torch aborts it).  The JAX package's run reports a timed-out
        solve's result as unset; the stopped solve's partial result is
        dropped the same way."""
        self._stop_solve.set()
        thread = self._solve_thread
        if thread is None:
            return
        logger.info("stopping the device solve")
        thread.join(self.STOP_JOIN_S)
        if not thread.is_alive():
            logger.info("the device solve stopped")
        else:
            logger.error(
                "the device solve did not stop within %.0fs of the "
                "timeout", self.STOP_JOIN_S,
            )

    def current_solution(self):
        with self._result_lock:
            return dict(self._assignment), self._cost

    def dead_letter_total(self) -> int:
        """Parked messages dropped (TTL/cap) across the orchestrator and
        every locally hosted agent — the zero-loss assertion of chaos
        runs (`--max-dead-letters`)."""
        return self._agent.messaging.dead_letter_count + sum(
            a.messaging.dead_letter_count
            for a in self._local_agents.values()
        )

    def stop_agents(self, timeout: float = 5.0) -> None:
        """Ask every agent to stop cleanly (pyDCOP :291)."""
        with tracer.span(
            "orchestrator.stop_agents", cat="lifecycle",
            n_agents=len(self.mgt.registered_agents),
        ):
            for a in list(self.mgt.registered_agents):
                self.mgt.post_msg(
                    f"_mgt_{a}", StopAgentMessage(forced=False), MSG_MGT
                )
            self.mgt.all_stopped.wait(timeout)

    def stop(self) -> None:
        if self.metrics_server is not None:
            self.metrics_server.shutdown()
            self.metrics_server = None
        if self._solve_thread is not None and self._solve_thread.is_alive():
            self._stop_device_solve()
        self._agent.clean_shutdown()
        self._agent.join()
        self.status = "STOPPED" if self.status != "FINISHED" else self.status

    def request_agent_metrics(self) -> None:
        """Broadcast a metrics poll to every registered agent; replies
        land in ``AgentsMgt.agent_metrics`` (and the collector) via the
        existing ``metrics`` handler.  This is the send half of the
        agents' ``metrics_request`` handler — which sat dead (graftlint
        proto-dead-handler) until this method existed: nothing could
        sample agent metrics mid-run, only at stop time."""
        for a in list(self.mgt.registered_agents):
            self.mgt.post_msg(
                f"_mgt_{a}", MetricsRequestMessage(), MSG_MGT
            )

    def end_metrics(self) -> Dict[str, Any]:
        """Global metrics in pyDCOP's schema (orchestrator.py:1215)."""
        with self._result_lock:
            msg_count = sum(
                m.get("count_ext_msg", {}).get(c, 0)
                for m in self.mgt.agent_metrics.values()
                for c in m.get("count_ext_msg", {})
            )
            msg_size = sum(
                m.get("size_ext_msg", {}).get(c, 0)
                for m in self.mgt.agent_metrics.values()
                for c in m.get("size_ext_msg", {})
            )
            return {
                "status": self.status,
                "assignment": dict(self._assignment),
                "cost": self._cost,
                "violation": self._violation,
                "cycle": self._cycle,
                "msg_count": self.solve_msg_count + msg_count,
                "msg_size": self.solve_msg_size + msg_size,
                "time": (
                    time.perf_counter() - self.start_time
                    if self.start_time
                    else 0.0
                ),
                "cost_curve": self._cost_curve,
                "repair_metrics": list(self._repair_metrics),
            }

    def watch_status(self) -> Dict[str, Any]:
        """The ``/status`` payload for the ``watch`` verb: run state,
        anytime-best progress (live from the ``solve.best_cost`` /
        ``solve.cycles_to_best`` gauges while a chunked device solve is
        still running), a decimated cost curve once one exists, and
        per-agent queue health.  Read-only — safe to call from the scrape
        thread at any point in the run."""
        from ..telemetry.metrics import metrics_registry

        def _gauge(name: str) -> Optional[float]:
            m = metrics_registry.get(name)
            if m is None:
                return None
            values = m.snapshot()["values"]
            return values[0]["value"] if values else None

        # the gauge carries the device's INTERNAL minimization cost
        # (negated utility on max-objective problems, so its series is
        # non-increasing); /status sits next to external-sign fields
        # (cost, cost_curve), so convert before the two meet in one view
        sign = -1.0 if self.dcop.objective == "max" else 1.0
        best = _gauge("solve.best_cost")
        if best is not None:
            best = sign * best

        with self._result_lock:
            cost = self._cost
            violation = self._violation
            cycle = self._cycle
            curve = list(self._cost_curve) if self._cost_curve else None
        if curve:
            from ..telemetry.summary import decimate_series

            # keep the /status payload terminal-sized; the last point
            # (current incumbent) always survives
            curve = decimate_series(curve, 120)
        agents = {}
        # snapshot first: a scenario add_agent may grow the dict while
        # the scrape thread iterates
        for name, agent in sorted(dict(self._local_agents).items()):
            messaging = getattr(agent, "messaging", None)
            if messaging is None:
                continue
            agents[name] = {
                "queue": messaging._queue.qsize(),
                "parked": messaging.parked_count,
                "dead_letters": messaging.dead_letter_count,
            }
        out = {
            "status": self.status,
            "cost": cost,
            "violation": violation,
            "cycle": cycle,
            "best_cost": best,
            "cycles_to_best": _gauge("solve.cycles_to_best"),
            "cost_curve": curve,
            "agents": agents,
            "registered_agents": len(self.mgt.registered_agents),
            "dead_letters": self.dead_letter_total(),
            "time": (
                time.perf_counter() - self.start_time
                if self.start_time
                else 0.0
            ),
        }
        # graftpulse: solver-health block (diagnosis + churn series) for
        # the watch verb — present only when pulse is on and a device
        # solve has published health rows
        from ..telemetry.pulse import pulse

        pulse_block = pulse.status_block()
        if pulse_block is not None:
            out["pulse"] = pulse_block
        # graftdur: durability block (checkpoint dir/cadence/census,
        # scenario cursor, what this run resumed from) once configured
        from ..durability import durability

        dura_block = durability.status_block()
        if dura_block is not None:
            out["durability"] = dura_block
        # replication block (mode, k-target, achieved levels,
        # visit/refusal/retraction counters) once a round was requested
        from ..resilience import replication_status_block

        rep_block = replication_status_block(
            self.mgt, self.ktarget,
            self.mgt.replication_mode_active or self.replication_mode,
        )
        if rep_block is not None:
            out["replication"] = rep_block
        # graftmem: device-memory block (last live sample, guard config,
        # refusal counts) so watch/status sees the memory plane
        from ..telemetry.memplane import memory_status

        mem_block = memory_status()
        if mem_block is not None:
            out["memory"] = mem_block
        return out

    # ------------------------------------------------------------------
    # the device solve (replaces pyDCOP's per-agent algorithm run)
    # ------------------------------------------------------------------

    def _device_solve(self) -> None:
        from ..compile.hopper_kernels import thread_tally
        from ..utils.solve_control import stop_on

        t0 = time.perf_counter()
        with thread_tally() as launches, stop_on(self._stop_solve):
            r = self._solve_with_retry()
        t1 = time.perf_counter()
        self.device_solve_s = t1 - t0
        self.device_solve_span = (t0, t1)
        self.device_solve_launches = {
            w.__name__: n for w, n in launches.items()
        }
        if r is None or self._stop_solve.is_set():
            # failed, or stopped at the run's timeout: nothing to publish
            self._solve_done.set()
            return
        t0 = time.perf_counter()
        # everything below reads the solve RESULT, not the shared
        # attributes, so the publication holds no unguarded read of the
        # _result_lock-protected state
        assignment = r["assignment"]
        cost = r["cost"]
        cost_curve = r.get("cost_curve")
        with self._result_lock:
            self._assignment = assignment
            self._cost = cost
            self._violation = r["violation"]
            self._cycle = r["cycle"]
            self._cost_curve = cost_curve
            self.solve_msg_count = r["msg_count"]
            self.solve_msg_size = r["msg_size"]
        with tracer.span(
            "orchestrator.readback", cat="solve",
            n_computations=len(assignment),
        ):
            # per-cycle metrics stream (collection mode cycle_change)
            if cost_curve and self.collect_moment == "cycle_change":
                for i, c in enumerate(cost_curve):
                    self.mgt.post_msg(
                        self.mgt.name,
                        CycleChangeMessage(cycle=i + 1, cost=c),
                        MSG_VALUE,
                    )
            # value readbacks to the hosting agents: the deployed
            # computations see their final value exactly as pyDCOP's
            # computations see their own value_selection
            if self.distribution is not None:
                for comp_name, value in assignment.items():
                    try:
                        agent = self.distribution.agent_for(comp_name)
                    except KeyError:
                        continue
                    self.mgt.post_msg(
                        f"_mgt_{agent}",
                        Message(
                            "value_readback_fwd",
                            (comp_name, value, cost),
                        ),
                        MSG_VALUE,
                    )
        self.readback_s = time.perf_counter() - t0
        self._solve_done.set()

    def _solve_with_retry(self) -> Optional[Dict[str, Any]]:
        """The solve's result, or None when it failed (status ERROR).
        One retry on the card: a transient device failure must not take
        down a run whose whole control plane is healthy; a deterministic
        error just fails twice.  On the CPU only for a fault the schedule
        injected (transient by definition, retried as the JAX package
        retries it), and never after a sticky CUDA error, which fails
        every later CUDA call of this process: reported, not masked."""
        from ..api import solve_result

        attempts = 2 if (str(self.device).startswith("cuda")
                         or self.chaos is not None) else 1
        for attempt in range(attempts):
            try:
                with tracer.span(
                    "orchestrator.device_solve", cat="solve",
                    algo=self.algo.algo, n_cycles=self.n_cycles,
                    device=str(self.device),
                ):
                    if self.chaos is not None and self.chaos.device_fault():
                        raise RuntimeError(
                            "chaos: injected device step fault"
                        )
                    return solve_result(
                        self.dcop,
                        self.algo,
                        n_cycles=self.n_cycles,
                        seed=self.seed,
                        collect_curve=True,
                        infinity=self.infinity,
                        compiled=self.compiled,
                        device=self.device,
                    )
            except Exception:
                if attempt + 1 < attempts and not _sticky_cuda_error(
                    self.device
                ):
                    logger.warning(
                        "device solve failed (attempt %d/%d), retrying",
                        attempt + 1, attempts, exc_info=True,
                    )
                    continue
                logger.exception("device solve failed")
                self.status = "ERROR"
                return None
        return None

    # ------------------------------------------------------------------
    # scenario handling (pyDCOP :340,:955)
    # ------------------------------------------------------------------

    def _play_scenario(self, scenario) -> None:
        # the event cursor rides every checkpoint manifest, so a killed
        # scenario run resumes AFTER the events it already played
        # (--resume slices the scenario by the recorded cursor).  A
        # RESUMED run plays an already-sliced scenario: the cursor base it
        # seeded (commands/run.py) keeps the recorded cursor in
        # full-scenario coordinates across repeated kill/resume cycles.
        from ..durability import durability

        base = int(
            durability.runtime_extra().get("scenario_cursor", 0) or 0
        )
        for i, event in enumerate(scenario.events):
            if event.is_delay:
                time.sleep(event.delay)
            else:
                for action in event.actions:
                    if action.type == "remove_agent":
                        self._remove_agent(action.args["agent"])
                    elif action.type == "add_agent":
                        self._add_agent(action.args["agent"])
            durability.note_extra(
                scenario_cursor=base + i + 1, scenario_event=event.id
            )

    def _add_agent(self, agent_name: str) -> None:
        """Agent ARRIVAL (pyDCOP's scenario handling is remove-only).
        Thread topology: a fresh OrchestratedAgent joins in-process,
        registers with the directory and becomes a host candidate for
        later re-replications and repairs.  In a multi-machine run new
        agents instead join by starting their own ``agent`` process:
        arrival there IS registration, so this event only logs."""
        from .orchestratedagents import OrchestratedAgent

        if not isinstance(self._comm, InProcessCommunicationLayer):
            logger.warning(
                "scenario add_agent %s ignored on a networked topology: "
                "start a standalone agent process to join", agent_name,
            )
            return
        if agent_name in self.mgt.registered_agents:
            # a duplicate would re-register the name and hijack the live
            # agent's management route
            logger.warning(
                "scenario add_agent %s ignored: an agent with that name "
                "is already registered", agent_name,
            )
            return
        agent_def = self.dcop.agents.get(agent_name)
        if agent_def is None:
            from ..dcop.objects import AgentDef

            agent_def = AgentDef(agent_name)
        self.agent_defs.append(agent_def)
        # a schedule's message rules are refused before a run starts
        # (run.py), so the newcomer's transport is the plain one
        agent = OrchestratedAgent(
            agent_name,
            InProcessCommunicationLayer(),
            self.address,
            agent_def=agent_def,
        )
        agent.start()
        self._local_agents[agent_name] = agent
        # block (bounded) until the newcomer has registered: the next
        # scenario event may be a removal whose repair filters candidates
        # by registered_agents
        deadline = time.perf_counter() + 10.0
        while (
            agent_name not in self.mgt.registered_agents
            and time.perf_counter() < deadline
        ):
            time.sleep(0.02)
        if agent_name not in self.mgt.registered_agents:
            logger.warning(
                "scenario: added agent %s did not register within 10s",
                agent_name,
            )
        else:
            logger.info("scenario: added agent %s", agent_name)
            if self.ktarget is not None:
                # a newcomer immediately becomes a replication candidate:
                # re-run the negotiation so cheap capacity is used NOW,
                # and a later failure can repair onto it
                logger.info(
                    "re-replicating (k=%d) to include newcomer %s",
                    self.ktarget, agent_name,
                )
                try:
                    self.start_replication(self.ktarget, timeout=15.0)
                except TimeoutError:
                    logger.error(
                        "re-replication after adding %s timed out; "
                        "continuing with previous placements", agent_name,
                    )

    def kill_agent(self, agent_name: str) -> None:
        """Abrupt failure (a fault schedule's kill events): crash the
        agent (no clean shutdown, its transport dies), then run the
        repair a scenario removal gets.  On thread topologies the local
        agent object is crashed directly; elsewhere the agent is simply
        treated as gone (its process is presumed dead)."""
        if agent_name not in self.mgt.registered_agents:
            logger.warning(
                "chaos: kill of %s ignored: not a registered agent "
                "(registered: %s)",
                agent_name, sorted(self.mgt.registered_agents),
            )
            return
        agent = self._local_agents.get(agent_name)
        if agent is not None:
            agent.crash()
        self._remove_agent(agent_name, crashed=True)

    def _remove_agent(self, agent_name: str, crashed: bool = False) -> None:
        """Simulated failure + repair (pyDCOP :955-1124): pause, remove
        the agent, rehost its computations, resume.  ``crashed`` skips the
        polite AgentRemoved notification: a dead agent cannot read it,
        and the message would only sit parked until dead-lettered."""
        logger.info(
            "%s: removing agent %s", "chaos" if crashed else "scenario",
            agent_name,
        )
        event_bus.send("orchestrator.scenario.remove_agent", agent_name)
        with self._repair_lock, tracer.span(
            "orchestrator.repair", cat="lifecycle", agent=agent_name
        ) as sp:
            # pause all surviving agents' computations
            for a in list(self.mgt.registered_agents):
                if a == agent_name:
                    continue
                self.mgt.post_msg(
                    f"_mgt_{a}", PauseMessage(computations=None), MSG_MGT
                )
            if not crashed:
                self.mgt.post_msg(
                    f"_mgt_{agent_name}",
                    AgentRemovedMessage(reason="scenario"),
                    MSG_MGT,
                )
            self.mgt.registered_agents.discard(agent_name)
            # the dead agent can neither ack a replication round nor host
            # replicas: prune it before repair picks candidates
            self.mgt.note_agent_gone(agent_name)
            try:
                repair_metrics = self.mgt.repair_orphans(agent_name)
                self._repair_metrics.append(repair_metrics)
                sp.set(orphans=len(repair_metrics.get("orphans", [])))
            except Exception:
                logger.exception(
                    "repair after removing %s failed", agent_name
                )
            for a in list(self.mgt.registered_agents):
                self.mgt.post_msg(
                    f"_mgt_{a}", ResumeMessage(computations=None), MSG_MGT
                )


def _sticky_cuda_error(device) -> bool:
    """Whether the card is unusable for the rest of this process: a
    sticky CUDA error (an illegal address, a launch failure) makes every
    later CUDA call fail, so a retry could only mask it.  False off the
    card."""
    if not str(device).startswith("cuda"):
        return False
    import torch

    try:
        torch.cuda.synchronize(device)
    except Exception:
        return True
    return False


class AgentsMgt(MessagePassingComputation):
    """The orchestrator's management computation (pyDCOP AgentsMgt:535):
    registration barriers, deployment confirmation, metric collection and the
    repair coordination."""

    def __init__(self, orchestrator: Orchestrator) -> None:
        super().__init__(ORCHESTRATOR_MGT)
        self.orchestrator = orchestrator
        self.registered_agents: set = set()
        self.agent_addresses: Dict[str, Any] = {}
        self.deployed: Dict[str, set] = {}
        # computations awaiting a deploy ack; None until the first ack
        # (the distribution may not exist yet at construction time)
        self._pending_deploy: Optional[set] = None
        self.agent_metrics: Dict[str, Dict[str, Any]] = {}
        self.replica_hosts: Dict[str, List[str]] = {}
        self.expected_replications = 0
        self._n_replicated = 0
        # agents whose ReplicateComputations ack arrived: a missed
        # replication barrier reports exactly who stalled
        self.replicated_agents: set = set()
        # the agents the CURRENT replication round still expects (an
        # agent dying mid-round is discarded via note_agent_gone so the
        # barrier completes on the survivors), the achieved level per
        # computation (partial k is a result, not a failure) and the
        # round's mode, all surfaced in /status
        self.expected_replication_agents: set = set()
        self.replication_levels: Dict[str, int] = {}
        self.replication_mode_active: Optional[str] = None
        self._replication_armed = False
        # barrier epoch: bumped per round; acks echo it (see the message
        # taxonomy comment on ReplicateComputationsMessage)
        self.replication_round = 0
        self.all_registered = threading.Event()
        self.ready_to_run = threading.Event()
        self.all_replicated = threading.Event()
        self.all_stopped = threading.Event()
        self._stopped_agents: set = set()
        self._finished_computations: set = set()
        # the repair handshake's state (pyDCOP AgentsMgt repair barriers):
        # agents that acked setup_repair with the computations they can
        # host, and the selections repair_run produced
        self.repair_ready_agents: Dict[str, List[str]] = {}
        self.repair_selected: Dict[str, List[str]] = {}
        self.all_repair_ready = threading.Event()
        self.expected_repair_acks = 0
        # barrier epoch, bumped per episode; acks echo it (see the message
        # taxonomy comment on SetupRepairMessage)
        self.repair_round = 0

    # -- registration --------------------------------------------------

    @register("register_agent")
    def _on_register_agent(self, sender: str, msg, t: float) -> None:
        self.registered_agents.add(msg.agent)
        self.agent_addresses[msg.agent] = msg.address
        self.orchestrator.directory.directory.agents[msg.agent] = msg.address
        # make the agent's mgt computation routable from the orchestrator
        self.orchestrator._agent.messaging.register_route(
            f"_mgt_{msg.agent}", msg.agent, msg.address
        )
        expected = {a.name for a in self.orchestrator.agent_defs}
        if expected and expected <= self.registered_agents:
            self.all_registered.set()

    @register("deployed")
    def _on_deployed(self, sender: str, msg, t: float) -> None:
        # acks are incremental (one computation each); readiness is a
        # pending-set subtraction, not a rescan of every agent's hosted
        # list — the rescan made deployment O(n^2) at 100k computations.
        # The record is a SET per agent so a re-sent ack (agent
        # reconnect/redeploy) stays idempotent at O(1)
        self.deployed.setdefault(msg.agent, set()).update(msg.computations)
        dist = self.orchestrator.distribution
        if dist is None:
            return
        if self._pending_deploy is None:
            self._pending_deploy = {
                c for a in dist.agents
                for c in dist.computations_hosted(a)
            }
            for comps in self.deployed.values():
                self._pending_deploy.difference_update(comps)
        else:
            self._pending_deploy.difference_update(msg.computations)
        if not self._pending_deploy:
            self.ready_to_run.set()

    # -- metric collection ---------------------------------------------

    @register("value_change")
    def _on_value_change(self, sender: str, msg, t: float) -> None:
        if self.orchestrator.collector is not None:
            self.orchestrator.collector(
                {
                    "event": "value_change",
                    "computation": msg.computation,
                    "value": msg.value,
                    "cost": msg.cost,
                    "cycle": msg.cycle,
                    "time": t,
                }
            )

    @register("cycle_change")
    def _on_cycle_change(self, sender: str, msg, t: float) -> None:
        if self.orchestrator.collector is not None:
            self.orchestrator.collector(
                {
                    "event": "cycle_change",
                    "cycle": msg.cycle,
                    "cost": msg.cost,
                    "time": t,
                }
            )

    @register("metrics")
    def _on_metrics(self, sender: str, msg, t: float) -> None:
        self.agent_metrics[msg.agent] = msg.metrics
        if self.orchestrator.collector is not None:
            self.orchestrator.collector(
                {"event": "metrics", "agent": msg.agent,
                 "metrics": msg.metrics, "time": t}
            )

    @register("computation_finished")
    def _on_computation_finished(self, sender: str, msg, t: float) -> None:
        self._finished_computations.add(msg.computation)

    @register("agent_stopped")
    def _on_agent_stopped(self, sender: str, msg, t: float) -> None:
        self._stopped_agents.add(msg.agent)
        if msg.metrics:
            self.agent_metrics[msg.agent] = msg.metrics
        if self._stopped_agents >= self.registered_agents:
            self.all_stopped.set()

    def expect_replication(self, agents: set, k: int, mode: str) -> None:
        """Arm the replication barrier for one round: expect an ack from
        every agent in ``agents`` and clear the previous round's ack set
        (a stale ack must never release a new barrier).  Achieved levels
        persist across rounds: a re-replication round overwrites them."""
        self.expected_replication_agents = set(agents)
        self.expected_replications = len(agents)
        self.replicated_agents.clear()
        self.all_replicated.clear()
        self.replication_mode_active = mode
        self.replication_round += 1
        self._replication_armed = True

    def note_agent_gone(self, agent_name: str) -> None:
        """An agent died or was removed: the current replication round
        must not wait for its ack, it is not routable (a later round must
        not ship the corpse as a candidate), and it can no longer host
        replicas: drop it everywhere placement decisions read.

        Runs on the timeline or scenario thread while the mgt thread may
        be inserting round reports: iterate over SNAPSHOTS."""
        self.expected_replication_agents.discard(agent_name)
        self._check_replication_barrier()
        self.agent_addresses.pop(agent_name, None)
        for comp, hosts in list(self.replica_hosts.items()):
            if agent_name in hosts:
                hosts.remove(agent_name)
                self.replication_levels[comp] = len(hosts)
        for holders in list(
            self.orchestrator.directory.directory.replicas.values()
        ):
            holders.discard(agent_name)

    def _check_replication_barrier(self) -> None:
        self._n_replicated = len(self.replicated_agents)
        if (
            self._replication_armed
            and self.replicated_agents >= self.expected_replication_agents
        ):
            self.all_replicated.set()

    @register("replicated")
    def _on_replicated(self, sender: str, msg, t: float) -> None:
        # placements are real regardless of the round that produced them
        # (the owner DID ship those replicas): always merge the view, but
        # never re-admit a host that died since the owner committed it
        for comp, hosts in (msg.replica_hosts or {}).items():
            live = [h for h in hosts if h in self.registered_agents]
            self.replica_hosts[comp] = live
            self.replication_levels[comp] = len(live)
            for h in live:
                self.orchestrator.directory.directory.replicas.setdefault(
                    comp, set()
                ).add(h)
        # ...but only an ack of the CURRENT round counts toward the
        # barrier, and set-based, so a duplicated ack cannot release it
        # while another agent is still replicating
        ack_round = getattr(msg, "round", None)
        if ack_round is not None and ack_round != self.replication_round:
            logger.info(
                "stale replication ack from %s (round %s, current %s)",
                msg.agent, ack_round, self.replication_round,
            )
            return
        self.replicated_agents.add(msg.agent)
        self._check_replication_barrier()

    @register("replica_retracted")
    def _on_replica_retracted(self, sender: str, msg, t: float) -> None:
        """A host removed a committed replica (released by its owner, shed
        on capacity loss, dropped on migration): prune the placement view
        so repair candidates and ``/status`` levels track reality."""
        hosts = self.replica_hosts.get(msg.comp)
        if hosts and msg.agent in hosts:
            hosts.remove(msg.agent)
            self.replication_levels[msg.comp] = len(hosts)
        self.orchestrator.directory.directory.replicas.get(
            msg.comp, set()
        ).discard(msg.agent)
        logger.debug(
            "replica of %s retracted by %s (%s)",
            msg.comp, msg.agent, msg.reason,
        )

    # -- repair --------------------------------------------------------

    def expect_repair_acks(self, n: int) -> None:
        """Arm the repair-ready barrier for one repair episode: expect
        ``n`` ``repair_ready`` acks and clear state left over from any
        previous episode.  The bumped ``repair_round`` is what actually
        keeps stale acks out: a straggler's late ack from a timed-out
        episode echoes the old round and is dropped by the handlers.
        The bump happens FIRST — bumping after arming would leave a
        window where a queued stale ack still matches the live round
        and counts toward the fresh barrier (no current-round ack can
        exist yet, since no setup_repair has been sent)."""
        self.repair_round += 1
        self.repair_ready_agents.clear()
        self.repair_selected.clear()
        self.all_repair_ready.clear()
        self.expected_repair_acks = n

    @register("repair_ready")
    def _on_repair_ready(self, sender: str, msg, t: float) -> None:
        """An agent finished ``setup_repair`` and names the orphaned
        computations it is a candidate host for.  Until this handler
        existed the ack was silently dropped (graftlint
        proto-unhandled-message), so the repair barrier could only be
        inferred, never observed."""
        ack_round = getattr(msg, "round", None)
        if ack_round is not None and ack_round != self.repair_round:
            logger.info(
                "stale repair_ready ack from %s (round %s, current %s)",
                msg.agent, ack_round, self.repair_round,
            )
            return
        self.repair_ready_agents[msg.agent] = list(msg.computations or [])
        if ack_round is not None and ack_round != self.repair_round:
            # a new episode armed on the scenario thread between the
            # check above and the insert: this ack belongs to the dead
            # episode — withdraw it instead of counting it toward the
            # fresh barrier (the residual window after this re-check is
            # the same advisory-barrier semantics a timeout has)
            self.repair_ready_agents.pop(msg.agent, None)
            return
        if (
            self.expected_repair_acks
            and len(self.repair_ready_agents) >= self.expected_repair_acks
        ):
            self.all_repair_ready.set()

    @register("repair_done")
    def _on_repair_done(self, sender: str, msg, t: float) -> None:
        """An agent's ``repair_run`` selection: the computations it chose
        to host, recorded per agent."""
        ack_round = getattr(msg, "round", None)
        if ack_round is not None and ack_round != self.repair_round:
            logger.info(
                "stale repair_done ack from %s (round %s, current %s)",
                msg.agent, ack_round, self.repair_round,
            )
            return
        self.repair_selected[msg.agent] = list(msg.selected or [])
        if ack_round is not None and ack_round != self.repair_round:
            # lost the race with a new episode arming: withdraw
            self.repair_selected.pop(msg.agent, None)

    #: bound on the repair-ready barrier: the repair must never hang on
    #: a silent survivor (it may itself be mid-crash); it proceeds on the
    #: orchestrator's own knowledge after naming the stragglers
    REPAIR_READY_TIMEOUT = 5.0

    def repair_orphans(self, removed_agent: str) -> Dict[str, Any]:
        """Re-host the computations of a removed agent, with pyDCOP's
        repair handshake: ``setup_repair`` fans out to every survivor,
        which answers ``repair_ready`` naming the orphans it holds
        replicas of; once the (bounded) ready barrier passes, the
        placement is decided and the migrated computations deployed, and
        ``repair_run`` tells the survivors to activate (their
        ``repair_done`` selections land in :attr:`repair_selected`).

        The placement is pyDCOP's repair DCOP (binary variables
        x_(computation, agent) under hosted, capacity, hosting-cost and
        communication-cost constraints, ``reparation/``), candidates the
        replica holders when replication ran, solved with MGM-2 on the
        orchestrator's device on this thread.  The solve's span and its
        launches by kernel go into ``orchestrator.repair_runs``.  The
        whole repair is a ``solve_control.second_solve``: the main solve
        keeps few replays queued meanwhile."""
        from ..utils.solve_control import second_solve

        with second_solve():
            return self._repair_orphans(removed_agent)

    def _repair_orphans(self, removed_agent: str) -> Dict[str, Any]:
        from ..compile.hopper_kernels import thread_tally
        from ..reparation import repair_distribution

        orc = self.orchestrator
        dist = orc.distribution
        orphans = list(dist.computations_hosted(removed_agent))
        if not orphans:
            return {"orphans": [], "migrated": {}}
        # phase 1: setup_repair -> repair_ready (bounded barrier).
        # Survivors' _mgt_ computations stay live through the repair
        # freeze (blanket pauses skip control-plane computations), so
        # the acks flow while the algorithm computations are paused.
        survivors = sorted(self.registered_agents)
        self.expect_repair_acks(len(survivors))
        repair_info = {
            "orphans": orphans,
            "removed": removed_agent,
            "round": self.repair_round,
        }
        for a in survivors:
            self.post_msg(
                f"_mgt_{a}",
                SetupRepairMessage(repair_info=repair_info),
                MSG_MGT,
            )
        if survivors and not self.all_repair_ready.wait(
            self.REPAIR_READY_TIMEOUT
        ):
            acked = dict(self.repair_ready_agents)
            missing = sorted(set(survivors) - set(acked))
            logger.warning(
                "repair-ready barrier missed %d/%d ack(s) within "
                "%.1fs (no repair_ready from %s) — proceeding with "
                "the orchestrator's own placement knowledge",
                len(missing), len(survivors),
                self.REPAIR_READY_TIMEOUT, missing,
            )
        t0 = time.perf_counter()
        repicked = repair_distribution.repicked
        with thread_tally() as launches:
            new_dist, metrics = repair_distribution(
                orc.cg,
                [
                    a
                    for a in orc.agent_defs
                    if a.name in self.registered_agents
                ],
                dist,
                removed_agent,
                orc.algo,
                replica_hosts=self.replica_hosts or None,
                device=orc.device,
            )
        orc.repair_runs.append({
            "removed": removed_agent,
            "span": (t0, time.perf_counter()),
            "launches": {w.__name__: n for w, n in launches.items()},
            "metrics": dict(metrics),
            # the JAX package's two fallbacks, counted: a greedy placement
            # (the tabulation guard) and the orphans MGM-2 gave no host
            # or several
            "greedy": metrics["repair_status"] == "GREEDY",
            "repicked": repair_distribution.repicked - repicked,
        })
        orc.distribution = new_dist
        # phase 2: deploy migrated computations on their new hosts
        for comp in orphans:
            new_agent = new_dist.agent_for(comp)
            node = orc.cg.computation(comp)
            self.post_msg(
                f"_mgt_{new_agent}",
                DeployMessage(comp_def=ComputationDef(node, orc.algo)),
                MSG_MGT,
            )
        # phase 3: repair_run -> repair_done (fire-and-forget: the
        # selections are bookkeeping, nothing blocks on them)
        for a in survivors:
            self.post_msg(f"_mgt_{a}", RepairRunMessage(), MSG_MGT)
        metrics["orphans"] = orphans
        metrics["repair_ready_agents"] = sorted(
            dict(self.repair_ready_agents)
        )
        return metrics
