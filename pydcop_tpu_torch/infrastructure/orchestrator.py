"""Orchestrator: bootstrap, deployment, run control, metrics sink.

The port's copy of ``pydcop_tpu/infrastructure/orchestrator.py``:
``Orchestrator`` (an Agent named "orchestrator" hosting the Directory and
an ``AgentsMgt`` management computation; ``start``,
``deploy_computations``, ``run``, ``stop_agents``, ``current_solution``,
``end_metrics``, ``watch_status``) and ``AgentsMgt`` (registration
barriers, deploy fan-out, value/cycle/metric collection and the repair
handshake's acks), with pyDCOP's management message taxonomy.

pyDCOP's agents compute and its orchestrator coordinates.  Here the
orchestrator also owns the card: ``run()`` starts a ``device-solve``
thread that runs the whole DCOP as one ``api.solve_result`` on the
orchestrator's ``device``, then posts the per-cycle costs and one value
read-back a computation to the hosting agents, so the rest of the
control plane (metrics modes, UI, discovery) observes what pyDCOP's
would.  Every CUDA call of a run is on that thread: the agents, the UI,
a ``/metrics`` scrape and the ``--period`` poll read host state only, so
nothing touches the card while the solve captures its graphs.

Scenarios, agent kills and arrivals, replication and repair
(``start_replication``, ``set_agent_capacity``, ``kill_agent``,
``repair_orphans``, scenario play) are not ported yet: they raise
``NotImplementedError`` naming the ROADMAP's queue item.
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

__all__ = ["Orchestrator", "AgentsMgt", "ORCHESTRATOR", "NOT_PORTED"]

logger = logging.getLogger("pydcop_tpu.orchestrator")

ORCHESTRATOR = "orchestrator"
ORCHESTRATOR_MGT = "_mgt_orchestrator"

#: the valid replica-placement paths (the negotiation vs the centralized
#: UCS oracle), as in the JAX package
REPLICATION_MODES = ("distributed", "local")

#: what the parts of the runtime that are not ported yet say when called
NOT_PORTED = (
    "not ported yet: scenarios, agent kills and arrivals, replication and "
    "repair come with the run verb (ROADMAP, Queue 1: the run verb with "
    "scenarios, resilience/, replication/, reparation/ and chaos/layer.py)"
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
        # how start_replication would place replicas, validated as in the
        # JAX package (replication itself is not ported yet)
        if replication_mode not in REPLICATION_MODES:
            raise ValueError(
                f"replication_mode must be one of {REPLICATION_MODES}, "
                f"got {replication_mode!r}"
            )
        self.replication_mode = replication_mode
        # the standing k-target: None while replication is not ported
        self.ktarget: Optional[int] = None
        # a ChaosController (chaos/controller.py) whose schedule holds
        # process kills only (the faults that need no agent machinery)
        # and, on thread topologies, the local agent objects
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
        """Ask every agent to replicate its computations k times: not
        ported yet."""
        raise NotImplementedError(f"start_replication: {NOT_PORTED}")

    def set_agent_capacity(self, agent_name: str, capacity: float) -> None:
        """Tell an agent its capacity changed (replication's retraction
        trigger): not ported yet."""
        raise NotImplementedError(f"set_agent_capacity: {NOT_PORTED}")

    def run(
        self,
        scenario=None,
        timeout: Optional[float] = None,
        repair_only: bool = False,
        ready_timeout: Optional[float] = None,
    ) -> None:
        """Start the computations and drive the device solve to completion.
        Blocks until finished / timeout.  A ``scenario`` is not ported
        yet: it raises before anything runs.

        ``ready_timeout`` bounds the wait for deployment confirmations;
        the default scales with the number of computations (each is one
        round-trip through the management plane — measured ~1ms each, so
        10k computations need more than a fixed 10s).
        """
        if scenario is not None:
            raise NotImplementedError(f"scenario play: {NOT_PORTED}")
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
            budget = None if timeout is None else timeout
            finished = self._solve_done.wait(budget)
            if not finished:
                self.status = "TIMEOUT"
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
        # no replication block: the JAX package adds one only once a
        # replication round was requested, which the port cannot do yet
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
        from ..api import solve_result

        # one retry on the card: a transient device failure must not take
        # down a run whose whole control plane is healthy; a deterministic
        # error just fails twice.  Never on the CPU (its failures are
        # deterministic), and not after a sticky CUDA error, which fails
        # every later CUDA call of this process: reported, not masked
        attempts = 2 if str(self.device).startswith("cuda") else 1
        r = None
        t0 = time.perf_counter()
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
                    r = solve_result(
                        self.dcop,
                        self.algo,
                        n_cycles=self.n_cycles,
                        seed=self.seed,
                        collect_curve=True,
                        infinity=self.infinity,
                        compiled=self.compiled,
                        device=self.device,
                    )
                break
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
                self.device_solve_s = time.perf_counter() - t0
                self._solve_done.set()
                return
        self.device_solve_s = time.perf_counter() - t0
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

    # ------------------------------------------------------------------
    # scenarios, kills and repair: not ported yet
    # ------------------------------------------------------------------

    def _play_scenario(self, scenario) -> None:
        raise NotImplementedError(f"scenario play: {NOT_PORTED}")

    def _add_agent(self, agent_name: str) -> None:
        raise NotImplementedError(f"add_agent: {NOT_PORTED}")

    def kill_agent(self, agent_name: str) -> None:
        raise NotImplementedError(f"kill_agent: {NOT_PORTED}")

    def _remove_agent(self, agent_name: str, crashed: bool = False) -> None:
        raise NotImplementedError(f"remove_agent: {NOT_PORTED}")


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
        self.all_registered = threading.Event()
        self.ready_to_run = threading.Event()
        self.all_stopped = threading.Event()
        self._stopped_agents: set = set()
        self._finished_computations: set = set()
        # the repair handshake's state: agents that acked setup_repair
        # with the computations they can host, and the selections
        # repair_run produced (repair_orphans, which speaks the
        # handshake, is not ported yet; the acks are recorded already)
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

    def repair_orphans(self, removed_agent: str) -> Dict[str, Any]:
        """Re-host the computations of a removed agent: not ported yet."""
        raise NotImplementedError(f"repair_orphans: {NOT_PORTED}")
