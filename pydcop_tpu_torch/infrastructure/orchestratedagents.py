"""Orchestrated agents: workers wired to an orchestrator.

The port's copy of ``pydcop_tpu/infrastructure/orchestratedagents.py``:
``OrchestratedAgent`` (an agent pre-wired to the orchestrator's
directory) and ``OrchestrationComputation`` (the worker-side management
endpoint ``_mgt_<agent>`` handling deploy / run / pause / resume /
replication / repair / stop, and pushing ValueChange / Metrics / Stopped
messages up).

A deployment instantiates host-side bookkeeping computations
(``DeviceShardComputation``): the algorithm runs on the card under the
orchestrator.  Every agent hosts a ``ReplicationComputation``
(``resilience/negotiation.py``), both halves of the replica negotiation,
and keeps the replicas it holds in ``replica_store``.  Nothing here
imports torch: an agent process (the ``agent`` verb, process mode's
spawned agents) keeps its books on the host only.  Pricing a replica
reads the algorithm's footprint model (its module, which imports torch),
so an agent process that takes part in a replication round imports it
then, and not before.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from ..algorithms import ComputationDef
from .agents import Agent
from .communication import CommunicationLayer, MSG_MGT, MSG_VALUE
from .computations import (
    Message,
    MessagePassingComputation,
    build_computation,
    register,
)
from .orchestrator import (
    AgentStoppedMessage,
    ComputationFinishedMessage,
    ComputationReplicatedMessage,
    DeployedMessage,
    MetricsMessage,
    ORCHESTRATOR,
    ORCHESTRATOR_MGT,
    RegisterAgentMessage,
    RepairDoneMessage,
    RepairReadyMessage,
    ValueChangeMessage,
)

__all__ = ["OrchestratedAgent", "OrchestrationComputation"]

logger = logging.getLogger("pydcop_tpu_torch.orchestratedagents")


class OrchestrationComputation(MessagePassingComputation):
    """Management endpoint ``_mgt_<agent>`` on every orchestrated agent."""

    def __init__(self, agent: "OrchestratedAgent") -> None:
        super().__init__(f"_mgt_{agent.name}")
        self.agent = agent

    def on_start(self) -> None:
        # register with the orchestrator (pyDCOP's retry loop,
        # agents.py:623-636, is unnecessary: the route is known up front)
        self.post_msg(
            ORCHESTRATOR_MGT,
            RegisterAgentMessage(
                agent=self.agent.name,
                address=self.agent.communication.address,
            ),
            MSG_MGT,
        )

    # -- deployment ----------------------------------------------------

    @register("deploy")  # graftproto: replies=deployed
    def _on_deploy(self, sender: str, msg, t: float) -> None:
        comp_def: ComputationDef = msg.comp_def
        comp = build_computation(comp_def)
        self.agent.add_computation(comp)
        self.agent.deployed.append(comp_def.name)
        logger.debug(
            "%s: deployed computation %s", self.agent.name, comp_def.name
        )
        # a deployment consumes capacity: drop a now-shadowed
        # own-computation replica (migration) and shed over-capacity ones
        self.agent.replication.on_deployed(comp_def.name)
        # ack only the NEW computation: a cumulative list would make the
        # ack payloads (and the orchestrator's readiness scan) quadratic
        # in the computation count — measured 300+ s of deployment at
        # 100k computations before this
        self.post_msg(
            ORCHESTRATOR_MGT,
            DeployedMessage(
                agent=self.agent.name, computations=[comp_def.name]
            ),
            MSG_MGT,
        )

    # -- lifecycle -----------------------------------------------------

    @register("run_computations")
    def _on_run(self, sender: str, msg, t: float) -> None:
        self.agent.run_computations(msg.computations)

    @register("pause_computations")
    def _on_pause(self, sender: str, msg, t: float) -> None:
        self.agent.pause_computations(msg.computations, paused=True)

    @register("resume_computations")
    def _on_resume(self, sender: str, msg, t: float) -> None:
        self.agent.pause_computations(msg.computations, paused=False)

    @register("stop_agent")  # graftproto: replies=agent_stopped
    def _on_stop_agent(self, sender: str, msg, t: float) -> None:
        self.post_msg(
            ORCHESTRATOR_MGT,
            AgentStoppedMessage(
                agent=self.agent.name, metrics=self.agent.metrics()
            ),
            MSG_MGT,
        )
        if msg.forced:
            self.agent.stop()
        else:
            self.agent.clean_shutdown()

    @register("agent_removed")
    def _on_agent_removed(self, sender: str, msg, t: float) -> None:
        logger.info(
            "%s: removed from the system (%s)", self.agent.name, msg.reason
        )
        self.agent.clean_shutdown()

    # -- value readbacks (device solve -> bookkeeping computations) ----

    @register("value_readback_fwd")
    def _on_value_readback_fwd(self, sender: str, msg, t: float) -> None:
        comp_name, value, cost = msg.content
        try:
            comp = self.agent.computation(comp_name)
        except Exception:
            return
        handler = getattr(comp, "_on_value_readback", None)
        if handler is not None:
            # dispatching value_readback fires the computation's
            # on_value_selection hook, which the agent wrapped to push the
            # ValueChangeMessage up — no second post here
            comp.on_message(
                "_device", Message("value_readback", (value, cost)), t
            )

    # -- metrics -------------------------------------------------------

    @register("metrics_request")  # graftproto: replies=metrics
    def _on_metrics_request(self, sender: str, msg, t: float) -> None:
        self.post_msg(
            ORCHESTRATOR_MGT,
            MetricsMessage(
                agent=self.agent.name, metrics=self.agent.metrics()
            ),
            MSG_MGT,
        )

    # -- resilience ----------------------------------------------------

    @register("replication")
    def _on_replication(self, sender: str, msg, t: float) -> None:
        self.agent.known_agents = dict(msg.agents or {})
        mode = getattr(msg, "mode", None) or "local"
        round_id = getattr(msg, "round", None)
        if mode == "distributed":
            # the negotiation round acks asynchronously (the round posts
            # ComputationReplicatedMessage when it finishes, possibly at
            # partial k)
            self.agent.replication.start_round(
                msg.k, dict(msg.agents or {}), round_id=round_id
            )
            return
        hosts = self.agent.replicate(
            msg.k, agent_defs=getattr(msg, "agent_defs", None)
        )
        self.post_msg(
            ORCHESTRATOR_MGT,
            ComputationReplicatedMessage(
                agent=self.agent.name, replica_hosts=hosts,
                round=round_id,
            ),
            MSG_MGT,
        )

    @register("store_replica")
    def _on_store_replica(self, sender: str, msg, t: float) -> None:
        comp_name, comp_def = msg.content
        owner = sender[len("_mgt_"):] if sender.startswith("_mgt_") else sender
        # through the same ledger as negotiated replicas, so retraction
        # and capacity shedding treat both replication modes alike
        self.agent.replication.adopt_replica(owner, comp_name, comp_def)

    @register("setup_repair")  # graftproto: replies=repair_ready
    def _on_setup_repair(self, sender: str, msg, t: float) -> None:
        comps = self.agent.setup_repair(msg.repair_info)
        # echo the episode's round so a late ack after a barrier
        # timeout can never release the NEXT episode's barrier
        self.post_msg(
            ORCHESTRATOR_MGT,
            RepairReadyMessage(
                agent=self.agent.name, computations=comps,
                round=(msg.repair_info or {}).get("round"),
            ),
            MSG_MGT,
        )

    @register("repair_run")  # graftproto: replies=repair_done
    def _on_repair_run(self, sender: str, msg, t: float) -> None:
        selected = self.agent.repair_run()
        repair_info = getattr(self.agent, "_repair_info", None) or {}
        self.post_msg(
            ORCHESTRATOR_MGT,
            RepairDoneMessage(
                agent=self.agent.name, selected=selected,
                round=repair_info.get("round"),
            ),
            MSG_MGT,
        )


class OrchestratedAgent(Agent):
    """An agent managed by a remote orchestrator (pyDCOP
    orchestratedagents.py:71)."""

    def __init__(
        self,
        name: str,
        comm: CommunicationLayer,
        orchestrator_address: Any,
        agent_def: Any = None,
        metrics_period: Optional[float] = None,
        ui_port: Optional[int] = None,
        delay: float = 0.0,
    ) -> None:
        super().__init__(
            name, comm, agent_def=agent_def, ui_port=ui_port, delay=delay
        )
        self.orchestrator_address = orchestrator_address
        self.deployed: List[str] = []
        self.replica_store: Dict[str, ComputationDef] = {}
        self.messaging.register_route(
            ORCHESTRATOR_MGT, ORCHESTRATOR, orchestrator_address
        )
        self.messaging.register_route(
            "_directory", ORCHESTRATOR, orchestrator_address
        )
        self.orchestration = OrchestrationComputation(self)
        self.add_computation(self.orchestration, publish=False)
        # both halves of the replication negotiation live here (owner walk
        # and candidate capacity ledger, resilience/)
        from ..resilience.negotiation import ReplicationComputation

        self.replication = ReplicationComputation(self)
        self.add_computation(self.replication, publish=False)
        if metrics_period:
            self.add_periodic_action(
                metrics_period, self._periodic_metrics
            )

    def _on_start(self) -> None:
        super()._on_start()
        self.orchestration.start()
        self.replication.start()

    def _periodic_metrics(self) -> None:
        self.orchestration.post_msg(
            ORCHESTRATOR_MGT,
            MetricsMessage(agent=self.name, metrics=self.metrics()),
            MSG_MGT,
        )

    def on_computation_value_changed(self, name: str, value, cost) -> None:
        # per-computation ValueChange push (collection mode value_change,
        # pyDCOP orchestratedagents.py:303-322)
        self.orchestration.post_msg(
            ORCHESTRATOR_MGT,
            ValueChangeMessage(
                computation=name, value=value, cost=cost, cycle=None
            ),
            MSG_VALUE,
        )

    def on_computation_finished(self, name: str) -> None:
        # completion push (pyDCOP agents.py:870): lands in
        # AgentsMgt._finished_computations — the receive half existed
        # since the seed, but until graftproto flagged the dead
        # conversation nothing ever sent it
        self.orchestration.post_msg(
            ORCHESTRATOR_MGT,
            ComputationFinishedMessage(computation=name),
            MSG_MGT,
        )

    # -- resilience hooks ------------------------------------------------

    def replicate(
        self, k: int, agent_defs: Optional[Dict[str, Any]] = None
    ) -> Dict[str, List[str]]:
        """Centralized (``replication_mode="local"``) replica placement:
        k replicas of every hosted computation def on other agents
        (pyDCOP ResilientAgent.replicate, via replication/'s UCS).  The
        distributed protocol goes through ``self.replication``
        instead."""
        from ..replication import replicate_computations

        return replicate_computations(self, k, agent_defs=agent_defs)

    def setup_repair(self, repair_info: Any) -> List[str]:
        """Accept repair responsibility for orphaned computations this agent
        holds replicas of (pyDCOP agents.py:1047): the repair_ready
        ack names only the orphans actually present in this agent's
        replica store — candidacy is a claim about held state, not an
        echo of the orchestrator's orphan list."""
        self._repair_info = repair_info
        orphans = set(repair_info.get("orphans", []))
        return sorted(orphans & set(self.replica_store))

    def repair_run(self) -> List[str]:
        """The repair decision itself is computed on device by the
        orchestrator (reparation.repair_distribution); agents acknowledge."""
        return []
