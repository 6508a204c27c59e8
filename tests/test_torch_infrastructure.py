"""The port's agent runtime (``pydcop_tpu_torch/infrastructure/``) on the
CPU, against the JAX package's.

Case for case the in-slice part of ``tests/test_infrastructure.py``: the
message substrate, agents over the in-process layer, the orchestrated
thread topology end to end, the control plane at 10,000 variables and
the websocket UI.  Then the two packages side by side: every management
message's ``simple_repr``, thread mode's ``end_metrics()`` (MaxSum on
``ell``, DSA, DPOP, on seeded problems, clocks excluded) and its
``value_change``/``cycle_change`` collector rows, exact wherever both
packages run the same solve; the ``orchestrator`` and ``agent`` verbs'
JSON; scenarios, replication, agent kills and repair run, and message
rules, which are not ported yet, are refused with
``NotImplementedError``.  The port runs with
``device="cpu"`` (``--device cpu`` on its CLI), the JAX package under
``JAX_PLATFORMS=cpu``."""

import importlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pydcop_tpu_torch.dcop import (
    DCOP,
    AgentDef,
    Domain,
    Variable,
    constraint_from_str,
)
from pydcop_tpu_torch.dcop.scenario import Scenario
from pydcop_tpu_torch.infrastructure import (
    Agent,
    ComputationException,
    InProcessCommunicationLayer,
    Message,
    MessagePassingComputation,
    SynchronousComputationMixin,
    event_bus,
    message_type,
    register,
)
from pydcop_tpu_torch.infrastructure.run import (
    run_local_thread_dcop,
    solve,
)
from pydcop_tpu_torch.utils.simple_repr import from_repr, simple_repr


def coloring_dcop(n_agents=3):
    d = Domain("colors", "", ["R", "G", "B"])
    x, y, z = Variable("x", d), Variable("y", d), Variable("z", d)
    dcop = DCOP("chain")
    dcop += constraint_from_str("c1", "10 if x == y else 0", [x, y])
    dcop += constraint_from_str("c2", "10 if y == z else 0", [y, z])
    dcop.add_agents(
        [AgentDef(f"a{i}", capacity=100) for i in range(n_agents)]
    )
    return dcop


# ---------------------------------------------------------------------------
# tier 1: substrate units
# ---------------------------------------------------------------------------


class TestMessageType:
    def test_fields_and_size(self):
        Msg = message_type("test_msg_a", ["value", "stuff"])
        m = Msg(value=[1, 2, 3], stuff="x")
        assert m.type == "test_msg_a"
        assert m.value == [1, 2, 3]
        assert m.size == 4  # len([1,2,3]) + len("x")

    def test_serialization_roundtrip(self):
        Msg = message_type("test_msg_b", ["value"])
        m = Msg(value=42)
        m2 = from_repr(simple_repr(m))
        assert m2 == m and m2.value == 42

    def test_conflicting_redefinition_rejected(self):
        message_type("test_msg_c", ["a"])
        with pytest.raises(ValueError):
            message_type("test_msg_c", ["a", "b"])

    def test_management_message_taxonomy_roundtrips(self):
        # every management message the control plane exchanges must
        # survive simple_repr serialization: the process/HTTP topology
        # ships them as JSON
        from pydcop_tpu_torch.infrastructure import discovery as dsc
        from pydcop_tpu_torch.infrastructure import orchestrator as orc
        from pydcop_tpu_torch.infrastructure.computations import (
            SynchronizationMsg,
        )

        samples = [
            orc.DeployMessage(comp_def={"name": "x", "algo": "dsa"}),
            orc.RunAgentMessage(computations=["x", "y"]),
            orc.PauseMessage(computations=None),
            orc.ResumeMessage(computations=["x"]),
            orc.StopAgentMessage(forced=False),
            orc.AgentRemovedMessage(reason="scenario"),
            orc.RegisterAgentMessage(agent="a1", address="tcp://h:1"),
            orc.DeployedMessage(agent="a1", computations=["x"]),
            orc.ValueChangeMessage(
                computation="x", value=2, cost=1.5, cycle=3
            ),
            orc.CycleChangeMessage(cycle=4, cost=10.0),
            orc.MetricsMessage(agent="a1", metrics={"count": {"x": 1}}),
            orc.ComputationFinishedMessage(computation="x"),
            orc.AgentStoppedMessage(agent="a1", metrics={"t": 0.5}),
            orc.ReplicateComputationsMessage(
                k=2, agents=["a1", "a2"], mode="distributed",
                agent_defs=None, round=1,
            ),
            orc.ComputationReplicatedMessage(
                agent="a1", replica_hosts={"x": ["a2", "a3"]}, round=1
            ),
            orc.SetupRepairMessage(
                repair_info={"orphans": ["x"], "round": 1}
            ),
            orc.RepairReadyMessage(
                agent="a1", computations=["x"], round=1
            ),
            orc.RepairRunMessage(),
            orc.RepairDoneMessage(agent="a1", selected=["x"], round=1),
            dsc.PublishAgentMessage(agent="a1", address="tcp://h:1"),
            dsc.UnpublishAgentMessage(agent="a1"),
            dsc.PublishComputationMessage(
                computation="x", agent="a1", address="tcp://h:1"
            ),
            dsc.UnpublishComputationMessage(computation="x"),
            dsc.PublishReplicaMessage(replica="x", agent="a2"),
            dsc.UnpublishReplicaMessage(replica="x", agent="a2"),
            dsc.SubscribeMessage(
                kind="agent", name=None, subscribe=True
            ),
            SynchronizationMsg(cycle_id=7),
        ]
        for msg in samples:
            back = from_repr(simple_repr(msg))
            assert type(back) is type(msg), msg.type
            assert back.type == msg.type
            for field in type(msg)._repr_fields:
                assert getattr(back, field) == getattr(msg, field), (
                    msg.type, field,
                )


class Echo(MessagePassingComputation):
    def __init__(self, name):
        super().__init__(name)
        self.received = []

    @register("ping")
    def _on_ping(self, sender, msg, t):
        self.received.append((sender, msg.content))
        self.post_msg(sender, Message("pong", msg.content))

    @register("pong")
    def _on_pong(self, sender, msg, t):
        self.received.append((sender, msg.content))


class TestComputation:
    def test_handler_dispatch(self):
        c = Echo("e1")
        sent = []
        c.message_sender = lambda s, d, m, p: sent.append((s, d, m))
        c.start()
        c.on_message("other", Message("ping", 42), 0.0)
        assert c.received == [("other", 42)]
        assert sent and sent[0][1] == "other" and sent[0][2].type == "pong"

    def test_unknown_message_raises(self):
        c = Echo("e2")
        with pytest.raises(ComputationException):
            c.on_message("other", Message("nope", None), 0.0)

    def test_pause_buffers_messages(self):
        c = Echo("e3")
        sent = []
        c.message_sender = lambda s, d, m, p: sent.append(d)
        c.start()
        c.pause(True)
        c.on_message("other", Message("ping", 1), 0.0)
        assert c.received == []
        c.pause(False)
        assert c.received == [("other", 1)] and sent == ["other"]


class SyncPair(SynchronousComputationMixin, MessagePassingComputation):
    def __init__(self, name, neighbor):
        super().__init__(name)
        self.neighbor = neighbor
        self.cycles_seen = []

    def synchronized_neighbors(self):
        return [self.neighbor]

    def on_start(self):
        self.start_cycle()
        self.post_sync_msg(self.neighbor, Message("tick", 0))

    @register("tick")
    def _on_tick(self, sender, msg, t):
        self.on_sync_message(sender, msg, t)

    @register("_sync")
    def _on_sync(self, sender, msg, t):
        self.on_sync_message(sender, msg, t)

    def on_new_cycle(self, messages, cycle_id):
        self.cycles_seen.append(cycle_id)
        if cycle_id < 3:
            self.post_sync_msg(self.neighbor, Message("tick", cycle_id))


class TestSynchronousMixin:
    def test_cycle_progression(self):
        # queued wiring like the agent loop: deliveries happen after both
        # computations started, never reentrantly
        a, b = SyncPair("a", "b"), SyncPair("b", "a")
        qa, qb = [], []
        a.message_sender = lambda s, d, m, p: qb.append((s, m))
        b.message_sender = lambda s, d, m, p: qa.append((s, m))
        a.start_cycle()
        b.start_cycle()
        a.start()
        b.start()
        for _ in range(50):
            if not qa and not qb:
                break
            if qb:
                s, m = qb.pop(0)
                b.on_message(s, m, 0.0)
            if qa:
                s, m = qa.pop(0)
                a.on_message(s, m, 0.0)
        assert a.cycles_seen[:3] == [1, 2, 3]
        assert b.cycles_seen[:3] == [1, 2, 3]

    def test_double_message_detected(self):
        a = SyncPair("a", "b")
        a.message_sender = lambda *args: None
        a.start_cycle()
        m1, m2 = Message("tick", 0), Message("tick", 0)
        m1._cycle_id = 0
        m2._cycle_id = 0
        a._on_tick("b", m1, 0.0)
        # second message for the same cycle: protocol race
        a._cycle_msgs["b"] = m1  # keep buffer non-empty
        with pytest.raises(ComputationException):
            a.on_sync_message("b", m2, 0.0)

    def test_next_cycle_message_buffered_not_lost(self):
        # a fast neighbor's cycle-(c+1) message arrives before this node
        # finishes cycle c: it must be buffered and consumed by the next
        # round, not dropped or treated as current (reference
        # computations.py:698-725 semantics)
        a = SyncPair("a", "b")
        sent = []
        a.message_sender = lambda s, d, m, p: sent.append((d, m))
        a.start_cycle()
        ahead = Message("tick", "ahead")
        ahead._cycle_id = 1
        a.on_sync_message("b", ahead, 0.0)
        assert a.cycle_count == 0  # not advanced by a future message
        now = Message("tick", "now")
        now._cycle_id = 0
        a.on_sync_message("b", now, 0.0)
        # cycle 0 completed with "now"; the buffered "ahead" message is
        # already in the new current-cycle buffer
        assert a.cycles_seen == [1]
        assert a.current_cycle["b"].content == "ahead"
        # and completing cycle 1 needs nothing more from b
        assert a.cycle_count == 1

    def test_skew_beyond_one_cycle_raises(self):
        a = SyncPair("a", "b")
        a.message_sender = lambda *args: None
        a.start_cycle()
        far = Message("tick", 0)
        far._cycle_id = 2
        with pytest.raises(ComputationException, match="skew"):
            a.on_sync_message("b", far, 0.0)

    def test_padding_sent_to_silent_neighbors(self):
        # a node with nothing to say still closes the round for its
        # neighbors with a _sync padding message (SyncPair always speaks,
        # so use a silent variant)
        class Silent(SyncPair):
            def on_new_cycle(self, messages, cycle_id):
                self.cycles_seen.append(cycle_id)  # no send

        a = Silent("a", "b")
        sent = []
        a.message_sender = lambda s, d, m, p: sent.append((d, m))
        a.start_cycle()
        m = Message("tick", 0)
        m._cycle_id = 0
        a.on_sync_message("b", m, 0.0)
        pads = [(d, mm) for d, mm in sent if mm.type == "_sync"]
        assert len(pads) == 1
        assert pads[0][0] == "b"
        assert pads[0][1]._cycle_id == 1  # stamped with the NEW cycle
        assert [d for d, _ in sent] == ["b"]  # nothing else went out


# ---------------------------------------------------------------------------
# tier 2: agents + discovery in-process
# ---------------------------------------------------------------------------


class TestAgents:
    def test_two_agents_message_exchange(self):
        a1 = Agent("a1", InProcessCommunicationLayer())
        a2 = Agent("a2", InProcessCommunicationLayer())
        e1, e2 = Echo("e1"), Echo("e2")
        a1.add_computation(e1, publish=False)
        a2.add_computation(e2, publish=False)
        # wire routes manually (no directory in this test)
        a1.messaging.register_route("e2", "a2", a2.communication.address)
        a2.messaging.register_route("e1", "a1", a1.communication.address)
        a1.start()
        a2.start()
        e1.start()
        e2.start()
        e1.post_msg("e2", Message("ping", "hello"))
        deadline = time.time() + 2
        while time.time() < deadline and not e1.received:
            time.sleep(0.01)
        assert ("e1", "hello") in e2.received  # ping arrived
        assert ("e2", "hello") in e1.received  # pong came back
        a1.clean_shutdown()
        a2.clean_shutdown()
        a1.join()
        a2.join()

    def test_parked_message_sent_on_route_discovery(self):
        a1 = Agent("a1", InProcessCommunicationLayer())
        a2 = Agent("a2", InProcessCommunicationLayer())
        e1, e2 = Echo("p1"), Echo("p2")
        a1.add_computation(e1, publish=False)
        a2.add_computation(e2, publish=False)
        a1.start()
        a2.start()
        e1.start()
        e2.start()
        e1.post_msg("p2", Message("ping", 1))  # no route yet: parked
        time.sleep(0.1)
        assert e2.received == []
        a1.messaging.register_route("p2", "a2", a2.communication.address)
        a2.messaging.register_route("p1", "a1", a1.communication.address)
        deadline = time.time() + 2
        while time.time() < deadline and not e2.received:
            time.sleep(0.01)
        assert ("p1", 1) in e2.received
        a1.clean_shutdown()
        a2.clean_shutdown()

    def test_metrics_counts_external_messages(self):
        a1 = Agent("m1", InProcessCommunicationLayer())
        a2 = Agent("m2", InProcessCommunicationLayer())
        e1, e2 = Echo("q1"), Echo("q2")
        a1.add_computation(e1, publish=False)
        a2.add_computation(e2, publish=False)
        a1.messaging.register_route("q2", "m2", a2.communication.address)
        a2.messaging.register_route("q1", "m1", a1.communication.address)
        a1.start()
        a2.start()
        e1.start()
        e2.start()
        e1.post_msg("q2", Message("ping", 5))
        time.sleep(0.3)
        m = a1.metrics()
        assert m["count_ext_msg"].get("q1", 0) >= 1
        a1.clean_shutdown()
        a2.clean_shutdown()


# ---------------------------------------------------------------------------
# tier 3: full orchestrated run (thread topology)
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent.parent


def _run_thread(dcop, algo, distribution="oneagent", **kw):
    return run_local_thread_dcop(algo, dcop, distribution, device="cpu",
                                 **kw)


class TestOrchestratedRun:
    def test_solve_through_runtime(self):
        dcop = coloring_dcop()
        assignment = solve(dcop, "dpop", "oneagent", device="cpu")
        vals = [assignment["x"], assignment["y"], assignment["z"]]
        assert vals[0] != vals[1] and vals[1] != vals[2]

    def test_full_lifecycle_and_metrics(self):
        dcop = coloring_dcop()
        collected = []
        orchestrator = _run_thread(
            dcop, "dsa", n_cycles=20, seed=1, collector=collected.append,
        )
        try:
            orchestrator.deploy_computations()
            orchestrator.run(timeout=30)
            assert orchestrator.status == "FINISHED"
            assignment, cost = orchestrator.current_solution()
            assert set(assignment) == {"x", "y", "z"}
            metrics = orchestrator.end_metrics()
            assert metrics["status"] == "FINISHED"
            assert metrics["cycle"] == 20
            assert metrics["cost"] == cost
            # value readbacks arrived at the mgt computation as value_change
            deadline = time.time() + 2
            while time.time() < deadline and len(collected) < 3:
                time.sleep(0.02)
            comps = {
                c["computation"]
                for c in collected
                if c["event"] == "value_change"
            }
            assert comps == {"x", "y", "z"}
            # the device solve and its read-back, timed apart
            assert orchestrator.device_solve_s > 0
            assert orchestrator.readback_s >= 0
        finally:
            orchestrator.stop_agents()
            orchestrator.stop()

    def test_metrics_request_poll_and_repair_acks(self):
        # the send half of the agents' metrics_request handler and the
        # receive half of the repair_ready/repair_done acks.  The JAX
        # package keeps run() alive with a scenario's delay event; the
        # port plays no scenario yet, so a longer solve does it
        dcop = coloring_dcop()
        collected = []
        orchestrator = _run_thread(
            dcop, "dsa", n_cycles=3000, collector=collected.append,
            collect_moment="period", collect_period=0.05,
        )
        try:
            orchestrator.deploy_computations()
            orchestrator.run(timeout=60)
            assert any(c["event"] == "metrics" for c in collected), (
                "collect_period poll produced no metrics events"
            )
            # the poll is de-registered once run() returns
            assert orchestrator.mgt._periodic == []
            # live metrics poll: every registered agent answers with a
            # MetricsMessage that lands in agent_metrics
            orchestrator.mgt.agent_metrics.clear()
            orchestrator.request_agent_metrics()
            deadline = time.time() + 5
            expected = set(orchestrator.mgt.registered_agents)
            while time.time() < deadline and set(
                orchestrator.mgt.agent_metrics
            ) < expected:
                time.sleep(0.02)
            assert set(orchestrator.mgt.agent_metrics) >= expected
            # repair handshake acks are recorded, not dropped, and the
            # armed barrier releases when every expected ack arrived
            from pydcop_tpu_torch.infrastructure import orchestrator as orc

            orchestrator.mgt.expect_repair_acks(1)
            assert not orchestrator.mgt.all_repair_ready.is_set()
            rnd = orchestrator.mgt.repair_round
            orchestrator.mgt.on_message(
                "a1",
                orc.RepairReadyMessage(
                    agent="a1", computations=["x"], round=rnd
                ),
                0.0,
            )
            orchestrator.mgt.on_message(
                "a1",
                orc.RepairDoneMessage(
                    agent="a1", selected=["x"], round=rnd
                ),
                0.0,
            )
            assert orchestrator.mgt.repair_ready_agents == {"a1": ["x"]}
            assert orchestrator.mgt.repair_selected == {"a1": ["x"]}
            assert orchestrator.mgt.all_repair_ready.is_set()
            # re-arming clears the previous episode's acks and bumps
            # the round
            orchestrator.mgt.expect_repair_acks(2)
            assert orchestrator.mgt.repair_ready_agents == {}
            assert not orchestrator.mgt.all_repair_ready.is_set()
            assert orchestrator.mgt.repair_round == rnd + 1
            # a straggler's ack from the timed-out previous episode must
            # not count toward (or release) the new barrier
            orchestrator.mgt.on_message(
                "a2",
                orc.RepairReadyMessage(
                    agent="a2", computations=["y"], round=rnd
                ),
                0.0,
            )
            orchestrator.mgt.on_message(
                "a2",
                orc.RepairDoneMessage(
                    agent="a2", selected=["y"], round=rnd
                ),
                0.0,
            )
            assert orchestrator.mgt.repair_ready_agents == {}
            assert orchestrator.mgt.repair_selected == {}
            assert not orchestrator.mgt.all_repair_ready.is_set()
        finally:
            orchestrator.stop_agents()
            orchestrator.stop()

    def test_computation_finished_reaches_orchestrator(self):
        dcop = coloring_dcop()
        orchestrator = _run_thread(dcop, "dsa", n_cycles=5)
        try:
            orchestrator.deploy_computations()
            assert orchestrator.mgt.ready_to_run.wait(5)
            agent = next(
                a for a in orchestrator._local_agents.values()
                if a.deployed
            )
            comp = agent.computation(agent.deployed[0])
            comp.finished()
            deadline = time.time() + 5
            while (
                time.time() < deadline
                and comp.name
                not in orchestrator.mgt._finished_computations
            ):
                time.sleep(0.02)
            assert (
                comp.name in orchestrator.mgt._finished_computations
            )
        finally:
            orchestrator.stop_agents()
            orchestrator.stop()

    def test_deployment_readback_updates_hosted_computations(self):
        dcop = coloring_dcop()
        orchestrator = _run_thread(dcop, "dpop", n_cycles=1)
        try:
            orchestrator.deploy_computations()
            # deployment confirmations are asynchronous: the ready_to_run
            # barrier is pyDCOP's "all deployed" condition
            assert orchestrator.mgt.ready_to_run.wait(5)
            deployed = {
                c for comps in orchestrator.mgt.deployed.values()
                for c in comps
            }
            assert deployed == {"x", "y", "z"}
            orchestrator.run(timeout=30)
        finally:
            orchestrator.stop_agents()
            orchestrator.stop()


def _hosted_by(o, agent):
    return set(o.distribution.computations_hosted(agent))


def _replicates(o, agent):
    # once deployed, the agents a replication round would name, then the
    # local placement
    assert o.mgt.ready_to_run.wait(10)
    a = o._local_agents[agent]
    a.known_agents = dict(o.mgt.agent_addresses)
    hosts = a.replicate(1)
    return (set(hosts) == _hosted_by(o, agent)
            and all(len(h) == 1 and agent not in h for h in hosts.values()))


def _repaired(o, agent, metrics):
    return (set(metrics["migrated"]) == set(metrics["orphans"])
            and agent not in o.distribution.agents)


class TestReplicationAndRepairCalls:
    """Scenarios, replication, agent kills and repair, each called once
    on a deployed thread-mode run: the call does its work on the CPU and
    leaves the run able to go on."""

    @pytest.mark.parametrize("call", [
        lambda o: set(o.start_replication(1)) == {"x", "y", "z"},
        lambda o: o.set_agent_capacity("a0", 10) is None,
        lambda o: (o.kill_agent("a0"),
                   "a0" not in o.mgt.registered_agents
                   and not _hosted_by(o, "a0"))[1],
        lambda o: _repaired(o, "a0", o.mgt.repair_orphans("a0")),
        lambda o: (o.run(scenario=Scenario([]), timeout=30),
                   o.status == "FINISHED")[1],
        lambda o: _replicates(o, "a0"),
    ], ids=["start_replication", "set_agent_capacity", "kill_agent",
            "repair_orphans", "run_scenario", "replicate"])
    def test_call_does_its_work(self, call):
        orchestrator = _run_thread(coloring_dcop(), "dsa", n_cycles=5)
        try:
            orchestrator.deploy_computations()
            assert call(orchestrator) is True
            assert orchestrator.status in ("STARTED", "FINISHED")
        finally:
            orchestrator.stop_agents()
            orchestrator.stop()


def test_a_repair_is_a_second_solve(monkeypatch):
    # the engine keeps few replays queued while a repair runs beside the
    # main solve (base.REPLAYS_IN_FLIGHT): the repair, its handshake
    # included, marks itself for the whole process, and only while it runs
    from pydcop_tpu_torch import reparation
    from pydcop_tpu_torch.utils.solve_control import (
        second_solve,
        second_solve_live,
    )

    assert not second_solve_live()
    with second_solve():
        with second_solve():
            assert second_solve_live()
        assert second_solve_live()
    assert not second_solve_live()

    seen = []
    real = reparation.repair_distribution

    def spy(*args, **kwargs):
        seen.append(second_solve_live())
        return real(*args, **kwargs)

    spy.repicked = real.repicked
    monkeypatch.setattr(reparation, "repair_distribution", spy)
    orchestrator = _run_thread(coloring_dcop(), "dsa", n_cycles=5)
    try:
        orchestrator.deploy_computations()
        metrics = orchestrator.mgt.repair_orphans("a0")
        assert _repaired(orchestrator, "a0", metrics)
    finally:
        orchestrator.stop_agents()
        orchestrator.stop()
    assert seen == [True]
    assert not second_solve_live()


class TestNotPortedYet:
    """Message rules are not ported yet: a fault schedule with one is
    refused with ``NotImplementedError`` naming the queue item, before
    anything starts."""

    def test_agent_kill_schedule_refused_before_start(self):
        from pydcop_tpu_torch.chaos import ChaosController, FaultSchedule
        from pydcop_tpu_torch.chaos.schedule import KillEvent, MessageRule

        # agent kills run now; a schedule with a message rule is refused
        chaos = ChaosController(FaultSchedule(
            seed=1, events=[KillEvent(agent="a0", at=0.1)]))
        orchestrator = run_local_thread_dcop(
            "dsa", coloring_dcop(), "oneagent", device="cpu", chaos=chaos)
        try:
            assert orchestrator.chaos is chaos
        finally:
            orchestrator.stop_agents()
            orchestrator.stop()
        chaos = ChaosController(FaultSchedule(
            seed=1, events=[KillEvent(agent="a0", at=0.1),
                            MessageRule(action="drop", p=0.5)]))
        with pytest.raises(NotImplementedError, match="message rules"):
            run_local_thread_dcop("dsa", coloring_dcop(), "oneagent",
                                  device="cpu", chaos=chaos)

    def test_watch_status_has_no_replication_block(self):
        orchestrator = _run_thread(coloring_dcop(), "dsa", n_cycles=5)
        try:
            orchestrator.deploy_computations()
            orchestrator.run(timeout=30)
            status = orchestrator.watch_status()
            assert status["status"] == "FINISHED"
            assert "replication" not in status
            assert status["registered_agents"] == 3
        finally:
            orchestrator.stop_agents()
            orchestrator.stop()


def test_cuda_without_a_card_is_refused(monkeypatch):
    # the runtime's entry points default to the card and never fall back
    # to the CPU: without one they raise before any agent starts
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_local_thread_dcop("dsa", coloring_dcop(), "oneagent")


class TestControlPlaneScale:
    """The orchestrator's readback/registration cost at 10k variables:
    the control plane stays a small constant over the device solve."""

    def test_cycle_metrics_run_at_10k_vars(self):
        from pydcop_tpu_torch.commands.generators.graphcoloring import (
            generate_graph_coloring,
        )

        dcop = generate_graph_coloring(10_000, 3, graph="grid", seed=1)
        dcop._agents_def.clear()
        dcop.add_agents([AgentDef(f"a{i}", capacity=10**9) for i in range(8)])
        orchestrator = _run_thread(
            dcop, "dsa", "adhoc", n_cycles=5, seed=1,
            collect_moment="cycle_change",
        )
        try:
            orchestrator.deploy_computations()
            t0 = time.perf_counter()
            # registration of 10k computations: one mgt round-trip each
            assert orchestrator.mgt.ready_to_run.wait(120)
            registration = time.perf_counter() - t0
            t0 = time.perf_counter()
            orchestrator.run(timeout=240)
            run_wall = time.perf_counter() - t0
            assert orchestrator.status == "FINISHED"
            metrics = orchestrator.end_metrics()
            assert metrics["cycle"] == 5
            assert len(metrics["assignment"]) == 10_000
            # control-plane budget: registration and the solve+readback
            # (including 10k per-computation value readbacks) stay bounded
            assert registration < 90, registration
            assert run_wall < 120, run_wall
        finally:
            orchestrator.stop_agents()
            orchestrator.stop()


# ---------------------------------------------------------------------------
# the websocket UI
# ---------------------------------------------------------------------------


def _free_ports(n):
    """A base port with ``n`` consecutive ports free on 127.0.0.1."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        held = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                held.append(s)
                s.bind(("127.0.0.1", p))
        except OSError:
            continue
        finally:
            for s in held:
                s.close()
        return base
    raise RuntimeError("no run of free ports")


class TestUiServer:
    def _ws_connect(self, port):
        import base64

        conn = socket.create_connection(("127.0.0.1", port), timeout=3)
        key = base64.b64encode(b"0123456789abcdef").decode()
        conn.sendall(
            (
                f"GET / HTTP/1.1\r\nHost: localhost:{port}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += conn.recv(1024)
        assert b"101" in resp.split(b"\r\n")[0]
        return conn

    def _ws_send_text(self, conn, text):
        import struct

        data = text.encode()
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        header = b"\x81" + struct.pack("!B", 0x80 | len(data)) + mask
        conn.sendall(header + masked)

    def _ws_read_text(self, conn):
        import struct

        head = conn.recv(2)
        n = head[1] & 0x7F
        if n == 126:
            n = struct.unpack("!H", conn.recv(2))[0]
        data = b""
        while len(data) < n:
            data += conn.recv(n - len(data))
        return data.decode()

    def _ws_reply(self, conn, cmd):
        """The reply to ``cmd``: the bus is process-wide, so events that
        other threads of the process publish may be pushed before it."""
        conn.settimeout(10)
        while True:
            frame = json.loads(self._ws_read_text(conn))
            if frame.get("cmd") == cmd:
                return frame
            assert "topic" in frame, frame

    def test_ui_query_and_event_stream(self):
        port = _free_ports(1)
        agent = Agent(
            "ui_agent", InProcessCommunicationLayer(), ui_port=port
        )
        e = Echo("ui_echo")
        agent.add_computation(e, publish=False)
        agent.start()
        try:
            conn = self._ws_connect(port)
            self._ws_send_text(conn, json.dumps({"cmd": "agent"}))
            reply = self._ws_reply(conn, "agent")
            assert reply["agent"] == "ui_agent"
            assert "ui_echo" in reply["computations"]
            self._ws_send_text(conn, json.dumps({"cmd": "computations"}))
            reply = self._ws_reply(conn, "computations")
            names = {c["name"] for c in reply["computations"]}
            assert "ui_echo" in names
            conn.close()
        finally:
            agent.clean_shutdown()
            agent.join()
            event_bus.enabled = False
            event_bus.reset()

    def test_event_stream_during_solve(self):
        # a ws client stays connected through a full thread-mode solve
        # and receives the pushed cycle/value events alongside answered
        # state queries
        port = _free_ports(3)
        orchestrator = run_local_thread_dcop(
            "dsa", coloring_dcop(3), distribution="oneagent",
            n_cycles=10, ui_port=port, delay=0.02, device="cpu",
        )
        try:
            conn = self._ws_connect(port)
            conn.settimeout(10)
            # state query answered while the runtime is live
            self._ws_send_text(conn, json.dumps({"cmd": "agent"}))
            streamed = []
            reply = None
            orchestrator.deploy_computations()
            orchestrator.run(timeout=30)
            # drain frames until the solve's event stream and the query's
            # reply have both shown up: they interleave arbitrarily, and
            # on a loaded host three events can come before the reply
            try:
                while len(streamed) < 3 or reply is None:
                    frame = json.loads(self._ws_read_text(conn))
                    if "topic" in frame:
                        streamed.append(frame)
                    else:
                        reply = frame
            except (TimeoutError, socket.timeout):
                pass
            assert reply is not None and "computations" in reply
            topics = {f["topic"] for f in streamed}
            assert any(t.startswith("computations.") for t in topics), (
                streamed
            )
            conn.close()
        finally:
            orchestrator.stop_agents(5)
            orchestrator.stop()
            event_bus.enabled = False
            event_bus.reset()


class TestUiServerUnit:
    """The UiServer websocket plumbing: the RFC-6455 handshake key
    derivation, text-frame encode/decode round-trips across all three
    length encodings, and bus-event fanout to a connected client."""

    def test_ws_accept_key_matches_rfc6455_sample(self):
        from pydcop_tpu_torch.infrastructure.ui import _ws_accept_key

        # the worked example from RFC 6455 §1.3
        assert (
            _ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==")
            == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
        )

    def test_frame_encode_decode_roundtrip_all_length_ranges(self):
        from pydcop_tpu_torch.infrastructure.ui import (
            _ws_encode_text,
            _ws_read_frame,
        )

        class FakeConn:
            """recv()-compatible view over an in-memory byte buffer."""

            def __init__(self, data):
                self._data = data

            def recv(self, n):
                chunk, self._data = self._data[:n], self._data[n:]
                return chunk

        # 7-bit, 16-bit and 64-bit payload length encodings
        for n in (1, 125, 126, 4000, 70_000):
            text = "x" * n
            frame = _ws_encode_text(text)
            assert _ws_read_frame(FakeConn(frame)) == text
        # unicode survives the round trip
        frame = _ws_encode_text("héllo ✓")
        assert _ws_read_frame(FakeConn(frame)) == "héllo ✓"
        # a close frame (opcode 0x8) reads as None
        close = b"\x88\x00"
        assert _ws_read_frame(FakeConn(close)) is None

    def test_stop_ends_the_accept_thread(self):
        # closing the listening socket alone leaves accept() blocked on
        # Linux: the thread, and through it the agent and everything it
        # hosted, would live until the process exits
        agent = Agent("ui_stop", InProcessCommunicationLayer(),
                      ui_port=_free_ports(1))
        agent.start()
        ui = agent.computation("_ui_ui_stop")
        try:
            assert ui._accept_thread.is_alive()
        finally:
            agent.clean_shutdown()
            agent.join()
            event_bus.enabled = False
            event_bus.reset()
        ui._accept_thread.join(5)
        assert not ui._accept_thread.is_alive()

    def test_frames_are_the_jax_package_s(self):
        # the same text, the same bytes on the wire (exact)
        pytest.importorskip("jax")
        from pydcop_tpu.infrastructure import ui as jax_ui
        from pydcop_tpu_torch.infrastructure import ui

        for n in (0, 125, 126, 70_000):
            assert ui._ws_encode_text("é" * n) == jax_ui._ws_encode_text(
                "é" * n)
        assert ui._ws_accept_key("k") == jax_ui._ws_accept_key("k")

    def test_bus_event_fanout_to_connected_client(self):
        helper = TestUiServer()
        port = _free_ports(1)
        agent = Agent(
            "ui_unit", InProcessCommunicationLayer(), ui_port=port
        )
        agent.start()
        try:
            conn = helper._ws_connect(port)
            conn.settimeout(5)
            # wait until the server registered this client (the
            # handshake reply arrives before the accept-loop thread has
            # necessarily appended it to _clients)
            ui = agent.computation("_ui_ui_unit")
            deadline = time.perf_counter() + 5
            while not ui._clients and time.perf_counter() < deadline:
                time.sleep(0.01)
            assert ui._clients, "client never registered with UiServer"
            event_bus.send("computations.cycle.demo", {"cycle": 3})
            # other threads' events may come first: the bus is process-wide
            frame = json.loads(helper._ws_read_text(conn))
            while frame["topic"] != "computations.cycle.demo":
                frame = json.loads(helper._ws_read_text(conn))
            assert frame["topic"] == "computations.cycle.demo"
            assert "3" in frame["event"]
            conn.close()
        finally:
            agent.clean_shutdown()
            agent.join()
            event_bus.enabled = False
            event_bus.reset()


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


def _mgt_samples(pkg):
    """One instance of every management message type of ``pkg``."""
    orc = importlib.import_module(f"{pkg}.infrastructure.orchestrator")
    dsc = importlib.import_module(f"{pkg}.infrastructure.discovery")
    comps = importlib.import_module(f"{pkg}.infrastructure.computations")
    return [
        orc.DeployMessage(comp_def={"name": "x", "algo": "dsa"}),
        orc.RunAgentMessage(computations=["x", "y"]),
        orc.PauseMessage(computations=None),
        orc.ResumeMessage(computations=["x"]),
        orc.StopAgentMessage(forced=False),
        orc.AgentRemovedMessage(reason="scenario"),
        orc.RegisterAgentMessage(agent="a1", address=["h", 1]),
        orc.DeployedMessage(agent="a1", computations=["x"]),
        orc.ValueChangeMessage(computation="x", value=2, cost=1.5, cycle=3),
        orc.CycleChangeMessage(cycle=4, cost=10.0),
        orc.MetricsMessage(agent="a1", metrics={"count": {"x": 1}}),
        orc.ComputationFinishedMessage(computation="x"),
        orc.AgentStoppedMessage(agent="a1", metrics={"t": 0.5}),
        orc.ReplicateComputationsMessage(
            k=2, agents=["a1", "a2"], mode="distributed", agent_defs=None,
            round=1,
        ),
        orc.ComputationReplicatedMessage(
            agent="a1", replica_hosts={"x": ["a2", "a3"]}, round=1
        ),
        orc.SetupRepairMessage(repair_info={"orphans": ["x"], "round": 1}),
        orc.RepairReadyMessage(agent="a1", computations=["x"], round=1),
        orc.RepairRunMessage(),
        orc.RepairDoneMessage(agent="a1", selected=["x"], round=1),
        orc.MetricsRequestMessage(),
        dsc.PublishAgentMessage(agent="a1", address="tcp://h:1"),
        dsc.UnpublishAgentMessage(agent="a1"),
        dsc.PublishComputationMessage(
            computation="x", agent="a1", address="tcp://h:1"
        ),
        dsc.UnpublishComputationMessage(computation="x"),
        dsc.PublishReplicaMessage(replica="x", agent="a2"),
        dsc.UnpublishReplicaMessage(replica="x", agent="a2"),
        dsc.SubscribeMessage(kind="agent", name=None, subscribe=True),
        comps.SynchronizationMsg(cycle_id=7),
        comps.Message("value_readback_fwd", ["x", 2, 1.5]),
    ]


def _normalized(obj, pkg):
    """``obj`` with ``pkg``'s module prefix renamed to ``PKG``."""
    if isinstance(obj, dict):
        return {k: _normalized(v, pkg) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_normalized(v, pkg) for v in obj]
    if isinstance(obj, str) and obj.startswith(pkg + "."):
        return "PKG" + obj[len(pkg):]
    return obj


def test_management_messages_simple_repr_like_jax():
    # every management message of the taxonomy, both packages: the same
    # simple_repr but for the package's name in the module key (exact),
    # and the same type names as the JAX package declares
    pytest.importorskip("jax")
    from pydcop_tpu.utils.simple_repr import simple_repr as jax_repr

    port = [_normalized(simple_repr(m), "pydcop_tpu_torch")
            for m in _mgt_samples("pydcop_tpu_torch")]
    ref = [_normalized(jax_repr(m), "pydcop_tpu")
           for m in _mgt_samples("pydcop_tpu")]
    assert port == ref
    assert all(r["__module__"].startswith("PKG.") for r in port)


def _seeded_problem(pkg, n=12, seed=5):
    gen = importlib.import_module(f"{pkg}.commands.generators.graphcoloring")
    objs = importlib.import_module(f"{pkg}.dcop.objects")
    dcop = gen.generate_graph_coloring(
        n, 3, graph="random", p_edge=0.3, soft=True, seed=seed
    )
    dcop._agents_def.clear()
    dcop.add_agents(
        [objs.AgentDef(f"a{i}", capacity=10**6) for i in range(4)]
    )
    return dcop


def _thread_run(pkg, algo, params, moment, n_cycles=30):
    """A thread-mode run of ``pkg`` on the seeded problem: end_metrics()
    without its clock, the distribution, and the collector's rows
    (waited for: the value_change rows come from the agents)."""
    run_mod = importlib.import_module(f"{pkg}.infrastructure.run")
    algos = importlib.import_module(f"{pkg}.algorithms")
    dcop = _seeded_problem(pkg)
    algo_def = algos.AlgorithmDef.build_with_default_param(
        algo, params, mode=dcop.objective
    )
    rows = []
    kw = {"device": "cpu"} if pkg == "pydcop_tpu_torch" else {}
    orchestrator = run_mod.run_local_thread_dcop(
        algo_def, dcop, "adhoc", n_cycles=n_cycles, seed=3,
        collector=rows.append, collect_moment=moment, **kw,
    )
    try:
        orchestrator.deploy_computations()
        orchestrator.run(timeout=120)
        metrics = orchestrator.end_metrics()
        deadline = time.time() + 10
        while time.time() < deadline and sum(
            r["event"] == "value_change" for r in rows
        ) < len(metrics["assignment"]):
            time.sleep(0.02)
        dist = {a: sorted(orchestrator.distribution.computations_hosted(a))
                for a in orchestrator.distribution.agents}
    finally:
        orchestrator.stop_agents()
        orchestrator.stop()
    metrics.pop("time")
    rows = [{k: v for k, v in r.items() if k != "time"} for r in rows]
    return metrics, dist, rows


RUNTIME_CASES = [
    ("maxsum", {"layout": "ell", "damping": 0.7}),
    ("dsa", {}),
    ("dpop", {}),
]


@pytest.mark.parametrize("algo, params", RUNTIME_CASES)
def test_thread_end_metrics_like_jax(algo, params):
    # thread mode, seeded problem, adhoc distribution: end_metrics()
    # field by field the JAX package's, its clock excepted: status,
    # assignment, cost, violation, cycle, message counts and the cost
    # curve (exact: both run the same solve; MaxSum's float32 planes are
    # damped as XLA's FMA, so its cost is bit-equal too), and the same
    # placement of the computations on the agents
    pytest.importorskip("jax")
    port = _thread_run("pydcop_tpu_torch", algo, params, "value_change")
    ref = _thread_run("pydcop_tpu", algo, params, "value_change")
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[0]["status"] == "FINISHED"


@pytest.mark.parametrize("moment", ["value_change", "cycle_change"])
def test_collector_rows_like_jax(moment):
    # the collector's rows, time excepted: the cycle_change rows in cycle
    # order, the value_change rows (one a variable, posted by whichever
    # agent hosts it) as a set (exact)
    pytest.importorskip("jax")
    port = _thread_run("pydcop_tpu_torch", "dsa", {}, moment)[2]
    ref = _thread_run("pydcop_tpu", "dsa", {}, moment)[2]

    def split(rows):
        cycles = [r for r in rows if r["event"] == "cycle_change"]
        values = sorted((r for r in rows if r["event"] == "value_change"),
                        key=lambda r: r["computation"])
        return cycles, values

    assert split(port) == split(ref)
    cycles, values = split(port)
    assert len(values) == 12
    assert len(cycles) == (30 if moment == "cycle_change" else 0)


# ---------------------------------------------------------------------------
# the orchestrator and agent verbs over HTTP
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_listening(port, proc, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline and proc.poll() is None:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"nothing listens on port {port}")


def _verbs_run(pkg, problem, algo_args, tmp_path, importtime=False):
    """The ``orchestrator`` verb with two ``agent`` verb processes (the
    problem's agents a00000..a00009, five in each): the orchestrator's
    JSON and the agents' stderr (written to files: a pipe that fills
    would stall an agent mid-solve)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    device = ["--device", "cpu"] if pkg == "pydcop_tpu_torch" else []
    orch_port = _free_port()
    orch = subprocess.Popen(
        [sys.executable, "-m", pkg, *device, "orchestrator", *algo_args,
         "--port", str(orch_port), "--address", "127.0.0.1",
         "--register_timeout", "120", problem],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    # the agents register once, at start: the orchestrator must listen
    _wait_listening(orch_port, orch)
    x = ["-X", "importtime"] if importtime else []
    agents = []
    names = [f"a{i:05d}" for i in range(10)]
    logs = [tmp_path / f"{pkg}.agents{i}.err" for i in range(2)]
    for names, log in zip((names[:5], names[5:]), logs):
        extra = ["--address", "127.0.0.1"] if pkg == "pydcop_tpu_torch" \
            else []
        with open(log, "w") as err:
            agents.append(subprocess.Popen(
                [sys.executable, *x, "-m", pkg, "agent", "-n", *names,
                 "-p", str(_free_port()), *extra, "--orchestrator",
                 f"127.0.0.1:{orch_port}"],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err,
            ))
    try:
        out, err = orch.communicate(timeout=240)
        assert orch.returncode == 0, err[-3000:]
        for a in agents:
            a.wait(60)
        errs = [log.read_text() for log in logs]
        assert [a.returncode for a in agents] == [0, 0], errs
        return json.loads(out), errs
    finally:
        for p in [orch, *agents]:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_orchestrator_and_agent_verbs_like_jax(tmp_path):
    # the standalone orchestrator (which solves) and two agent-verb
    # processes (which only keep the books) over HTTP: the JAX verbs'
    # JSON, its clock excepted (exact: the same MaxSum solve); and no
    # agent process imported torch, its deploys and read-backs included
    pytest.importorskip("jax")
    problem = str(ROOT / "tests" / "instances" / "graph_coloring.yaml")
    algo_args = ["-a", "maxsum", "-p", "damping:0.7", "-p", "layout:ell",
                 "-n", "30", "-d", "adhoc"]
    port, errs = _verbs_run("pydcop_tpu_torch", problem, algo_args,
                            tmp_path, importtime=True)
    ref, _ = _verbs_run("pydcop_tpu", problem, algo_args, tmp_path)
    port.pop("time")
    ref.pop("time")
    assert port == ref
    assert port["status"] == "FINISHED" and len(port["assignment"]) == 10
    for err in errs:
        imported = {line.rsplit("|", 1)[-1].strip()
                    for line in err.splitlines()
                    if line.startswith("import time:")}
        assert "pydcop_tpu_torch.infrastructure.orchestratedagents" in (
            imported)
        assert "torch" not in imported and "jax" not in imported


def test_orchestrator_verb_refuses_what_is_not_ported(capsys):
    from pydcop_tpu_torch import dcop_cli

    # -s and -k run now (the thread-mode scenario and replication cases
    # are in tests/test_torch_run_cli.py); a distribution method the port
    # does not have yet is refused before the orchestrator starts
    problem = str(ROOT / "tests" / "instances" / "graph_coloring.yaml")
    for option in (["-d", "gh_cgdp"], ["-d", "ilp_fgdp", "-k", "2"]):
        rc = dcop_cli.main(["--device", "cpu", "orchestrator", "-a", "dsa",
                            *option, problem])
        assert rc == 2
        err = capsys.readouterr().err
        assert "not ported yet" in err and "Queue 1, item 2" in err


def test_failed_capture_leaves_no_runner_in_the_cache():
    # the orchestrator retries a failed device solve on the card; a
    # capture that raised (another thread's CUDA call invalidates a
    # global-mode capture) must leave nothing cached for the retry to
    # replay: the runner cache stores a build only once it returned
    from pydcop_tpu_torch.algorithms import base

    class Home:
        pass

    home = Home()

    def broken():
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        base.cached_runner(home, ("k",), "solve.run_cycles", broken)
    assert ("k",) not in home.__dict__.get("_device_consts", {})
    built = base.cached_runner(home, ("k",), "solve.run_cycles",
                               lambda: "runner")
    assert built == "runner"
    assert base.cached_runner(home, ("k",), "solve.run_cycles",
                              broken) == "runner"


def test_device_solve_retries_only_on_the_card(monkeypatch):
    # one retry on the card after a failure, none on the CPU (its
    # failures are deterministic), none after a sticky CUDA error
    from pydcop_tpu_torch import api
    from pydcop_tpu_torch.infrastructure import orchestrator as orc

    calls = []

    def failing(*args, **kwargs):
        calls.append(kwargs["device"])
        raise RuntimeError("device lost")

    monkeypatch.setattr(api, "solve_result", failing)
    for device, sticky, want in (("cpu", False, 1), ("cuda", False, 2),
                                 ("cuda", True, 1)):
        calls.clear()
        monkeypatch.setattr(orc, "_sticky_cuda_error", lambda d: sticky)
        o = _run_thread(coloring_dcop(), "dsa", n_cycles=5)
        try:
            o.device = device
            o.deploy_computations()
            o.run(timeout=30)
            assert o.status == "ERROR"
            assert calls == [device] * want
        finally:
            o.stop_agents()
            o.stop()
