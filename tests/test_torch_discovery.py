"""The port's discovery (``pydcop_tpu_torch/infrastructure/discovery.py``),
case for case the JAX package's ``tests/test_discovery_deep.py``: local
cache semantics, directory publication, subscription callbacks with
state sync, replica visibility, one-shot subscriptions and the
unsubscribe post discipline, over real agent threads with an in-process
directory host, like the runtime does.  Host only: no torch, no jax;
``test_directory_traffic_is_the_jax_package_s`` holds the directory's
messages to the JAX package's, in order and field for field."""

import time

import pytest

from pydcop_tpu_torch.infrastructure.agents import Agent
from pydcop_tpu_torch.infrastructure.communication import (
    InProcessCommunicationLayer,
)
from pydcop_tpu_torch.infrastructure.discovery import (
    DIRECTORY_COMP_NAME,
    Directory,
    DirectoryComputation,
    Discovery,
    UnknownAgent,
    UnknownComputation,
)


def _wait(predicate, timeout=3.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


class TestLocalCache:
    """Synchronous Discovery cache behavior — no directory involved."""

    def test_register_agent_without_publish(self):
        d = Discovery("a1", "addr1")
        d.register_agent("a2", "addr2", publish=False)
        assert d.agent_address("a2") == "addr2"

    def test_unregister_agent_drops_its_computations(self):
        d = Discovery("a1", "addr1")
        d.register_agent("a2", "addr2", publish=False)
        d.register_computation("c2", agent="a2", publish=False)
        d.unregister_agent("a2", publish=False)
        assert "a2" not in d.agents()
        with pytest.raises(UnknownComputation):
            d.computation_agent("c2")

    def test_unknown_agent_raises(self):
        d = Discovery("a1", "addr1")
        with pytest.raises(UnknownAgent):
            d.agent_address("nope")

    def test_register_computation_defaults_to_own_agent(self):
        d = Discovery("a1", "addr1")
        d.register_computation("c1", publish=False)
        assert d.computation_agent("c1") == "a1"
        # the agent's own address was cached alongside
        assert d.agent_address("a1") == "addr1"

    def test_agent_computations_filter(self):
        d = Discovery("a1", "addr1")
        d.register_computation("c1", publish=False)
        d.register_computation("c2", publish=False)
        d.register_computation("c3", agent="a9", address="x", publish=False)
        assert sorted(d.agent_computations("a1")) == ["c1", "c2"]
        assert d.agent_computations("a9") == ["c3"]


class _Net:
    """A directory host plus n client agents with wired routes."""

    def __init__(self, n_clients=2):
        self.host = Agent("host", InProcessCommunicationLayer())
        self.directory = Directory()
        self.dir_comp = DirectoryComputation(self.directory)
        self.host.add_computation(self.dir_comp, publish=False)
        self.clients = []
        for i in range(n_clients):
            a = Agent(f"a{i}", InProcessCommunicationLayer())
            a.messaging.register_route(
                DIRECTORY_COMP_NAME, "host", self.host.communication.address
            )
            self.host.messaging.register_route(
                f"_discovery_a{i}", f"a{i}", a.communication.address
            )
            self.clients.append(a)
        self.host.start()
        self.dir_comp.start()
        for a in self.clients:
            a.start()
            a.discovery.discovery_computation.start()

    def stop(self):
        for a in self.clients:
            a.clean_shutdown()
            a.join()
        self.host.clean_shutdown()
        self.host.join()


@pytest.fixture()
def net():
    n = _Net()
    yield n
    n.stop()


class TestDirectoryPublication:
    def test_publish_agent_reaches_directory(self, net):
        net.clients[0].discovery.register_agent("a0", "addr0")
        assert _wait(lambda: "a0" in net.directory.agents)

    def test_unpublish_agent(self, net):
        d = net.clients[0].discovery
        d.register_agent("a0", "addr0")
        assert _wait(lambda: "a0" in net.directory.agents)
        d.unregister_agent("a0")
        assert _wait(lambda: "a0" not in net.directory.agents)

    def test_publish_computation_records_host(self, net):
        net.clients[0].discovery.register_computation(
            "comp_x", agent="a0", address="addr0"
        )
        assert _wait(
            lambda: net.directory.computations.get("comp_x") == "a0"
        )


class TestSubscriptions:
    def test_subscribe_gets_current_state_then_updates(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        d0.register_agent("a0", "addr0")
        assert _wait(lambda: "a0" in net.directory.agents)
        events = []
        d1.subscribe_all_agents(
            lambda evt, name, val: events.append((evt, name))
        )
        # state sync: the already-registered agent arrives on subscribe
        assert _wait(lambda: "a0" in d1.agents())
        # live update: a later registration is pushed too
        d0.register_agent("a0b", "addr0b")
        assert _wait(lambda: "a0b" in d1.agents())
        assert ("agent_added", "a0b") in events

    def test_agent_removal_notifies_subscribers(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        events = []
        d1.subscribe_all_agents(
            lambda evt, name, val: events.append((evt, name))
        )
        d0.register_agent("gone", "addr")
        assert _wait(lambda: "gone" in d1.agents())
        d0.unregister_agent("gone")
        assert _wait(lambda: ("agent_removed", "gone") in events)
        assert "gone" not in d1.agents()

    def test_subscribe_computation_add_and_remove(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        events = []
        d1.subscribe_computation(
            "comp_y", lambda evt, name, val: events.append((evt, name, val))
        )
        d0.register_computation("comp_y", agent="a0", address="addr0")
        assert _wait(
            lambda: ("computation_added", "comp_y", "a0") in events
        )
        assert d1.computation_agent("comp_y") == "a0"
        d0.unregister_computation("comp_y")
        assert _wait(
            lambda: ("computation_removed", "comp_y", None) in events
        )
        with pytest.raises(UnknownComputation):
            d1.computation_agent("comp_y")

    def test_unsubscribed_computation_not_pushed(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        d0.register_computation("quiet", agent="a0", address="addr0")
        assert _wait(
            lambda: "quiet" in net.directory.computations
        )
        time.sleep(0.1)  # give any (wrong) push time to land
        with pytest.raises(UnknownComputation):
            d1.computation_agent("quiet")


class TestReplicas:
    def test_replica_visible_only_to_subscribers(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        events = []
        d1.subscribe_replica(
            "comp_r", lambda evt, name, val: events.append((evt, name, val))
        )
        d0.register_replica("comp_r", agent="a0")
        assert _wait(
            lambda: ("replica_added", "comp_r", "a0") in events
        )
        assert d1.replica_agents("comp_r") == {"a0"}
        # d0 itself keeps its local view
        assert d0.replica_agents("comp_r") == {"a0"}

    def test_replica_removal_is_pushed(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        events = []
        d1.subscribe_replica(
            "comp_s", lambda evt, name, val: events.append((evt, name, val))
        )
        d0.register_replica("comp_s", agent="a0")
        assert _wait(lambda: d1.replica_agents("comp_s") == {"a0"})
        d0.unregister_replica("comp_s", agent="a0")
        assert _wait(
            lambda: ("replica_removed", "comp_s", "a0") in events
        )
        assert d1.replica_agents("comp_s") == set()


class TestOneShotAndUnsubscribe:
    """Reference parity (discovery.py one-shot subscriptions +
    unsubscribe, tests test_subscribe_agent_cb_one_shot /
    test_unsubscribe_*): a one-shot callback fires for exactly one event
    then auto-removes; unsubscribing the last callback tells the
    directory to stop pushing."""

    def test_one_shot_agent_callback_fires_once_then_tears_down(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        events = []
        d1.subscribe_all_agents(
            lambda evt, name, val: events.append(name), one_shot=True
        )
        assert _wait(
            lambda: "a1" in net.directory.subscribers("agent", None)
        )
        d0.register_agent("a0", "addr0")
        assert _wait(lambda: len(events) == 1)
        # the fired one-shot was the only local interest: the directory
        # subscription is torn down like an explicit unsubscribe
        assert _wait(
            lambda: "a1" not in net.directory.subscribers("agent", None)
        )
        d0.register_agent("a0b", "addr0b")
        assert _wait(lambda: "a0b" in net.directory.agents)
        assert events == [events[0]]  # the callback never re-fired

    def test_persistent_callback_keeps_firing(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        events = []
        d1.subscribe_all_agents(
            lambda evt, name, val: events.append(name)
        )
        d0.register_agent("a0", "addr0")
        d0.register_agent("a0b", "addr0b")
        assert _wait(lambda: len(events) >= 2)

    def test_unsubscribe_specific_callback(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        kept, dropped = [], []

        def cb_kept(evt, name, val):
            kept.append(name)

        def cb_dropped(evt, name, val):
            dropped.append(name)

        d1.subscribe_all_agents(cb_kept)
        d1.subscribe_all_agents(cb_dropped)
        d1.unsubscribe_all_agents(cb_dropped)
        d0.register_agent("a0", "addr0")
        assert _wait(lambda: kept)
        assert dropped == []

    def test_unsubscribe_computation_stops_directory_pushes(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        events = []
        d1.subscribe_computation(
            "comp_x", lambda evt, name, val: events.append(evt)
        )
        d1.unsubscribe_computation("comp_x")
        # the directory-side subscription table must be empty again
        assert _wait(
            lambda: "a1" not in net.directory.subscribers(
                "computation", "comp_x"
            )
        )
        d0.register_computation("comp_x", agent="a0", address="addr0")
        assert _wait(
            lambda: net.directory.computations.get("comp_x") == "a0"
        )
        assert events == []

    def test_one_shot_replica_callback(self, net):
        d0, d1 = net.clients[0].discovery, net.clients[1].discovery
        events = []
        d1.subscribe_replica(
            "rep_c", lambda evt, name, val: events.append(evt),
            one_shot=True,
        )
        assert _wait(
            lambda: "a1" in net.directory.subscribers("replica", "rep_c")
        )
        d0.register_replica("rep_c", "a0")
        assert _wait(lambda: events == ["replica_added"])
        # the fired one-shot was the only local interest: the directory
        # stops pushing replica events to a1 (teardown, not just removal)
        assert _wait(
            lambda: "a1" not in net.directory.subscribers(
                "replica", "rep_c"
            )
        )
        d0.unregister_replica("rep_c", "a0")
        assert _wait(lambda: "a0" not in net.directory.replicas["rep_c"])
        assert events == ["replica_added"]  # one-shot: no removal event


class TestUnsubscribePostDiscipline:
    """The directory subscribe/unsubscribe posts must be serialized with
    the local record mutation, and an unsubscribe with no subscription
    must not reach the directory at all (the lock-gap fix)."""

    @staticmethod
    def _recording_discovery():
        d = Discovery("a1", "addr1")
        posts = []
        d.discovery_computation.post_msg = (
            lambda target, msg, prio=None: posts.append((target, msg))
        )
        return d, posts

    def test_unsubscribe_without_subscription_posts_nothing(self):
        d, posts = self._recording_discovery()
        d.unsubscribe_all_agents()
        d.unsubscribe_computation("never_subscribed")
        d.unsubscribe_replica("never_subscribed")
        assert posts == []

    def test_unsubscribe_after_subscribe_posts_once(self):
        d, posts = self._recording_discovery()
        d.subscribe_computation("comp_x")
        d.unsubscribe_computation("comp_x")
        kinds = [(m.kind, m.subscribe) for _, m in posts]
        assert kinds == [("computation", True), ("computation", False)]
        # a second unsubscribe is a no-op, not another directory post
        d.unsubscribe_computation("comp_x")
        assert len(posts) == 2

    def test_resubscribe_from_oneshot_callback_keeps_subscription(self):
        # the race the fix closes, exercised deterministically: a
        # one-shot callback that re-subscribes runs between the record
        # teardown and (pre-fix) the unsubscribe post — the directory
        # must end up with subscribe=True last, not unsubscribe
        d, posts = self._recording_discovery()

        def resubscribe(evt, name, val):
            d.subscribe_computation("comp_x", lambda *a: None)

        d.subscribe_computation("comp_x", resubscribe, one_shot=True)
        d._fire(
            "computation", "comp_x", "computation_added", "comp_x", "a0"
        )
        flags = [
            m.subscribe for _, m in posts if m.type == "subscribe"
        ]
        # subscribe, teardown, re-subscribe — in exactly that order
        assert flags == [True, False, True]


def _directory_traffic(pkg):
    """The messages a directory sends its subscriber, and the subscriber's
    callback events, for one scripted sequence of publications (the
    subscriber's posts go straight into the directory, synchronously)."""
    import importlib

    dsc = importlib.import_module(f"{pkg}.infrastructure.discovery")
    directory = dsc.DirectoryComputation()
    client = dsc.Discovery("a1", "addr1")
    sent, events = [], []

    def to_client(sender, target, msg, prio):
        sent.append((target, prio, msg.type, {
            f: getattr(msg, f) for f in type(msg)._repr_fields}))
        client.discovery_computation.on_message(sender, msg, 0.0)

    def to_directory(sender, target, msg, prio):
        directory.on_message(sender, msg, 0.0)

    directory.message_sender = to_client
    client.discovery_computation.message_sender = to_directory
    directory.start()
    client.discovery_computation.start()
    directory.on_message("x", dsc.PublishAgentMessage(
        agent="a0", address="addr0"), 0.0)
    client.subscribe_all_agents(lambda *e: events.append(e))
    client.subscribe_computation("c1", lambda *e: events.append(e))
    client.subscribe_replica("c1", lambda *e: events.append(e),
                             one_shot=True)
    for msg in (
        dsc.PublishComputationMessage(computation="c1", agent="a0",
                                      address="addr0"),
        dsc.PublishReplicaMessage(replica="c1", agent="a2"),
        dsc.PublishReplicaMessage(replica="c1", agent="a3"),
        dsc.PublishAgentMessage(agent="a2", address="addr2"),
        dsc.UnpublishComputationMessage(computation="c1"),
        dsc.UnpublishAgentMessage(agent="a0"),
    ):
        directory.on_message("x", msg, 0.0)
    return sent, events, sorted(client.agents())


def test_directory_traffic_is_the_jax_package_s():
    # the same publications through either package's directory and
    # client: the same messages, priorities and callback events (exact)
    pytest.importorskip("jax")
    assert _directory_traffic("pydcop_tpu_torch") == _directory_traffic(
        "pydcop_tpu")
