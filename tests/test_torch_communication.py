"""The port's communication layer (``pydcop_tpu_torch/infrastructure/
communication.py``), case for case the JAX package's
``tests/test_communication_deep.py``: Messaging priorities, metrics and
parking, the in-process layer's address isolation and error modes, the
HTTP layer end to end (on free ports) including unknown-computation
handling, the parked-message bounds and the re-park race.  Host only:
nothing here imports torch or jax; the layers are held to the JAX
package's observable behaviour, case by case (``test_wire_payload_
is_the_jax_package_s`` holds the HTTP body itself to the JAX layer's)."""

import threading
import time

import pytest

from pydcop_tpu_torch.infrastructure.communication import (
    CommunicationLayer,
    HttpCommunicationLayer,
    InProcessCommunicationLayer,
    Messaging,
    MSG_ALGO,
    MSG_MGT,
    Message,
    UnknownComputation,
)


class _Sink:
    """Bare local computation recording deliveries."""

    def __init__(self):
        self.received = []


class TestMessaging:
    def _local(self):
        m = Messaging("a1", InProcessCommunicationLayer())
        m.register_computation("c1", _Sink())
        m.register_computation("c2", _Sink())
        return m

    def test_local_delivery_and_pop(self):
        m = self._local()
        m.post_msg("c1", "c2", Message("m", "hello"))
        sender, dest, msg, _ = m.next_msg(timeout=0.5)
        assert (sender, dest, msg.content) == ("c1", "c2", "hello")

    def test_next_msg_none_when_empty(self):
        m = self._local()
        assert m.next_msg(timeout=0.05) is None

    def test_priority_order_beats_fifo(self):
        # management traffic (lower prio value) must overtake algorithm
        # messages already queued (reference test_messaging priorities)
        m = self._local()
        m.post_msg("c1", "c2", Message("algo", 1), MSG_ALGO)
        m.post_msg("c1", "c2", Message("algo", 2), MSG_ALGO)
        m.post_msg("c1", "c2", Message("mgt", 3), MSG_MGT)
        order = [m.next_msg(timeout=0.5)[2].content for _ in range(3)]
        assert order == [3, 1, 2]  # mgt first, then FIFO among equals

    def test_same_priority_is_fifo(self):
        m = self._local()
        for i in range(5):
            m.post_msg("c1", "c2", Message("m", i))
        got = [m.next_msg(timeout=0.5)[2].content for _ in range(5)]
        assert got == [0, 1, 2, 3, 4]

    def test_local_messages_not_counted_as_external(self):
        m = self._local()
        m.post_msg("c1", "c2", Message("m", "x"))
        assert m.count_ext_msg.get("c1", 0) == 0

    def test_external_messages_counted_but_not_mgt(self):
        # metrics track algorithm traffic; management traffic is free
        # (reference test_do_not_count_mgt_messages:178)
        a1, a2 = InProcessCommunicationLayer(), InProcessCommunicationLayer()
        m1 = Messaging("a1", a1)
        m2 = Messaging("a2", a2)
        m2.register_computation("remote", _Sink())
        m1.register_route("remote", "a2", a2.address)
        m1.post_msg("c1", "remote", Message("m", "x"), MSG_ALGO)
        m1.post_msg("c1", "remote", Message("m", "y"), MSG_MGT)
        assert m1.count_ext_msg["c1"] == 1
        assert m1.size_ext_msg["c1"] >= 1
        # both actually arrived on a2's queue
        contents = {m2.next_msg(0.5)[2].content for _ in range(2)}
        assert contents == {"x", "y"}

    def test_parked_message_flushes_once_route_known(self):
        a1, a2 = InProcessCommunicationLayer(), InProcessCommunicationLayer()
        m1 = Messaging("a1", a1)
        m2 = Messaging("a2", a2)
        m2.register_computation("later", _Sink())
        m1.post_msg("c1", "later", Message("m", 42))
        assert m2.next_msg(timeout=0.05) is None  # parked, not lost
        m1.register_route("later", "a2", a2.address)
        assert m2.next_msg(timeout=0.5)[2].content == 42

    def test_unknown_computation_lookup_raises(self):
        m = self._local()
        with pytest.raises(UnknownComputation):
            m.computation("ghost")


class TestInProcessLayer:
    def test_addresses_not_shared_across_instances(self):
        l1, l2 = InProcessCommunicationLayer(), InProcessCommunicationLayer()
        assert l1.address is l1
        assert l1.address is not l2.address

    def test_send_delivers_to_target_queue(self):
        l1, l2 = InProcessCommunicationLayer(), InProcessCommunicationLayer()
        m1, m2 = Messaging("a1", l1), Messaging("a2", l2)
        m2.register_computation("c2", _Sink())
        l1.send_msg("a1", "a2", l2, "c1", "c2", Message("m", "direct"), 20)
        assert m2.next_msg(timeout=0.5)[2].content == "direct"


class TestHttpLayer:
    def _pair(self, p1, p2):
        l1 = HttpCommunicationLayer(("127.0.0.1", p1))
        l2 = HttpCommunicationLayer(("127.0.0.1", p2))
        m1, m2 = Messaging("a1", l1), Messaging("a2", l2)
        return l1, l2, m1, m2

    def test_roundtrip_between_two_http_agents(self):
        l1, l2, m1, m2 = self._pair(0, 0)
        try:
            m2.register_computation("c2", _Sink())
            m1.register_computation("c1", _Sink())
            m1.register_route("c2", "a2", l2.address)
            m2.register_route("c1", "a1", l1.address)
            m1.post_msg("c1", "c2", Message("ping", {"k": [1, 2]}))
            got = m2.next_msg(timeout=3.0)
            assert got is not None
            assert got[2].content == {"k": [1, 2]}
            # and back
            m2.post_msg("c2", "c1", Message("pong", "ok"))
            assert m1.next_msg(timeout=3.0)[2].content == "ok"
        finally:
            l1.shutdown()
            l2.shutdown()

    def test_priority_travels_over_http(self):
        l1, l2, m1, m2 = self._pair(0, 0)
        try:
            m2.register_computation("c2", _Sink())
            m1.register_route("c2", "a2", l2.address)
            m1.post_msg("c1", "c2", Message("algo", "later"), MSG_ALGO)
            # wait for the first to land so queue ordering is meaningful
            deadline = time.time() + 3
            while m2.msg_queue_count < 1 and time.time() < deadline:
                time.sleep(0.01)
            m1.post_msg("c1", "c2", Message("mgt", "first"), MSG_MGT)
            deadline = time.time() + 3
            while m2.msg_queue_count < 2 and time.time() < deadline:
                time.sleep(0.01)
            order = [m2.next_msg(0.5)[2].content for _ in range(2)]
            assert order == ["first", "later"]
        finally:
            l1.shutdown()
            l2.shutdown()

    def test_unknown_computation_parks_for_rediscovery(self):
        # the receiver answers pyDCOP's 404; the sender must drop
        # the stale route and park, NOT raise or lose the message
        l1, l2, m1, m2 = self._pair(0, 0)
        try:
            m1.register_route("ghost", "a2", l2.address)
            m1.post_msg("c1", "ghost", Message("m", 7))
            time.sleep(0.3)
            assert m2.next_msg(timeout=0.05) is None
            # deploy the computation and re-announce the route: flushes
            m2.register_computation("ghost", _Sink())
            m1.register_route("ghost", "a2", l2.address)
            got = m2.next_msg(timeout=3.0)
            assert got is not None and got[2].content == 7
        finally:
            l1.shutdown()
            l2.shutdown()


class TestHttpErrorModes:
    """The CommunicationLayer error contract (reference
    communication.py:68-79): 'ignore' swallows transport failures,
    'fail' raises UnreachableAgent, 'retry' attempts three sends with
    backoff before giving up.  None of these were exercised before
    round 5."""

    @staticmethod
    def _dead_address():
        # bind-then-close reserves a port nobody is listening on
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        addr = s.getsockname()
        s.close()
        return addr

    @staticmethod
    def _send(layer, address):
        return layer.send_msg(
            "a1", "a2", address, "c1", "c2", Message("t", None), MSG_ALGO
        )

    def test_invalid_mode_rejected(self):
        with pytest.raises(ValueError):
            InProcessCommunicationLayer(on_error="explode")

    def test_ignore_returns_false_after_one_attempt(self, caplog):
        layer = HttpCommunicationLayer(("127.0.0.1", 0), on_error="ignore")
        try:
            with caplog.at_level("WARNING"):
                ok = self._send(layer, self._dead_address())
            assert ok is False
            attempts = [
                r for r in caplog.records if "http send" in r.getMessage()
            ]
            assert len(attempts) == 1
        finally:
            layer.shutdown()

    def test_fail_raises_unreachable(self):
        from pydcop_tpu_torch.infrastructure.communication import UnreachableAgent

        layer = HttpCommunicationLayer(("127.0.0.1", 0), on_error="fail")
        try:
            with pytest.raises(UnreachableAgent):
                self._send(layer, self._dead_address())
        finally:
            layer.shutdown()

    def test_retry_attempts_three_times_then_gives_up(self, caplog):
        layer = HttpCommunicationLayer(("127.0.0.1", 0), on_error="retry")
        try:
            with caplog.at_level("WARNING"):
                ok = self._send(layer, self._dead_address())
            assert ok is False
            attempts = [
                r for r in caplog.records if "http send" in r.getMessage()
            ]
            assert len(attempts) == 3
        finally:
            layer.shutdown()

    def test_retry_succeeds_when_peer_appears_late(self):
        # the peer binds its port only AFTER the sender's first attempt
        # has failed: retry's backoff must land the message on a later
        # attempt and report True.  jitter="none" pins the schedule
        # (sleeps 0.3s then 0.6s) so the peer at 0.25s is always up by a
        # retry — the default full jitter could draw near-zero sleeps
        from pydcop_tpu_torch.infrastructure.retry import RetryPolicy

        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        addr = s.getsockname()
        s.close()

        peer_box = {}

        def start_peer_late():
            time.sleep(0.25)
            peer = HttpCommunicationLayer(addr, on_error="retry")
            m = Messaging("a2", peer)
            m.register_computation("c2", _Sink())
            peer_box["peer"], peer_box["m"] = peer, m

        t = threading.Thread(target=start_peer_late)
        t.start()
        sender = HttpCommunicationLayer(
            ("127.0.0.1", 0),
            on_error="retry",
            retry_policy=RetryPolicy(
                max_attempts=3, base_delay=0.3, max_delay=2.0,
                jitter="none",
            ),
        )
        try:
            assert self._send(sender, addr) is True
            t.join()
            got = peer_box["m"].next_msg(2.0)
            assert got is not None
            _sender, dest, msg, _t = got
            assert dest == "c2" and msg.type == "t"
        finally:
            sender.shutdown()
            if "peer" in peer_box:
                peer_box["peer"].shutdown()

    def test_exhausted_retries_log_error_and_count(self, caplog):
        # a False return is indistinguishable from success at call
        # sites: exhaustion must log ONE error line and increment
        # comms.send_failures
        from pydcop_tpu_torch.telemetry import metrics_registry

        metrics_registry.reset()
        metrics_registry.enabled = True
        layer = HttpCommunicationLayer(("127.0.0.1", 0), on_error="ignore")
        try:
            with caplog.at_level("WARNING"):
                ok = self._send(layer, self._dead_address())
            assert ok is False
            errors = [
                r for r in caplog.records
                if r.levelname == "ERROR" and "giving up" in r.getMessage()
            ]
            assert len(errors) == 1
            counter = metrics_registry.get("comms.send_failures")
            assert counter.value(agent="a1", dest="a2") == 1
        finally:
            metrics_registry.enabled = False
            layer.shutdown()


class TestParkedBounds:
    """``Messaging._parked`` is bounded: a cap + TTL dead-letter the
    overflow, loudly."""

    def test_parked_cap_dead_letters_oldest(self):
        m = Messaging("a1", InProcessCommunicationLayer(), parked_cap=3)
        for i in range(5):
            m.post_msg("c1", "nowhere", Message("m", i))
        assert m.parked_count == 3
        assert m.dead_letter_count == 2
        # the survivors are the NEWEST three: evicting the oldest first
        # drops the messages whose route has been missing longest
        m.register_computation("nowhere", _Sink())
        m.register_route("nowhere", "a1", m.comm.address)
        got = [m.next_msg(timeout=0.5)[2].content for _ in range(3)]
        assert got == [2, 3, 4]
        assert m.next_msg(timeout=0.05) is None

    def test_parked_ttl_expires_on_new_park(self):
        m = Messaging(
            "a1", InProcessCommunicationLayer(), parked_ttl=0.05
        )
        m.post_msg("c1", "ghost1", Message("m", "old"))
        time.sleep(0.1)
        m.post_msg("c1", "ghost2", Message("m", "new"))
        assert m.dead_letter_count == 1
        assert m.parked_count == 1

    def test_ttl_clock_survives_replay_reparks(self):
        # register_route flushes and re-parks messages still lacking a
        # route: the re-park must keep the ORIGINAL park time, or every
        # route registration would reset every TTL clock and the bound
        # would never bind
        m = Messaging(
            "a1", InProcessCommunicationLayer(), parked_ttl=0.1
        )
        m.post_msg("c1", "ghost", Message("m", "old"))
        time.sleep(0.06)
        # a route for a DIFFERENT computation flushes + re-parks 'ghost'
        m.register_computation("other", _Sink())
        m.register_route("other", "a1", m.comm.address)
        assert m.parked_count == 1
        time.sleep(0.06)  # total parked time now > TTL
        m.post_msg("c1", "ghost2", Message("m", "new"))
        assert m.dead_letter_count == 1
        assert m.parked_count == 1

    def test_route_arrival_beats_ttl(self):
        # TTL is enforced lazily on NEW parks, never on the flush: a
        # late-arriving route still delivers whatever is parked
        m = Messaging(
            "a1", InProcessCommunicationLayer(), parked_ttl=0.01
        )
        m.post_msg("c1", "late", Message("m", 7))
        time.sleep(0.05)
        m.register_computation("late", _Sink())
        m.register_route("late", "a1", m.comm.address)
        assert m.next_msg(timeout=0.5)[2].content == 7
        assert m.dead_letter_count == 0

    def test_dead_letters_counted_in_metrics(self):
        from pydcop_tpu_torch.telemetry import metrics_registry

        metrics_registry.reset()
        metrics_registry.enabled = True
        try:
            m = Messaging(
                "agent_dl", InProcessCommunicationLayer(), parked_cap=1
            )
            m.post_msg("c1", "ghost1", Message("m", 1))
            m.post_msg("c1", "ghost2", Message("m", 2))
            counter = metrics_registry.get("comms.dead_letters")
            assert counter.value(agent="agent_dl") == 1
            gauge = metrics_registry.get("comms.parked_depth")
            assert gauge.value(agent="agent_dl") == 1
        finally:
            metrics_registry.enabled = False


class _DelayedLayer(CommunicationLayer):
    """Forwards every send to ``inner`` after ``seconds``."""

    def __init__(self, inner, seconds):
        super().__init__(inner.on_error)
        self.inner, self.seconds = inner, seconds

    @property
    def address(self):
        return self.inner.address

    def send_msg(self, *args):
        time.sleep(self.seconds)
        return self.inner.send_msg(*args)

    def shutdown(self):
        self.inner.shutdown()


class TestParkedReplayRace:
    """A 404 re-park racing ``register_route`` under injected delays
    must deliver exactly once: the lock-swap flush in register_route is
    what makes the replay neither lose nor duplicate the message.  The
    JAX package injects the delay with its chaos layer; the port's is
    not ported, so a layer that sleeps before each send stands in."""

    def test_repark_register_route_race_delivers_exactly_once(self):
        inner1 = HttpCommunicationLayer(("127.0.0.1", 0))
        l2 = HttpCommunicationLayer(("127.0.0.1", 0))
        l1 = _DelayedLayer(inner1, 0.05)
        m1 = Messaging("a1", l1)
        m2 = Messaging("a2", l2)
        try:
            # stale route: a2 answers 404 for 'late' until the deploy
            # thread registers it; the chaos delay stretches the window
            # in which the re-park races the route announcement
            m1.register_route("late", "a2", l2.address)

            def deploy_and_announce():
                time.sleep(0.02)
                m2.register_computation("late", _Sink())
                m1.register_route("late", "a2", l2.address)

            t = threading.Thread(target=deploy_and_announce)
            t.start()
            m1.post_msg("c1", "late", Message("m", 42))
            t.join()
            # a re-park that lost the race to the announcement flush is
            # still parked: one more announcement flushes it
            m1.register_route("late", "a2", l2.address)
            received = []
            deadline = time.time() + 3
            while time.time() < deadline:
                got = m2.next_msg(timeout=0.15)
                if got is not None:
                    received.append(got[2].content)
                elif received:
                    break
            assert received == [42]
            assert m1.dead_letter_count == 0
        finally:
            l1.shutdown()
            l2.shutdown()


def test_wire_payload_is_the_jax_package_s(monkeypatch):
    # the HTTP body a send posts: the JAX layer's JSON field for field,
    # the message's simple_repr naming its own package's module (exact)
    import json
    import urllib.request

    pytest.importorskip("jax")
    from pydcop_tpu.infrastructure import communication as jax_comm
    from pydcop_tpu.infrastructure import orchestrator as jax_orc
    from pydcop_tpu_torch.infrastructure import orchestrator as orc

    bodies = []

    class _Done(Exception):
        pass

    def capture(req, timeout=None):
        bodies.append(json.loads(req.data.decode()))
        raise _Done

    monkeypatch.setattr(urllib.request, "urlopen", capture)
    for layer_mod, msg in (
        (jax_comm, jax_orc.ValueChangeMessage(
            computation="x", value=2, cost=1.5, cycle=3)),
        (__import__("pydcop_tpu_torch.infrastructure.communication",
                    fromlist=["x"]),
         orc.ValueChangeMessage(computation="x", value=2, cost=1.5,
                                cycle=3)),
    ):
        layer = layer_mod.HttpCommunicationLayer(("127.0.0.1", 0))
        msg._cycle_id = 4
        try:
            with pytest.raises(_Done):
                layer.send_msg("a1", "a2", ("127.0.0.1", 1), "c1", "c2",
                               msg, MSG_ALGO)
        finally:
            layer.shutdown()
    jax_body, port_body = bodies
    jax_msg, port_msg = jax_body.pop("msg"), port_body.pop("msg")
    assert jax_msg.pop("__module__") == (
        "pydcop_tpu.infrastructure.computations")
    assert port_msg.pop("__module__") == (
        "pydcop_tpu_torch.infrastructure.computations")
    assert port_msg == jax_msg and port_body == jax_body
    assert port_body["cycle_id"] == 4


def test_mailbox_keeps_every_message_of_concurrent_senders():
    # the port's mailbox appends without a lock: more sending threads
    # than cores, switching every 10 microseconds, lose nothing while
    # the owner consumes, each sender's messages keep their order, and a
    # management message still overtakes queued algorithm ones (the
    # JAX package's queue.PriorityQueue order)
    import os
    import sys

    m = Messaging("hub", InProcessCommunicationLayer())
    m.register_computation("sink", _Sink())
    senders, n = 2 * (os.cpu_count() or 4), 1000

    def send(k):
        for i in range(n):
            m.post_msg(f"c{k}", "sink", Message("m", (k, i)), MSG_ALGO)

    threads = [threading.Thread(target=send, args=(k,))
               for k in range(senders)]
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 60
        while len(got) < senders * n // 2 and time.time() < deadline:
            item = m.next_msg(timeout=1.0)
            if item is not None:
                got.append(item[2].content)
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    m.post_msg("x", "sink", Message("mgt", "first"), MSG_MGT)
    assert m.next_msg(timeout=1.0)[2].content == "first"
    while True:
        item = m.next_msg(timeout=0.05)
        if item is None:
            break
        got.append(item[2].content)
    assert len(got) == senders * n
    assert m.msg_queue_count == senders * n + 1
    for k in range(senders):
        assert [i for kk, i in got if kk == k] == list(range(n))
