"""The agent runtime's telemetry in the port, case for case the runtime
part of the JAX package's ``tests/test_telemetry.py``: the event-bus ->
metrics bridge (``telemetry/bridge.py``), the message_snd/message_rcv
topics and comms counters of ``Messaging``, the stats rows' routing, and
a thread-mode CLI solve whose trace and metrics cover the run's traffic.
Host only but for the CLI case, which solves with ``--device cpu``; the
last case holds the bus's dispatch order to the JAX package's."""

import json
import os
import subprocess
import sys

import pytest

from pydcop_tpu_torch.infrastructure import stats
from pydcop_tpu_torch.infrastructure.communication import (
    InProcessCommunicationLayer,
    Messaging,
)
from pydcop_tpu_torch.infrastructure.computations import Message
from pydcop_tpu_torch.infrastructure.events import EventDispatcher, event_bus
from pydcop_tpu_torch.telemetry import (
    attach_event_bridge,
    metrics_registry,
    telemetry_off,
    tracer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCE = os.path.join(ROOT, "tests", "instances", "graph_coloring.yaml")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry_off()
    yield
    telemetry_off()
    event_bus.enabled = False
    event_bus.reset()


def run_cli(*args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )


class TestEventBusBridge:
    def test_topics_become_metrics(self):
        metrics_registry.enabled = True
        bridge = attach_event_bridge()
        try:
            event_bus.send("computations.message_snd.c1", ("c2", "ping"))
            event_bus.send("computations.message_snd.c1", ("c3", "ping"))
            event_bus.send("computations.message_rcv.c2", ("c1", "ping"))
            event_bus.send("computations.cycle.c1", 3)
            event_bus.send("computations.value.c1", ("a", 0.5))
            event_bus.send("agents.add_computation.a1", "c1")
            event_bus.send("orchestrator.scenario.remove_agent", "a2")
            reg = metrics_registry
            assert reg.counter("computations.messages_sent").value(
                computation="c1"
            ) == 2
            assert reg.counter("computations.messages_received").value(
                computation="c2"
            ) == 1
            assert reg.counter("computations.cycles").value(
                computation="c1"
            ) == 1
            assert reg.counter("computations.value_changes").value(
                computation="c1"
            ) == 1
            assert reg.counter("agents.computations_added").value(
                agent="a1"
            ) == 1
            assert reg.counter("orchestrator.events").value(
                event="scenario.remove_agent"
            ) == 1
        finally:
            bridge.detach()

    def test_attach_enables_bus_detach_restores(self):
        assert not event_bus.enabled
        bridge = attach_event_bridge()
        assert event_bus.enabled
        bridge.detach()
        assert not event_bus.enabled

    def test_raising_callback_keeps_dispatching_and_counts(self):
        # a callback that raises must not kill the sender's
        # thread nor starve later subscribers
        metrics_registry.enabled = True
        bus = EventDispatcher(enabled=True)
        seen = []

        def bad(topic, evt):
            raise RuntimeError("boom")

        bus.subscribe("computations.cycle.*", bad)
        bus.subscribe("computations.cycle.*", lambda t, e: seen.append(e))
        bus.send("computations.cycle.c1", 7)  # must not raise
        assert seen == [7]
        assert metrics_registry.counter(
            "telemetry.dispatch_errors"
        ).value(topic="computations.cycle.c1") == 1




class TestMessagingTelemetry:
    def _pair(self):
        """Two wired Messaging endpoints (a1 -> a2 route registered)."""
        m1 = Messaging("a1", InProcessCommunicationLayer())
        m2 = Messaging("a2", InProcessCommunicationLayer())
        m2.register_computation("c2", object())
        m1.register_route("c2", "a2", m2.comm.address)
        return m1, m2

    def test_snd_rcv_topics_published_from_messaging(self):
        topics = []
        event_bus.enabled = True
        event_bus.subscribe(
            "computations.message_snd.*", lambda t, e: topics.append((t, e))
        )
        event_bus.subscribe(
            "computations.message_rcv.*", lambda t, e: topics.append((t, e))
        )
        m1, m2 = self._pair()
        m1.post_msg("c1", "c2", Message("ping", "hello"))
        assert (
            "computations.message_snd.c1", ("c2", "ping")
        ) in topics
        assert (
            "computations.message_rcv.c2", ("c1", "ping")
        ) in topics

    def test_comms_counters_match_traffic(self):
        metrics_registry.enabled = True
        m1, m2 = self._pair()
        msg = Message("ping", "hello")
        for _ in range(5):
            m1.post_msg("c1", "c2", msg)
        reg = metrics_registry
        assert reg.counter("comms.messages_sent").value(agent="a1") == 5
        assert reg.counter("comms.messages_received").value(agent="a2") == 5
        assert reg.counter("comms.payload_bytes_sent").value(
            agent="a1"
        ) == 5 * msg.size
        assert reg.counter("comms.payload_bytes_received").value(
            agent="a2"
        ) == 5 * msg.size
        assert reg.gauge("comms.queue_depth").value(agent="a2") >= 1
        # consuming records delivery latency
        assert m2.next_msg(timeout=1) is not None
        assert reg.histogram("comms.delivery_seconds").count(agent="a2") == 1

    def test_parked_then_flushed_message_counted_once(self):
        # a message posted before its destination has a route parks, and
        # register_route's flush re-posts it: the telemetry sinks must see
        # ONE logical message, not two
        metrics_registry.enabled = True
        tracer.enabled = True
        topics = []
        event_bus.enabled = True
        event_bus.subscribe(
            "computations.message_snd.*", lambda t, e: topics.append(t)
        )
        m1 = Messaging("a1", InProcessCommunicationLayer())
        m2 = Messaging("a2", InProcessCommunicationLayer())
        m2.register_computation("c2", object())
        m1.post_msg("c1", "c2", Message("ping", "x"))  # no route: parks
        m1.register_route("c2", "a2", m2.comm.address)  # flush re-posts
        assert m2.next_msg(timeout=1) is not None  # delivered exactly once
        reg = metrics_registry
        assert reg.counter("comms.messages_sent").value(agent="a1") == 1
        assert reg.counter("comms.messages_received").value(agent="a2") == 1
        assert topics == ["computations.message_snd.c1"]
        names = [e["name"] for e in tracer.events()]
        assert names.count("comms.send") == 1

    def test_trace_instants_for_send_recv(self):
        tracer.enabled = True
        m1, m2 = self._pair()
        m1.post_msg("c1", "c2", Message("ping", "x"))
        names = [e["name"] for e in tracer.events()]
        assert names.count("comms.send") == 1
        assert names.count("comms.recv") == 1

    def test_404_repark_counts_ext_msg_once(self):
        # a send answered with pyDCOP's 404 re-parks the message;
        # the register_route replay is its one successful send and must
        # be the one count in count_ext_msg/size_ext_msg
        from pydcop_tpu_torch.infrastructure.communication import (
            CommunicationLayer,
            UnknownComputation,
        )

        class Flaky404Layer(CommunicationLayer):
            def __init__(self):
                super().__init__()
                self.calls = 0

            @property
            def address(self):
                return self

            def send_msg(self, *a, **kw):
                self.calls += 1
                if self.calls == 1:
                    raise UnknownComputation("c2")
                return True

        m1 = Messaging("a1", Flaky404Layer())
        m1.register_route("c2", "a2", "addr")
        m1.post_msg("c1", "c2", Message("ping", "x"))  # 404 -> re-parked
        assert m1.count_ext_msg.get("c1", 0) == 0
        m1.register_route("c2", "a2", "addr")  # flush: succeeds now
        assert m1.comm.calls == 2
        assert m1.count_ext_msg["c1"] == 1
        assert m1.size_ext_msg["c1"] == Message("ping", "x").size




class TestStatsTelemetry:
    def test_set_stats_file_none_closes_and_disables(self, tmp_path):
        p = str(tmp_path / "trace.csv")
        stats.set_stats_file(p)
        stats.trace_computation("comp_a", 1, 0.25, 2, 64, 10, 3)
        handle = stats._file
        stats.set_stats_file(None)
        assert not stats.stats_enabled()
        assert stats._file is None
        assert handle.closed
        stats.trace_computation("comp_b", 2, 0.5)  # no-op after close
        with open(p, encoding="utf-8") as f:
            lines = f.read().splitlines()
        assert lines[0] == ",".join(stats.columns)
        assert len(lines) == 2 and "comp_a" in lines[1]

    def test_rows_routed_to_registry_and_csv_identical(self, tmp_path):
        p = str(tmp_path / "trace.csv")
        # CSV written with metrics OFF, the pre-telemetry format...
        stats.set_stats_file(p)
        stats.trace_computation("comp_a", 1, 0.25, 2, 64, 10, 3)
        stats.set_stats_file(None)
        with open(p, encoding="utf-8") as f:
            baseline_row = f.read().splitlines()[1].split(",")[1:]
        # ...must be byte-identical (time column aside) with metrics ON
        metrics_registry.enabled = True
        stats.set_stats_file(p)
        stats.trace_computation("comp_a", 1, 0.25, 2, 64, 10, 3)
        stats.set_stats_file(None)
        with open(p, encoding="utf-8") as f:
            row = f.read().splitlines()[1].split(",")[1:]
        assert row == baseline_row
        reg = metrics_registry
        assert reg.counter("stats.steps").value(computation="comp_a") == 1
        assert reg.counter("stats.msg_count").value(
            computation="comp_a"
        ) == 2
        assert reg.counter("stats.msg_size").value(
            computation="comp_a"
        ) == 64
        assert reg.counter("stats.op_count").value(
            computation="comp_a"
        ) == 10
        assert reg.histogram("stats.step_seconds").sum(
            computation="comp_a"
        ) == pytest.approx(0.25)

    def test_registry_only_routing_without_csv(self):
        metrics_registry.enabled = True
        stats.trace_computation("comp_x", 0, 0.1)
        assert metrics_registry.counter("stats.steps").value(
            computation="comp_x"
        ) == 1




class TestCliRoundTrip:
    def test_thread_mode_demo_covers_acceptance(self, tmp_path):
        # acceptance criterion: a demo solve whose trace covers compile,
        # >= 1 readback window and message send/recv, with metrics
        # counters matching the run's actual traffic
        trace = str(tmp_path / "trace.json")
        metrics = str(tmp_path / "metrics.json")
        r = run_cli(
            "solve", "-a", "dsa", "-m", "thread", "-n", "5",
            "--trace-out", trace, "--metrics-out", metrics, INSTANCE,
            timeout=180,
        )
        assert r.returncode == 0, r.stderr
        events = json.load(open(trace))["traceEvents"]
        names = [e["name"] for e in events if e.get("ph") in ("X", "i")]
        assert "solve.window" in names and "solve.readback" in names
        assert "orchestrator.device_solve" in names
        assert "orchestrator.readback" in names
        n_send = names.count("comms.send")
        n_recv = names.count("comms.recv")
        assert n_send > 0 and n_recv > 0
        m = json.load(open(metrics))["metrics"]

        def total(name):
            return sum(v["value"] for v in m[name]["values"])

        # counters match the run's actual traffic: every posted message
        # was delivered in-process (sent == received), and each one was
        # also recorded as a trace instant and a bus-bridge count
        assert total("comms.messages_sent") == total(
            "comms.messages_received"
        ) == n_send == n_recv
        assert total("comms.payload_bytes_sent") == total(
            "comms.payload_bytes_received"
        ) > 0
        assert total("computations.messages_sent") == n_send


def test_dispatch_order_is_the_jax_package_s():
    # the same subscriptions (exact and wildcard, interleaved) and sends
    # on either package's bus: the same callbacks in the same order
    pytest.importorskip("jax")
    from pydcop_tpu_torch.infrastructure.events import (
        EventDispatcher as JaxDispatcher,
    )

    def calls(bus):
        seen = []
        for topic in ("computations.cycle.c1", "computations.*",
                      "computations.cycle.*", "agents.*",
                      "computations.cycle.c1"):
            bus.subscribe(topic, lambda t, e, k=topic: seen.append((k, t)))
        bus.send("computations.cycle.c1", 1)
        bus.send("agents.add_computation.a1", 2)
        bus.send("computations.value.c2", 3)
        bus.unsubscribe("computations.*", bus._subs["computations.*"][0])
        bus.send("computations.cycle.c1", 4)
        return seen

    assert calls(EventDispatcher(enabled=True)) == calls(
        JaxDispatcher(enabled=True))
