"""The port's computation substrate (``pydcop_tpu_torch/infrastructure/
computations.py`` and ``stats.py``), case for case the JAX package's
``tests/test_computations_deep.py``: periodic actions driven by a real
agent loop (cadence, removal, several periods, paused), handler
registration semantics, pause buffering in both directions, the per-step
CSV trace and stop semantics.  Host only: no torch, no jax."""

import time

import pytest

from pydcop_tpu_torch.infrastructure.agents import Agent
from pydcop_tpu_torch.infrastructure.communication import (
    InProcessCommunicationLayer,
)
from pydcop_tpu_torch.infrastructure.computations import (
    ComputationException,
    Message,
    MessagePassingComputation,
    register,
)


def _wait(predicate, timeout=3.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


class _Probe(MessagePassingComputation):
    def __init__(self, name="probe"):
        super().__init__(name)
        self.pings = []

    @register("ping")
    def _on_ping(self, sender, msg, t):
        self.pings.append(msg.content)


@pytest.fixture()
def hosted():
    agent = Agent("host", InProcessCommunicationLayer())
    comp = _Probe()
    agent.add_computation(comp, publish=False)
    agent.start()
    comp.start()
    yield agent, comp
    agent.clean_shutdown()
    agent.join()


class TestPeriodicActions:
    def test_fires_repeatedly_at_period(self, hosted):
        agent, comp = hosted
        ticks = []
        comp.add_periodic_action(0.05, lambda: ticks.append(time.time()))
        assert _wait(lambda: len(ticks) >= 4)
        # cadence sanity: not all at once
        assert ticks[-1] - ticks[0] >= 0.1

    def test_remove_stops_firing(self, hosted):
        agent, comp = hosted
        ticks = []
        cb = comp.add_periodic_action(0.05, lambda: ticks.append(1))
        assert _wait(lambda: len(ticks) >= 2)
        comp.remove_periodic_action(cb)
        n = len(ticks)
        time.sleep(0.2)
        assert len(ticks) == n

    def test_several_periods_fire_proportionally(self, hosted):
        agent, comp = hosted
        fast, slow = [], []
        comp.add_periodic_action(0.03, lambda: fast.append(1))
        comp.add_periodic_action(0.15, lambda: slow.append(1))
        assert _wait(lambda: len(slow) >= 2, timeout=4)
        assert len(fast) > len(slow)

    def test_not_called_while_paused(self, hosted):
        agent, comp = hosted
        ticks = []
        comp.add_periodic_action(0.03, lambda: ticks.append(1))
        assert _wait(lambda: len(ticks) >= 1)
        comp.pause(True)
        time.sleep(0.1)  # let in-flight ticks settle
        n = len(ticks)
        time.sleep(0.2)
        assert len(ticks) <= n + 1  # at most one straggler
        comp.pause(False)
        assert _wait(lambda: len(ticks) > n + 1)


class TestHandlers:
    def test_unknown_message_type_raises(self):
        comp = _Probe()
        comp.start()
        with pytest.raises(ComputationException, match="no handler"):
            comp.on_message("s", Message("nope", 1), 0.0)

    def test_post_without_host_raises(self):
        comp = _Probe()
        comp.start()
        with pytest.raises(ComputationException, match="not hosted"):
            comp.post_msg("other", Message("ping", 1))

    def test_pause_buffers_in_and_out(self, hosted):
        agent, comp = hosted
        other = _Probe("other")
        agent.add_computation(other, publish=False)
        other.start()
        comp.pause(True)
        # inbound buffered
        comp.on_message("x", Message("ping", "in"), 0.0)
        assert comp.pings == []
        # outbound buffered
        comp.post_msg("other", Message("ping", "out"))
        time.sleep(0.1)
        assert other.pings == []
        comp.pause(False)
        assert comp.pings == ["in"]
        assert _wait(lambda: other.pings == ["out"])

    def test_message_delivery_through_agent(self, hosted):
        agent, comp = hosted
        other = _Probe("other")
        agent.add_computation(other, publish=False)
        other.start()
        comp.post_msg("other", Message("ping", 7))
        assert _wait(lambda: other.pings == [7])


class TestStatsTracing:
    """The per-step CSV trace (infrastructure/stats.py): dormant by
    default, and once a stats file is set
    every handled message writes one schema row."""

    def test_disabled_by_default_writes_nothing(self, tmp_path):
        from pydcop_tpu_torch.infrastructure import stats

        assert not stats.stats_enabled()
        # no file set: tracing is a no-op, not an error
        stats.trace_computation("c", 0, 0.001)

    def test_rows_written_per_handled_message(self, tmp_path):
        from pydcop_tpu_torch.infrastructure import stats

        out = tmp_path / "trace.csv"
        stats.set_stats_file(str(out))
        try:
            comp = _Probe()
            comp.start()
            comp.on_message("peer", Message("ping", 1), 0.0)
            comp.on_message("peer", Message("ping", 2), 0.0)
        finally:
            stats.set_stats_file(None)
        lines = out.read_text().strip().splitlines()
        assert lines[0] == ",".join(stats.columns)
        assert len(lines) == 3  # header + one row per message
        row = lines[1].split(",")
        assert row[1] == "probe"
        assert float(row[3]) >= 0.0  # duration
        assert row[4] == "1"  # msg_count
        assert not stats.stats_enabled()


class TestStopSemantics:
    """stop() vs clean_shutdown(): the hard stop abandons the queue after the in-flight message; the clean
    one drains pending messages first."""

    @staticmethod
    def _agent_with_probe():
        agent = Agent("drain", InProcessCommunicationLayer())
        comp = _Probe()
        agent.add_computation(comp, publish=False)
        comp.start()
        return agent, comp

    def test_clean_shutdown_drains_pending(self):
        agent, comp = self._agent_with_probe()
        # enqueue a burst BEFORE the loop starts, then shut down cleanly:
        # every message must still be handled
        for i in range(50):
            agent.messaging.post_msg(
                "x", "probe", Message("ping", i), prio=20
            )
        agent.start()
        agent.clean_shutdown()
        agent.join(10.0)
        assert len(comp.pings) == 50

    def test_hard_stop_abandons_queue(self):
        # deterministic: the first message parks on an event while the
        # main thread issues the hard stop, so exactly the in-flight
        # message is handled and the rest of the queue is abandoned
        import threading

        gate = threading.Event()
        entered = threading.Event()

        class _Gated(_Probe):
            @register("ping")
            def _on_ping(self, sender, msg, t):
                entered.set()
                gate.wait(10.0)
                self.pings.append(msg.content)

        agent = Agent("drain2", InProcessCommunicationLayer())
        comp = _Gated("probe")
        agent.add_computation(comp, publish=False)
        comp.start()
        for i in range(50):
            agent.messaging.post_msg(
                "x", "probe", Message("ping", i), prio=20
            )
        agent.start()
        assert entered.wait(5.0)
        agent.stop()  # hard: exits after the in-flight message
        gate.set()
        agent.join(10.0)
        assert len(comp.pings) == 1


def test_stats_rows_are_the_jax_package_s(tmp_path):
    # the same two handled messages through either package's substrate:
    # the same CSV header and rows, the clock columns (time, duration)
    # excepted (exact)
    import importlib

    pytest.importorskip("jax")
    rows = {}
    for pkg in ("pydcop_tpu_torch", "pydcop_tpu"):
        stats = importlib.import_module(f"{pkg}.infrastructure.stats")
        comps = importlib.import_module(
            f"{pkg}.infrastructure.computations")

        class Probe(comps.MessagePassingComputation):
            @comps.register("ping")
            def _on_ping(self, sender, msg, t):
                pass

        out = tmp_path / f"{pkg}.csv"
        stats.set_stats_file(str(out))
        try:
            comp = Probe("probe")
            comp.start()
            comp.on_message("peer", comps.Message("ping", [1, 2]), 0.0)
            comp.on_message("peer", comps.Message("ping", "x"), 0.0)
        finally:
            stats.set_stats_file(None)
        lines = [line.split(",") for line in out.read_text().splitlines()]
        rows[pkg] = [lines[0]] + [r[1:3] + r[4:] for r in lines[1:]]
    assert rows["pydcop_tpu_torch"] == rows["pydcop_tpu"]
