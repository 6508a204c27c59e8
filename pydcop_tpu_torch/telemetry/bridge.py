"""Event-bus -> metrics bridge.

The port's copy of ``pydcop_tpu/telemetry/bridge.py``: turns the agent
runtime's ``computations.* / agents.* / orchestrator.*`` bus topics
(``infrastructure/events.py``) into registry metrics, so attaching one
object gives per-computation message, cycle and value counters without
touching any agent.  ``commands/_utils.start_telemetry`` attaches it
whenever the registry is on.

The bridge enables the bus on attach and restores its previous state on
detach.  The ``event_bus`` import is deferred to attach time, so this
module stays free of import cycles (the infrastructure package imports
telemetry for its instrumentation).  Stdlib only.
"""

from __future__ import annotations

from typing import Any, Optional

from .metrics import MetricsRegistry, metrics_registry

__all__ = ["EventBusBridge", "attach_event_bridge"]


def _suffix(topic: str, prefix: str) -> str:
    return topic[len(prefix):] if topic.startswith(prefix) else topic


class EventBusBridge:
    """Subscribes wildcard bus topics and counts them in a registry."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        bus: Any = None,
    ) -> None:
        reg = registry if registry is not None else metrics_registry
        self._registry = reg
        self._bus = bus
        self._attached = False
        self._bus_was_enabled = False
        self._msg_snd = reg.counter(
            "computations.messages_sent",
            "messages posted, by sending computation (bus)",
        )
        self._msg_rcv = reg.counter(
            "computations.messages_received",
            "messages delivered, by destination computation (bus)",
        )
        self._cycles = reg.counter(
            "computations.cycles", "cycle transitions, by computation (bus)"
        )
        self._values = reg.counter(
            "computations.value_changes",
            "value selections, by computation (bus)",
        )
        self._comp_added = reg.counter(
            "agents.computations_added",
            "computations deployed onto agents, by agent (bus)",
        )
        self._comp_removed = reg.counter(
            "agents.computations_removed",
            "computations removed from agents, by agent (bus)",
        )
        self._orch_events = reg.counter(
            "orchestrator.events", "orchestrator bus events, by kind"
        )

    # one callback per topic family (wildcard subscriptions)

    def _on_msg_snd(self, topic: str, evt: Any) -> None:
        self._msg_snd.inc(
            computation=_suffix(topic, "computations.message_snd.")
        )

    def _on_msg_rcv(self, topic: str, evt: Any) -> None:
        self._msg_rcv.inc(
            computation=_suffix(topic, "computations.message_rcv.")
        )

    def _on_cycle(self, topic: str, evt: Any) -> None:
        self._cycles.inc(computation=_suffix(topic, "computations.cycle."))

    def _on_value(self, topic: str, evt: Any) -> None:
        self._values.inc(computation=_suffix(topic, "computations.value."))

    def _on_comp_added(self, topic: str, evt: Any) -> None:
        self._comp_added.inc(
            agent=_suffix(topic, "agents.add_computation.")
        )

    def _on_comp_removed(self, topic: str, evt: Any) -> None:
        self._comp_removed.inc(
            agent=_suffix(topic, "agents.rem_computation.")
        )

    def _on_orchestrator(self, topic: str, evt: Any) -> None:
        self._orch_events.inc(event=_suffix(topic, "orchestrator."))

    _SUBSCRIPTIONS = (
        ("computations.message_snd.*", "_on_msg_snd"),
        ("computations.message_rcv.*", "_on_msg_rcv"),
        ("computations.cycle.*", "_on_cycle"),
        ("computations.value.*", "_on_value"),
        ("agents.add_computation.*", "_on_comp_added"),
        ("agents.rem_computation.*", "_on_comp_removed"),
        ("orchestrator.*", "_on_orchestrator"),
    )

    def attach(self) -> "EventBusBridge":
        if self._attached:
            return self
        if self._bus is None:
            from ..infrastructure.events import event_bus

            self._bus = event_bus
        self._bus_was_enabled = self._bus.enabled
        self._bus.enabled = True
        for topic, method in self._SUBSCRIPTIONS:
            self._bus.subscribe(topic, getattr(self, method))
        self._attached = True
        return self

    def detach(self) -> None:
        if not self._attached:
            return
        for topic, method in self._SUBSCRIPTIONS:
            self._bus.unsubscribe(topic, getattr(self, method))
        self._bus.enabled = self._bus_was_enabled
        self._attached = False


def attach_event_bridge(
    registry: Optional[MetricsRegistry] = None, bus: Any = None
) -> EventBusBridge:
    """Create + attach a bridge in one call; returns it for ``detach()``."""
    return EventBusBridge(registry=registry, bus=bus).attach()
