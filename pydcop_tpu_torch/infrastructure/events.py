"""In-process event bus: the runtime's observability spine.

The port's copy of ``pydcop_tpu/infrastructure/events.py``:
topic-keyed callbacks with ``*``-suffix wildcard subscription, disabled
by default (enabled when a UI or the metrics bridge attaches).  Topics
follow pyDCOP's naming: ``computations.value.<name>``,
``computations.cycle.<name>``, ``computations.message_rcv/message_snd.
<name>``, ``agents.add_computation.<agent>``.

The bus carries host-side events only: the device solve runs under the
orchestrator, which republishes its results here (value readbacks, cycle
costs) instead of every computation firing callbacks from its own
thread.  Stdlib only: agent processes import it without torch.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Tuple

__all__ = ["EventDispatcher", "event_bus"]

logger = logging.getLogger("pydcop_tpu_torch.infrastructure.events")


class EventDispatcher:
    """Topic -> callbacks dispatcher with ``*`` suffix wildcards.

    ``send`` reads an immutable snapshot of the subscriptions, rebuilt
    under the lock by ``subscribe``/``unsubscribe``/``reset``: with the
    bus on, every message of a run is two sends, from every agent's
    thread, and a lock taken on each was a convoy between them."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._lock = threading.RLock()
        self._subs: Dict[str, List[Callable[[str, Any], None]]] = {}
        # ((topic or wildcard prefix, is a wildcard, callbacks), ...), in
        # subscription order
        self._snapshot: Tuple[
            Tuple[str, bool, Tuple[Callable[[str, Any], None], ...]], ...
        ] = ()

    def _publish_locked(self) -> None:
        self._snapshot = tuple(
            (t[:-1], True, tuple(cbs)) if t.endswith("*")
            else (t, False, tuple(cbs))
            for t, cbs in self._subs.items()
        )

    def subscribe(self, topic: str, cb: Callable[[str, Any], None]) -> None:
        with self._lock:
            self._subs.setdefault(topic, []).append(cb)
            self._publish_locked()

    def unsubscribe(self, topic: str, cb: Callable[[str, Any], None]) -> None:
        with self._lock:
            cbs = self._subs.get(topic, [])
            if cb in cbs:
                cbs.remove(cb)
            if not cbs and topic in self._subs:
                del self._subs[topic]
            self._publish_locked()

    def send(self, topic: str, event: Any) -> None:
        if not self.enabled:
            return
        targets: List[Callable[[str, Any], None]] = []
        for key, wild, cbs in self._snapshot:
            if topic.startswith(key) if wild else topic == key:
                targets.extend(cbs)
        # callbacks run from a snapshot (a subscriber may re-enter
        # subscribe/unsubscribe); a RAISING callback must not kill the
        # SENDER's thread — an agent loop or the orchestrator — nor
        # starve the remaining subscribers, so each error is contained,
        # logged and counted (telemetry.dispatch_errors)
        for cb in targets:
            try:
                cb(topic, event)
            except Exception:
                logger.exception(
                    "event-bus callback %r failed on topic %s", cb, topic
                )
                # lazy import: telemetry must stay importable without the
                # infrastructure package (and vice versa)
                from ..telemetry.metrics import metrics_registry

                metrics_registry.counter(
                    "telemetry.dispatch_errors",
                    "event-bus callbacks that raised, by topic",
                ).inc(topic=topic)

    def reset(self) -> None:
        with self._lock:
            self._subs.clear()
            self._publish_locked()


#: Process-wide singleton, like pyDCOP's ``event_bus`` (Events.py:98).
event_bus = EventDispatcher()
