"""Agent runtime: the host-side worker that owns computations.

The port's copy of ``pydcop_tpu/infrastructure/agents.py``: ``Agent`` is
one thread and the agent's ``Messaging`` queue, hosting computations
(``add_computation``, run, pause, stop, ``clean_shutdown``), its dispatch
loop, periodic actions and per-agent metrics; ``AgentMetrics`` aggregates
the event bus's value and cycle events.

Agents carry control-plane computations only (management, discovery,
the value read-backs of the device solve): the algorithm's cycles run on
the card under the orchestrator, so the 50 ms poll of an agent's thread
costs nothing during a solve.  Stdlib only: an agent process (the
``agent`` verb, process mode's spawned agents) imports no torch.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .communication import (
    CommunicationLayer,
    Messaging,
    UnknownComputation,
)
from ..telemetry.tracing import tracer
from .computations import Message, MessagePassingComputation
from .discovery import Discovery
from .events import event_bus

__all__ = ["Agent", "AgentException", "AgentMetrics"]

logger = logging.getLogger("pydcop_tpu_torch.agents")


class AgentException(Exception):
    pass


class Agent:
    """A named runtime hosting computations behind one message queue.

    The agent is single-threaded: all computation handlers run on the agent
    thread, so computations never need locks (pyDCOP agents.py:279-281 in
    computations.py).  ``start()`` spins the thread; ``add_computation``
    registers a computation with messaging + discovery and wires its
    ``message_sender``; ``clean_shutdown`` drains the queue then stops.
    """

    def __init__(
        self,
        name: str,
        comm: CommunicationLayer,
        agent_def: Any = None,
        ui_port: Optional[int] = None,
        delay: float = 0.0,
    ) -> None:
        self.name = name
        self.agent_def = agent_def
        self.communication = comm
        self.messaging = Messaging(name, comm, delay=delay)
        self.discovery = Discovery(name, comm.address)
        self._computations: Dict[str, MessagePassingComputation] = {}
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._stopping = threading.Event()
        self._shutdown_clean = False
        self._crashed = False
        self._started_evt = threading.Event()
        self.t_active = 0.0
        self._last_tick = 0.0
        self._t_started: Optional[float] = None
        self._ui_server = None
        self._ui_port = ui_port
        self._periodic_cbs: List[Dict[str, Any]] = []
        # computations with registered periodic actions, keyed by object
        # id (see add_computation: the tick scan must not be O(hosted))
        self._ticking: Dict[int, MessagePassingComputation] = {}
        # the agent's own discovery endpoint is a hosted computation
        self.add_computation(
            self.discovery.discovery_computation, publish=False
        )

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def is_running(self) -> bool:
        return self._running

    def start(self) -> "Agent":
        if self._running:
            raise AgentException(f"agent {self.name} already started")
        with tracer.span("agent.start", cat="lifecycle", agent=self.name):
            self._running = True
            self._stopping.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"agent-{self.name}", daemon=True
            )
            self._thread.start()
            self._started_evt.wait(timeout=5)
            if self._ui_port:
                from .ui import UiServer

                self._ui_server = UiServer(self, self._ui_port)
                self.add_computation(self._ui_server, publish=False)
                self._ui_server.start()
        return self

    def stop(self) -> None:
        """Hard stop: the loop exits after the current message."""
        self._stopping.set()

    def clean_shutdown(self) -> None:
        """Graceful stop: process pending messages first (pyDCOP :431)."""
        self._shutdown_clean = True
        self._stopping.set()

    def crash(self) -> None:
        """Simulate abrupt process death (graftchaos kill events): no
        clean shutdown, no queue draining, and the inbound transport dies
        immediately so peers see an unreachable agent — not a politely
        closing one."""
        self._crashed = True
        self._shutdown_clean = False
        self._stopping.set()
        # a dead process hosts nothing: sealing messaging makes in-process
        # peers get UnknownComputation (and re-park) instead of feeding a
        # dead queue that reports the send as delivered
        self.messaging.seal()
        try:
            self.communication.shutdown()
        except Exception:  # a dying transport must not mask the crash
            logger.debug("%s: transport shutdown during crash", self.name)
        # graftpulse flight recorder: an abrupt agent death is exactly the
        # moment the last-K health vectors stop being reconstructible —
        # dump them now (no-op unless pulse is enabled; never raises)
        from ..telemetry.pulse import pulse

        pulse.recorder.maybe_dump(f"agent-crash:{self.name}")
        event_bus.send(f"agents.crash.{self.name}", self.name)

    def join(self, timeout: float = 5.0) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    # ------------------------------------------------------------------
    # computations
    # ------------------------------------------------------------------

    def add_computation(
        self,
        computation: MessagePassingComputation,
        name: Optional[str] = None,
        publish: bool = True,
    ) -> None:
        """Host a computation: wire its sender, register it locally and
        (optionally) in the directory (pyDCOP agents.py:175)."""
        name = name or computation.name
        if computation.message_sender is None:
            computation.message_sender = self._send_from_computation
        self._computations[name] = computation
        # the tick registry holds ONLY computations with periodic actions:
        # scanning every hosted computation each 10 ms tick was O(hosted)
        # and made agents decelerate during large deployments (measured:
        # ack rate fell from ~300/s to ~30/s per agent as hosted counts
        # crossed 60k).  Computations notify on (de)registration of
        # periodic actions, so dynamic additions land here too.
        computation._periodic_registry_notify = self._update_ticking
        if computation._periodic:
            self._ticking[id(computation)] = computation
        self.messaging.register_computation(name, computation)
        self.discovery.register_computation(
            name, self.name, self.communication.address, publish=publish
        )
        hook = getattr(computation, "on_value_selection", None)
        if hook is not None:
            computation.on_value_selection = self._notify_wrap(
                computation, hook
            )
        # finished() is the computation's completion signal (pyDCOP
        # agents.py:870 wraps it at deploy time).  Until graftproto's
        # proto-unsent-message rule flagged it, nothing wrapped it here,
        # so ComputationFinishedMessage was declared + handled but never
        # on the wire — the orchestrator could not observe completion.
        fin_hook = getattr(computation, "finished", None)
        if fin_hook is not None:
            computation.finished = self._finished_wrap(
                computation, fin_hook
            )
        event_bus.send(f"agents.add_computation.{self.name}", name)

    def _notify_wrap(self, computation, hook: Callable) -> Callable:
        def wrapped(value, cost):
            hook(value, cost)
            self.on_computation_value_changed(computation.name, value, cost)

        return wrapped

    def _finished_wrap(self, computation, hook: Callable) -> Callable:
        def wrapped():
            hook()
            self.on_computation_finished(computation.name)

        return wrapped

    def on_computation_value_changed(self, name: str, value, cost) -> None:
        """Overridden by orchestrated agents to push ValueChange messages."""

    def on_computation_finished(self, name: str) -> None:
        """Overridden by orchestrated agents to push ComputationFinished
        messages up to the orchestrator."""

    def _update_ticking(self, computation) -> None:
        # keyed by object identity, not name: a computation may be hosted
        # under an alias (add_computation's ``name`` parameter)
        if computation._periodic:
            self._ticking[id(computation)] = computation
        else:
            self._ticking.pop(id(computation), None)

    def remove_computation(self, name: str) -> None:
        comp = self._computations.pop(name, None)
        if comp is None:
            return
        self._ticking.pop(id(comp), None)
        if getattr(comp, "_periodic_registry_notify", None) is not None:
            comp._periodic_registry_notify = None
        if comp.is_running:
            comp.stop()
        self.messaging.unregister_computation(name)
        self.discovery.unregister_computation(name)
        event_bus.send(f"agents.rem_computation.{self.name}", name)

    def computation(self, name: str) -> MessagePassingComputation:
        try:
            return self._computations[name]
        except KeyError:
            raise UnknownComputation(
                f"{name} not hosted on {self.name}"
            ) from None

    @property
    def computations(self) -> List[MessagePassingComputation]:
        return list(self._computations.values())

    def run_computations(self, names: Optional[List[str]] = None) -> None:
        # a set: list membership per computation made starting 50k hosted
        # computations O(n^2) — the dominant cost of orchestrator.run at
        # 400k+ variables (sampled)
        wanted = None if names is None else set(names)
        for comp in self.computations:
            if wanted is None or comp.name in wanted:
                if not comp.is_running:
                    comp.start()

    def pause_computations(
        self, names: Optional[List[str]] = None, paused: bool = True
    ) -> None:
        """Pause/unpause hosted computations.  A blanket pause
        (``names=None`` — the repair freeze) applies only to ALGORITHM
        computations: control-plane endpoints (``_mgt_``, ``_discovery_``,
        ``_replication_`` — every "_"-prefixed name) must stay live, or
        the management computation pauses ITSELF and buffers the very
        Resume that would wake it — after the first repair the whole
        control plane (stop acks, metrics, replication rounds) was
        silently wedged forever."""
        wanted = None if names is None else set(names)
        for comp in self.computations:
            if wanted is None:
                if comp.name.startswith("_"):
                    continue
                comp.pause(paused)
            elif comp.name in wanted:
                comp.pause(paused)

    # ------------------------------------------------------------------
    # messaging
    # ------------------------------------------------------------------

    def _send_from_computation(
        self, sender_comp: str, dest_comp: str, msg: Message,
        prio: Optional[int],
    ) -> None:
        self.messaging.post_msg(sender_comp, dest_comp, msg, prio)

    def _run(self) -> None:
        logger.debug("agent %s thread started", self.name)
        self._t_started = time.perf_counter()
        self._on_start()
        self._started_evt.set()
        while not self._stopping.is_set() or (
            self._shutdown_clean and not self.messaging._queue.empty()
        ):
            item = self.messaging.next_msg(timeout=0.05)
            now = time.perf_counter()
            if item is not None:
                sender, dest, msg, t = item
                t0 = time.perf_counter()
                self._handle_message(sender, dest, msg, t)
                self.t_active += time.perf_counter() - t0
            # periodic actions have >= 10 ms granularity, and only the
            # ticking registry is scanned: iterating every hosted
            # computation here was O(hosted) per 10 ms, which starved
            # message processing during 100k+-computation deployments
            if now - self._last_tick >= 0.01:
                self._last_tick = now
                for comp in list(self._ticking.values()):
                    comp._tick(now)
            for p in self._periodic_cbs:
                if now - p["last"] >= p["period"]:
                    p["last"] = now
                    p["cb"]()
            if self._shutdown_clean and self.messaging._queue.empty():
                break
        self._on_stop()
        self._running = False
        logger.debug("agent %s thread stopped", self.name)

    def _handle_message(
        self, sender: str, dest: str, msg: Message, t: float
    ) -> None:
        comp = self._computations.get(dest)
        if comp is None:
            logger.warning(
                "%s: message for unknown computation %s (%s)",
                self.name, dest, msg.type,
            )
            return
        try:
            comp.on_message(sender, msg, t)
        except Exception:
            logger.exception(
                "%s: error handling %s message in %s",
                self.name, msg.type, dest,
            )

    def add_periodic_action(self, period: float, cb: Callable) -> None:
        """Run ``cb`` every ``period`` seconds on the agent loop.  Periods
        below the loop's 10 ms tick granularity are clamped rather than
        silently degraded."""
        self._periodic_cbs.append(
            {"period": max(period, 0.01), "cb": cb, "last": 0.0}
        )

    # hooks -------------------------------------------------------------

    def _on_start(self) -> None:
        """Runs on the agent thread before the loop (pyDCOP :591):
        register self in local discovery."""
        self.discovery.register_agent(
            self.name, self.communication.address, publish=False
        )

    def _on_stop(self) -> None:
        if tracer.enabled:
            tracer.instant(
                "agent.stop", cat="lifecycle", agent=self.name,
                clean=self._shutdown_clean,
            )
        for comp in self.computations:
            if comp.is_running:
                comp.stop()
        self.messaging.shutdown()

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        """Per-agent metrics in pyDCOP's shape (agents.py:717):
        cumulated external message count/size per computation + activity
        ratio."""
        elapsed = (
            time.perf_counter() - self._t_started if self._t_started else 0.0
        )
        return {
            "count_ext_msg": dict(self.messaging.count_ext_msg),
            "size_ext_msg": dict(self.messaging.size_ext_msg),
            "activity_ratio": self.t_active / elapsed if elapsed else 0.0,
            "cycles": {
                c.name: getattr(c, "cycle_count", getattr(c, "_cycle", 0))
                for c in self.computations
            },
        }

    def __repr__(self) -> str:
        return f"Agent({self.name})"


class AgentMetrics:
    """Event-bus subscriber aggregating value/cycle/message events (pyDCOP
    agents.py:878) — attach to observe a running system without touching the
    agents."""

    def __init__(self) -> None:
        self.value_events: List[Any] = []
        self.cycle_events: List[Any] = []
        event_bus.subscribe("computations.value.*", self._on_value)
        event_bus.subscribe("computations.cycle.*", self._on_cycle)

    def _on_value(self, topic: str, evt: Any) -> None:
        self.value_events.append((topic, evt, time.perf_counter()))

    def _on_cycle(self, topic: str, evt: Any) -> None:
        self.cycle_events.append((topic, evt, time.perf_counter()))

    def detach(self) -> None:
        event_bus.unsubscribe("computations.value.*", self._on_value)
        event_bus.unsubscribe("computations.cycle.*", self._on_cycle)
