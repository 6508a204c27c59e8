"""Message-passing computation substrate (host side).

The port's copy of ``pydcop_tpu/infrastructure/computations.py``:
``Message``/``message_type``, handler registration with ``@register``
and a collecting metaclass, the ``MessagePassingComputation`` lifecycle
with pause buffering and periodic actions, the
``SynchronousComputationMixin``, ``DcopComputation``/
``VariableComputation``, the ``DeviceShardComputation`` stand-in and
``build_computation``.

The substrate carries control-plane traffic only (registration,
deployment, metrics, discovery): the algorithm's cycles run on the card
as replays of captured CUDA graphs under the orchestrator, where a
"message" is a row of a tensor and never touches these classes.  Stdlib
only, and nothing here loads an algorithm module on a deploy: an agent
process hosts its computations without importing torch.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..algorithms import ComputationDef
from ..utils.simple_repr import SimpleRepr
from . import stats
from .events import event_bus

__all__ = [
    "Message",
    "message_type",
    "register",
    "ComputationException",
    "MessagePassingComputation",
    "SynchronousComputationMixin",
    "SynchronizationMsg",
    "DcopComputation",
    "VariableComputation",
    "build_computation",
]

logger = logging.getLogger("pydcop_tpu_torch.infrastructure.computations")


class ComputationException(Exception):
    pass


class Message(SimpleRepr):
    """Base message: a type tag + optional content.  ``size`` feeds the
    communication metrics (pyDCOP computations.py:53-121)."""

    _repr_fields = ("msg_type", "content")

    def __init__(self, msg_type: str, content: Any = None) -> None:
        self._msg_type = msg_type
        self._content = content

    @property
    def type(self) -> str:
        return self._msg_type

    @property
    def msg_type(self) -> str:
        return self._msg_type

    @property
    def content(self) -> Any:
        return self._content

    @property
    def size(self) -> int:
        return 1

    @classmethod
    def _from_repr(cls, msg_type, content):
        return cls(msg_type, content)

    def __repr__(self) -> str:
        return f"Message({self._msg_type}, {self._content})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Message)
            and self.type == other.type
            and self.content == other.content
        )


class _MsgRegistry:
    """Attribute bag holding every ``message_type``-created class so that
    ``from_repr`` can resolve them by qualname
    (``_msg_registry.<type_name>``) — dynamic classes are not module-level
    names in their defining module."""


_msg_registry = _MsgRegistry()


def message_type(name: str, fields: List[str]):
    """Class factory for message types (pyDCOP computations.py:122):

        ValueMsg = message_type("value", ["value", "cost"])
        m = ValueMsg(value=3, cost=1.5); m.value, m.type
    """
    existing = getattr(_msg_registry, name, None)
    if existing is not None:
        if tuple(existing._repr_fields) != tuple(fields):
            raise ValueError(
                f"message type {name!r} already defined with fields "
                f"{existing._repr_fields}"
            )
        return existing

    field_set = frozenset(fields)
    slots = tuple(("_" + f, f) for f in fields)

    def __init__(self, *args, **kwargs):
        if not args and kwargs.keys() == field_set:
            # the common call, every field by keyword: nothing to check
            # (a deployment builds three messages a computation)
            self._msg_type = name
            self._content = None
            for attr, f in slots:
                setattr(self, attr, kwargs[f])
            return
        named = dict(zip(fields, args))
        overlap = set(named) & set(kwargs)
        if overlap:
            raise TypeError(f"duplicate argument(s) {sorted(overlap)}")
        named.update(kwargs)
        unknown = set(named) - set(fields)
        if unknown:
            raise TypeError(f"unexpected argument(s) {sorted(unknown)}")
        missing = set(fields) - set(named)
        if missing:
            raise TypeError(f"missing argument(s) {sorted(missing)}")
        Message.__init__(self, name, None)
        for f in fields:
            setattr(self, "_" + f, named[f])

    def _make_prop(f):
        return property(lambda self: getattr(self, "_" + f))

    def _size(self) -> int:
        total = 0
        for f in fields:
            v = getattr(self, "_" + f)
            try:
                total += len(v)
            except TypeError:
                total += 1
        return total

    def _eq(self, other) -> bool:
        return type(other).__name__ == type(self).__name__ and all(
            getattr(other, f, None) == getattr(self, f) for f in fields
        )

    namespace: Dict[str, Any] = {
        "__init__": __init__,
        "_repr_fields": tuple(fields),
        "size": property(_size),
        "__eq__": _eq,
        "__hash__": None,
        "__repr__": lambda self: (
            name
            + "("
            + ", ".join(f"{f}={getattr(self, f)!r}" for f in fields)
            + ")"
        ),
    }
    for f in fields:
        namespace[f] = _make_prop(f)
    cls = type(name, (Message,), namespace)
    cls._from_repr = classmethod(lambda c, **kw: c(**kw))
    cls.__module__ = __name__
    cls.__qualname__ = f"_msg_registry.{name}"
    setattr(_msg_registry, name, cls)
    return cls


def register(msg_type: str):
    """Decorator marking a method as the handler for ``msg_type`` messages
    (pyDCOP computations.py:576)."""

    def deco(fn):
        fn._handles_msg_type = msg_type
        return fn

    return deco


class _HandlerCollector(type):
    """Metaclass collecting ``@register``-decorated handlers into
    ``_msg_handlers`` (pyDCOP ComputationMetaClass:237)."""

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        handlers: Dict[str, Callable] = {}
        for base in reversed(cls.__mro__):
            for attr in vars(base).values():
                t = getattr(attr, "_handles_msg_type", None)
                if t is not None:
                    handlers[t] = attr
        cls._msg_handlers = handlers
        return cls


class MessagePassingComputation(metaclass=_HandlerCollector):
    """A named computation that receives messages through ``on_message`` and
    sends through a pluggable ``message_sender`` (wired by the hosting Agent).

    Lifecycle: ``start`` -> (``pause``/``unpause``) -> ``stop``.  While paused,
    incoming and outgoing messages are buffered and delivered on unpause
    (pyDCOP computations.py:304-305,517-544).  Computations are
    single-threaded by design — the hosting agent serializes all calls — so no
    handler needs to be thread-safe (pyDCOP :279-281).
    """

    def __init__(self, name: str) -> None:
        self._name = name
        self._running = False
        self._paused = False
        self._stopped = False
        self._msg_sender: Optional[Callable] = None
        self._paused_in: List[Tuple[str, Message, float]] = []
        self._paused_out: List[Tuple[str, Message, int]] = []
        self._periodic: List[Dict[str, Any]] = []
        self.msg_count = 0

    # -- identity ------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def is_paused(self) -> bool:
        return self._paused

    @property
    def message_sender(self) -> Optional[Callable]:
        return self._msg_sender

    @message_sender.setter
    def message_sender(self, sender: Callable) -> None:
        if self._msg_sender is not None and sender is not self._msg_sender:
            raise AttributeError("message_sender can only be set once")
        self._msg_sender = sender

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self._running = True
        self.on_start()

    def stop(self) -> None:
        self._running = False
        self._stopped = True
        self.on_stop()

    def pause(self, paused: bool = True) -> None:
        was = self._paused
        self._paused = paused
        if was and not paused:
            out, self._paused_out = self._paused_out, []
            for target, msg, prio in out:
                self.post_msg(target, msg, prio)
            inc, self._paused_in = self._paused_in, []
            for sender, msg, t in inc:
                self.on_message(sender, msg, t)

    def on_start(self) -> None:  # override points
        pass

    def on_stop(self) -> None:
        pass

    def on_pause(self, paused: bool) -> None:
        pass

    def finished(self) -> None:
        """Signal completion to the hosting agent (wrapped with notification
        hooks at deploy, pyDCOP agents.py:870)."""

    # -- messaging -----------------------------------------------------

    def on_message(self, sender: str, msg: Message, t: float) -> None:
        if self._paused:
            self._paused_in.append((sender, msg, t))
            return
        self.msg_count += 1
        # ``computations.message_rcv.<name>`` is published by the transport
        # (communication.py deliver_local), not here: publishing per layer
        # would double-count every message for bus subscribers
        handler = self._msg_handlers.get(msg.type)
        if handler is None:
            raise ComputationException(
                f"computation {self.name} has no handler for message "
                f"type {msg.type!r}"
            )
        # per-step trace row (pyDCOP stats.py:47-103 schema): one
        # handled message = one step; duration measured around the
        # handler, size from the message's own accounting.  cycle_count
        # is the synchronous mixin's integer round counter (plain async
        # computations have no rounds: 0)
        traced = stats.trace_active()
        t0 = time.perf_counter() if traced else 0.0
        handler(self, sender, msg, t)
        if traced:
            stats.trace_computation(
                self.name,
                int(getattr(self, "cycle_count", 0) or 0),
                time.perf_counter() - t0,
                msg_count=1,
                msg_size=getattr(msg, "size", 0) or 0,
            )

    def post_msg(
        self, target: str, msg: Message, prio: Optional[int] = None
    ) -> None:
        if self._paused:
            self._paused_out.append((target, msg, prio))
            return
        if self._msg_sender is None:
            raise ComputationException(
                f"computation {self.name} is not hosted: no message sender"
            )
        # ``computations.message_snd.<name>`` is published by the transport
        # (communication.py post_msg), which this sender routes into
        self._msg_sender(self.name, target, msg, prio)

    # -- periodic actions ---------------------------------------------

    def add_periodic_action(self, period: float, cb: Callable) -> Callable:
        """Register ``cb`` to run every ``period`` seconds while running; the
        hosting agent's loop drives these (pyDCOP computations.py:546).

        Granularity is 10 ms: the agent loop ticks computations at most
        every 0.01 s (agents.py agent loop), so shorter periods are
        clamped — they would silently degrade to the tick rate anyway."""
        self._periodic.append(
            {"period": max(period, 0.01), "cb": cb, "last": 0.0}
        )
        self._notify_periodic_registry()
        return cb

    def remove_periodic_action(self, cb: Callable) -> None:
        self._periodic = [p for p in self._periodic if p["cb"] is not cb]
        self._notify_periodic_registry()

    def _notify_periodic_registry(self) -> None:
        # the hosting agent keeps a registry of computations with periodic
        # actions so its 10 ms tick never scans every hosted computation
        # (agents.py add_computation)
        notify = getattr(self, "_periodic_registry_notify", None)
        if notify is not None:
            notify(self)

    def _tick(self, now: float) -> None:
        if not self._running or self._paused:
            return
        for p in self._periodic:
            if now - p["last"] >= p["period"]:
                p["last"] = now
                p["cb"]()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name})"


SynchronizationMsg = message_type("_sync", ["cycle_id"])


class SynchronousComputationMixin:
    """Round-based (BSP) execution emulated on the async substrate.

    Parity with pyDCOP's mixin (computations.py:633): every algorithm
    message is stamped with the sender's ``cycle_id``; a computation switches
    to cycle ``c+1`` once it holds one message from every neighbor for cycle
    ``c``, sending ``SynchronizationMsg`` padding to neighbors it has nothing
    to say to.  Messages one cycle ahead are buffered; skew beyond one cycle
    raises (a protocol race, pyDCOP :698-725).

    On the device solve this machinery is unnecessary (one replay of the
    solve's graphs IS the round), so the mixin only serves host-side
    protocols and tests.
    """

    @property
    def cycle_count(self) -> int:
        return getattr(self, "_cycle_count", 0)

    @property
    def current_cycle(self) -> Dict[str, Message]:
        return getattr(self, "_cycle_msgs", {})

    def synchronized_neighbors(self) -> List[str]:
        """Neighbor computation names participating in the rounds."""
        raise NotImplementedError

    def start_cycle(self) -> None:
        self._cycle_count = getattr(self, "_cycle_count", 0)
        self._cycle_msgs: Dict[str, Message] = {}
        self._next_msgs: Dict[str, Message] = {}
        self._sent_this_cycle: set = set()

    def post_sync_msg(
        self, target: str, msg: Message, prio: Optional[int] = None
    ) -> None:
        """Send an algorithm message stamped with the current cycle."""
        msg._cycle_id = self.cycle_count
        self._sent_this_cycle.add(target)
        self.post_msg(target, msg, prio)

    def _pad_sync(self) -> None:
        for n in self.synchronized_neighbors():
            if n not in self._sent_this_cycle:
                m = SynchronizationMsg(cycle_id=self.cycle_count)
                m._cycle_id = self.cycle_count
                self.post_msg(n, m)
        self._sent_this_cycle = set()

    @register("_sync")
    def _on_sync_padding(self, sender: str, msg: Message, t: float) -> None:
        """Default route for bare ``_sync`` padding messages: they carry no
        algorithm payload, so every mixin user buffers them the same way.
        (Before this handler existed the padding was silently dropped
        unless each concrete computation re-registered ``_sync`` itself —
        the exact protocol hole graftlint's proto-unhandled-message rule
        flagged.)  Concrete classes may still override with their own
        ``@register("_sync")`` handler; the collector keeps the subclass
        one."""
        if not hasattr(self, "_cycle_msgs"):
            # padding for a round protocol this computation never started
            # (start_cycle not called): drop it loudly instead of
            # crashing the agent thread
            logger.warning(
                "%s: _sync padding from %s before start_cycle()",
                self.name, sender,
            )
            return
        self.on_sync_message(sender, msg, t)

    def on_sync_message(self, sender: str, msg: Message, t: float) -> None:
        """Route an incoming algorithm message into the cycle buffers; call
        from the concrete computation's handlers."""
        cycle_id = getattr(msg, "_cycle_id", self.cycle_count)
        if cycle_id == self.cycle_count:
            if sender in self._cycle_msgs:
                raise ComputationException(
                    f"{self.name}: two messages from {sender} in cycle "
                    f"{self.cycle_count}"
                )
            self._cycle_msgs[sender] = msg
        elif cycle_id == self.cycle_count + 1:
            if sender in self._next_msgs:
                raise ComputationException(
                    f"{self.name}: two messages from {sender} in cycle "
                    f"{cycle_id}"
                )
            self._next_msgs[sender] = msg
        else:
            raise ComputationException(
                f"{self.name}: message from {sender} for cycle {cycle_id} "
                f"while in cycle {self.cycle_count} (skew > 1)"
            )
        if set(self._cycle_msgs) >= set(self.synchronized_neighbors()):
            cycle_msgs = self._cycle_msgs
            self._cycle_count += 1
            self._cycle_msgs = self._next_msgs
            self._next_msgs = {}
            event_bus.send(
                f"computations.cycle.{self.name}", self._cycle_count
            )
            self.on_new_cycle(cycle_msgs, self._cycle_count)
            self._pad_sync()

    def on_new_cycle(self, messages: Dict[str, Message], cycle_id: int):
        """Called once per completed round with that round's messages."""
        raise NotImplementedError


class DcopComputation(MessagePassingComputation):
    """A computation attached to a node of a computation graph (pyDCOP
    computations.py:832): knows its neighbors and footprint."""

    def __init__(self, name: str, comp_def: Optional[ComputationDef]) -> None:
        super().__init__(name)
        self.computation_def = comp_def
        self._cycle = 0

    @property
    def neighbors(self) -> List[str]:
        if self.computation_def is None:
            return []
        return list(self.computation_def.node.neighbors)

    def footprint(self) -> float:
        """Memory footprint from the algorithm module's ``computation_memory``
        (pyDCOP computations.py:1019-1056)."""
        if self.computation_def is None:
            return 0.0
        from ..algorithms import load_algorithm_module

        mod = load_algorithm_module(self.computation_def.algo.algo)
        fn = getattr(mod, "computation_memory", None)
        if fn is None:
            return 0.0
        try:
            return float(fn(self.computation_def.node))
        except (NotImplementedError, ValueError):
            return 0.0

    def new_cycle(self) -> None:
        self._cycle += 1
        event_bus.send(f"computations.cycle.{self.name}", self._cycle)

    def post_to_all_neighbors(
        self, msg: Message, prio: Optional[int] = None
    ) -> None:
        for n in self.neighbors:
            self.post_msg(n, msg, prio)


class VariableComputation(DcopComputation):
    """A computation responsible for selecting one variable's value
    (pyDCOP computations.py:967).  ``value_selection`` fires the event bus
    and the agent's notification hooks."""

    def __init__(self, variable, comp_def: Optional[ComputationDef] = None):
        name = variable.name if comp_def is None else comp_def.node.name
        super().__init__(name, comp_def)
        self._variable = variable
        self.current_value: Any = None
        self.current_cost: Optional[float] = None
        self._previous_values: List[Any] = []

    @property
    def variable(self):
        return self._variable

    @property
    def previous_values(self) -> List[Any]:
        return list(self._previous_values)

    def value_selection(self, value: Any, cost: float = 0.0) -> None:
        if value != self.current_value:
            self._previous_values.append(self.current_value)
        self.current_value = value
        self.current_cost = cost
        event_bus.send(
            f"computations.value.{self.name}", (value, cost)
        )
        self.on_value_selection(value, cost)

    def on_value_selection(self, value: Any, cost: float) -> None:
        """Hook wrapped by the hosting agent to push ValueChange messages to
        the orchestrator (pyDCOP agents.py:870)."""


class DeviceShardComputation(DcopComputation):
    """Host-side stand-in for a computation whose algorithm executes on
    device.

    In pyDCOP, deploying a ComputationDef instantiates a python object
    that will run the algorithm (computations.py:1156).  Here the algorithm
    advances as batched device arrays; the deployed object only (a) anchors
    the computation in discovery/metrics/distribution bookkeeping and (b)
    receives the per-cycle value readbacks the orchestrator publishes, so the
    rest of the control plane (UI, metrics modes, repair) sees exactly the
    same events as in pyDCOP.
    """

    current_value: Any = None
    current_cost: Optional[float] = None

    @register("value_readback")
    def _on_value_readback(self, sender: str, msg: Message, t: float) -> None:
        value, cost = msg.content
        self.current_value = value
        self.current_cost = cost
        event_bus.send(f"computations.value.{self.name}", (value, cost))
        self.on_value_selection(value, cost)

    def on_value_selection(self, value: Any, cost: float) -> None:
        """Hook wrapped by the hosting agent (same contract as
        VariableComputation.on_value_selection)."""


def build_computation(comp_def: ComputationDef) -> MessagePassingComputation:
    """Instantiate the computation for a deployed ComputationDef: a
    DeviceShardComputation placeholder, since the algorithm itself runs on
    the card under the orchestrator.  The JAX package first asks the
    algorithm module for a host-side ``build_computation``; no algorithm
    of either package exports one, and importing a port's algorithm
    module imports torch, so the port's agents skip the lookup: a deploy
    imports nothing beyond this package's host-only modules."""
    return DeviceShardComputation(comp_def.node.name, comp_def)
