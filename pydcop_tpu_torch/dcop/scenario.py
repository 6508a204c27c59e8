"""Dynamic-DCOP scenarios: timed events that change the problem.

Counterpart of ``pydcop_tpu/dcop/scenario.py``, copied (the YAML loader
reads and writes them).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from ..utils.simple_repr import SimpleRepr

__all__ = ["EventAction", "DcopEvent", "Scenario"]


class EventAction(SimpleRepr):
    """A single action: type + free-form args (e.g. agent name)."""

    _repr_fields = ("type", "args")

    def __init__(self, type: str, **args: Any) -> None:  # noqa: A002
        self._type = type
        self._args = dict(args)

    @property
    def type(self) -> str:
        return self._type

    @property
    def args(self) -> Dict[str, Any]:
        return dict(self._args)

    @classmethod
    def _from_repr(cls, type, args):  # noqa: A002
        return cls(type, **args)

    def __eq__(self, other):
        return (
            isinstance(other, EventAction)
            and other._type == self._type
            and other._args == self._args
        )

    def __repr__(self) -> str:
        return f"EventAction({self._type}, {self._args})"


class DcopEvent(SimpleRepr):
    """An event: either a delay (seconds) or a list of actions."""

    _repr_fields = ("id", "delay", "actions")

    def __init__(
        self,
        id: str,  # noqa: A002
        delay: Optional[float] = None,
        actions: Optional[List[EventAction]] = None,
    ) -> None:
        self._id = id
        self._delay = delay
        self._actions = list(actions) if actions else None

    @property
    def id(self) -> str:
        return self._id

    @property
    def delay(self) -> Optional[float]:
        return self._delay

    @property
    def actions(self) -> Optional[List[EventAction]]:
        return list(self._actions) if self._actions is not None else None

    @property
    def is_delay(self) -> bool:
        return self._delay is not None

    @classmethod
    def _from_repr(cls, id, delay=None, actions=None):  # noqa: A002
        return cls(id, delay, actions)

    def __eq__(self, other):
        return (
            isinstance(other, DcopEvent)
            and other._id == self._id
            and other._delay == self._delay
            and other._actions == self._actions
        )

    def __repr__(self) -> str:
        kind = f"delay {self._delay}" if self.is_delay else self._actions
        return f"DcopEvent({self._id}, {kind})"


class Scenario(SimpleRepr):
    """An ordered list of events injected during a dynamic run."""

    _repr_fields = ("events",)

    def __init__(self, events: Optional[Iterable[DcopEvent]] = None) -> None:
        self._events = list(events) if events else []

    @property
    def events(self) -> List[DcopEvent]:
        return list(self._events)

    def add_event(self, event: DcopEvent) -> None:
        self._events.append(event)

    def __iter__(self):
        return iter(self._events)

    def __len__(self) -> int:
        return len(self._events)

    @classmethod
    def _from_repr(cls, events):
        return cls(events)

    def __eq__(self, other):
        return isinstance(other, Scenario) and other._events == self._events
