"""Per-thread controls of a running solve.

The agent runtime runs solves on two threads of one process: the
orchestrator's ``device-solve`` thread runs the main solve, and the
thread that plays a scenario runs each repair's solve.  Two controls
follow a solve through the engine without a parameter on every solver's
signature, each set for the current thread only:

- ``stop_on(event)``: once ``event`` is set, the solve ends at its next
  look at the host (the engine between runs of chunks, the plain
  branch-and-bound between its chunks of steps), as a timeout ends it.
  The orchestrator sets it when ``run``'s timeout runs out, so the
  device solve ends and its thread can be joined.
- ``auxiliary()``: the solve is not the run's own; it neither binds the
  durability manager, nor writes checkpoints, nor takes a pending
  ``--resume`` (a repair solve that starts before the main solve binds
  must not claim its checkpoint trail).

And one for the whole process: ``second_solve()`` marks a repair in
progress, from its handshake to the end of its solve.  Meanwhile the
engine keeps few of a solve's chunk replays queued on the card
(``base.REPLAYS_IN_FLIGHT``), so that the main solve's thread leaves the
interpreter to the repair's; a solve that runs alone queues its runs of
chunks whole.

Stdlib only.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

__all__ = [
    "auxiliary", "is_auxiliary", "second_solve", "second_solve_live",
    "stop_on", "stop_requested",
]

_local = threading.local()
_second = [0]
_second_lock = threading.Lock()


@contextlib.contextmanager
def stop_on(event: Optional[threading.Event]) -> Iterator[None]:
    """Solves on this thread inside the block end early once ``event`` is
    set (None: no stop)."""
    prev = getattr(_local, "stop", None)
    _local.stop = event
    try:
        yield
    finally:
        _local.stop = prev


def stop_requested() -> bool:
    """Whether the current thread's solve was asked to stop."""
    event = getattr(_local, "stop", None)
    return event is not None and event.is_set()


@contextlib.contextmanager
def auxiliary() -> Iterator[None]:
    """Solves on this thread inside the block leave durability alone."""
    prev = getattr(_local, "auxiliary", False)
    _local.auxiliary = True
    try:
        yield
    finally:
        _local.auxiliary = prev


def is_auxiliary() -> bool:
    return getattr(_local, "auxiliary", False)


@contextlib.contextmanager
def second_solve() -> Iterator[None]:
    """A second solve runs beside the main one while the block runs."""
    with _second_lock:
        _second[0] += 1
    try:
        yield
    finally:
        with _second_lock:
            _second[0] -= 1


def second_solve_live() -> bool:
    return _second[0] > 0
