"""Fault schedules: the declarative half of the chaos layer.

The port's copy of ``pydcop_tpu/chaos/schedule.py``.  A
:class:`FaultSchedule` is a seed plus a list of fault events: timed
crashes (*kill agent a2 at t=0.2s*, *kill this process at t=5s*),
message-stream rules (*drop messages matching a pattern with probability
p*, delay, duplicate, reorder, transport errors) and one-shot device-step
faults.  Schedules load from YAML (``--fault-schedule``) or are built in
code.

Determinism: probabilistic decisions are NOT drawn from a shared PRNG
stream, where thread interleaving would change which message consumes
which draw.  Every decision is a keyed hash of ``(seed, rule, message
stream, per-stream sequence number)`` (:func:`unit_draw`), so the
decision for the n-th message of a given (src, dest, type) stream is a
pure function of the schedule, and the fault event log sorted by (stream,
n) is the same across runs with the same seed and schedule, however the
threads race.

Standard library only, but for the YAML loader (PyYAML).
"""

from __future__ import annotations

import fnmatch
import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

__all__ = [
    "KillEvent",
    "KillProcessEvent",
    "MessageRule",
    "DeviceFault",
    "FaultSchedule",
    "load_fault_schedule",
    "unit_draw",
    "MESSAGE_ACTIONS",
]

#: message-stream actions a rule may apply
MESSAGE_ACTIONS = ("drop", "delay", "duplicate", "reorder", "transport_error")


def unit_draw(seed: int, stream: str, n: int) -> float:
    """Deterministic uniform draw in [0, 1) keyed by (seed, stream, n).

    blake2b keeps this stable across processes and Python versions
    (``hash()`` is salted per process and would break replay)."""
    digest = hashlib.blake2b(
        f"{seed}|{stream}|{n}".encode("utf-8"), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / 2**64


@dataclass(frozen=True)
class KillEvent:
    """Crash ``agent`` abruptly ``at`` seconds after the run starts: no
    clean shutdown, no queue draining, inbound transport dies with it.
    The orchestrator then repairs the orphans like any real failure."""

    agent: str
    at: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"kill": self.agent, "at": self.at}


@dataclass(frozen=True)
class KillProcessEvent:
    """Kill THIS WHOLE PROCESS abruptly ``at`` seconds after the run
    starts: ``os._exit(exit_code)`` — no atexit hooks, no stream
    flushing, no queue draining.  The crash model of a durable solve's
    kill and resume: everything that should survive must already be on
    disk, which is what the atomic checkpoint writes guarantee.  Default
    exit code 137 mirrors a SIGKILL death."""

    at: float = 0.0
    exit_code: int = 137

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kill_process": True, "at": self.at,
            "exit_code": self.exit_code,
        }


@dataclass(frozen=True)
class MessageRule:
    """A message-stream fault active for the whole run.

    ``action``: one of :data:`MESSAGE_ACTIONS`.  ``pattern`` fnmatch-es
    the message *type*; ``dest``/``src`` optionally fnmatch the
    destination/sender computation names.  ``p`` is the per-message
    firing probability (decided by :func:`unit_draw`); ``count`` caps
    total firings (globally, first-come — only deterministic when the
    rule matches a single stream); ``seconds`` sizes delays (``delay``
    sleeps exactly ``seconds``; ``reorder`` sleeps ``seconds * draw`` so
    racing senders interleave differently)."""

    action: str
    pattern: str = "*"
    dest: Optional[str] = None
    src: Optional[str] = None
    p: float = 1.0
    count: Optional[int] = None
    seconds: float = 0.05

    def __post_init__(self) -> None:
        if self.action not in MESSAGE_ACTIONS:
            raise ValueError(
                f"invalid fault action {self.action!r}: "
                f"expected one of {MESSAGE_ACTIONS}"
            )
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"probability p={self.p} outside [0, 1]")

    def matches(
        self, src_comp: str, dest_comp: str, msg_type: str
    ) -> bool:
        if not fnmatch.fnmatchcase(msg_type, self.pattern):
            return False
        if self.dest is not None and not fnmatch.fnmatchcase(
            dest_comp, self.dest
        ):
            return False
        if self.src is not None and not fnmatch.fnmatchcase(
            src_comp, self.src
        ):
            return False
        return True

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {self.action: self.pattern, "p": self.p}
        if self.dest is not None:
            out["dest"] = self.dest
        if self.src is not None:
            out["src"] = self.src
        if self.count is not None:
            out["count"] = self.count
        if self.action in ("delay", "reorder"):
            out["seconds"] = self.seconds
        return out


@dataclass(frozen=True)
class DeviceFault:
    """Fail the next ``count`` device solve steps once each (the
    orchestrator's device-solve retry absorbs them)."""

    count: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return {"device_fault": self.count}


FaultEvent = Union[KillEvent, KillProcessEvent, MessageRule, DeviceFault]


@dataclass
class FaultSchedule:
    """A seed + fault events; see the module docstring for determinism."""

    seed: int = 0
    events: List[FaultEvent] = field(default_factory=list)

    @property
    def kills(self) -> List[KillEvent]:
        return [e for e in self.events if isinstance(e, KillEvent)]

    @property
    def process_kills(self) -> List[KillProcessEvent]:
        return [
            e for e in self.events if isinstance(e, KillProcessEvent)
        ]

    @property
    def rules(self) -> List[MessageRule]:
        return [e for e in self.events if isinstance(e, MessageRule)]

    @property
    def device_faults(self) -> int:
        return sum(
            e.count for e in self.events if isinstance(e, DeviceFault)
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seed": self.seed,
            "events": [e.to_dict() for e in self.events],
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "FaultSchedule":
        if not isinstance(data, dict):
            raise ValueError(
                f"fault schedule must be a mapping, got {type(data).__name__}"
            )
        events: List[FaultEvent] = []
        for i, raw in enumerate(data.get("events") or []):
            events.append(_parse_event(raw, i))
        return cls(seed=int(data.get("seed", 0)), events=events)


def _parse_event(raw: Dict[str, Any], index: int) -> FaultEvent:
    if not isinstance(raw, dict):
        raise ValueError(f"event {index}: must be a mapping, got {raw!r}")
    if "kill_process" in raw:
        # accept `kill_process: true` + `at: T` and the `kill_process: T`
        # shorthand; `kill_process: false`/empty must NOT silently mean
        # "kill at t=0" — a templated schedule toggling the event off
        # would nuke the process instead
        kp = raw["kill_process"]
        if kp is None or kp is False:
            raise ValueError(
                f"event {index}: kill_process must be true or a time "
                f"in seconds (got {kp!r}); delete the event to disable it"
            )
        at = raw.get("at")
        if at is None and isinstance(kp, (int, float)) and not isinstance(
            kp, bool
        ):
            at = kp
        return KillProcessEvent(
            at=float(at or 0.0), exit_code=int(raw.get("exit_code", 137))
        )
    if "kill" in raw:
        return KillEvent(
            agent=str(raw["kill"]), at=float(raw.get("at", 0.0))
        )
    if "device_fault" in raw:
        return DeviceFault(count=int(raw["device_fault"]))
    for action in MESSAGE_ACTIONS:
        if action in raw:
            return MessageRule(
                action=action,
                pattern=str(raw[action]),
                dest=raw.get("dest"),
                src=raw.get("src"),
                p=float(raw.get("p", 1.0)),
                count=(
                    int(raw["count"]) if raw.get("count") is not None
                    else None
                ),
                seconds=float(raw.get("seconds", 0.05)),
            )
    raise ValueError(
        f"event {index}: unknown fault kind in {sorted(raw)} — expected "
        f"'kill', 'kill_process', 'device_fault' or one of "
        f"{MESSAGE_ACTIONS}"
    )


def load_fault_schedule(source: str) -> FaultSchedule:
    """A schedule from a YAML file path or an inline YAML string."""
    import os

    import yaml

    text = source
    if os.path.exists(source):
        with open(source, "r", encoding="utf-8") as f:
            text = f.read()
    data = yaml.safe_load(text)
    if isinstance(data, str):
        raise ValueError(
            f"fault schedule {source!r}: not a mapping (is the path right?)"
        )
    return FaultSchedule.from_dict(data or {})
