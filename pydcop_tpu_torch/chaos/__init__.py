"""Deterministic, seeded fault injection.

The port's counterpart of ``pydcop_tpu/chaos/``:

- :class:`FaultSchedule` (schedule.py): YAML or programmatic fault
  events (timed agent and process kills, message drop/delay/duplicate/
  reorder, transport errors, one-shot device-step faults) under one seed.
- :class:`ChaosController` (controller.py): live decisions and the
  deterministic fault event log (the same for the same seed and
  schedule, however threads race), and the kill timeline.

Surface: ``--fault-schedule`` on ``solve`` (process kills around a
durable solve) and ``serve`` (tenant kills and delays), and
``chaos.events`` in the metrics registry.  The JAX package's
``ChaosCommunicationLayer`` wraps its agent runtime's message layer,
which the port does not have.
"""

from .controller import ChaosController, FaultDecision
from .schedule import (
    DeviceFault,
    FaultSchedule,
    KillEvent,
    KillProcessEvent,
    MessageRule,
    load_fault_schedule,
    unit_draw,
)

__all__ = [
    "ChaosController",
    "DeviceFault",
    "FaultDecision",
    "FaultSchedule",
    "KillEvent",
    "KillProcessEvent",
    "MessageRule",
    "load_fault_schedule",
    "unit_draw",
]
