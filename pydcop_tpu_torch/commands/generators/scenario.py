"""Scenario generator: random agent-removal event streams.

The port's copy of ``pydcop_tpu/commands/generators/scenario.py``: an
initial delay, then ``evts_count`` removal events (each removing
``actions_count`` distinct agents) separated by ``delay`` seconds, and a
final delay.  ``remove_agent`` events belong to the agent runtime; the
port's ``ScenarioSession`` refuses them, as the JAX package's does.
"""

from __future__ import annotations

import random
from typing import List

from ...dcop.scenario import DcopEvent, EventAction, Scenario

__all__ = ["generate_scenario"]


def generate_scenario(
    evts_count: int,
    actions_count: int,
    delay: float,
    initial_delay: float,
    end_delay: float,
    agents: List[str],
    seed: int = 0,
) -> Scenario:
    rng = random.Random(seed)
    remaining = set(agents)
    events: List[DcopEvent] = [DcopEvent("init", delay=initial_delay)]
    for i in range(evts_count):
        if len(remaining) < actions_count:
            break
        removed = rng.sample(sorted(remaining), actions_count)
        remaining.difference_update(removed)
        events.append(
            DcopEvent(
                f"e{i}",
                actions=[
                    EventAction("remove_agent", agent=a) for a in removed
                ],
            )
        )
        if i != evts_count - 1:
            events.append(DcopEvent(f"d{i}", delay=delay))
    events.append(DcopEvent("end", delay=end_delay))
    return Scenario(events)
