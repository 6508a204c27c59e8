"""Meeting-scheduling benchmark generator (PEAV model).

Counterpart of ``pydcop_tpu/commands/generators/meetingscheduling.py``,
copied: the same ``random.Random`` calls in the same order, so one seed
gives the same DCOP in both packages.  Resources have a per-slot "value if
kept free"; events need a subset of resources, with a value for each and
a length.  In the PEAV encoding each resource is an agent controlling one
variable per event it may attend (domain = start slot, 0 = not
scheduled).  Intra-agent constraints penalize overlapping schedules and
carry the scheduling utility; inter-agent equality constraints penalize
resources that disagree on an event's start.  The objective is ``max``.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ...dcop.dcop import DCOP
from ...dcop.objects import AgentDef, Domain, Variable
from ...dcop.relations import NAryMatrixRelation

__all__ = [
    "Resource",
    "Event",
    "generate_problem_definition",
    "generate_meeting_scheduling",
]


@dataclass
class Resource:
    id: int
    value_free: Dict[int, int]  # slot -> value if kept free


@dataclass
class Event:
    id: int
    resources: Dict[int, int]  # resource id -> value of attending
    length: int


def generate_problem_definition(
    slots_count: int,
    resources_count: int,
    max_resource_value: int,
    events_count: int,
    max_length_event: int,
    max_resources_event: int,
    rng: random.Random,
) -> Tuple[List[int], Dict[int, Event], Dict[int, Resource]]:
    """Random multi-event scheduling instance (reference :368-437)."""
    slots = list(range(1, slots_count + 1))
    resources = {
        i: Resource(
            i, {s: rng.randint(0, max_resource_value) for s in slots}
        )
        for i in range(resources_count)
    }
    events: Dict[int, Event] = {}
    for i in range(events_count):
        length = rng.randint(1, max_length_event)
        k = rng.randint(1, max_resources_event)
        chosen = rng.sample(sorted(resources), min(k, len(resources)))
        values = {r: rng.randint(1, max_resource_value) for r in chosen}
        events[i] = Event(i, values, length)
    return slots, events, resources


def _value_for_event(res: Resource, evt: Event, t: int) -> float:
    """Utility of scheduling ``res`` on ``evt`` at slot ``t`` — event value
    minus the forgone free-slot values (reference :603-630)."""
    if t == 0:
        return 0.0
    evt_value = evt.resources[res.id] * evt.length
    free_value = sum(res.value_free[t + j] for j in range(evt.length))
    return float(evt_value - free_value)


def generate_meeting_scheduling(
    slots_count: int = 5,
    resources_count: int = 3,
    max_resource_value: int = 10,
    events_count: int = 3,
    max_length_event: int = 2,
    max_resources_event: int = 2,
    penalty: int = 100,
    seed: int = 0,
) -> DCOP:
    """Full PEAV DCOP for a random instance."""
    rng = random.Random(seed)
    slots, events, resources = generate_problem_definition(
        slots_count,
        resources_count,
        max_resource_value,
        events_count,
        max_length_event,
        max_resources_event,
        rng,
    )
    dcop = DCOP(
        f"MeetingScheduling_{slots_count}_{resources_count}_{events_count}",
        "max",
    )

    variables: Dict[Tuple[int, int], Variable] = {}
    agents: List[AgentDef] = []
    for res in resources.values():
        res_vars: Dict[Tuple[int, int], Variable] = {}
        for evt in events.values():
            if res.id not in evt.resources:
                continue
            name = f"v_{res.id:02d}_{evt.id:02d}"
            # domain = start slot; 0 means "not scheduled"; an event of
            # length L can start no later than slots_count - L + 1
            dom = Domain(
                f"d_{name}",
                "time_slot",
                list(range(0, slots_count - evt.length + 2)),
            )
            v = Variable(name, dom)
            res_vars[(res.id, evt.id)] = v
            dcop.add_variable(v)
        variables.update(res_vars)
        agents.append(AgentDef(f"a_{res.id}"))

        # intra-agent constraints: conflicts + utilities (reference :503)
        keys = sorted(res_vars)
        n_evts = len(keys)
        for (r1, e1), (r2, e2) in itertools.combinations(keys, 2):
            v1, v2 = res_vars[(r1, e1)], res_vars[(r2, e2)]
            evt1, evt2 = events[e1], events[e2]
            table = np.zeros((len(v1.domain), len(v2.domain)))
            for i1, t1 in enumerate(v1.domain.values):
                for i2, t2 in enumerate(v2.domain.values):
                    overlap = (
                        t1 != 0
                        and t2 != 0
                        and (
                            t1 <= t2 <= t1 + evt1.length - 1
                            or t2 <= t1 <= t2 + evt2.length - 1
                        )
                    )
                    if overlap:
                        table[i1, i2] = -penalty
                    else:
                        table[i1, i2] = (
                            _value_for_event(res, evt1, t1)
                            + _value_for_event(res, evt2, t2)
                        ) / (n_evts - 1)
            dcop.add_constraint(
                NAryMatrixRelation(
                    [v1, v2], table, name=f"ci_{v1.name}_{v2.name}"
                )
            )
        if n_evts == 1:
            # single event: carry its utility as a unary constraint
            (rid, eid), v = next(iter(res_vars.items()))
            evt = events[eid]
            table = np.array(
                [
                    _value_for_event(res, evt, t)
                    for t in v.domain.values
                ]
            )
            dcop.add_constraint(
                NAryMatrixRelation([v], table, name=f"cu_{v.name}")
            )

    # inter-agent constraints: all resources of an event must agree on its
    # start slot (reference :588-600)
    for evt in events.values():
        for r1, r2 in itertools.combinations(sorted(evt.resources), 2):
            v1 = variables[(r1, evt.id)]
            v2 = variables[(r2, evt.id)]
            table = np.zeros((len(v1.domain), len(v2.domain)))
            for i1, t1 in enumerate(v1.domain.values):
                for i2, t2 in enumerate(v2.domain.values):
                    if t1 != t2:
                        table[i1, i2] = -penalty
            dcop.add_constraint(
                NAryMatrixRelation(
                    [v1, v2], table, name=f"ce_{v1.name}_{v2.name}"
                )
            )

    dcop.add_agents(agents)
    return dcop
