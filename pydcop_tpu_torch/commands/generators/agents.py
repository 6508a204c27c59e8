"""Agent-definition generator.

The port's copy of ``pydcop_tpu/commands/generators/agents.py``: agent
lists named from a count or from a DCOP's variables, with capacity,
hosting-cost modes (``None`` or ``name_mapping``: zero cost for the
matching variable) and random route costs, the same ``random`` calls in
the same order.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ...dcop.objects import AgentDef

__all__ = [
    "generate_agents_from_count",
    "generate_agents_from_variables",
    "generate_agent_defs",
]


def generate_agents_from_count(
    agent_count: int, agent_prefix: str = "a"
) -> List[str]:
    digits = len(str(agent_count - 1)) if agent_count > 1 else 1
    return [f"{agent_prefix}{i:0{digits}d}" for i in range(agent_count)]


def generate_agents_from_variables(
    variables: List[str], agent_prefix: str = "a"
) -> List[str]:
    """One agent per variable, named after it (variable ``v12`` -> agent
    ``a12``; a name that starts with a digit is prefixed whole)."""
    out = []
    for v in variables:
        suffix = v[1:] if v and not v[0].isdigit() else v
        out.append(f"{agent_prefix}{suffix}")
    return out


def generate_hosting_costs(
    mode: Optional[str], agent_names: List[str], computations: List[str]
) -> Dict[str, Dict[str, float]]:
    """hosting costs per agent: ``name_mapping`` gives cost 0 for the
    computation whose name matches the agent's suffix."""
    costs: Dict[str, Dict[str, float]] = {}
    if mode == "name_mapping":
        comp_by_suffix = {c[1:]: c for c in computations}
        for a in agent_names:
            suffix = a[1:]
            if suffix in comp_by_suffix:
                costs[a] = {comp_by_suffix[suffix]: 0.0}
    return costs


def generate_agent_defs(
    names: List[str],
    capacity: Optional[int] = None,
    hosting_mode: Optional[str] = None,
    computations: Optional[List[str]] = None,
    default_hosting_cost: float = 0,
    default_route: float = 1,
    routes_range: Optional[float] = None,
    seed: int = 0,
) -> List[AgentDef]:
    rng = random.Random(seed)
    hosting = generate_hosting_costs(
        hosting_mode, names, computations or []
    )
    routes: Dict[str, Dict[str, float]] = {}
    if routes_range:
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                routes.setdefault(a, {})[b] = round(
                    rng.uniform(0, routes_range), 2
                )
    out = []
    for a in names:
        kwargs = {}
        if capacity is not None:
            kwargs["capacity"] = capacity
        out.append(
            AgentDef(
                a,
                default_hosting_cost=default_hosting_cost,
                hosting_costs=hosting.get(a, {}),
                default_route=default_route,
                routes=routes.get(a, {}),
                **kwargs,
            )
        )
    return out
