"""SECP benchmark generator: smart-environment configuration problems.

The port's copy of ``pydcop_tpu/commands/generators/secp.py``, the same
``random`` calls in the same order, so a seed gives the same problem and
the same YAML text: ``lights`` light variables (domain 0..4) each with a
linear efficiency cost; ``models`` model variables tied to a weighted sum
of lights by a hard threshold constraint; ``rules`` soft constraints
setting targets for lights and models; one agent per light, whose hosting
costs prefer its own variable and cost and default high.
"""

from __future__ import annotations

import random
from typing import Dict, List

from ...dcop.dcop import DCOP
from ...dcop.objects import AgentDef, Domain, Variable
from ...dcop.relations import constraint_from_str

__all__ = ["generate_secp"]


def generate_secp(
    lights: int = 3,
    models: int = 2,
    rules: int = 2,
    capacity: int = 100,
    max_model_size: int = 3,
    max_rule_size: int = 2,
    seed: int = 0,
) -> DCOP:
    rng = random.Random(seed)
    light_domain = Domain("light", "light", list(range(5)))
    dcop = DCOP("secp", "min")

    light_vars: Dict[str, Variable] = {}
    light_costs: Dict[str, str] = {}
    for i in range(lights):
        v = Variable(f"l{i}", light_domain)
        light_vars[v.name] = v
        dcop.add_variable(v)
        efficiency = rng.randint(0, 90) / 100
        c = constraint_from_str(
            f"c_l{i}", f"{v.name} * {efficiency}", [v]
        )
        dcop.add_constraint(c)
        light_costs[v.name] = c.name

    model_vars: Dict[str, Variable] = {}
    for j in range(models):
        mv = Variable(f"m{j}", light_domain)
        model_vars[mv.name] = mv
        dcop.add_variable(mv)
        size = rng.randint(2, max(2, max_model_size))
        chosen = rng.sample(sorted(light_vars), min(size, lights))
        expr = " + ".join(
            f"{name} * {rng.randint(1, 7) / 10}" for name in chosen
        )
        con = constraint_from_str(
            f"c_m{j}",
            f"0 if 10 * abs({mv.name} - ({expr})) < 5 else 10000",
            [light_vars[n] for n in chosen] + [mv],
        )
        dcop.add_constraint(con)

    all_vars = {**light_vars, **model_vars}
    for k in range(rules):
        max_size = min(max_rule_size, len(all_vars))
        rule_size = rng.randint(1, max_size)
        chosen = rng.sample(sorted(all_vars), rule_size)
        expr = " + ".join(
            f"abs({name} - {rng.randint(0, 4)})" for name in chosen
        )
        con = constraint_from_str(
            f"r_{k}", f"10 * ({expr})", [all_vars[n] for n in chosen]
        )
        dcop.add_constraint(con)

    agents: List[AgentDef] = []
    for name, cost_name in light_costs.items():
        agents.append(
            AgentDef(
                f"a{name}",
                capacity=capacity,
                hosting_costs={name: 0, cost_name: 0},
                default_hosting_cost=100,
            )
        )
    dcop.add_agents(agents)
    return dcop
