"""IoT benchmark generator: power-law constraint graphs with route and
hosting costs.

The port's copy of ``pydcop_tpu/commands/generators/iot.py``, the same
numpy calls in the same order: a Barabasi-Albert constraint graph of
``num`` variables (random binary cost tables over ``range``), one agent a
variable with a capacity from MaxSum's footprint model, hosting costs
that prefer the own variable, route costs from the factor graph, and an
initial distribution (each variable on its agent, the factors placed
greedily).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ...dcop.dcop import DCOP
from ...dcop.objects import AgentDef, Domain, Variable
from ...dcop.relations import NAryMatrixRelation
from .graphcoloring import scale_free_edges

__all__ = ["generate_powerlaw_var_constraints", "generate_iot"]


def generate_powerlaw_var_constraints(
    num_var: int, domain_size: int, constraint_range: int, seed: int = 0
) -> Tuple[Dict[str, Variable], Dict[str, NAryMatrixRelation], Domain]:
    """Barabasi-Albert (m=2) graph; each edge a random cost table drawn
    uniformly in [0, constraint_range)."""
    rng = np.random.default_rng(seed)
    edges = scale_free_edges(num_var, 2, rng)
    domain = Domain("d", "d", list(range(domain_size)))
    variables = {
        f"v{i:03d}": Variable(f"v{i:03d}", domain) for i in range(num_var)
    }
    constraints: Dict[str, NAryMatrixRelation] = {}
    for i, j in edges:
        v1, v2 = variables[f"v{int(i):03d}"], variables[f"v{int(j):03d}"]
        table = rng.integers(
            0, constraint_range, (domain_size, domain_size)
        ).astype(float)
        c = NAryMatrixRelation(
            [v1, v2], table, name=f"c{int(i):03d}_{int(j):03d}"
        )
        constraints[c.name] = c
    return variables, constraints, domain


def generate_iot(
    num: int = 30,
    domain_size: int = 10,
    constraint_range: int = 100,
    seed: int = 0,
):
    """Full IoT instance: DCOP + agents with capacity/hosting/route costs +
    the initial variable-to-own-agent distribution.

    Returns (dcop, distribution_mapping).
    """
    from ...algorithms import maxsum as maxsum_module
    from ...computations_graph import factor_graph

    variables, constraints, domain = generate_powerlaw_var_constraints(
        num, domain_size, constraint_range, seed
    )
    dcop = DCOP("iot", "min")
    for v in variables.values():
        dcop.add_variable(v)
    for c in constraints.values():
        dcop.add_constraint(c)

    cg = factor_graph.build_computation_graph(dcop)
    footprints = {
        n.name: maxsum_module.computation_memory(n) for n in cg.nodes
    }

    agents: List[AgentDef] = []
    mapping: Dict[str, List[str]] = {}
    var_nodes = [n for n in cg.nodes if n.type == "VariableComputation"]
    for node in var_nodes:
        a_name = f"a{node.name[1:]}"
        # prefer hosting the own variable (cost 0) and its factors (cost 1)
        hosting_costs = {node.name: 0.0}
        for neigh in node.neighbors:
            hosting_costs[neigh] = 1.0
        # route costs: cheap to agents of neighbor computations
        routes = {}
        for neigh in node.neighbors:
            for nn in cg.computation(neigh).neighbors:
                if nn != node.name:
                    routes[f"a{nn[1:]}"] = 0.5
        agents.append(
            AgentDef(
                a_name,
                capacity=footprints[node.name] * 100,
                default_hosting_cost=10,
                hosting_costs=hosting_costs,
                default_route=1,
                routes=routes,
            )
        )
        mapping[a_name] = [node.name]
    dcop.add_agents(agents)

    # distribute factor computations greedily on the agents, cheapest
    # (hosting + capacity-feasible) first
    factor_nodes = [n for n in cg.nodes if n.type == "FactorComputation"]
    used = {a.name: footprints[mapping[a.name][0]] for a in agents}
    agent_by_name = {a.name: a for a in agents}
    for node in sorted(
        factor_nodes, key=lambda n: -footprints[n.name]
    ):
        best, best_cost = None, float("inf")
        for a in agents:
            if used[a.name] + footprints[node.name] > a.capacity:
                continue
            cost = agent_by_name[a.name].hosting_cost(node.name)
            if cost < best_cost:
                best, best_cost = a.name, cost
        if best is None:
            best = min(used, key=used.get)
        mapping[best].append(node.name)
        used[best] += footprints[node.name]
    return dcop, mapping
