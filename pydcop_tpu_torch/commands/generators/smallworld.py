"""Small-world benchmark generator.

The port's copy of ``pydcop_tpu/commands/generators/smallworld.py``, the
same numpy calls in the same order: a Watts-Strogatz small-world
constraint graph with random binary cost tables, one variable a node.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...dcop.dcop import DCOP
from ...dcop.objects import AgentDef, Domain, Variable
from ...dcop.relations import NAryMatrixRelation

__all__ = ["watts_strogatz_edges", "generate_small_world"]


def watts_strogatz_edges(
    n: int, k: int, p: float, rng: np.random.Generator
) -> np.ndarray:
    """Watts-Strogatz ring-lattice rewiring: each node connects to its k//2
    nearest neighbors on a ring; each edge is rewired with probability p.

    The JAX package builds a rewire's candidates as a Python list over
    all n nodes; here they are the same nodes in the same order (every
    node but i and i's neighbors so far, ascending) as a numpy array, so
    ``rng.choice`` draws the same node."""
    edges = set()
    adjacent = [[] for _ in range(n)]  # each node's neighbors so far
    nodes = np.arange(n)
    for i in range(n):
        for offset in range(1, k // 2 + 1):
            j = (i + offset) % n
            if rng.random() < p:
                free = np.ones(n, dtype=bool)
                free[i] = False
                free[adjacent[i]] = False
                choices = nodes[free]
                if choices.size:
                    j = int(rng.choice(choices))
            if i != j:
                edge = (min(i, j), max(i, j))
                if edge not in edges:
                    edges.add(edge)
                    adjacent[i].append(j)
                    adjacent[j].append(i)
    return np.asarray(sorted(edges), dtype=np.int32).reshape(-1, 2)


def generate_small_world(
    n: int = 20,
    k: int = 4,
    p: float = 0.1,
    domain_size: int = 5,
    cost_range: int = 10,
    seed: Optional[int] = None,
) -> DCOP:
    rng = np.random.default_rng(seed)
    edges = watts_strogatz_edges(n, k, p, rng)
    domain = Domain("d", "d", list(range(domain_size)))
    dcop = DCOP(f"smallworld_{n}_{k}_{p}", "min")
    variables = {}
    for i in range(n):
        v = Variable(f"v{i:03d}", domain)
        variables[i] = v
        dcop.add_variable(v)
    for i, j in edges:
        table = rng.integers(
            0, cost_range, (domain_size, domain_size)
        ).astype(float)
        dcop.add_constraint(
            NAryMatrixRelation(
                [variables[int(i)], variables[int(j)]],
                table,
                name=f"c{int(i):03d}_{int(j):03d}",
            )
        )
    dcop.add_agents([AgentDef(f"a{i:03d}") for i in range(n)])
    return dcop
