"""Mixed hard/soft constraint problem generator.

Counterpart of ``pydcop_tpu/commands/generators/mixedproblem.py``: the
same numpy RNG calls in the same order and the same constraint
expressions, so one seed gives the same problem (``dcop_yaml`` text-equal)
in both packages.  A random problem over one integer domain
``0..range-1`` mixing HARD constraints (infinite cost off a reachable
target) with SOFT ones (weighted distance to a random target), across
three arity regimes:

* arity 1: one unary constraint per variable;
* arity 2: constraints are the edges of a connected Erdos-Renyi graph;
  hard edges are disequalities, soft edges penalize the distance of the
  pair sum to a random target;
* arity >= 3: a random bipartite constraint/variable graph where every
  variable appears in at least one constraint, every constraint covers at
  least one variable and none exceeds ``arity``; constraints score a
  random-weighted sum of their scope against a target.

Hard targets are drawn reachable over the full domain, soft costs are
``abs(...)`` in every regime so costs stay non-negative, and the
hard-constraint count is ``round(proportion * constraint_count)`` in all
regimes.  This is the workload of :mod:`..algorithms.mixeddsa`, which
minimizes violations first and soft cost second (bench config 7).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from ...dcop.dcop import DCOP
from ...dcop.objects import AgentDef, Domain, Variable
from ...dcop.relations import constraint_from_str
from .graphcoloring import _connect_isolated, random_edges

__all__ = ["generate_mixed_problem"]


def _weights(rng: np.random.Generator, k: int) -> List[float]:
    """k non-zero weights in (0, 1], rounded to 2 decimals; clamped away
    from 0 so rounding can never make a term a don't-care."""
    return [max(0.01, round(float(w), 2)) for w in 1.0 - rng.random(k)]


def _sum_expr(weights: List[float], names: List[str]) -> str:
    return " + ".join(
        f"{w}*{v}" if w != 1 else v for w, v in zip(weights, names)
    )


def _hard_expr(weights: List[float], names: List[str], values) -> str:
    """Infinite cost unless the weighted sum hits a reachable target."""
    target = round(sum(w * int(v) for w, v in zip(weights, values)), 2)
    return (
        f"0 if abs({_sum_expr(weights, names)} - {target}) < 1e-9 "
        "else float('inf')"
    )


def _soft_expr(
    weights: List[float], names: List[str], rng, domain_range: int
) -> str:
    target = round(float(rng.uniform(0, sum(weights) * (domain_range - 1))), 2)
    return f"abs({_sum_expr(weights, names)} - {target})"


def generate_mixed_problem(
    variable_count: int,
    constraint_count: int,
    hard_proportion: float,
    arity: int = 2,
    domain_range: int = 3,
    density: float = 0.3,
    agents: Optional[int] = None,
    capacity: int = 0,
    seed: Optional[int] = None,
) -> DCOP:
    if not 0 <= hard_proportion <= 1:
        raise ValueError(
            f"hard proportion must be in [0, 1], got {hard_proportion}"
        )
    if arity < 1:
        raise ValueError(f"arity must be at least 1, got {arity}")
    if arity > variable_count:
        raise ValueError(
            f"constraint arity ({arity}) cannot exceed the variable "
            f"count ({variable_count})"
        )
    if constraint_count <= 0:
        raise ValueError(
            f"constraint count must be positive, got {constraint_count}"
        )
    if arity == 1 and constraint_count != variable_count:
        # unary constraints pair off one-to-one with variables
        raise ValueError(
            "arity 1 needs exactly one constraint per variable "
            f"(got {constraint_count} constraints, {variable_count} "
            "variables)"
        )

    rng = np.random.default_rng(seed)
    domain = Domain("levels", "level", list(range(domain_range)))
    dcop = DCOP("mixed constraints problem", "min")
    variables: Dict[int, Variable] = {}
    for i in range(variable_count):
        v = Variable(f"v{i}", domain)
        variables[i] = v
        dcop.add_variable(v)

    if arity == 2:
        # constraints are the edges of a connected G(n, p=density) graph;
        # the requested constraint_count is advisory here
        edges = random_edges(variable_count, density, rng)
        edges = _connect_isolated(edges, variable_count, rng)
        scopes = [[int(i), int(j)] for i, j in edges]
        if len(scopes) != constraint_count:
            logging.getLogger("pydcop_tpu_torch.generate").warning(
                "for arity 2 constraints are the edges of the random "
                "graph: the density (%s) produced %s constraints, not "
                "the requested %s",
                density, len(scopes), constraint_count,
            )
    elif arity == 1:
        scopes = [[i] for i in range(variable_count)]
    else:
        scopes = _bipartite_scopes(
            variable_count, constraint_count, arity, density, rng
        )

    n_constraints = len(scopes)
    hard_count = int(round(hard_proportion * n_constraints))
    hard_flags = np.zeros(n_constraints, dtype=bool)
    hard_flags[rng.permutation(n_constraints)[:hard_count]] = True

    for ci, (scope, is_hard) in enumerate(zip(scopes, hard_flags)):
        names = [f"v{i}" for i in scope]
        if arity == 2 and is_hard:
            # hard pair constraints are disequalities: the graph-coloring
            # flavor of "mixed"
            expr = f"0 if {names[0]} != {names[1]} else float('inf')"
        else:
            ws = _weights(rng, len(scope))
            if is_hard:
                reachable = rng.integers(0, domain_range, len(scope))
                expr = _hard_expr(ws, names, reachable)
            else:
                expr = _soft_expr(ws, names, rng, domain_range)
        dcop.add_constraint(
            constraint_from_str(
                f"c{ci}", expr, [variables[i] for i in scope]
            )
        )

    agents_count = variable_count if agents is None else agents
    if capacity:
        agent_defs = [
            AgentDef(f"a{i}", capacity=capacity) for i in range(agents_count)
        ]
    else:
        agent_defs = [AgentDef(f"a{i}") for i in range(agents_count)]
    dcop.add_agents(agent_defs)
    return dcop


def _bipartite_scopes(
    variable_count: int,
    constraint_count: int,
    arity: int,
    density: float,
    rng: np.random.Generator,
) -> List[List[int]]:
    """Random constraint scopes for arity >= 3: the density sets the total number of variable->constraint memberships;
    every variable joins at least one constraint, every constraint gets at
    least one variable, and no scope exceeds ``arity`` or repeats a
    variable."""
    max_memberships = constraint_count * arity
    target = int(constraint_count * min(arity, variable_count) * density)
    target = max(target, variable_count, constraint_count)
    if target > max_memberships:
        target = max_memberships
    if variable_count > max_memberships:
        raise ValueError(
            f"{constraint_count} constraints of arity <= {arity} cannot "
            f"cover {variable_count} variables"
        )

    scope_sets: List[set] = [set() for _ in range(constraint_count)]
    # open constraints tracked incrementally — rebuilding candidate lists
    # per placement would be O(constraints * variables) per membership
    open_cs = list(range(constraint_count))

    def _place(c_idx_in_open: int, v: int) -> None:
        c = open_cs[c_idx_in_open]
        scope_sets[c].add(v)
        if len(scope_sets[c]) == arity:  # full: swap-remove from open set
            open_cs[c_idx_in_open] = open_cs[-1]
            open_cs.pop()

    # every variable joins one constraint with room
    for v in rng.permutation(variable_count):
        _place(int(rng.integers(len(open_cs))), int(v))
    # every empty constraint gets one variable
    for c in range(constraint_count):
        if not scope_sets[c]:
            scope_sets[c].add(int(rng.integers(variable_count)))
    # rejection-sample (open constraint, new variable) memberships until the
    # density target is met; when nearly full the retry odds degrade, so cap
    # total attempts and accept coming up slightly short
    placed = sum(len(s) for s in scope_sets)
    attempts = 0
    max_attempts = 50 * max(1, target - placed)
    while placed < target and open_cs and attempts < max_attempts:
        attempts += 1
        i = int(rng.integers(len(open_cs)))
        v = int(rng.integers(variable_count))
        if v in scope_sets[open_cs[i]]:
            continue
        _place(i, v)
        placed += 1
    return [sorted(s) for s in scope_sets]
