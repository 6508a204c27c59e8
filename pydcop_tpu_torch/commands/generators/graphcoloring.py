"""Graph-coloring benchmark problem generator.

Counterpart of ``pydcop_tpu/commands/generators/graphcoloring.py``: the
same graph models and the same numpy RNG calls in the same order, so one
seed gives identical problems in both packages.  ``generate_graph_coloring``
builds an object-level (YAML-able) ``DCOP``; ``generate_coloring_arrays``
lowers the same problem family straight to a ``CompiledDCOP``, with no
python objects, for sizes where building them would dominate.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...compile.core import CompiledDCOP
from ...compile.direct import compile_from_edges
from ...dcop.dcop import DCOP
from ...dcop.objects import AgentDef, Domain, Variable
from ...dcop.relations import NAryMatrixRelation

__all__ = [
    "random_edges",
    "scale_free_edges",
    "grid_edges",
    "generate_graph_coloring",
    "generate_coloring_arrays",
]


def random_edges(
    n: int, p_edge: float, rng: np.random.Generator
) -> np.ndarray:
    """Erdos-Renyi G(n, p) edge list [n_e, 2] (i < j)."""
    n_pairs = n * (n - 1) // 2
    if n <= 4096:
        i, j = np.triu_indices(n, k=1)
        keep = rng.random(i.shape[0]) < p_edge
        return np.stack([i[keep], j[keep]], axis=1).astype(np.int32)
    # large n: materializing all O(n^2) pairs is infeasible — draw the edge
    # count from Binomial(n_pairs, p) and sample that many distinct pairs
    n_edges = int(rng.binomial(n_pairs, p_edge))
    picked: set = set()
    while len(picked) < n_edges:
        need = n_edges - len(picked)
        a = rng.integers(0, n, 2 * need)
        b = rng.integers(0, n, 2 * need)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        for x, y in zip(lo[lo != hi], hi[lo != hi]):
            picked.add((int(x), int(y)))
            if len(picked) == n_edges:
                break
    return np.asarray(sorted(picked), dtype=np.int32).reshape(-1, 2)


def scale_free_edges(
    n: int, m: int, rng: np.random.Generator
) -> np.ndarray:
    """Barabasi-Albert preferential attachment: each new node attaches to
    ``m`` existing nodes with probability proportional to degree."""
    if n <= m:
        raise ValueError(f"scale-free graph needs n > m (got n={n}, m={m})")
    # repeated-nodes trick: sample attachment targets from a list where each
    # node appears once per unit of degree
    targets = list(range(m))
    repeated: List[int] = []
    edges = np.empty((m * (n - m), 2), dtype=np.int32)
    k = 0
    for src in range(m, n):
        for dst in targets:
            edges[k, 0] = dst
            edges[k, 1] = src
            k += 1
        repeated.extend(targets)
        repeated.extend([src] * m)
        # next targets: m distinct degree-weighted picks
        picks = set()
        while len(picks) < m:
            picks.add(repeated[int(rng.integers(len(repeated)))])
        targets = list(picks)
    return edges[:k]


def grid_edges(side: int) -> np.ndarray:
    """4-neighborhood grid lattice (side x side)."""
    idx = np.arange(side * side).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return np.concatenate([right, down]).astype(np.int32)


def _coloring_table(n_colors: int, hard: bool) -> np.ndarray:
    """Cost table for one edge: equal colors cost 1 (soft) or inf (hard);
    random unary preferences are added by the caller in soft mode."""
    # np.where, not eye * inf: 0 * inf is NaN
    return np.where(
        np.eye(n_colors, dtype=bool), np.inf if hard else 1.0, 0.0
    )


def _build_edges(
    n: int,
    graph: str,
    p_edge: Optional[float],
    m_edge: Optional[int],
    rng: np.random.Generator,
) -> np.ndarray:
    if graph == "random":
        return random_edges(n, p_edge if p_edge is not None else 0.1, rng)
    if graph == "scalefree":
        return scale_free_edges(n, m_edge if m_edge is not None else 2, rng)
    if graph == "grid":
        side = int(round(n ** 0.5))
        if side * side != n:
            raise ValueError(
                f"grid graphs need a square variable count, got {n}"
            )
        return grid_edges(side)
    raise ValueError(f"unknown graph model {graph!r}")


def _connect_isolated(
    edges: np.ndarray, n: int, rng: np.random.Generator
) -> np.ndarray:
    """Attach every zero-degree variable to a random partner."""
    present = np.zeros(n, dtype=bool)
    present[edges.ravel()] = True
    missing = np.nonzero(~present)[0]
    if missing.size:
        partners = rng.integers(0, n - 1, missing.size)
        partners = partners + (partners >= missing)
        extra = np.stack(
            [missing.astype(np.int32), partners.astype(np.int32)], axis=1
        )
        edges = np.concatenate([edges, extra])
    return edges


def generate_graph_coloring(
    variables_count: int,
    colors_count: int,
    graph: str = "random",
    p_edge: Optional[float] = None,
    m_edge: Optional[int] = None,
    soft: bool = True,
    extensive: bool = False,
    noise_level: float = 0.02,
    seed: Optional[int] = None,
    allow_subgraph: bool = False,
    n_agents: Optional[int] = None,
) -> DCOP:
    """Object-level generator (a YAML-able DCOP).

    Soft problems add random unary preference costs scaled by
    ``noise_level``; hard problems make equal colors infeasible.
    """
    rng = np.random.default_rng(seed)
    edges = _build_edges(variables_count, graph, p_edge, m_edge, rng)
    if not allow_subgraph and variables_count > 1:
        edges = _connect_isolated(edges, variables_count, rng)

    dom = Domain("colors", "d", list(range(colors_count)))
    dcop = DCOP(f"graph_coloring_{variables_count}", objective="min")
    variables = []
    for i in range(variables_count):
        v = Variable(f"v{i:05d}", dom)
        variables.append(v)
        dcop.add_variable(v)

    table = _coloring_table(colors_count, hard=not soft)
    for k, (i, j) in enumerate(edges):
        c = NAryMatrixRelation(
            [variables[i], variables[j]],
            table,
            name=f"cost_{k}",
        )
        dcop.add_constraint(c)

    if soft and noise_level:
        for i, v in enumerate(variables):
            prefs = rng.random(colors_count) * noise_level
            c = NAryMatrixRelation([v], prefs, name=f"pref_{i}")
            dcop.add_constraint(c)

    if n_agents is None:
        n_agents = variables_count
    dcop.add_agents(
        [AgentDef(f"a{a:05d}", capacity=100) for a in range(n_agents)]
    )
    return dcop


def generate_coloring_arrays(
    variables_count: int,
    colors_count: int,
    graph: str = "scalefree",
    p_edge: Optional[float] = None,
    m_edge: Optional[int] = None,
    soft: bool = True,
    noise_level: float = 0.02,
    seed: Optional[int] = None,
) -> CompiledDCOP:
    """Array-level generator: straight to CompiledDCOP, no python objects.
    Soft problems cost 1 per equal-colored edge plus random unary
    preferences scaled by ``noise_level``; hard problems cost 1e9."""
    rng = np.random.default_rng(seed)
    edges = _build_edges(variables_count, graph, p_edge, m_edge, rng)
    if variables_count > 1:
        edges = _connect_isolated(edges, variables_count, rng)
    table = np.where(
        np.eye(colors_count, dtype=bool),
        np.float32(1.0 if soft else 1e9),
        np.float32(0.0),
    )
    unary = (
        rng.random((variables_count, colors_count)).astype(np.float32)
        * noise_level
        if soft and noise_level
        else None
    )
    return compile_from_edges(
        variables_count, colors_count, edges, table, unary=unary
    )
