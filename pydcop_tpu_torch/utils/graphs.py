"""Graph helper utilities over variables and constraints.

The port's copy of ``pydcop_tpu/utils/graphs.py``: bipartite
variable/constraint views, diameter, cycle counts, pair enumeration, on
plain adjacency dicts, with an optional networkx export (networkx is
needed only by the export helpers).
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Dict, List, Sequence, Set, Tuple

__all__ = [
    "as_bipartite_graph",
    "as_networkx_graph",
    "as_networkx_bipartite_graph",
    "graph_diameter",
    "cycles_count",
    "all_pairs",
]


def all_pairs(elements: Sequence[Any]) -> List[Tuple[Any, Any]]:
    """All unordered pairs of distinct elements (pyDCOP :289)."""
    return list(itertools.combinations(elements, 2))


def _adjacency(variables, relations) -> Dict[str, Set[str]]:
    """Variable-to-variable adjacency induced by shared constraints."""
    adj: Dict[str, Set[str]] = {v.name: set() for v in variables}
    for r in relations:
        names = [v.name for v in r.dimensions]
        for a, b in all_pairs(names):
            if a in adj and b in adj:
                adj[a].add(b)
                adj[b].add(a)
    return adj


def as_bipartite_graph(
    variables, relations
) -> Dict[str, List[str]]:
    """Bipartite adjacency: variable and constraint names -> neighbor names
    (pyDCOP :68)."""
    adj: Dict[str, List[str]] = {}
    for v in variables:
        adj[v.name] = []
    for r in relations:
        adj[r.name] = [v.name for v in r.dimensions]
        for v in r.dimensions:
            if v.name in adj:
                adj[v.name].append(r.name)
    return adj


def _bfs_depths(adj: Dict[str, Set[str]], root: str) -> Dict[str, int]:
    depths = {root: 0}
    q = deque([root])
    while q:
        n = q.popleft()
        for m in adj[n]:
            if m not in depths:
                depths[m] = depths[n] + 1
                q.append(m)
    return depths


def graph_diameter(variables, relations) -> int:
    """Longest shortest path over the constraint graph; for forests, the max
    diameter over components (pyDCOP :270)."""
    adj = _adjacency(variables, relations)
    seen: Set[str] = set()
    diameter = 0
    for root in adj:
        if root in seen:
            continue
        comp_depths = _bfs_depths(adj, root)
        seen |= set(comp_depths)
        comp = list(comp_depths)
        if len(comp) <= 512:
            # small component: exact all-pairs BFS
            best = 0
            for n in comp:
                best = max(
                    best, max(_bfs_depths(adj, n).values(), default=0)
                )
        else:
            # large component: double sweep (2 BFS) — exact on trees, a
            # tight lower bound on general graphs
            far1 = max(comp_depths, key=comp_depths.get)
            d2 = _bfs_depths(adj, far1)
            best = max(d2.values(), default=0)
        diameter = max(diameter, best)
    return diameter


def cycles_count(variables, relations) -> int:
    """Number of independent cycles in the constraint graph: E - V + C
    (pyDCOP :263)."""
    adj = _adjacency(variables, relations)
    n_edges = sum(len(nbrs) for nbrs in adj.values()) // 2
    seen: Set[str] = set()
    components = 0
    for root in adj:
        if root in seen:
            continue
        components += 1
        seen |= set(_bfs_depths(adj, root))
    return n_edges - len(adj) + components


def as_networkx_graph(variables, relations):
    """Constraint graph as a networkx Graph (pyDCOP :131)."""
    import networkx as nx

    g = nx.Graph()
    g.add_nodes_from(v.name for v in variables)
    for r in relations:
        for a, b in all_pairs([v.name for v in r.dimensions]):
            g.add_edge(a, b)
    return g


def as_networkx_bipartite_graph(variables, relations):
    """Bipartite factor graph as a networkx Graph with ``bipartite`` node
    attributes (pyDCOP :157)."""
    import networkx as nx

    g = nx.Graph()
    g.add_nodes_from((v.name for v in variables), bipartite=0)
    g.add_nodes_from((r.name for r in relations), bipartite=1)
    for r in relations:
        for v in r.dimensions:
            g.add_edge(r.name, v.name)
    return g
