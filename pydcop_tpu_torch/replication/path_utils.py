"""Path-cost algebra for replica placement.

The port's copy of ``pydcop_tpu/replication/path_utils.py`` (pyDCOP's
``cheapest_path_to``, ``affordable_path_from``,
``filter_missing_agents_paths``): small helpers over path tables
``{(a0, ..., an): cost}`` and the uniform-cost search of the agent route
graph, ``ucs_paths``, with its closed form for an owner that knows only
its own routes, ``owner_paths``.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Path",
    "cheapest_path_to",
    "affordable_path_from",
    "filter_missing_agents_paths",
    "ucs_paths",
    "owner_paths",
]

Path = Tuple[str, ...]


def cheapest_path_to(
    target: str, paths: Dict[Path, float]
) -> Tuple[Optional[Path], float]:
    """The cheapest known path ending at ``target`` (pyDCOP :99)."""
    best: Optional[Path] = None
    best_cost = float("inf")
    for path, cost in paths.items():
        if path and path[-1] == target and cost < best_cost:
            best, best_cost = path, cost
    return best, best_cost


def affordable_path_from(
    prefix: Path, budget: float, paths: Dict[Path, float]
) -> Dict[Path, float]:
    """Paths extending ``prefix`` whose cost fits in ``budget``
    (pyDCOP :125)."""
    out: Dict[Path, float] = {}
    n = len(prefix)
    for path, cost in paths.items():
        if path[:n] == prefix and cost <= budget:
            out[path] = cost
    return out


def filter_missing_agents_paths(
    paths: Dict[Path, float], available: Iterable[str]
) -> Dict[Path, float]:
    """Drop paths through agents that are gone (pyDCOP :135)."""
    avail = set(available)
    return {
        path: cost
        for path, cost in paths.items()
        if all(a in avail for a in path)
    }


def ucs_paths(start: str, route_cost, agents: List[str]) -> Dict[str, float]:
    """Uniform-cost search over the full route graph from ``start``: cheapest
    path cost to every other agent.  ``route_cost(a, b)`` gives one hop's
    cost.  This is the exploration order of pyDCOP's distributed UCS
    (dist_ucs_hostingcosts.py:419) computed locally."""
    dist: Dict[str, float] = {start: 0.0}
    heap: List[Tuple[float, str]] = [(0.0, start)]
    seen = set()
    while heap:
        cost, a = heapq.heappop(heap)
        if a in seen:
            continue
        seen.add(a)
        for b in agents:
            if b == a or b in seen:
                continue
            c = cost + float(route_cost(a, b))
            if c < dist.get(b, float("inf")):
                dist[b] = c
                heapq.heappush(heap, (c, b))
    return dist


#: a hop's cost where the owner does not know the route
OTHER_HOP = 1.0


def owner_paths(start: str, route_cost, agents: List[str]) -> Dict[str, float]:
    """``ucs_paths`` under replication's knowledge model: ``start``
    knows its own routes (``route_cost(start, b)``), every other hop
    costs ``OTHER_HOP``.  The same dict, with the same floats in the
    same order, from ``len(agents)`` route lookups instead of their
    square: the search first settles ``start`` (each other agent at its
    direct route, where that is finite), then the agent with the
    cheapest (cost, name), ``a1`` at ``d1``, which offers ``d1 +
    OTHER_HOP`` to all the others; every agent settled later offers no
    less, so nothing after ``a1`` improves a cost."""
    dist: Dict[str, float] = {start: 0.0}
    for b in agents:
        if b == start:
            continue
        c = 0.0 + float(route_cost(start, b))
        if c < float("inf"):
            dist[b] = c
    first = [(c, b) for b, c in dist.items() if b != start]
    if not first:
        return dist
    d1, a1 = min(first)
    via = d1 + OTHER_HOP
    for b in agents:
        if b == start or b == a1:
            continue
        if via < dist.get(b, float("inf")):
            dist[b] = via
    return dist
