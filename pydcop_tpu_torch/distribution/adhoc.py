"""adhoc distribution: capacity-aware heuristic honoring DistributionHints.

The port's copy of ``pydcop_tpu/distribution/adhoc.py``, with
``distribute_remove``/``distribute_add`` for dynamic repair: colocation
groups (``host_with``) are merged with union-find, ``must_host`` pins
groups to agents, remaining groups go largest-footprint first to the
agent with the most free capacity that already hosts a neighbor
(communication locality), falling back to the globally least-loaded
agent.  The footprints are the algorithm module's
``computation_memory``, the JAX package's models.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

from ..computations_graph.objects import ComputationGraph
from ..dcop.objects import AgentDef
from .objects import (
    Distribution,
    DistributionHints,
    ImpossibleDistributionException,
)

__all__ = ["distribute", "distribute_remove", "distribute_add"]


class _UnionFind:
    def __init__(self, items):
        self.parent = {i: i for i in items}

    def find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def _footprint(node, computation_memory: Optional[Callable]) -> float:
    if computation_memory is None:
        return 0.0
    try:
        return float(computation_memory(node))
    except Exception:
        return 0.0


def distribute(
    computation_graph: ComputationGraph,
    agentsdef: Iterable[AgentDef],
    hints: Optional[DistributionHints] = None,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
    timeout=None,
) -> Distribution:
    agents = {a.name: a for a in agentsdef}
    if not agents:
        raise ImpossibleDistributionException("no agents")
    hints = hints or DistributionHints()
    nodes = {n.name: n for n in computation_graph.nodes}
    # each node's footprint, once: the JAX package's code computes it
    # again at each of its three uses (the same values, summed in the
    # same orders below)
    fp = {n: _footprint(node, computation_memory)
          for n, node in nodes.items()}

    # colocation groups
    uf = _UnionFind(list(nodes))
    for c, others in hints.host_with.items():
        for o in others:
            if c in nodes and o in nodes:
                uf.union(c, o)
    groups: Dict[str, List[str]] = {}
    for n in nodes:
        groups.setdefault(uf.find(n), []).append(n)

    remaining = {a: float(agents[a].capacity) for a in agents}
    mapping: Dict[str, List[str]] = {a: [] for a in agents}
    hosted: Dict[str, str] = {}

    def place(agent: str, comps: List[str]) -> None:
        need = sum(fp[c] for c in comps)
        if remaining[agent] < need:
            raise ImpossibleDistributionException(
                f"agent {agent} lacks capacity for {comps} "
                f"(need {need}, free {remaining[agent]})"
            )
        remaining[agent] -= need
        for c in comps:
            mapping[agent].append(c)
            hosted[c] = agent

    # pinned groups first
    placed_groups = set()
    for agent, comps in hints.must_host.items():
        if agent not in agents:
            raise ImpossibleDistributionException(
                f"must_host references unknown agent {agent}"
            )
        for c in comps:
            if c not in nodes:
                continue
            root = uf.find(c)
            if root in placed_groups:
                if hosted.get(c) != agent:
                    # group already pinned to a different agent by a
                    # colocated computation's must_host
                    raise ImpossibleDistributionException(
                        f"conflicting must_host/host_with hints for {c}: "
                        f"pinned to both {hosted.get(c)} and {agent}"
                    )
                continue
            place(agent, sorted(groups[root]))
            placed_groups.add(root)

    # remaining groups: largest footprint first
    todo = [
        (root, comps)
        for root, comps in groups.items()
        if root not in placed_groups
    ]
    todo.sort(key=lambda rc: -sum(fp[c] for c in rc[1]))
    for root, comps in todo:
        # prefer an agent hosting a neighbor of this group
        neighbor_agents = set()
        for c in comps:
            for n in nodes[c].neighbors:
                if n in hosted:
                    neighbor_agents.add(hosted[n])
        need = sum(fp[c] for c in comps)
        candidates = sorted(
            (a for a in agents if remaining[a] >= need),
            key=lambda a: (a not in neighbor_agents, -remaining[a], a),
        )
        if not candidates:
            raise ImpossibleDistributionException(
                f"no agent has capacity {need} for group {sorted(comps)}"
            )
        place(candidates[0], sorted(comps))

    return Distribution(mapping)


def distribute_remove(
    removed_agents: List[str],
    distribution: Distribution,
    computation_graph: ComputationGraph,
    agentsdef: Iterable[AgentDef],
    computation_memory: Optional[Callable] = None,
) -> Distribution:
    """Re-place the computations orphaned by removed agents on the remaining
    ones (pyDCOP adhoc.py:187)."""
    mapping = distribution.mapping
    orphaned: List[str] = []
    for a in removed_agents:
        orphaned.extend(mapping.pop(a, []))
    survivors = [a for a in agentsdef if a.name in mapping]
    if not survivors:
        raise ImpossibleDistributionException("no surviving agents")
    nodes = {n.name: n for n in computation_graph.nodes}
    remaining = {}
    for a in survivors:
        used = sum(
            _footprint(nodes[c], computation_memory)
            for c in mapping[a.name]
            if c in nodes
        )
        remaining[a.name] = float(a.capacity) - used
    for c in sorted(
        orphaned,
        key=lambda c: -_footprint(nodes.get(c), computation_memory)
        if c in nodes
        else 0,
    ):
        best = max(remaining, key=lambda a: remaining[a])
        need = _footprint(nodes.get(c), computation_memory) if c in nodes else 0
        if remaining[best] < need:
            raise ImpossibleDistributionException(
                f"cannot re-place {c}: no capacity left"
            )
        remaining[best] -= need
        mapping[best].append(c)
    return Distribution(mapping)


def distribute_add(
    added_computations: List[str],
    distribution: Distribution,
    computation_graph: ComputationGraph,
    agentsdef: Iterable[AgentDef],
    computation_memory: Optional[Callable] = None,
) -> Distribution:
    """Place newly added computations on the least-loaded agents."""
    mapping = distribution.mapping
    nodes = {n.name: n for n in computation_graph.nodes}
    agents = {a.name: a for a in agentsdef}
    remaining = {}
    for name, a in agents.items():
        used = sum(
            _footprint(nodes[c], computation_memory)
            for c in mapping.get(name, [])
            if c in nodes
        )
        remaining[name] = float(a.capacity) - used
        mapping.setdefault(name, [])
    for c in added_computations:
        best = max(remaining, key=lambda a: remaining[a])
        need = _footprint(nodes.get(c), computation_memory) if c in nodes else 0
        if remaining[best] < need:
            raise ImpossibleDistributionException(
                f"cannot place {c}: no capacity left"
            )
        remaining[best] -= need
        mapping[best].append(c)
    return Distribution(mapping)
