"""Shared cost model for distributions: hosting + communication.

The port's own copy of ``pydcop_tpu/distribution/_costs.py``: the
objective of the cgdp family of distribution methods, total cost = sum
of hosting costs of every (computation, agent) placement + sum over
computation-graph edges of msg_load(edge) x route(agent_src, agent_dst).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

from ..computations_graph.objects import ComputationGraph
from ..dcop.objects import AgentDef
from .objects import Distribution

__all__ = ["distribution_cost", "edge_loads", "RATIO_HOST_COMM"]

# Relative weight of communication vs hosting in the combined objective, same
# role as the reference's RATIO_HOST_COMM (oilp_cgdp.py).
RATIO_HOST_COMM = 0.8


def edge_loads(
    computation_graph: ComputationGraph,
    communication_load: Optional[Callable],
) -> Dict[Tuple[str, str], float]:
    """{(comp_a, comp_b) sorted -> message load} for every graph edge."""
    loads: Dict[Tuple[str, str], float] = {}
    for node in computation_graph.nodes:
        for neigh in node.neighbors:
            key = tuple(sorted((node.name, neigh)))
            if key in loads:
                continue
            if communication_load is None:
                loads[key] = 1.0
            else:
                try:
                    loads[key] = float(communication_load(node, neigh))
                except Exception:
                    loads[key] = 1.0
    return loads


def distribution_cost(
    distribution: Distribution,
    computation_graph: ComputationGraph,
    agentsdef: Iterable[AgentDef],
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
    ratio_host_comm: float = RATIO_HOST_COMM,
) -> Tuple[float, float, float]:
    """(total, communication, hosting) costs of a distribution."""
    agents = {a.name: a for a in agentsdef}
    hosting = 0.0
    for agent_name, comps in distribution.mapping.items():
        agent = agents[agent_name]
        for c in comps:
            hosting += float(agent.hosting_cost(c))
    comm = 0.0
    for (c1, c2), load in edge_loads(
        computation_graph, communication_load
    ).items():
        if not (
            distribution.has_computation(c1)
            and distribution.has_computation(c2)
        ):
            continue
        a1 = distribution.agent_for(c1)
        a2 = distribution.agent_for(c2)
        comm += load * float(agents[a1].route(a2))
    total = ratio_host_comm * comm + (1 - ratio_host_comm) * hosting
    return total, comm, hosting
