"""oneagent distribution: one computation per agent.

The port's copy of ``pydcop_tpu/distribution/oneagent.py``: the classical
DCOP hypothesis (each agent controls exactly one computation), the
default distribution of ``solve``.  The device solve ignores it: every
computation advances in one replay of the solve's graphs whoever hosts
it; the agent runtime deploys by it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from ..computations_graph.objects import ComputationGraph
from ..dcop.objects import AgentDef
from .objects import (
    Distribution,
    DistributionHints,
    ImpossibleDistributionException,
)

__all__ = ["distribute", "distribution_cost"]


def distribute(
    computation_graph: ComputationGraph,
    agentsdef: Iterable[AgentDef],
    hints: Optional[DistributionHints] = None,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
    timeout=None,
) -> Distribution:
    agents = list(agentsdef)
    nodes = computation_graph.nodes
    if len(agents) < len(nodes):
        raise ImpossibleDistributionException(
            f"oneagent needs at least as many agents ({len(agents)}) as "
            f"computations ({len(nodes)})"
        )
    mapping = {a.name: [] for a in agents}
    for node, agent in zip(nodes, agents):
        mapping[agent.name].append(node.name)
    return Distribution(mapping)


def distribution_cost(
    distribution: Distribution,
    computation_graph: ComputationGraph,
    agentsdef: Iterable[AgentDef],
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
) -> float:
    # oneagent has no cost model (pyDCOP returns 0)
    return 0.0
