"""Ordered chain of variables, for SyncBB.

The port's copy of ``pydcop_tpu/computations_graph/ordered_graph.py``
(lexical order), the graph the agent runtime deploys for SyncBB.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..dcop.dcop import DCOP
from ..dcop.objects import Variable
from ..dcop.relations import Constraint
from .objects import ComputationGraph, ComputationNode, Link

__all__ = [
    "OrderLink",
    "OrderedVarNode",
    "OrderedConstraintGraph",
    "build_computation_graph",
]


class OrderLink(Link):
    """Chain link: type 'next' or 'previous'."""

    def __init__(self, link_type: str, source: str, target: str) -> None:
        if link_type not in ("next", "previous"):
            raise ValueError("order link type must be 'next' or 'previous'")
        super().__init__((source, target), link_type)
        self.source = source
        self.target = target


class OrderedVarNode(ComputationNode):
    def __init__(
        self,
        variable: Variable,
        constraints: List[Constraint],
        prev_node: Optional[str],
        next_node: Optional[str],
        position: int,
    ) -> None:
        links = []
        if prev_node:
            links.append(OrderLink("previous", variable.name, prev_node))
        if next_node:
            links.append(OrderLink("next", variable.name, next_node))
        super().__init__(variable.name, "OrderedVariableComputation", links)
        self.variable = variable
        self.constraints = list(constraints)
        self.prev_node = prev_node
        self.next_node = next_node
        self.position = position


class OrderedConstraintGraph(ComputationGraph):
    graph_type = "ordered_graph"

    def ordered_nodes(self) -> List[OrderedVarNode]:
        return sorted(self.nodes, key=lambda n: n.position)


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[Iterable[Variable]] = None,
    constraints: Optional[Iterable[Constraint]] = None,
) -> OrderedConstraintGraph:
    """Lexically ordered chain; each constraint attached to its *last* variable
    in the order (so SyncBB can evaluate it as soon as the partial assignment
    reaches that variable)."""
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    ordered = sorted(variables, key=lambda v: v.name)
    pos = {v.name: i for i, v in enumerate(ordered)}

    cons_at: Dict[str, List[Constraint]] = {v.name: [] for v in ordered}
    for c in constraints:
        scope = [v.name for v in c.dimensions if v.name in pos]
        if not scope:
            continue
        last = max(scope, key=lambda n: pos[n])
        cons_at[last].append(c)

    graph = OrderedConstraintGraph()
    for i, v in enumerate(ordered):
        prev_node = ordered[i - 1].name if i > 0 else None
        next_node = ordered[i + 1].name if i < len(ordered) - 1 else None
        graph.add_node(
            OrderedVarNode(v, cons_at[v.name], prev_node, next_node, i)
        )
    return graph
