"""Constraints hypergraph: one computation per variable, hyperedges =
constraints.

The port's copy of
``pydcop_tpu/computations_graph/constraints_hypergraph.py``: the graph of
DSA, A-DSA, MGM, MGM-2, DBA, GDBA, MixedDSA and DSA-tuto
(``GRAPH_TYPE = "constraints_hypergraph"``), which the agent runtime
deploys one node a computation.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ..dcop.dcop import DCOP
from ..dcop.objects import Variable
from ..dcop.relations import Constraint
from .objects import ComputationGraph, ComputationNode, Link

__all__ = [
    "VariableComputationNode",
    "ConstraintLink",
    "ComputationConstraintsHyperGraph",
    "build_computation_graph",
]


class ConstraintLink(Link):
    """Hyperedge over the variables of one constraint."""

    def __init__(self, constraint_name: str, nodes: Iterable[str]) -> None:
        super().__init__(nodes, "constraint_link")
        self.constraint_name = constraint_name

    def __eq__(self, other):
        return (
            isinstance(other, ConstraintLink)
            and other.constraint_name == self.constraint_name
            and other.nodes == self.nodes
        )

    def __hash__(self):
        return hash((self.constraint_name, self.nodes))

    def __repr__(self):
        return f"ConstraintLink({self.constraint_name}, {self.nodes})"


class VariableComputationNode(ComputationNode):
    def __init__(
        self, variable: Variable, constraints: Iterable[Constraint]
    ) -> None:
        self.variable = variable
        self.constraints = list(constraints)
        links = [
            ConstraintLink(c.name, [v.name for v in c.dimensions])
            for c in self.constraints
        ]
        super().__init__(variable.name, "VariableComputation", links)

    def _simple_repr(self):
        from ..utils.simple_repr import simple_repr

        return {
            "__qualname__": type(self).__qualname__,
            "__module__": type(self).__module__,
            "variable": simple_repr(self.variable),
            "constraints": [simple_repr(c) for c in self.constraints],
        }

    @classmethod
    def _from_repr(cls, variable, constraints):
        from ..utils.simple_repr import from_repr

        return cls(
            from_repr(variable), [from_repr(c) for c in constraints]
        )


class ComputationConstraintsHyperGraph(ComputationGraph):
    graph_type = "constraints_hypergraph"

    def density(self) -> float:
        # same definition as pyDCOP's (:166): edge endpoints over n^2
        n = self.node_count()
        if n == 0:
            return 0.0
        ends = sum(len(l.nodes) for l in self.links)
        return ends / (n * n)


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[Iterable[Variable]] = None,
    constraints: Optional[Iterable[Constraint]] = None,
) -> ComputationConstraintsHyperGraph:
    """One node per variable; each constraint links all its variables.

    Unary constraints are kept (they influence the local cost) but create no
    inter-node link.
    """
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    cons_of = {v.name: [] for v in variables}
    for c in constraints:
        for v in c.dimensions:
            if v.name in cons_of:
                cons_of[v.name].append(c)

    graph = ComputationConstraintsHyperGraph()
    for v in variables:
        graph.add_node(VariableComputationNode(v, cons_of[v.name]))
    return graph
