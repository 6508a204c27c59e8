"""Factor graph: one computation per variable AND per constraint.

The port's copy of ``pydcop_tpu/computations_graph/factor_graph.py``:
the bipartite variable/factor graph that MaxSum's footprint model
(``algorithms/maxsum.computation_memory``) and the IoT generator read.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from ..dcop.dcop import DCOP
from ..dcop.objects import Variable
from ..dcop.relations import Constraint
from .objects import ComputationGraph, ComputationNode, Link

__all__ = [
    "VariableComputationNode",
    "FactorComputationNode",
    "FactorGraphLink",
    "ComputationsFactorGraph",
    "build_computation_graph",
]


class FactorGraphLink(Link):
    def __init__(self, variable_node: str, factor_node: str) -> None:
        super().__init__((variable_node, factor_node), "var_factor")


class VariableComputationNode(ComputationNode):
    def __init__(self, variable: Variable, factor_names: Iterable[str]) -> None:
        links = [FactorGraphLink(variable.name, f) for f in factor_names]
        super().__init__(variable.name, "VariableComputation", links)
        self.variable = variable

    def _simple_repr(self):
        from ..utils.simple_repr import simple_repr

        return {
            "__qualname__": type(self).__qualname__,
            "__module__": type(self).__module__,
            "variable": simple_repr(self.variable),
            "factor_names": [
                n for l in self.links for n in l.nodes if n != self.name
            ],
        }

    @classmethod
    def _from_repr(cls, variable, factor_names):
        from ..utils.simple_repr import from_repr

        return cls(from_repr(variable), factor_names)


class FactorComputationNode(ComputationNode):
    def __init__(self, factor: Constraint) -> None:
        links = [FactorGraphLink(v.name, factor.name) for v in factor.dimensions]
        super().__init__(factor.name, "FactorComputation", links)
        self.factor = factor

    @property
    def variables(self) -> List[Variable]:
        return self.factor.dimensions

    def _simple_repr(self):
        from ..utils.simple_repr import simple_repr

        return {
            "__qualname__": type(self).__qualname__,
            "__module__": type(self).__module__,
            "factor": simple_repr(self.factor),
        }

    @classmethod
    def _from_repr(cls, factor):
        from ..utils.simple_repr import from_repr

        return cls(from_repr(factor))


class ComputationsFactorGraph(ComputationGraph):
    graph_type = "factor_graph"

    @property
    def variable_nodes(self) -> List[VariableComputationNode]:
        return [n for n in self.nodes if isinstance(n, VariableComputationNode)]

    @property
    def factor_nodes(self) -> List[FactorComputationNode]:
        return [n for n in self.nodes if isinstance(n, FactorComputationNode)]

    def density(self) -> float:
        # bipartite density: edges / (vars * factors)
        nv, nf = len(self.variable_nodes), len(self.factor_nodes)
        if not nv or not nf:
            return 0.0
        return self.link_count() / (nv * nf)


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[Iterable[Variable]] = None,
    constraints: Optional[Iterable[Constraint]] = None,
) -> ComputationsFactorGraph:
    """Build the bipartite variable/factor graph for a DCOP.  Unary variable costs stay attached to the variable
    (they do not become factors).

    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> from pydcop_tpu_torch.dcop.relations import constraint_from_str
    >>> d = Domain('d', '', [0, 1])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> c = constraint_from_str('c1', 'x + y', [x, y])
    >>> g = build_computation_graph(variables=[x, y], constraints=[c])
    >>> sorted(n.name for n in g.nodes)
    ['c1', 'x', 'y']
    >>> sorted(g.neighbors('c1'))
    ['x', 'y']
    """
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    factors_of = {v.name: [] for v in variables}
    for c in constraints:
        for v in c.dimensions:
            if v.name in factors_of:
                factors_of[v.name].append(c.name)

    graph = ComputationsFactorGraph()
    for v in variables:
        graph.add_node(VariableComputationNode(v, factors_of[v.name]))
    for c in constraints:
        graph.add_node(FactorComputationNode(c))
    return graph
