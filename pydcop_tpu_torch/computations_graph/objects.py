"""Computation-graph base objects.

The port's copy of ``pydcop_tpu/computations_graph/objects.py``: nodes
(``ComputationNode``), (hyper)edges (``Link``) and the graph
(``ComputationGraph``).  Nodes are serializable; links may be
hyperedges.  These graphs are host-side metadata: the solvers lower a
problem to tensors and never walk them; the generators read them to size
agents (``generators/iot.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set

from ..utils.simple_repr import SimpleRepr

__all__ = ["ComputationNode", "Link", "ComputationGraph"]


class Link(SimpleRepr):
    """A (hyper)edge between computation nodes, with a type tag."""

    _repr_fields = ("link_type", "nodes")

    def __init__(self, nodes: Iterable[str], link_type: str = "link") -> None:
        self._nodes = tuple(sorted(nodes))
        self._link_type = link_type

    @property
    def nodes(self) -> Sequence[str]:
        return self._nodes

    @property
    def type(self) -> str:
        return self._link_type

    def has_node(self, name: str) -> bool:
        return name in self._nodes

    @classmethod
    def _from_repr(cls, link_type, nodes):
        # always rebuild a BASE link: subclasses (PseudoTreeLink, OrderLink,
        # FactorGraphLink) have richer constructors but links only ship as
        # graph metadata (see ComputationNode docstring)
        return Link(nodes, link_type)

    def __eq__(self, other):
        return (
            isinstance(other, Link)
            and other._nodes == self._nodes
            and other._link_type == self._link_type
        )

    def __hash__(self):
        return hash((self._nodes, self._link_type))

    def __repr__(self) -> str:
        return f"Link({self._link_type}, {self._nodes})"


class ComputationNode(SimpleRepr):
    """A node in a computation graph: a named unit of computation with links.

    ``type`` identifies the node kind for the algorithm (e.g. VariableComputation
    vs FactorComputation in a factor graph).

    Serialization note: nodes are shipped to agents at deploy/replication time
    (inside ComputationDefs).  They deserialize as *base* ComputationNodes —
    name, type and links (so neighbors survive) — because the TPU runtime
    recompiles device arrays from the DCOP itself; algorithm-specific node
    payloads (Variable/Constraint objects) never need to travel.
    """

    _repr_fields = ("name", "node_type", "links")

    def __init__(
        self,
        name: str,
        node_type: str = "computation",
        links: Optional[Iterable[Link]] = None,
    ) -> None:
        self._name = name
        self._node_type = node_type
        self._links = list(links) if links else []

    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return self._node_type

    @property
    def links(self) -> List[Link]:
        return list(self._links)

    @property
    def neighbors(self) -> List[str]:
        out: List[str] = []
        for l in self._links:
            for n in l.nodes:
                if n != self._name and n not in out:
                    out.append(n)
        return out

    def add_link(self, link: Link) -> None:
        self._links.append(link)

    @classmethod
    def _from_repr(cls, name, node_type, links):
        # always rebuild a BASE node (see class docstring): subclasses carry
        # runtime-only payloads that are not shipped
        return ComputationNode(name, node_type, links)

    def __eq__(self, other):
        return (
            isinstance(other, ComputationNode)
            and other.name == self.name
            and other.type == self.type
        )

    def __hash__(self):
        return hash((self._name, self._node_type))

    def __repr__(self) -> str:
        return f"ComputationNode({self._name}, {self._node_type})"


class ComputationGraph:
    """Base class for computation graphs.

    Subclasses set ``graph_type`` and provide ``nodes``; links are derived.
    """

    graph_type = "generic"

    def __init__(
        self, nodes: Optional[Iterable[ComputationNode]] = None
    ) -> None:
        self._nodes: Dict[str, ComputationNode] = {}
        for n in nodes or []:
            self.add_node(n)

    def add_node(self, node: ComputationNode) -> None:
        self._nodes[node.name] = node

    @property
    def nodes(self) -> List[ComputationNode]:
        return list(self._nodes.values())

    def computation(self, name: str) -> ComputationNode:
        try:
            return self._nodes[name]
        except KeyError:
            raise KeyError(f"no computation {name} in graph")

    def computations(self) -> List[ComputationNode]:
        return list(self._nodes.values())

    @property
    def links(self) -> List[Link]:
        seen: Set[Link] = set()
        out: List[Link] = []
        for n in self._nodes.values():
            for l in n.links:
                if l not in seen:
                    seen.add(l)
                    out.append(l)
        return out

    def neighbors(self, name: str) -> List[str]:
        return self.computation(name).neighbors

    def node_count(self) -> int:
        return len(self._nodes)

    def link_count(self) -> int:
        return len(self.links)

    def density(self) -> float:
        n = self.node_count()
        if n <= 1:
            return 0.0
        return 2 * self.link_count() / (n * (n - 1))

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}({self.node_count()} nodes, "
            f"{self.link_count()} links)"
        )
