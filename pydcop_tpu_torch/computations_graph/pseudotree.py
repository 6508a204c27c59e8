"""DFS pseudo-tree: tree + pseudo-parent edges, for DPOP and NCBB.

The port's copy of ``pydcop_tpu/computations_graph/pseudotree.py``: a
deterministic, iterative host-side DFS (max-degree root, each constraint
on its lowest node, forests handled), whose output also carries the
schedule, the nodes grouped by depth level.  The agent runtime deploys
its nodes for DPOP and NCBB; their solvers build their own trees from
the compiled problem.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..dcop.dcop import DCOP
from ..dcop.objects import Variable
from ..dcop.relations import Constraint
from .objects import ComputationGraph, ComputationNode, Link

__all__ = [
    "PseudoTreeLink",
    "PseudoTreeNode",
    "ComputationPseudoTree",
    "build_computation_graph",
    "get_dfs_relations",
]


class PseudoTreeLink(Link):
    """Link types: 'parent' (tree edge) or 'pseudo_parent' (back edge)."""

    def __init__(self, link_type: str, source: str, target: str) -> None:
        super().__init__((source, target), link_type)
        self.source = source
        self.target = target

    def __repr__(self):
        return f"PseudoTreeLink({self.type}, {self.source} -> {self.target})"


class PseudoTreeNode(ComputationNode):
    """A variable node of the pseudo-tree, with its DFS relations and the
    constraints attached to it (lowest-node rule)."""

    def __init__(
        self,
        variable: Variable,
        parent: Optional[str],
        pseudo_parents: List[str],
        children: List[str],
        pseudo_children: List[str],
        constraints: List[Constraint],
        depth: int,
    ) -> None:
        links = []
        if parent:
            links.append(PseudoTreeLink("parent", variable.name, parent))
        for pp in pseudo_parents:
            links.append(PseudoTreeLink("pseudo_parent", variable.name, pp))
        for c in children:
            links.append(PseudoTreeLink("parent", c, variable.name))
        for pc in pseudo_children:
            links.append(PseudoTreeLink("pseudo_parent", pc, variable.name))
        super().__init__(variable.name, "PseudoTreeComputation", links)
        self.variable = variable
        self.parent = parent
        self.pseudo_parents = list(pseudo_parents)
        self.children = list(children)
        self.pseudo_children = list(pseudo_children)
        self.constraints = list(constraints)
        self.depth = depth


def get_dfs_relations(
    node: PseudoTreeNode,
) -> Tuple[Optional[str], List[str], List[str], List[str]]:
    """(parent, pseudo_parents, children, pseudo_children) — pyDCOP
    pseudotree.py:178."""
    return (
        node.parent,
        list(node.pseudo_parents),
        list(node.children),
        list(node.pseudo_children),
    )


class ComputationPseudoTree(ComputationGraph):
    graph_type = "pseudotree"

    def __init__(self, nodes: Iterable[PseudoTreeNode]) -> None:
        super().__init__(nodes)

    @property
    def roots(self) -> List[PseudoTreeNode]:
        return [n for n in self.nodes if n.parent is None]

    def levels(self) -> List[List[PseudoTreeNode]]:
        """Nodes grouped by depth — the DPOP UTIL/VALUE wave schedule."""
        by_depth: Dict[int, List[PseudoTreeNode]] = {}
        for n in self.nodes:
            by_depth.setdefault(n.depth, []).append(n)
        return [by_depth[d] for d in sorted(by_depth)]


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[Iterable[Variable]] = None,
    constraints: Optional[Iterable[Constraint]] = None,
) -> ComputationPseudoTree:
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    var_names = [v.name for v in variables]
    by_name = {v.name: v for v in variables}

    # variable adjacency via shared constraints
    adjacency: Dict[str, Set[str]] = {n: set() for n in var_names}
    for c in constraints:
        scope = [v.name for v in c.dimensions if v.name in adjacency]
        for a in scope:
            for b in scope:
                if a != b:
                    adjacency[a].add(b)

    parent: Dict[str, Optional[str]] = {}
    depth: Dict[str, int] = {}
    order: Dict[str, int] = {}  # DFS visit order (ancestor test)
    children: Dict[str, List[str]] = {n: [] for n in var_names}
    visited: Set[str] = set()
    counter = 0

    unvisited = set(var_names)
    while unvisited:
        # max-degree root heuristic, ties broken by name for determinism
        root = max(
            sorted(unvisited), key=lambda n: (len(adjacency[n]), n)
        )
        # iterative DFS
        stack: List[Tuple[str, Optional[str]]] = [(root, None)]
        while stack:
            node, par = stack.pop()
            if node in visited:
                continue
            visited.add(node)
            unvisited.discard(node)
            parent[node] = par
            depth[node] = 0 if par is None else depth[par] + 1
            order[node] = counter
            counter += 1
            if par is not None:
                children[par].append(node)
            # deterministic order: visit higher-degree neighbors first
            neighs = sorted(
                (n for n in adjacency[node] if n not in visited),
                key=lambda n: (len(adjacency[n]), n),
            )
            for n in neighs:
                stack.append((n, node))

    # ancestor sets for pseudo-parent classification
    def ancestors(n: str) -> Set[str]:
        out = set()
        p = parent[n]
        while p is not None:
            out.add(p)
            p = parent[p]
        return out

    anc = {n: ancestors(n) for n in var_names}

    pseudo_parents: Dict[str, List[str]] = {n: [] for n in var_names}
    pseudo_children: Dict[str, List[str]] = {n: [] for n in var_names}
    for n in var_names:
        for m in sorted(adjacency[n], key=lambda x: order[x]):
            if m == parent[n] or n == parent.get(m):
                continue
            if m in anc[n]:
                pseudo_parents[n].append(m)
                if n not in pseudo_children[m]:
                    pseudo_children[m].append(n)

    # lowest-node rule: each constraint attached to the deepest (latest in DFS
    # order) variable of its scope (pyDCOP pseudotree.py:452)
    constraints_of: Dict[str, List[Constraint]] = {n: [] for n in var_names}
    for c in constraints:
        scope = [v.name for v in c.dimensions if v.name in order]
        if not scope:
            continue
        lowest = max(scope, key=lambda n: order[n])
        constraints_of[lowest].append(c)

    nodes = [
        PseudoTreeNode(
            by_name[n],
            parent[n],
            pseudo_parents[n],
            children[n],
            pseudo_children[n],
            constraints_of[n],
            depth[n],
        )
        for n in var_names
    ]
    return ComputationPseudoTree(nodes)
