"""The port's computation graphs (``pydcop_tpu_torch/computations_graph/``
and ``utils/graphs.py``), which the agent runtime deploys, case for case
the JAX package's ``tests/test_graphs_deep.py``: DFS tree shape on
chains and cycles, pseudo-parent classification of back edges, the
lowest-node constraint-attachment rule, roots and levels, the ordered
chain and the density metrics of every graph model.  Then the two
packages side by side on seeded problems: the same graphs (nodes, links,
pseudo-tree parents, levels), the same ``adhoc`` and ``oneagent``
placements and the same ``utils/graphs`` answers (exact)."""

import pytest

from pydcop_tpu_torch.computations_graph import (
    constraints_hypergraph as chg,
)
from pydcop_tpu_torch.computations_graph import factor_graph as fg
from pydcop_tpu_torch.computations_graph import ordered_graph as og
from pydcop_tpu_torch.computations_graph import pseudotree as pt
from pydcop_tpu_torch.dcop.objects import Domain, Variable
from pydcop_tpu_torch.dcop.relations import constraint_from_str


def _vars(names):
    d = Domain("d", "", [0, 1, 2])
    return {n: Variable(n, d) for n in names}


def _chain(names):
    vs = _vars(names)
    cons = [
        constraint_from_str(
            f"c{a}{b}", f"{a} + {b}", [vs[a], vs[b]]
        )
        for a, b in zip(names, names[1:])
    ]
    return vs, cons


class TestPseudoTree:
    def test_single_var(self):
        vs = _vars(["x"])
        tree = pt.build_computation_graph(
            variables=vs.values(), constraints=[]
        )
        [node] = tree.nodes
        assert node.parent is None
        assert node.children == []
        assert tree.roots[0].name == "x"

    def test_two_var_chain(self):
        vs, cons = _chain(["x", "y"])
        tree = pt.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        by_name = {n.name: n for n in tree.nodes}
        root = tree.roots[0]
        child = by_name[{"x", "y"}.difference({root.name}).pop()]
        assert child.parent == root.name
        assert root.children == [child.name]
        assert child.pseudo_parents == []
        # lowest-node rule: the constraint sits on the child
        assert [c.name for c in child.constraints] == ["cxy"]
        assert root.constraints == []

    def test_3cycle_has_one_pseudo_parent(self):
        # a triangle: DFS tree is a chain, the back edge becomes a
        # pseudo-parent link (reference test_3nodes_tree_cycle:147)
        vs = _vars(["x", "y", "z"])
        cons = [
            constraint_from_str("cxy", "x + y", [vs["x"], vs["y"]]),
            constraint_from_str("cyz", "y + z", [vs["y"], vs["z"]]),
            constraint_from_str("czx", "z + x", [vs["z"], vs["x"]]),
        ]
        tree = pt.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        by_name = {n.name: n for n in tree.nodes}
        # exactly one node carries a pseudo-parent, and it is the deepest
        deepest = max(tree.nodes, key=lambda n: n.depth)
        assert deepest.depth == 2
        pseudo_nodes = [n for n in tree.nodes if n.pseudo_parents]
        assert [n.name for n in pseudo_nodes] == [deepest.name]
        pp = pseudo_nodes[0].pseudo_parents[0]
        assert deepest.name in by_name[pp].pseudo_children
        # every constraint attached at its DFS-lowest scope variable
        attach = {
            c.name: n.name for n in tree.nodes for c in n.constraints
        }
        assert len(attach) == 3
        assert sum(len(n.constraints) for n in tree.nodes) == 3
        # the deepest node sees both of its constraints
        assert len(by_name[deepest.name].constraints) == 2

    def test_3ary_constraint_attaches_once_at_lowest(self):
        vs = _vars(["x", "y", "z"])
        c3 = constraint_from_str(
            "cxyz", "x + y + z", [vs["x"], vs["y"], vs["z"]]
        )
        tree = pt.build_computation_graph(
            variables=vs.values(), constraints=[c3]
        )
        holders = [n for n in tree.nodes if n.constraints]
        assert len(holders) == 1
        assert holders[0].depth == max(n.depth for n in tree.nodes)

    def test_every_edge_is_tree_or_pseudo(self):
        # structural invariant of a DFS pseudo-tree: every constraint edge
        # connects a node to an ancestor/descendant, never across branches
        import random

        random.seed(8)
        names = [f"v{i}" for i in range(10)]
        vs = _vars(names)
        cons = []
        for k in range(14):
            a, b = random.sample(names, 2)
            cons.append(
                constraint_from_str(f"c{k}", f"{a} + {b}", [vs[a], vs[b]])
            )
        tree = pt.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        by_name = {n.name: n for n in tree.nodes}

        def ancestors(n):
            out = set()
            p = by_name[n].parent
            while p is not None:
                out.add(p)
                p = by_name[p].parent
            return out

        for c in cons:
            a, b = (v.name for v in c.dimensions)
            assert (
                a in ancestors(b) or b in ancestors(a)
            ), f"{c.name} crosses branches"

    def test_levels_partition_by_depth(self):
        vs, cons = _chain(["a", "b", "c", "d"])
        tree = pt.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        levels = tree.levels()
        # the max-degree root heuristic roots mid-chain: whatever the
        # shape, levels must partition all nodes and group them by depth
        assert sum(len(lv) for lv in levels) == 4
        for depth, lv in enumerate(levels):
            assert all(n.depth == depth for n in lv)
        # chain: one root, everything else hangs off it contiguously
        assert len(levels[0]) == 1

    def test_forest_has_one_root_per_component(self):
        vs = _vars(["x", "y", "p", "q"])
        cons = [
            constraint_from_str("c1", "x + y", [vs["x"], vs["y"]]),
            constraint_from_str("c2", "p + q", [vs["p"], vs["q"]]),
        ]
        tree = pt.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        assert len(tree.roots) == 2

    def test_deterministic(self):
        vs, cons = _chain(["a", "b", "c"])
        t1 = pt.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        t2 = pt.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        assert [(n.name, n.parent) for n in t1.nodes] == [
            (n.name, n.parent) for n in t2.nodes
        ]


class TestOrderedGraph:
    def test_lexical_chain(self):
        vs, cons = _chain(["b", "a", "c"])
        g = og.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        names = [n.name for n in g.ordered_nodes()]
        assert names == sorted(names)


class TestDensityMetrics:
    """pyDCOP's TestMetrics across models."""

    def _two_var_one_constraint(self):
        vs, cons = _chain(["x", "y"])
        return vs, cons

    def test_factor_graph_density(self):
        vs, cons = self._two_var_one_constraint()
        g = fg.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        # bipartite: 2 edges / (2 vars * 1 factor)
        assert g.density() == pytest.approx(1.0)

    def test_hypergraph_density(self):
        vs, cons = self._two_var_one_constraint()
        g = chg.build_computation_graph(
            variables=vs.values(), constraints=cons
        )
        assert 0 < g.density() <= 1.0


def _problem(pkg, seed, n=14):
    import importlib

    gen = importlib.import_module(f"{pkg}.commands.generators.graphcoloring")
    objs = importlib.import_module(f"{pkg}.dcop.objects")
    dcop = gen.generate_graph_coloring(
        n, 3, graph="random", p_edge=0.3, soft=True, seed=seed
    )
    dcop._agents_def.clear()
    dcop.add_agents([objs.AgentDef(f"a{i}", capacity=40) for i in range(30)])
    return dcop


def _graph_view(pkg, module, algo, seed):
    """A graph module's view of a seeded problem: nodes with their links,
    pseudo-tree fields where present, density, and the adhoc and
    oneagent placements under the algorithm's footprint model."""
    import importlib

    dcop = _problem(pkg, seed)
    gm = importlib.import_module(f"{pkg}.computations_graph.{module}")
    mem = importlib.import_module(f"{pkg}.algorithms.{algo}")
    cg = gm.build_computation_graph(dcop)
    nodes = []
    for node in sorted(cg.nodes, key=lambda n: n.name):
        row = [node.name, node.type, sorted(node.neighbors)]
        for field in ("parent", "pseudo_parents", "children", "depth",
                      "position", "prev_node", "next_node"):
            value = getattr(node, field, None)
            row.append(sorted(value) if isinstance(value, (list, set))
                       else value)
        nodes.append(row)
    placements = []
    for method in ("adhoc", "oneagent"):
        dm = importlib.import_module(f"{pkg}.distribution.{method}")
        try:
            dist = dm.distribute(
                cg, list(dcop.agents.values()),
                computation_memory=mem.computation_memory,
                communication_load=mem.communication_load,
            )
            placements.append({a: sorted(dist.computations_hosted(a))
                               for a in dist.agents})
        except Exception as e:  # the same refusal either way
            placements.append(type(e).__name__)
    return nodes, cg.density(), placements


@pytest.mark.parametrize("module, algo", [
    ("factor_graph", "maxsum"),
    ("constraints_hypergraph", "dsa"),
    ("constraints_hypergraph", "mgm2"),
    ("pseudotree", "dpop"),
    ("pseudotree", "ncbb"),
    ("ordered_graph", "syncbb"),
])
@pytest.mark.parametrize("seed", [1, 4])
def test_graphs_and_placements_like_jax(module, algo, seed):
    pytest.importorskip("jax")
    assert _graph_view("pydcop_tpu_torch", module, algo, seed) == (
        _graph_view("pydcop_tpu", module, algo, seed))


@pytest.mark.parametrize("seed", [1, 4])
def test_graph_utils_like_jax(seed):
    pytest.importorskip("jax")
    import importlib

    out = {}
    for pkg in ("pydcop_tpu_torch", "pydcop_tpu"):
        graphs = importlib.import_module(f"{pkg}.utils.graphs")
        dcop = _problem(pkg, seed)
        variables = list(dcop.variables.values())
        relations = list(dcop.constraints.values())
        bip = graphs.as_bipartite_graph(variables, relations)
        out[pkg] = (
            {k: sorted(v) for k, v in bip.items()},
            graphs.graph_diameter(variables, relations),
            graphs.cycles_count(variables, relations),
            graphs.all_pairs([v.name for v in variables]),
        )
    assert out["pydcop_tpu_torch"] == out["pydcop_tpu"]
