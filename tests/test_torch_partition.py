"""The port's multilevel partitioner and ``tpu_part`` against the JAX
package's, on the CPU.

Bars: ``multilevel_assign`` gives the same part array on the same seeded
random graphs (sizes from a handful of vertices to a few hundred, 2 to 5
parts, exact and uneven targets); ``tpu_part.distribute`` gives the same
``agent_for`` map on seeded computation graphs with uneven agent
capacities; and the router's own bucket graphs (one node a bucket,
same-algorithm buckets chained) for 2 to 5 workers and 1 to 40 buckets
are laid out alike by both packages' ``Router._compute_placement``,
through ``tpu_part`` and never through its modulo fallback.
"""

import logging

import numpy as np
import pytest

from pydcop_tpu.computations_graph import objects as jax_cg
from pydcop_tpu.dcop.objects import AgentDef as JaxAgentDef
from pydcop_tpu.distribution import tpu_part as jax_tpu_part
from pydcop_tpu.partition.multilevel import (
    multilevel_assign as jax_multilevel_assign,
)
from pydcop_tpu_torch.computations_graph import objects as cg
from pydcop_tpu_torch.dcop.objects import AgentDef
from pydcop_tpu_torch.distribution import tpu_part
from pydcop_tpu_torch.partition import multilevel_assign


def _random_csr(rng, n, avg_degree):
    """A symmetric weighted graph as (indptr, nbr, wgt), edges sorted by
    (src, dst), duplicates merged (weights summed)."""
    m = max(1, int(n * avg_degree / 2))
    a = rng.integers(0, n, m)
    b = rng.integers(0, n, m)
    keep = a != b
    a, b = a[keep], b[keep]
    w = rng.integers(1, 5, a.size).astype(np.float64)
    src = np.concatenate([a, b]).astype(np.int64)
    dst = np.concatenate([b, a]).astype(np.int64)
    wgt = np.concatenate([w, w])
    key = src * n + dst
    uniq, inv = np.unique(key, return_inverse=True)
    wsum = np.bincount(inv, weights=wgt)
    s, d = uniq // n, uniq % n
    indptr = np.searchsorted(s, np.arange(n + 1))
    return indptr, d, wsum


def _targets(rng, n, k, uneven):
    if not uneven:
        base = np.full(k, n // k, dtype=np.int64)
        base[: n - base.sum()] += 1
        return base
    cuts = np.sort(rng.integers(0, n + 1, k - 1))
    return np.diff(np.concatenate([[0], cuts, [n]])).astype(np.int64)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n, avg_degree", [(7, 2.0), (40, 3.0),
                                           (150, 4.0), (400, 5.0)])
def test_multilevel_assign_is_jaxs(seed, n, avg_degree):
    rng = np.random.default_rng(seed * 1000 + n)
    indptr, nbr, wgt = _random_csr(rng, n, avg_degree)
    for k in (2, 3, 5):
        targets = _targets(rng, n, k, uneven=bool(seed % 2))
        got = multilevel_assign(indptr, nbr, wgt, targets)
        want = jax_multilevel_assign(indptr, nbr, wgt, targets)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            np.bincount(got, minlength=k), targets)


def test_multilevel_assign_edge_cases_are_jaxs():
    empty = (np.zeros(1, np.int64), np.zeros(0, np.int64),
             np.zeros(0, np.float64))
    for fn in (multilevel_assign, jax_multilevel_assign):
        assert fn(*empty, np.array([0, 0])).size == 0
    # no edges at all, one part, a bad target sum
    free = (np.zeros(6, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.float64))
    for targets in ([1, 2, 2], [5], [3, 2]):
        np.testing.assert_array_equal(
            multilevel_assign(*free, np.array(targets)),
            jax_multilevel_assign(*free, np.array(targets)))
    for fn in (multilevel_assign, jax_multilevel_assign):
        with pytest.raises(ValueError, match="targets sum"):
            fn(*free, np.array([1, 1]))


def _graphs(rng, n_nodes, p_link):
    """The same seeded computation graph in each package's objects."""
    names = [f"c{i:03d}" for i in range(n_nodes)]
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]
             if rng.random() < p_link]
    out = []
    for mod in (cg, jax_cg):
        links = {nm: [] for nm in names}
        for a, b in pairs:
            link = mod.Link((a, b))
            links[a].append(link)
            links[b].append(link)
        out.append(mod.ComputationGraph(nodes=[
            mod.ComputationNode(nm, "var", links=links[nm])
            for nm in names]))
    return out


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("n_nodes, n_agents", [(1, 3), (12, 2), (30, 3),
                                               (60, 4), (90, 5)])
def test_tpu_part_distribute_is_jaxs(seed, n_nodes, n_agents):
    rng = np.random.default_rng(seed + 31 * n_nodes)
    graph, jax_graph = _graphs(rng, n_nodes, p_link=min(1.0, 4.0 / n_nodes))
    caps = rng.integers(50, 200, n_agents).astype(float)
    loads = {}

    def load(node, neigh):
        # a message load by edge, the same for both packages' nodes
        key = tuple(sorted((node.name, neigh)))
        return loads.setdefault(key, float(1 + rng.integers(4)))

    agents = [AgentDef(f"a{i}", capacity=c) for i, c in enumerate(caps)]
    jax_agents = [JaxAgentDef(f"a{i}", capacity=c)
                  for i, c in enumerate(caps)]
    got = tpu_part.distribute(graph, agents, communication_load=load)
    want = jax_tpu_part.distribute(jax_graph, jax_agents,
                                   communication_load=load)
    assert got.mapping == want.mapping
    for node in graph.nodes:
        assert got.agent_for(node.name) == want.agent_for(node.name)
    assert tpu_part.distribution_cost(
        got, graph, agents, communication_load=load
    ) == jax_tpu_part.distribution_cost(
        want, jax_graph, jax_agents, communication_load=load)


def test_tpu_part_refuses_what_jaxs_refuses():
    graph, jax_graph = _graphs(np.random.default_rng(0), 8, 0.5)
    from pydcop_tpu.distribution.objects import (
        ImpossibleDistributionException as JaxImpossible,
    )
    from pydcop_tpu_torch.distribution.objects import (
        ImpossibleDistributionException,
    )

    with pytest.raises(ImpossibleDistributionException, match="no agents"):
        tpu_part.distribute(graph, [])
    with pytest.raises(JaxImpossible, match="no agents"):
        jax_tpu_part.distribute(jax_graph, [])
    # a memory footprint over the capacity of a block's agent
    small = [AgentDef("a0", capacity=1.0), AgentDef("a1", capacity=1.0)]
    jax_small = [JaxAgentDef("a0", capacity=1.0),
                 JaxAgentDef("a1", capacity=1.0)]
    with pytest.raises(ImpossibleDistributionException, match="capacity"):
        tpu_part.distribute(graph, small, computation_memory=lambda n: 2.0)
    with pytest.raises(JaxImpossible, match="capacity"):
        jax_tpu_part.distribute(jax_graph, jax_small,
                                computation_memory=lambda n: 2.0)


ALGOS = ("dsa", "maxsum", "mgm")


def _buckets(n):
    """n affinity keys of the router's form, algorithms interleaved."""
    out = []
    for i in range(n):
        algo = ALGOS[i % len(ALGOS)]
        v, c = 2 ** (1 + (i // 3) % 7), 2 ** (1 + (i // 5) % 6)
        out.append(f"{algo}/v{v}c{c}")
    return sorted(set(out))


def _routers(n_workers):
    from pydcop_tpu.serve.router import Router as JaxRouter
    from pydcop_tpu.telemetry.federate import FleetTarget as JaxTarget
    from pydcop_tpu_torch.serve.router import Router
    from pydcop_tpu_torch.telemetry.federate import FleetTarget

    names = [f"w{i}" for i in range(n_workers)]

    def fetch(url):
        return None

    return (
        Router([FleetTarget(w, f"http://fake/{w}") for w in names],
               fetch=fetch, post=lambda u, d: None),
        JaxRouter([JaxTarget(w, f"http://fake/{w}") for w in names],
                  fetch=fetch, post=lambda u, d: None),
        names,
    )


@pytest.mark.parametrize("n_workers", [2, 3, 4, 5])
@pytest.mark.parametrize("n_buckets", [1, 2, 3, 5, 8, 13, 21, 40])
def test_router_bucket_placement_is_jaxs(n_workers, n_buckets, caplog):
    router, jax_router, workers = _routers(n_workers)
    buckets = _buckets(n_buckets)
    counts = {b: 1 + i % 4 for i, b in enumerate(buckets)}
    with caplog.at_level(logging.ERROR):
        got = router._compute_placement(buckets, counts, workers)
        want = jax_router._compute_placement(buckets, counts, workers)
    # placement took the tpu_part path: no modulo fallback was logged
    assert not [r for r in caplog.records if "falling back" in r.message]
    assert got == want
    assert set(got) == set(buckets) and set(got.values()) <= set(workers)
    # one worker per bucket, and the map is tpu_part's over the chain
    # graph of the router's construction
    if n_workers > 1:
        graph_links = {b: [] for b in buckets}
        by_algo = {}
        for b in buckets:
            by_algo.setdefault(b.split("/", 1)[0], []).append(b)
        for group in by_algo.values():
            for a, b in zip(group, group[1:]):
                link = cg.Link((a, b))
                graph_links[a].append(link)
                graph_links[b].append(link)
        graph = cg.ComputationGraph(nodes=[
            cg.ComputationNode(b, "bucket", links=graph_links[b])
            for b in buckets])
        dist = tpu_part.distribute(
            graph, [AgentDef(w, capacity=100.0) for w in workers],
            communication_load=lambda _n, _m: 1.0)
        assert got == {b: dist.agent_for(b) for b in buckets}
    router.collector.stop()
    jax_router.collector.stop()


# -- the sharded ELL's row orderings and the cross-shard model ----------


def _clique_pair(n=24, d=3, seed=0):
    """One seeded clique with per-constraint tables, compiled by each
    package from the same arrays."""
    from pydcop_tpu.compile.direct import (
        compile_from_edges as jax_compile_from_edges,
    )
    from pydcop_tpu_torch.compile.direct import compile_from_edges

    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(n, k=1)
    edges = np.stack([ii, jj], axis=1)
    tables = rng.uniform(0, 10, size=(len(edges), d, d)).astype(np.float32)
    return (compile_from_edges(n, d, edges, tables),
            jax_compile_from_edges(n, d, edges, tables))


def _problem_pair(kind):
    """The same problem compiled by both packages (the JAX partition
    tests' corpus, smaller, and a ternary one)."""
    from pydcop_tpu.commands.generators.graphcoloring import (
        generate_coloring_arrays as jax_coloring,
    )
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_coloring_arrays,
    )

    if kind == "clique":
        return _clique_pair()
    if kind == "ternary":
        from pydcop_tpu.commands.generators.mixedproblem import (
            generate_mixed_problem as jax_mixed,
        )
        from pydcop_tpu.compile.core import compile_dcop as jax_compile
        from pydcop_tpu_torch.commands.generators.mixedproblem import (
            generate_mixed_problem,
        )
        from pydcop_tpu_torch.compile.core import compile_dcop

        args = (40, 30, 0.3)
        kw = dict(arity=3, domain_range=3, density=0.1, seed=5)
        return (compile_dcop(generate_mixed_problem(*args, **kw)),
                jax_compile(jax_mixed(*args, **kw)))
    kw = {
        "scalefree": dict(graph="scalefree", m_edge=2, seed=11),
        "grid": dict(graph="grid", seed=12),
        "random": dict(graph="random", p_edge=0.02, seed=13),
    }[kind]
    n = 256 if kind == "grid" else 400
    return generate_coloring_arrays(n, 3, **kw), jax_coloring(n, 3, **kw)


KINDS = ["scalefree", "grid", "random", "clique", "ternary"]


def _equal(got, want):
    assert type(got) is type(want)
    if isinstance(got, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _equal(got[k], want[k])
    else:
        assert got == want


@pytest.mark.parametrize("kind", KINDS)
def test_variable_graph_and_bfs_order_are_jaxs(kind):
    from pydcop_tpu.parallel.placement import bfs_order as jax_bfs
    from pydcop_tpu.partition import variable_graph as jax_variable_graph
    from pydcop_tpu_torch.parallel.placement import bfs_order
    from pydcop_tpu_torch.partition import variable_graph

    port, jax = _problem_pair(kind)
    _equal(variable_graph(port), jax_variable_graph(jax))
    _equal(variable_graph(port, 2), jax_variable_graph(jax, 2))
    _equal(bfs_order(port), jax_bfs(jax))


@pytest.mark.parametrize("n, k, row_chunk", [
    (10, 1, None), (100, 8, None), (17, 4, None), (30, 4, 8), (1, 3, None),
])
def test_chunk_targets_are_jaxs(n, k, row_chunk):
    from pydcop_tpu.partition import chunk_targets as jax_chunk_targets
    from pydcop_tpu_torch.partition import chunk_targets

    _equal(chunk_targets(n, k, row_chunk), jax_chunk_targets(n, k, row_chunk))
    for bad in ((5, 0, None), (100, 4, 10)):
        with pytest.raises(ValueError):
            chunk_targets(*bad)
        with pytest.raises(ValueError):
            jax_chunk_targets(*bad)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [2, 4, 8])
def test_partition_order_is_jaxs(kind, k):
    from pydcop_tpu.partition import partition_order as jax_partition_order
    from pydcop_tpu_torch.partition import partition_order

    port, jax = _problem_pair(kind)
    for effort in ("fast", "quality"):
        order, assign, info = partition_order(port, k, effort=effort)
        j_order, j_assign, j_info = jax_partition_order(jax, k,
                                                       effort=effort)
        _equal((order, assign), (j_order, j_assign))
        info.pop("order_wall_s")
        j_info.pop("order_wall_s")
        _equal(info, j_info)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("strategy", ["auto", "none", "bfs", "multilevel"])
def test_ell_shard_assignment_is_jaxs(kind, strategy):
    from pydcop_tpu.partition import (
        ell_shard_assignment as jax_ell_shard_assignment,
    )
    from pydcop_tpu_torch.partition import ell_shard_assignment

    port, jax = _problem_pair(kind)
    for n_shards, row_chunk in ((1, None), (4, None), (3, 200)):
        _equal(ell_shard_assignment(port, n_shards, row_chunk, strategy),
               jax_ell_shard_assignment(jax, n_shards, row_chunk, strategy))
    with pytest.raises(ValueError):
        ell_shard_assignment(port, 4, None, "nope")


def test_partitioned_layout_is_jaxs():
    # partition_compiled stamps the meta that ell_shard_assignment's auto
    # resolution reads; reorder_compiled and the incidence diagnostics
    from pydcop_tpu.parallel import placement as jax_placement
    from pydcop_tpu.partition import (
        ell_shard_assignment as jax_ell_shard_assignment,
    )
    from pydcop_tpu_torch.parallel import placement
    from pydcop_tpu_torch.partition import ell_shard_assignment

    port, jax = _problem_pair("scalefree")
    for strategy, k in (("bfs", None), ("multilevel", 4), ("auto", 4)):
        got = placement.partition_compiled(port, strategy, k)
        want = jax_placement.partition_compiled(jax, strategy, k)
        for field in ("var_names", "domain_size", "unary", "edge_var",
                      "edge_con", "var_degree"):
            _equal(getattr(got, field), getattr(want, field))
        for b, jb in zip(got.buckets, want.buckets):
            _equal((b.var_slots, b.edge_ids, b.con_ids, b.tables),
                   (jb.var_slots, jb.edge_ids, jb.con_ids, jb.tables))
        for shards in (2, 4, 8):
            assert placement.cross_shard_edges(got, shards) == (
                jax_placement.cross_shard_edges(want, shards))
            assert placement.cross_shard_incidence(got, shards) == (
                jax_placement.cross_shard_incidence(want, shards))
        if k:
            _equal(ell_shard_assignment(got, k, None, "auto"),
                   jax_ell_shard_assignment(want, k, None, "auto"))
    with pytest.raises(ValueError):
        placement.partition_compiled(port, "multilevel", 1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("plane_dtype", ["f32", "bf16"])
def test_ici_model_and_block_are_jaxs(kind, plane_dtype):
    from pydcop_tpu.partition import ici_block as jax_ici_block
    from pydcop_tpu.partition import ici_model as jax_ici_model
    from pydcop_tpu_torch.partition import ici_block, ici_model

    port, jax = _problem_pair(kind)
    for n_shards in (1, 4, 8):
        _equal(ici_model(port, None, n_shards, plane_dtype),
               jax_ici_model(jax, None, n_shards, plane_dtype))
    got = ici_block(port, 4, plane_dtype)
    want = jax_ici_block(jax, 4, plane_dtype)
    for block in (got, want):  # the walls left out
        for strategy in ("bfs", "multilevel"):
            block[strategy].pop("order_wall_s")
    _equal(got, want)
    with pytest.raises(ValueError):
        ici_model(port, np.zeros(3, dtype=np.int64), 4)
