"""The port's replica placement (``pydcop_tpu_torch/replication/``,
``resilience/``) against the JAX package's, on the CPU.

The path helpers, ``ucs_paths`` and ``owner_paths`` (the port's closed
form of the search for the owner's knowledge model) against JAX's search, the replica objects and
their YAML byte for byte, ``ucs_replica_hosts`` on seeded agent sets,
then the thread runtime: the ``distributed`` negotiation and the
``local`` placement of both packages equal to the oracle on a quiet
network (JAX's ``TestQuietNetworkEquivalence``), partial k, retraction
on a smaller k, shedding on lost capacity, migration onto a replica
holder, and the ``/status`` replication block.  Every wait is bounded.
"""

import random
import time

import pytest

from pydcop_tpu.dcop import AgentDef as JaxAgentDef
from pydcop_tpu.dcop import DCOP as JaxDCOP
from pydcop_tpu.dcop import Domain as JaxDomain
from pydcop_tpu.dcop import Variable as JaxVariable
from pydcop_tpu.dcop import constraint_from_str as jax_constraint
from pydcop_tpu.infrastructure.run import (
    run_local_thread_dcop as jax_run_local_thread_dcop,
)
from pydcop_tpu.replication import path_utils as jax_path_utils
from pydcop_tpu.replication import ucs_replica_hosts as jax_ucs_replica_hosts
from pydcop_tpu.replication.objects import (
    ReplicaDistribution as JaxReplicaDistribution,
)
from pydcop_tpu.replication.yamlformat import (
    yaml_replica_dist as jax_yaml_replica_dist,
)
from pydcop_tpu_torch.dcop import (
    DCOP,
    AgentDef,
    Domain,
    Variable,
    constraint_from_str,
)
from pydcop_tpu_torch.distribution.objects import Distribution
from pydcop_tpu_torch.infrastructure.orchestrator import (
    replication_timeout_detail,
)
from pydcop_tpu_torch.infrastructure.run import run_local_thread_dcop
from pydcop_tpu_torch.replication import (
    hosting_cost_of,
    path_utils,
    rank_hosts,
    ucs_replica_hosts,
)
from pydcop_tpu_torch.replication.objects import ReplicaDistribution
from pydcop_tpu_torch.replication.yamlformat import (
    load_replica_dist,
    yaml_replica_dist,
)
from pydcop_tpu_torch.telemetry import telemetry_off
from pydcop_tpu_torch.telemetry.metrics import metrics_registry


@pytest.fixture(autouse=True)
def _telemetry_teardown():
    yield
    telemetry_off()


def _poll(predicate, timeout=30.0):
    """Commits and retractions are fire-and-forget: wait for the
    condition itself, bounded."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


# ---------------------------------------------------------------------------
# path helpers, ucs_paths, replica objects
# ---------------------------------------------------------------------------


def _path_table(seed):
    rng = random.Random(seed)
    names = [f"a{i}" for i in range(6)]
    table = {}
    for _ in range(12):
        path = tuple(rng.sample(names, rng.randint(1, 4)))
        table[path] = round(rng.uniform(0, 5), 2)
    return names, table


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_path_helpers_match_jax(seed):
    names, table = _path_table(seed)
    for target in names:
        assert (path_utils.cheapest_path_to(target, table)
                == jax_path_utils.cheapest_path_to(target, table))
    for budget in (0.5, 2.0, 10.0):
        for start in names:
            assert (path_utils.affordable_path_from(start, budget, table)
                    == jax_path_utils.affordable_path_from(start, budget,
                                                           table))
    gone = names[:2]
    assert (path_utils.filter_missing_agents_paths(table, gone)
            == jax_path_utils.filter_missing_agents_paths(table, gone))


def _routes(seed, n, spread=1.0, decimals=2):
    rng = random.Random(seed)
    names = [f"a{i}" for i in range(n)]
    drawn = {(a, b): round(rng.uniform(0, spread), decimals)
             for a in names for b in names if a < b}
    if seed % 2:
        # some routes unknown: infinite, as a missing link
        for key in rng.sample(sorted(drawn), n):
            drawn[key] = float("inf")
    return names, drawn


@pytest.mark.parametrize("seed, n, spread", [
    (0, 5, 1.0), (1, 8, 1.0), (2, 12, 100.0), (3, 12, 0.5), (4, 30, 100.0),
    (5, 30, 0.05),
])
def test_ucs_paths_match_jax(seed, n, spread):
    names, drawn = _routes(seed, n, spread)

    def route(a, b):
        return drawn.get((a, b), drawn.get((b, a), 1.0))

    for start in names[:4]:
        want = jax_path_utils.ucs_paths(start, route, names)
        assert path_utils.ucs_paths(start, route, names) == want

        # the owner's knowledge (its own routes, 1.0 for every other
        # hop): owner_paths gives the search's dict, floats and order
        def owner_route(a, b, _s=start):
            return route(a, b) if a == _s else 1.0

        want = jax_path_utils.ucs_paths(start, owner_route, names)
        got = path_utils.owner_paths(start, owner_route, names)
        assert got == want
        assert list(got) == list(want)


def test_replica_objects_and_yaml_match_jax():
    mapping = {"c1": ["a2", "a1"], "c0": ["a0"], "c2": []}
    port, jax = ReplicaDistribution(mapping), JaxReplicaDistribution(mapping)
    assert port.mapping == jax.mapping
    assert port.computations == jax.computations
    for c in mapping:
        assert port.agents_for_computation(c) == jax.agents_for_computation(c)
        assert port.replica_count(c) == jax.replica_count(c)
    for a in ("a0", "a1", "a2", "a9"):
        assert port.computations_for_agent(a) == jax.computations_for_agent(a)
    text = yaml_replica_dist(port)
    assert text == jax_yaml_replica_dist(jax)
    assert load_replica_dist(text) == port


def _agent_sets(seed, n, comps):
    rng = random.Random(seed)
    names = [f"a{i}" for i in range(n)]
    out = []
    for name in names:
        out.append(dict(
            name=name, capacity=rng.choice([5, 50, 1000]),
            routes={o: round(rng.uniform(0.5, 3.0), 2) for o in names
                    if o != name and rng.random() < 0.7},
            hosting_costs={c: round(rng.uniform(0, 2), 2) for c in comps
                           if rng.random() < 0.5},
            default_hosting_cost=round(rng.uniform(0, 2), 2),
        ))
    return names, out


@pytest.mark.parametrize("seed, k", [(0, 1), (1, 2), (2, 3), (3, 2), (4, 5)])
def test_ucs_replica_hosts_matches_jax(seed, k):
    comps = [f"v{i}" for i in range(5)]
    names, specs = _agent_sets(seed, 7, comps)
    port = {s["name"]: AgentDef(**s) for s in specs}
    jax = {s["name"]: JaxAgentDef(**s) for s in specs}
    for owner in names[:3]:
        for comp in comps:
            def route(a, b, _defs, _o=owner):
                return float(_defs[_o].route(b)) if a == _o else 1.0

            got = ucs_replica_hosts(
                owner, comp, k, names, lambda a, b: route(a, b, port),
                lambda a, c: hosting_cost_of(port, a, c))
            want = jax_ucs_replica_hosts(
                owner, comp, k, names, lambda a, b: route(a, b, jax),
                lambda a, c: float(jax[a].hosting_cost(c)))
            assert got == want
            assert len(got) == min(k, len(names) - 1)
            assert owner not in got
            # the local mode's ranking, from the closed form of the paths
            assert rank_hosts(
                owner, comp, k, names,
                path_utils.owner_paths(
                    owner, lambda a, b: route(a, b, port), names),
                lambda a, c: hosting_cost_of(port, a, c)) == want


# ---------------------------------------------------------------------------
# the thread runtime: the negotiation, partial k, retraction
# ---------------------------------------------------------------------------


def _ring(pkg, n, agents, name="ring"):
    """A ring of n colored variables in either package's model."""
    dom_cls, var_cls, dcop_cls, cons = pkg
    d = dom_cls("colors", "", ["R", "G", "B"])
    vs = [var_cls(f"v{i}", d) for i in range(n)]
    dcop = dcop_cls(name)
    for i in range(n):
        a, b = vs[i], vs[(i + 1) % n]
        dcop += cons(f"c{i}", f"10 if {a.name} == {b.name} else 0", [a, b])
    dcop.add_agents(agents)
    return dcop


PORT = (Domain, Variable, DCOP, constraint_from_str)
JAX = (JaxDomain, JaxVariable, JaxDCOP, jax_constraint)


def _stop(orchestrator):
    orchestrator.stop_agents(timeout=3)
    orchestrator.stop()


def _port_run(dcop, distribution="oneagent", **kw):
    return run_local_thread_dcop("dsa", dcop, distribution, n_cycles=5,
                                 device="cpu", **kw)


def _equivalence_agents(seed, n_agents):
    rng = random.Random(seed)
    names = [f"a{i}" for i in range(n_agents)]
    comps = [f"v{i}" for i in range(n_agents)]
    specs = []
    for name in names:
        specs.append(dict(
            name=name, capacity=1000,
            routes={o: round(rng.uniform(0.5, 3.0), 2) for o in names
                    if o != name},
            hosting_costs={c: round(rng.uniform(0.0, 2.0), 2)
                           for c in comps},
            default_hosting_cost=round(rng.uniform(0.0, 2.0), 2),
        ))
    return specs


def _placements(run, dcop, k, mode):
    orchestrator = run(dcop, replication_mode=mode)
    try:
        orchestrator.deploy_computations()
        levels = orchestrator.start_replication(k=k, timeout=20)
        return ({c: list(h)
                 for c, h in orchestrator.mgt.replica_hosts.items()},
                orchestrator.distribution, levels)
    finally:
        _stop(orchestrator)


@pytest.mark.parametrize("seed, k", [(1, 1), (2, 2), (3, 2), (4, 3)])
def test_protocol_matches_jax_and_the_oracle(seed, k):
    specs = _equivalence_agents(seed, 4)
    dcop = _ring(PORT, 4, [AgentDef(**s) for s in specs], name=f"eq{seed}")
    jax_dcop = _ring(JAX, 4, [JaxAgentDef(**s) for s in specs],
                     name=f"eq{seed}")
    negotiated, dist, levels = _placements(_port_run, dcop, k,
                                           "distributed")
    local, _, _ = _placements(_port_run, dcop, k, "local")
    jax_negotiated, _, jax_levels = _placements(
        lambda d, **kw: jax_run_local_thread_dcop("dsa", d, "oneagent",
                                                  n_cycles=5, **kw),
        jax_dcop, k, "distributed")

    expected = {}
    names = list(dcop.agents)
    for comp in dist.computations:
        owner = dist.agent_for(comp)
        owner_def = dcop.agents[owner]

        def route_cost(a, b, _o=owner, _od=owner_def):
            return float(_od.route(b)) if a == _o else 1.0

        def hosting_cost(a, c):
            return float(dcop.agents[a].hosting_cost(c))

        expected[comp] = ucs_replica_hosts(owner, comp, k, names,
                                           route_cost, hosting_cost)
    assert negotiated == expected
    assert local == expected
    assert jax_negotiated == expected
    assert levels == jax_levels == {c: min(k, 3) for c in expected}


def test_more_k_than_agents_is_partial_k():
    dcop = _ring(PORT, 3, [AgentDef(f"a{i}", capacity=100)
                           for i in range(3)])
    orchestrator = _port_run(dcop)
    try:
        orchestrator.deploy_computations()
        t0 = time.perf_counter()
        levels = orchestrator.start_replication(k=5, timeout=20)
        assert time.perf_counter() - t0 < 10
        assert levels == {"v0": 2, "v1": 2, "v2": 2}
        assert orchestrator.mgt.replicated_agents == {"a0", "a1", "a2"}
        block = orchestrator.watch_status()["replication"]
        assert block["ktarget"] == 5
        assert sorted(block["below_target"]) == ["v0", "v1", "v2"]
    finally:
        _stop(orchestrator)


@pytest.mark.parametrize("mode", ["distributed", "local"])
def test_capacity_exhausts_mid_round(mode):
    def build(pkg, agent_cls):
        d = pkg[0]("colors", "", ["R", "G"])
        x, y = pkg[1]("x", d), pkg[1]("y", d)
        dcop = pkg[2]("partial")
        dcop += pkg[3]("c0", "10 if x == y else 0", [x, y])
        dcop.add_agents([agent_cls("o1", capacity=100),
                         agent_cls("h1", capacity=1),
                         agent_cls("h2", capacity=0)])
        return dcop

    from pydcop_tpu.distribution.objects import (
        Distribution as JaxDistribution,
    )

    mapping = {"o1": ["x", "y"], "h1": [], "h2": []}
    got = _placements(
        lambda d, **kw: _port_run(d, Distribution(mapping), **kw),
        build(PORT, AgentDef), 2, mode)
    want = _placements(
        lambda d, **kw: jax_run_local_thread_dcop(
            "dsa", d, JaxDistribution(mapping), n_cycles=5, **kw),
        build(JAX, JaxAgentDef), 2, mode)
    assert got[0] == want[0]
    assert got[2] == want[2]
    if mode == "distributed":
        # x (negotiated first) takes h1's only slot; y gets nothing
        assert got[2] == {"x": 1, "y": 0}


def test_timeout_detail_names_agents_and_levels():
    from pydcop_tpu.infrastructure.orchestrator import (
        replication_timeout_detail as jax_detail,
    )

    args = (2.0, {"a1", "a2"}, {"a2"}, {"x": 1, "y": 2}, 2)
    s = replication_timeout_detail(*args)
    assert s == jax_detail(*args)
    assert "a1" in s and "below the k-target 2" in s and "y" not in s


def _stores(orchestrator):
    return sum(len(a.replica_store)
               for a in orchestrator._local_agents.values())


def _counter_total(name):
    m = metrics_registry.get(name)
    if m is None:
        return 0
    return int(sum(v["value"] for v in m.snapshot()["values"]))


def _retraction_run():
    dcop = _ring(PORT, 3, [AgentDef(f"a{i}", capacity=100)
                           for i in range(3)])
    orchestrator = _port_run(dcop)
    orchestrator.deploy_computations()
    return orchestrator


def test_k_decrease_retracts_surplus():
    metrics_registry.enabled = True
    orchestrator = _retraction_run()
    try:
        assert orchestrator.start_replication(k=2, timeout=20) == {
            "v0": 2, "v1": 2, "v2": 2}
        assert _poll(lambda: _stores(orchestrator) == 6)
        assert orchestrator.start_replication(k=1, timeout=20) == {
            "v0": 1, "v1": 1, "v2": 1}
        assert _poll(lambda: _stores(orchestrator) == 3)
        assert _poll(
            lambda: _counter_total("replication.retractions") >= 3)
        assert _poll(lambda: all(
            len(holders) == 1 for holders in
            orchestrator.directory.directory.replicas.values()))
    finally:
        _stop(orchestrator)


def test_capacity_shrink_sheds_replicas():
    metrics_registry.enabled = True
    orchestrator = _retraction_run()
    try:
        orchestrator.start_replication(k=1, timeout=20)
        comp, (host,) = next(iter(orchestrator.mgt.replica_hosts.items()))
        agent = orchestrator._local_agents[host]
        assert _poll(lambda: comp in agent.replica_store)
        orchestrator.set_agent_capacity(host, 0.0)
        assert _poll(lambda: comp not in agent.replica_store)
        assert _poll(
            lambda: host not in orchestrator.mgt.replica_hosts[comp])
        assert _poll(
            lambda: orchestrator.mgt.replication_levels[comp] == 0)
        assert _poll(lambda: host not in (
            orchestrator.directory.directory.replicas.get(comp, set())))
        assert _poll(
            lambda: _counter_total("replication.retractions") >= 1)
    finally:
        _stop(orchestrator)


def test_migration_drops_own_replica():
    orchestrator = _retraction_run()
    try:
        orchestrator.start_replication(k=1, timeout=20)
        victim = "a0"
        (orphan,) = orchestrator.distribution.computations_hosted(victim)
        (holder,) = orchestrator.mgt.replica_hosts[orphan]
        orchestrator._remove_agent(victim)
        # the repair's candidates are the replica holders: the orphan
        # moves onto its only one, which drops the shadowed replica
        assert orchestrator.distribution.agent_for(orphan) == holder
        holder_agent = orchestrator._local_agents[holder]
        assert _poll(lambda: orphan not in holder_agent.replica_store)
        assert _poll(lambda: holder not in (
            orchestrator.mgt.replica_hosts.get(orphan, [])))
    finally:
        _stop(orchestrator)


def test_status_block_matches_jax():
    from pydcop_tpu.resilience import (
        replication_status_block as jax_block,
    )
    from pydcop_tpu_torch.resilience import replication_status_block

    dcop = _ring(PORT, 3, [AgentDef(f"a{i}", capacity=100)
                           for i in range(3)])
    jax_dcop = _ring(JAX, 3, [JaxAgentDef(f"a{i}", capacity=100)
                              for i in range(3)])
    blocks = []
    for run, problem in (
        (_port_run, dcop),
        (lambda d, **kw: jax_run_local_thread_dcop("dsa", d, "oneagent",
                                                   n_cycles=5, **kw),
         jax_dcop),
    ):
        orchestrator = run(problem)
        try:
            orchestrator.deploy_computations()
            orchestrator.start_replication(k=2, timeout=20)
            blocks.append(orchestrator.watch_status()["replication"])
        finally:
            _stop(orchestrator)
    assert blocks[0]["ktarget"] == blocks[1]["ktarget"] == 2
    assert blocks[0]["mode"] == blocks[1]["mode"] == "distributed"
    assert blocks[0]["levels"] == blocks[1]["levels"]
    assert blocks[0]["below_target"] == blocks[1]["below_target"] == []
    assert replication_status_block(None, None, "local") is None
    assert jax_block(None, None, "local") is None
