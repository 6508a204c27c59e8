"""The port's repair (``pydcop_tpu_torch/reparation/``) against the JAX
package's, on the CPU.

The same problem (a generated soft coloring with one agent per variable,
routes and hosting costs, through YAML into each package) and the same
distribution give the same orphans, candidates and candidate info; the
repair DCOP has the same variables and constraints, and its tables
compile bit for bit; ``repair_distribution`` gives JAX's ``migrated``,
``repair_cost`` and ``repair_status``, with and without replica hosts,
after MGM-2 and on the greedy path (the tabulation guard lowered in both
packages), and re-picks the orphans MGM-2 leaves with no host or several
as JAX does, counting them.  A failure of the solve itself is an error,
never a greedy placement, and the repair solves on the card unless the
caller asks for the CPU."""

import pytest
import torch
from test_torch_compile import _assert_compiled_equal

import pydcop_tpu.compile.core as jax_core
from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load_dcop
from pydcop_tpu.infrastructure.run import _build as jax_build
from pydcop_tpu.reparation import removal as jax_removal
from pydcop_tpu.reparation import repair_dcop as jax_repair_dcop
from pydcop_tpu.reparation import (
    repair_distribution as jax_repair_distribution,
)
import pydcop_tpu_torch.compile.core as port_core
from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.commands.generators.agents import (
    generate_agent_defs,
    generate_agents_from_variables,
)
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_graph_coloring,
)
from pydcop_tpu_torch.compile.core import compile_dcop
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop
from pydcop_tpu_torch.infrastructure.run import _build
from pydcop_tpu_torch.reparation import (
    removal,
    repair_dcop,
    repair_distribution,
)


def _problem_yaml(n=12, seed=4, capacity=100):
    dcop = generate_graph_coloring(n, 3, graph="scalefree", m_edge=2,
                                   soft=True, seed=seed)
    comps = sorted(dcop.variables)
    dcop._agents_def.clear()
    dcop.add_agents(generate_agent_defs(
        generate_agents_from_variables(comps), capacity=capacity,
        hosting_mode="name_mapping", computations=comps,
        default_hosting_cost=5, default_route=1, routes_range=10,
        seed=seed))
    return dcop_yaml(dcop)


def _both(algo="mgm", n=12, seed=4, distribution="adhoc", capacity=100):
    """(port, jax) of (dcop, algo_def, cg, distribution) on one YAML."""
    text = _problem_yaml(n, seed, capacity)
    port_dcop, jax_dcop = load_dcop(text), jax_load_dcop(text)
    port = (port_dcop,) + _build(port_dcop, AlgorithmDef.build_with_default_param(
        algo, mode="min"), distribution)
    jax = (jax_dcop,) + jax_build(jax_dcop, JaxAlgorithmDef.build_with_default_param(
        algo, mode="min"), distribution)
    return port, jax


def _mapping(dist):
    return {a: list(dist.computations_hosted(a)) for a in dist.agents}


def _victim(dist, nth=0):
    hosting = [a for a in sorted(dist.agents) if dist.computations_hosted(a)]
    return hosting[nth % len(hosting)]


@pytest.mark.parametrize("algo", ["mgm", "maxsum"])
def test_orphans_candidates_and_info_match_jax(algo):
    port, jax = _both(algo)
    assert _mapping(port[3]) == _mapping(jax[3])
    for nth in range(3):
        victim = _victim(port[3], nth)
        orphans = removal.removal_orphaned_computations(port[3], victim)
        assert orphans == jax_removal.removal_orphaned_computations(
            jax[3], victim)
        survivors = {a: d for a, d in port[0].agents.items() if a != victim}
        jax_survivors = {a: d for a, d in jax[0].agents.items()
                         if a != victim}
        for replicas in (None, {orphans[0]: sorted(survivors)[:2]}):
            assert removal.removal_candidate_agents(
                orphans, survivors, replicas
            ) == jax_removal.removal_candidate_agents(
                orphans, jax_survivors, replicas)
        for comp in orphans:
            assert removal.removal_candidate_computation_info(
                comp, port[2], port[3], victim
            ) == jax_removal.removal_candidate_computation_info(
                comp, jax[2], jax[3], victim)


def _replicas(dist, victim, survivors):
    """Two replica holders an orphan, picked by name from the survivors."""
    names = sorted(survivors)
    return {c: [names[i % len(names)], names[(i + 3) % len(names)]]
            for i, c in enumerate(dist.computations_hosted(victim))}


@pytest.mark.parametrize("algo, with_replicas", [
    ("mgm", False), ("mgm", True), ("maxsum", False), ("maxsum", True),
])
def test_repair_dcop_matches_jax_bit_for_bit(algo, with_replicas):
    port, jax = _both(algo)
    victim = _victim(port[3])
    survivors = [a for a in port[0].agents if a != victim]
    replicas = (_replicas(port[3], victim, survivors) if with_replicas
                else None)
    got, got_vars = repair_dcop(port[2], list(port[0].agents.values()),
                                port[3], victim, port[1], replicas)
    want, want_vars = jax_repair_dcop(jax[2], list(jax[0].agents.values()),
                                      jax[3], victim, jax[1], replicas)
    assert list(got.variables) == list(want.variables)
    assert list(got.constraints) == list(want.constraints)
    assert {c: {a: v.name for a, v in by.items()}
            for c, by in got_vars.items()} == {
        c: {a: v.name for a, v in by.items()}
        for c, by in want_vars.items()}
    assert sorted(got.agents) == sorted(want.agents)
    _assert_compiled_equal(compile_dcop(got), jax_compile_dcop(want))


def _same_repair(got, want):
    new_dist, metrics = got
    jax_dist, jax_metrics = want
    assert metrics == jax_metrics
    assert _mapping(new_dist) == _mapping(jax_dist)


@pytest.mark.parametrize("algo, seed, with_replicas", [
    ("mgm", 4, False), ("mgm", 4, True), ("maxsum", 4, False),
    ("maxsum", 4, True), ("mgm", 9, False), ("maxsum", 9, True),
])
def test_repair_distribution_matches_jax(algo, seed, with_replicas):
    port, jax = _both(algo, seed=seed)
    for nth in range(2):
        victim = _victim(port[3], nth)
        survivors = [a for a in port[0].agents if a != victim]
        replicas = (_replicas(port[3], victim, survivors) if with_replicas
                    else None)
        agents = [a for a in port[0].agents.values() if a.name != victim]
        jax_agents = [a for a in jax[0].agents.values() if a.name != victim]
        got = repair_distribution(port[2], agents, port[3], victim, port[1],
                                  replica_hosts=replicas, device="cpu")
        want = jax_repair_distribution(jax[2], jax_agents, jax[3], victim,
                                       jax[1], replica_hosts=replicas)
        _same_repair(got, want)
        assert got[1]["repair_status"] == "FINISHED"
        if replicas:
            for comp, host in got[1]["migrated"].items():
                assert host in replicas[comp]


def test_greedy_path_matches_jax(monkeypatch):
    # the tabulation guard refuses the repair DCOP in both packages (JAX:
    # inside its solve_result; the port: in compile_dcop, before the card)
    monkeypatch.setattr(jax_core, "MAX_TABLE_ELEMS", 2)
    monkeypatch.setattr(port_core, "MAX_TABLE_ELEMS", 2)
    port, jax = _both("mgm")
    victim = _victim(port[3])
    before = repair_distribution.greedy
    got = repair_distribution(
        port[2], [a for a in port[0].agents.values() if a.name != victim],
        port[3], victim, port[1], device="cpu")
    want = jax_repair_distribution(
        jax[2], [a for a in jax[0].agents.values() if a.name != victim],
        jax[3], victim, jax[1])
    _same_repair(got, want)
    assert got[1]["repair_status"] == "GREEDY"
    assert repair_distribution.greedy == before + 1


def test_orphans_mgm2_leaves_unplaced_are_repicked_as_jax_does():
    # one cycle of MGM-2 leaves the random initial assignment of the
    # hosted-exactly-once constraints: orphans with no host or several,
    # re-picked by hosting cost in both packages, and counted here
    port, jax = _both("mgm", n=16, seed=11)
    repicked = 0
    for nth in range(4):
        victim = _victim(port[3], nth)
        before = repair_distribution.repicked
        got = repair_distribution(
            port[2], [a for a in port[0].agents.values() if a.name != victim],
            port[3], victim, port[1], n_cycles=0, seed=3, device="cpu")
        want = jax_repair_distribution(
            jax[2], [a for a in jax[0].agents.values() if a.name != victim],
            jax[3], victim, jax[1], n_cycles=0, seed=3)
        _same_repair(got, want)
        repicked += repair_distribution.repicked - before
    assert repicked > 0


def test_a_failed_solve_is_an_error_not_a_greedy_placement(monkeypatch):
    import pydcop_tpu_torch.api as api

    def fail(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(api, "solve_result", fail)
    port, _ = _both("mgm")
    victim = _victim(port[3])
    before = repair_distribution.greedy
    with pytest.raises(RuntimeError, match="device lost"):
        repair_distribution(
            port[2], [a for a in port[0].agents.values() if a.name != victim],
            port[3], victim, port[1], device="cpu")
    assert repair_distribution.greedy == before


def test_repair_solves_on_the_card_by_default(monkeypatch):
    port, _ = _both("mgm")
    victim = _victim(port[3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        repair_distribution(
            port[2], [a for a in port[0].agents.values() if a.name != victim],
            port[3], victim, port[1])


def test_repair_solve_leaves_the_run_checkpoints_alone(tmp_path):
    # a repair's solve is an auxiliary one: it neither binds the run's
    # checkpoint manager nor writes into its trail
    from pydcop_tpu_torch.durability import CheckpointManager, durability

    manager = CheckpointManager(str(tmp_path), every_cycles=1)
    durability.configure(manager=manager, resume=None)
    try:
        port, _ = _both("mgm")
        victim = _victim(port[3])
        repair_distribution(
            port[2], [a for a in port[0].agents.values() if a.name != victim],
            port[3], victim, port[1], device="cpu")
        assert not manager.bound
        assert not manager.saved_paths
        assert not list(tmp_path.iterdir())
    finally:
        durability.reset()



def test_a_stream_of_its_own_keeps_its_own_ticket_pools(monkeypatch):
    # xla_tree_sum's tickets: the default stream's launches and graphs
    # share the device's pool; a solve on own_stream (a repair beside the
    # main solve) takes that stream's, in its eager launches and in the
    # graphs it captures, and a warm-up on a side stream sizes the pool of
    # the capture that follows (streams stand-ins, on the CPU)
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    class Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

        def __eq__(self, other):
            return getattr(other, "cuda_stream", None) == self.cuda_stream

        def synchronize(self):
            pass

    default, own, side = Stream(0), Stream(7), Stream(9)
    state = {"current": default, "capturing": False}
    monkeypatch.setattr(torch.cuda, "default_stream", lambda d=None: default)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: state["current"])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    monkeypatch.setattr(hk, "_ticket_pools", {})
    dev = torch.device("cpu")

    def tickets(current, capturing=False, home=None, n=10):
        state.update(current=current, capturing=capturing)
        monkeypatch.setattr(hk._local, "home", home, raising=False)
        return hk._tickets(dev, n)

    main = tickets(default)
    assert tickets(side) is not main  # a warm-up's own pool
    assert tickets(default, capturing=True) is main
    repair = tickets(own, home=own)
    assert repair is not main and tickets(side, home=own) is not repair
    assert tickets(default, capturing=True, home=own) is repair
    assert set(hk._ticket_pools) == {(dev, None), (dev, 7), (dev, 9)}
    # a capture larger than any pool of its home stream is refused
    with pytest.raises(RuntimeError, match="inside a graph capture"):
        tickets(default, capturing=True, home=own, n=10**6)
    # a warm-up sizes its home's pool first: the capture then finds it
    tickets(side, home=own, n=10**6)
    assert tickets(default, capturing=True, home=own, n=10**6).numel() >= 10**6
