"""The port's generators and ``generate`` verb against the JAX package's,
on the CPU.

Every family of the verb (graph coloring, Ising, meeting scheduling,
SECP, mixed, IoT, small world, agents, scenarios) makes the same
``random``/numpy draws in the same order in both packages, so a seed
gives the same problem: the port's YAML text equals the JAX package's
byte for byte, as do the two verbs' ``--output`` files (IoT's ``dist_``
file included).  The IoT generator's placement, MaxSum's footprint model
on a factor graph, and MaxSum and DSA on the generated IoT, small-world
and SECP problems (assignment and cost) are the JAX package's too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pydcop_tpu import dcop_cli as jax_cli
from pydcop_tpu.algorithms import load_algorithm_module as jax_algorithm
from pydcop_tpu.algorithms import maxsum as jax_maxsum
from pydcop_tpu.commands.generators import agents as jax_agents
from pydcop_tpu.commands.generators import graphcoloring as jax_gc
from pydcop_tpu.commands.generators import iot as jax_iot
from pydcop_tpu.commands.generators import ising as jax_ising
from pydcop_tpu.commands.generators import meetingscheduling as jax_ms
from pydcop_tpu.commands.generators import mixedproblem as jax_mixed
from pydcop_tpu.commands.generators import scenario as jax_scenario
from pydcop_tpu.commands.generators import secp as jax_secp
from pydcop_tpu.commands.generators import smallworld as jax_sw
from pydcop_tpu.compile.core import compile_dcop as jax_compile
from pydcop_tpu.computations_graph import factor_graph as jax_fg
from pydcop_tpu.dcop import yamldcop as jax_yaml
from pydcop_tpu_torch import dcop_cli
from pydcop_tpu_torch.algorithms import load_algorithm_module
from pydcop_tpu_torch.algorithms import maxsum
from pydcop_tpu_torch.commands.generators import agents as port_agents
from pydcop_tpu_torch.commands.generators import graphcoloring as port_gc
from pydcop_tpu_torch.commands.generators import iot as port_iot
from pydcop_tpu_torch.commands.generators import ising as port_ising
from pydcop_tpu_torch.commands.generators import meetingscheduling as port_ms
from pydcop_tpu_torch.commands.generators import mixedproblem as port_mixed
from pydcop_tpu_torch.commands.generators import scenario as port_scenario
from pydcop_tpu_torch.commands.generators import secp as port_secp
from pydcop_tpu_torch.commands.generators import smallworld as port_sw
from pydcop_tpu_torch.compile.core import compile_dcop
from pydcop_tpu_torch.computations_graph import factor_graph
from pydcop_tpu_torch.dcop import yamldcop as port_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (family, generator function name, kwargs): small sizes of each family
# whose objects ``dcop_yaml`` writes
DCOP_FAMILIES = [
    ("graph_coloring", "generate_graph_coloring",
     dict(variables_count=20, colors_count=3, p_edge=0.3)),
    ("graph_coloring", "generate_graph_coloring",
     dict(variables_count=30, colors_count=4, graph="scalefree", m_edge=2,
          soft=True)),
    ("ising", "generate_ising", dict(row_count=3, col_count=4)),
    ("ising", "generate_ising", dict(row_count=4, col_count=2,
                                     extensive=False)),
    ("meeting_scheduling", "generate_meeting_scheduling",
     dict(slots_count=4, resources_count=5, events_count=4)),
    ("secp", "generate_secp", dict(lights=6, models=3, rules=4)),
    ("secp", "generate_secp", dict(lights=10, models=4, rules=8,
                                   max_model_size=4, max_rule_size=3)),
    ("mixed_problem", "generate_mixed_problem",
     dict(variable_count=15, constraint_count=20, hard_proportion=0.3,
          domain_range=3, density=0.3)),
    ("small_world", "generate_small_world", dict(n=30, k=4, p=0.2)),
    ("small_world", "generate_small_world",
     dict(n=25, k=6, p=0.9, domain_size=3, cost_range=20)),
]
MODULES = {
    "graph_coloring": (port_gc, jax_gc), "ising": (port_ising, jax_ising),
    "meeting_scheduling": (port_ms, jax_ms),
    "secp": (port_secp, jax_secp), "mixed_problem": (port_mixed, jax_mixed),
    "small_world": (port_sw, jax_sw), "iot": (port_iot, jax_iot),
}
SEEDS = (0, 3, 11)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("family, fn, kw", DCOP_FAMILIES)
def test_generated_yaml_is_the_jax_text(family, fn, kw, seed):
    port_mod, jax_mod = MODULES[family]
    port = getattr(port_mod, fn)(**kw, seed=seed)
    ref = getattr(jax_mod, fn)(**kw, seed=seed)
    assert port_yaml.dcop_yaml(port) == jax_yaml.dcop_yaml(ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num, domain", [(12, 3), (30, 10)])
def test_iot_problem_and_placement_are_jax(num, domain, seed):
    port, port_map = port_iot.generate_iot(num, domain, 50, seed=seed)
    ref, ref_map = jax_iot.generate_iot(num, domain, 50, seed=seed)
    assert port_yaml.dcop_yaml(port) == jax_yaml.dcop_yaml(ref)
    assert port_map == ref_map
    # every computation placed once
    placed = sorted(c for comps in port_map.values() for c in comps)
    assert placed == sorted([*port.variables, *port.constraints])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("count, kw", [
    (5, {}),
    (12, dict(capacity=30, routes_range=4.0, default_route=2)),
    (101, dict(default_hosting_cost=5, routes_range=1.5)),
])
def test_agent_defs_are_jax(count, kw, seed):
    names = port_agents.generate_agents_from_count(count, "ag")
    assert names == jax_agents.generate_agents_from_count(count, "ag")
    port = port_agents.generate_agent_defs(names, seed=seed, **kw)
    ref = jax_agents.generate_agent_defs(names, seed=seed, **kw)
    assert port_yaml.yaml_agents(port) == jax_yaml.yaml_agents(ref)


def test_agents_from_variables_with_name_mapping_are_jax():
    variables = ["v1", "v2", "x10", "7"]
    names = port_agents.generate_agents_from_variables(variables)
    assert names == jax_agents.generate_agents_from_variables(variables)
    port = port_agents.generate_agent_defs(
        names, hosting_mode="name_mapping", computations=variables)
    ref = jax_agents.generate_agent_defs(
        names, hosting_mode="name_mapping", computations=variables)
    assert port_yaml.yaml_agents(port) == jax_yaml.yaml_agents(ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("evts, actions", [(3, 1), (4, 2), (10, 3)])
def test_scenario_is_jax(evts, actions, seed):
    agents = [f"a{i:02d}" for i in range(12)]
    port = port_scenario.generate_scenario(evts, actions, 2.0, 1.0, 3.0,
                                           agents, seed=seed)
    ref = jax_scenario.generate_scenario(evts, actions, 2.0, 1.0, 3.0,
                                         agents, seed=seed)
    assert port_yaml.yaml_scenario(port) == jax_yaml.yaml_scenario(ref)


@pytest.mark.parametrize("n, k, p, seed", [
    (10, 2, 0.0, 1), (40, 4, 0.1, 2), (60, 4, 0.5, 3), (30, 6, 1.0, 4),
    (5, 4, 0.7, 5),
])
def test_watts_strogatz_edges_are_jax(n, k, p, seed):
    port = port_sw.watts_strogatz_edges(n, k, p, np.random.default_rng(seed))
    ref = jax_sw.watts_strogatz_edges(n, k, p, np.random.default_rng(seed))
    assert port.dtype == ref.dtype and np.array_equal(port, ref)


@pytest.mark.parametrize("family", ["iot", "secp", "small_world"])
def test_factor_graph_footprints_are_jax(family):
    if family == "iot":
        port, _ = port_iot.generate_iot(15, 4, 20, seed=2)
        ref, _ = jax_iot.generate_iot(15, 4, 20, seed=2)
    else:
        fn = f"generate_{family}"
        port = getattr(MODULES[family][0], fn)(seed=2)
        ref = getattr(MODULES[family][1], fn)(seed=2)
    port_g = factor_graph.build_computation_graph(port)
    ref_g = jax_fg.build_computation_graph(ref)
    assert [(n.name, n.type, n.neighbors) for n in port_g.nodes] == [
        (n.name, n.type, n.neighbors) for n in ref_g.nodes
    ]
    assert port_g.density() == ref_g.density()
    for pn, rn in zip(port_g.nodes, ref_g.nodes):
        assert maxsum.computation_memory(pn) == \
            jax_maxsum.computation_memory(rn)
        for neigh in pn.neighbors:
            assert maxsum.communication_load(pn, neigh) == \
                jax_maxsum.communication_load(rn, neigh)


# ---------------------------------------------------------------------------
# the verb
# ---------------------------------------------------------------------------

VERB_CASES = [
    ("graph_coloring", ["-v", "25", "-c", "3", "--soft", "--seed", "4"]),
    ("graph_coloring", ["-v", "30", "-g", "scalefree", "--m_edge", "2",
                        "--seed", "1"]),
    ("ising", ["--row_count", "3", "--col_count", "5", "--seed", "2"]),
    ("ising", ["--row_count", "3", "--intentional", "--no_agents",
               "--seed", "2"]),
    ("meeting_scheduling", ["--events_count", "4", "--seed", "3"]),
    ("secp", ["-l", "8", "-m", "3", "-r", "5", "--seed", "6"]),
    ("mixed_problem", ["-v", "12", "-c", "15", "-H", "0.4", "-r", "3",
                       "-d", "0.4", "-a", "3", "--capacity", "50",
                       "--seed", "8"]),
    ("iot", ["-n", "20", "-d", "4", "-r", "30", "--seed", "5"]),
    ("small_world", ["-n", "40", "-k", "4", "-p", "0.3", "-d", "3",
                     "--seed", "9"]),
    ("agents", ["--count", "14", "--capacity", "20", "--routes_range",
                "3"]),
    ("agents", ["--dcop_files", "tests/instances/graph_coloring.yaml",
                "--hosting", "name_mapping", "--seed", "2"]),
    ("scenario", ["--evts_count", "3", "--actions_count", "2", "--agents",
                  "a1", "a2", "a3", "a4", "a5", "a6", "a7", "--seed", "4"]),
]


def _verb_outputs(main, directory, family, args):
    os.makedirs(directory)
    out = os.path.join(directory, f"{family}.yaml")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        assert main(["generate", family, *args, "-o", out]) == 0
    finally:
        os.chdir(cwd)
    return {
        name: open(os.path.join(directory, name), "rb").read()
        for name in sorted(os.listdir(directory))
    }


@pytest.mark.parametrize("family, args", VERB_CASES)
def test_verb_output_files_are_the_jax_files(family, args, tmp_path):
    port = _verb_outputs(dcop_cli.main, str(tmp_path / "port"), family,
                         args)
    ref = _verb_outputs(jax_cli.main, str(tmp_path / "jax"), family, args)
    assert port == ref
    if family == "iot":
        assert sorted(port) == ["dist_iot.yaml", "iot.yaml"]


def test_verb_scenario_over_a_generated_dcop_file(tmp_path):
    files = {}
    for name, main in (("port", dcop_cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        d.mkdir()
        assert main(["generate", "iot", "-n", "15", "--seed", "2", "-o",
                     str(d / "iot.yaml")]) == 0
        assert main(["generate", "scenario", "--evts_count", "4",
                     "--dcop_files", str(d / "iot.yaml"), "--seed", "7",
                     "-o", str(d / "scen.yaml")]) == 0
        files[name] = (d / "scen.yaml").read_text()
    assert files["port"] == files["jax"]
    assert "remove_agent" in files["port"]


def test_verb_runs_without_a_card_or_device_flag(tmp_path):
    # generate is host-only: no card visible and no --device, and it
    # still writes the JAX package's text to stdout
    port = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "generate", "secp",
         "-l", "4", "--seed", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert port.returncode == 0, port.stderr[-2000:]
    assert port.stdout == jax_yaml.dcop_yaml(
        jax_secp.generate_secp(lights=4, seed=2))


def test_verb_without_a_family_prints_help(capsys):
    assert dcop_cli.main(["generate"]) == 2
    assert "graph_coloring" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# solves on generated problems
# ---------------------------------------------------------------------------

SOLVED = {
    "iot": lambda mod: mod.generate_iot(40, 5, 30, seed=3)[0],
    "small_world": lambda mod: mod.generate_small_world(
        60, 4, 0.2, 4, 10, seed=5),
    "secp": lambda mod: mod.generate_secp(12, 4, 8, seed=1),
}


@pytest.mark.parametrize("algo, params", [
    ("maxsum", {"damping": 0.7}), ("dsa", {}),
])
@pytest.mark.parametrize("family", sorted(SOLVED))
def test_generated_problems_solve_as_jax(family, algo, params):
    port_mod, jax_mod = MODULES[family]
    # the problem crosses as the JAX package's text: the same problem
    ref = SOLVED[family](jax_mod)
    port = port_yaml.load_dcop(jax_yaml.dcop_yaml(ref))
    assert port_yaml.dcop_yaml(SOLVED[family](port_mod)) == \
        jax_yaml.dcop_yaml(ref)
    got = load_algorithm_module(algo).solve(
        compile_dcop(port), dict(params), n_cycles=30, seed=4, device="cpu")
    want = jax_algorithm(algo).solve(
        jax_compile(ref), dict(params), n_cycles=30, seed=4)
    assert got.assignment == want.assignment
    assert (got.cost, got.violations, got.cycles) == (
        want.cost, want.violations, want.cycles)
