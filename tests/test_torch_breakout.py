"""MixedDSA, DBA and GDBA, and the mixed-problem generator, against the
JAX package, both on the CPU.

- ``generate_mixed_problem`` makes the same numpy calls in the same order:
  its DCOP is ``dcop_yaml`` text-equal to the JAX package's, and it logs
  the same message when the arity-2 graph's density sets the constraint
  count.
- Whole solves of every variant and mode parameter on a mixed hard/soft
  problem of each arity regime, on a hard coloring and on a soft one
  (carried across as YAML and compiled by each package): the same
  assignment, cost, violations, cycles, message counts and status.  All
  three report the anytime best, which the strict ``<`` of the engine
  keeps only where ``evaluate`` sums in the JAX package's order.
- Bench config 7 and the 10,000-variable hard coloring give the results
  of the JAX package on a CPU (``JAX_PLATFORMS=cpu``, jax 0.9.0), pinned
  here.
- ``python -m pydcop_tpu_torch solve -a mixeddsa`` on a generated file.
"""

import json
import logging
import subprocess
import sys

import pytest
from test_torch_api import ROOT
from test_torch_local_search import assert_same_solve

from pydcop_tpu.algorithms import dba as jax_dba
from pydcop_tpu.algorithms import gdba as jax_gdba
from pydcop_tpu.algorithms import mixeddsa as jax_mixeddsa
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_graph_coloring as jax_graph_coloring,
)
from pydcop_tpu.commands.generators.mixedproblem import (
    generate_mixed_problem as jax_mixed_problem,
)
from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
from pydcop_tpu.dcop.yamldcop import dcop_yaml as jax_dcop_yaml
from pydcop_tpu_torch.algorithms import dba, gdba, load_algorithm_module
from pydcop_tpu_torch.algorithms import mixeddsa
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_graph_coloring,
)
from pydcop_tpu_torch.commands.generators.mixedproblem import (
    generate_mixed_problem,
)
from pydcop_tpu_torch.compile.core import compile_dcop
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop

# generate_mixed_problem's (args, kwargs): each arity regime, a domain
# range, agents with a capacity
MIXED = {
    "arity2": ((60, 60, 0.4), dict(arity=2, domain_range=4, density=0.08,
                                   seed=3)),
    "arity3": ((30, 20, 0.3), dict(arity=3, seed=1)),
    "arity1": ((20, 20, 0.5), dict(arity=1, seed=2)),
    "arity4": ((40, 30, 0.2), dict(arity=4, domain_range=4, density=0.5,
                                   seed=5, agents=10, capacity=7)),
}


@pytest.mark.parametrize("case", sorted(MIXED))
def test_mixed_problem_yaml_equals_jax(case):
    args, kw = MIXED[case]
    assert dcop_yaml(generate_mixed_problem(*args, **kw)) == jax_dcop_yaml(
        jax_mixed_problem(*args, **kw)
    )


def test_mixed_problem_logs_the_density_message_like_jax(caplog):
    args, kw = MIXED["arity2"]
    with caplog.at_level(logging.WARNING):
        jax_mixed_problem(*args, **kw)
        generate_mixed_problem(*args, **kw)
    jax_msg, port_msg = (
        [r.getMessage() for r in caplog.records if r.name == name]
        for name in ("pydcop_tpu.generate", "pydcop_tpu_torch.generate")
    )
    assert port_msg == jax_msg and len(port_msg) == 1
    assert "produced 150 constraints, not the requested 60" in port_msg[0]


# the problems, each compiled by both packages from one DCOP (the port's
# from the JAX one's YAML text)
PROBLEMS = {
    "mixed2": lambda: jax_mixed_problem(*MIXED["arity2"][0],
                                        **MIXED["arity2"][1]),
    "mixed3": lambda: jax_mixed_problem(*MIXED["arity3"][0],
                                        **MIXED["arity3"][1]),
    "hard": lambda: jax_graph_coloring(40, 3, graph="random", p_edge=0.12,
                                       soft=False, seed=2),
    "soft": lambda: jax_graph_coloring(40, 3, graph="scalefree", m_edge=2,
                                       soft=True, seed=4),
}


def _pair(problem):
    dcop = PROBLEMS[problem]()
    return compile_dcop(load_dcop(jax_dcop_yaml(dcop))), jax_compile_dcop(dcop)


# (port module, JAX module, params): every variant and mode parameter
SOLVERS = {
    "mixeddsa-B": (mixeddsa, jax_mixeddsa, {}),
    "mixeddsa-A": (mixeddsa, jax_mixeddsa, {"variant": "A"}),
    "mixeddsa-C": (mixeddsa, jax_mixeddsa, {"variant": "C"}),
    "mixeddsa-probas": (mixeddsa, jax_mixeddsa,
                        {"proba_hard": 0.9, "proba_soft": 0.2}),
    "dba": (dba, jax_dba, {}),
    "dba-distance3": (dba, jax_dba, {"max_distance": 3}),
    "dba-infinity5": (dba, jax_dba, {"infinity": 5}),
    "gdba": (gdba, jax_gdba, {}),
    "gdba-M": (gdba, jax_gdba, {"modifier": "M"}),
    "gdba-NM": (gdba, jax_gdba, {"violation": "NM"}),
    "gdba-MX": (gdba, jax_gdba, {"violation": "MX"}),
    "gdba-R": (gdba, jax_gdba, {"increase_mode": "R"}),
    "gdba-C": (gdba, jax_gdba, {"increase_mode": "C"}),
    "gdba-T": (gdba, jax_gdba, {"increase_mode": "T"}),
    "gdba-M-NM-T": (gdba, jax_gdba, {"modifier": "M", "violation": "NM",
                                     "increase_mode": "T"}),
}


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_solve_matches_jax(solver, problem):
    mod, jax_mod, params = SOLVERS[solver]
    port, ref = _pair(problem)
    want = jax_mod.solve(ref, params, n_cycles=30, seed=5)
    got = mod.solve(port, params, n_cycles=30, seed=5, device="cpu")
    assert_same_solve(got, want)
    assert got.status == "FINISHED" and got.cycles == 30


def test_mixeddsa_stop_cycle_sets_the_cycle_count():
    port, _ = _pair("mixed3")
    got = mixeddsa.solve(port, {"stop_cycle": 7}, n_cycles=50, device="cpu")
    assert got.cycles == 7


def test_dba_refuses_a_max_problem():
    dcop = jax_mixed_problem(*MIXED["arity3"][0], **MIXED["arity3"][1])
    text = jax_dcop_yaml(dcop).replace("objective: min", "objective: max")
    port = compile_dcop(load_dcop(text))
    with pytest.raises(ValueError, match="minimization"):
        dba.solve(port, {}, n_cycles=3, device="cpu")


@pytest.mark.parametrize("mod", [mixeddsa, dba, gdba])
def test_entry_points_default_to_the_card(mod):
    import torch

    port, _ = _pair("hard")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.solve(port, {}, n_cycles=3)


@pytest.mark.parametrize("name", ["mixeddsa", "dba", "gdba"])
def test_algorithm_modules_load(name):
    mod = load_algorithm_module(name)
    assert mod.GRAPH_TYPE == "constraints_hypergraph"


# bench config 7 (bench_all.py: generate_mixed_problem -> compile_dcop, 50
# cycles, seed 0) and the 10,000-variable hard scale-free coloring (100
# cycles, seed 0): (cost, violations, cycles) of the JAX package on a CPU
CONFIG_7 = ((2000, 2000, 0.4), dict(arity=2, domain_range=5, density=0.0025,
                                     seed=13))
CONFIG_7_JAX = {
    "mixeddsa": (1925.9599999999969, 0, 50),
    "dba": (3908.4600000000037, 0, 50),
    "gdba": (2189.669999999992, 0, 50),
}
HARD_10K = (10_000, 3, dict(graph="scalefree", m_edge=2, soft=False, seed=7))
HARD_10K_JAX = {"dba": (0.0, 101, 100), "gdba": (0.0, 556, 100)}


@pytest.fixture(scope="module")
def config7():
    args, kw = CONFIG_7
    return compile_dcop(generate_mixed_problem(*args, **kw))


@pytest.mark.parametrize("algo", sorted(CONFIG_7_JAX))
def test_config7_gives_the_jax_result(algo, config7):
    assert config7.n_constraints == 5050  # the density's graph, not 2000
    got = load_algorithm_module(algo).solve(
        config7, {}, n_cycles=50, seed=0, device="cpu"
    )
    assert (got.cost, got.violations, got.cycles) == CONFIG_7_JAX[algo]


@pytest.mark.parametrize("algo", sorted(HARD_10K_JAX))
def test_hard_10k_coloring_gives_the_jax_result(algo):
    n, d, kw = HARD_10K
    compiled = compile_dcop(generate_graph_coloring(n, d, **kw))
    got = load_algorithm_module(algo).solve(
        compiled, {}, n_cycles=100, seed=0, device="cpu"
    )
    assert (got.cost, got.violations, got.cycles) == HARD_10K_JAX[algo]


def test_cli_solves_with_mixeddsa(tmp_path):
    args, kw = MIXED["arity2"]
    path = tmp_path / "mixed.yaml"
    path.write_text(dcop_yaml(generate_mixed_problem(*args, **kw)))
    out = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
         "solve", "-a", "mixeddsa", "-n", "20", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout)
    port, ref = _pair("mixed2")
    want = jax_mixeddsa.solve(ref, {}, n_cycles=20, seed=0)
    assert got["assignment"] == want.assignment
    assert (got["cost"], got["violation"], got["cycle"]) == (
        want.cost, want.violations, want.cycles
    )
    assert got["status"] == "FINISHED"
