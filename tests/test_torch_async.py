"""DSA-tuto, A-DSA and A-MaxSum against the JAX package, both on the CPU,
on the same arrays (carried across with ``port_of``), params and seed.

Each solve must give the JAX package's assignment, cost, violations,
cycles, message counts and status, bit for bit: a local-search move and
a wake mask turn on float comparisons and threefry bits, so any
difference in a cost or a draw would show as another trajectory.  The
A-DSA variants also run on a hard coloring on which the JAX package's
three variants end apart (checked first), so the test tells them apart.
A-MaxSum runs its defaults, a ``stop_cycle``, ``start_messages="all"``
(inert: both packages warn and run as the default does) and a tree on
which the stability stop ends the solve early.  The CLI prints the JAX
CLI's JSON for the three solvers.
"""

import dataclasses
import json
import sys
import warnings

import pytest
from test_torch_api import _path, assert_same_result
from test_torch_cli import _run
from test_torch_lanes import jax_case, port_of

from pydcop_tpu.algorithms import adsa as jax_adsa
from pydcop_tpu.algorithms import amaxsum as jax_amaxsum
from pydcop_tpu.algorithms import dsatuto as jax_dsatuto
from pydcop_tpu.algorithms import warn_inert_params as jax_warn_inert
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_coloring_arrays,
)
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_graph_coloring as jax_graph_coloring,
)
from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
from pydcop_tpu_torch.algorithms import (
    adsa,
    amaxsum,
    dsatuto,
    load_algorithm_module,
    warn_inert_params,
)

CASES = ("grid", "scalefree", "clique", "mixed", "d20")
SOLVERS = {
    "dsatuto": (dsatuto, jax_dsatuto),
    "adsa": (adsa, jax_adsa),
    "amaxsum": (amaxsum, jax_amaxsum),
}


def assert_same(got, want):
    assert got.assignment == want.assignment
    assert (got.cost, got.violations, got.cycles, got.msg_count,
            got.msg_size, got.status) == (
        want.cost, want.violations, want.cycles, want.msg_count,
        want.msg_size, want.status)


def _solve_both(algo, ref, params, n_cycles, seed):
    port_mod, jax_mod = SOLVERS[algo]
    want = jax_mod.solve(ref, dict(params), n_cycles=n_cycles, seed=seed)
    got = port_mod.solve(port_of(ref), dict(params), n_cycles=n_cycles,
                         seed=seed, device="cpu")
    return got, want


@pytest.mark.parametrize("case", CASES)
def test_dsatuto_matches_jax(case):
    got, want = _solve_both("dsatuto", jax_case(case), {}, 30, 3)
    assert_same(got, want)


@pytest.mark.parametrize("variant", ["A", "B", "C"])
@pytest.mark.parametrize("case", CASES)
def test_adsa_matches_jax(case, variant):
    got, want = _solve_both(
        "adsa", jax_case(case), {"variant": variant}, 30, 3
    )
    assert_same(got, want)


def _hard80():
    """The 80-variable hard coloring of chip_smoke.py's dsa_hard80, as
    arrays."""
    return dataclasses.replace(
        jax_compile_dcop(jax_graph_coloring(
            80, 3, "random", p_edge=0.07, soft=False, seed=1
        )),
        dcop=None,
    )


def test_adsa_variants_differ_on_a_hard_coloring_as_in_jax():
    ref = _hard80()
    runs = {
        v: _solve_both("adsa", ref, {"variant": v}, 40, 2) for v in "ABC"
    }
    # the JAX package's variants end at three different assignments
    assert len({r[1].violations for r in runs.values()}) == 3
    for got, want in runs.values():
        assert_same(got, want)


def test_adsa_probability_and_stop_cycle_match_jax():
    got, want = _solve_both(
        "adsa", jax_case("scalefree"),
        {"probability": 0.4, "stop_cycle": 12}, 30, 6,
    )
    assert got.cycles == 12
    assert_same(got, want)


def test_adsa_period_is_inert_and_warns_like_jax():
    ref = jax_case("grid")
    with pytest.warns(UserWarning, match="period"):
        want = jax_adsa.solve(ref, {"period": 2.0}, n_cycles=20, seed=1)
    with pytest.warns(UserWarning, match="period"):
        got = adsa.solve(port_of(ref), {"period": 2.0}, n_cycles=20,
                         seed=1, device="cpu")
    assert_same(got, want)
    assert_same(
        got, adsa.solve(port_of(ref), {}, n_cycles=20, seed=1, device="cpu")
    )


# (case, params, n_cycles, seed)
AMAXSUM_RUNS = {
    "default": ("scalefree", {}, 40, 3),
    "damping": ("clique", {"damping": 0.7}, 40, 3),
    "mixed": ("mixed", {"damping_nodes": "vars"}, 30, 0),
    "d20": ("d20", {"noise": 0.0}, 20, 5),
    "stop-cycle": ("grid", {"stop_cycle": 12}, 30, 2),
}


@pytest.mark.parametrize("run", sorted(AMAXSUM_RUNS))
def test_amaxsum_matches_jax(run):
    case, params, n_cycles, seed = AMAXSUM_RUNS[run]
    got, want = _solve_both("amaxsum", jax_case(case), params, n_cycles,
                            seed)
    assert_same(got, want)
    if "stop_cycle" in params:
        assert got.cycles == params["stop_cycle"]


def test_amaxsum_stability_stop_matches_jax():
    # on a tree the messages settle: the stop fires before n_cycles
    ref = jax_coloring_arrays(60, 3, graph="scalefree", m_edge=1, seed=0)
    got, want = _solve_both("amaxsum", ref, {}, 200, 1)
    assert want.cycles < 200
    assert_same(got, want)


def test_amaxsum_start_messages_is_inert_and_warns_like_jax():
    ref = jax_case("scalefree")
    params = {"start_messages": "all"}
    with pytest.warns(UserWarning, match="start_messages"):
        want = jax_amaxsum.solve(ref, dict(params), n_cycles=30, seed=4)
    with pytest.warns(UserWarning, match="start_messages"):
        got = amaxsum.solve(port_of(ref), dict(params), n_cycles=30, seed=4,
                            device="cpu")
    assert_same(got, want)
    assert_same(got, amaxsum.solve(port_of(ref), {}, n_cycles=30, seed=4,
                                   device="cpu"))


@pytest.mark.parametrize("given", [
    None, {}, {"period": 0.5}, {"period": "0.5"}, {"period": 1.0},
    {"period": "x"}, {"variant": "A"},
])
def test_warn_inert_params_warns_like_jax(given):
    inert = {"period": "no effect"}

    def warned(fn, defs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(given, inert, defs)
        return [str(w.message) for w in caught]

    assert warned(warn_inert_params, adsa.algo_params) == warned(
        jax_warn_inert, jax_adsa.algo_params
    )


@pytest.mark.parametrize("algo", sorted(SOLVERS))
def test_algo_params_like_jax(algo):
    port_mod, jax_mod = SOLVERS[algo]
    assert [tuple(p) for p in port_mod.algo_params] == [
        tuple(p) for p in jax_mod.algo_params
    ]
    assert load_algorithm_module(algo).GRAPH_TYPE == jax_mod.GRAPH_TYPE


@pytest.mark.parametrize("algo, opts", [
    ("dsatuto", ["-n", "30", "--seed", "2"]),
    ("adsa", ["-p", "variant:C", "-n", "25"]),
    ("amaxsum", ["-p", "damping:0.7", "-n", "40", "--collect_curve"]),
])
def test_cli_prints_the_jax_cli_json(algo, opts, tmp_path):
    args = ["solve", "-a", algo, *opts, _path("graph_coloring")]
    port = _run([sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
                 "--output", str(tmp_path / "port.json"), *args])
    ref = _run([sys.executable, "-m", "pydcop_tpu", *args],
               env={"JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads(ref.stdout)
    assert got.pop("cost_curve", None) == want.pop("cost_curve", None)
    assert_same_result(got, want, algo)
