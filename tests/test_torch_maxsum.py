"""The whole slice: the port's ``maxsum.solve`` against the JAX package's
``maxsum.solve`` on the same ``CompiledDCOP`` (carried across with
``compiled_from_numpy``), same params and seed, both on the CPU.

Bars: on the grid case (degree classes <= 4, where every float sum of the
cycle is bitwise equal across the two packages) the assignment, cost and
cycle count are identical.  Elsewhere fan-in sums over large degree
classes may round differently, so near-tied argmins may flip: violations
must be equal and the cost within rel=1e-5, the bar the JAX package's own
test holds its lanes and ELL layouts to.
"""

import dataclasses

import numpy as np
import pytest

from pydcop_tpu.algorithms import maxsum as jax_maxsum
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_generate,
)
from pydcop_tpu_torch.algorithms import maxsum
from pydcop_tpu_torch.interop import compiled_from_numpy

CASES = {
    "scalefree": (150, dict(graph="scalefree", m_edge=2, seed=13)),
    "clique": (12, dict(graph="random", p_edge=1.0, seed=3)),
    "grid": (36, dict(graph="grid", seed=4)),
    # bench config 2's instance
    "random1k": (1000, dict(graph="random", p_edge=0.005, seed=11)),
}

# (case, params, n_cycles, seed): default params (noise 0.01, leafs
# wavefront) with damping 0.5, plus the other start mode, an explicit
# stop_cycle, and config 2's own settings
RUNS = {
    "grid-default": ("grid", {"damping": 0.5}, 30, 5),
    "scalefree-default": ("scalefree", {"damping": 0.5}, 30, 5),
    "clique-default": ("clique", {"damping": 0.5}, 30, 5),
    "scalefree-all": (
        "scalefree", {"damping": 0.5, "start_messages": "all"}, 30, 5,
    ),
    "grid-stop-cycle": ("grid", {"damping": 0.5, "stop_cycle": 12}, 30, 2),
    "config2": ("random1k", {"damping": 0.5, "stop_cycle": 60}, 60, 0),
}


def _pair(case):
    n, kw = CASES[case]
    ref = jax_generate(n, 3, **kw)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    fields["buckets"] = [dataclasses.asdict(b) for b in ref.buckets]
    return compiled_from_numpy(fields), ref


@pytest.mark.parametrize("run", sorted(RUNS))
def test_solve_matches_jax(run):
    case, params, n_cycles, seed = RUNS[run]
    port_c, ref_c = _pair(case)
    ref = jax_maxsum.solve(ref_c, params, n_cycles=n_cycles, seed=seed)
    got = maxsum.solve(
        port_c, params, n_cycles=n_cycles, seed=seed, device="cpu"
    )
    assert got.status == "FINISHED"
    assert got.violations == ref.violations
    if case == "grid":
        assert got.assignment == ref.assignment
        assert got.cost == ref.cost
        assert got.cycles == ref.cycles
    else:
        assert got.cost == pytest.approx(ref.cost, rel=1e-5)
    if params.get("stop_cycle"):
        assert got.cycles == params["stop_cycle"]
    assert got.msg_count == 2 * port_c.n_edges * got.cycles


def test_converged_run_stops_early_like_jax():
    # a quiet instance (no unary preferences, no noise) settles within
    # the budget: the stop-on-stable rule must stop both at one cycle
    port_c, ref_c = _pair("grid")
    params = {"damping": 0.0, "noise": 0.0}
    ref = jax_maxsum.solve(ref_c, params, n_cycles=200, seed=0)
    got = maxsum.solve(port_c, params, n_cycles=200, seed=0, device="cpu")
    assert ref.cycles < 200
    assert got.cycles == ref.cycles
    assert got.assignment == ref.assignment


@pytest.mark.parametrize("layout", ["auto", "ell", "ell_pallas"])
def test_every_ell_layout_runs_the_one_path(layout):
    port_c, _ = _pair("scalefree")
    base = maxsum.solve(port_c, {"damping": 0.5}, n_cycles=10, device="cpu")
    got = maxsum.solve(
        port_c, {"damping": 0.5, "layout": layout}, n_cycles=10,
        device="cpu",
    )
    assert got.assignment == base.assignment and got.cost == base.cost


@pytest.mark.parametrize(
    "params, kwargs",
    [
        ({"layout": "edges"}, {}),
        ({"layout": "lanes"}, {}),
        ({"layout": "pallas"}, {}),
        ({"precision": "bf16"}, {}),
        ({}, {"timeout": 1.0}),
    ],
)
def test_unported_options_raise(params, kwargs):
    port_c, _ = _pair("grid")
    with pytest.raises(NotImplementedError):
        maxsum.solve(port_c, params, n_cycles=3, device="cpu", **kwargs)


def test_warm_solve_reuses_cached_operands():
    port_c, _ = _pair("grid")
    a = maxsum.solve(port_c, {}, n_cycles=5, device="cpu")
    n_cached = len(port_c._device_consts)
    b = maxsum.solve(port_c, {}, n_cycles=5, device="cpu")
    assert len(port_c._device_consts) == n_cached
    assert a == b


def test_result_is_a_valid_assignment():
    port_c, _ = _pair("scalefree")
    res = maxsum.solve(port_c, {}, n_cycles=20, seed=1, device="cpu")
    assert set(res.assignment) == set(port_c.var_names)
    assert set(res.assignment.values()) <= {0, 1, 2}
    assert np.isfinite(res.cost)
    assert (res.cost, res.violations) == port_c.host_cost(
        np.array([res.assignment[n] for n in port_c.var_names])
    )


def _scripted_engine(costs, n_cycles, convergence=None):
    """run_cycles over a one-variable problem whose unary costs are
    ``costs``: init picks value 0, step k picks value k (mod len)."""
    from collections import namedtuple

    import torch

    from pydcop_tpu_torch.algorithms.base import extract_values, run_cycles
    from pydcop_tpu_torch.compile.kernels import DeviceDCOP

    State = namedtuple("State", "values k")
    d = len(costs)
    dev = DeviceDCOP(
        n_vars=1, max_domain=d,
        valid_mask=torch.ones((1, d), dtype=torch.bool),
        unary=torch.tensor([costs], dtype=torch.float32),
        constant_cost=torch.tensor(0.0),
        buckets=(),
    )

    def init(dev):
        return State(torch.zeros(1, dtype=torch.int32), 0)

    def step(dev, state):
        k = state.k + 1
        return State(torch.full((1,), k % d, dtype=torch.int32), k)

    return run_cycles(
        dev, init, step, extract_values, n_cycles=n_cycles,
        convergence=convergence,
    )


def test_anytime_best_is_strict_and_one_based():
    # cycle:  0  1  2  3  4  5
    # cost:   5  3  3  4  2  5   -> best 2, first reached at cycle 4
    vals, extras = _scripted_engine([5.0, 3.0, 3.0, 4.0, 2.0], n_cycles=5)
    assert vals.tolist() == [4]
    assert extras == {"best_cost": 2.0, "cycles": 5, "cycles_to_best": 4}
    # a tie with the incumbent never moves it: cost 3 first at cycle 1
    vals, extras = _scripted_engine([5.0, 3.0, 3.0], n_cycles=2)
    assert vals.tolist() == [1] and extras["cycles_to_best"] == 1
    # never improved on: cycle 0
    _, extras = _scripted_engine([1.0, 2.0], n_cycles=3)
    assert extras["cycles_to_best"] == 0


def test_stop_on_stable_runs_same_count_steps():
    import torch

    always = lambda dev, old, new: torch.tensor(True)  # noqa: E731
    _, extras = _scripted_engine([1.0, 2.0], n_cycles=10, convergence=always)
    assert extras["cycles"] == maxsum.SAME_COUNT
    _, extras = _scripted_engine([1.0, 2.0], n_cycles=3, convergence=always)
    assert extras["cycles"] == 3
