"""The whole slice: the port's ``maxsum.solve`` against the JAX package's
``maxsum.solve`` on the same ``CompiledDCOP`` (carried across with
``compiled_from_numpy``), same params and seed, both on the CPU.

Bar: the assignment, cost and cycle count are identical on every run, on
the ELL layout (``auto``) and on the lanes and edges layouts.  Every float
sum that decides a result runs in XLA-CPU's order (``xla_sum``,
``segment_sum_onto``, ``domain_sum``), so the fan-ins, the anytime-best
totals and the argmins are the JAX package's bit for bit, at damping 0.5
and at the main path's damping 0.7 (where XLA-CPU may contract the damping
into an FMA; on these runs that changes no result).
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
    # bench config 4's generator at 2,000 variables
    "scalefree2k": (2000, dict(graph="scalefree", m_edge=2, seed=7)),
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
    # the main path's own params (bench config 4's)
    "config4-params": (
        "scalefree2k", {"damping": 0.7, "layout": "ell"}, 30, 7,
    ),
}


def _pair(case):
    n, kw = CASES[case]
    ref = jax_generate(n, 3, **kw)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    fields["buckets"] = [dataclasses.asdict(b) for b in ref.buckets]
    return compiled_from_numpy(fields), ref


def _solves_like_jax(case, params, n_cycles, seed):
    port_c, ref_c = _pair(case)
    ref = jax_maxsum.solve(ref_c, params, n_cycles=n_cycles, seed=seed)
    got = maxsum.solve(
        port_c, params, n_cycles=n_cycles, seed=seed, device="cpu"
    )
    assert got.status == "FINISHED"
    assert got.violations == ref.violations
    assert got.assignment == ref.assignment
    assert got.cost == ref.cost
    assert got.cycles == ref.cycles
    return port_c, got


@pytest.mark.parametrize("run", sorted(RUNS))
def test_solve_matches_jax(run):
    case, params, n_cycles, seed = RUNS[run]
    port_c, got = _solves_like_jax(case, params, n_cycles, seed)
    if params.get("stop_cycle"):
        assert got.cycles == params["stop_cycle"]
    assert got.msg_count == 2 * port_c.n_edges * got.cycles


@pytest.mark.parametrize("layout", ["lanes", "edges"])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_solve_matches_jax_on_the_other_layouts(run, layout):
    case, params, n_cycles, seed = RUNS[run]
    _solves_like_jax(case, dict(params, layout=layout), n_cycles, seed)


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
        ({"precision": "bf16"}, {}),
        # with and without a timeout
        ({"precision": "bf16"}, {"timeout": 1.0}),
    ],
)
def test_unported_options_raise(params, kwargs):
    # precision="bf16" was the last option the port refused; it is ported
    # now, with and without a timeout: it raises nothing and gives the
    # JAX package's result
    port_c, ref_c = _pair("grid")
    ref = jax_maxsum.solve(ref_c, params, n_cycles=3, **kwargs)
    got = maxsum.solve(port_c, params, n_cycles=3, device="cpu", **kwargs)
    assert (got.assignment, got.cost, got.violations, got.cycles) == (
        ref.assignment, ref.cost, ref.violations, ref.cycles
    )


@pytest.mark.parametrize(
    "layout, want",
    [
        ("auto", "ell"), ("ell", "ell"), ("ell_pallas", "ell"),
        ("lanes", "lanes"), ("pallas", "lanes"), ("edges", "edges"),
    ],
)
def test_resolve_layout_on_a_binary_problem(layout, want):
    port_c, _ = _pair("grid")
    assert maxsum.resolve_layout(port_c, layout) == want


@pytest.mark.parametrize("layout", ["lanes", "pallas", "edges"])
def test_every_layout_gives_the_ell_result_on_grid(layout):
    # the grid's sums are exact in every layout: one trajectory
    port_c, _ = _pair("grid")
    params = {"damping": 0.5}
    ell = maxsum.solve(port_c, params, n_cycles=30, seed=5, device="cpu")
    got = maxsum.solve(
        port_c, dict(params, layout=layout), n_cycles=30, seed=5,
        device="cpu",
    )
    assert got == ell


def _chip_smoke():
    """``chip_smoke.py`` loaded by path, for its problem generator."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_compiled(fields):
    """The JAX package's CompiledDCOP of the same arrays."""
    from pydcop_tpu.compile.core import ArityBucket, CompiledDCOP
    from pydcop_tpu.dcop.objects import Domain

    fields = dict(fields)
    fields["buckets"] = [ArityBucket(**b) for b in fields["buckets"]]
    fields["domains"] = [
        Domain(d.name, d.type, d.values) for d in fields["domains"]
    ]
    return CompiledDCOP(dcop=None, **fields)


@pytest.mark.parametrize("start", ["leafs", "all"])
def test_chip_smoke_mixed_problem_solves_like_jax(start):
    fields = _chip_smoke().mixed_problem_fields(
        n_vars=120, n_binary=240, n_ternary=60, seed=3
    )
    port_c = compiled_from_numpy(fields)
    assert sorted(b.arity for b in port_c.buckets) == [2, 3]
    assert np.all(np.diff(port_c.edge_var) >= 0)
    params = {"damping": 0.5, "start_messages": start}
    ref = jax_maxsum.solve(_jax_compiled(fields), params, n_cycles=30, seed=4)
    got = maxsum.solve(port_c, params, n_cycles=30, seed=4, device="cpu")
    assert got.violations == ref.violations
    assert got.cost == pytest.approx(ref.cost, rel=1e-5)
    assert got.cycles == ref.cycles


def test_chip_smoke_mixed_record_is_jaxs():
    # chip_smoke.py's maxsum_mixed phase at its own size: the recorded
    # (cost, violations, cycles) is the JAX package's, and the port's CPU
    # solve gives the same assignment
    smoke = _chip_smoke()
    fields = smoke.mixed_problem_fields()
    params = dict(smoke.MIXED["params"], layout="auto")
    run = dict(n_cycles=smoke.MIXED["n_cycles"], seed=smoke.MIXED["seed"])
    ref = jax_maxsum.solve(_jax_compiled(fields), params, **run)
    got = maxsum.solve(
        compiled_from_numpy(fields), params, device="cpu", **run
    )
    assert (ref.cost, ref.violations, ref.cycles) == smoke.MAXSUM_RECORDED[
        "mixed"
    ]
    assert got.assignment == ref.assignment
    assert (got.cost, got.violations, got.cycles) == (
        ref.cost, ref.violations, ref.cycles,
    )


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


def _scripted_engine(costs, n_cycles, convergence=None, keep_state=False):
    """run_cycles over a one-variable problem whose unary costs are
    ``costs``: init picks value 0, step k picks value k (mod len).  With
    ``keep_state`` the final state is copied into a state of its own."""
    from collections import namedtuple
    from types import SimpleNamespace

    import torch

    from pydcop_tpu_torch.algorithms.base import extract_values, run_cycles
    from pydcop_tpu_torch.compile.kernels import DeviceDCOP, onto_layout

    State = namedtuple("State", "values k")
    d = len(costs)
    zero = torch.zeros(1, dtype=torch.int64)
    onto_perm, onto_offsets = onto_layout(np.array([0, 1]))
    dev = DeviceDCOP(
        n_vars=1, max_domain=d, n_edges=1, n_constraints=1,
        domain_size=torch.tensor([d]),
        valid_mask=torch.ones((1, d), dtype=torch.bool),
        unary=torch.tensor([costs], dtype=torch.float32),
        constant_cost=torch.tensor(0.0),
        edge_var=zero, edge_con=zero, var_degree=zero,
        buckets=(), f2v_perm=zero, fan_in_offsets=torch.tensor([0, 1]),
        fan_in_onto_perm=torch.as_tensor(onto_perm),
        fan_in_onto_offsets=torch.as_tensor(onto_offsets),
    )

    def init(dev, key):
        return State(
            torch.zeros(1, dtype=torch.int32), torch.zeros((), dtype=torch.int32)
        )

    def step(dev, state, key):
        k = state.k + 1
        return State((k % d).reshape(1), k)

    values, _, extras = run_cycles(
        SimpleNamespace(), dev, init, step, extract_values,
        n_cycles=n_cycles, convergence=convergence, return_final=False,
        state_into=init(dev, None) if keep_state else None,
    )
    return values, extras


def test_anytime_best_is_strict_and_one_based():
    # cycle:  0  1  2  3  4  5
    # cost:   5  3  3  4  2  5   -> best 2, first reached at cycle 4
    vals, extras = _scripted_engine([5.0, 3.0, 3.0, 4.0, 2.0], n_cycles=5)
    assert vals.tolist() == [4]
    assert extras == {
        "best_cost": 2.0, "cycles": 5, "cycles_to_best": 4,
        "timed_out": False,
    }
    # asked for, the final state (after 5 cycles), not the best one
    _, extras = _scripted_engine(
        [5.0, 3.0, 3.0, 4.0, 2.0], n_cycles=5, keep_state=True
    )
    state = extras["state"]
    assert (state.values.tolist(), int(state.k)) == ([0], 5)
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
