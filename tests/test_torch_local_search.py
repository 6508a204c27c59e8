"""The local-search slice (DSA, MGM, MGM-2) against the JAX package, both
on the CPU, on the same arrays (carried across with ``port_of``), params
and seed.

- The local-cost layer: ``local_costs`` sums each variable's per-edge slot
  costs in edge order onto its unary costs, the order of the jitted JAX
  function (XLA folds ``unary + segment_sum`` into one scatter-add onto
  the unary plane), so it is required bitwise equal to the jitted
  ``local_costs`` on every case.
  ``edge_constraint_costs``, ``constraint_costs`` and ``violation_count``
  are gathers and counts: exact everywhere.
- The Ising generator's arrays and MGM-2's offer-structure arrays (host
  numpy, the same calls in the same order): bit-identical.
- Whole solves: the same assignment, cost, cycles, message counts and
  status as the JAX package.  A local-search move turns on float
  comparisons, so one ulp of difference in a local cost would diverge the
  trajectory; these cases are the evidence that it does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lanes import jax_case, port_of

from pydcop_tpu.algorithms import dsa as jax_dsa
from pydcop_tpu.algorithms import mgm as jax_mgm
from pydcop_tpu.algorithms import mgm2 as jax_mgm2
from pydcop_tpu.commands.generators.ising import (
    generate_ising_arrays as jax_ising,
)
from pydcop_tpu.commands.generators.ising import (
    grid_edges_periodic as jax_grid_edges_periodic,
)
from pydcop_tpu.compile import kernels as jk
from pydcop_tpu.compile.direct import compile_from_edges as jax_from_edges
from pydcop_tpu_torch.algorithms import dsa, mgm, mgm2
from pydcop_tpu_torch.commands.generators.ising import (
    generate_ising_arrays,
    grid_edges_periodic,
)
from pydcop_tpu_torch.compile import kernels as tk

CASES = ("grid", "ising", "isolated", "clique", "scalefree", "d20", "mixed")


def jax_problem(case):
    """The JAX CompiledDCOP of a case: the coloring and mixed-arity cases
    of ``test_torch_lanes``, a 6x7 Ising grid, and a small random
    problem whose last variable is in no constraint."""
    if case == "ising":
        return jax_ising(6, 7, seed=3)
    if case == "isolated":
        rng = np.random.default_rng(2)
        edges = np.array(
            [(i, j) for i in range(9) for j in range(i + 1, 9)
             if rng.random() < 0.3], dtype=np.int32,
        )
        table = rng.random((len(edges), 3, 3)).astype(np.float32) * 4
        return jax_from_edges(10, 3, edges, table)
    return jax_case(case)


def _pair(case):
    ref = jax_problem(case)
    return port_of(ref), ref


def _values(ref, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, ref.domain_size).astype(np.int32)


def test_isolated_case_has_an_unconstrained_variable():
    port, _ = _pair("isolated")
    assert port.var_degree[-1] == 0 and port.n_edges > 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_local_costs_equal_jax(case, seed):
    port, ref = _pair(case)
    vals = _values(ref, seed)
    want = np.asarray(
        jax.jit(jk.local_costs)(jk.to_device(ref), jnp.asarray(vals))
    )
    got = tk.local_costs(
        tk.to_device(port, "cpu"), torch.as_tensor(vals)
    ).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", CASES)
def test_constraint_costs_and_violations_equal_jax(case):
    port, ref = _pair(case)
    vals = _values(ref, 4)
    jdev, pdev = jk.to_device(ref), tk.to_device(port, "cpu")
    jv, pv = jnp.asarray(vals), torch.as_tensor(vals)
    for jfn, pfn in (
        (jk.edge_constraint_costs, tk.edge_constraint_costs),
        (jk.constraint_costs, tk.constraint_costs),
    ):
        want = np.asarray(jfn(jdev, jv))
        got = pfn(pdev, pv).numpy()
        assert np.array_equal(got, want)
    assert int(tk.violation_count(pdev, pv)) == int(
        jk.violation_count(jdev, jv)
    )


def test_violation_count_counts_forbidden_entries():
    port, ref = _pair("mixed")  # the mixed case has hard constraints
    counts = {
        int(tk.violation_count(tk.to_device(port, "cpu"),
                               torch.as_tensor(_values(ref, s))))
        for s in range(4)
    }
    assert max(counts) > 0


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_max_equals_jax(dtype):
    import jax

    # sorted ids with empty segments (1, 3 and the last): each gets the
    # dtype's lowest value, as in JAX (so an int32 flag reads True)
    ids = np.array([0, 0, 2, 4, 4, 4], dtype=np.int32)
    x = np.array([1, 5, -2, 0, 7, 3]).astype(dtype)
    want = np.asarray(jax.ops.segment_max(
        x, ids, num_segments=6, indices_are_sorted=True
    ))
    got = tk.segment_max(torch.as_tensor(x), torch.as_tensor(ids), 6)
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)
    if dtype == np.int32:
        assert (got != 0).tolist() == [True, True, True, True, True, True]


@pytest.mark.parametrize("shape", [(1, 5), (2, 2), (4, 6), (100, 100)])
def test_ising_arrays_equal_jax(shape):
    assert np.array_equal(
        grid_edges_periodic(*shape), jax_grid_edges_periodic(*shape)
    )
    if shape == (100, 100):  # bench config 3
        got, ref = generate_ising_arrays(100, 100, seed=3), jax_ising(
            100, 100, seed=3
        )
    else:
        got, ref = generate_ising_arrays(*shape, seed=5), jax_ising(
            *shape, seed=5
        )
    for f in ("unary", "edge_var", "edge_con", "var_degree", "domain_size"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    (gb,), (rb,) = got.buckets, ref.buckets
    for f in ("tables", "var_slots", "edge_ids", "con_ids"):
        a, b = getattr(gb, f), getattr(rb, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("case", CASES)
def test_mgm2_offer_structure_equals_jax(case):
    port, ref = _pair(case)
    want = jax_mgm2._offer_structure(ref, jk.to_device(ref))
    got = mgm2._offer_structure(port, port.max_domain)
    assert len(got) == len(want) == 12
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert np.array_equal(g, w), i
    if case == "mixed":
        assert len(got[6]) > 0  # the arity-3 slices are exercised


def test_mgm2_padded_offers_equal_jax():
    port, ref = _pair("scalefree")
    n_off = len(mgm2._offers_cached(port, port.max_domain)[0])
    want = jax_mgm2._padded_offers(ref, jk.to_device(ref), n_off + 7)
    got = mgm2._padded_offers(port, tk.to_device(port, "cpu"), n_off + 7)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def test_padded_neighbor_pairs_equal_jax():
    port, ref = _pair("grid")
    n = len(port.neighbor_pairs()[0]) + 5
    want = jax_mgm.padded_neighbor_pairs(ref, n, jk.to_device(ref))
    got = mgm.padded_neighbor_pairs(port, n, tk.to_device(port, "cpu"))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# (module, JAX module, params): every variant, break mode and favor
SOLVERS = {
    "dsa-A": (dsa, jax_dsa, {"variant": "A"}),
    "dsa-B": (dsa, jax_dsa, {"variant": "B"}),
    "dsa-C": (dsa, jax_dsa, {"variant": "C"}),
    "dsa-arity": (dsa, jax_dsa, {"p_mode": "arity", "probability": 0.5}),
    "mgm-lexic": (mgm, jax_mgm, {"break_mode": "lexic"}),
    "mgm-random": (mgm, jax_mgm, {"break_mode": "random"}),
    "mgm2-unilateral": (mgm2, jax_mgm2, {"favor": "unilateral"}),
    "mgm2-no": (mgm2, jax_mgm2, {"favor": "no", "threshold": 0.3}),
    "mgm2-coordinated": (mgm2, jax_mgm2, {"favor": "coordinated"}),
}
# (solver, case): each solver on a binary coloring, the Ising grid (MGM-2
# only: config 3's family), the mixed-arity problem and the problem with
# an isolated variable
SOLVES = [
    (s, c)
    for s in sorted(SOLVERS)
    for c in ("scalefree", "mixed", "isolated")
] + [("mgm2-unilateral", "ising"), ("dsa-B", "grid"), ("mgm-lexic", "d20")]


def assert_same_solve(got, ref):
    assert got.assignment == ref.assignment
    assert got.cost == ref.cost and got.violations == ref.violations
    assert got.cycles == ref.cycles
    assert (got.msg_count, got.msg_size) == (ref.msg_count, ref.msg_size)
    assert got.status == ref.status


@pytest.mark.parametrize("solver, case", SOLVES)
def test_solve_matches_jax(solver, case):
    mod, jax_mod, params = SOLVERS[solver]
    port, ref = _pair(case)
    want = jax_mod.solve(ref, params, n_cycles=25, seed=6)
    got = mod.solve(port, params, n_cycles=25, seed=6, device="cpu")
    assert_same_solve(got, want)
    assert got.status == "FINISHED" and got.cycles == 25


@pytest.mark.parametrize("mod", [dsa, mgm, mgm2])
def test_stop_cycle_sets_the_cycle_count(mod):
    port, _ = _pair("grid")
    got = mod.solve(port, {"stop_cycle": 7}, n_cycles=50, device="cpu")
    assert got.cycles == 7


def test_monotone_solvers_report_the_final_assignment():
    # MGM and MGM-2 never raise the cost: their final assignment is the
    # best one, and a longer run is no worse
    port, _ = _pair("scalefree")
    for mod in (mgm, mgm2):
        short = mod.solve(port, {}, n_cycles=5, seed=1, device="cpu")
        long = mod.solve(port, {}, n_cycles=20, seed=1, device="cpu")
        assert long.cost <= short.cost


@pytest.mark.parametrize("mod", [dsa, mgm, mgm2])
def test_entry_points_default_to_the_card(mod):
    port, _ = _pair("grid")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.solve(port, {}, n_cycles=3)


def test_dsa_variant_b_sees_isolated_variables_as_violated():
    # JAX's int32 segment_max gives INT32_MIN to a variable with no
    # constraint, which casts to True: variant B then lets it move on a
    # zero gain.  The port reproduces that flag.
    import jax

    port, ref = _pair("isolated")
    pdev, jdev = tk.to_device(port, "cpu"), jk.to_device(ref)
    vals = _values(ref, 0)
    switch, _ = dsa.dsa_decision(
        pdev, torch.as_tensor(vals), torch.ones(port.n_vars),
        dsa.constraint_optima(port, pdev), "B",
        torch.tensor([0, 3], dtype=torch.int64),
    )
    jswitch, _ = jax_dsa.dsa_decision(
        jdev, jnp.asarray(vals), jnp.ones(ref.n_vars),
        jax_dsa.constraint_optima(ref, jdev), "B", jax.random.PRNGKey(3),
    )
    assert switch.tolist() == np.asarray(jswitch).tolist()
    assert bool(switch[-1])  # probability 1: the isolated variable moves


# hard colorings (every conflict a forbidden 1e9 tuple) on which the
# anytime best kept another cycle than JAX's while ``evaluate`` summed in
# torch's order: many cycles tie in true cost, and only XLA's float32
# order picks JAX's one (test_torch_evaluate_order.py); (generator
# arguments, solver, seed, cycles)
HARD_COLORING = {
    "dsa": ((80, 3, dict(graph="random", p_edge=0.07, soft=False, seed=1)),
            "dsa", 0, 60),
    "maxsum": ((60, 3, dict(graph="random", p_edge=0.08, soft=False,
                            seed=2)), "maxsum", 1, 30),
}


@pytest.mark.parametrize("case", sorted(HARD_COLORING))
def test_hard_coloring_keeps_the_jax_anytime_best(case):
    from pydcop_tpu.algorithms import maxsum as jax_maxsum
    from pydcop_tpu.commands.generators.graphcoloring import (
        generate_graph_coloring as jax_graph_coloring,
    )
    from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.compile.core import compile_dcop

    (n, d, kw), algo, seed, n_cycles = HARD_COLORING[case]
    mod, jax_mod = {"dsa": (dsa, jax_dsa), "maxsum": (maxsum, jax_maxsum)}[
        algo
    ]
    ref = jax_compile_dcop(jax_graph_coloring(n, d, **kw))
    port = compile_dcop(generate_graph_coloring(n, d, **kw))
    want = jax_mod.solve(ref, {}, n_cycles=n_cycles, seed=seed)
    got = mod.solve(port, {}, n_cycles=n_cycles, seed=seed, device="cpu")
    assert want.violations > 0  # hard conflicts remain: costs tie at 1e9s
    assert_same_solve(got, want)
