"""MaxSum's lanes layout (``[D, n_edges]`` planes) against the JAX
package's, on the same inputs, and the ``lanes``/``pallas`` solves.

- ``factor_arity2_minplus_plain`` and ``factor_step_lanes`` take adds, one
  subtract and mins in the JAX package's association, so they must equal
  the JAX functions exactly: the Pallas kernel ``factor_arity2_minplus``
  (interpret mode here) and ``factor_step_lanes`` with and without
  ``use_pallas``, the arity-3 bucket and D=20 included.
- ``variable_step_with_select_lanes`` sums floats.  Its fan-in is a
  segmented sum in edge order onto the unary costs, the order of the
  jitted JAX step (XLA folds ``unary + segment_sum`` into one scatter-add
  onto the unary plane), and its mean sums the domain axis in index
  order, as XLA's reduce does, so it is held to the jitted JAX step: the
  values and planes are required equal on every case.
- Whole solves: on the grid case the assignment, cost and cycle count are
  identical; elsewhere violations are equal and the cost is within
  rel=1e-5, the JAX package's own cross-layout bar.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import maxsum as jax_maxsum
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_generate,
)
from pydcop_tpu.commands.generators.mixedproblem import generate_mixed_problem
from pydcop_tpu.compile import kernels as jk
from pydcop_tpu.compile.core import compile_dcop
from pydcop_tpu.compile.pallas_kernels import (
    factor_arity2_minplus as jax_factor_arity2_minplus,
)
from pydcop_tpu_torch.algorithms import maxsum
from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile import kernels as tk
from pydcop_tpu_torch.interop import compiled_from_numpy, planes_from_numpy

# the JAX package's TestEllPallas cases, a D=20 coloring (past the TPU
# kernel's MAX_PALLAS_DOMAIN of 16) and a mixed binary + ternary problem
CASES = ("clique", "d20", "grid", "mixed", "scalefree")
# the factor step's cases add the CUDA kernel's cut points in D: 2 (four
# constraints a thread), 5 (the last D with two), 8 (the last with
# whole-table loads); 17 is the first D of its runtime-D kernel
FACTOR_CASES = CASES + ("d2", "d5", "d8", "d17")
COLORING = {
    "scalefree": (150, 3, dict(graph="scalefree", m_edge=2, seed=13)),
    "clique": (12, 3, dict(graph="random", p_edge=1.0, seed=3)),
    "grid": (36, 3, dict(graph="grid", seed=4)),
    "d20": (60, 20, dict(graph="scalefree", m_edge=2, seed=1)),
    "d2": (200, 2, dict(graph="scalefree", m_edge=2, seed=2)),
    "d5": (200, 5, dict(graph="scalefree", m_edge=2, seed=5)),
    "d8": (200, 8, dict(graph="scalefree", m_edge=2, seed=8)),
    "d17": (200, 17, dict(graph="scalefree", m_edge=2, seed=17)),
}
CPU = torch.device("cpu")
# The JAX steps as one compiled program each, as the JAX package's engine
# runs them (eager dispatch compiles each of their ops anew for each
# shape, and sums a fan-in before adding the unary costs, where the jitted
# step sums onto them).  Adds and mins cannot contract, so jit changes no
# bit of a factor step.
jax_factor_step_lanes = jax.jit(
    jk.factor_step_lanes, static_argnames=("use_pallas",)
)


def jax_variable_step(fn, case):
    return jax.jit(fn, static_argnames="damping")


def port_of(ref):
    """The port's CompiledDCOP for the JAX one's arrays."""
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    fields["buckets"] = [dataclasses.asdict(b) for b in ref.buckets]
    return compiled_from_numpy(fields)


@lru_cache(maxsize=None)
def jax_case(case):
    """The JAX CompiledDCOP of a case; object-level problems are cut to
    their arrays (``dcop=None``), the only thing the port solves."""
    if case == "mixed":
        dcop = generate_mixed_problem(30, 20, 0.3, arity=3, seed=1)
        ref = compile_dcop(dcop)
        return dataclasses.replace(ref, dcop=None)
    n, d, kw = COLORING[case]
    return jax_generate(n, d, **kw)


def _pair(case):
    ref = jax_case(case)
    return port_of(ref), ref


def _plane(shape, seed):
    """A random float32 plane with ~10% of its entries at BIG, as the
    invalid lanes of real messages carry."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    return np.where(rng.random(shape) < 0.1, 1e9, x).astype(np.float32)


def _devs(case):
    port, ref = _pair(case)
    pdev, rdev = tk.to_device(port, "cpu"), jk.to_device(ref)
    return pdev, tk.lanes_aux(pdev), rdev, jk.lanes_aux(rdev)


def test_mixed_case_has_an_arity3_bucket():
    port, _ = _pair("mixed")
    assert sorted(b.arity for b in port.buckets) == [2, 3]
    assert port.n_edges == 25 and port.max_domain == 3


# the cases within the TPU kernel's MAX_PALLAS_DOMAIN: past it the JAX
# package never runs its kernel (pallas_supported), and the D=17 and D=20
# cases are held against the jnp branch it runs by
# test_factor_step_lanes_equals_jax
@pytest.mark.parametrize(
    "case", [c for c in FACTOR_CASES if c not in ("d17", "d20")]
)
def test_factor_arity2_minplus_plain_equals_pallas_interpret(case):
    pdev, paux, rdev, raux = _devs(case)
    v2f = _plane((pdev.max_domain, pdev.n_edges), seed=3)
    v2f_t, _ = planes_from_numpy(v2f, v2f, CPU)
    for bi, b in enumerate(rdev.buckets):
        if b.arity != 2:
            continue
        a_in, b_in = (jnp.asarray(v2f)[:, b.edge_ids[:, s]] for s in (0, 1))
        want = jax_factor_arity2_minplus(
            raux.tables_t[bi], a_in, b_in, interpret=True
        )
        got = hk.factor_arity2_minplus_plain(
            v2f_t, *paux.edge_cols[bi], paux.tables_t[bi]
        )
        # adds, one subtract and mins in one association: exactly equal
        for g, w in zip(got, want):
            assert torch.equal(g, torch.as_tensor(np.asarray(w)))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", FACTOR_CASES)
def test_factor_step_lanes_equals_jax(case, use_pallas):
    pdev, paux, rdev, raux = _devs(case)
    v2f = _plane((pdev.max_domain, pdev.n_edges), seed=4)
    want = jax_factor_step_lanes(
        rdev, raux, jnp.asarray(v2f), use_pallas=use_pallas
    )
    v2f_t, _ = planes_from_numpy(v2f, v2f, CPU)
    before = hk.factor_arity2_minplus.launches
    got = tk.factor_step_lanes(pdev, paux, v2f_t)
    assert hk.factor_arity2_minplus.launches == before  # CPU: plain version
    assert torch.equal(got, torch.as_tensor(np.asarray(want)))


@pytest.mark.parametrize("case", CASES)
def test_variable_step_lanes_matches_jax(case):
    pdev, paux, rdev, raux = _devs(case)
    d, e = pdev.max_domain, pdev.n_edges
    f2v, prev = _plane((d, e), seed=5), _plane((d, e), seed=6)
    unary = np.random.default_rng(7).random((d, pdev.n_vars))
    unary = unary.astype(np.float32)
    want_v2f, want_vals = jax_variable_step(
        jk.variable_step_with_select_lanes, case
    )(
        rdev, raux._replace(unary_t=jnp.asarray(unary)), jnp.asarray(f2v),
        damping=0.5, prev_v2f_t=jnp.asarray(prev),
    )
    f2v_t, prev_t = planes_from_numpy(f2v, prev, CPU)
    got_v2f, got_vals = tk.variable_step_with_select_lanes(
        pdev, dataclasses.replace(paux, unary_t=torch.as_tensor(unary)),
        f2v_t, damping=0.5, prev_v2f_t=prev_t,
    )
    want_v2f = np.asarray(want_v2f)
    assert got_vals.dtype == torch.int32
    assert np.array_equal(got_vals.numpy(), np.asarray(want_vals))
    assert np.array_equal(got_v2f.numpy(), want_v2f)


@lru_cache(maxsize=None)
def jax_solve(case, layout, params, n_cycles, seed):
    """The JAX package's solve of a case (cached: several port solves are
    held against one)."""
    return jax_maxsum.solve(
        jax_case(case), dict(params, layout=layout), n_cycles=n_cycles,
        seed=seed,
    )


def assert_solve_matches(got, ref, case, stop_cycle=0):
    assert got.status == "FINISHED"
    assert got.violations == ref.violations
    if case == "grid":
        assert got.assignment == ref.assignment
        assert got.cost == ref.cost
        assert got.cycles == ref.cycles
    else:
        assert got.cost == pytest.approx(ref.cost, rel=1e-5)
    if stop_cycle:
        assert got.cycles == stop_cycle


# (case, params, n_cycles, seed): damping 0.5 and the default leafs
# wavefront on every case, plus the other start mode and a stop_cycle run
RUNS = {
    "grid": ("grid", (("damping", 0.5),), 30, 5),
    "scalefree": ("scalefree", (("damping", 0.5),), 30, 5),
    "clique": ("clique", (("damping", 0.5),), 30, 5),
    "d20": ("d20", (("damping", 0.5),), 20, 5),
    "mixed": ("mixed", (), 20, 0),
    "scalefree-all": (
        "scalefree", (("damping", 0.5), ("start_messages", "all")), 30, 5,
    ),
    "grid-stop-cycle": ("grid", (("damping", 0.5), ("stop_cycle", 12)), 30, 2),
}


# every run under lanes; under pallas, the runs that differ in the problem
# (the port runs one cycle for both, and the JAX package pins its two
# bit-identical), so the start-mode and stop_cycle variants run once
@pytest.mark.parametrize(
    "run, layout",
    [(run, "lanes") for run in sorted(RUNS)]
    + [(run, "pallas") for run in sorted(RUNS) if "-" not in run],
)
def test_solve_matches_jax(run, layout):
    case, params, n_cycles, seed = RUNS[run]
    ref = jax_solve(case, layout, params, n_cycles, seed)
    port, _ = _pair(case)
    before = hk.factor_arity2_minplus.launches
    got = maxsum.solve(
        port, dict(params, layout=layout), n_cycles=n_cycles, seed=seed,
        device="cpu",
    )
    assert hk.factor_arity2_minplus.launches == before
    assert_solve_matches(got, ref, case, dict(params).get("stop_cycle", 0))
    assert got.msg_count == 2 * port.n_edges * got.cycles


def test_mixed_problem_solves_like_jax_under_auto():
    # auto runs lanes on a problem ELL cannot represent; the JAX package
    # solves this one to cost 1.95 in 20 cycles
    ref = jax_solve("mixed", "auto", (), 20, 0)
    port, _ = _pair("mixed")
    got = maxsum.solve(port, {}, n_cycles=20, seed=0, device="cpu")
    assert_solve_matches(got, ref, "mixed")
    assert got.cost == pytest.approx(1.95, rel=1e-5)
    assert got.cycles == 20


def test_ell_layouts_fall_back_to_lanes_on_non_binary_problems(caplog):
    port, _ = _pair("mixed")
    lanes = maxsum.solve(
        port, {"layout": "lanes"}, n_cycles=10, seed=1, device="cpu"
    )
    for layout in ("auto", "ell", "ell_pallas"):
        with caplog.at_level("INFO", logger=maxsum.logger.name):
            got = maxsum.solve(
                port, {"layout": layout}, n_cycles=10, seed=1, device="cpu"
            )
        assert got == lanes
        assert "non-binary constraints" in caplog.text


def test_lanes_aux_is_built_once_per_problem():
    port, _ = _pair("scalefree")
    a = maxsum.solve(port, {"layout": "pallas"}, n_cycles=5, device="cpu")
    n_cached = len(port._device_consts)
    b = maxsum.solve(port, {"layout": "pallas"}, n_cycles=5, device="cpu")
    assert len(port._device_consts) == n_cached
    assert a == b
