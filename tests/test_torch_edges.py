"""MaxSum's edges layout (``[n_edges, D]`` planes) against the JAX
package's, on the same inputs, and the ``edges`` solves.

- ``factor_step`` takes adds, one subtract and mins in the JAX package's
  association, so it must equal the JAX ``factor_step`` exactly, the
  arity-3 bucket and D=20 included.
- ``variable_step_with_select`` and ``select_values`` sum floats: the
  fan-in is a segmented sum in edge order onto the unary costs, the order
  of the jitted JAX step, and the mean sums the domain axis in index
  order, as XLA's reduce does, so both are held to the jitted JAX
  functions: the values and planes are required equal on every case.
- Whole solves are held to the bar of ``tests/test_torch_lanes.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lanes import (
    CASES,
    RUNS,
    _pair,
    _plane,
    assert_solve_matches,
    jax_solve,
    jax_variable_step,
    port_of,
)

from pydcop_tpu.algorithms import maxsum as jax_maxsum
from pydcop_tpu.compile import kernels as jk
from pydcop_tpu_torch.algorithms import maxsum
from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile import kernels as tk
from pydcop_tpu_torch.interop import planes_from_numpy

CPU = torch.device("cpu")
# one compiled program (adds and mins: jit changes no bit of it)
jax_factor_step = jax.jit(jk.factor_step)


def _devs(case):
    port, ref = _pair(case)
    return tk.to_device(port, "cpu"), jk.to_device(ref)


@pytest.mark.parametrize("case", CASES)
def test_factor_step_equals_jax(case):
    pdev, rdev = _devs(case)
    v2f = _plane((pdev.n_edges, pdev.max_domain), seed=8)
    want = jax_factor_step(rdev, jnp.asarray(v2f))
    v2f_e, _ = planes_from_numpy(v2f, v2f, CPU)
    assert torch.equal(
        tk.factor_step(pdev, v2f_e), torch.as_tensor(np.asarray(want))
    )


@pytest.mark.parametrize("case", CASES)
def test_variable_step_matches_jax(case):
    pdev, rdev = _devs(case)
    d, e = pdev.max_domain, pdev.n_edges
    f2v, prev = _plane((e, d), seed=9), _plane((e, d), seed=10)
    want_v2f, want_vals = jax_variable_step(
        jk.variable_step_with_select, case
    )(rdev, jnp.asarray(f2v), damping=0.5, prev_v2f=jnp.asarray(prev))
    f2v_e, prev_e = planes_from_numpy(f2v, prev, CPU)
    got_v2f, got_vals = tk.variable_step_with_select(
        pdev, f2v_e, damping=0.5, prev_v2f=prev_e
    )
    assert torch.equal(
        tk.variable_step(pdev, f2v_e, damping=0.5, prev_v2f=prev_e), got_v2f
    )
    want_v2f = np.asarray(want_v2f)
    assert got_vals.dtype == torch.int32
    assert np.array_equal(got_vals.numpy(), np.asarray(want_vals))
    assert np.array_equal(
        tk.select_values(pdev, f2v_e).numpy(),
        np.asarray(jax.jit(jk.select_values)(rdev, jnp.asarray(f2v))),
    )
    assert np.array_equal(got_v2f.numpy(), want_v2f)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_solve_matches_jax(run):
    case, params, n_cycles, seed = RUNS[run]
    ref = jax_solve(case, "edges", params, n_cycles, seed)
    port, _ = _pair(case)
    def counts():
        return hk.factor_arity2_minplus.launches, hk.ell_minplus.launches

    before = counts()
    got = maxsum.solve(
        port, dict(params, layout="edges"), n_cycles=n_cycles, seed=seed,
        device="cpu",
    )
    # the edges layout has no kernel, in the JAX package as here
    assert counts() == before
    assert_solve_matches(got, ref, case, dict(params).get("stop_cycle", 0))


def _edgeless():
    """A problem with unary costs and no constraint between variables:
    a mixed problem of arity 1 folds every constraint into the unary
    plane."""
    from pydcop_tpu.commands.generators.mixedproblem import (
        generate_mixed_problem,
    )
    from pydcop_tpu.compile.core import compile_dcop

    ref = compile_dcop(generate_mixed_problem(10, 10, 0.3, arity=1, seed=2))
    ref = dataclasses.replace(ref, dcop=None)
    assert ref.n_edges == 0 and not ref.buckets
    return port_of(ref), ref


@pytest.mark.parametrize("layout", ["auto", "edges", "lanes"])
def test_edgeless_problem_solves_to_the_unary_argmin(layout):
    port, ref = _edgeless()
    want = jax_maxsum.solve(ref, {"layout": layout}, n_cycles=20, seed=0)
    got = maxsum.solve(
        port, {"layout": layout}, n_cycles=20, seed=0, device="cpu"
    )
    assert got.assignment == want.assignment
    assert got.cycles == want.cycles
    assert got.cost == pytest.approx(want.cost, rel=1e-5)
    best = np.where(port.valid_mask, port.unary, np.inf).argmin(axis=1)
    assert (got.cost, got.violations) == port.host_cost(best)
    assert got.msg_count == 0


def test_layouts_agree_on_scalefree():
    # the port's four cycles on one problem: the JAX package's
    # cross-layout bar (equal violations, cost within rel=1e-5)
    port, _ = _pair("scalefree")
    params = {"damping": 0.5, "noise": 0.0}
    ell = maxsum.solve(
        port, dict(params, layout="ell"), n_cycles=25, seed=5, device="cpu"
    )
    for layout in ("lanes", "pallas", "edges"):
        got = maxsum.solve(
            port, dict(params, layout=layout), n_cycles=25, seed=5,
            device="cpu",
        )
        assert got.violations == ell.violations
        assert got.cost == pytest.approx(ell.cost, rel=1e-5)
