"""The ELL cycle's device ops against the JAX package's, on the same inputs.

- ``factor_step_ell`` and ``ell_minplus_plain`` take mins and adds only,
  so they must equal the JAX ``factor_step_ell`` exactly, both its jnp
  path and its Pallas kernel (``use_pallas=True``, interpret mode here).
- ``variable_step_with_select_ell`` and ``evaluate`` sum floats in XLA's
  order (``xla_sum``: windows of 32, level by level, for the fan-in of
  every degree class and for the totals; the domain axis in index order),
  so their values and planes are required equal to the JAX package's, on
  every case, and ``evaluate`` to the jitted ``evaluate`` the JAX engine
  runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms.base import _noised as jax_noised
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_generate,
)
from pydcop_tpu.compile import kernels as jk
from pydcop_tpu_torch.algorithms.base import _noised
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_coloring_arrays,
)
from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile import kernels as tk
from pydcop_tpu_torch.interop import planes_from_numpy
from pydcop_tpu_torch.random import PRNGKey

CASES = {
    "scalefree": (150, dict(graph="scalefree", m_edge=2, seed=13)),
    "clique": (12, dict(graph="random", p_edge=1.0, seed=3)),
    "grid": (36, dict(graph="grid", seed=4)),
}
# the CUDA kernel's cut points in D: 2 (two slots a thread), 5 (the last D
# with two), 8 (the last with whole-table loads); 17 is the first D of its
# runtime-D kernel, past the TPU kernel's MAX_PALLAS_DOMAIN of 16, where
# the JAX package runs jnp
DOMAINS = (2, 5, 8, 17)
CPU = torch.device("cpu")


def _case(name):
    n, kw = CASES[name]
    port, ref = generate_coloring_arrays(n, 3, **kw), jax_generate(n, 3, **kw)
    return port, ref, tk.build_ell(port), jk.build_ell(ref)


def _planes(ell, seed=11):
    """Two random [D, n_pad] planes, zero on padding slots."""
    rng = np.random.default_rng(seed)
    d = ell.tabs_t.shape[0]
    return [
        np.where(ell.real_row, rng.normal(size=(d, ell.n_pad)), 0.0).astype(
            np.float32
        )
        for _ in range(2)
    ]


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("fn", ["factor_step_ell", "ell_minplus_plain"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_factor_step_equals_jax(case, use_pallas, fn):
    _, _, pe, re_ = _case(case)
    v2f, _ = _planes(pe)
    ref = jk.factor_step_ell(
        jnp.asarray(re_.tabs_t), jnp.asarray(re_.pair_perm),
        jnp.asarray(re_.real_row), jnp.asarray(v2f), use_pallas=use_pallas,
    )
    v2f_t, _ = planes_from_numpy(v2f, v2f, CPU)
    args = (_t(pe.tabs_t), _t(pe.pair_perm), _t(pe.real_row), v2f_t)
    if fn == "factor_step_ell":
        got = tk.factor_step_ell(*args)
    else:
        got = hk.ell_minplus_plain(args[3], args[1], args[0], args[2])
    # mins and adds only: equal by value, exactly
    assert torch.equal(got, torch.as_tensor(np.asarray(ref)))


@pytest.mark.parametrize(
    "d, use_pallas",
    [(d, False) for d in DOMAINS] + [(d, True) for d in DOMAINS if d <= 16],
)
def test_ell_minplus_plain_equals_jax_at_domain_cut_points(d, use_pallas):
    kw = dict(graph="scalefree", m_edge=2, seed=d)
    pe, re_ = (
        tk.build_ell(generate_coloring_arrays(200, d, **kw)),
        jk.build_ell(jax_generate(200, d, **kw)),
    )
    v2f, _ = _planes(pe, seed=d)
    ref = jk.factor_step_ell(
        jnp.asarray(re_.tabs_t), jnp.asarray(re_.pair_perm),
        jnp.asarray(re_.real_row), jnp.asarray(v2f), use_pallas=use_pallas,
    )
    got = hk.ell_minplus_plain(
        _t(v2f), _t(pe.pair_perm), _t(pe.tabs_t), _t(pe.real_row)
    )
    assert got.shape == (d, pe.n_pad)
    # mins and adds only: equal by value, exactly
    assert torch.equal(got, torch.as_tensor(np.asarray(ref)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_variable_step_matches_jax(case):
    _, _, pe, re_ = _case(case)
    f2v, prev = _planes(pe, seed=5)
    d = pe.tabs_t.shape[0]
    unary = np.random.default_rng(6).random((d, len(pe.var_perm)))
    unary = unary.astype(np.float32)
    ref_v2f, ref_vals = jk.variable_step_with_select_ell(
        re_.spans, jnp.asarray(unary), jnp.asarray(re_.valid_ell_t),
        jnp.asarray(re_.edge_valid_t), jnp.asarray(re_.dsize_edges),
        jnp.asarray(re_.pos_of_var), jnp.asarray(re_.real_row),
        jnp.asarray(f2v), damping=0.5, prev_v2f_t=jnp.asarray(prev),
    )
    f2v_t, prev_t = planes_from_numpy(f2v, prev, CPU)
    v2f, vals = tk.variable_step_with_select_ell(
        pe.spans, _t(unary), _t(pe.valid_ell_t), _t(pe.edge_valid_t),
        _t(pe.dsize_edges), _t(pe.pos_of_var, torch.int64),
        _t(pe.real_row), f2v_t, damping=0.5, prev_v2f_t=prev_t,
    )
    ref_v2f, ref_vals = np.asarray(ref_v2f), np.asarray(ref_vals)
    assert vals.dtype == torch.int32
    assert np.array_equal(vals.numpy(), ref_vals)
    assert np.array_equal(v2f.numpy(), ref_v2f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluate_matches_jax(case):
    port, ref, _, _ = _case(case)
    vals = np.random.default_rng(2).integers(0, 3, ref.n_vars).astype(
        np.int32
    )
    want = float(
        jax.jit(jk.evaluate)(jk.to_device(ref), jnp.asarray(vals))
    )
    got = float(tk.evaluate(tk.to_device(port, "cpu"), _t(vals)))
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_argmin_matches_jax(case):
    port, ref, _, _ = _case(case)
    costs = np.random.default_rng(4).integers(0, 3, (ref.n_vars, 3))
    costs = costs.astype(np.float32)  # integer costs: many ties
    want = np.asarray(
        jk.masked_argmin(jnp.asarray(costs), jnp.asarray(ref.valid_mask))
    )
    got = tk.masked_argmin(_t(costs), _t(port.valid_mask))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_noised_unary_equals_jax(case):
    port, ref, _, _ = _case(case)
    want = jax_noised(
        jk.to_device(ref), jax.random.PRNGKey(9), ref.n_vars, 0.01
    ).unary
    got = _noised(tk.to_device(port, "cpu"), PRNGKey(9), 0.01).unary
    assert np.array_equal(
        got.numpy().view(np.uint32), np.asarray(want).view(np.uint32)
    )
