"""MaxSum's ``precision="bf16"`` against the JAX package's, on the CPU.

Both message planes are stored in bfloat16; every op that reads them
widens them to float32, and each step's new planes round to bf16 once, as
they are stored.  The port reproduces the JAX engine's jitted arithmetic
(the order of every float sum, ``damping`` rounded to bf16 where it scales
a bf16 plane, the bf16 rounding of the stability test), so:

- the plain versions of both kernels, given a bf16 plane, equal the JAX
  package's Pallas kernels (interpret mode) given the same bf16 operands,
  and the factor steps equal the JAX steps, bit for bit;
- whole solves give the JAX package's assignment, cost, violations,
  cycles and message counts on every layout (``ell``, ``lanes``,
  ``pallas``, ``edges``, and the lanes fallback of a non-binary problem),
  with damping on both sides, on the variables only (the bf16 fan-in)
  and off (where the stop-on-stable test ends the solve early);
- bench config 2 gives the JAX package's pinned cost on all four layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lanes import _devs, _pair, _plane

from pydcop_tpu.algorithms import maxsum as jax_maxsum
from pydcop_tpu.compile import kernels as jk
from pydcop_tpu.compile.pallas_kernels import (
    factor_arity2_minplus as jax_factor_arity2_minplus,
)
from pydcop_tpu.compile.pallas_kernels import ell_minplus as jax_ell_minplus
from pydcop_tpu_torch.algorithms import maxsum
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_coloring_arrays,
)
from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile import kernels as tk


def _bf16_plane(shape, seed):
    """A random plane rounded to bf16: the same bits for both packages
    (JAX's and torch's float32 -> bf16 casts both round to nearest even)."""
    x = _plane(shape, seed)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.as_tensor(x).to(torch.bfloat16)
    assert np.array_equal(
        np.asarray(jx.astype(jnp.float32)), tx.float().numpy()
    )
    return jx, tx


@pytest.mark.parametrize("case", ["scalefree", "clique", "grid", "d8"])
def test_ell_minplus_plain_with_a_bf16_plane_equals_pallas(case):
    port, ref = _pair(case)
    pe, re_ = tk.build_ell(port), jk.build_ell(ref)
    d = port.max_domain
    jv, tv = _bf16_plane((d, pe.n_pad), seed=d)
    real = torch.as_tensor(pe.real_row)
    jv, tv = jnp.where(re_.real_row, jv, 0), torch.where(real, tv, 0.0)
    got = hk.ell_minplus_plain(
        tv, torch.as_tensor(pe.pair_perm), torch.as_tensor(pe.tabs_t), real
    )
    assert got.dtype == torch.float32
    tabs = jnp.asarray(re_.tabs_t)
    want = jax_ell_minplus(
        tabs.reshape(d * d, -1), jv[:, jnp.asarray(re_.pair_perm)],
        jnp.asarray(re_.real_row).astype(tabs.dtype), interpret=True,
    )
    assert torch.equal(got, torch.as_tensor(np.asarray(want)))
    want_jnp = jk.factor_step_ell(
        tabs, jnp.asarray(re_.pair_perm), jnp.asarray(re_.real_row), jv
    )
    assert torch.equal(got, torch.as_tensor(np.asarray(want_jnp)))


@pytest.mark.parametrize("case", ["scalefree", "clique", "grid", "d2", "d8"])
def test_factor_arity2_minplus_plain_with_a_bf16_plane_equals_pallas(case):
    pdev, paux, rdev, raux = _devs(case)
    jv, tv = _bf16_plane((pdev.max_domain, pdev.n_edges), seed=7)
    for bi, b in enumerate(rdev.buckets):
        a_in, b_in = (jv[:, b.edge_ids[:, s]] for s in (0, 1))
        want = jax_factor_arity2_minplus(
            raux.tables_t[bi], a_in, b_in, interpret=True
        )
        got = hk.factor_arity2_minplus_plain(
            tv, *paux.edge_cols[bi], paux.tables_t[bi]
        )
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert torch.equal(g, torch.as_tensor(np.asarray(w)))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["scalefree", "mixed", "d20"])
def test_factor_steps_with_a_bf16_plane_equal_jax(case, use_pallas):
    pdev, paux, rdev, raux = _devs(case)
    d, e = pdev.max_domain, pdev.n_edges
    jv, tv = _bf16_plane((d, e), seed=8)
    want = jax.jit(jk.factor_step_lanes, static_argnames="use_pallas")(
        rdev, raux, jv, use_pallas=use_pallas
    )
    assert torch.equal(
        tk.factor_step_lanes(pdev, paux, tv),
        torch.as_tensor(np.asarray(want)),
    )
    jv_e, tv_e = jv.T, tv.T.contiguous()
    want = jax.jit(jk.factor_step)(rdev, jv_e)
    assert torch.equal(
        tk.factor_step(pdev, tv_e), torch.as_tensor(np.asarray(want))
    )


BF16 = {"damping": 0.5, "precision": "bf16"}
# (params, cases): the default damping on every case; damping on the
# variables only (the factor->variable plane reaches the fan-in as bf16)
# and no damping or noise (where the stop-on-stable test ends the mixed
# problem's solve early) on two
RUNS = [
    (BF16, ("grid", "scalefree", "clique", "mixed", "d20")),
    (dict(BF16, damping=0.7, damping_nodes="vars"), ("scalefree",)),
    (dict(BF16, damping=0.0, noise=0.0), ("scalefree", "mixed")),
]
SOLVES = [
    (case, layout, i)
    for i, (_, cases) in enumerate(RUNS)
    for case in cases
    for layout in ("ell", "lanes", "pallas", "edges")
]


@pytest.mark.parametrize("case, layout, run", SOLVES)
def test_bf16_solve_equals_jax(case, layout, run):
    params = dict(RUNS[run][0], layout=layout)
    port, ref = _pair(case)
    want = jax_maxsum.solve(ref, params, n_cycles=30, seed=5)
    got = maxsum.solve(port, params, n_cycles=30, seed=5, device="cpu")
    assert got.assignment == want.assignment
    assert (got.cost, got.violations, got.cycles) == (
        want.cost, want.violations, want.cycles
    )
    assert (got.msg_count, got.msg_size, got.status) == (
        want.msg_count, want.msg_size, want.status
    )
    if params["damping"] == 0.0 and case == "mixed":
        assert got.cycles < 30  # stopped on stable messages


# bench config 2 under bf16: the JAX package's result on the CPU (the same
# on all four layouts; f32 gives 176.00823494198994)
CONFIG_2_BF16 = (176.9906821902914, 0, 60)


@pytest.mark.parametrize("layout", ["ell", "lanes", "pallas", "edges"])
def test_config2_bf16_gives_the_jax_cost(layout):
    c2 = generate_coloring_arrays(1000, 3, graph="random", p_edge=0.005,
                                  seed=11)
    got = maxsum.solve(
        c2, {"damping": 0.5, "stop_cycle": 60, "precision": "bf16",
             "layout": layout},
        n_cycles=60, seed=0, device="cpu",
    )
    assert (got.cost, got.violations, got.cycles) == CONFIG_2_BF16


def test_bf16_planes_are_stored_as_bf16():
    port, _ = _pair("scalefree")
    dev = tk.to_device(port, "cpu")
    for layout in ("ell", "lanes", "edges"):
        init = maxsum._make_init(layout, "bf16")
        consts = {
            "ell": lambda: (
                *maxsum._ell_activation(port, tk.build_ell(port), "all",
                                        "cpu"),
                *maxsum._ell_dev_arrays(port, tk.build_ell(port), "cpu"),
            ),
            "lanes": lambda: (dev.f2v_perm, dev.f2v_perm, tk.lanes_aux(dev)),
            "edges": lambda: (dev.f2v_perm, dev.f2v_perm),
        }[layout]()
        state = init(dev, None, *consts)
        assert state.v2f.dtype == state.f2v.dtype == torch.bfloat16
        assert not state.v2f.any()
