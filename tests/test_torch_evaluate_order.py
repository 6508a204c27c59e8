"""The port's float sums in XLA-CPU's order, against the JAX package.

The JAX engine runs each solve as one jitted program, and XLA's CPU
compiler rewrites every float32 sum over more than 32 elements into a
tree: windows of 32, each summed in order from 0.0 over the input padded
with zeros symmetrically, level after level until at most 32 partial sums
are left, then those in order.  ``xla_sum`` reproduces that order
(``hopper_kernels.xla_tree_levels``), so:

- ``xla_sum`` equals ``jax.jit(jnp.sum)`` bit for bit on costs of up to
  1e9 (forbidden tuples), 1-D and over the last axis of the ELL fan-in's
  ``[D, nb, db]`` classes, float32 and bf16;
- ``evaluate`` equals the jitted JAX ``evaluate`` bit for bit on the
  hard-coloring problem where a different order made the anytime best keep
  another cycle than JAX's (its tests are in ``test_torch_local_search.py``);
- ``segment_sum_onto`` equals XLA's fold of ``base + segment_sum(x)`` into
  one scatter-add onto ``base``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.commands.generators.graphcoloring import (
    generate_graph_coloring as jax_graph_coloring,
)
from pydcop_tpu.compile import kernels as jk
from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_graph_coloring,
)
from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile import kernels as tk
from pydcop_tpu_torch.compile.core import compile_dcop


def _big_costs(n, seed, shape=None):
    """float32 costs as ``evaluate`` sums them: soft costs in [0, 10),
    ~30% forbidden entries at 1e9, ~10% negated (max problems)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if shape is None else shape
    x = np.where(rng.random(shape) < 0.3, 1e9, rng.random(shape) * 10)
    sign = np.where(rng.random(shape) < 0.1, -1.0, 1.0)
    return (x * sign).astype(np.float32)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize(
    "n", [1, 2, 31, 32, 33, 1000, 1025, 3000, 100_003]
)
def test_xla_sum_equals_jitted_jnp_sum(n):
    jitted = jax.jit(jnp.sum)
    for seed in range(3):
        x = _big_costs(n, seed)
        want = jitted(jnp.asarray(x))
        got = tk.xla_sum(torch.as_tensor(x))
        assert got.dtype == torch.float32 and got.shape == ()
        assert _bits(got.numpy()) == _bits(want)


@pytest.mark.parametrize("db", [2, 16, 32, 64, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_sum_over_the_last_axis_equals_jax(db, dtype):
    # the ELL fan-in of one degree class: [D, nb, db] -> [D, nb], then the
    # unary costs added; a bf16 class sums in float32 and rounds once
    rng = np.random.default_rng(db)
    x = (rng.normal(size=(3, 9, db)) * np.exp(rng.normal(size=(3, 9, db))))
    u = rng.normal(size=(3, 9)).astype(np.float32)
    xj = jnp.asarray(x.astype(np.float32)).astype(dtype)
    want = jax.jit(lambda s, u: s.sum(axis=2) + u)(xj, jnp.asarray(u))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32)))
    xt = xt.to(getattr(torch, dtype))
    got = tk.xla_sum(xt) + torch.as_tensor(u)
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize(
    "n, want",
    [
        (1, []),  # a single value is its own sum
        (2, [(2, 1, 0, 2)]),
        (32, [(32, 1, 0, 32)]),
        (33, [(33, 2, 15, 32), (2, 1, 0, 2)]),
        # XLA's own HLO: window={size=32 stride=32 pad=12_12}
        (1000, [(1000, 32, 12, 32), (32, 1, 0, 32)]),
        # two levels, pad=4_4 then pad=1_1
        (3000, [(3000, 94, 4, 32), (94, 3, 1, 32), (3, 1, 0, 3)]),
    ],
)
def test_xla_tree_levels(n, want):
    assert hk.xla_tree_levels(n) == want


@pytest.mark.parametrize("n", [1, 2, 5, 40])
def test_xla_sum_keeps_the_sign_of_zero_as_xla_does(n):
    # XLA sums from +0.0 and pads with +0.0, so a total of -0.0 entries
    # reads +0.0; a single entry is its own sum and keeps its sign
    got = tk.xla_sum(torch.full((n,), -0.0))
    want = jax.jit(jnp.sum)(jnp.full((n,), -0.0, dtype=jnp.float32))
    assert bool(torch.signbit(got)) == bool(np.signbit(np.asarray(want)))
    assert bool(torch.signbit(got)) == (n == 1)


def test_xla_tree_sum_on_cpu_is_the_plain_version_and_uncounted():
    x = torch.as_tensor(_big_costs(5000, 3))
    before = hk.xla_tree_sum.launches
    assert torch.equal(hk.xla_tree_sum(x), hk.xla_tree_sum_plain(x))
    assert hk.xla_tree_sum.launches == before


# the problem and assignments on which the port's anytime best kept
# another cycle than JAX's while evaluate summed in torch's order
HARD80 = (80, 3, dict(graph="random", p_edge=0.07, soft=False, seed=1))


def test_evaluate_equals_jitted_jax_evaluate_on_hard_coloring():
    n, d, kw = HARD80
    jdev = jk.to_device(jax_compile_dcop(jax_graph_coloring(n, d, **kw)))
    tdev = tk.to_device(compile_dcop(generate_graph_coloring(n, d, **kw)),
                        "cpu")
    jitted = jax.jit(jk.evaluate)
    rng = np.random.default_rng(0)
    for _ in range(50):
        vals = rng.integers(0, d, n).astype(np.int32)
        want = jitted(jdev, jnp.asarray(vals))
        got = tk.evaluate(tdev, torch.as_tensor(vals))
        assert _bits(got.numpy()) == _bits(want)


@pytest.mark.parametrize("axis", [0, 1])
def test_segment_sum_onto_equals_xla_scatter_onto_base(axis):
    rng = np.random.default_rng(axis)
    n_seg, n_x = 40, 700
    ids = np.sort(rng.integers(0, n_seg - 3, n_x)).astype(np.int32)
    x = (rng.normal(size=(n_x, 3)) * 1e3).astype(np.float32)
    base = rng.normal(size=(n_seg, 3)).astype(np.float32)
    want = jax.jit(
        lambda b, x: b + jax.ops.segment_sum(
            x, jnp.asarray(ids), num_segments=n_seg, indices_are_sorted=True
        )
    )(jnp.asarray(base), jnp.asarray(x))
    want = np.asarray(want)
    perm, onto = (
        torch.as_tensor(a)
        for a in tk.onto_layout(tk.segment_offsets(ids, n_seg))
    )
    tb, tx = torch.as_tensor(base), torch.as_tensor(x)
    if axis == 1:  # the lanes layout: [D, n] planes, offsets a row a lane
        tb, tx, want = tb.T.contiguous(), tx.T.contiguous(), want.T
        onto = onto.expand(3, -1).contiguous()
    got = tk.segment_sum_onto(tb, tx, perm, onto, axis)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
