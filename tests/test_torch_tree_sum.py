"""The sum sites of the ``xla_tree_sum`` kernel, whole, against the JAX
package.

On the card each site is one launch of ``csrc/xla_tree_sum.cu``:
``evaluate``'s total (``hopper_kernels.tree_evaluate``: the gathers, the
unary and bucket sums and their combine), MaxSum's ELL fan-in over every
degree class (``ell_fan_in``) and the sum over the domain axis, read in
place (``domain_sum``).  On the CPU each is its plain version, which must
be bit-equal to the per-call composition of ``xla_tree_sum_plain`` that
defines XLA-CPU's order and to the jitted JAX function: costs of up to
1e9 (forbidden tuples), sums of 1, 32, 33, 1,024, 1,025 and 100,000
values, a one-element sum of -0.0, buckets of arity 1 to 4, classes of
degree 0 to 2,048 with float32 and bf16 planes, and D = 1, 3 and 33.

One order of XLA-CPU's is not the port's: where the sum of 22 to 32
values is fused with the gather that makes them (``evaluate``'s unary or
bucket total of a problem with 22 to 32 variables or constraints), LLVM
vectorizes the loop (8 accumulators on an AVX-512 host), and the total may
differ from the sequential one in its last bits.  The vector width follows
the host's CPU, so the port keeps XLA's order for an unfused sum (the
order of ``jnp.sum`` of those values), and the JAX comparisons below use
sums outside that range; the composition test holds a 32-value bucket.

The tests marked ``cuda`` hold each kernel to its plain version on the
card and count its one launch; they skip without a card.  JAX is imported
only by the tests that compare with it, so on the card this file runs
without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tree_sum.py
"""

import types

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile import kernels as tk


def _jax():
    """(jax, jax.numpy, the JAX package's compile.kernels)."""
    import jax
    import jax.numpy as jnp

    from pydcop_tpu.compile import kernels as jk

    return jax, jnp, jk


def _costs(rng, shape):
    """float32 costs as ``evaluate`` sums them: soft costs in [0, 10),
    ~30% forbidden entries at 1e9, ~10% negated."""
    x = np.where(rng.random(shape) < 0.3, 1e9, rng.random(shape) * 10)
    return (x * np.where(rng.random(shape) < 0.1, -1.0, 1.0)).astype(
        np.float32
    )


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


# evaluate's cases: (n_vars, D, [(n_c, arity) of each bucket])
EVALUATE = {
    # a one-element sum keeps its -0.0
    "one_var": (1, 3, [(1, 2)]),
    "arities_1_to_4": (40, 3, [(2, 1), (33, 2), (1, 3), (1025, 4)]),
    "window_edges": (1024, 2, [(1025, 2), (33, 3), (1, 1)]),
    "no_bucket": (33, 4, []),
    "100k": (100_000, 3, [(100_000, 2)]),
    # a bucket of 32 constraints: XLA vectorizes its fused sum (above)
    "bucket_of_32": (40, 3, [(32, 3), (5, 2)]),
}
# the cases with no sum of 22 to 32 gathered values
JAX_EVALUATE = sorted(
    case for case, (n_vars, _, specs) in EVALUATE.items()
    if not any(22 <= n <= 32 for n in [n_vars] + [n for n, _ in specs])
)


def _evaluate_inputs(case):
    """numpy (unary, values, [(tables_flat, var_slots)], constant)."""
    n_vars, d, specs = EVALUATE[case]
    rng = np.random.default_rng(n_vars)
    unary = _costs(rng, (n_vars, d))
    values = rng.integers(0, d, n_vars).astype(np.int32)
    buckets = [
        (_costs(rng, (n_c, d ** a)),
         rng.integers(0, n_vars, (n_c, a)).astype(np.int64))
        for n_c, a in specs
    ]
    if case == "one_var":
        unary[0, values[0]] = -0.0
        buckets[0][0][0, :] = -0.0
    constant = np.float32(rng.random() * 5)
    return unary, values, buckets, constant


def _torch_evaluate_args(case, device="cpu"):
    unary, values, buckets, constant = _evaluate_inputs(case)

    def t(a):
        return torch.as_tensor(a, device=device)

    return (t(unary), t(values), [(t(a), t(b)) for a, b in buckets],
            t(constant))


@pytest.mark.parametrize("case", sorted(EVALUATE))
def test_tree_evaluate_plain_is_the_per_call_composition(case):
    unary, values, buckets, constant = _torch_evaluate_args(case)
    d = unary.shape[1]
    # the per-call composition: each sum one xla_tree_sum_plain call
    unary_cost = hk.xla_tree_sum_plain(unary[torch.arange(len(values)),
                                             values.long()])
    cons = 0
    for tables, var_slots in buckets:
        flat = torch.zeros(var_slots.shape[0], dtype=torch.int64)
        for t in range(var_slots.shape[1]):
            flat = flat * d + values.long()[var_slots[:, t]]
        cons = cons + hk.xla_tree_sum_plain(
            tables[torch.arange(len(flat)), flat]
        )
    want = unary_cost + cons + constant
    before = hk.xla_tree_sum.launches
    got = hk.tree_evaluate(unary, values, buckets, constant)
    assert hk.xla_tree_sum.launches == before
    assert got.shape == () and got.dtype == torch.float32
    assert _bits(got.numpy()) == _bits(want.numpy())


@pytest.mark.parametrize("case", JAX_EVALUATE)
def test_tree_evaluate_plain_equals_jitted_jax_evaluate(case):
    jax, jnp, jk = _jax()
    unary, values, buckets, constant = _evaluate_inputs(case)
    arities = [b.shape[1] for _, b in buckets]

    def jax_evaluate(unary, values, tables, slots, constant):
        dev = types.SimpleNamespace(
            unary=unary, max_domain=unary.shape[1], constant_cost=constant,
            buckets=[
                jk.DeviceBucket(a, t, s, None, None)
                for a, t, s in zip(arities, tables, slots)
            ],
        )
        return jk.evaluate(dev, values)

    want = jax.jit(jax_evaluate)(
        jnp.asarray(unary), jnp.asarray(values),
        [jnp.asarray(t) for t, _ in buckets],
        [jnp.asarray(s.astype(np.int32)) for _, s in buckets],
        jnp.asarray(constant),
    )
    got = hk.tree_evaluate(*_torch_evaluate_args(case))
    assert _bits(got.numpy()) == _bits(want)
    if case == "one_var":
        assert np.signbit(np.asarray(want)) == bool(torch.signbit(got))


# the ELL fan-in's degree classes, (nb, db) in plane order
FAN_IN_SPANS = ((4, 0), (50, 1), (40, 2), (9, 32), (5, 64), (2, 2048))


def _fan_in_inputs(d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n_pad = sum(nb * db for nb, db in FAN_IN_SPANS)
    n_vars = sum(nb for nb, _ in FAN_IN_SPANS)
    u = _costs(rng, (d, n_vars))
    u[:, 0] = -0.0  # a degree-0 class copies u, sign and all
    f2v = (rng.normal(size=(d, n_pad)) * 100).astype(np.float32)
    f2v_t = torch.as_tensor(f2v).to(getattr(torch, dtype))
    return torch.as_tensor(u), f2v_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_fan_in_plain_is_the_per_class_composition(dtype):
    u, f2v_t = _fan_in_inputs(3, dtype)
    tot_parts, v2f_parts = [], []
    off_e = off_v = 0
    for nb, db in FAN_IN_SPANS:
        ub = u[:, off_v:off_v + nb]
        if db == 0:
            tot_parts.append(ub)
        else:
            seg = f2v_t[:, off_e:off_e + nb * db].reshape(3, nb, db)
            tot_b = tk.xla_sum(seg) + ub
            tot_parts.append(tot_b)
            v2f_parts.append((tot_b[:, :, None] - seg).reshape(3, nb * db))
        off_e += nb * db
        off_v += nb
    before = hk.xla_tree_sum.launches
    tot, v2f = hk.ell_fan_in(FAN_IN_SPANS, u, f2v_t)
    assert hk.xla_tree_sum.launches == before
    assert tot.dtype == v2f.dtype == torch.float32
    assert np.array_equal(_bits(tot), _bits(torch.cat(tot_parts, 1)))
    assert np.array_equal(_bits(v2f), _bits(torch.cat(v2f_parts, 1)))
    assert bool(torch.signbit(tot[0, 0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_fan_in_plain_equals_jitted_jax(dtype):
    # the fan-in of the JAX package's ELL variable step, class by class
    jax, jnp, _ = _jax()
    u, f2v_t = _fan_in_inputs(3, dtype, seed=1)

    def jax_fan_in(u, f2v):
        tot_parts, v2f_parts = [], []
        off_e = off_v = 0
        for nb, db in FAN_IN_SPANS:
            ub = u[:, off_v:off_v + nb]
            if db == 0:
                tot_parts.append(ub)
            else:
                seg = f2v[:, off_e:off_e + nb * db].reshape(3, nb, db)
                tot_b = seg.sum(axis=2) + ub
                tot_parts.append(tot_b)
                v2f_parts.append((tot_b[:, :, None] - seg).reshape(3, -1))
            off_e += nb * db
            off_v += nb
        return (jnp.concatenate(tot_parts, axis=1),
                jnp.concatenate(v2f_parts, axis=1))

    f2v_j = jnp.asarray(f2v_t.float().numpy()).astype(dtype)
    want_tot, want_v2f = jax.jit(jax_fan_in)(jnp.asarray(u.numpy()), f2v_j)
    tot, v2f = hk.ell_fan_in(FAN_IN_SPANS, u, f2v_t)
    assert np.array_equal(_bits(tot), _bits(want_tot))
    assert np.array_equal(_bits(v2f), _bits(want_v2f))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_ell_variable_step_equals_jitted_jax(precision):
    # the whole variable half-cycle on a real ELL layout (hubs of degree
    # up to 256), whose fan-in is now ell_fan_in
    jax, jnp, jk = _jax()
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_coloring_arrays,
    )

    c = generate_coloring_arrays(2000, 3, graph="scalefree", m_edge=2,
                                 seed=7)
    ell = tk.build_ell(c)
    assert max(db for _, db in ell.spans) >= 128
    rng = np.random.default_rng(3)
    unary_t = np.asarray(c.unary)[ell.var_perm].T.astype(np.float32).copy()
    f2v = np.where(ell.real_row, rng.normal(size=(3, ell.n_pad)), 0.0)
    f2v = f2v.astype(np.float32)
    prev = np.where(ell.real_row, rng.normal(size=(3, ell.n_pad)), 0.0)
    plane = jnp.bfloat16 if precision == "bf16" else jnp.float32
    prev_j = jnp.asarray(prev.astype(np.float32)).astype(plane)
    args = [ell.valid_ell_t, ell.edge_valid_t, ell.dsize_edges,
            ell.pos_of_var, ell.real_row]
    want_v2f, want_vals = jax.jit(
        lambda u, f, p, *a: jk.variable_step_with_select_ell(
            ell.spans, u, *a[:2], a[2], a[3], a[4], f, damping=0.5,
            prev_v2f_t=p,
        )
    )(jnp.asarray(unary_t), jnp.asarray(f2v), prev_j,
      *[jnp.asarray(a) for a in args])
    prev_t = torch.as_tensor(np.asarray(prev_j.astype(jnp.float32)))
    if precision == "bf16":
        prev_t = prev_t.to(torch.bfloat16)
    got_v2f, got_vals = tk.variable_step_with_select_ell(
        ell.spans, torch.as_tensor(unary_t),
        *[torch.as_tensor(a) for a in args[:2]],
        torch.as_tensor(args[2]), torch.as_tensor(args[3]),
        torch.as_tensor(args[4]), torch.as_tensor(f2v), damping=0.5,
        prev_v2f_t=prev_t,
    )
    assert np.array_equal(got_vals.numpy(), np.asarray(want_vals))
    assert np.array_equal(_bits(got_v2f), _bits(want_v2f))


@pytest.mark.parametrize("d", [1, 3, 33])
def test_domain_sum_equals_jitted_jax_on_either_axis(d):
    jax, jnp, _ = _jax()
    rng = np.random.default_rng(d)
    x = _costs(rng, (d, 3000))
    want = jax.jit(lambda a: jnp.sum(a, axis=0, keepdims=True))(
        jnp.asarray(x)
    )
    got = tk.domain_sum(torch.as_tensor(x), 0)
    assert got.shape == (1, 3000)
    assert np.array_equal(_bits(got), _bits(want))
    # the edges layout's [n_edges, D] plane, and the contiguous composition
    got_t = tk.domain_sum(torch.as_tensor(x.T.copy()), 1)
    assert got_t.shape == (3000, 1)
    assert np.array_equal(_bits(got_t[:, 0]), _bits(want[0]))
    plain = hk.xla_tree_sum_plain(torch.as_tensor(x.T.copy()))
    assert np.array_equal(_bits(plain), _bits(want[0]))


def test_tree_sum_sites_refuse_other_devices():
    meta = torch.zeros((3, 40), device="meta")
    with pytest.raises(ValueError):
        hk.ell_fan_in(((40, 1),), meta, meta)
    with pytest.raises(ValueError):
        hk.tree_evaluate(meta, meta[0], [], meta[0, 0])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _launches_of(call):
    """The result of ``call()`` and the xla_tree_sum launches it made."""
    before = hk.xla_tree_sum.launches
    out = call()
    torch.cuda.synchronize()
    return out, hk.xla_tree_sum.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EVALUATE))
@pytest.mark.parametrize("value_dtype", [torch.int32, torch.int64])
def test_tree_evaluate_kernel_equals_plain_on_card(case, value_dtype):
    _card()
    unary, values, buckets, constant = _torch_evaluate_args(case, "cuda")
    values = values.to(value_dtype)
    for _ in range(2):  # the second launch finds its tickets at zero
        got, n = _launches_of(
            lambda: hk.tree_evaluate(unary, values, buckets, constant)
        )
        assert n == 1
        want = hk.tree_evaluate_plain(
            unary.cpu(), values.cpu(),
            [(a.cpu(), b.cpu()) for a, b in buckets], constant.cpu(),
        )
        assert _bits(got.cpu().numpy()) == _bits(want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 3])
def test_ell_fan_in_kernel_equals_plain_on_card(dtype, d):
    _card()
    u, f2v_t = _fan_in_inputs(d, dtype)
    (tot, v2f), n = _launches_of(
        lambda: hk.ell_fan_in(FAN_IN_SPANS, u.cuda(), f2v_t.cuda())
    )
    assert n == 1
    want_tot, want_v2f = hk.ell_fan_in_plain(FAN_IN_SPANS, u, f2v_t)
    assert np.array_equal(_bits(tot.cpu()), _bits(want_tot))
    assert np.array_equal(_bits(v2f.cpu()), _bits(want_v2f))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 33])
def test_domain_sum_kernel_equals_plain_on_card(d):
    _card()
    x = torch.as_tensor(_costs(np.random.default_rng(d), (d, 70_000)))
    got, n = _launches_of(lambda: tk.domain_sum(x.cuda(), 0))
    assert n == 1
    assert np.array_equal(_bits(got.cpu()), _bits(tk.domain_sum(x, 0)))
