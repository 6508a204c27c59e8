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

``_tile_fan_in`` and ``_eval_model`` are the card's fan-in tiles and
``evaluate`` kernel as numpy (which lane sums what, in which order),
held to the same references on the CPU.

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


def _fan_in_inputs(d, dtype, seed=0, spans=FAN_IN_SPANS):
    rng = np.random.default_rng(seed)
    n_pad = sum(nb * db for nb, db in spans)
    n_vars = sum(nb for nb, _ in spans)
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


def _jax_fan_in(spans, u, f2v_t):
    """The JAX package's ELL fan-in, class by class, jitted (the
    reshape-sums and broadcasts of its ELL variable step)."""
    jax, jnp, _ = _jax()
    d = u.shape[0]

    def fan_in(u, f2v):
        tot_parts, v2f_parts = [], []
        off_e = off_v = 0
        for nb, db in spans:
            ub = u[:, off_v:off_v + nb]
            if db == 0:
                tot_parts.append(ub)
            else:
                seg = f2v[:, off_e:off_e + nb * db].reshape(d, nb, db)
                tot_b = seg.sum(axis=2) + ub
                tot_parts.append(tot_b)
                v2f_parts.append((tot_b[:, :, None] - seg).reshape(d, -1))
            off_e += nb * db
            off_v += nb
        return (jnp.concatenate(tot_parts, axis=1),
                jnp.concatenate(v2f_parts, axis=1))

    dtype = "bfloat16" if f2v_t.dtype == torch.bfloat16 else "float32"
    f2v_j = jnp.asarray(f2v_t.float().numpy()).astype(dtype)
    return jax.jit(fan_in)(jnp.asarray(u.numpy()), f2v_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_fan_in_plain_equals_jitted_jax(dtype):
    u, f2v_t = _fan_in_inputs(3, dtype, seed=1)
    want_tot, want_v2f = _jax_fan_in(FAN_IN_SPANS, u, f2v_t)
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


# -- the batched sites: K instances of one shape, one launch ---------------


def _evaluate_batch(case, k, device="cpu"):
    """K instances of an EVALUATE case's shape (instance i drawn from seed
    i), stacked on a leading axis."""
    parts = []
    for i in range(k):
        unary, values, buckets, constant = _evaluate_inputs(case)
        rng = np.random.default_rng(1000 + i)
        unary = _costs(rng, unary.shape)
        values = rng.integers(0, unary.shape[1], len(values)).astype(
            np.int32)
        buckets = [(_costs(rng, t.shape), vs) for t, vs in buckets]
        parts.append((unary, values, buckets, np.float32(i)))

    def t(xs):
        return torch.as_tensor(np.stack(xs), device=device)

    n_b = len(parts[0][2])
    return (
        t([p[0] for p in parts]), t([p[1] for p in parts]),
        [(t([p[2][b][0] for p in parts]), t([p[2][b][1] for p in parts]))
         for b in range(n_b)],
        t([p[3] for p in parts]),
    )


@pytest.mark.parametrize("k", [1, 3])
def test_tree_evaluate_batched_on_cpu_is_each_instance(k):
    unary, values, buckets, constant = _evaluate_batch("window_edges", k)
    got = hk.tree_evaluate_batched(unary, values, buckets, constant)
    for i in range(k):
        want = hk.tree_evaluate_plain(
            unary[i], values[i], [(a[i], b[i]) for a, b in buckets],
            constant[i])
        assert _bits(got[i]) == _bits(want)


def _batched_launches_of(call):
    """``call()``'s result and its (xla_tree_sum launches, batched ones)."""
    before = (hk.xla_tree_sum.launches, hk.xla_tree_sum.batched.launches)
    out = call()
    torch.cuda.synchronize()
    return out, (hk.xla_tree_sum.launches - before[0],
                 hk.xla_tree_sum.batched.launches - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["arities_1_to_4", "window_edges",
                                  "100k"])
@pytest.mark.parametrize("k", [1, 3, 32])
def test_tree_evaluate_batched_kernel_equals_plain_on_card(case, k):
    # K totals, rows over 1,024 values among them, in one launch; each
    # the plain version's of its instance; a second launch finds its
    # tickets at zero
    _card()
    if case == "100k" and k == 32:
        pytest.skip("3.2M gathers a bucket: the k=3 case covers the tree")
    args = _evaluate_batch(case, k, "cuda")
    want = hk.tree_evaluate_batched(*[
        [(a.cpu(), b.cpu()) for a, b in x] if isinstance(x, list)
        else x.cpu() for x in args
    ])
    for _ in range(2):
        got, n = _batched_launches_of(
            lambda: hk.tree_evaluate_batched(*args))
        assert n == (1, 1)
        assert np.array_equal(_bits(got.cpu()), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3, 32])
def test_ell_fan_in_batched_kernel_equals_plain_on_card(dtype, k):
    # FAN_IN_SPANS holds a class of 2,048-slot rows: over 1,024 values
    _card()
    parts = [_fan_in_inputs(3, dtype, seed=i) for i in range(k)]
    u = torch.stack([p[0] for p in parts])
    f2v = torch.stack([p[1] for p in parts])
    (tot, v2f), n = _batched_launches_of(
        lambda: hk.ell_fan_in_batched(FAN_IN_SPANS, u.cuda(), f2v.cuda()))
    assert n == (1, 1)
    for i in range(k):
        want_tot, want_v2f = hk.ell_fan_in_plain(FAN_IN_SPANS, u[i], f2v[i])
        assert np.array_equal(_bits(tot[i].cpu()), _bits(want_tot))
        assert np.array_equal(_bits(v2f[i].cpu()), _bits(want_v2f))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 1025, 70_000])
@pytest.mark.parametrize("k", [1, 3, 32])
def test_rows_sum_batched_kernel_equals_plain_on_card(n, k):
    # the domain sum's strided rows of K instances ([K, n, D] read in
    # place), one launch
    _card()
    x = torch.as_tensor(_costs(np.random.default_rng(n + k), (k, 3, n)))
    xs = x.cuda().movedim(1, -1)  # [K, n, D], the plane read in place
    got, launches = _batched_launches_of(
        lambda: hk.xla_tree_sum_batched(xs))
    assert launches == (1, 1)
    for i in range(k):
        want = hk.xla_tree_sum_plain(x[i].movedim(0, -1))
        assert np.array_equal(_bits(got[i].cpu()), _bits(want))
    long_rows = x.cuda()  # [K, D, n]: rows of n values
    got, launches = _batched_launches_of(
        lambda: hk.xla_tree_sum_batched(long_rows))
    assert launches == (1, 1)
    for i in range(k):
        assert np.array_equal(_bits(got[i].cpu()),
                              _bits(hk.xla_tree_sum_plain(x[i])))


# -- the fan-in's warp tiles and the domain sum's short rows ----------------
#
# On the card the fan-in's classes of up to 32 slots run as warp tasks of
# 32 * g consecutive rows of one class, staged through a shared tile
# (``csrc/xla_tree_sum.cu``, ``TileTask``); the domain sum's rows of up to
# 32 values take a short-row kernel.  ``_tile_fan_in`` is that warp tiling
# as numpy, lane by lane: the host's task table, the lanes' coalesced
# loads into a tile of pitch ``db | 1`` (the slot of each value found by
# the kernel's own carry rule), each lane's sum of its rows in index order
# from +0.0, the plane's rounding, the write-back of ``t - x`` and the
# lanes' stores.  It must give the plain version's and JAX's bits, on
# ragged classes (rows not a multiple of 32), classes of every size up to
# 32 (the unrolled 2, 4, 8, 16, 32 and the runtime ones, odd and even)
# and config 4's span table.

# ragged classes: (37, 3), (70, 5), (33, 17), (31, 31) and (65, 32) end
# in a part-filled task; 6, 12 and 24 slots take the runtime body with an
# even db (pitch db + 1), 3, 5, 17 and 31 with an odd one
TILE_SPANS = ((4, 0), (50, 1), (37, 3), (70, 5), (33, 17), (31, 31),
              (65, 32), (45, 6), (21, 12), (11, 24), (40, 2), (9, 4),
              (300, 8), (5, 64), (2, 2048))
_LANES = 32


def _tile_groups(db):
    """Groups of 32 rows a warp task of a class of db slots takes (the
    source's ``tile_groups``): at least 16 values a lane."""
    return 16 if db <= 1 else (1 if db >= 16 else -(-16 // db))


def _tile_tasks(spans, d):
    """The short classes' warp tasks in the host's table: by class, its
    plane offset, variable offset, group and ``(plane row, first row,
    rows)`` of each task ``t``: ``t // per_d``, ``(t % per_d) * group``."""
    tasks = {}
    off_e = off_v = 0
    for c, (nb, db) in enumerate(spans):
        if db <= _LANES:
            group = _LANES * _tile_groups(db)
            per_d = -(-nb // group)
            tasks[c] = (off_e, off_v, group, [
                (t // per_d, (t % per_d) * group,
                 min(group, nb - (t % per_d) * group))
                for t in range(d * per_d)
            ])
        off_e += nb * db
        off_v += nb
    return tasks


def _round_plane(x, plane_dtype):
    """A float32 total as the plane's type rounds it (bf16: once)."""
    if plane_dtype == torch.bfloat16:
        return torch.as_tensor(x).to(torch.bfloat16).float().numpy()
    return x


def _tile_fan_in(spans, unary_t, f2v_t):
    """``ell_fan_in`` with its short classes as the card's warp tiles, in
    numpy, vectorised over a class's tasks ([T, 32]: a task's lanes); the
    classes over 32 slots (the kernel's row paths) are the plain
    version's.  Every output the tiles own starts as NaN."""
    d = f2v_t.shape[0]
    plane = f2v_t.float().numpy()
    u = unary_t.numpy()
    tot_plain, v2f_plain = hk.ell_fan_in_plain(spans, unary_t, f2v_t)
    tot, v2f = tot_plain.numpy().copy(), v2f_plain.numpy().copy()
    lane = np.arange(_LANES)[None, :]
    for c, (off_e, off_v, group, tasks) in _tile_tasks(spans, d).items():
        nb, db = spans[c]
        tot[:, off_v:off_v + nb] = np.nan
        v2f[:, off_e:off_e + nb * db] = np.nan
        dd, j0, rows = (np.array(col)[:, None] for col in zip(*tasks))
        dd = np.broadcast_to(dd, (len(tasks), _LANES))

        def put(out, at, value, live):
            out[dd[live], at[live]] = value[live]

        def u_at(row):  # the lanes' unary entries, 0.0 where masked
            live = row < rows
            return live, np.where(
                live, u[dd, off_v + j0 + np.minimum(row, rows - 1)],
                np.float32(0.0))

        if db <= 1:  # copy u, or a 1-slot row: its value, no tile
            for q in range(group // _LANES):
                row = lane + q * _LANES
                live, uv = u_at(row)
                if db == 0:
                    put(tot, off_v + j0 + row, uv, live)
                    continue
                x = plane[dd, off_e + j0 + np.minimum(row, rows - 1)]
                t = (x + uv).astype(np.float32)
                put(tot, off_v + j0 + row, t, live)
                put(v2f, off_e + j0 + row, (t - x).astype(np.float32), live)
            continue
        pitch = db | 1
        n = rows * db  # values of each task
        base = off_e + j0 * db
        dr, di = _LANES // db, _LANES % db
        tile = np.full((len(tasks), group * pitch), np.nan, np.float32)
        tix = np.arange(len(tasks))[:, None]
        # the lanes' loads, value e = lane + 32 k to row e // db, slot
        # e % db, found by the kernel's carry rule
        r, i = lane // db, lane % db
        slots = []
        for k in range(_tile_groups(db) * db):
            e = lane + k * _LANES
            at = np.broadcast_to(r * pitch + i, (len(tasks), _LANES))
            tile[tix, at] = np.where(
                e < n, plane[dd, base + np.minimum(e, n - 1)],
                np.float32(0.0))
            slots.append((e, at))
            r, i = r + dr, i + di
            r, i = np.where(i >= db, r + 1, r), np.where(i >= db, i - db, i)
        # each lane sums its rows from +0.0 in index order
        for q in range(_tile_groups(db)):
            row = lane + q * _LANES
            live, uv = u_at(row)
            cols = np.minimum(row, group - 1) * pitch
            acc = np.zeros((len(tasks), _LANES), np.float32)
            for k in range(db):
                acc = (acc + tile[tix, cols + k]).astype(np.float32)
            t = (_round_plane(acc, f2v_t.dtype) + uv).astype(np.float32)
            put(tot, off_v + j0 + row, t, live)
            for k in range(db):
                x = tile[tix, cols + k]
                tile[tix, cols + k] = np.where(
                    live, (t - x).astype(np.float32), x)
        # the lanes' stores of the range
        for e, at in slots:
            put(v2f, base + e, tile[tix, at], e < n)
    return torch.as_tensor(tot), torch.as_tensor(v2f)


def _at_offset(t, offset):
    """``t``'s values in fresh contiguous storage that starts ``offset``
    elements in (an odd offset: no 8- or 16-byte aligned row)."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


def _config4_ell():
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_coloring_arrays,
    )

    c = generate_coloring_arrays(100_000, 3, graph="scalefree", m_edge=2,
                                 seed=7)
    return c, tk.build_ell(c)


@pytest.mark.parametrize("d", [1, 3, 17])
def test_tile_tasks_cover_each_short_row_once(d):
    for spans in (TILE_SPANS, FAN_IN_SPANS, ((1, 1), (33, 2), (1, 32))):
        tasks = _tile_tasks(spans, d)
        short = [c for c, (_, db) in enumerate(spans) if db <= _LANES]
        assert sorted(tasks) == short
        for c, (_, _, group, class_tasks) in tasks.items():
            nb, db = spans[c]
            assert group % _LANES == 0 and group // _LANES * max(db, 1) >= 16
            seen = [(dd, j0 + r) for dd, j0, rows in class_tasks
                    for r in range(rows)]
            assert sorted(seen) == [(dd, j) for dd in range(d)
                                    for j in range(nb)]
            # a task's rows are one contiguous range of the plane
            assert all(0 < rows <= group for _, _, rows in class_tasks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1, 3, 17])
def test_tile_model_equals_plain(dtype, d):
    u, f2v_t = _fan_in_inputs(d, dtype, seed=d, spans=TILE_SPANS)
    f2v_t[:, :9] = -0.0  # the 1-slot class's rows: t - x of a -0.0
    tot, v2f = _tile_fan_in(TILE_SPANS, u, f2v_t)
    want_tot, want_v2f = hk.ell_fan_in_plain(TILE_SPANS, u, f2v_t)
    assert np.array_equal(_bits(tot), _bits(want_tot))
    assert np.array_equal(_bits(v2f), _bits(want_v2f))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_model_equals_jitted_jax(dtype):
    u, f2v_t = _fan_in_inputs(3, dtype, seed=11, spans=TILE_SPANS)
    want_tot, want_v2f = _jax_fan_in(TILE_SPANS, u, f2v_t)
    tot, v2f = _tile_fan_in(TILE_SPANS, u, f2v_t)
    assert np.array_equal(_bits(tot), _bits(want_tot))
    assert np.array_equal(_bits(v2f), _bits(want_v2f))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_tile_model_on_config4_equals_plain_and_jitted_jax_step(
        precision, monkeypatch):
    # config 4's span table (classes 2..32 hold 89.6% of its slots): the
    # model against the plain fan-in, then in the port's ELL variable step
    # against the JAX package's jitted one
    jax, jnp, jk = _jax()
    c, ell = _config4_ell()
    assert ell.spans[:5] == ((49911, 2), (29990, 4), (13430, 8), (4708, 16),
                             (1432, 32))
    rng = np.random.default_rng(4)
    unary_t = np.asarray(c.unary)[ell.var_perm].T.astype(np.float32).copy()
    f2v = np.where(ell.real_row, rng.normal(size=(3, ell.n_pad)), 0.0)
    f2v = f2v.astype(np.float32)
    prev = np.where(ell.real_row, rng.normal(size=(3, ell.n_pad)), 0.0)
    plane = jnp.bfloat16 if precision == "bf16" else jnp.float32
    f2v_j = jnp.asarray(f2v).astype(plane)
    prev_j = jnp.asarray(prev.astype(np.float32)).astype(plane)
    f2v_t = torch.as_tensor(np.asarray(f2v_j.astype(jnp.float32)))
    prev_t = torch.as_tensor(np.asarray(prev_j.astype(jnp.float32)))
    if precision == "bf16":
        f2v_t, prev_t = f2v_t.to(torch.bfloat16), prev_t.to(torch.bfloat16)
    u_t = torch.as_tensor(unary_t)
    tot, v2f = _tile_fan_in(ell.spans, u_t, f2v_t)
    want_tot, want_v2f = hk.ell_fan_in_plain(ell.spans, u_t, f2v_t)
    assert np.array_equal(_bits(tot), _bits(want_tot))
    assert np.array_equal(_bits(v2f), _bits(want_v2f))
    args = [ell.valid_ell_t, ell.edge_valid_t, ell.dsize_edges,
            ell.pos_of_var, ell.real_row]
    want_v2f, want_vals = jax.jit(
        lambda u, f, p, *a: jk.variable_step_with_select_ell(
            ell.spans, u, *a[:2], a[2], a[3], a[4], f, damping=0.5,
            prev_v2f_t=p,
        )
    )(jnp.asarray(unary_t), f2v_j, prev_j, *[jnp.asarray(a) for a in args])
    monkeypatch.setattr(tk, "ell_fan_in", _tile_fan_in)
    got_v2f, got_vals = tk.variable_step_with_select_ell(
        ell.spans, u_t, *[torch.as_tensor(a) for a in args], f2v_t,
        damping=0.5, prev_v2f_t=prev_t,
    )
    assert np.array_equal(got_vals.numpy(), np.asarray(want_vals))
    assert np.array_equal(_bits(got_v2f.float()), _bits(want_v2f))


@pytest.mark.parametrize("d", [2, 5, 16, 17, 32])
def test_domain_sum_short_rows_equal_jitted_jax(d):
    # the short-row kernel's sums: ((0 + x0) + x1) + ..., rows of an odd
    # count read in place, and a batch of three instances
    jax, jnp, _ = _jax()
    rng = np.random.default_rng(100 + d)
    x = _costs(rng, (3, d, 3001))
    x[:, 0, :5] = -0.0
    want = jax.jit(jax.vmap(lambda a: jnp.sum(a, axis=0, keepdims=True)))(
        jnp.asarray(x))
    for i in range(3):
        got = tk.domain_sum(torch.as_tensor(x[i]), 0)
        assert np.array_equal(_bits(got), _bits(want[i]))
    got = hk.xla_tree_sum_batched(torch.as_tensor(x).movedim(1, -1))
    assert np.array_equal(_bits(got), _bits(want[:, 0]))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [1, 3, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_fan_in_tiles_kernel_equals_plain_on_card(dtype, d, offset):
    # ragged short classes, 0 and 1 slot, runtime sizes; at an odd
    # offset no plane row is 8-byte aligned
    _card()
    u, f2v_t = _fan_in_inputs(d, dtype, seed=d, spans=TILE_SPANS)
    u_c, f2v_c = _at_offset(u.cuda(), offset), _at_offset(f2v_t.cuda(), offset)
    for _ in range(2):  # the second launch finds its tickets at zero
        (tot, v2f), n = _launches_of(
            lambda: hk.ell_fan_in(TILE_SPANS, u_c, f2v_c))
        assert n == 1
        want_tot, want_v2f = hk.ell_fan_in_plain(TILE_SPANS, u, f2v_t)
        assert np.array_equal(_bits(tot.cpu()), _bits(want_tot))
        assert np.array_equal(_bits(v2f.cpu()), _bits(want_v2f))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_fan_in_config4_kernel_equals_plain_on_card(dtype):
    _card()
    _, ell = _config4_ell()
    g = torch.Generator().manual_seed(4)
    f2v_t = torch.randn((3, ell.n_pad), generator=g).to(getattr(torch, dtype))
    u = torch.rand((3, len(ell.var_perm)), generator=g) * 10
    (tot, v2f), n = _launches_of(
        lambda: hk.ell_fan_in(ell.spans, u.cuda(), f2v_t.cuda()))
    assert n == 1
    want_tot, want_v2f = hk.ell_fan_in_plain(ell.spans, u, f2v_t)
    assert np.array_equal(_bits(tot.cpu()), _bits(want_tot))
    assert np.array_equal(_bits(v2f.cpu()), _bits(want_v2f))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_fan_in_tiles_batched_kernel_equals_plain_on_card(dtype, k):
    _card()
    parts = [_fan_in_inputs(3, dtype, seed=i, spans=TILE_SPANS)
             for i in range(k)]
    u = torch.stack([p[0] for p in parts])
    f2v = torch.stack([p[1] for p in parts])
    (tot, v2f), n = _batched_launches_of(
        lambda: hk.ell_fan_in_batched(TILE_SPANS, u.cuda(), f2v.cuda()))
    assert n == (1, 1)
    for i in range(k):
        want_tot, want_v2f = hk.ell_fan_in_plain(TILE_SPANS, u[i], f2v[i])
        assert np.array_equal(_bits(tot[i].cpu()), _bits(want_tot))
        assert np.array_equal(_bits(v2f[i].cpu()), _bits(want_v2f))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [3001, 4098])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 16, 17, 32, 33])
def test_domain_sum_short_rows_kernel_equals_plain_on_card(d, n, offset):
    # n odd or 2 mod 4: plane rows of every alignment and a scalar tail
    _card()
    x = torch.as_tensor(_costs(np.random.default_rng(d * n), (d, n)))
    x[0, :3] = -0.0
    x_c = _at_offset(x.cuda(), offset)
    got, launches = _launches_of(lambda: tk.domain_sum(x_c, 0))
    assert launches == 1
    assert np.array_equal(_bits(got.cpu()), _bits(tk.domain_sum(x, 0)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 17])
@pytest.mark.parametrize("k", [1, 3, 32])
def test_domain_sum_short_rows_batched_kernel_equals_plain_on_card(k, d):
    # [K, D, n] read in place: the instance on the grid's y axis
    _card()
    x = torch.as_tensor(_costs(np.random.default_rng(k * d), (k, d, 1003)))
    got, launches = _batched_launches_of(
        lambda: hk.xla_tree_sum_batched(x.cuda().movedim(1, -1)))
    assert launches == (1, 1)
    for i in range(k):
        want = hk.xla_tree_sum_plain(x[i].movedim(0, -1))
        assert np.array_equal(_bits(got[i].cpu()), _bits(want))


# -- evaluate's kernel: a level-2 window a block, one handoff an instance ----
#
# On the card ``tree_evaluate`` is ``evaluate_kernel`` (``csrc/
# xla_tree_sum.cu``).  A block is one level-2 window of one segment (the
# unary entries, or a bucket's table entries): warp w stages level-1
# windows 4w .. 4w + 3 of it, lane l gathering input l of each; lane q of
# warp w sums window 4w + q across the shared tile in index order from
# +0.0, and thread 0 sums the 32 window sums in order into the block's
# partial (a one-value segment's partial is its value).  Every block then
# takes one ticket of its instance; the block that draws the last one
# finishes each segment, a warp a segment (segments w, w + 8, ...): levels
# of windows in a loop while over 1,024 partials are left, then one level
# (lane w sums window w) or the partials themselves, then the lanes' sums
# in lane order from +0.0; thread 0 combines the totals as
# ``unary + (0 + b0 + b1 + ...) + constant``.  ``_eval_model`` is that
# kernel as numpy (blocks in a random order, partials NaN until written),
# held bit for bit to the plain version, to ``xla_tree_sum_plain`` segment
# by segment (a one-value segment's -0.0 shows only there: the combine's
# adds turn it into +0.0) and to the jitted JAX ``evaluate``.

_WARPS = 8
_PER_WARP = _LANES // _WARPS  # level-1 windows a warp stages
_UNROLLED_TAIL = _LANES * _LANES  # partials the tail's one level takes


def _eval_layout(n):
    """``(k1, lo1, k2, lo2)`` of a segment of n values as the host lays it
    out: level 1's windows and front padding (none up to 32 values, one
    window), the blocks (level-2 windows; one up to 1,024 values, whose
    sum is then the total; one for no value) and level 2's padding."""
    k1 = -(-n // _LANES)
    k2 = -(-k1 // _LANES)
    lo1 = 0 if n <= _LANES else (k1 * _LANES - n) // 2
    lo2 = 0 if k1 <= _LANES else (k2 * _LANES - k1) // 2
    return k1, lo1, max(k2, 1), lo2


def _seq(cols):
    """Sums along the last axis in index order from +0.0 (float32)."""
    acc = np.zeros(cols.shape[:-1], np.float32)
    for i in range(cols.shape[-1]):
        acc = (acc + cols[..., i]).astype(np.float32)
    return acc


def _eval_gather(unary, values, buckets):
    """The segments' values as the kernel gathers them: the unary entry of
    each variable, then each bucket's table entry at the flat index
    ``((v0 * D + v1) * D + ...)`` of its slots' values (float32)."""
    d = unary.shape[1]
    vals = values.astype(np.int64)
    segs = [unary[np.arange(len(vals)), vals]]
    for tables, slots in buckets:
        flat = vals[slots[:, 0]]
        for t in range(1, slots.shape[1]):
            flat = flat * d + vals[slots[:, t]]
        segs.append(tables[np.arange(len(flat)), flat])
    return [np.asarray(s, np.float32) for s in segs]


def _eval_partials(x):
    """The level-2 partial of each block of a segment's values: input
    ``((w2 * 32 - lo2 + 4 * warp + q) * 32 - lo1 + lane`` (0.0 outside
    [0, n)) at [block w2, warp, q, lane]; the window sums of lane q of each
    warp, then thread 0's sum of them in window order."""
    n = len(x)
    _, lo1, k2, lo2 = _eval_layout(n)
    w2, warp, q, lane = np.ix_(np.arange(k2), np.arange(_WARPS),
                               np.arange(_PER_WARP), np.arange(_LANES))
    c = ((w2 * _LANES - lo2 + warp * _PER_WARP + q) * _LANES - lo1 + lane)
    live = (c >= 0) & (c < n)
    tile = np.where(live, x[np.clip(c, 0, max(n - 1, 0))] if n else 0.0,
                    np.float32(0.0)).astype(np.float32)
    sums = _seq(tile)  # [k2, warp, q]: lane q of each warp
    part = _seq(sums.reshape(k2, _LANES))  # thread 0, windows in order
    if n == 1:  # input 0 is lane 0 of window 0
        part = tile[:, 0, 0, 0]
    return part


def _windows(src):
    """One level of windows of 32 over src with XLA's front padding."""
    m = len(src)
    k = -(-m // _LANES)
    lo = (k * _LANES - m) // 2
    padded = np.zeros(k * _LANES, np.float32)
    padded[lo:lo + m] = src
    return _seq(padded.reshape(k, _LANES))


def _eval_upper(part):
    """A segment's total from its partials, as one warp of the finishing
    block computes it."""
    if len(part) == 1:
        return part[0]
    src = part
    while len(src) > _UNROLLED_TAIL:  # lane w takes windows w, w + 32, ...
        src = _windows(src)
    lanes = np.zeros(_LANES, np.float32)
    w = _windows(src) if len(src) > _LANES else src
    lanes[:len(w)] = w
    return _seq(lanes)  # the lanes in order, every lane past them +0.0


def _eval_model(unary, values, buckets, constant, seed=0):
    """``(total, segment totals)`` of one instance (numpy operands) as
    ``evaluate_kernel`` computes them, its blocks in a random order."""
    segs = _eval_gather(unary, values, buckets)
    written = [_eval_partials(x) for x in segs]  # each block's partial
    parts = [np.full(len(p), np.nan, np.float32) for p in written]
    blocks = [(s, w2) for s, p in enumerate(parts) for w2 in range(len(p))]
    ticket, finisher = 0, None
    for b in np.random.default_rng(seed).permutation(len(blocks)):
        s, w2 = blocks[b]
        parts[s][w2] = written[s][w2]
        if ticket == len(blocks) - 1:  # the instance's last ticket
            assert finisher is None
            assert not any(np.isnan(p).any() for p in parts)
            finisher = b
        ticket += 1
    assert finisher is not None
    totals = [None] * len(segs)
    for warp in range(_WARPS):
        for t in range(warp, len(segs), _WARPS):
            totals[t] = np.float32(_eval_upper(parts[t]))
    cons = np.float32(0.0)
    for b in totals[1:]:
        cons = np.float32(cons + b)
    return np.float32(np.float32(totals[0] + cons) + constant), totals


def _model_levels(n):
    """The tree levels the kernel's structure gives a sum of n values, as
    ``xla_tree_levels`` writes them."""
    if n == 1:
        return []
    k1, lo1, k2, lo2 = _eval_layout(n)
    if n <= _LANES:
        return [(n, 1, 0, n)]
    levels = [(n, k1, lo1, _LANES)]
    if k1 <= _LANES:
        return levels + [(k1, 1, 0, k1)]
    levels.append((k1, k2, lo2, _LANES))
    m = k2
    while m > _LANES:
        k = -(-m // _LANES)
        levels.append((m, k, (k * _LANES - m) // 2, _LANES))
        m = k
    return levels + [(m, 1, 0, m)]


MODEL_SIZES = (1, 32, 33, 1024, 1025, 32768, 32769, 100_000)


@pytest.mark.parametrize("n", MODEL_SIZES + (0, 2, 31, 1023, 2049, 65_536,
                                             1_048_576, 1_048_577,
                                             33_554_433))
def test_eval_model_levels_are_xla_levels(n):
    # the blocks' two levels, then the finisher's loop and its one level
    # (33,554,433 values: two turns of the loop over 1,024 partials)
    assert _model_levels(n) == hk.xla_tree_levels(n)
    assert _eval_layout(n)[2] >= 1  # no value: one block, its sum +0.0


# the model's cases: (n_vars, D, [(n_c, arity) of each bucket]); every
# size of MODEL_SIZES as a unary and a bucket segment, arities 1 to 4,
# 16 buckets, a level loop over 1,024 partials (1,048,577 values)
MODEL_EVALUATE = {
    **{f"n{n}": (n, 3, [(n, 2), (max(n // 3, 1), 1 + n % 4)])
       for n in MODEL_SIZES},
    "arities_1_to_4": (2049, 3, [(33, 1), (1025, 2), (40, 3), (1, 4)]),
    "buckets_16": (1025, 2, [(n, 1 + b % 4) for b, n in enumerate(
        (1, 2, 31, 33, 64, 1024, 1025, 2048, 3000, 5, 1, 40, 32_769, 7, 900,
         1030))]),
    "level_loop": (1_048_577, 2, [(1_048_577, 1), (35, 2)]),
}
# the cases with no sum of 22 to 32 gathered values (XLA vectorizes those)
JAX_MODEL_EVALUATE = sorted(
    case for case, (n_vars, _, specs) in MODEL_EVALUATE.items()
    if not any(22 <= n <= 32 for n in [n_vars] + [n for n, _ in specs])
)


def _model_inputs(case, seed=0):
    """numpy (unary, values, [(tables_flat, var_slots)], constant) of a
    MODEL_EVALUATE case; the first variable's unary entry and the first
    constraint's table row are -0.0."""
    n_vars, d, specs = MODEL_EVALUATE[case]
    rng = np.random.default_rng([n_vars, seed])
    unary = _costs(rng, (n_vars, d))
    values = rng.integers(0, d, n_vars).astype(np.int32)
    buckets = [
        (_costs(rng, (n_c, d ** a)),
         rng.integers(0, n_vars, (n_c, a)).astype(np.int64))
        for n_c, a in specs
    ]
    unary[0, values[0]] = -0.0
    for tables, _ in buckets:
        tables[0, :] = -0.0
    return unary, values, buckets, np.float32(rng.random() * 5)


def _as_torch(unary, values, buckets, constant, value_dtype=torch.int32,
              device="cpu"):
    def t(a):
        return torch.as_tensor(a, device=device)

    return (t(unary), t(values).to(value_dtype),
            [(t(a), t(b)) for a, b in buckets], t(constant))


@pytest.mark.parametrize("case", sorted(MODEL_EVALUATE))
def test_eval_model_segments_equal_xla_tree_sum_plain(case):
    unary, values, buckets, constant = _model_inputs(case)
    _, totals = _eval_model(unary, values, buckets, constant)
    for x, total in zip(_eval_gather(unary, values, buckets), totals):
        want = hk.xla_tree_sum_plain(torch.as_tensor(x))
        assert _bits(total) == _bits(want.numpy())
    if MODEL_EVALUATE[case][0] == 1:  # a one-value sum keeps its -0.0
        assert np.signbit(totals[0])


@pytest.mark.parametrize("value_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", sorted(MODEL_EVALUATE))
def test_eval_model_equals_plain(case, value_dtype):
    ops = _model_inputs(case, seed=1)
    got, _ = _eval_model(*ops, seed=2)
    want = hk.tree_evaluate_plain(*_as_torch(*ops, value_dtype))
    assert _bits(got) == _bits(want.numpy())


@pytest.mark.parametrize("case", JAX_MODEL_EVALUATE)
def test_eval_model_equals_jitted_jax_evaluate(case):
    jax, jnp, jk = _jax()
    unary, values, buckets, constant = _model_inputs(case, seed=3)
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
    got, _ = _eval_model(unary, values, buckets, constant, seed=4)
    assert _bits(got) == _bits(want)


def _model_batch(case, k, seed=0):
    """K instances of a MODEL_EVALUATE case (instance i from seed 100 *
    seed + 10 + i), numpy, stacked on a leading axis."""
    inst = [_model_inputs(case, seed=100 * seed + 10 + i) for i in range(k)]
    return (np.stack([p[0] for p in inst]), np.stack([p[1] for p in inst]),
            [(np.stack([p[2][b][0] for p in inst]),
              np.stack([p[2][b][1] for p in inst]))
             for b in range(len(inst[0][2]))],
            np.stack([p[3] for p in inst]))


@pytest.mark.parametrize("k, case", [(1, "n1025"), (3, "buckets_16"),
                                     (32, "n33"), (32, "arities_1_to_4")])
def test_eval_model_batched_equals_plain(k, case):
    # a batch's instances are independent rows of blocks (the grid's y),
    # each with its own ticket: instance i's total is its solo total
    unary, values, buckets, constant = _model_batch(case, k)
    want = hk.tree_evaluate_batched(
        *_as_torch(unary, values, buckets, constant))
    for i in range(k):
        got, _ = _eval_model(unary[i], values[i],
                             [(t[i], s[i]) for t, s in buckets], constant[i],
                             seed=i)
        assert _bits(got) == _bits(want[i].numpy())


@pytest.mark.parametrize("n", MODEL_SIZES + (0, 1_048_577, 40_000_000))
def test_eval_scratch_fits_the_wrappers_allocation(n):
    # evaluate_kernel takes a partial a block and, over 1,024 partials,
    # room for the next level; the wrappers allocate what the source's
    # earlier kernel took, which covers it (so --against runs either
    # build through one marshalling)
    for sizes, k in (([n], 1), ([n, 7, n], 3)):
        need = 0
        for m in sizes:
            k2 = _eval_layout(m)[2]
            need += k2 + (-(-k2 // _LANES) if k2 > _UNROLLED_TAIL else 0)
        given = hk._tree_needs([(m, k) for m in sizes])[0] + k * len(sizes)
        assert k * need <= given


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", sorted(MODEL_EVALUATE))
def test_evaluate_kernel_model_cases_equal_plain_on_card(case, value_dtype):
    _card()
    ops = _model_inputs(case, seed=1)
    args = _as_torch(*ops, value_dtype, device="cuda")
    want = hk.tree_evaluate_plain(*_as_torch(*ops, value_dtype))
    for _ in range(2):  # the second launch finds its ticket at zero
        got, n = _launches_of(lambda: hk.tree_evaluate(*args))
        assert n == 1
        assert _bits(got.cpu().numpy()) == _bits(want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("k, case", [(1, "n1025"), (3, "buckets_16"),
                                     (32, "n33"), (32, "arities_1_to_4"),
                                     (3, "n100000")])
def test_evaluate_kernel_batched_model_cases_on_card(k, case, value_dtype):
    _card()
    batch = _model_batch(case, k)
    want = hk.tree_evaluate_batched(*_as_torch(*batch, value_dtype))
    args = _as_torch(*batch, value_dtype, device="cuda")
    got, n = _batched_launches_of(lambda: hk.tree_evaluate_batched(*args))
    assert n == (1, 1)
    assert np.array_equal(_bits(got.cpu()), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [None, 3])
def test_evaluate_kernel_graph_replays_on_card(k):
    # one launch captured into a CUDA graph, replayed over three other
    # operand sets copied into its inputs: each replay's total is its set's
    # (the finishing block left every ticket at zero for the next)
    _card()
    case = "buckets_16"

    def operands(seed):
        return _as_torch(*(_model_inputs(case, seed) if k is None
                           else _model_batch(case, k, seed)))

    call = hk.tree_evaluate if k is None else hk.tree_evaluate_batched
    host = operands(0)
    unary, values, buckets, constant = (
        x.cuda() if isinstance(x, torch.Tensor)
        else [(a.cuda(), b.cuda()) for a, b in x] for x in host)
    call(unary, values, buckets, constant)  # the ticket pool, outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with hk.capture_tally() as tally, torch.cuda.graph(graph):
        out = call(unary, values, buckets, constant)
    assert tally == ({hk.xla_tree_sum: 1} if k is None else
                     {hk.xla_tree_sum: 1, hk.xla_tree_sum.batched: 1})
    for seed in (1, 2, 3):
        u, v, bs, c = operands(seed)
        unary.copy_(u)
        values.copy_(v)
        for (t, s), (t_new, s_new) in zip(buckets, bs):
            t.copy_(t_new)
            s.copy_(s_new)
        constant.copy_(c)
        graph.replay()
        torch.cuda.synchronize()
        want = (hk.tree_evaluate_plain(u, v, bs, c) if k is None
                else hk.tree_evaluate_batched(u, v, bs, c))
        assert np.array_equal(_bits(out.cpu()), _bits(want))

