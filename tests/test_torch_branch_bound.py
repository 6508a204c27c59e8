"""SyncBB, NCBB and their depth-first branch and bound against the JAX
package, both on the CPU.

The port's DFS (``hopper_kernels.branch_bound``: on the CPU its plain
version, 256 masked steps between looks at the depth) must take JAX's
``_bb_loop`` steps exactly: the same step count, incumbent and completion
flag, and the same upper bound to the bit (the attachment sum in XLA's
order: in slot order up to 32 slots, the tree above).  Whole solves give
the JAX package's assignment, cost, ``cycle``, ``msg_count`` and status
on random binary problems of 6 to 12 variables (with unary costs, and
one to maximize), on ``tests/instances/graph_coloring.yaml`` and under a
step cap.  Ternary constraints are refused.  The CLI prints the JAX CLI's
JSON.  The kernel's tests on the card are in ``test_torch_kernels.py``.

The card's kernel does not take JAX's steps one by one: it computes a
position's candidate row once a visit, when the search descends into it,
and every later step at that position reads the row.  ``_row_search``
is that search as scalar numpy, held here to ``_bb_loop`` and to the
plain DFS exactly, so the reformulation is checked on the CPU.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_api import _path, assert_same_result
from test_torch_cli import _run
from test_torch_kernels import BB_SYNTH, _k1_searches, bb_operands
from test_torch_lanes import port_of

import pydcop_tpu as J
import pydcop_tpu_torch as P
from pydcop_tpu.algorithms import _branch_bound as jax_bb
from pydcop_tpu.algorithms import ncbb as jax_ncbb
from pydcop_tpu.algorithms import syncbb as jax_syncbb
from pydcop_tpu.commands.generators.mixedproblem import (
    generate_mixed_problem as jax_mixed_problem,
)
from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
from pydcop_tpu.compile.direct import compile_from_edges as jax_from_edges
from pydcop_tpu.dcop.yamldcop import dcop_yaml
from pydcop_tpu_torch.algorithms import _branch_bound, ncbb, syncbb
from pydcop_tpu_torch.algorithms.dpop import _Tree
from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile.core import compile_dcop
from pydcop_tpu_torch.dcop.yamldcop import load_dcop

SOLVERS = {"syncbb": (syncbb, jax_syncbb), "ncbb": (ncbb, jax_ncbb)}


def _random(n, d, p, seed, unary=False, objective="min"):
    """A random binary problem (JAX arrays): each pair a constraint with
    probability p, tables in [0, 4), optional unary costs in [0, 1)."""
    rng = np.random.default_rng(seed)
    edges = np.array(
        [(i, j) for i in range(n) for j in range(i + 1, n)
         if rng.random() < p], dtype=np.int32,
    )
    table = (rng.random((len(edges), d, d)) * 4).astype(np.float32)
    u = (rng.random((n, d)).astype(np.float32) if unary else None)
    return jax_from_edges(n, d, edges, table, unary=u, objective=objective)


# name: (problem arguments, the algorithms to run it; SyncBB only where
# its plain DFS takes a few thousand steps at most)
PROBLEMS = {
    "rand6": ((6, 3, 0.5, 0), ("syncbb", "ncbb")),
    "rand8": ((8, 3, 0.4, 1), ("syncbb", "ncbb")),
    "rand10_d2": ((10, 2, 0.4, 2), ("syncbb", "ncbb")),
    "rand12": ((12, 3, 0.3, 3), ("ncbb",)),
    "rand9_d4": ((9, 4, 0.5, 4), ("ncbb",)),
    "rand7_unary": ((7, 3, 0.5, 5, True), ("syncbb", "ncbb")),
    "rand8_max": ((8, 3, 0.4, 6, True, "max"), ("syncbb", "ncbb")),
}
RUNS = [(name, algo) for name, (_, algos) in PROBLEMS.items()
        for algo in algos]


def assert_same(got, want):
    assert got.assignment == want.assignment
    assert (got.cost, got.violations, got.cycles, got.msg_count,
            got.msg_size, got.status) == (
        want.cost, want.violations, want.cycles, want.msg_count,
        want.msg_size, want.status)


def _solve_both(algo, ref, params):
    port_mod, jax_mod = SOLVERS[algo]
    want = jax_mod.solve(ref, dict(params))
    got = port_mod.solve(port_of(ref), dict(params), device="cpu")
    return got, want


@pytest.mark.parametrize("name, algo", RUNS)
def test_solve_matches_jax(name, algo):
    args, _ = PROBLEMS[name]
    got, want = _solve_both(algo, _random(*args), {})
    assert want.status == "FINISHED"
    assert_same(got, want)


@pytest.mark.parametrize("algo", sorted(SOLVERS))
@pytest.mark.parametrize("name", ["rand8", "rand12"])
def test_step_cap_times_out_at_jax_steps(algo, name):
    got, want = _solve_both(algo, _random(*PROBLEMS[name][0]),
                            {"max_iters": 5})
    assert want.status == "TIMEOUT"
    assert_same(got, want)


@pytest.mark.parametrize("algo", sorted(SOLVERS))
def test_graph_coloring_instance_like_jax(algo):
    ref = J.load_dcop_from_file(_path("graph_coloring"))
    port = P.load_dcop_from_file(_path("graph_coloring"))
    want = J.solve_result(ref, algo)
    got = P.solve_result(port, algo, device="cpu")
    assert_same_result(got, want, algo)


@pytest.mark.parametrize("algo", sorted(SOLVERS))
def test_ternary_constraint_is_refused_like_jax(algo):
    dcop = jax_mixed_problem(12, 8, 0.3, arity=3, seed=1)
    ref = jax_compile_dcop(dcop)
    port = compile_dcop(load_dcop(dcop_yaml(dcop)))
    port_mod, jax_mod = SOLVERS[algo]
    with pytest.raises(ValueError, match="binary") as want:
        jax_mod.solve(ref, {})
    with pytest.raises(ValueError, match="binary") as got:
        port_mod.solve(port, {}, device="cpu")
    assert str(got.value) == str(want.value)


def _loop_both(ref, order, max_iters, initial=None):
    """JAX's ``_bb_loop`` on its operands, and the port's plain DFS on
    the port's operands of the same problem."""
    order = np.asarray(order)
    port = port_of(ref)
    ops = _branch_bound._operands(port, order, initial, torch.device("cpu"))
    got = hk.branch_bound(*ops, max_iters).numpy()
    # the JAX operands, built as branch_and_bound builds them
    att_table, att_other, att_mask, _ = jax_bb._build_attachments(ref, order)
    j_ops = [o.numpy() for o in ops]
    assert np.array_equal(j_ops[2], att_table)
    assert np.array_equal(j_ops[3], att_other)
    assert np.array_equal(j_ops[4], att_mask)
    best, ub, iters, complete = jax_bb._bb_loop(
        *(jnp.asarray(o) for o in j_ops), max_iters=max_iters
    )
    n = ref.n_vars
    want = np.concatenate([
        np.asarray(best, np.int32),
        np.asarray(ub, np.float32).reshape(1).view(np.int32),
        [int(iters), int(complete)],
    ]).astype(np.int32)
    return got, want, ops[2].shape[1], n


@pytest.mark.parametrize("name", ["rand6", "rand8", "rand7_unary"])
def test_plain_dfs_takes_jax_steps(name):
    ref = _random(*PROBLEMS[name][0])
    got, want, _, n = _loop_both(ref, np.arange(ref.n_vars), 10 ** 6)
    assert want[n + 2] == 1  # complete
    assert np.array_equal(got, want)


def test_plain_dfs_with_a_seed_takes_jax_steps():
    ref = _random(*PROBLEMS["rand12"][0])
    port = port_of(ref)
    tree = _Tree(port)
    initial = ncbb._greedy_init(port, tree)
    got, want, _, _ = _loop_both(ref, tree.topo, 10 ** 6, initial)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n, p, k_min", [
    (12, 0.0, 1),  # K = 1: a one-element sum keeps its term as is
    (40, 1.0, 33),  # K = 39: windows of 32, then the window sums
])
def test_plain_dfs_sums_in_xla_order(n, p, k_min):
    # capped searches with tables of mixed magnitudes: an attachment sum in
    # another order would change the upper bound's bits or the trajectory
    rng = np.random.default_rng(n)
    edges = np.array([(i, i + 1) for i in range(n - 1)] if p == 0.0 else
                     [(i, j) for i in range(n) for j in range(i + 1, n)],
                     dtype=np.int32)
    table = (rng.random((len(edges), 3, 3)) * 10.0 ** rng.integers(
        -3, 4, (len(edges), 1, 1))).astype(np.float32)
    ref = jax_from_edges(n, 3, edges, table)
    got, want, k, _ = _loop_both(ref, np.arange(n), 3000)
    assert k >= k_min
    assert np.array_equal(got, want)


def _xla_slot_sum(terms):
    """The float32 sum of a position's K slot terms in the order of the
    jitted ``_bb_loop``'s reduce: K = 1 the term itself, up to 32 in slot
    order from +0.0, above that windows of 32 (symmetric zero padding),
    each from +0.0, then the window sums in order from +0.0."""
    f32 = np.float32
    k = len(terms)
    if k == 1:
        return terms[0]
    if k <= 32:
        acc = f32(0.0)
        for t in terms:
            acc = f32(acc + t)
        return acc
    windows = -(-k // 32)
    lo = (windows * 32 - k) // 2
    padded = [f32(0.0)] * lo + list(terms) + [f32(0.0)] * (
        windows * 32 - k - lo)
    top = f32(0.0)
    for w in range(windows):
        acc = f32(0.0)
        for t in padded[32 * w:32 * (w + 1)]:
            acc = f32(acc + t)
        top = f32(top + acc)
    return top


def _row_search(ops, max_iters):
    """The card kernel's search, scalar: on a descent into p (and for p =
    0 at the start) p's row ``(test, cost_new)`` for every v < dsize[p];
    every step at p reads it; a return to p resumes at assign[p] + 1.
    Returns the output vector, the descents as (step, position), and the
    rows computed by position."""
    unary, dsize, table, other, mask, lb, ub0, best0 = (
        o.numpy() for o in ops)
    n = unary.shape[0]
    f32 = np.float32
    assign = np.zeros(n, dtype=np.int32)
    best = best0.astype(np.int32).copy()
    ub = f32(ub0)
    rows = np.zeros((n, unary.shape[1], 2), dtype=np.float32)
    visits = np.zeros(n, dtype=np.int64)

    def row(p, prefix):
        visits[p] += 1
        for v in range(dsize[p]):
            terms = [table[p, s, assign[other[p, s]], v] if mask[p, s]
                     else f32(0.0) for s in range(table.shape[1])]
            cost_new = f32(prefix + f32(unary[p, v] + _xla_slot_sum(terms)))
            rows[p, v] = (f32(cost_new + lb[p + 1]), cost_new)

    depth = v = steps = 0
    descents = []
    if max_iters > 0:
        row(0, f32(0.0))
    while steps < max_iters:
        steps += 1
        if v >= dsize[depth]:
            depth -= 1
            if depth < 0:
                break
            v = assign[depth] + 1
            continue
        test, cost_new = rows[depth, v]
        if not test < ub:
            v += 1
            continue
        assign[depth] = v
        if depth == n - 1:
            ub, best, v = cost_new, assign.copy(), v + 1
        else:
            depth, v = depth + 1, 0
            descents.append((steps, depth))
            row(depth, cost_new)
    out = np.concatenate([
        best, np.asarray(ub, np.float32).reshape(1).view(np.int32),
        [steps, int(depth < 0)],
    ]).astype(np.int32)
    return out, descents, visits


def _jax_loop(ops, max_iters):
    best, ub, iters, complete = jax_bb._bb_loop(
        *(jnp.asarray(o.numpy()) for o in ops), max_iters=max_iters
    )
    return np.concatenate([
        np.asarray(best, np.int32),
        np.asarray(ub, np.float32).reshape(1).view(np.int32),
        [int(iters), int(complete)],
    ]).astype(np.int32)


def _model_ops(name):
    """(operands on the CPU, the full search's step cap) of a model case:
    SyncBB's searches of the random problems, NCBB's seeded one, the sum
    order cases (K = 1, K = 39), and raw operands of mixed domain sizes
    (``bb_operands``), one with tied costs."""
    if name in ("rand6", "rand8", "rand7_unary"):
        port = port_of(_random(*PROBLEMS[name][0]))
        return _branch_bound._operands(
            port, np.arange(port.n_vars), None, torch.device("cpu")
        ), 10 ** 6
    if name == "rand12_ncbb":
        port = port_of(_random(*PROBLEMS["rand12"][0]))
        tree = _Tree(port)
        return _branch_bound._operands(
            port, np.asarray(tree.topo), ncbb._greedy_init(port, tree),
            torch.device("cpu"),
        ), 10 ** 6
    if name in ("k1", "k39"):
        n = 12 if name == "k1" else 40
        rng = np.random.default_rng(n)
        edges = np.array(
            [(i, i + 1) for i in range(n - 1)] if name == "k1" else
            [(i, j) for i in range(n) for j in range(i + 1, n)],
            dtype=np.int32)
        table = (rng.random((len(edges), 3, 3)) * 10.0 ** rng.integers(
            -3, 4, (len(edges), 1, 1))).astype(np.float32)
        port = port_of(jax_from_edges(n, 3, edges, table))
        return _branch_bound._operands(
            port, np.arange(n), None, torch.device("cpu")
        ), 3_000
    if name == "tree_ncbb":
        return _k1_searches()[name], 3_000
    args, kw = BB_SYNTH[name]
    return bb_operands(*args, **kw), 3_000


MODEL_CASES = ["rand6", "rand8", "rand7_unary", "rand12_ncbb", "k1", "k39",
               "tree_ncbb", "d5", "ties"]


@pytest.mark.parametrize("cap", ["1", "5", "after_descent", "full"])
@pytest.mark.parametrize("name", MODEL_CASES)
def test_row_per_visit_search_takes_jax_steps(name, cap):
    # best, ub's bits, steps and completion: the row-per-visit search's
    # are _bb_loop's and the plain DFS's, under every cap; "after_descent"
    # stops on the step right after the first descent into a position
    # visited before: the step that first reads a recomputed row
    ops, full = _model_ops(name)
    assert ops[2].shape[1] == {"k1": 1, "k39": 39, "tree_ncbb": 1}.get(
        name, ops[2].shape[1])
    if cap == "after_descent":
        _, descents, _ = _row_search(ops, full)
        seen = {0}
        again = [s for s, p in descents if p in seen or seen.add(p)]
        max_iters = again[0] + 1
    else:
        max_iters = full if cap == "full" else int(cap)
    got, _, _ = _row_search(ops, max_iters)
    assert np.array_equal(got, _jax_loop(ops, max_iters))
    assert np.array_equal(got, hk.branch_bound_plain(*ops, max_iters).numpy())


@pytest.mark.parametrize("name", ["rand6", "rand8", "rand7_unary",
                                  "rand12_ncbb", "tree_ncbb", "d5", "ties"])
def test_row_per_visit_search_computes_a_row_a_visit(name):
    # a complete search: one row a visit (the first, then one a descent),
    # and each visit of p takes dsize[p] + 1 steps, so the rows computed
    # by position account for every step
    ops, full = _model_ops(name)
    out, descents, visits = _row_search(ops, full)
    n = ops[0].shape[0]
    assert out[n + 2] == 1
    assert len(descents) == visits.sum() - 1
    assert out[n + 1] == int((visits * (ops[1].numpy() + 1)).sum())


def test_branch_and_bound_raises_on_a_refused_search(monkeypatch):
    # the card's kernel answers misoriented attachments with the seed and
    # steps = -1: the caller raises rather than decode it as a solution
    port = port_of(_random(*PROBLEMS["rand6"][0]))
    n = port.n_vars

    def refused(*ops):
        out = torch.zeros(n + 3, dtype=torch.int32)
        out[n + 1] = -1
        return out

    monkeypatch.setattr(_branch_bound.hopper_kernels, "branch_bound",
                        refused)
    with pytest.raises(RuntimeError, match="refused"):
        _branch_bound.branch_and_bound(port, np.arange(n), device="cpu")


def test_build_attachments_like_jax():
    ref = _random(*PROBLEMS["rand12"][0])
    order = np.random.default_rng(0).permutation(ref.n_vars)
    for got, want in zip(
        _branch_bound._build_attachments(port_of(ref), order),
        jax_bb._build_attachments(ref, order),
    ):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_warm_solve_reuses_its_operands():
    port = port_of(_random(*PROBLEMS["rand6"][0]))
    first = syncbb.solve(port, {}, device="cpu")
    cached = dict(port._device_consts)
    assert syncbb.solve(port, {}, device="cpu") == first
    assert port._device_consts.keys() == cached.keys()


@pytest.mark.parametrize("algo", sorted(SOLVERS))
def test_cli_prints_the_jax_cli_json(algo, tmp_path):
    args = ["solve", "-a", algo, _path("graph_coloring")]
    port = _run([sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
                 "--output", str(tmp_path / "port.json"), *args])
    ref = _run([sys.executable, "-m", "pydcop_tpu", *args],
               env={"JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    assert_same_result(json.loads((tmp_path / "port.json").read_text()),
                       json.loads(ref.stdout), algo)
