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
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_api import _path, assert_same_result
from test_torch_cli import _run
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
