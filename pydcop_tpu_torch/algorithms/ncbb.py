"""NCBB: no-commitment branch and bound on a DFS pseudo-tree.

Counterpart of ``pydcop_tpu/algorithms/ncbb.py``: complete search on a
pseudo-tree, unary and binary constraints only, in two phases.  The
initialization phase walks the tree top-down on the host, each variable
greedily taking the value of least cost against its assigned ancestors;
the search phase is the DFS of ``_branch_bound.py`` (one kernel launch on
the card) over the pseudo-tree's DFS order, its upper bound seeded with
the greedy assignment.  ``cycle`` counts DFS steps, ``msg_count`` and
``msg_size`` three a step (VALUE, COST and SEARCH in the reference
protocol).  A search stopped by ``max_iters`` reports ``TIMEOUT``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..compile.core import CompiledDCOP
from ..compile.kernels import resolve_device
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from ._branch_bound import branch_and_bound, check_binary_only
from .base import finalize
from .dpop import _Tree

GRAPH_TYPE = "pseudotree"

algo_params: List[AlgoParameterDef] = [
    AlgoParameterDef("max_iters", "int", None, 0),
]


def _greedy_init(compiled: CompiledDCOP, tree: _Tree) -> np.ndarray:
    """The initialization phase: walking the tree top-down, every variable
    picks the value minimizing its unary cost plus the cost of its
    constraints whose other variables are already assigned."""
    n = compiled.n_vars
    touching: List[List[Any]] = [[] for _ in range(n)]
    for b in compiled.buckets:
        for row in range(b.n_constraints):
            for own, v in enumerate(b.var_slots[row]):
                touching[int(v)].append((b, row, own))

    values = np.zeros(n, dtype=np.int32)
    assigned = np.zeros(n, dtype=bool)
    for i in tree.topo:  # DFS order: ancestors before descendants
        cand = compiled.unary[i].astype(np.float64).copy()
        for b, row, own in touching[i]:
            slots = b.var_slots[row]
            others = [(s, int(v)) for s, v in enumerate(slots) if s != own]
            if not all(assigned[v] for _, v in others):
                continue
            idx: List[Any] = [slice(None)] * b.arity
            for s, v in others:
                idx[s] = int(values[v])
            cand += np.moveaxis(b.tables[row], own, 0)[
                (slice(None),)
                + tuple(idx[s] for s in range(b.arity) if s != own)
            ]
        cand[~compiled.valid_mask[i]] = np.inf
        values[i] = int(np.argmin(cand))
        assigned[i] = True
    return values


def solve(
    compiled: CompiledDCOP,
    params: Optional[Dict[str, Any]] = None,
    n_cycles: int = 1,
    seed: int = 0,
    collect_curve: bool = False,
    device="cuda",
) -> SolveResult:
    """Solve ``compiled`` exactly with NCBB on ``device`` (the card unless
    the caller asks for the CPU)."""
    params = prepare_algo_params(params or {}, algo_params)
    check_binary_only(compiled, "ncbb")
    device = resolve_device(device)
    tree = _Tree(compiled)
    values, iters, complete = branch_and_bound(
        compiled, np.asarray(tree.topo),  # DFS order, root first
        max_iters=params["max_iters"],
        initial=_greedy_init(compiled, tree), device=device,
    )
    result = finalize(
        compiled, values, cycles=iters, msg_count=3 * iters,
        msg_size=3 * iters,
    )
    if not complete:
        result = result._replace(status="TIMEOUT")
    return result


# the footprint models the agent runtime's distributions read (the JAX
# package's, host only)


def computation_memory(node) -> float:
    """NCBB is polynomial-space: each computation stores one bound and one
    value per neighbor."""
    return float(len(node.links) + 1)


def communication_load(node, target: str) -> float:
    """VALUE/COST/SEARCH messages are scalars."""
    return 1.0
