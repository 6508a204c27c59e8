"""SyncBB: synchronous branch and bound over an ordered variable chain.

Counterpart of ``pydcop_tpu/algorithms/syncbb.py``: complete search in the
lexical variable order and the domain's value order, unary and binary
constraints only, no parameter of the reference (``max_iters`` caps the
search; 0 is the engine's default cap).  The reference passes a Current
Partial Assignment token from agent to agent; here the whole search is
the DFS of ``_branch_bound.py``, one kernel launch on the card.

``msg_count`` counts DFS steps (each is one move of the reference's CPA
token: extension, retry or backtrack), ``msg_size`` adds the path length
per move, and ``cycle`` is 0, as the reference reports.  A search stopped
by the cap reports ``TIMEOUT``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..compile.core import CompiledDCOP
from ..compile.kernels import resolve_device
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from ._branch_bound import branch_and_bound, check_binary_only
from .base import finalize

GRAPH_TYPE = "ordered_graph"

algo_params: List[AlgoParameterDef] = [
    AlgoParameterDef("max_iters", "int", None, 0),
]


def solve(
    compiled: CompiledDCOP,
    params: Optional[Dict[str, Any]] = None,
    n_cycles: int = 1,
    seed: int = 0,
    collect_curve: bool = False,
    device="cuda",
) -> SolveResult:
    """Solve ``compiled`` exactly with SyncBB on ``device`` (the card
    unless the caller asks for the CPU)."""
    params = prepare_algo_params(params or {}, algo_params)
    check_binary_only(compiled, "syncbb")
    device = resolve_device(device)
    # lexical order == compiled variable order (compile_dcop sorts names)
    values, iters, complete = branch_and_bound(
        compiled, np.arange(compiled.n_vars),
        max_iters=params["max_iters"], device=device,
    )
    result = finalize(
        compiled, values, cycles=0, msg_count=iters,
        msg_size=iters * compiled.n_vars,
    )
    if not complete:
        # the cap stopped the search: the incumbent is not proven optimal
        result = result._replace(status="TIMEOUT")
    return result


# the footprint models the agent runtime's distributions read (the JAX
# package's, host only)


def computation_memory(node) -> float:
    """A SyncBB computation only holds the CPA path: one (var, value, cost)
    triple per variable before it in the chain."""
    return float(node.position + 1)


def communication_load(node, target: str) -> float:
    """CPA token size: the full path in the worst case."""
    return float(node.position + 1)
