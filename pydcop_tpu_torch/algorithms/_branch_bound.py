"""The depth-first branch and bound shared by the complete search solvers.

Counterpart of ``pydcop_tpu/algorithms/_branch_bound.py``; backs
``syncbb`` and ``ncbb``.  The search keeps the reference protocols'
semantics (the same variable and value order, the same optimum) and runs
the whole DFS on the device: on the card as one launch of the
``branch_bound`` kernel, on the CPU as its plain PyTorch step, advanced
256 steps between looks at the depth.  Extending the path by one
assignment reads binary cost tables oriented ahead of time towards the
later variable of their scope.  Unary and binary constraints only, like
the reference; the callers reject higher arities.  The capture census
(``telemetry/profiling.py``) counts a search's operand build, the first
search of an order and seed on a problem, as a ``bb.search`` compile,
and each later search of the same key as a hit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compile import hopper_kernels
from ..compile.core import CompiledDCOP
from .base import _tensor_bytes, cached_runner

__all__ = ["branch_and_bound", "check_binary_only"]

# the cap on DFS steps when the caller sets none: complete search is a
# correctness feature here, not a throughput one
DEFAULT_MAX_ITERS = 5_000_000


def check_binary_only(compiled: CompiledDCOP, algo: str) -> None:
    for b in compiled.buckets:
        if b.arity > 2:
            raise ValueError(
                f"{algo} only supports unary and binary constraints "
                f"(like the reference implementation); found arity "
                f"{b.arity} constraint {b.names[0]!r}"
            )


def _build_attachments(
    compiled: CompiledDCOP, order: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Orient every binary constraint towards the *later* variable of its
    scope in ``order`` (the position that can evaluate it first).

    Returns per-position padded arrays:
      att_table [n, K, D, D]  (axis 1 = earlier var's value, axis 2 = own)
      att_other [n, K]        position of the earlier variable
      att_mask  [n, K]        validity
      att_min   [n]           sum of min table entries attached at position
    """
    n = compiled.n_vars
    d = compiled.max_domain
    pos = np.empty(n, dtype=np.int64)
    pos[np.asarray(order)] = np.arange(n)

    per_pos: List[List[Tuple[int, np.ndarray]]] = [[] for _ in range(n)]
    for b in compiled.buckets:
        if b.arity != 2:
            continue
        for row in range(b.n_constraints):
            i, j = int(b.var_slots[row, 0]), int(b.var_slots[row, 1])
            table = b.tables[row]
            if pos[i] < pos[j]:  # j is later: axes already (other, own)
                per_pos[pos[j]].append((int(pos[i]), table))
            else:
                per_pos[pos[i]].append((int(pos[j]), table.T))

    k = max(1, max((len(p) for p in per_pos), default=1))
    att_table = np.zeros((n, k, d, d), dtype=compiled.float_dtype)
    att_other = np.zeros((n, k), dtype=np.int32)
    att_mask = np.zeros((n, k), dtype=bool)
    att_min = np.zeros(n, dtype=np.float64)
    for p, items in enumerate(per_pos):
        for s, (other, table) in enumerate(items):
            att_table[p, s] = table
            att_other[p, s] = other
            att_mask[p, s] = True
            att_min[p] += float(table.min())
    return att_table, att_other, att_mask, att_min


def _operands(
    compiled: CompiledDCOP, order: np.ndarray,
    initial: Optional[np.ndarray], device: torch.device,
) -> Tuple[torch.Tensor, ...]:
    """The search's operands on ``device``: the oriented tables, the unary
    costs and domain sizes by position, the tail bounds and the seed bound
    and assignment."""
    n = compiled.n_vars
    att_table, att_other, att_mask, att_min = _build_attachments(
        compiled, order
    )
    unary_by_pos = compiled.unary[order].astype(compiled.float_dtype)
    dsize_by_pos = compiled.domain_size[order]
    # admissible tail bound: for every later position, at least the min
    # valid unary cost plus the min entry of each constraint evaluated there
    unary_min = np.where(
        compiled.valid_mask, compiled.unary.astype(np.float64), np.inf
    ).min(axis=1)[order]
    per_pos_min = unary_min + att_min
    lb_suffix = np.zeros(n + 1, dtype=np.float64)
    lb_suffix[:n] = per_pos_min[::-1].cumsum()[::-1]

    if initial is not None:
        # the seed's cost in engine form: min-form unary + binary tables,
        # no constant offset (constants shift every branch equally)
        ub0 = float(
            compiled.unary[np.arange(n), initial].astype(np.float64).sum()
        )
        for b in compiled.buckets:
            idx = (np.arange(b.n_constraints),) + tuple(
                initial[b.var_slots[:, s]] for s in range(b.arity)
            )
            ub0 += float(b.tables[idx].astype(np.float64).sum())
        ub0 += 1e-6  # the seed must stay reachable under the strict <
        best0 = initial[order]
    else:
        ub0 = np.inf
        best0 = np.zeros(n, dtype=np.int32)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

    return (
        put(unary_by_pos, np.float32),
        put(dsize_by_pos, np.int32),
        put(att_table, np.float32),
        put(att_other, np.int32),
        put(att_mask, bool),
        put(lb_suffix, np.float32),
        put(ub0, np.float32),
        put(best0, np.int32),
    )


def branch_and_bound(
    compiled: CompiledDCOP,
    order: Sequence[int],
    max_iters: int = 0,
    initial: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[np.ndarray, int, bool]:
    """Exact DFS over variables in ``order`` (positions of compiled
    variable ids) on ``device``.  ``initial``: an optional full assignment
    (value indices by variable id) that seeds the upper bound.

    Returns (values by variable id, DFS steps, completed?)."""
    n = compiled.n_vars
    device = torch.device(device)
    order = np.asarray(order, dtype=np.int64)
    if initial is not None:
        initial = np.asarray(initial, dtype=np.int32)
    # every operand derives from the order and the seed: a warm solve
    # builds and uploads nothing
    operands = cached_runner(
        compiled,
        (
            "bb_operands", order.tobytes(),
            None if initial is None else initial.tobytes(), str(device),
        ),
        "bb.search", lambda: _operands(compiled, order, initial, device),
        device, _tensor_bytes,
    )
    packed = hopper_kernels.branch_bound(
        *operands, int(max_iters) or DEFAULT_MAX_ITERS
    ).cpu().numpy()
    if packed[n + 1] < 0:
        raise RuntimeError(
            "branch_bound refused the operands: an attachment does not name "
            "an earlier position"
        )
    values = np.zeros(n, dtype=np.int32)
    values[order] = packed[:n]
    return values, int(packed[n + 1]), bool(packed[n + 2])
