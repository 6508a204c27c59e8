"""The "compiled DCOP": padded cost tensors + gather index arrays.

Counterpart of ``pydcop_tpu/compile/core.py``; host-side and numpy only.
A DCOP is lowered once into dense index arrays, and a solver cycle is then
a few device passes over them:

- domains padded to ``max_domain`` (D); ``domain_size[n_vars]`` + a
  validity mask; invalid table/unary entries hold ``BIG`` (a large finite
  cost, not +inf, so ``a - b`` stays NaN-free in message updates).
- constraints bucketed by arity ``a``; each bucket holds cost tables
  ``[n_c, D, ..., D]``, the variable id of every slot ``var_slots [n_c, a]``
  and the edge id of every slot ``edge_ids [n_c, a]``.
- a global edge list (one edge per (constraint, slot) pair, i.e. one
  factor-graph edge): ``edge_var[n_edges]`` maps edge -> variable, sorted.
- unary variable costs are folded into ``unary [n_vars, D]``.
- ``objective='max'`` problems are negated at compile time (solvers always
  minimize) and un-negated in reported costs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..dcop.objects import Domain

__all__ = ["ArityBucket", "CompiledDCOP", "BIG", "sort_edges_by_var"]

# Large finite cost standing in for +inf on padded/invalid entries.  Kept well
# below float32 max so sums of a few of them do not overflow.
BIG = 1e9


@dataclass
class ArityBucket:
    """All constraints of one arity, stacked."""

    arity: int
    tables: np.ndarray  # [n_c] + [D]*arity
    var_slots: np.ndarray  # [n_c, arity] global variable ids
    edge_ids: np.ndarray  # [n_c, arity] global edge ids
    con_ids: np.ndarray  # [n_c] global constraint ids
    names: List[str] = field(default_factory=list)

    @property
    def n_constraints(self) -> int:
        return self.tables.shape[0]


@dataclass
class CompiledDCOP:
    """Host-side product of a compile: every array is numpy; solvers move
    them to a torch device as needed (``compile.kernels.to_device``)."""

    objective: str  # 'min' or 'max' (original; arrays are always min-form)
    var_names: List[str]
    var_index: Dict[str, int]
    domains: List[Domain]
    n_vars: int
    max_domain: int
    domain_size: np.ndarray  # [n_vars] int32
    valid_mask: np.ndarray  # [n_vars, D] bool
    unary: np.ndarray  # [n_vars, D] float, BIG on invalid slots
    constant_cost: float  # sum of arity-0 constraints
    buckets: List[ArityBucket]
    n_edges: int
    edge_var: np.ndarray  # [n_edges] int32, sorted
    edge_con: np.ndarray  # [n_edges] int32 (global constraint id)
    var_degree: np.ndarray  # [n_vars] int32: number of edges per variable
    con_names: List[str]  # global constraint id -> name
    float_dtype: Any = np.float32

    def assignment_from_indices(self, idx: np.ndarray) -> Dict[str, Any]:
        # .tolist() once + plain list indexing: far faster than per-element
        # numpy scalar conversion at 100k variables
        idx_list = np.asarray(idx).tolist()
        values = getattr(self, "_domain_values", None)
        if values is None:
            values = [d.values for d in self.domains]
            self._domain_values = values
        return {
            n: dv[j]
            for n, dv, j in zip(self.var_names, values, idx_list)
        }

    @property
    def n_constraints(self) -> int:
        return len(self.con_names)

    def host_cost(
        self, values_idx: np.ndarray, infinity: float = 10000
    ) -> Tuple[float, int]:
        """(cost, violations) of a full assignment, computed host-side in
        float64 with numpy gathers.  A constraint at original cost >=
        infinity counts as a violation and its cost is not accumulated."""
        sign = 1.0 if self.objective == "min" else -1.0
        vals = np.asarray(values_idx)[: self.n_vars]
        threshold = min(infinity, BIG)
        # unary entries at/above the violation threshold (folded hard
        # arity-1 constraints) count as violations
        unary_orig = sign * self.unary[np.arange(self.n_vars), vals].astype(
            np.float64
        )
        unary_violated = unary_orig >= threshold
        cost = float(unary_orig[~unary_violated].sum())
        violations = int(unary_violated.sum())
        for b in self.buckets:
            idx = (np.arange(b.n_constraints),) + tuple(
                vals[b.var_slots[:, s]] for s in range(b.arity)
            )
            orig = sign * b.tables[idx].astype(np.float64)
            violated = orig >= threshold
            violations += int(violated.sum())
            cost += float(orig[~violated].sum())
        return cost + sign * self.constant_cost, violations

    # neighbor (variable-variable) directed pair list; built lazily, cached
    _neigh_cache: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def neighbor_pairs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) directed pairs for every pair of distinct variables
        sharing at least one constraint, lexicographically sorted."""
        if self._neigh_cache is not None:
            return self._neigh_cache
        srcs, dsts = [], []
        for b in self.buckets:
            a = b.arity
            ii, jj = np.meshgrid(np.arange(a), np.arange(a), indexing="ij")
            off = (ii != jj).reshape(-1)
            s = b.var_slots[:, ii.reshape(-1)[off]].reshape(-1)
            t = b.var_slots[:, jj.reshape(-1)[off]].reshape(-1)
            keep = s != t  # a variable repeated in one scope is not a pair
            srcs.append(s[keep])
            dsts.append(t[keep])
        if srcs and sum(len(s) for s in srcs):
            pairs = np.unique(
                np.stack(
                    [np.concatenate(srcs), np.concatenate(dsts)], axis=1
                ),
                axis=0,
            )
            src, dst = pairs[:, 0], pairs[:, 1]
        else:
            src = np.zeros(0, dtype=np.int64)
            dst = np.zeros(0, dtype=np.int64)
        self._neigh_cache = (src.astype(np.int32), dst.astype(np.int32))
        return self._neigh_cache


def sort_edges_by_var(
    edge_var: np.ndarray,
    edge_con: np.ndarray,
    buckets: List[ArityBucket],
) -> Tuple[np.ndarray, np.ndarray]:
    """Renumber edge ids so ``edge_var`` is sorted (variable-major order).

    The ELL layout reads each variable's incidences as one contiguous
    range of the sorted edge list.  Bucket ``edge_ids`` are remapped in
    place."""
    perm = np.argsort(edge_var, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    for b in buckets:
        b.edge_ids = inv[b.edge_ids].astype(np.int32)
    return edge_var[perm], edge_con[perm]


def _clamp(table: np.ndarray, big: float) -> np.ndarray:
    """Clamp +/-inf (hard constraints written as float('inf')) and NaN to the
    finite BIG band: the kernels' a - b arithmetic must stay NaN-free."""
    return np.nan_to_num(table, nan=big, posinf=big, neginf=-big)
