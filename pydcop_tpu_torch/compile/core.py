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

``compile_dcop`` lowers an object-level ``DCOP`` with the same numpy calls
in the same order as the JAX package, so both packages solve bit-identical
arrays; array-level problems (``compile/direct.py``) carry no ``DCOP``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..dcop.dcop import DCOP
from ..dcop.objects import Domain
from ..dcop.relations import Constraint
from ..telemetry.metrics import metrics_registry
from ..telemetry.tracing import tracer
from .tabulate import tabulate_constraint

__all__ = [
    "ArityBucket", "CompiledDCOP", "BIG", "compile_dcop", "sort_edges_by_var",
    "table_bytes",
]

# Large finite cost standing in for +inf on padded/invalid entries.  Kept well
# below float32 max so sums of a few of them do not overflow.
BIG = 1e9

# Tabulation guard: a constraint's dense table may hold at most this many
# entries (size-based, not arity-based: a 20-ary constraint over binary
# variables is a 1M-entry table and fine).
MAX_TABLE_ELEMS = 2 ** 20


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
    # the object-level problem, for the exact host cost; None for
    # array-only problems (compile/direct.py)
    dcop: Optional[DCOP] = None

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

    def indices_from_assignment(self, assignment: Dict[str, Any]) -> np.ndarray:
        out = np.zeros(self.n_vars, dtype=np.int32)
        for i, n in enumerate(self.var_names):
            out[i] = self.domains[i].index(assignment[n])
        return out

    def initial_indices(self, default: str = "first") -> np.ndarray:
        """Initial value indices: declared initial_value, else first value."""
        out = np.zeros(self.n_vars, dtype=np.int32)
        if self.dcop is None:  # array-only problems declare no initial values
            return out
        for i, n in enumerate(self.var_names):
            v = self.dcop.variables[n]
            if v.initial_value is not None:
                out[i] = self.domains[i].index(v.initial_value)
        return out

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

    def csr_adjacency(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr, dst) CSR form of the variable adjacency: the
        ``neighbor_pairs`` list grouped by source (it comes back
        lexicographically sorted).  DPOP's pseudo-tree builder reads it."""
        src, dst = self.neighbor_pairs()
        indptr = np.searchsorted(src, np.arange(self.n_vars + 1))
        return indptr, dst


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


def table_bytes(compiled: "CompiledDCOP") -> int:
    """Host bytes held by the compiled cost tensors (bucket tables + the
    unary plane): the number that decides whether a problem fits the
    card's memory."""
    return int(
        sum(b.tables.nbytes for b in compiled.buckets)
        + compiled.unary.nbytes
    )


# the host-compile census: fingerprints of problems already lowered in
# this process, so repeated compiles of an identical DCOP are countable.
# Bounded: a telemetry census, not a result cache.
_seen_fingerprints: set = set()
_MAX_FINGERPRINTS = 4096


def _fingerprint(compiled: "CompiledDCOP") -> Tuple:
    """Cheap shape-level identity of a compiled problem: two compiles of
    one DCOP always collide; distinct problems collide only when they
    agree on every size below."""
    return (
        compiled.n_vars,
        compiled.max_domain,
        compiled.n_edges,
        compiled.n_constraints,
        compiled.objective,
        str(np.dtype(compiled.float_dtype)),
        tuple((b.arity, b.n_constraints) for b in compiled.buckets),
        float(compiled.constant_cost),
    )


def _record_compile_stats(
    compiled: "CompiledDCOP", span, wall_s: float = 0.0
) -> None:
    """Publish the compile's size profile to the telemetry sinks (called
    only when tracing or metrics are on), the JAX package's span
    arguments and ``compile.*`` metrics."""
    tbytes = table_bytes(compiled)
    span.set(
        n_vars=compiled.n_vars,
        n_edges=compiled.n_edges,
        n_constraints=compiled.n_constraints,
        n_buckets=len(compiled.buckets),
        max_domain=compiled.max_domain,
        table_bytes=tbytes,
    )
    reg = metrics_registry
    reg.histogram(
        "compile.host_seconds",
        "host lowering wall (DCOP/arrays -> padded tensors)",
    ).observe(wall_s)
    fp = _fingerprint(compiled)
    if fp in _seen_fingerprints:
        reg.counter(
            "compile.host_repeat_compiles",
            "host lowerings of a problem already compiled this process",
        ).inc()
    elif len(_seen_fingerprints) < _MAX_FINGERPRINTS:
        _seen_fingerprints.add(fp)
    reg.counter("compile.runs", "compile_dcop invocations").inc()
    reg.gauge("compile.n_vars", "variables in the last compile").set(
        compiled.n_vars
    )
    reg.gauge("compile.n_edges", "factor-graph edges in the last compile").set(
        compiled.n_edges
    )
    reg.gauge(
        "compile.buckets", "arity buckets in the last compile"
    ).set(len(compiled.buckets))
    reg.gauge(
        "compile.table_bytes",
        "bytes of cost tables + unary plane in the last compile",
    ).set(tbytes)


def compile_dcop(
    dcop: DCOP,
    float_dtype=np.float32,
    big: float = BIG,
) -> CompiledDCOP:
    """Lower a DCOP to the padded-tensor representation.  Publishes the
    ``compile.compile_dcop`` span and the ``compile.*`` census while the
    tracer or the metrics registry is on."""
    with tracer.span("compile.compile_dcop", cat="compile") as sp:
        t0 = time.perf_counter()
        compiled = _compile_dcop(dcop, float_dtype, big)
        if tracer.enabled or metrics_registry.enabled:
            _record_compile_stats(compiled, sp, time.perf_counter() - t0)
    return compiled


def _compile_dcop(
    dcop: DCOP,
    float_dtype=np.float32,
    big: float = BIG,
) -> CompiledDCOP:
    var_names = sorted(dcop.variables)
    var_index = {n: i for i, n in enumerate(var_names)}
    domains = [dcop.variables[n].domain for n in var_names]
    n_vars = len(var_names)
    if n_vars == 0:
        raise ValueError("cannot compile a DCOP with no variables")
    max_domain = max(len(d) for d in domains)
    sign = 1.0 if dcop.objective == "min" else -1.0

    domain_size = np.array([len(d) for d in domains], dtype=np.int32)
    valid_mask = (
        np.arange(max_domain)[None, :] < domain_size[:, None]
    )

    # unary: variable costs + arity-1 constraints folded in
    unary = np.zeros((n_vars, max_domain), dtype=np.float64)
    for i, n in enumerate(var_names):
        v = dcop.variables[n]
        if v.has_cost:
            unary[i, : domain_size[i]] = sign * np.asarray(v.cost_vector())

    constant_cost = 0.0
    by_arity: Dict[int, List[Tuple[int, str, Constraint]]] = {}
    con_names: List[str] = []
    external_values = {
        n: ev.value for n, ev in dcop.external_variables.items()
    }
    with tracer.span("compile.scan_constraints", cat="compile"):
        for cid, (cname, c) in enumerate(sorted(dcop.constraints.items())):
            con_names.append(cname)
            # fix external variables at their current value
            ext_in_scope = [
                v.name for v in c.dimensions if v.name in external_values
            ]
            if ext_in_scope:
                c = c.slice({n: external_values[n] for n in ext_in_scope})
            if c.arity == 0:
                constant_cost += sign * c.get_value_for_assignment({})
            elif c.arity == 1:
                vi = var_index[c.dimensions[0].name]
                table = _clamp(sign * tabulate_constraint(c), big)
                unary[vi, : len(table)] += table
            else:
                if max_domain ** c.arity > MAX_TABLE_ELEMS:
                    raise NotImplementedError(
                        f"constraint {cname} (arity {c.arity}) would need a "
                        f"{max_domain}^{c.arity}-entry dense table "
                        f"(> {MAX_TABLE_ELEMS})"
                    )
                by_arity.setdefault(c.arity, []).append((cid, cname, c))

    unary[~valid_mask] = big

    # build buckets + global edge list
    buckets: List[ArityBucket] = []
    edge_var: List[int] = []
    edge_con: List[int] = []
    next_edge = 0
    with tracer.span("compile.build_buckets", cat="compile"):
        for arity in sorted(by_arity):
            entries = by_arity[arity]
            n_c = len(entries)
            tables = np.full(
                (n_c,) + (max_domain,) * arity, big, dtype=np.float64
            )
            var_slots = np.zeros((n_c, arity), dtype=np.int32)
            edge_ids = np.zeros((n_c, arity), dtype=np.int32)
            con_ids = np.zeros(n_c, dtype=np.int32)
            names = []
            for k, (cid, cname, c) in enumerate(entries):
                table = _clamp(sign * tabulate_constraint(c), big)
                idx = tuple(slice(0, s) for s in table.shape)
                tables[(k,) + idx] = table
                for s, v in enumerate(c.dimensions):
                    vi = var_index[v.name]
                    var_slots[k, s] = vi
                    edge_ids[k, s] = next_edge
                    edge_var.append(vi)
                    edge_con.append(cid)
                    next_edge += 1
                con_ids[k] = cid
                names.append(cname)
            buckets.append(
                ArityBucket(
                    arity=arity,
                    tables=tables.astype(float_dtype),
                    var_slots=var_slots,
                    edge_ids=edge_ids,
                    con_ids=con_ids,
                    names=names,
                )
            )

    with tracer.span("compile.sort_edges", cat="compile"):
        edge_var_arr = np.asarray(edge_var, dtype=np.int32)
        edge_con_arr = np.asarray(edge_con, dtype=np.int32)
        edge_var_arr, edge_con_arr = sort_edges_by_var(
            edge_var_arr, edge_con_arr, buckets
        )
    var_degree = np.zeros(n_vars, dtype=np.int32)
    np.add.at(var_degree, edge_var_arr, 1)

    return CompiledDCOP(
        dcop=dcop,
        objective=dcop.objective,
        var_names=var_names,
        var_index=var_index,
        domains=domains,
        n_vars=n_vars,
        max_domain=max_domain,
        domain_size=domain_size,
        valid_mask=valid_mask,
        unary=unary.astype(float_dtype),
        constant_cost=float(constant_cost),
        buckets=buckets,
        n_edges=next_edge,
        edge_var=edge_var_arr,
        edge_con=edge_con_arr,
        var_degree=var_degree,
        con_names=con_names,
        float_dtype=float_dtype,
    )
