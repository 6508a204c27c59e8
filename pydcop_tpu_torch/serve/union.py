"""Fleet fusion: K tenant problems as ONE block-diagonal union solve.

Counterpart of ``pydcop_tpu/serve/union.py``.  The K compiled problems
are concatenated into one disjoint-union ``CompiledDCOP`` (variables,
edges, constraints and tables block-shifted) that solves through the
ordinary engine: every kernel runs unbatched at K times the size.  The
union is a legitimate instance of the same algorithm: each tenant's block
evolves under its own local costs with per-variable randomness of the
same distribution as alone, but from one fleet seed (``fleet_seed``), so
its trajectory is not its solo one; tenants that need their own seed's
bits use the vmap mode.  Each tenant's result is its block of the
union's values, costed on the host by its own compiled problem.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np

from ..compile.core import ArityBucket, CompiledDCOP

__all__ = ["union_compiled", "fleet_seed"]


def fleet_seed(seeds: List[int]) -> int:
    """One deterministic fleet seed from the tenants' seeds (crc32 of the
    ordered list: stable across processes, unlike ``hash``)."""
    return zlib.crc32(
        ",".join(str(int(s)) for s in seeds).encode()
    ) & 0x7FFFFFFF


def union_compiled(
    parts: List[CompiledDCOP],
) -> Tuple[CompiledDCOP, List[Tuple[int, int]]]:
    """The disjoint union of K compiled problems, and each tenant's
    ``(lo, hi)`` variable block.  The parts must share max_domain, float
    dtype and objective; every index array is shifted by its block's
    offsets, so the union is the compiled form of the disjoint graph
    union (its edges stay sorted by variable, since block i's variable
    ids all precede block i+1's)."""
    if not parts:
        raise ValueError("union of zero problems")
    d0 = parts[0]
    for c in parts[1:]:
        if (
            c.max_domain != d0.max_domain
            or np.dtype(c.float_dtype) != np.dtype(d0.float_dtype)
            or c.objective != d0.objective
        ):
            raise ValueError(
                "fleet fusion needs equal max_domain/dtype/objective "
                "across tenants"
            )
    blocks: List[Tuple[int, int]] = []
    v_off = e_off = c_off = 0
    var_names: List[str] = []
    domains = []
    con_names: List[str] = []
    by_arity: Dict[int, Dict[str, list]] = {}
    dsz, vmask, unary, evar, econ, vdeg = [], [], [], [], [], []
    constant = 0.0
    for i, c in enumerate(parts):
        blocks.append((v_off, v_off + c.n_vars))
        var_names.extend(f"u{i}.{n}" for n in c.var_names)
        domains.extend(c.domains)
        con_names.extend(f"u{i}.{n}" for n in c.con_names)
        dsz.append(np.asarray(c.domain_size))
        vmask.append(np.asarray(c.valid_mask))
        unary.append(np.asarray(c.unary, dtype=d0.float_dtype))
        vdeg.append(np.asarray(c.var_degree))
        if c.n_edges:
            evar.append(np.asarray(c.edge_var) + v_off)
            econ.append(np.asarray(c.edge_con) + c_off)
        for b in c.buckets:
            acc = by_arity.setdefault(
                b.arity,
                {"tables": [], "var_slots": [], "edge_ids": [],
                 "con_ids": []},
            )
            acc["tables"].append(np.asarray(b.tables, dtype=d0.float_dtype))
            acc["var_slots"].append(np.asarray(b.var_slots) + v_off)
            acc["edge_ids"].append(np.asarray(b.edge_ids) + e_off)
            acc["con_ids"].append(np.asarray(b.con_ids) + c_off)
        constant += float(c.constant_cost)
        v_off += c.n_vars
        e_off += c.n_edges
        c_off += c.n_constraints
    buckets = [
        ArityBucket(
            arity=a,
            tables=np.concatenate(acc["tables"]),
            var_slots=np.concatenate(acc["var_slots"]).astype(np.int32),
            edge_ids=np.concatenate(acc["edge_ids"]).astype(np.int32),
            con_ids=np.concatenate(acc["con_ids"]).astype(np.int32),
        )
        for a, acc in sorted(by_arity.items())
    ]
    union = CompiledDCOP(
        objective=d0.objective,
        var_names=var_names,
        var_index={n: i for i, n in enumerate(var_names)},
        domains=domains,
        n_vars=v_off,
        max_domain=d0.max_domain,
        domain_size=np.concatenate(dsz).astype(np.int32),
        valid_mask=np.concatenate(vmask),
        unary=np.concatenate(unary),
        constant_cost=constant,
        buckets=buckets,
        n_edges=e_off,
        edge_var=(
            np.concatenate(evar).astype(np.int32)
            if evar else np.zeros(0, dtype=np.int32)
        ),
        edge_con=(
            np.concatenate(econ).astype(np.int32)
            if econ else np.zeros(0, dtype=np.int32)
        ),
        var_degree=np.concatenate(vdeg).astype(np.int32),
        con_names=con_names,
        float_dtype=d0.float_dtype,
        dcop=None,
    )
    return union, blocks
