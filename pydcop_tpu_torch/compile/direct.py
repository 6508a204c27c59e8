"""Direct array-level construction of a CompiledDCOP.

Counterpart of ``pydcop_tpu/compile/direct.py``: benchmark generators
produce edge lists + shared cost tables as numpy arrays, and this module
lowers them to the ``CompiledDCOP`` representation without building
per-constraint python objects.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..dcop.objects import Domain
from ..telemetry.metrics import metrics_registry
from ..telemetry.tracing import tracer
from .core import (
    ArityBucket,
    CompiledDCOP,
    _clamp,
    _record_compile_stats,
    sort_edges_by_var,
)

__all__ = ["compile_from_edges"]


def compile_from_edges(
    n_vars: int,
    domain_size: int,
    edges: np.ndarray,
    table: np.ndarray,
    unary: Optional[np.ndarray] = None,
    domain_values: Optional[List] = None,
    float_dtype=np.float32,
    objective: str = "min",
) -> CompiledDCOP:
    """Compile a uniform binary-constraint DCOP given as arrays.

    - ``edges [n_c, 2]``: variable-id pairs, one binary constraint each.
    - ``table``: either ``[D, D]`` (shared by all constraints) or
      ``[n_c, D, D]`` (per-constraint).
    - ``unary [n_vars, D]`` optional unary costs.

    Publishes the same ``compile.*`` telemetry as ``compile_dcop`` (size
    profile, host wall, repeat-compile census) when a sink is on.
    """
    with tracer.span("compile.compile_from_edges", cat="compile") as sp:
        t0 = time.perf_counter()
        compiled = _compile_from_edges(
            n_vars, domain_size, edges, table, unary, domain_values,
            float_dtype, objective,
        )
        if tracer.enabled or metrics_registry.enabled:
            _record_compile_stats(compiled, sp, time.perf_counter() - t0)
    return compiled


def _compile_from_edges(
    n_vars: int,
    domain_size: int,
    edges: np.ndarray,
    table: np.ndarray,
    unary: Optional[np.ndarray] = None,
    domain_values: Optional[List] = None,
    float_dtype=np.float32,
    objective: str = "min",
) -> CompiledDCOP:
    edges = np.asarray(edges, dtype=np.int32)
    n_c = edges.shape[0]
    d = domain_size
    table = np.asarray(table, dtype=float_dtype)
    if table.ndim == 2:
        tables = np.broadcast_to(table, (n_c, d, d))
    else:
        tables = table
    if tables.shape != (n_c, d, d):
        raise ValueError(f"bad table shape {table.shape}")

    if domain_values is None:
        domain_values = list(range(d))
    dom = Domain("d", "generated", domain_values)
    domains = [dom] * n_vars

    sign = 1.0 if objective == "min" else -1.0
    un = np.zeros((n_vars, d), dtype=float_dtype)
    if unary is not None:
        un = _clamp(un + sign * np.asarray(unary, dtype=float_dtype), 1e9)
    # min-form + clamp inf/NaN (hard constraints written as float('inf'))
    # to the finite BIG band
    tables = _clamp(sign * tables.astype(np.float64), 1e9).astype(float_dtype)

    edge_ids = np.arange(2 * n_c, dtype=np.int32).reshape(n_c, 2)
    edge_var = edges.reshape(-1).astype(np.int32)
    edge_con = np.repeat(np.arange(n_c, dtype=np.int32), 2)

    bucket = ArityBucket(
        arity=2,
        tables=np.ascontiguousarray(tables, dtype=float_dtype),
        var_slots=edges,
        edge_ids=edge_ids,
        con_ids=np.arange(n_c, dtype=np.int32),
        names=[f"c{i}" for i in range(n_c)],
    )
    edge_var, edge_con = sort_edges_by_var(edge_var, edge_con, [bucket])
    var_degree = np.zeros(n_vars, dtype=np.int32)
    np.add.at(var_degree, edge_var, 1)
    return CompiledDCOP(
        objective=objective,
        var_names=[f"v{i}" for i in range(n_vars)],
        var_index={f"v{i}": i for i in range(n_vars)},
        domains=domains,
        n_vars=n_vars,
        max_domain=d,
        domain_size=np.full(n_vars, d, dtype=np.int32),
        valid_mask=np.ones((n_vars, d), dtype=bool),
        unary=un,
        constant_cost=0.0,
        buckets=[bucket],
        n_edges=2 * n_c,
        edge_var=edge_var,
        edge_con=edge_con,
        var_degree=var_degree,
        con_names=list(bucket.names),
        float_dtype=float_dtype,
    )
