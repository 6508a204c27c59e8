"""Placement-aware layout: graph partitioning as array reordering.

The port's copy of ``pydcop_tpu/parallel/placement.py``, the same numpy
calls in the same order.  The reference's distribution layer places
computations so that inter-agent communication is minimized (message
load x route cost over graph edges); on a set of row-block shards the
analogous objective is locality: WHICH rows sit together is decided by
the numbering the compiler produced.

This module renumbers host-side so shard boundaries follow graph
structure:

- ``bfs_order``: breadth-first order over the variable adjacency
  (variables sharing a constraint), restarted per connected component
  from a max-degree seed.  Contiguous blocks of this order are BFS
  layers: neighborhoods stay together, and on banded graphs (grids,
  meshes) cross-block edges shrink to the band boundary.
- ``reorder_compiled``: rebuilds a CompiledDCOP under a variable
  permutation: variable rows permuted, bucket constraint rows re-sorted
  to follow their (new) lowest variable, the global edge list
  regenerated and re-sorted var-major.  Assignments decode identically
  (names travel with the rows).
- ``partition_compiled``: the placement-aware layout, dispatching
  between the multilevel partitioner (``partition.partition_order``) and
  the BFS order.
- ``cross_shard_edges`` / ``cross_shard_incidence``: the locality
  diagnostics under equal row blocks.

The sharded solve these layouts feed is not ported; the port uses them
for the analytic cross-shard model of ``partition.icimodel`` and the
``partition`` blocks of the capture records.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..compile.core import ArityBucket, CompiledDCOP, sort_edges_by_var

__all__ = [
    "bfs_order",
    "reorder_compiled",
    "partition_compiled",
    "cross_shard_edges",
    "cross_shard_incidence",
]


def bfs_order(compiled: CompiledDCOP) -> np.ndarray:
    """[n_vars] permutation (new position -> old variable id) in BFS order
    over the variable adjacency, one component at a time, each seeded at its
    highest-degree variable (hubs first keeps their neighborhoods in the
    same block)."""
    n = compiled.n_vars
    indptr, dst = compiled.csr_adjacency()
    degree = np.diff(indptr)
    # stable ordering of seeds: by descending degree, then id
    seed_order = np.lexsort((np.arange(n), -degree))
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    seed_ptr = 0
    while pos < n:
        while seed_ptr < n and visited[seed_order[seed_ptr]]:
            seed_ptr += 1
        frontier = np.array([seed_order[seed_ptr]], dtype=np.int64)
        visited[frontier[0]] = True
        while frontier.size:
            order[pos : pos + frontier.size] = frontier
            pos += frontier.size
            # all neighbors of the frontier, vectorized per layer
            spans = [
                dst[indptr[v] : indptr[v + 1]] for v in frontier.tolist()
            ]
            neigh = (
                np.unique(np.concatenate(spans)) if spans else
                np.empty(0, dtype=np.int64)
            )
            frontier = neigh[~visited[neigh]]
            visited[frontier] = True
    return order


def reorder_compiled(
    compiled: CompiledDCOP, var_perm: np.ndarray
) -> CompiledDCOP:
    """A new CompiledDCOP with variables renumbered by ``var_perm`` (new
    position -> old id).  Semantically identical: same constraints, same
    names, same costs; only row order (and hence shard assignment under
    row-block sharding) changes."""
    var_perm = np.asarray(var_perm, dtype=np.int64)
    n = compiled.n_vars
    if var_perm.shape != (n,) or not np.array_equal(
        np.sort(var_perm), np.arange(n)
    ):
        raise ValueError("var_perm must be a permutation of range(n_vars)")
    inv = np.empty(n, dtype=np.int64)
    inv[var_perm] = np.arange(n)

    var_names = [compiled.var_names[o] for o in var_perm]
    domains = [compiled.domains[o] for o in var_perm]

    # rebuild buckets: slots renumbered, constraint rows re-sorted so each
    # follows its lowest (new) variable — table rows shard with their data
    buckets = []
    edge_var_parts = []
    edge_con_parts = []
    next_edge = 0
    for b in compiled.buckets:
        var_slots = inv[b.var_slots]  # [n_c, a] new variable ids
        row_order = np.argsort(var_slots.min(axis=1), kind="stable")
        var_slots = var_slots[row_order]
        n_c, a = var_slots.shape
        edge_ids = (
            next_edge + np.arange(n_c * a, dtype=np.int32).reshape(n_c, a)
        )
        next_edge += n_c * a
        con_ids = b.con_ids[row_order]
        edge_var_parts.append(var_slots.reshape(-1))
        edge_con_parts.append(np.repeat(con_ids, a))
        buckets.append(
            ArityBucket(
                arity=b.arity,
                tables=b.tables[row_order],
                var_slots=var_slots.astype(np.int32),
                edge_ids=edge_ids,
                con_ids=con_ids,
                names=[b.names[i] for i in row_order] if b.names else [],
            )
        )
    if edge_var_parts:
        edge_var = np.concatenate(edge_var_parts).astype(np.int32)
        edge_con = np.concatenate(edge_con_parts).astype(np.int32)
    else:
        edge_var = np.zeros(0, dtype=np.int32)
        edge_con = np.zeros(0, dtype=np.int32)
    edge_var, edge_con = sort_edges_by_var(edge_var, edge_con, buckets)
    var_degree = np.zeros(n, dtype=np.int32)
    np.add.at(var_degree, edge_var, 1)

    return CompiledDCOP(
        dcop=compiled.dcop,
        objective=compiled.objective,
        var_names=var_names,
        var_index={na: i for i, na in enumerate(var_names)},
        domains=domains,
        n_vars=n,
        max_domain=compiled.max_domain,
        domain_size=compiled.domain_size[var_perm],
        valid_mask=compiled.valid_mask[var_perm],
        unary=compiled.unary[var_perm],
        constant_cost=compiled.constant_cost,
        buckets=buckets,
        n_edges=next_edge,
        edge_var=edge_var,
        edge_con=edge_con,
        var_degree=var_degree,
        con_names=compiled.con_names,
        float_dtype=compiled.float_dtype,
    )


def partition_compiled(
    compiled: CompiledDCOP,
    strategy: str = "auto",
    n_shards: Optional[int] = None,
) -> CompiledDCOP:
    """Placement-aware layout: renumber variables so contiguous row-block
    shards follow graph structure (the device analog of the reference's
    communication-minimizing distribution).

    - ``strategy="multilevel"`` — the multilevel partitioner
      (``partition.partition_order``): k-way partition whose parts ARE
      the padded DeviceDCOP's row chunks, laid out as contiguous
      blocks.  Needs ``n_shards >= 2``.
    - ``strategy="bfs"`` — the linear-time breadth-first order (the
      original layout, kept as the fallback and the property-test
      baseline); shard-count agnostic.
    - ``strategy="auto"`` — multilevel when ``n_shards >= 2`` and the
      problem has edges, else BFS.

    A multilevel result is stamped with ``_partition_meta`` so
    downstream layout passes (maxsum's ``ordering="auto"``) know the
    contiguous chunks already follow the partition and skip recomputing
    it."""
    if strategy not in ("auto", "bfs", "multilevel"):
        raise ValueError(f"unknown partition strategy {strategy!r}")
    if strategy == "auto":
        strategy = (
            "multilevel"
            if (n_shards or 0) > 1 and compiled.n_edges > 0
            else "bfs"
        )
    if strategy == "bfs":
        return reorder_compiled(compiled, bfs_order(compiled))
    if not n_shards or n_shards < 2:
        raise ValueError(
            "strategy='multilevel' partitions for a shard count: pass "
            f"n_shards >= 2 (got {n_shards!r})"
        )
    from ..partition import partition_order

    order, _assign, info = partition_order(compiled, n_shards)
    out = reorder_compiled(compiled, order)
    try:
        object.__setattr__(
            out,
            "_partition_meta",
            {
                "strategy": "multilevel",
                "n_shards": int(n_shards),
                "incidence": info["incidence"],
                "order_wall_s": info["order_wall_s"],
            },
        )
    except (AttributeError, TypeError):  # pragma: no cover
        pass
    return out


def cross_shard_edges(compiled: CompiledDCOP, n_shards: int) -> int:
    """How many message rows live on a different shard than their variable
    row or their constraint row, under equal contiguous row-blocks (the
    layout ``shard_device_dcop`` produces).  Lower = less inter-device
    traffic per cycle."""

    def shard_of(idx: np.ndarray, size: int) -> np.ndarray:
        return (idx.astype(np.int64) * n_shards) // max(size, 1)

    edge_ids = np.arange(compiled.n_edges)
    e_shard = shard_of(edge_ids, compiled.n_edges)
    v_shard = shard_of(compiled.edge_var, compiled.n_vars)
    crossings = int((e_shard != v_shard).sum())
    for b in compiled.buckets:
        rows = np.arange(b.n_constraints)
        c_shard = shard_of(rows, b.n_constraints)
        msg_shard = shard_of(b.edge_ids, compiled.n_edges)
        crossings += int((msg_shard != c_shard[:, None]).sum())
    return crossings


def cross_shard_incidence(compiled: CompiledDCOP, n_shards: int) -> float:
    """Fraction of binary-constraint incidences (edge slots) whose partner
    variable lives on a different shard, under the equal contiguous
    variable row-blocks both ``shard_device_dcop`` and the mesh-composable
    ELL layout use.

    This IS the cross-shard fraction of the ELL pair-permutation gather —
    a slot lives with its own variable's shard, its partner slot with the
    partner variable's — so it predicts the per-cycle ICI traffic of a
    sharded ELL solve directly from the graph (cross-validated against
    ``compile.kernels.ell_cross_shard_frac`` on the built layout).  BFS
    placement (``partition_compiled``) exists to drive it down."""
    if compiled.n_edges == 0 or n_shards <= 1:
        return 0.0
    # the PADDED DeviceDCOP's row chunk (pad_device_dcop reserves a dead
    # row, so the axis pads to ceil_to(n_vars + 1, mesh)) — the same
    # default blocking build_ell uses, so this predicts the layout's
    # measured ell_cross_shard_frac exactly
    chunk = (compiled.n_vars + n_shards) // n_shards
    src, dst = compiled.neighbor_pairs()
    if len(src) == 0:
        return 0.0
    s = np.minimum(src // chunk, n_shards - 1)
    d = np.minimum(dst // chunk, n_shards - 1)
    return float((s != d).mean())
