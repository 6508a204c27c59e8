"""Ising benchmark problem generator (array level).

Counterpart of ``pydcop_tpu/commands/generators/ising.py``'s array path:
a periodic 2-D grid of binary variables; each edge gets a coupling cost
``J`` drawn from U(-bin_range, bin_range) (``J`` when the two spins
agree, ``-J`` when they differ), each variable a field cost ``h`` from
U(-un_range, un_range) (``h`` for spin 0, ``-h`` for spin 1).  The same
numpy calls in the same order, so one seed gives identical arrays in both
packages.  The object-level (YAML-able) generator is a later slice.
"""

from __future__ import annotations

import numpy as np

from ...compile.core import CompiledDCOP
from ...compile.direct import compile_from_edges

__all__ = ["grid_edges_periodic", "generate_ising_arrays"]


def grid_edges_periodic(rows: int, cols: int) -> np.ndarray:
    """Edge list of the periodic rows x cols grid: each cell connects to its
    right and down neighbor (wrap-around), like nx.grid_2d_graph(periodic)."""
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    idx = (r * cols + c).ravel()
    right = (r * cols + (c + 1) % cols).ravel()
    down = (((r + 1) % rows) * cols + c).ravel()
    edges = np.concatenate(
        [np.stack([idx, right], 1), np.stack([idx, down], 1)]
    )
    # drop self-loops (1-wide/1-tall grids) and duplicate edges (2x2 wrap)
    edges = edges[edges[:, 0] != edges[:, 1]]
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    return edges.astype(np.int32)


def generate_ising_arrays(
    rows: int,
    cols: int,
    bin_range: float = 1.6,
    un_range: float = 0.05,
    seed: int = 0,
) -> CompiledDCOP:
    """Array-level Ising instance, lowered straight to the compiled
    representation."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    edges = grid_edges_periodic(rows, cols)
    j = rng.uniform(-bin_range, bin_range, edges.shape[0])
    tables = np.empty((edges.shape[0], 2, 2), dtype=np.float32)
    tables[:, 0, 0] = j
    tables[:, 1, 1] = j
    tables[:, 0, 1] = -j
    tables[:, 1, 0] = -j
    h = rng.uniform(-un_range, un_range, n)
    unary = np.stack([h, -h], axis=1).astype(np.float32)
    return compile_from_edges(
        n_vars=n, domain_size=2, edges=edges, table=tables, unary=unary
    )
