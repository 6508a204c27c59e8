"""Ising benchmark problem generator.

Counterpart of ``pydcop_tpu/commands/generators/ising.py``'s array path:
a periodic 2-D grid of binary variables; each edge gets a coupling cost
``J`` drawn from U(-bin_range, bin_range) (``J`` when the two spins
agree, ``-J`` when they differ), each variable a field cost ``h`` from
U(-un_range, un_range) (``h`` for spin 0, ``-h`` for spin 1).  The same
numpy calls in the same order, so one seed gives identical arrays (and
YAML text) in both packages.  ``generate_ising`` builds the object-level
DCOP that the ``generate ising`` verb writes (extensive tables or
intentional expressions, one agent a cell); ``generate_ising_arrays``
lowers the grid straight to the compiled representation.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ...compile.core import CompiledDCOP
from ...compile.direct import compile_from_edges
from ...dcop.dcop import DCOP
from ...dcop.objects import AgentDef, Domain, Variable
from ...dcop.relations import NAryMatrixRelation, constraint_from_str

__all__ = ["generate_ising", "generate_ising_arrays", "grid_edges_periodic"]


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


def generate_ising(
    row_count: int,
    col_count: int,
    bin_range: float = 1.6,
    un_range: float = 0.05,
    extensive: bool = True,
    no_agents: bool = False,
    seed: Optional[int] = None,
) -> DCOP:
    """Object-level Ising DCOP: the JAX package's structure and names."""
    rng = np.random.default_rng(seed)
    domain = Domain("var_domain", "binary", [0, 1])
    dcop = DCOP(
        f"Ising_{row_count}_{col_count}_{bin_range}_{un_range}", "min"
    )

    def vname(r: int, c: int) -> str:
        return f"v_{r}_{c}"

    variables: Dict[str, Variable] = {}
    for r in range(row_count):
        for c in range(col_count):
            v = Variable(vname(r, c), domain)
            variables[v.name] = v
            dcop.add_variable(v)

    # unary field costs
    for v in variables.values():
        h = float(rng.uniform(-un_range, un_range))
        if extensive:
            con = NAryMatrixRelation(
                [v], np.array([h, -h]), name=f"cu_{v.name}"
            )
        else:
            con = constraint_from_str(
                f"cu_{v.name}", f"-{h} if {v.name} == 1 else {h}", [v]
            )
        dcop.add_constraint(con)

    # binary couplings on the periodic grid
    for r in range(row_count):
        for c in range(col_count):
            for r2, c2 in (
                (r, (c + 1) % col_count),
                ((r + 1) % row_count, c),
            ):
                if (r2, c2) == (r, c):
                    continue
                (ra, ca), (rb, cb) = sorted([(r, c), (r2, c2)])
                name = f"cb_{vname(ra, ca)}_{vname(rb, cb)}"
                if name in dcop.constraints:
                    continue
                j = float(rng.uniform(-bin_range, bin_range))
                va, vb = variables[vname(ra, ca)], variables[vname(rb, cb)]
                if extensive:
                    con = NAryMatrixRelation(
                        [va, vb],
                        np.array([[j, -j], [-j, j]]),
                        name=name,
                    )
                else:
                    con = constraint_from_str(
                        name,
                        f"{j} if {va.name} == {vb.name} else -{j}",
                        [va, vb],
                    )
                dcop.add_constraint(con)

    if not no_agents:
        dcop.add_agents(
            [
                AgentDef(f"a_{r}_{c}")
                for r in range(row_count)
                for c in range(col_count)
            ]
        )
    return dcop


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
