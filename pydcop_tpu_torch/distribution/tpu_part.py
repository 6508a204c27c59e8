"""tpu_part: agent placement through the multilevel partitioner.

The port's own copy of ``pydcop_tpu/distribution/tpu_part.py`` (the name
is the JAX package's): the multilevel k-way partitioner of
``partition.multilevel`` places *computations on agents*, whose cost
sums message load x route cost over computation-graph edges.  The HA
router lays its affinity buckets on serve workers through it.

The computation graph's node adjacency becomes the partition graph (edge
weights = ``communication_load``, like every cgdp-family method), the
agent count becomes k, and per-agent targets are proportional to agent
capacity — so the contiguous blocks of the partition order become the
per-agent computation sets.  Costing is the shared ``distribution_cost``
of ``distribution._costs``.

Unlike the greedy methods, the partitioner optimizes the GLOBAL cut
rather than placing computations one at a time — on neighborhood-heavy
graphs it produces materially fewer cross-agent edges at equal balance.
DistributionHints are not consulted.  Numpy and the stdlib only: the
host-only ``router`` verb runs it without torch.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from ..computations_graph.objects import ComputationGraph
from ..dcop.objects import AgentDef
from ._costs import distribution_cost as _dist_cost, edge_loads
from .objects import (
    Distribution,
    DistributionHints,
    ImpossibleDistributionException,
)

__all__ = ["distribute", "distribution_cost"]


def _capacity_targets(
    n_nodes: int, capacities: np.ndarray
) -> np.ndarray:
    """Integer per-agent node-count targets proportional to capacity,
    summing exactly to ``n_nodes`` (largest-remainder rounding)."""
    total = float(capacities.sum())
    if total <= 0:
        # all-zero capacities: spread evenly
        capacities = np.ones_like(capacities)
        total = float(capacities.sum())
    exact = capacities * (n_nodes / total)
    base = np.floor(exact).astype(np.int64)
    short = n_nodes - int(base.sum())
    if short > 0:
        order = np.argsort(-(exact - base), kind="stable")
        base[order[:short]] += 1
    return base


def distribute(
    computation_graph: ComputationGraph,
    agentsdef: Iterable[AgentDef],
    hints: Optional[DistributionHints] = None,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
    timeout=None,
) -> Distribution:
    from ..partition.multilevel import multilevel_assign

    agents = sorted(agentsdef, key=lambda a: a.name)
    if not agents:
        raise ImpossibleDistributionException("no agents")
    nodes = sorted(computation_graph.nodes, key=lambda nd: nd.name)
    names = [nd.name for nd in nodes]
    index = {nm: i for i, nm in enumerate(names)}
    n = len(names)
    k = len(agents)
    if n == 0:
        return Distribution({a.name: [] for a in agents})

    # node adjacency CSR weighted by message load (the cgdp objective's
    # load term).  Route costs do NOT steer the block->agent mapping
    # (blocks land on name-ordered agents); they enter only through the
    # shared distribution_cost accounting — uniform-route deployments
    # (the common case, and the mesh analogy) lose nothing.
    loads = edge_loads(computation_graph, communication_load)
    srcs: List[int] = []
    dsts: List[int] = []
    ws: List[float] = []
    for nd in nodes:
        for neigh in nd.neighbors:
            if neigh not in index:
                continue
            key = tuple(sorted((nd.name, neigh)))
            srcs.append(index[nd.name])
            dsts.append(index[neigh])
            ws.append(float(loads.get(key, 1.0)))
    if srcs:
        src = np.asarray(srcs, dtype=np.int64)
        dst = np.asarray(dsts, dtype=np.int64)
        w = np.asarray(ws, dtype=np.float64)
        order = np.lexsort((dst, src))
        src, dst, w = src[order], dst[order], w[order]
        indptr = np.searchsorted(src, np.arange(n + 1))
    else:
        indptr = np.zeros(n + 1, dtype=np.int64)
        dst = np.zeros(0, dtype=np.int64)
        w = np.zeros(0, dtype=np.float64)

    capacities = np.asarray([float(a.capacity) for a in agents])
    targets = _capacity_targets(n, capacities)
    assign = multilevel_assign(indptr, dst, w, targets)

    # capacity check on real footprints (node counts were the balance
    # proxy; memory-weighted capacity must still hold)
    if computation_memory is not None:
        footprint = np.zeros(n)
        for i, nd in enumerate(nodes):
            try:
                footprint[i] = float(computation_memory(nd))
            except Exception:
                footprint[i] = 0.0
        part_fp = np.bincount(assign, weights=footprint, minlength=k)
        over = np.flatnonzero(part_fp > capacities + 1e-9)
        if over.size:
            raise ImpossibleDistributionException(
                f"tpu_part: partition block exceeds agent capacity for "
                f"{[agents[int(p)].name for p in over]} "
                f"(footprints {part_fp[over].tolist()} vs capacities "
                f"{capacities[over].tolist()}); use a capacity-first "
                "method (adhoc/gh_cgdp) for tightly-packed deployments"
            )

    mapping: Dict[str, List[str]] = {a.name: [] for a in agents}
    for i, nm in enumerate(names):
        mapping[agents[int(assign[i])].name].append(nm)
    return Distribution(mapping)


def distribution_cost(
    distribution: Distribution,
    computation_graph: ComputationGraph,
    agentsdef: Iterable[AgentDef],
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
):
    return _dist_cost(
        distribution,
        computation_graph,
        agentsdef,
        computation_memory,
        communication_load,
    )
