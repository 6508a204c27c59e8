"""Multilevel k-way graph partitioning, vectorized numpy + boundary FM.

The port's own copy of ``pydcop_tpu/partition/multilevel.py``: the same
numpy calls in the same order, so both packages give the same parts for
the same graph.  ``distribution.tpu_part`` places computations on agents
with ``multilevel_assign``, and the HA router places its affinity
buckets on workers through ``tpu_part``; ``variable_graph``,
``chunk_targets``, ``partition_order`` and ``ell_shard_assignment`` give
the row orderings of a sharded ELL layout, which ``partition.icimodel``
costs (the sharded solve itself is not ported).

The classic multilevel recipe (coarsen / initial partition /
uncoarsen+refine) restated as array programs, so a large graph
partitions on the host without a python-per-vertex loop on the fine
levels:

- **Coarsening** — size-constrained label-propagation clustering (each
  vertex adopts the neighboring cluster with the heaviest connection,
  rank-capped so clusters stay small): the scheme known to handle
  hub-and-spoke (scale-free) graphs, where pure heavy-edge matching
  stalls on stars.  Mutual heavy-edge matching is kept as the fallback
  when label propagation stops shrinking.  Contracted edge weights are
  summed, so the cut of a coarse partition IS the cut of its projection.
- **Bisection** — k-way is recursive 2-way (like METIS' pmetis): each
  bisection runs the full multilevel pipeline with a greedy-grown
  initial split and, per level, a vectorized boundary pass followed by
  sequential Fiduccia–Mattheyses hill climbing (gain heap, best prefix
  of a move sequence kept, so it escapes the local optima the batch
  pass cannot).  FM is bounded to ``fm_limit`` vertices per level —
  coarse levels decide most of the cut.
- **k-way polish** — pairwise FM sweeps over the heaviest-boundary part
  pairs (vertex moves between two parts never change the cut toward
  other parts, so each pair refines independently), first with a slack
  bound, then a Kernighan–Lin-style two-heap pass that alternates sides
  so every candidate prefix is BALANCED — the only move structure that
  can still improve at exact part sizes.
- **Exact fill** — part sizes are made EXACTLY the requested targets
  (cheapest boundary vertices move last).

All functions are deterministic: ties break on vertex id, no RNG.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "variable_graph",
    "chunk_targets",
    "multilevel_assign",
    "partition_order",
    "ell_shard_assignment",
]

# stop coarsening when the graph is this small (enough vertices that the
# greedy initial partition has room to balance the parts)...
_COARSEST_PER_PART = 8
_COARSEST_FLOOR = 32
# ...or when a level shrinks the vertex count by less than this
_MIN_SHRINK = 0.02
# vectorized refinement rounds per level
_REFINE_ROUNDS = 8
# allowed transient imbalance during slack refinement, as a fraction of
# the target size (exact-fill restores sizes == targets at the end)
_REFINE_SLACK = 0.05

# sequential FM knobs: skip levels larger than the limit (python heap
# ops per vertex), bound moves per pass, stop a pass this far past its
# best prefix
_FM_LIMIT = 150_000
_FM_MOVE_CAP = 30_000
_FM_PLATEAU = 2_000
_FM_PASSES = 6


# ---------------------------------------------------------------------------
# graph extraction
# ---------------------------------------------------------------------------


def variable_graph(
    compiled, plane_itemsize: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, nbr, wgt) CSR of the variable adjacency with edge weights
    in message-plane BYTES PER CYCLE between the pair.

    Every arity-``a`` constraint contributes a slot pair per ordered pair
    of distinct scope variables; each pair slot of the sharded ELL cycle
    gathers its partner's ``[D]`` message column once per cycle, so one
    binary constraint between ``(u, v)`` costs ``D * itemsize`` bytes in
    each direction when the pair straddles shards.  Multi-edges (several
    constraints over one pair) accumulate."""
    n = compiled.n_vars
    itemsize = (
        int(plane_itemsize)
        if plane_itemsize is not None
        else int(np.dtype(compiled.float_dtype).itemsize)
    )
    unit = float(compiled.max_domain * itemsize)
    srcs: List[np.ndarray] = []
    dsts: List[np.ndarray] = []
    for b in compiled.buckets:
        a = b.arity
        if a < 2 or b.n_constraints == 0:
            continue
        ii, jj = np.meshgrid(np.arange(a), np.arange(a), indexing="ij")
        off = (ii != jj).reshape(-1)
        s = b.var_slots[:, ii.reshape(-1)[off]].reshape(-1)
        t = b.var_slots[:, jj.reshape(-1)[off]].reshape(-1)
        keep = s != t  # a variable repeated in one scope is not a pair
        srcs.append(s[keep].astype(np.int64))
        dsts.append(t[keep].astype(np.int64))
    if not srcs or not sum(len(s) for s in srcs):
        return (
            np.zeros(n + 1, dtype=np.int64),
            np.zeros(0, dtype=np.int64),
            np.zeros(0, dtype=np.float64),
        )
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    # merge duplicate directed pairs, summing multiplicity
    key = src * n + dst
    uniq, counts = np.unique(key, return_counts=True)
    m_src = uniq // n
    m_dst = uniq % n
    wgt = counts.astype(np.float64) * unit
    indptr = np.searchsorted(m_src, np.arange(n + 1))
    return indptr, m_dst, wgt


def chunk_targets(
    n: int, k: int, row_chunk: Optional[int] = None
) -> np.ndarray:
    """Per-part vertex-count targets matching the equal contiguous row
    blocks the padded DeviceDCOP shards into: ``pad_device_dcop`` pads
    the variable axis to ``ceil_to(n + 1, k)`` (it always reserves a dead
    row), so the GSPMD chunk is ``ceil((n + 1) / k)`` and the last
    block(s) absorb the remainder.  Identical blocking to ``build_ell``
    and ``cross_shard_incidence``; callers that know the actual padded
    row count pass ``row_chunk`` explicitly."""
    if k <= 0:
        raise ValueError(f"need k >= 1 parts, got {k}")
    if row_chunk is None:
        row_chunk = (n + k) // k  # ceil((n + 1) / k)
    if row_chunk * k < n:
        raise ValueError(
            f"row_chunk {row_chunk} x {k} parts does not cover {n} rows"
        )
    return np.array(
        [min(row_chunk, max(0, n - p * row_chunk)) for p in range(k)],
        dtype=np.int64,
    )


# ---------------------------------------------------------------------------
# coarsening
# ---------------------------------------------------------------------------


def _rank_in_group(groups: np.ndarray, priority: np.ndarray) -> np.ndarray:
    """Rank (0 = best) of each element within its group, higher
    ``priority`` first; ties break on position."""
    order = np.lexsort((np.arange(len(groups)), -priority, groups))
    g = groups[order]
    first = np.ones(len(g), dtype=bool)
    first[1:] = g[1:] != g[:-1]
    starts = np.flatnonzero(first)
    grp = np.cumsum(first) - 1
    rank_sorted = np.arange(len(g)) - starts[grp]
    rank = np.empty(len(groups), dtype=np.int64)
    rank[order] = rank_sorted
    return rank


def _lp_cluster(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    vw: np.ndarray,
    weight_cap: float,
    rounds: int = 5,
) -> Optional[Tuple[np.ndarray, int]]:
    """Size-constrained label propagation: every vertex repeatedly adopts
    the label with the strongest total connection among its neighbors,
    admission rank-capped so no cluster exceeds ``weight_cap``.  Returns
    (cmap, n_coarse) or None when the graph refuses to shrink."""
    n = indptr.size - 1
    if n == 0 or len(nbr) == 0:
        return None
    src = np.repeat(np.arange(n), np.diff(indptr))
    label = np.arange(n)
    for _ in range(rounds):
        cw = np.bincount(label, weights=vw, minlength=n)
        key = src.astype(np.int64) * n + label[nbr]
        uniq, inv = np.unique(key, return_inverse=True)
        ws = np.bincount(inv, weights=wgt, minlength=len(uniq))
        su = (uniq // n).astype(np.int64)
        lu = (uniq % n).astype(np.int64)
        order = np.lexsort((lu, -ws, su))
        su_sorted = su[order]
        first = np.ones(len(su_sorted), dtype=bool)
        first[1:] = su_sorted[1:] != su_sorted[:-1]
        top = order[first]
        best = np.full(n, -1, dtype=np.int64)
        best_w = np.zeros(n)
        best[su[top]] = lu[top]
        best_w[su[top]] = ws[top]
        # connection to the vertex's own current label
        own = np.zeros(n)
        own_key = np.arange(n, dtype=np.int64) * n + label
        pos = np.searchsorted(uniq, own_key)
        ok = (pos < len(uniq)) & (
            uniq[np.minimum(pos, len(uniq) - 1)] == own_key
        )
        own[ok] = ws[pos[ok]]
        movers = np.flatnonzero(
            (best >= 0) & (best != label) & (best_w > own)
        )
        if not movers.size:
            break
        dest = best[movers]
        rank = _rank_in_group(dest, best_w[movers] - own[movers])
        room = np.maximum(
            0.0,
            np.floor(
                (weight_cap - cw[dest]) / np.maximum(vw[movers], 1)
            ),
        )
        admit = rank < room
        label[movers[admit]] = dest[admit]
    uniq, cmap = np.unique(label, return_inverse=True)
    n_coarse = len(uniq)
    if n_coarse >= n * (1 - _MIN_SHRINK):
        return None
    return cmap.astype(np.int64), n_coarse


def _best_neighbor(
    indptr: np.ndarray,
    nbr: np.ndarray,
    src: np.ndarray,
    score: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vertex heaviest neighbor under ``score`` (-inf = ineligible):
    (best_nbr, best_score), best_nbr = -1 where no eligible neighbor."""
    n = indptr.size - 1
    deg = np.diff(indptr)
    order = np.lexsort((nbr, -score, src))
    best = np.full(n, -1, dtype=np.int64)
    best_score = np.full(n, -np.inf)
    rows = deg > 0
    top = order[indptr[:-1][rows]]
    eligible = np.isfinite(score[top])
    best[np.flatnonzero(rows)[eligible]] = nbr[top[eligible]]
    best_score[np.flatnonzero(rows)[eligible]] = score[top[eligible]]
    return best, best_score


def _match_level(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    vw: np.ndarray,
    weight_cap: float,
    rounds: int = 4,
) -> Optional[Tuple[np.ndarray, int]]:
    """Mutual heavy-edge matching (+ one capacity-capped aggregation
    round): the fallback coarsening when label propagation stalls."""
    n = indptr.size - 1
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n), deg)
    match = np.full(n, -1, dtype=np.int64)
    for _ in range(rounds):
        free_edge = (match[src] < 0) & (match[nbr] < 0)
        fits = vw[src] + vw[nbr] <= weight_cap
        score = np.where(free_edge & fits, wgt, -np.inf)
        best, _ = _best_neighbor(indptr, nbr, src, score)
        has = np.flatnonzero(best >= 0)
        if not has.size:
            break
        mutual = has[best[best[has]] == has]
        lo = mutual[mutual < best[mutual]]
        if not lo.size:
            break
        match[lo] = best[lo]
        match[best[lo]] = lo
    # aggregation round: free vertices may join an existing matched pair
    # (capacity-capped) — keeps hub-and-spoke regions shrinking when
    # mutual matching stalls on stars
    free_v = match < 0
    pair_root = np.where(
        (match >= 0) & (match < np.arange(n)), match, np.arange(n)
    )
    score = np.where(free_v[src] & ~free_v[nbr], wgt, -np.inf)
    best, best_w = _best_neighbor(indptr, nbr, src, score)
    joiners = np.flatnonzero(free_v & (best >= 0))
    # joiners are tracked in their own array: their target IS the pair's
    # root vertex, while `match` entries on pairs point at the partner —
    # folding both into `match` and taking min(match, id) would no-op
    # every join whose vertex id is below the root's
    joined = np.full(n, -1, dtype=np.int64)
    if joiners.size:
        roots = pair_root[best[joiners]]
        root_w = vw[roots] + vw[match[roots]]
        rank = _rank_in_group(roots, best_w[joiners])
        room = np.maximum(
            0,
            np.floor(
                (weight_cap - root_w) / np.maximum(vw[joiners], 1)
            ),
        )
        ok = rank < room
        joined[joiners[ok]] = roots[ok]
    root = np.where(
        match >= 0, np.minimum(match, np.arange(n)), np.arange(n)
    )
    root = np.where(joined >= 0, joined, root)
    root = np.minimum(root, root[root])
    is_root = root == np.arange(n)
    n_coarse = int(is_root.sum())
    if n_coarse >= n * (1 - _MIN_SHRINK):
        return None
    cmap = np.cumsum(is_root) - 1
    return cmap[root], n_coarse


def _coarsen_level(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    vw: np.ndarray,
    weight_cap: float,
) -> Optional[Tuple[np.ndarray, int]]:
    """One coarsening level: label-propagation clustering first, mutual
    matching as the fallback; None when neither shrinks the graph."""
    out = _lp_cluster(indptr, nbr, wgt, vw, weight_cap)
    if out is not None:
        return out
    return _match_level(indptr, nbr, wgt, vw, weight_cap)


def _contract(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    vw: np.ndarray,
    cmap: np.ndarray,
    n_coarse: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Contract a graph under ``cmap``: coarse CSR with summed edge
    weights + summed vertex weights."""
    deg = np.diff(indptr)
    src = np.repeat(np.arange(indptr.size - 1), deg)
    cu = cmap[src]
    cv = cmap[nbr]
    keep = cu != cv
    key = cu[keep] * n_coarse + cv[keep]
    uniq, inv = np.unique(key, return_inverse=True)
    w = np.bincount(inv, weights=wgt[keep], minlength=len(uniq))
    m_src = uniq // n_coarse
    m_dst = uniq % n_coarse
    c_indptr = np.searchsorted(m_src, np.arange(n_coarse + 1))
    c_vw = np.bincount(cmap, weights=vw, minlength=n_coarse)
    return c_indptr, m_dst, w, c_vw


# ---------------------------------------------------------------------------
# initial partition (coarsest graph — small, plain python is fine)
# ---------------------------------------------------------------------------


def _greedy_grow(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    vw: np.ndarray,
    targets: np.ndarray,
) -> np.ndarray:
    """Greedy region growth: parts grown one at a time by absorbing the
    unassigned vertex with the strongest connection to the part."""
    n = indptr.size - 1
    k = len(targets)
    assign = np.full(n, -1, dtype=np.int64)
    conn = np.zeros(n)
    deg_w = np.zeros(n)
    np.add.at(deg_w, np.repeat(np.arange(n), np.diff(indptr)), wgt)
    # big parts first: they need the most room to grow connected
    for p in np.argsort(-targets, kind="stable"):
        target = float(targets[p])
        if target <= 0:
            continue
        size = 0.0
        conn[:] = 0.0
        while size < target:
            un = assign < 0
            if not un.any():
                break
            cand = np.where(un, conn, -np.inf)
            v = int(np.argmax(cand))
            if not np.isfinite(cand[v]) or conn[v] <= 0.0:
                # no connected candidate: seed at the heaviest-degree
                # unassigned vertex (hubs first, like bfs_order)
                un_ids = np.flatnonzero(un)
                v = int(un_ids[np.argmax(deg_w[un_ids])])
            assign[v] = p
            size += float(vw[v])
            span = slice(indptr[v], indptr[v + 1])
            conn[nbr[span]] += wgt[span]
    # leftovers (only when every target filled early): least-full part
    left = np.flatnonzero(assign < 0)
    if left.size:
        sizes = np.bincount(
            assign[assign >= 0], weights=vw[assign >= 0], minlength=k
        )
        for v in left:
            p = int(np.argmin(sizes - targets))
            assign[v] = p
            sizes[p] += vw[v]
    return assign


# ---------------------------------------------------------------------------
# refinement: vectorized boundary pass
# ---------------------------------------------------------------------------


def _part_connectivity(
    src: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    assign: np.ndarray,
    n: int,
    k: int,
) -> np.ndarray:
    """W[v, p] = total edge weight from v into part p (one bincount)."""
    return np.bincount(
        src * k + assign[nbr], weights=wgt, minlength=n * k
    ).reshape(n, k)


def _refine(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    vw: np.ndarray,
    assign: np.ndarray,
    targets: np.ndarray,
    rounds: int = _REFINE_ROUNDS,
    slack: float = _REFINE_SLACK,
) -> np.ndarray:
    """Vectorized boundary passes: positive-gain moves applied best-first
    while the balance bound holds (per-destination room AND per-source
    drain limits, both relative to ``targets``)."""
    n = indptr.size - 1
    k = len(targets)
    if k <= 1 or n == 0 or len(nbr) == 0:
        return assign
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n), deg)
    sizes = np.bincount(assign, weights=vw, minlength=k).astype(float)
    tgt = targets.astype(float)
    hi = tgt * (1 + slack) + vw.max()
    lo = np.maximum(tgt * (1 - slack) - vw.max(), 0.0)
    for _ in range(rounds):
        W = _part_connectivity(src, nbr, wgt, assign, n, k)
        cur = W[np.arange(n), assign]
        W[np.arange(n), assign] = -np.inf
        best_p = np.argmax(W, axis=1)
        gain = W[np.arange(n), best_p] - cur
        movers = np.flatnonzero(gain > 1e-12)
        if not movers.size:
            break
        # best-first under the balance bound: per-destination prefix by
        # room, then per-source prefix by drain allowance
        accepted = np.zeros(len(movers), dtype=bool)
        order = np.argsort(-gain[movers], kind="stable")
        mv = movers[order]
        for p in range(k):
            into = mv[best_p[mv] == p]
            if not into.size:
                continue
            room = hi[p] - sizes[p]
            take = np.cumsum(vw[into]) <= room
            accepted[np.searchsorted(movers, into[take])] = True
        for q in range(k):
            outof = mv[(assign[mv] == q)]
            outof = outof[accepted[np.searchsorted(movers, outof)]]
            if not outof.size:
                continue
            drain = sizes[q] - lo[q]
            drop = np.cumsum(vw[outof]) > drain
            accepted[np.searchsorted(movers, outof[drop])] = False
        moved = movers[accepted]
        if not moved.size:
            break
        np.subtract.at(sizes, assign[moved], vw[moved])
        np.add.at(sizes, best_p[moved], vw[moved])
        assign[moved] = best_p[moved]
    return assign


# ---------------------------------------------------------------------------
# refinement: sequential FM (gain heap, hill climbing, best prefix)
# ---------------------------------------------------------------------------


def _fm2(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    vw: np.ndarray,
    assign: np.ndarray,
    targets: np.ndarray,
    passes: int = _FM_PASSES,
    slack: float = 0.05,
) -> np.ndarray:
    """Sequential Fiduccia–Mattheyses on a 2-way partition: repeatedly
    move the highest-gain unlocked vertex (lazy-invalidating gain heap),
    allowing negative-gain moves, and keep the best prefix of each pass'
    move sequence — the hill-climbing step batch label propagation lacks.
    Balance is a soft bound during a pass (``slack``); callers restore
    exact sizes with :func:`_exact_fill`."""
    n = indptr.size - 1
    if n == 0 or len(nbr) == 0:
        return assign
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n), deg)
    tgt = targets.astype(float)
    hi = tgt * (1 + slack) + vw.max()
    move_cap = min(n, _FM_MOVE_CAP)
    if n > 20_000:
        # big levels: the vectorized boundary pass already ran; a couple
        # of hill-climbing passes capture most of the remaining gain at
        # a fraction of the heap churn
        passes = min(passes, 2)
    for _ in range(passes):
        W = np.bincount(
            src * 2 + assign[nbr], weights=wgt, minlength=n * 2
        ).reshape(n, 2)
        g = W[np.arange(n), 1 - assign] - W[np.arange(n), assign]
        sizes = np.bincount(assign, weights=vw, minlength=2).astype(float)
        locked = np.zeros(n, dtype=bool)
        a = assign.copy()
        # seed the heap with boundary vertices only: an interior vertex
        # has strictly negative gain and can only become worth moving
        # after a neighbor moves — at which point the update pushes it
        boundary = np.flatnonzero(W[:, 0] * W[:, 1] > 0)
        if not boundary.size:
            boundary = np.flatnonzero(W.sum(axis=1) > 0)
        heap = [(-g[v], v) for v in boundary.tolist()]
        heapq.heapify(heap)
        moves: List[int] = []
        cur_gain = 0.0
        best_gain = 0.0
        best_prefix = 0
        while heap and len(moves) < move_cap:
            ng, v = heapq.heappop(heap)
            if locked[v] or -ng != g[v]:
                continue  # stale entry
            d = 1 - a[v]
            if sizes[d] + vw[v] > hi[d]:
                continue
            cur_gain += g[v]
            sizes[a[v]] -= vw[v]
            sizes[d] += vw[v]
            a[v] = d
            locked[v] = True
            moves.append(v)
            span = slice(indptr[v], indptr[v + 1])
            nb_v = nbr[span]
            w_v = wgt[span]
            same = a[nb_v] == d
            g[nb_v] += np.where(same, -2.0 * w_v, 2.0 * w_v)
            for u in nb_v[~locked[nb_v]].tolist():
                heapq.heappush(heap, (-g[u], u))
            if cur_gain > best_gain + 1e-12:
                best_gain = cur_gain
                best_prefix = len(moves)
            elif len(moves) - best_prefix > _FM_PLATEAU:
                break
        if best_prefix == 0:
            break
        flip = np.asarray(moves[:best_prefix], dtype=np.int64)
        assign[flip] = 1 - assign[flip]
    return assign


def _fm2_balanced(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    vw: np.ndarray,
    assign: np.ndarray,
    targets: np.ndarray,
    passes: int = _FM_PASSES,
) -> np.ndarray:
    """Kernighan–Lin-flavored FM: two gain heaps (one per side); while a
    side exceeds its target only it may move, so move sequences
    alternate and every candidate prefix is balanced — the move
    structure that can still improve a partition at EXACT part sizes,
    where plain FM's one-directional prefixes are all rejected."""
    n = indptr.size - 1
    if n == 0 or len(nbr) == 0:
        return assign
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n), deg)
    tgt = targets.astype(float)
    move_cap = min(n, _FM_MOVE_CAP)
    for _ in range(passes):
        W = np.bincount(
            src * 2 + assign[nbr], weights=wgt, minlength=n * 2
        ).reshape(n, 2)
        g = W[np.arange(n), 1 - assign] - W[np.arange(n), assign]
        sizes = np.bincount(assign, weights=vw, minlength=2).astype(float)
        locked = np.zeros(n, dtype=bool)
        a = assign.copy()
        boundary = np.flatnonzero(W[:, 0] * W[:, 1] > 0)
        if not boundary.size:
            boundary = np.flatnonzero(W.sum(axis=1) > 0)
        heaps: List[list] = [[], []]
        for v in boundary.tolist():
            heapq.heappush(heaps[a[v]], (-g[v], v))
        moves: List[int] = []
        cur_gain = 0.0
        best_gain = 0.0
        best_prefix = 0
        plateau = 0
        while len(moves) < move_cap:
            over = sizes - tgt
            forced = over[0] > 1e-9 or over[1] > 1e-9
            if over[0] > 1e-9:
                side = 0
            elif over[1] > 1e-9:
                side = 1
            else:
                # balanced: take the better valid top of the two heaps
                for s in (0, 1):
                    h = heaps[s]
                    while h and (
                        locked[h[0][1]]
                        or -h[0][0] != g[h[0][1]]
                        or a[h[0][1]] != s
                    ):
                        heapq.heappop(h)
                if heaps[0] and heaps[1]:
                    side = 0 if heaps[0][0][0] <= heaps[1][0][0] else 1
                elif heaps[0]:
                    side = 0
                elif heaps[1]:
                    side = 1
                else:
                    break
            h = heaps[side]
            v = -1
            while h:
                ng, u = heapq.heappop(h)
                if locked[u] or -ng != g[u] or a[u] != side:
                    continue
                v = u
                break
            if v < 0:
                if forced:
                    # the overfull side has no movable vertex left: the
                    # pass cannot restore balance, stop (the best prefix
                    # is balanced by construction)
                    break
                if not heaps[0] and not heaps[1]:
                    break
                continue
            d = 1 - side
            cur_gain += g[v]
            sizes[side] -= vw[v]
            sizes[d] += vw[v]
            a[v] = d
            locked[v] = True
            moves.append(v)
            span = slice(indptr[v], indptr[v + 1])
            nb_v = nbr[span]
            w_v = wgt[span]
            same = a[nb_v] == d
            g[nb_v] += np.where(same, -2.0 * w_v, 2.0 * w_v)
            for u in nb_v[~locked[nb_v]].tolist():
                heapq.heappush(heaps[a[u]], (-g[u], u))
            if (
                abs(sizes[0] - tgt[0]) < 1.0
                and cur_gain > best_gain + 1e-12
            ):
                best_gain = cur_gain
                best_prefix = len(moves)
                plateau = 0
            else:
                plateau += 1
                if plateau > _FM_PLATEAU:
                    break
        if best_prefix == 0:
            break
        flip = np.asarray(moves[:best_prefix], dtype=np.int64)
        assign[flip] = 1 - assign[flip]
    return assign


def _exact_fill(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    assign: np.ndarray,
    targets: np.ndarray,
) -> np.ndarray:
    """Make part sizes EXACTLY ``targets`` (unit vertex weights): move
    the cheapest boundary vertices from overfull to underfull parts."""
    n = indptr.size - 1
    k = len(targets)
    if k <= 1:
        return np.zeros(n, dtype=np.int64)
    if int(targets.sum()) != n:
        raise ValueError(
            f"targets sum {int(targets.sum())} != vertex count {n}"
        )
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n), deg)
    sizes = np.bincount(assign, minlength=k).astype(np.int64)
    guard = 0
    while not np.array_equal(sizes, targets):
        guard += 1
        if guard > 4 * k + 8:  # pragma: no cover - safety valve
            raise RuntimeError("exact-fill failed to converge")
        W = (
            _part_connectivity(src, nbr, wgt, assign, n, k)
            if len(nbr)
            else np.zeros((n, k))
        )
        cur = W[np.arange(n), assign]
        under = np.flatnonzero(sizes < targets)
        room = (targets - sizes)[under].astype(np.int64)
        # best underfull destination per vertex
        Wu = W[:, under]
        bu = np.argmax(Wu, axis=1)
        loss = cur - Wu[np.arange(n), bu]  # cut increase of the move
        for q in np.flatnonzero(sizes > targets):
            surplus = int(sizes[q] - targets[q])
            vs = np.flatnonzero(assign == q)
            pick = vs[np.argsort(loss[vs], kind="stable")]
            moved = 0
            for v in pick:
                d = int(bu[v])
                if room[d] <= 0:
                    avail = np.flatnonzero(room > 0)
                    if not avail.size:
                        break
                    d = int(avail[np.argmax(Wu[v, avail])])
                assign[v] = under[d]
                room[d] -= 1
                sizes[q] -= 1
                sizes[under[d]] += 1
                moved += 1
                if moved >= surplus:
                    break
    return assign


# ---------------------------------------------------------------------------
# 2-way multilevel bisection
# ---------------------------------------------------------------------------


def _bisect(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    targets: np.ndarray,
    refine_rounds: int = _REFINE_ROUNDS,
    fm_limit: int = _FM_LIMIT,
) -> np.ndarray:
    """Full multilevel 2-way partition with EXACT part sizes."""
    n = indptr.size - 1
    targets = np.asarray(targets, dtype=np.int64)
    if targets[0] == 0:
        return np.ones(n, dtype=np.int64)
    if targets[1] == 0:
        return np.zeros(n, dtype=np.int64)

    # coarsening.  The cluster weight cap aims the coarsest graph at
    # ~``floor`` vertices of comparable weight: heavier clusters would
    # make the balance targets unreachable for the initial partition and
    # freeze refinement (a vertex heavier than the slack cannot move).
    levels: List[np.ndarray] = []  # cmap per level (fine -> coarse ids)
    graphs = [(indptr, nbr, wgt, np.ones(n))]
    floor = max(_COARSEST_FLOOR, _COARSEST_PER_PART * 2)
    weight_cap = max(4.0, float(n) / floor)
    while graphs[-1][0].size - 1 > floor:
        ip, nb, w, vw = graphs[-1]
        out = _coarsen_level(ip, nb, w, vw, weight_cap)
        if out is None:
            break
        cmap, n_coarse = out
        levels.append(cmap)
        graphs.append(_contract(ip, nb, w, vw, cmap, n_coarse))

    # initial split on the coarsest graph
    ip, nb, w, vw = graphs[-1]
    tgt_f = targets.astype(float)
    assign = _greedy_grow(ip, nb, w, vw, tgt_f)

    # uncoarsen: vectorized boundary pass + sequential FM at every level
    for lvl in range(len(levels), -1, -1):
        if lvl < len(levels):
            assign = assign[levels[lvl]]
        ip, nb, w, vw = graphs[lvl]
        assign = _refine(
            ip, nb, w, vw, assign, tgt_f, rounds=refine_rounds
        )
        if ip.size - 1 <= fm_limit:
            assign = _fm2(ip, nb, w, vw, assign, targets)
    assign = _exact_fill(indptr, nbr, wgt, assign, targets)
    if n <= fm_limit:
        # balanced hill climb at exact sizes, then re-pin exact balance
        assign = _fm2_balanced(
            indptr, nbr, wgt, np.ones(n), assign, targets
        )
        assign = _exact_fill(indptr, nbr, wgt, assign, targets)
    return assign


def _subgraph(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    sel: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Induced subgraph on the vertices where ``sel``: (indptr, nbr,
    wgt, ids) with ids mapping new -> old vertex numbers."""
    ids = np.flatnonzero(sel)
    newid = np.full(indptr.size - 1, -1, dtype=np.int64)
    newid[ids] = np.arange(ids.size)
    src = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    keep = sel[src] & sel[nbr]
    s = newid[src[keep]]
    d = newid[nbr[keep]]
    w = wgt[keep]
    order = np.lexsort((d, s))
    s, d, w = s[order], d[order], w[order]
    ip = np.searchsorted(s, np.arange(ids.size + 1))
    return ip, d, w, ids


# ---------------------------------------------------------------------------
# the k-way entry point
# ---------------------------------------------------------------------------


def _pairwise_polish(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    assign: np.ndarray,
    targets: np.ndarray,
    sweeps: int = 2,
    fm_limit: int = _FM_LIMIT,
    balanced: bool = False,
) -> np.ndarray:
    """Pairwise FM sweeps over the heaviest-boundary part pairs: moves
    between two parts never change the cut toward other parts, so each
    pair refines independently with the 2-way machinery.  ``balanced``
    selects the two-heap KL variant that preserves exact part sizes."""
    n = indptr.size - 1
    k = len(targets)
    src = np.repeat(np.arange(n), np.diff(indptr))
    refine = _fm2_balanced if balanced else _fm2
    for _ in range(sweeps):
        improved = False
        a, b = assign[src], assign[nbr]
        m = a < b
        boundary = np.bincount(
            a[m] * k + b[m], weights=wgt[m], minlength=k * k
        )
        for pk in np.argsort(-boundary, kind="stable"):
            if boundary[pk] <= 0:
                break
            p, q = int(pk // k), int(pk % k)
            ip, d, w, ids = _subgraph(
                indptr, nbr, wgt, (assign == p) | (assign == q)
            )
            if ip.size - 1 > fm_limit or len(d) == 0:
                continue
            sub = (assign[ids] == q).astype(np.int64)
            t2 = np.array([targets[p], targets[q]], dtype=np.int64)
            sub_src = np.repeat(np.arange(ip.size - 1), np.diff(ip))
            before = float(w[sub[sub_src] != sub[d]].sum())
            new = refine(ip, d, w, np.ones(ids.size), sub.copy(), t2)
            if not balanced:
                new = _exact_fill(ip, d, w, new, t2)
            after = float(w[new[sub_src] != new[d]].sum())
            if after < before - 1e-9:
                assign[ids] = np.where(new == 0, p, q)
                improved = True
        if not improved:
            break
    return assign


def multilevel_assign(
    indptr: np.ndarray,
    nbr: np.ndarray,
    wgt: np.ndarray,
    targets: np.ndarray,
    refine_rounds: int = _REFINE_ROUNDS,
    fm_limit: int = _FM_LIMIT,
    polish_sweeps: int = 2,
) -> np.ndarray:
    """k-way partition of a CSR graph into parts of EXACTLY the given
    vertex-count ``targets`` (sum == n): [n] int64 part assignment.

    Recursive multilevel bisection (coarsen / greedy-grow / per-level
    boundary pass + sequential FM) followed by pairwise FM polish over
    the part pairs with the heaviest boundaries — a slack pass first,
    then the balanced KL pass that can still move at exact sizes."""
    targets = np.asarray(targets, dtype=np.int64)
    n = indptr.size - 1
    if targets.sum() != n:
        raise ValueError(
            f"targets sum {targets.sum()} != vertex count {n}"
        )
    k = len(targets)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if k == 1:
        return np.zeros(n, dtype=np.int64)

    def recurse(ip, nb, w, tgt, base, out, ids):
        kk = len(tgt)
        if kk == 1:
            out[ids] = base
            return
        half = kk // 2
        two = np.array(
            [tgt[:half].sum(), tgt[half:].sum()], dtype=np.int64
        )
        a2 = _bisect(
            ip, nb, w, two,
            refine_rounds=refine_rounds, fm_limit=fm_limit,
        )
        for side, sub_tgt, sub_base in (
            (0, tgt[:half], base),
            (1, tgt[half:], base + half),
        ):
            s_ip, s_nb, s_w, s_ids = _subgraph(ip, nb, w, a2 == side)
            recurse(s_ip, s_nb, s_w, sub_tgt, sub_base, out, ids[s_ids])

    assign = np.zeros(n, dtype=np.int64)
    recurse(indptr, nbr, wgt, targets, 0, assign, np.arange(n))
    if k > 2 and polish_sweeps > 0:
        assign = _pairwise_polish(
            indptr, nbr, wgt, assign, targets,
            sweeps=polish_sweeps, fm_limit=fm_limit,
        )
        assign = _exact_fill(indptr, nbr, wgt, assign, targets)
        assign = _pairwise_polish(
            indptr, nbr, wgt, assign, targets,
            sweeps=polish_sweeps, fm_limit=fm_limit, balanced=True,
        )
    return _exact_fill(indptr, nbr, wgt, assign, targets)


def partition_order(
    compiled,
    n_shards: int,
    row_chunk: Optional[int] = None,
    effort: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Multilevel placement of a compiled DCOP for ``n_shards`` row-block
    shards: (order, assign, info).

    ``order`` is a [n_vars] permutation (new position -> old variable id)
    laying each part out as one contiguous block whose span is EXACTLY
    the padded DeviceDCOP's GSPMD row chunk (``chunk_targets``), so
    ``reorder_compiled(compiled, order)`` + ``build_ell`` gives a sharded
    layout whose pair gather crosses shards exactly where the partition
    cut does.  ``assign`` is the per-variable part id in the ORIGINAL
    numbering; ``info`` carries cut statistics.

    ``effort``: "fast" skips the pairwise-polish stages (about half the
    wall at ~1% worse cut), "quality" runs them, "auto" picks quality up
    to 200k variables."""
    import time

    if effort not in ("auto", "fast", "quality"):
        raise ValueError(f"unknown effort {effort!r}")
    if effort == "auto":
        effort = "quality" if compiled.n_vars <= 200_000 else "fast"
    t0 = time.perf_counter()
    n = compiled.n_vars
    targets = chunk_targets(n, n_shards, row_chunk)
    indptr, nbr, wgt = variable_graph(compiled)
    assign = multilevel_assign(
        indptr, nbr, wgt, targets,
        polish_sweeps=2 if effort == "quality" else 0,
    )
    # stable within parts: prior locality (generator / BFS order) is kept
    order = np.lexsort((np.arange(n), assign))
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n), deg)
    cross = assign[src] != assign[nbr]
    info = {
        "n_shards": int(n_shards),
        "effort": effort,
        "targets": targets.tolist(),
        "cut_weight": float(wgt[cross].sum()),
        "total_weight": float(wgt.sum()),
        "incidence": (
            float(cross.sum() / len(nbr)) if len(nbr) else 0.0
        ),
        "order_wall_s": round(time.perf_counter() - t0, 4),
    }
    return order, assign, info


def ell_shard_assignment(
    compiled,
    n_shards: int,
    row_chunk: Optional[int],
    strategy: str = "auto",
) -> Tuple[Optional[np.ndarray], str]:
    """Resolve a maxsum ``ordering`` strategy to a per-variable ELL shard
    assignment: (shard_of, resolved_tag).

    ``shard_of=None`` means "use the contiguous row chunks of the current
    numbering" (``build_ell``'s default).  ``auto`` resolves to the
    multilevel partitioner on sharded meshes — unless the compiled
    problem was already laid out by ``partition_compiled`` for this
    shard count, in which case the contiguous chunks ARE the partition
    and recomputing would be wasted work.  The resolved tag must ride
    every cache key derived from the layout (maxsum's ``ell_host`` /
    ``ell_frac`` consts): two strategies on one compiled problem are two
    different layouts, and a warm plan must never serve a stale
    ordering."""
    if strategy not in ("auto", "none", "bfs", "multilevel"):
        raise ValueError(f"unknown ordering strategy {strategy!r}")
    if n_shards <= 1 or strategy == "none" or compiled.n_edges == 0:
        return None, "none"
    if strategy == "auto":
        meta = getattr(compiled, "_partition_meta", None)
        if (
            isinstance(meta, dict)
            and meta.get("n_shards") == n_shards
        ):
            # already block-laid-out for this mesh: contiguous chunks
            return None, f"pre:{meta.get('strategy', 'multilevel')}"
        strategy = "multilevel"
    n = compiled.n_vars
    if row_chunk is None:
        row_chunk = (n + n_shards) // n_shards
    if strategy == "bfs":
        from ..parallel.placement import bfs_order

        order = bfs_order(compiled)
        assign = np.empty(n, dtype=np.int64)
        assign[order] = np.minimum(
            np.arange(n) // row_chunk, n_shards - 1
        )
        return assign, "bfs"
    _, assign, _ = partition_order(compiled, n_shards, row_chunk)
    return assign, "multilevel"
