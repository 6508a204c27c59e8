"""DPOP: complete inference by dynamic programming on a DFS pseudo-tree.

Counterpart of ``pydcop_tpu/algorithms/dpop.py``.  Each node's UTIL
computation is

    util(sep) = min over own value of [ sum of attached constraint tables
                + sum of children UTIL tensors ]

a tensor join (addition over the union of scopes) and one min-reduction.
The UTIL wave runs in tree-depth levels, deepest first.  Within a level,
nodes are grouped by separator size; each group's joins run as one flat
gather + segment-sum over all of the group's contributions (attached
tables, children UTILs, own unary costs), so the op count is
O(depth x distinct widths).  A contribution is placed into a joint by
index arithmetic: entry j of the flat [D^m] joint reads its source at
sum_t digit(j, axis_t) * stride_t.

The host-side plan (``_Tree``, ``_wave_schedule``, ``_batch_layout``) is
copied from the JAX package, so both packages run the same batches with
the same padding.  The contraction is plain PyTorch: a gather, the port's
ordered ``segment_sum`` (``torch.segment_reduce``, no atomics), the own
unary costs, then ``amin``/``argmin`` over the own-value axis (the first
minimum, as ``jnp.argmin``).

Two execution paths, element-identical by construction:

- the fused wave (``_plan_fused_wave``): when no node needs the chunked
  path and the wave fits the fused budgets, the whole UTIL wave is planned
  once per problem; on the card it is captured once into one CUDA graph
  and each solve replays it and reads back the flat argmin array once; on
  the CPU the same plan runs eagerly;
- the streaming level loop, otherwise: joints live only within their
  level, and a node whose joint exceeds ``MAX_JOINT_ELEMS`` is computed in
  sequential chunks of at most ``CHUNK_ELEMS`` elements.

The gather indices, which the JAX package builds with numpy on the host,
are built on the device from each row's joint positions and source
offset (``_gather_matrix``): the same integer arithmetic, without a
host pass and an upload of D^m indices a row.

The VALUE wave (root-to-leaf) indexes the per-node argmin tables on the
host: O(n_vars) scalar lookups.  ``solve`` counts its graph captures and
replays and the chunks it contracts (``solve.captures``,
``solve.replays``, ``solve.chunks``); the capture census
(``telemetry/profiling.py``) counts the fused wave's build as a
``dpop.fused_wave`` compile and each reuse as a hit.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import resolve_device, segment_offsets, segment_sum
from ..telemetry.memplane import memguard
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from .base import (
    _capture,
    _side_stream,
    capture_lock,
    _tensor_bytes,
    cached_const,
    cached_runner,
    finalize,
)

GRAPH_TYPE = "pseudotree"

algo_params: List[AlgoParameterDef] = []

# A single node's joint above this many elements (float32, ~1 GiB) switches
# to the chunked sequential path, computed CHUNK_ELEMS at a time.
MAX_JOINT_ELEMS = 2 ** 28
CHUNK_ELEMS = 2 ** 24
# Feasibility guard: a node's OUTPUT (util + argmin tables, d^|sep|
# elements each) is live until the VALUE wave no matter how the joint is
# chunked, so bound it per node AND in aggregate: solve raises a
# diagnostic MemoryError up front instead of dying mid-solve.
MAX_OUTPUT_ELEMS = 2 ** 28
# total live tensor budget for one level batch (joints + gathered
# contribution rows; joints are freed per level)
MAX_LEVEL_ELEMS = 2 ** 29
# argmin (choice) tables stay on the device so the UTIL wave never waits
# on the host, but past this many accumulated elements they are flushed to
# the host between levels
CHOICE_FLUSH_ELEMS = 2 ** 26
# total elements (sources + joints + outputs) above which the fused wave
# defers to the streaming path's per-level freeing and choice flushing
FUSED_WAVE_MAX_ELEMS = 2 ** 24
# batch-descriptor cap: very deep trees (one batch per level) stream
FUSED_WAVE_MAX_BATCHES = 512


def computation_memory(node) -> float:
    """UTIL tensor footprint estimate: D^(|parent ∪ pseudo_parents|+1), a
    lower bound (the true separator also inherits ancestors from the
    node's subtree)."""
    d = len(node.variable.domain)
    sep = (1 if node.parent else 0) + len(node.pseudo_parents)
    return float(d ** (sep + 1))


def communication_load(node, target: str) -> float:
    """UTIL message to the parent is the projected hypercube (lower-bound
    estimate, see computation_memory)."""
    d = len(node.variable.domain)
    sep = (1 if node.parent else 0) + len(node.pseudo_parents)
    return float(d ** sep)


class _Tree:
    """DFS pseudo-tree over compiled variable indices: max-degree root,
    higher-degree neighbors visited first, each constraint attached to the
    DFS-lowest variable of its scope.  Built from the compiled arrays, so
    DPOP also runs on array-only problems."""

    def __init__(self, compiled: CompiledDCOP) -> None:
        n = compiled.n_vars
        indptr, dst = compiled.csr_adjacency()
        degree = np.diff(indptr)

        def neighbors(i: int) -> np.ndarray:
            return dst[indptr[i] : indptr[i + 1]]

        parent = [-1] * n
        depth = [0] * n
        order = [-1] * n
        children: List[List[int]] = [[] for _ in range(n)]
        visited = np.zeros(n, dtype=bool)
        counter = 0
        # roots in descending degree (ties: lowest id), one DFS per component
        root_order = np.lexsort((np.arange(n), -degree))
        root_ptr = 0
        while counter < n:
            while visited[root_order[root_ptr]]:
                root_ptr += 1
            root = int(root_order[root_ptr])
            stack: List[Tuple[int, int]] = [(root, -1)]
            while stack:
                node, par = stack.pop()
                if visited[node]:
                    continue
                visited[node] = True
                parent[node] = par
                depth[node] = 0 if par < 0 else depth[par] + 1
                order[node] = counter
                counter += 1
                if par >= 0:
                    children[par].append(node)
                unvis = [m for m in neighbors(node).tolist() if not visited[m]]
                unvis.sort(key=lambda m: (degree[m], m))
                for m in unvis:
                    stack.append((m, node))
        self.parent = parent
        self.depth = depth
        self.order = order
        self.children = children

        # constraints attached to the DFS-lowest variable of their scope
        order_arr = np.asarray(order)
        self.attached: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
        for bi, b in enumerate(compiled.buckets):
            lowest = b.var_slots[
                np.arange(b.n_constraints),
                np.argmax(order_arr[b.var_slots], axis=1),
            ]
            for row_idx, v in enumerate(lowest.tolist()):
                self.attached[v].append((bi, row_idx))

        # separators, bottom-up: sep(i) = (neighbors-above(i) ∪ union of
        # children seps) \ {i}
        self.topo = sorted(range(n), key=lambda i: order[i])  # root first
        sep: List[set] = [set() for _ in range(n)]
        for i in reversed(self.topo):
            s = {int(m) for m in neighbors(i) if order[int(m)] < order[i]}
            for c in children[i]:
                s |= sep[c]
            s.discard(i)
            sep[i] = s
        self.sep = sep
        # deterministic separator ordering: DFS order (ancestors first)
        self.sep_order: List[List[int]] = [
            sorted(sep[i], key=lambda m: order[m]) for i in range(n)
        ]


def _digit_strides(m: int, d: int) -> np.ndarray:
    """C-order strides of a [D]^m block."""
    return d ** (m - 1 - np.arange(m, dtype=np.int64))


def _gather_indices(
    joint_flat_idx: torch.Tensor,
    joint_strides: np.ndarray,
    positions: Tuple[int, ...],
    d: int,
    src_offset: int,
) -> torch.Tensor:
    """For each flat joint index j, the flat source index of a contribution
    whose source axis t sits on joint axis positions[t] (C-order source).
    The JAX package's arithmetic, on the device that holds
    ``joint_flat_idx`` (int64): a batch's indices are built there, not on
    the host and uploaded."""
    a = len(positions)
    out = torch.full_like(joint_flat_idx, src_offset)
    for t, p in enumerate(positions):
        digit = (joint_flat_idx // int(joint_strides[p])) % d
        out += digit * (d ** (a - 1 - t))
    return out


def _gather_matrix(layout: "_BatchLayout", d: int, device) -> torch.Tensor:
    """A batch's [nc_pad, D^m] int32 gather map, one row per contribution
    (padding rows read the zero pad), built on ``device``.  Source arrays
    are bounded far below 2^31 by the level budget."""
    jidx = torch.arange(layout.size, dtype=torch.int64, device=device)
    strides = _digit_strides(layout.m, d)
    out = torch.empty(
        (len(layout.idx_rows), layout.size), dtype=torch.int32, device=device
    )
    for r, (positions, src_offset) in enumerate(layout.idx_rows):
        out[r] = _gather_indices(jidx, strides, positions, d, src_offset)
    return out


def _level_groups(
    tree: _Tree, nodes: List[int]
) -> Dict[int, List[int]]:
    groups: Dict[int, List[int]] = {}
    for i in nodes:
        groups.setdefault(len(tree.sep_order[i]), []).append(i)
    return groups


def solve(
    compiled: CompiledDCOP,
    params: Optional[Dict[str, Any]] = None,
    n_cycles: int = 1,
    seed: int = 0,
    collect_curve: bool = False,
    mesh=None,
    device="cuda",
) -> SolveResult:
    """Solve ``compiled`` exactly with DPOP on ``device`` (the card unless
    the caller asks for the CPU).  ``n_cycles``, ``seed`` and
    ``collect_curve`` are accepted for the solver interface and have no
    effect: DPOP runs one UTIL and one VALUE wave.  ``mesh`` (the JAX
    package's sharded UTIL wave) is not ported and raises."""
    prepare_algo_params(params or {}, algo_params)
    if mesh is not None:
        raise NotImplementedError(
            "dpop: the mesh-sharded UTIL wave is not ported"
        )
    device = resolve_device(device)
    tree = _Tree(compiled)
    d = compiled.max_domain
    n = compiled.n_vars

    # feasibility check up front: even chunked, a node must materialize its
    # util + argmin tables (d^|sep| elements each), and the argmin tables
    # of ALL nodes live until the VALUE wave, so bound their aggregate too
    total_out = 0
    for i in range(n):
        sep_elems = d ** len(tree.sep_order[i])
        total_out += sep_elems
        if sep_elems > MAX_OUTPUT_ELEMS or total_out > 2 * MAX_OUTPUT_ELEMS:
            raise MemoryError(
                f"DPOP util/argmin tables need {total_out}+ entries "
                f"(variable {compiled.var_names[i]} alone has {sep_elems}, "
                f"separator "
                f"{[compiled.var_names[s] for s in tree.sep_order[i]]}); "
                f"induced width too large — use an approximate algorithm"
            )

    if memguard.enabled:
        # before the first upload: a refused solve puts nothing on the
        # device
        memguard.check(compiled, "dpop", params, device=device)
    bucket_tables = [
        _up(compiled, b.tables.reshape(b.tables.shape[0], -1), device)
        for b in compiled.buckets
    ]
    unary = _up(compiled, compiled.unary, device)

    values: Optional[np.ndarray] = None
    plan = cached_const(
        compiled, ("dpop_fused_plan",),
        lambda: _plan_fused_wave(compiled, tree, d),
    )
    if plan is not None:
        wave = cached_runner(
            compiled, ("dpop_fused_wave", str(device)), "dpop.fused_wave",
            lambda: _FusedWave(plan, d, bucket_tables, unary), device,
            _FusedWave.static_bytes,
        )
        flat_choice = wave.run()
        assert flat_choice.size == plan.total_out, (
            "fused wave output drifted from its plan"
        )
        values = _value_wave(
            tree, d, n,
            lambda i, flat: flat_choice[int(plan.node_off[i]) + flat],
        )

    if values is None:
        # per-node results of the UTIL wave, as (producer tensor, row)
        # references; choice holds device tensors until they are flushed
        util_flat: Dict[int, Any] = {}  # [D^sep] flat util message
        choice: Dict[int, Any] = {}  # [D^sep] flat argmin over own value

        for kind, payload, m in _wave_schedule(compiled, tree, d):
            if kind == "batch":
                _util_group(
                    compiled, tree, payload, m, d,
                    bucket_tables, unary, util_flat, choice,
                )
            elif kind == "big":
                _util_chunked(
                    compiled, tree, payload, d, bucket_tables, unary,
                    util_flat, choice,
                )
            else:  # level_end: free consumed children utils
                for i in payload:
                    for c in tree.children[i]:
                        util_flat.pop(c, None)
                # flush device-resident argmin tables to the host once the
                # accumulated ones exceed the budget
                _materialize_choices(choice, CHOICE_FLUSH_ELEMS)

        _materialize_choices(choice, 0)
        values = _value_wave(tree, d, n, lambda i, flat: choice[i][flat])

    n_roots = sum(1 for i in range(n) if tree.parent[i] < 0)
    n_msgs = n - n_roots
    util_size = sum(
        d ** len(tree.sep_order[i]) for i in range(n) if tree.parent[i] >= 0
    )
    value_size = sum(
        len(tree.sep_order[i]) + 1 for i in range(n) if tree.parent[i] >= 0
    )
    return finalize(
        compiled,
        values,
        cycles=1,
        msg_count=2 * n_msgs,
        msg_size=int(util_size + value_size),
    )


solve.captures = 0  # fused-wave graph captures
solve.replays = 0  # fused-wave graph replays
solve.chunks = 0  # chunk contractions of the chunked path


def _wave_schedule(compiled: CompiledDCOP, tree: _Tree, d: int):
    """The UTIL wave's batch schedule, deepest level first: the one source
    of truth consumed by both the streaming loop in solve() and
    _plan_fused_wave, so the two execution paths cannot drift.

    Yields ("batch", nodes, m) for a same-width small-node sub-batch
    (joint = [D]^m each, sized against the level budget), ("big", node, 0)
    for a node needing the chunked path, and ("level_end", nodes, 0)
    after each level (the streaming consumer frees child utils and
    flushes choices there)."""
    n = compiled.n_vars
    max_depth = max(tree.depth) if n else 0
    levels: List[List[int]] = [[] for _ in range(max_depth + 1)]
    for i in range(n):
        levels[tree.depth[i]].append(i)
    for depth in range(max_depth, -1, -1):
        level_nodes = levels[depth]
        if not level_nodes:
            continue
        big_nodes = [
            i for i in level_nodes
            if d ** (len(tree.sep_order[i]) + 1) > MAX_JOINT_ELEMS
        ]
        big_set = set(big_nodes)
        small_nodes = [i for i in level_nodes if i not in big_set]
        for m, group in sorted(_level_groups(tree, small_nodes).items()):
            # sub-batch so one batch's joints PLUS its gathered
            # contribution rows (one [D^m] row per attached table / child
            # util) stay within the level budget
            size = d ** (m + 1)
            budget = max(MAX_LEVEL_ELEMS // 4, 2 * size)
            batch: List[int] = []
            rows = 0
            for i in group:
                n_contrib = (
                    1 + len(tree.attached[i]) + len(tree.children[i])
                )
                if batch and (rows + n_contrib) * size > budget:
                    yield ("batch", batch, m + 1)
                    batch, rows = [], 0
                batch.append(i)
                rows += n_contrib
            if batch:
                yield ("batch", batch, m + 1)
        for i in big_nodes:
            yield ("big", i, 0)
        yield ("level_end", level_nodes, 0)


def _value_wave(tree: _Tree, d: int, n: int, lookup) -> np.ndarray:
    """VALUE wave: root-to-leaf, each node reads its argmin table (via
    ``lookup(node, flat_separator_index)``) at its separator's already
    decided values: O(n) host lookups, shared by both paths."""
    values = np.zeros(n, dtype=np.int32)
    for i in tree.topo:  # root first: separators already fixed
        sep = tree.sep_order[i]
        flat = 0
        if sep:
            strides = _digit_strides(len(sep), d)
            flat = int(sum(
                int(values[s]) * int(st) for s, st in zip(sep, strides)
            ))
        values[i] = int(lookup(i, flat))
    return values


def _materialize_choices(choice: Dict[int, Any], threshold: int) -> None:
    """Fetch device-resident argmin tables to the host when their unique
    producer tensors exceed ``threshold`` elements: one read-back per
    producer (a whole level/width group), then host-side row views.
    Entries already on the host are untouched."""
    producers: Dict[int, torch.Tensor] = {}
    for v in choice.values():
        if isinstance(v, tuple):
            producers.setdefault(id(v[0]), v[0])
    if not producers or sum(a.numel() for a in producers.values()) <= threshold:
        return
    fetched = {k: a.cpu().numpy() for k, a in producers.items()}
    for i, v in list(choice.items()):
        if isinstance(v, tuple):
            arr, slot = v
            host = fetched[id(arr)]
            choice[i] = host if slot is None else host[slot]


def _node_contributions(
    compiled: CompiledDCOP,
    tree: _Tree,
    i: int,
    axes_pos: Dict[int, int],
) -> List[Tuple[str, Any, List[int]]]:
    """(kind, payload, joint positions) for every join input of node ``i``
    except its own unary costs: attached constraint tables and children
    UTIL messages."""
    out: List[Tuple[str, Any, List[int]]] = []
    for bi, row in tree.attached[i]:
        b = compiled.buckets[bi]
        positions = [axes_pos[int(v)] for v in b.var_slots[row]]
        out.append(("table", (bi, row), positions))
    for c in tree.children[i]:
        positions = [axes_pos[v] for v in tree.sep_order[c]]
        out.append(("child", c, positions))
    return out


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


# above this size the upload cache keys an array by a 16-byte blake2b
# digest of its bytes instead of the bytes themselves
_UP_KEY_DIGEST_NBYTES = 1 << 16
# uploads above this stay uncached: bandwidth-bound, and warm solves of
# problems this large are dominated by compute anyway
_UP_CACHE_MAX_NBYTES = 1 << 24


def _up(compiled: CompiledDCOP, arr, device) -> torch.Tensor:
    """Content-addressed upload memo for the wave's operand arrays (index
    matrices, segment offsets, row selectors, bucket tables): the UTIL
    wave is deterministic per compiled problem, so a warm solve uploads
    nothing it uploaded before."""
    a = np.asarray(arr)
    if a.nbytes > _UP_CACHE_MAX_NBYTES:
        return torch.as_tensor(a, device=device)
    if a.nbytes > _UP_KEY_DIGEST_NBYTES:
        content = hashlib.blake2b(a.tobytes(), digest_size=16).digest()
    else:
        content = a.tobytes()
    return cached_const(
        compiled,
        ("dpop_up", str(device), a.dtype.str, a.shape, content),
        lambda: torch.as_tensor(a, device=device),
    )


def _rows_flat(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``a``, flattened."""
    return a.index_select(0, idx).reshape(-1)


def _concat_pad(parts: List[torch.Tensor], n: int) -> torch.Tensor:
    """Concatenate 1-D parts and zero-pad to length ``n``."""
    flat = torch.cat(parts) if len(parts) > 1 else parts[0]
    return torch.cat([flat, flat.new_zeros(n - flat.shape[0])])


def _min_argmin(joints: torch.Tensor, axis: int):
    """(min, argmin) over ``axis``; the argmin is the first minimum, as
    ``jnp.argmin``'s, as int32."""
    return (
        torch.amin(joints, dim=axis),
        torch.argmin(joints, dim=axis).to(torch.int32),
    )


def _unary_util(own: torch.Tensor, rows: int):
    """(util, argmin) for nodes with no contributions beyond their own
    unary costs."""
    joints = own.new_zeros((own.shape[0], rows, own.shape[1])) + own[:, None, :]
    return _min_argmin(joints, 2)


def _group_contract(src, idx, seg_offsets, own):
    """One level-group's joins: gather every contribution row, sum the
    rows of each node in order (``segment_sum``, the same bits on every
    run), add the own-variable unary costs, reduce to (util, argmin) over
    the own-value axis.  ``idx`` is the [n_contrib, D^m] int32 gather map,
    ``seg_offsets`` the [n_seg + 1] bounds of each node's rows."""
    gathered = src.index_select(0, idx.reshape(-1)).reshape(idx.shape)
    joints = segment_sum(gathered, seg_offsets, axis=0)
    d = own.shape[-1]
    joints = joints.reshape(own.shape[0], -1, d) + own[:, None, :]
    return _min_argmin(joints, 2)


class _BatchLayout(NamedTuple):
    """Source layout of ONE UTIL batch: the single definition (shared by
    the streaming _util_group and the fused _plan_fused_wave) of how a
    batch's flat source array is assembled: per-bucket table rows first,
    then per-producer child UTIL rows (row count padded to a power of
    two), then the pow2 zero pad whose first element is the target of
    padded gather rows."""

    unary_only: bool
    m: int  # joint width (separator + own variable)
    size: int  # d ** m
    ng_pad: int
    group_ids: np.ndarray  # [ng_pad] int64 node ids (padded with node 0)
    bucket_rows: Tuple[Tuple[int, np.ndarray], ...]  # (bucket, row ids)
    # (producer key, padded row ids | None = whole flat vector, row elems)
    child_parts: Tuple[Tuple[Any, Optional[np.ndarray], int], ...]
    # (joint positions, source offset) of each gather-map row, padded to
    # nc_pad rows; _gather_matrix builds the [nc_pad, size] map from them
    idx_rows: Tuple[Tuple[Tuple[int, ...], int], ...]
    seg_ids: Optional[np.ndarray]  # [nc_pad] int32
    src_pad: int
    est_elems: int  # live-element estimate: src + gathered rows + joints


def _batch_layout(
    compiled: CompiledDCOP,
    tree: _Tree,
    batch: List[int],
    m: int,
    d: int,
    producer_of,
) -> _BatchLayout:
    """Compute a batch's _BatchLayout.

    ``producer_of(child) -> (key, slot, row_elems)``: where the child's
    UTIL row lives: ``key`` identifies the producer tensor (id() for the
    streaming path, batch index for the fused plan), ``slot`` its row
    (None = a chunked producer's single flat vector, used whole)."""
    size = d ** m
    src_offsets: Dict[Any, int] = {}
    offset = 0
    rows_by_bucket: Dict[int, List[int]] = {}
    for i in batch:
        for bi, row in tree.attached[i]:
            rows_by_bucket.setdefault(bi, []).append(row)
    bucket_rows = []
    for bi, rows in sorted(rows_by_bucket.items()):
        width = int(np.prod(compiled.buckets[bi].tables.shape[1:]))
        for k, row in enumerate(rows):
            src_offsets[("table", bi, row)] = offset + k * width
        offset += len(rows) * width
        bucket_rows.append((bi, np.asarray(rows, np.int64)))
    # children UTIL rows live inside their producing group's [n_g, row]
    # tensor: per producer, one compact gather of exactly the rows this
    # batch consumes
    needed: Dict[Any, List[Tuple[int, Any, int]]] = {}
    for i in batch:
        for c in tree.children[i]:
            key, slot, row_len = producer_of(c)
            needed.setdefault(key, []).append((c, slot, row_len))
    child_parts = []
    for key, consumers in needed.items():  # first-consumer order
        row_len = consumers[0][2]
        if consumers[0][1] is None:
            # chunked producer: a single [row_len] vector, used whole
            for c, _slot, _rl in consumers:
                src_offsets[("child", c)] = offset
            child_parts.append((key, None, row_len))
            offset += row_len
            continue
        slots = sorted({slot for _c, slot, _rl in consumers})
        pos = {sl: k for k, sl in enumerate(slots)}
        n_rows = _pow2(len(slots))
        row_idx = np.zeros(n_rows, dtype=np.int64)
        row_idx[: len(slots)] = slots
        for c, slot, _rl in consumers:
            src_offsets[("child", c)] = offset + pos[slot] * row_len
        child_parts.append((key, row_idx, row_len))
        offset += n_rows * row_len

    n_contrib = sum(
        len(tree.attached[i]) + len(tree.children[i]) for i in batch
    )
    n_g = len(batch)
    # pad every shape to a power of two, as the JAX package does for its
    # compile-shape reuse.  Padding gather rows point at a guaranteed-zero
    # src entry and land in the last real segment, adding exactly 0.0;
    # padded segments read node 0's unary and are never stored.
    ng_pad = _pow2(max(n_g, 1))
    group_ids = np.zeros(ng_pad, dtype=np.int64)
    group_ids[:n_g] = batch
    if n_contrib == 0:
        return _BatchLayout(
            True, m, size, ng_pad, group_ids, (), (), (), None, 0,
            2 * ng_pad * size,
        )
    nc_pad = _pow2(n_contrib)
    src_pad = _pow2(offset + 1)
    # gather map: one [D^m] row per contribution, segment id = group slot
    idx_rows: List[Tuple[Tuple[int, ...], int]] = []
    seg_ids: List[int] = []
    for slot, i in enumerate(batch):
        axes = tree.sep_order[i] + [i]
        pos = {v: k for k, v in enumerate(axes)}
        for kind, payload, positions in _node_contributions(
            compiled, tree, i, pos
        ):
            key = (
                ("table",) + payload if kind == "table"
                else ("child", payload)
            )
            idx_rows.append((tuple(positions), src_offsets[key]))
            seg_ids.append(slot)
    idx_rows += [((), offset)] * (nc_pad - len(idx_rows))
    seg_ids += [n_g - 1] * (nc_pad - len(seg_ids))
    return _BatchLayout(
        False, m, size, ng_pad, group_ids, tuple(bucket_rows),
        tuple(child_parts), tuple(idx_rows), np.asarray(seg_ids, np.int32),
        src_pad, src_pad + (nc_pad + 2 * ng_pad) * size,
    )


def _util_group(
    compiled: CompiledDCOP,
    tree: _Tree,
    group: List[int],
    m: int,
    d: int,
    bucket_tables: List[torch.Tensor],
    unary: torch.Tensor,
    util_flat: Dict[int, Any],
    choice: Dict[int, Any],
) -> None:
    """UTIL for a group of same-width nodes (joint = [D]^m each) as one
    gather + segment-sum: each contribution expands to a [D^m] row of the
    source array (layout: _batch_layout); rows sum into their node's
    joint."""
    device = unary.device

    def producer_of(c):
        arr, slot = util_flat[c]
        return (id(arr), slot, arr.numel() if slot is None else arr.shape[-1])

    layout = _batch_layout(compiled, tree, group, m, d, producer_of)
    if layout.unary_only:
        own = unary.index_select(
            0, _up(compiled, np.asarray(group, np.int64), device)
        )  # [n_g, D]
        util, arg = _unary_util(own, layout.size // d)
    else:
        arrs: Dict[Any, torch.Tensor] = {}
        for i in group:
            for c in tree.children[i]:
                arr = util_flat[c][0]
                arrs[id(arr)] = arr
        src_parts: List[torch.Tensor] = [
            _rows_flat(bucket_tables[bi], _up(compiled, rows, device))
            for bi, rows in layout.bucket_rows
        ]
        for key, row_idx, _row_len in layout.child_parts:
            arr = arrs[key]
            if row_idx is None:
                src_parts.append(arr.reshape(-1))
            else:
                src_parts.append(
                    _rows_flat(arr, _up(compiled, row_idx, device))
                )
        src = _concat_pad(src_parts, layout.src_pad)
        util, arg = _group_contract(
            src,
            _gather_matrix(layout, d, device),
            _up(compiled, segment_offsets(layout.seg_ids, layout.ng_pad),
                device),
            unary.index_select(0, _up(compiled, layout.group_ids, device)),
        )
    for slot, i in enumerate(group):
        # (tensor, row) references: consumers address rows by flat offset
        util_flat[i] = (util, slot)
        choice[i] = (arg, slot)


def _chunk_contract(srcs, idxs, own):
    """One chunk of a big node's joint: the sum of every contribution's
    gathered values, in contribution order, plus the own unary costs,
    reduced over the own-value axis."""
    joint = srcs[0][idxs[0]]
    for s, ix in zip(srcs[1:], idxs[1:]):
        joint = joint + s[ix]
    joint = joint.reshape(-1, own.shape[-1]) + own[None, :]
    return _min_argmin(joint, 1)


def _util_chunked(
    compiled: CompiledDCOP,
    tree: _Tree,
    i: int,
    d: int,
    bucket_tables: List[torch.Tensor],
    unary: torch.Tensor,
    util_flat: Dict[int, Any],
    choice: Dict[int, Any],
) -> None:
    """Sequential fallback for a node whose joint exceeds the in-core limit:
    iterate over the leading separator axes in chunks, keeping only
    [CHUNK_ELEMS] live at a time."""
    device = unary.device
    axes = tree.sep_order[i] + [i]
    m = len(axes)
    size = d ** m
    n_chunks = 1
    while size // n_chunks > CHUNK_ELEMS:
        n_chunks *= d
    chunk = size // n_chunks
    strides = _digit_strides(m, d)
    pos = {v: k for k, v in enumerate(axes)}
    contribs = _node_contributions(compiled, tree, i, pos)

    # sources are chunk-invariant: resolve each contribution's row once
    srcs = []
    for kind, payload, positions in contribs:
        if kind == "table":
            bi, row = payload
            srcs.append(bucket_tables[bi][row])
        else:
            arr, slot = util_flat[payload]
            srcs.append(arr if slot is None else arr[slot])

    own = unary[i]
    util_parts: List[torch.Tensor] = []
    choice_parts: List[torch.Tensor] = []
    for ci in range(n_chunks):
        jidx = torch.arange(ci * chunk, (ci + 1) * chunk,
                            dtype=torch.int64, device=device)
        idxs = [
            _gather_indices(jidx, strides, positions, d, 0)
            for (_, _, positions) in contribs
        ]
        if idxs:
            u, a = _chunk_contract(srcs, idxs, own)
        else:
            u, a = _unary_util(own[None, :], chunk // d)
            u, a = u[0], a[0]
        solve.chunks += 1
        util_parts.append(u)
        choice_parts.append(a)
    # same (tensor, row) convention as _util_group, slot None = whole tensor
    util_flat[i] = (torch.cat(util_parts), None)
    choice[i] = (torch.cat(choice_parts), None)


# ---------------------------------------------------------------------------
# The fused UTIL wave: planned once per problem, one CUDA graph on the card
# ---------------------------------------------------------------------------


class _FusedPlan(NamedTuple):
    descs: Tuple[_BatchLayout, ...]  # the wave's batches, in order
    node_off: np.ndarray  # [n] int64 offset of node i's argmin table
    total_out: int  # length of the flat choice read-back


def _plan_fused_wave(compiled: CompiledDCOP, tree: _Tree, d: int):
    """Plan the whole UTIL wave as _BatchLayout descriptors.

    Both the schedule (_wave_schedule) and each batch's source layout
    (_batch_layout) are the same code the streaming path runs, so the
    fused result is element-identical by construction.  Returns None when
    any node needs the chunked path or the wave exceeds the fused
    budgets."""
    n = compiled.n_vars
    if n == 0:
        return None

    descs: List[_BatchLayout] = []
    node_loc: Dict[int, Tuple[int, int, int]] = {}  # node -> (batch,
    #   slot, row elements)
    total_live = 0

    def producer_of(c):
        return node_loc[c]

    def plan_batch(batch: List[int], m: int) -> bool:
        nonlocal total_live
        if len(descs) >= FUSED_WAVE_MAX_BATCHES:
            return False
        layout = _batch_layout(compiled, tree, batch, m, d, producer_of)
        if total_live + layout.est_elems > FUSED_WAVE_MAX_ELEMS:
            return False
        total_live += layout.est_elems
        bid = len(descs)
        descs.append(layout)
        row_len = layout.size // d
        for slot, i in enumerate(batch):
            node_loc[i] = (bid, slot, row_len)
        return True

    for kind, payload, m in _wave_schedule(compiled, tree, d):
        if kind == "big":
            return None  # chunked path needed: stream
        if kind == "batch" and not plan_batch(payload, m):
            return None

    # flat output layout: batches in order, each [ng_pad * row_len]
    base = 0
    batch_base = []
    for desc in descs:
        batch_base.append(base)
        base += desc.ng_pad * (desc.size // d)
    node_off = np.zeros(n, dtype=np.int64)
    for i, (bid, slot, row_len) in node_loc.items():
        node_off[i] = batch_base[bid] + slot * row_len
    return _FusedPlan(descs=tuple(descs), node_off=node_off, total_out=base)


class _FusedWave:
    """A fused plan's operands on one device, and on the card the wave
    captured into one CUDA graph.

    Every index the wave reads is uploaded here, before any capture, so
    the captured work holds no host value and no upload.  On the card the
    wave runs once on a side stream (warm-up), is captured once, and each
    ``run`` replays the graph and reads back the flat argmin array; on the
    CPU ``run`` runs the same ops eagerly."""

    def __init__(self, plan: _FusedPlan, d: int, bucket_tables,
                 unary) -> None:
        device = unary.device
        self.d = d
        self.bucket_tables, self.unary = bucket_tables, unary

        def up(a):
            return torch.as_tensor(np.asarray(a), device=device)

        self.ops = []
        for desc in plan.descs:
            if desc.unary_only:
                self.ops.append((desc, up(desc.group_ids), (), (), None, None))
                continue
            self.ops.append((
                desc,
                up(desc.group_ids),
                tuple((bi, up(rows)) for bi, rows in desc.bucket_rows),
                tuple((pb, up(ridx)) for pb, ridx, _ in desc.child_parts),
                _gather_matrix(desc, d, device),
                up(segment_offsets(desc.seg_ids, desc.ng_pad)),
            ))
        self.graph = None
        if device.type == "cuda":
            self.capture()

    def static_bytes(self) -> int:
        """The bytes of the tensors the wave reads in place."""
        return _tensor_bytes(
            [t for op in self.ops for t in op[1:]
             if isinstance(t, torch.Tensor)]
            + [t for op in self.ops for part in op[2:4] for _, t in part]
            + list(self.bucket_tables) + [self.unary]
        )

    def capture(self) -> None:
        """Warm the wave up on a side stream, then capture it."""
        with capture_lock:
            with _side_stream(self.unary.device):
                self._wave()
            self.graph = _capture(self._store)
        solve.captures += 1

    def _wave(self) -> torch.Tensor:
        """The UTIL wave: [total_out] int32 argmin tables, batch after
        batch, the same contraction the streaming path runs."""
        outs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for desc, group_ids, bucket_rows, child_rows, idx, offsets in self.ops:
            own = self.unary.index_select(0, group_ids)
            if desc.unary_only:
                outs.append(_unary_util(own, desc.size // self.d))
                continue
            parts = [
                _rows_flat(self.bucket_tables[bi], rows)
                for bi, rows in bucket_rows
            ]
            parts += [_rows_flat(outs[pb][0], ridx) for pb, ridx in child_rows]
            src = _concat_pad(parts, desc.src_pad)
            outs.append(_group_contract(src, idx, offsets, own))
        return torch.cat([arg.reshape(-1) for _, arg in outs])

    def _store(self) -> None:
        self.out = self._wave()

    def run(self) -> np.ndarray:
        if self.graph is None:
            return self._wave().numpy()
        self.graph.replay()
        solve.replays += 1
        return self.out.cpu().numpy()
