"""Device representation and the device ops of the solvers' cycles.

Counterpart of ``pydcop_tpu/compile/kernels.py``:

- ``DeviceDCOP``/``DeviceBucket``: the compiled arrays as tensors on one
  torch device (``to_device``), with ``f2v_perm`` (``build_f2v_perm``),
  the one gather that takes factor-side blocks back to global edge order.
- ``evaluate``: the total cost of a full assignment, run once per cycle
  for anytime-best tracking, summed by ``xla_sum`` in the JAX package's
  order (XLA-CPU's tree of windows of 32).
- the local-cost layer of the local-search solvers (DSA, MGM, MGM-2,
  MixedDSA, DBA, GDBA): ``local_costs`` (every candidate value's cost for
  every variable, others held fixed), ``_slot_costs`` and
  ``per_slot_to_edges`` (per-edge slot data), ``edge_constraint_costs``,
  ``constraint_costs``, ``violation_count``, and the ``segment_max`` and
  ``segment_min`` the neighbourhood reductions use.
- the edges layout: ``[n_edges, D]`` message planes; ``factor_step``
  (any arity) and ``variable_step_with_select``, whose fan-in is a sorted
  segmented sum over the edges of each variable.
- the lanes layout: the same cycle on ``[D, n_edges]`` planes
  (``factor_step_lanes``, ``variable_step_with_select_lanes``).  Every
  arity-2 bucket's min-plus marginalization runs as the Hopper kernel
  ``hopper_kernels.factor_arity2_minplus`` on the card; other arities run
  the plain broadcast-add-min.
- the ELL ("degree-bucketed") layout, binary constraints only:
  ``build_ell`` (host, numpy) orders edge slots by variable and pads each
  variable to a power-of-two degree class, so the variable fan-in is a
  dense reshape-sum per class, the fan-out a broadcast, and the factor
  exchange ONE permutation gather to the partner slot.
  ``factor_step_ell`` is that gather plus the min-plus marginalization,
  run by the Hopper kernel ``hopper_kernels.ell_minplus`` on the card;
  ``variable_step_with_select_ell`` is the variable half.  Padding slots
  carry exact zeros in both message planes every cycle, so fan-in sums
  and convergence checks never see them.

Every float sum whose rounding can decide a result runs in the order XLA's
CPU compiler gives the JAX package's jitted program, on the CPU and on
the card alike: windows of 32, level after level, for ``evaluate``'s
totals, the ELL fan-in and ``xla_sum`` (on the card each is one launch of
the ``xla_tree_sum`` kernel: ``hopper_kernels.tree_evaluate``,
``ell_fan_in``, ``xla_tree_sum``); ``segment_sum_onto`` for a fan-in
that XLA folds, with the ``base +`` around it, into one scatter onto the
base (the edges and lanes fan-ins, ``local_costs``); ``domain_sum`` for
the mean over the domain axis.  ``segment_sum`` is
``torch.segment_reduce`` over the variable-sorted edges: each segment
summed in edge order, deterministic
on the card (no atomics) and bitwise equal to XLA's sorted
``segment_sum`` on the CPU.

Every op here runs inside a CUDA graph capture on the card: no host
read-back, no host-to-device copy, no shape that depends on values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .core import BIG, CompiledDCOP
from .hopper_kernels import (
    _OPS,
    _batch_first,
    bucket_costs_plain,
    damp_fma,
    ell_fan_in,
    ell_minplus,
    factor_arity2_minplus,
    minplus_marginals_plain,
    tree_evaluate,
    xla_tree_sum,
)

__all__ = [
    "DeviceBucket",
    "DeviceDCOP",
    "resolve_device",
    "build_f2v_perm",
    "to_device",
    "take_rows",
    "masked_argmin",
    "xla_sum",
    "domain_sum",
    "evaluate",
    "local_costs",
    "per_slot_to_edges",
    "constraint_costs",
    "edge_constraint_costs",
    "violation_count",
    "factor_step",
    "variable_step",
    "variable_step_with_select",
    "select_values",
    "segment_sum",
    "segment_sum_onto",
    "fan_in_onto",
    "onto_layout",
    "segment_max",
    "segment_min",
    "bf16_scalar",
    "damp",
    "segment_offsets",
    "LanesAux",
    "lanes_aux",
    "factor_step_lanes",
    "variable_step_with_select_lanes",
    "EllLayout",
    "build_ell",
    "factor_step_ell",
    "variable_step_with_select_ell",
]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when no card is
    present: a solve asked for the card never goes on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device


@dataclass(frozen=True)
class DeviceBucket:
    arity: int
    tables_flat: torch.Tensor  # [n_c, D**arity]
    var_slots: torch.Tensor  # [n_c, arity] int64
    edge_ids: torch.Tensor  # [n_c, arity] int64
    con_ids: torch.Tensor  # [n_c] int64


@dataclass(frozen=True)
class DeviceDCOP:
    """The arrays of a ``CompiledDCOP`` as tensors on one device.  An
    edgeless problem gets one dummy edge on variable 0 (``n_edges`` 1,
    ``edge_var``/``edge_con`` ``zeros(1)``), as in the JAX package."""

    n_vars: int
    max_domain: int
    n_edges: int  # max(compiled.n_edges, 1)
    n_constraints: int  # max(compiled.n_constraints, 1)
    domain_size: torch.Tensor  # [n_vars] int64
    valid_mask: torch.Tensor  # [n_vars, D] bool
    unary: torch.Tensor  # [n_vars, D] float32
    constant_cost: torch.Tensor  # scalar float32
    edge_var: torch.Tensor  # [n_edges] int64, sorted
    edge_con: torch.Tensor  # [n_edges] int64
    var_degree: torch.Tensor  # [n_vars] int64
    buckets: Tuple[DeviceBucket, ...]
    # [n_edges] int64: gather map from the stacked (bucket, slot) factor
    # blocks, plus their sentinel zero row, to global edge order
    f2v_perm: torch.Tensor
    # [n_vars + 1] int64: variable v's edges are edge_var[off[v]:off[v+1]]
    # (the dummy edge of an edgeless problem counts for variable 0)
    fan_in_offsets: torch.Tensor
    # the fan-in onto a per-variable base (``segment_sum_onto``): [n_vars +
    # n_edges] int64 gather map from ``cat([base, per_edge])`` to each
    # variable's base followed by its edges, and the [n_vars + 1] bounds
    # of those segments (``to_device`` builds both)
    fan_in_onto_perm: torch.Tensor
    fan_in_onto_offsets: torch.Tensor


def build_f2v_perm(
    bucket_edge_ids: List[np.ndarray], n_edges: int
) -> np.ndarray:
    """[n_edges] int32 gather indices from factor-kernel output order to
    global edge order.

    Factor-side kernels emit one block per (bucket, slot), stacked
    bucket-major then slot-major, plus one all-zero sentinel row at the
    end; ``stacked[perm]`` is then the plane in global edge order.  Edges
    absent from every bucket map to the sentinel."""
    total = sum(e.shape[0] * e.shape[1] for e in bucket_edge_ids)
    perm = np.full(n_edges, total, dtype=np.int32)  # default: sentinel row
    base = 0
    for edge_ids in bucket_edge_ids:
        n_c, a = edge_ids.shape
        for s in range(a):
            perm[edge_ids[:, s]] = base + s * n_c + np.arange(n_c)
        base += n_c * a
    return perm


def to_device(c: CompiledDCOP, device="cuda") -> DeviceDCOP:
    """The compiled arrays as tensors on ``device``."""
    if c.n_edges and not np.all(np.diff(c.edge_var) >= 0):
        # the fan-in sums each variable's edges as one contiguous segment:
        # an unsorted edge list would corrupt every fan-in (run it through
        # compile.core.sort_edges_by_var)
        raise ValueError(
            "CompiledDCOP.edge_var must be sorted by variable id"
        )
    device = resolve_device(device)
    fdt = torch.float32

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    buckets = tuple(
        DeviceBucket(
            arity=b.arity,
            tables_flat=torch.as_tensor(
                b.tables.reshape(b.tables.shape[0], -1), dtype=fdt,
                device=device,
            ),
            var_slots=idx(b.var_slots),
            edge_ids=idx(b.edge_ids),
            con_ids=idx(b.con_ids),
        )
        for b in c.buckets
    )
    n_edges = max(c.n_edges, 1)
    dummy = np.zeros(1, dtype=np.int32)
    edge_var = c.edge_var if c.n_edges else dummy
    offsets = segment_offsets(edge_var, c.n_vars)
    onto_perm, onto_offsets = onto_layout(offsets)
    return DeviceDCOP(
        n_vars=c.n_vars,
        max_domain=c.max_domain,
        n_edges=n_edges,
        n_constraints=max(c.n_constraints, 1),
        domain_size=idx(c.domain_size),
        valid_mask=torch.as_tensor(c.valid_mask, device=device),
        unary=torch.as_tensor(c.unary, dtype=fdt, device=device),
        constant_cost=torch.tensor(c.constant_cost, dtype=fdt, device=device),
        edge_var=idx(edge_var),
        edge_con=idx(c.edge_con if c.n_edges else dummy),
        var_degree=idx(c.var_degree),
        buckets=buckets,
        f2v_perm=idx(
            build_f2v_perm([b.edge_ids for b in c.buckets], n_edges)
        ),
        fan_in_offsets=idx(offsets),
        fan_in_onto_perm=idx(onto_perm),
        fan_in_onto_offsets=idx(onto_offsets),
    )


def _strides(arity: int, d: int) -> List[int]:
    """C-order strides of a [D]*arity block."""
    return [d ** (arity - 1 - t) for t in range(arity)]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=-1)``: per-row table reads."""
    return torch.gather(x, -1, idx.long())


def _flat_index(vals: torch.Tensor, strides: List[int]) -> torch.Tensor:
    """``sum_t vals[:, t] * strides[t]``: the flat table index of each row
    of slot values (integer, so exact in any order).  The strides stay
    Python ints: no host-to-device copy, so it runs inside a CUDA graph
    capture."""
    flat = vals[:, 0] * strides[0]
    for t in range(1, len(strides)):
        flat = flat + vals[:, t] * strides[t]
    return flat


def _bucket_costs(
    bucket: DeviceBucket, d: int, values: torch.Tensor
) -> torch.Tensor:
    """[n_c] cost of each constraint in the bucket under ``values``."""
    return bucket_costs_plain(bucket.tables_flat, bucket.var_slots, d, values)


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum over the last axis in the order XLA's CPU compiler
    gives the JAX package's jitted ``jnp.sum``: windows of 32 summed in
    order, symmetrically zero-padded, level after level until at most 32
    partial sums are left, then those in order (``hopper_kernels.
    xla_tree_levels``).  A bf16 ``x`` is summed in float32 and rounded to
    bf16 once, as XLA does.  On the card it is one launch of the
    ``xla_tree_sum`` kernel, on the CPU its plain version: one order on
    both."""
    if x.dtype == torch.bfloat16:
        return xla_tree_sum(x.float()).to(torch.bfloat16)
    return xla_tree_sum(x)


def domain_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over the domain axis ``dim`` (kept, of size 1) in XLA's
    order: ``xla_sum`` over that axis (in index order from 0.0 up to 32
    values; a single value is its own sum), read in place on the card."""
    return xla_sum(x.movedim(dim, -1)).unsqueeze(dim)


def evaluate(dev: DeviceDCOP, values: torch.Tensor) -> torch.Tensor:
    """Scalar total cost (min-form) of a full assignment: unary +
    constraints + constant, summed per bucket (no scatter).  Each sum runs
    in XLA-CPU's tree order, and the totals combine as the JAX package's
    do, ``unary + (0 + b0 + b1 + ...) + constant``: the total is the JAX
    package's to the bit, so the anytime best's strict ``<`` keeps the
    same cycle where cycles with forbidden (1e9) entries tie in true
    cost.  On the card the gathers, the sums and the combine are one
    launch (``hopper_kernels.tree_evaluate``)."""
    return tree_evaluate(
        dev.unary, values,
        [(b.tables_flat, b.var_slots) for b in dev.buckets],
        dev.constant_cost,
    )


# ---------------------------------------------------------------------------
# The local-cost layer of the local-search solvers (DSA, MGM, MGM-2)
# ---------------------------------------------------------------------------


def _slot_costs(
    bucket: DeviceBucket, d: int, values: torch.Tensor
) -> torch.Tensor:
    """[n_c, arity, D]: cost of the bucket's constraints when slot s takes
    each candidate value and every other slot keeps its current value."""
    a = bucket.arity
    strides = _strides(a, d)
    vals = values.long()[bucket.var_slots]  # [n_c, a]
    flat_full = _flat_index(vals, strides)  # the full current assignment
    cand = torch.arange(d, device=values.device)
    out = []
    for s in range(a):
        offset = flat_full - vals[:, s] * strides[s]  # slot s zeroed
        idx = offset[:, None] + cand * strides[s]  # [n_c, D]
        out.append(take_rows(bucket.tables_flat, idx))
    return torch.stack(out, dim=1)


def per_slot_to_edges(
    dev: DeviceDCOP, blocks: List[torch.Tensor]
) -> torch.Tensor:
    """[n_edges, width]: each bucket's ``[n_c, arity, width]`` block of
    per-(constraint, slot) data placed at its global edge rows, flattened
    slot-major and stacked bucket-major (the ``build_f2v_perm`` contract),
    then the one ``f2v_perm`` gather; edges of no bucket read zeros."""
    width = blocks[0].shape[-1]
    outs = [b.transpose(0, 1).reshape(-1, width) for b in blocks]
    return _stack_to_edges(dev, outs, width)


def local_costs(dev: DeviceDCOP, values: torch.Tensor) -> torch.Tensor:
    """[n_vars, D]: for each variable, the total cost of each candidate
    value while every other variable keeps its current ``values``
    (invalid candidates cost >= BIG).  The per-slot costs are per-edge
    data in the variable-sorted edge order, so the fan-in is the sorted
    ``segment_sum``: deterministic on the card, and bitwise equal to the
    JAX package's on the CPU."""
    blocks = [
        _slot_costs(bucket, dev.max_domain, values)
        for bucket in dev.buckets
    ]
    if not blocks:
        return dev.unary
    return fan_in_onto(dev, dev.unary, per_slot_to_edges(dev, blocks))


def fan_in_onto(
    dev: DeviceDCOP, base: torch.Tensor, per_edge: torch.Tensor
) -> torch.Tensor:
    """[n_vars, width]: ``base`` plus each variable's per-edge rows,
    summed in the JAX package's jitted order (``segment_sum_onto``)."""
    return segment_sum_onto(
        base, per_edge, dev.fan_in_onto_perm, dev.fan_in_onto_offsets, 0
    )


def constraint_costs(
    dev: DeviceDCOP, values: torch.Tensor
) -> torch.Tensor:
    """[n_constraints]: cost of every (arity >= 2) constraint under
    ``values``, placed by global constraint id (folded arity <= 1 entries
    are zero)."""
    out = dev.unary.new_zeros(dev.n_constraints)
    for bucket in dev.buckets:
        out.index_copy_(
            0, bucket.con_ids, _bucket_costs(bucket, dev.max_domain, values)
        )
    return out


def edge_constraint_costs(
    dev: DeviceDCOP, values: torch.Tensor
) -> torch.Tensor:
    """[n_edges]: the cost of each edge's constraint under ``values``
    (every slot of a constraint sees its cost; edges of no bucket see
    0), without a scatter."""
    blocks = [
        _bucket_costs(b, dev.max_domain, values)[:, None, None].expand(
            -1, b.arity, 1
        )
        for b in dev.buckets
    ]
    if not blocks:
        return dev.unary.new_zeros(dev.n_edges)
    return per_slot_to_edges(dev, blocks)[:, 0]


#: min-form cost magnitude from which an entry counts as a hard-constraint
#: violation on the device: half of BIG, which no noise or few summed soft
#: costs reach and every BIG-encoded forbidden tuple does
VIOLATION_BAND = BIG * 0.5


def violation_count(dev: DeviceDCOP, values: torch.Tensor) -> torch.Tensor:
    """Scalar count of the entries (unary and every bucket) in the BIG
    forbidden band at ``values``."""
    unary_cost = take_rows(dev.unary, values[:, None])[:, 0]
    count = (unary_cost.abs() >= VIOLATION_BAND).sum()
    for b in dev.buckets:
        count = count + (
            _bucket_costs(b, dev.max_domain, values).abs() >= VIOLATION_BAND
        ).sum()
    return count


def masked_argmin(
    costs: torch.Tensor, valid_mask: torch.Tensor
) -> torch.Tensor:
    """Argmin over the valid domain slots of each row (int32; the first
    index on ties)."""
    masked = torch.where(valid_mask, costs, torch.inf)
    return torch.argmin(masked, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Edges layout: message planes [n_edges, D]
# ---------------------------------------------------------------------------


def _stack_to_edges(
    dev: DeviceDCOP, outs: List[torch.Tensor], width: int
) -> torch.Tensor:
    """Per-(bucket, slot) [n_c, width] blocks in global edge order: the
    ``f2v_perm`` gather over the blocks plus their sentinel zero row."""
    stacked = torch.cat(outs + [outs[0].new_zeros((1, width))])
    return stacked[dev.f2v_perm]


def factor_step(dev: DeviceDCOP, v2f: torch.Tensor) -> torch.Tensor:
    """One factor half-cycle on [n_edges, D] planes: for each constraint
    and target slot s, ``out[c, s, x] = min over the other slots' values
    of (cost + sum over the other slots' messages)``, computed as one
    broadcast-add into the joint table, ``((T + m_0) + m_1) + ...``, and
    per slot the min over the others of ``total - m_s``.  Fan-out to edge
    order is the ``f2v_perm`` gather."""
    d = dev.max_domain
    outs = []
    for bucket in dev.buckets:
        a = bucket.arity
        n_c = bucket.tables_flat.shape[0]
        in_msgs = v2f[bucket.edge_ids]  # [n_c, a, D]
        msgs = []  # slot s's messages along axis 1 + s of [n_c] + [D]*a
        for s in range(a):
            shape = [n_c] + [1] * a
            shape[1 + s] = d
            msgs.append(in_msgs[:, s].reshape(shape))
        total = bucket.tables_flat.reshape((n_c,) + (d,) * a)
        for m in msgs:
            total = total + m
        for s in range(a):
            marg = total - msgs[s]
            axes = tuple(1 + t for t in range(a) if t != s)
            outs.append(
                torch.amin(marg, dim=axes) if axes else marg.reshape(n_c, d)
            )
    if not outs:
        return torch.zeros_like(v2f)
    return _stack_to_edges(dev, outs, d)


def bf16_scalar(x: float) -> float:
    """``x`` rounded to bfloat16 (to nearest even): the constant XLA
    multiplies a bf16 plane by when a Python float scales it."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def damp(
    damping: float, prev: torch.Tensor, new: torch.Tensor, fma: bool = False
):
    """``damping * prev + (1 - damping) * new``, with the float32 ``new``.
    A bfloat16 ``prev`` (MaxSum's precision="bf16") is scaled as the JAX
    package's jitted step scales it: widened to float32 and multiplied by
    ``damping`` rounded to bf16, in float32, with no rounding of the
    product back to bf16 (XLA's CPU compiler keeps the excess precision
    where the product feeds a float32 add).

    ``fma``: a float32 ``prev`` is damped as one fused multiply-add,
    ``fma(d, prev, (1 - d) * new)`` rounded once, the form XLA's CPU
    compiler gives the JAX package's MaxSum programs
    (``hopper_kernels.damp_fma``: the ``damp_fma`` kernel on the card,
    its plain version on the CPU).  A bf16 ``prev`` ignores it: JAX's
    bf16 program does not contract."""
    if prev.dtype == torch.bfloat16:
        return prev.float() * bf16_scalar(damping) + (1.0 - damping) * new
    if fma:
        return damp_fma(damping, prev, new)
    return damping * prev + (1.0 - damping) * new


def _normalize_v2f(
    v2f: torch.Tensor, mask: torch.Tensor, dsize: torch.Tensor, dim: int,
    damping: float, prev: torch.Tensor, fma: bool = False,
) -> torch.Tensor:
    """Mean-normalize variable->factor messages over the valid domain
    slots (``dim`` is the domain axis), BIG on invalid slots, then damp
    against the previous plane (``damp``'s ``fma``)."""
    mean = domain_sum(torch.where(mask, v2f, 0.0), dim) / (
        torch.clamp(dsize, min=1)
    )
    v2f = torch.where(mask, v2f - mean, BIG)
    if damping and prev is not None:
        v2f = damp(damping, prev, v2f, fma)
    return v2f


def segment_sum(
    x: torch.Tensor, offsets: torch.Tensor, axis: int
) -> torch.Tensor:
    """The fan-in: sums of ``x`` along ``axis`` over the contiguous
    segments that ``offsets`` bound (one per variable), each summed in
    order, with no atomics: the same bits on every run on the card, and
    bitwise equal to XLA's sorted ``segment_sum`` on the CPU.  ``offsets``
    is precomputed, so no call rescans segment lengths, and ``unsafe``
    skips the offsets' checks, which read values back to the host (a
    sync that a CUDA graph capture forbids).  Mapped over an instance
    axis (the serving layer's batches) it is one ``segment_reduce`` over
    the K instances, each with its own offsets, each segment still summed
    in order."""
    return _segment_sum_op(x, offsets, axis)


@torch.library.custom_op(f"{_OPS}::segment_sum", mutates_args=())
def _segment_sum_op(
    x: torch.Tensor, offsets: torch.Tensor, axis: int
) -> torch.Tensor:
    return torch.segment_reduce(
        x, "sum", offsets=offsets, axis=axis, unsafe=True
    )


@_segment_sum_op.register_vmap
def _segment_sum_vmap(info, in_dims, x, offsets, axis):
    x, offsets, _ = _batch_first(
        info.batch_size, in_dims, (x, offsets, axis)
    )
    return torch.segment_reduce(
        x, "sum", offsets=offsets.contiguous(), axis=axis + 1, unsafe=True
    ), 0


def segment_max(
    x: torch.Tensor, seg_ids: torch.Tensor, n_segments: int
) -> torch.Tensor:
    """[n_segments] maxima of the 1-D ``x`` grouped by ``seg_ids``: the
    JAX package's ``segment_max``.  An empty segment gives the dtype's
    lowest value, as in JAX: ``-inf`` for floats, ``INT32_MIN`` for int32
    (so an int32 flag cast to bool reads True there).  A scatter-max into
    the lowest value: exact in any order (only the sign of a zero maximum
    may vary, which no comparison sees), and one pass over ``x`` where a
    segmented reduction takes a thread block per segment."""
    lowest = (
        -torch.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
    )
    out = x.new_full((n_segments,), lowest)
    return out.scatter_reduce_(
        0, seg_ids.long(), x, "amax", include_self=True
    )


def segment_min(
    x: torch.Tensor, seg_ids: torch.Tensor, n_segments: int
) -> torch.Tensor:
    """[n_segments] minima of the 1-D ``x`` grouped by ``seg_ids``: the
    JAX package's ``segment_min``.  An empty segment gives the dtype's
    largest value, as in JAX (``inf``, ``INT32_MAX``).  A scatter-min,
    exact in any order, as ``segment_max``."""
    largest = (
        torch.inf if x.is_floating_point() else torch.iinfo(x.dtype).max
    )
    out = x.new_full((n_segments,), largest)
    return out.scatter_reduce_(
        0, seg_ids.long(), x, "amin", include_self=True
    )


def onto_layout(offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(perm, onto_offsets)`` of ``segment_sum_onto`` for the segments
    that ``offsets`` bound (host, numpy): segment ``k`` of ``cat([base,
    x])[perm]`` is ``base[k]`` followed by ``x[off[k]:off[k + 1]]``."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n_seg, n_x = len(offsets) - 1, int(offsets[-1])
    onto_offsets = offsets + np.arange(n_seg + 1)
    perm = np.empty(n_seg + n_x, dtype=np.int64)
    is_base = np.zeros(n_seg + n_x, dtype=bool)
    is_base[onto_offsets[:-1]] = True
    perm[is_base] = np.arange(n_seg)
    perm[~is_base] = n_seg + np.arange(n_x)
    return perm, onto_offsets


def segment_sum_onto(
    base: torch.Tensor, x: torch.Tensor, perm: torch.Tensor,
    onto_offsets: torch.Tensor, axis: int,
) -> torch.Tensor:
    """``base + segment sums of x`` along ``axis``, each segment summed in
    order starting from its base value: ``((base[k] + x[o]) + x[o + 1])
    ...``.  This is the order of the JAX package's jitted fan-ins: XLA
    folds ``base + segment_sum(x)`` into one scatter-add whose operand is
    ``base``.  ``perm`` and ``onto_offsets`` are ``onto_layout``'s (the
    offsets shaped for ``segment_reduce``: one row a lane on axis 1)."""
    ext = torch.index_select(torch.cat([base, x], dim=axis), axis, perm)
    return segment_sum(ext, onto_offsets, axis)


def segment_offsets(seg_ids: np.ndarray, n_segments: int) -> np.ndarray:
    """[n_segments + 1] int64 bounds of the segments of sorted
    ``seg_ids`` (host, numpy): segment ``k`` is rows
    ``off[k]:off[k + 1]``."""
    counts = np.bincount(
        np.asarray(seg_ids, dtype=np.int64), minlength=n_segments
    )
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _fan_in_total(
    dev: DeviceDCOP, unary: torch.Tensor, f2v: torch.Tensor,
    offsets: torch.Tensor, onto_offsets: torch.Tensor, axis: int,
) -> torch.Tensor:
    """MaxSum's fan-in plus the unary costs (``axis`` is the edge axis;
    the offsets shaped for ``segment_reduce`` on it), in the JAX
    package's jitted order: a float32 plane summed onto the unary costs;
    a bf16 plane (undamped under precision="bf16") summed on its own in
    bf16, each partial sum rounded, then added."""
    if f2v.dtype == torch.bfloat16:
        return segment_sum(f2v, offsets, axis) + unary
    return segment_sum_onto(
        unary, f2v, dev.fan_in_onto_perm, onto_offsets, axis
    )


def variable_step_with_select(
    dev: DeviceDCOP,
    f2v: torch.Tensor,
    damping: float = 0.0,
    prev_v2f: torch.Tensor = None,
    fma: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variable half-cycle on [n_edges, D] planes: fan-in (sorted
    segmented sum) plus unary costs, the argmin of that total as the
    per-variable values, and the variable->factor messages
    ``total[edge_var] - f2v``, mean-normalized and damped (``damp``'s
    ``fma``)."""
    total = _fan_in_total(
        dev, dev.unary, f2v, dev.fan_in_offsets, dev.fan_in_onto_offsets, 0
    )  # [n_vars, D]
    values = masked_argmin(total, dev.valid_mask)
    v2f = _normalize_v2f(
        total[dev.edge_var] - f2v, dev.valid_mask[dev.edge_var],
        dev.domain_size[dev.edge_var][:, None], 1, damping, prev_v2f, fma,
    )
    return v2f, values


def variable_step(
    dev: DeviceDCOP,
    f2v: torch.Tensor,
    damping: float = 0.0,
    prev_v2f: torch.Tensor = None,
) -> torch.Tensor:
    """``variable_step_with_select`` without the values."""
    return variable_step_with_select(dev, f2v, damping, prev_v2f)[0]


def select_values(dev: DeviceDCOP, f2v: torch.Tensor) -> torch.Tensor:
    """Best value index per variable from [n_edges, D] factor->variable
    messages."""
    total = _fan_in_total(
        dev, dev.unary, f2v, dev.fan_in_offsets, dev.fan_in_onto_offsets, 0
    )
    return masked_argmin(total, dev.valid_mask)


# ---------------------------------------------------------------------------
# Lanes layout: message planes [D, n_edges]
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LanesAux:
    """Static lane-major companions of a DeviceDCOP (built once per
    problem; ``unary_t`` is replaced by the noised plane at init)."""

    tables_t: Tuple[torch.Tensor, ...]  # per bucket [D**arity, n_c]
    # per bucket, per slot: the [n_c] int32 edge-id column (contiguous,
    # as the kernel takes it)
    edge_cols: Tuple[Tuple[torch.Tensor, ...], ...]
    unary_t: torch.Tensor  # [D, n_vars]
    valid_t: torch.Tensor  # [D, n_vars] bool
    fan_in_offsets_t: torch.Tensor  # [D, n_vars + 1] int64, a row a lane
    fan_in_onto_offsets_t: torch.Tensor  # [D, n_vars + 1], the same


def lanes_aux(dev: DeviceDCOP) -> LanesAux:
    d = dev.max_domain
    return LanesAux(
        tables_t=tuple(b.tables_flat.T.contiguous() for b in dev.buckets),
        edge_cols=tuple(
            tuple(
                b.edge_ids[:, s].to(torch.int32).contiguous()
                for s in range(b.arity)
            )
            for b in dev.buckets
        ),
        unary_t=dev.unary.T.contiguous(),
        valid_t=dev.valid_mask.T.contiguous(),
        fan_in_offsets_t=dev.fan_in_offsets.expand(d, -1).contiguous(),
        fan_in_onto_offsets_t=dev.fan_in_onto_offsets.expand(
            d, -1
        ).contiguous(),
    )


def _gather_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[:, idx]``."""
    return torch.index_select(x, 1, idx)


def factor_step_lanes(
    dev: DeviceDCOP, aux: LanesAux, v2f_t: torch.Tensor
) -> torch.Tensor:
    """``factor_step`` on [D, n_edges] planes.  Arity-2 buckets go through
    ``factor_arity2_minplus`` (the Hopper kernel on the card), other
    arities through the plain broadcast-add-min; both keep the
    association ``((T + m_0) + m_1) + ... - m_s``, so the result equals
    the JAX package's lanes step with or without its Pallas kernel."""
    d = dev.max_domain
    outs = []  # [D, n_c] blocks in (bucket, slot) order
    for bi, bucket in enumerate(dev.buckets):
        cols = aux.edge_cols[bi]
        if bucket.arity == 2:
            outs.extend(factor_arity2_minplus(v2f_t, *cols, aux.tables_t[bi]))
        else:
            outs.extend(
                minplus_marginals_plain(
                    aux.tables_t[bi], [_gather_cols(v2f_t, e) for e in cols]
                )
            )
    if not outs:
        return torch.zeros_like(v2f_t)
    stacked = torch.cat(outs + [outs[0].new_zeros((d, 1))], dim=1)
    return _gather_cols(stacked, dev.f2v_perm)


def variable_step_with_select_lanes(
    dev: DeviceDCOP,
    aux: LanesAux,
    f2v_t: torch.Tensor,
    damping: float = 0.0,
    prev_v2f_t: torch.Tensor = None,
    fma: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``variable_step_with_select`` on [D, n_edges] planes."""
    total = _fan_in_total(
        dev, aux.unary_t, f2v_t, aux.fan_in_offsets_t,
        aux.fan_in_onto_offsets_t, 1,
    )  # [D, n_vars]
    values = torch.argmin(
        torch.where(aux.valid_t, total, torch.inf), dim=0
    ).to(torch.int32)
    v2f_t = _normalize_v2f(
        _gather_cols(total, dev.edge_var) - f2v_t,
        _gather_cols(aux.valid_t, dev.edge_var),
        dev.domain_size[dev.edge_var][None, :], 0, damping, prev_v2f_t, fma,
    )
    return v2f_t, values


# ---------------------------------------------------------------------------
# ELL ("degree-bucketed") MaxSum layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EllLayout:
    """Host-side product of ``build_ell`` (numpy; static per problem)."""

    spans: Tuple[Tuple[int, int], ...]  # (n_vars, padded degree) per class
    n_pad: int  # total padded edge slots
    var_perm: np.ndarray  # [V] ell position -> original variable id
    pos_of_var: np.ndarray  # [V] original variable id -> ell position
    edge_orig: np.ndarray  # [n_pad] original edge id, -1 on padding slots
    pair_perm: np.ndarray  # [n_pad] int32 ell slot of the partner edge
    #                        (self on padding slots)
    tabs_t: np.ndarray  # [D, D, n_pad] tab[d_self, d_partner, slot]
    edge_valid_t: np.ndarray  # [D, n_pad] own-variable valid lanes
    valid_ell_t: np.ndarray  # [D, V] valid_mask in ell variable order
    dsize_edges: np.ndarray  # [n_pad] own-variable domain size (1 on pads)
    real_row: np.ndarray  # [1, n_pad] bool, False on padding slots


def build_ell(c: CompiledDCOP, n_shards: int = 1) -> EllLayout:
    """Compile the ELL edge ordering for a binary-constraint problem.

    Raises ValueError when any constraint bucket has arity != 2 or the
    problem has no edges.  Only the single-device layout is ported: the
    mesh-sharded variant (``n_shards > 1``) raises NotImplementedError."""
    if n_shards != 1:
        raise NotImplementedError(
            "build_ell: only the single-device layout (n_shards=1) is "
            "ported; the sharded ELL layout is a later slice"
        )
    if c.n_edges == 0:
        raise ValueError("ELL layout needs at least one edge")
    if any(b.arity != 2 for b in c.buckets):
        raise ValueError("ELL layout supports binary constraints only")
    if not np.all(np.diff(c.edge_var) >= 0):
        raise ValueError(
            "CompiledDCOP.edge_var must be sorted by variable id"
        )
    V, E, D = c.n_vars, c.n_edges, c.max_domain
    deg = np.asarray(c.var_degree, dtype=np.int64)
    cls = np.zeros(V, dtype=np.int64)
    nz = deg > 0
    # power-of-two degree classes bound padding waste to <2x; float log2 is
    # exact for any int below 2^53 so exact powers classify to themselves
    cls[nz] = (2 ** np.ceil(np.log2(deg[nz]))).astype(np.int64)
    order = np.lexsort((np.arange(V), cls))
    # edges are sorted by variable, so variable v's incidences are the
    # contiguous range starts[v]:starts[v]+deg[v]
    starts = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    spans: List[Tuple[int, int]] = []
    chunks: List[np.ndarray] = []
    for cval in np.unique(cls[order]):
        sel = order[cls[order] == cval]
        nb, db = len(sel), int(cval)
        spans.append((nb, db))
        if db == 0:
            continue
        idx = starts[sel][:, None] + np.arange(db)[None, :]
        valid = np.arange(db)[None, :] < deg[sel][:, None]
        chunks.append(np.where(valid, idx, -1).reshape(-1))
    var_perm = order.astype(np.int32)
    pos_of_var = np.empty(V, dtype=np.int32)
    pos_of_var[var_perm] = np.arange(V, dtype=np.int32)
    edge_orig = (
        np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)
    )
    n_pad = len(edge_orig)
    real = edge_orig >= 0
    eo = edge_orig[real]
    ell_of_edge = np.empty(E, dtype=np.int64)
    ell_of_edge[eo] = np.flatnonzero(real)
    # partner / slot / table lookup per original edge
    partner = np.empty(E, dtype=np.int64)
    slot_of = np.empty(E, dtype=np.int8)
    con_local = np.empty(E, dtype=np.int64)
    (b,) = c.buckets  # binary-only: exactly one bucket
    e0 = np.asarray(b.edge_ids[:, 0], dtype=np.int64)
    e1 = np.asarray(b.edge_ids[:, 1], dtype=np.int64)
    partner[e0], partner[e1] = e1, e0
    slot_of[e0], slot_of[e1] = 0, 1
    con_local[e0] = np.arange(len(e0))
    con_local[e1] = np.arange(len(e1))
    T3 = np.asarray(b.tables, dtype=c.float_dtype)  # [n_c, D, D]
    pair_perm = np.arange(n_pad, dtype=np.int32)
    pair_perm[real] = ell_of_edge[partner[eo]]
    # per-edge joint tables, own value on the leading axis: slot-1 edges
    # see the transposed table
    tabs = np.zeros((n_pad, D, D), dtype=c.float_dtype)
    t = T3[con_local[eo]]
    s1 = slot_of[eo] == 1
    t[s1] = np.swapaxes(t[s1], 1, 2)
    tabs[real] = t
    ev = np.asarray(c.edge_var, dtype=np.int64)[eo]
    edge_valid_t = np.zeros((D, n_pad), dtype=bool)
    edge_valid_t[:, real] = np.asarray(c.valid_mask)[ev].T
    dsize_edges = np.ones(n_pad, dtype=c.float_dtype)
    dsize_edges[real] = np.asarray(c.domain_size)[ev].astype(c.float_dtype)
    valid_ell = np.asarray(c.valid_mask)[var_perm]
    return EllLayout(
        spans=tuple(spans),
        n_pad=n_pad,
        var_perm=var_perm,
        pos_of_var=pos_of_var,
        edge_orig=edge_orig,
        pair_perm=pair_perm,
        tabs_t=np.ascontiguousarray(tabs.transpose(1, 2, 0)),
        edge_valid_t=edge_valid_t,
        valid_ell_t=np.ascontiguousarray(valid_ell.T),
        dsize_edges=dsize_edges,
        real_row=real[None, :],
    )


def factor_step_ell(
    tabs_t: torch.Tensor,
    pair_perm: torch.Tensor,
    real_row: torch.Tensor,
    v2f_t: torch.Tensor,
) -> torch.Tensor:
    """Factor half-cycle on ELL planes: the partner exchange (the one
    gather of the cycle) and the min-plus marginalization over the
    edge-major joint tables, as one ``ell_minplus`` call.  Padding slots
    emit exact zeros."""
    return ell_minplus(v2f_t, pair_perm, tabs_t, real_row)


def variable_step_with_select_ell(
    spans: Tuple[Tuple[int, int], ...],
    unary_ell_t: torch.Tensor,
    valid_ell_t: torch.Tensor,
    edge_valid_t: torch.Tensor,
    dsize_edges: torch.Tensor,
    pos_of_var: torch.Tensor,
    real_row: torch.Tensor,
    f2v_t: torch.Tensor,
    damping: float = 0.0,
    prev_v2f_t: torch.Tensor = None,
    fma: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variable half-cycle on ELL planes: per-class dense reshape-sums for
    the fan-in and broadcast for the fan-out (``hopper_kernels.
    ell_fan_in``: one launch over every class on the card), and ONE [V]
    gather mapping the argmin back to original variable order; damped
    against ``prev_v2f_t`` (``damp``'s ``fma``)."""
    tot, v2f_t = ell_fan_in(spans, unary_ell_t, f2v_t)
    values_ell = torch.argmin(
        torch.where(valid_ell_t, tot, torch.inf), dim=0
    ).to(torch.int32)
    values = values_ell[pos_of_var]
    mean = domain_sum(torch.where(edge_valid_t, v2f_t, 0.0), 0) / (
        torch.clamp(dsize_edges[None, :], min=1)
    )
    # invalid lanes of real slots block the partner min-plus with BIG;
    # padding slots stay exactly zero so fan-in sums and convergence
    # checks never see them
    v2f_t = torch.where(
        edge_valid_t, v2f_t - mean, real_row.to(v2f_t.dtype) * BIG
    )
    if damping and prev_v2f_t is not None:
        v2f_t = damp(damping, prev_v2f_t, v2f_t, fma)
    return v2f_t, values
