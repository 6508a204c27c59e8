"""Device representation and the device ops of the MaxSum ELL cycle.

Counterpart of ``pydcop_tpu/compile/kernels.py``:

- ``DeviceDCOP``/``DeviceBucket``: the compiled arrays as tensors on one
  torch device (``to_device``).
- ``evaluate``: the total cost of a full assignment, run once per cycle
  for anytime-best tracking.
- the ELL ("degree-bucketed") layout: ``build_ell`` (host, numpy) orders
  edge slots by variable and pads each variable to a power-of-two degree
  class, so the variable fan-in is a dense reshape-sum per class, the
  fan-out a broadcast, and the factor exchange ONE permutation gather to
  the partner slot.  ``factor_step_ell`` is that gather plus the min-plus
  marginalization, run by the Hopper kernel ``hopper_kernels.ell_minplus``
  on the card; ``variable_step_with_select_ell`` is the variable half.

Binary constraints only.  Padding slots carry exact zeros in both message
planes every cycle, so fan-in sums and convergence checks never see them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .core import BIG, CompiledDCOP
from .hopper_kernels import ell_minplus

__all__ = [
    "DeviceBucket",
    "DeviceDCOP",
    "resolve_device",
    "to_device",
    "take_rows",
    "masked_argmin",
    "evaluate",
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


@dataclass(frozen=True)
class DeviceDCOP:
    """The arrays of a ``CompiledDCOP`` that the ELL cycle reads on the
    device (the edge-list arrays serve only the host-side ELL build)."""

    n_vars: int
    max_domain: int
    valid_mask: torch.Tensor  # [n_vars, D] bool
    unary: torch.Tensor  # [n_vars, D] float32
    constant_cost: torch.Tensor  # scalar float32
    buckets: Tuple[DeviceBucket, ...]


def to_device(c: CompiledDCOP, device="cuda") -> DeviceDCOP:
    """The compiled arrays as tensors on ``device``."""
    device = resolve_device(device)
    fdt = torch.float32
    buckets = tuple(
        DeviceBucket(
            arity=b.arity,
            tables_flat=torch.as_tensor(
                b.tables.reshape(b.tables.shape[0], -1), dtype=fdt,
                device=device,
            ),
            var_slots=torch.as_tensor(
                b.var_slots.astype(np.int64), device=device
            ),
        )
        for b in c.buckets
    )
    return DeviceDCOP(
        n_vars=c.n_vars,
        max_domain=c.max_domain,
        valid_mask=torch.as_tensor(c.valid_mask, device=device),
        unary=torch.as_tensor(c.unary, dtype=fdt, device=device),
        constant_cost=torch.tensor(c.constant_cost, dtype=fdt, device=device),
        buckets=buckets,
    )


def _strides(arity: int, d: int) -> List[int]:
    """C-order strides of a [D]*arity block."""
    return [d ** (arity - 1 - t) for t in range(arity)]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=-1)``: per-row table reads."""
    return torch.gather(x, -1, idx.long())


def _bucket_costs(
    bucket: DeviceBucket, d: int, values: torch.Tensor
) -> torch.Tensor:
    """[n_c] cost of each constraint in the bucket under ``values``."""
    strides = torch.tensor(
        _strides(bucket.arity, d), dtype=torch.int64,
        device=values.device,
    )
    vals = values.long()[bucket.var_slots]  # [n_c, a]
    flat = (vals * strides).sum(dim=1)
    return take_rows(bucket.tables_flat, flat[:, None])[:, 0]


def evaluate(dev: DeviceDCOP, values: torch.Tensor) -> torch.Tensor:
    """Scalar total cost (min-form) of a full assignment: unary +
    constraints + constant, summed per bucket (no scatter)."""
    unary_cost = take_rows(dev.unary, values[:, None])[:, 0].sum()
    cons = sum(
        _bucket_costs(b, dev.max_domain, values).sum() for b in dev.buckets
    )
    return unary_cost + cons + dev.constant_cost


def masked_argmin(
    costs: torch.Tensor, valid_mask: torch.Tensor
) -> torch.Tensor:
    """Argmin over the valid domain slots of each row (int32; the first
    index on ties)."""
    masked = torch.where(valid_mask, costs, torch.inf)
    return torch.argmin(masked, dim=-1).to(torch.int32)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variable half-cycle on ELL planes: per-class dense reshape-sums for
    the fan-in, broadcast for the fan-out, and ONE [V] gather mapping the
    argmin back to original variable order."""
    d = f2v_t.shape[0]
    tot_parts, v2f_parts = [], []
    off_e = off_v = 0
    for nb, db in spans:  # every span has nb >= 1
        u = unary_ell_t[:, off_v:off_v + nb]
        if db == 0:
            tot_parts.append(u)
        else:
            seg = f2v_t[:, off_e:off_e + nb * db].reshape(d, nb, db)
            tot_b = seg.sum(dim=2) + u
            tot_parts.append(tot_b)
            v2f_parts.append((tot_b[:, :, None] - seg).reshape(d, nb * db))
        off_e += nb * db
        off_v += nb
    tot = torch.cat(tot_parts, dim=1)
    values_ell = torch.argmin(
        torch.where(valid_ell_t, tot, torch.inf), dim=0
    ).to(torch.int32)
    values = values_ell[pos_of_var]
    v2f_t = torch.cat(v2f_parts, dim=1)
    mean = torch.where(edge_valid_t, v2f_t, 0.0).sum(
        dim=0, keepdim=True
    ) / torch.clamp(dsize_edges[None, :], min=1)
    # invalid lanes of real slots block the partner min-plus with BIG;
    # padding slots stay exactly zero so fan-in sums and convergence
    # checks never see them
    v2f_t = torch.where(
        edge_valid_t, v2f_t - mean, real_row.to(v2f_t.dtype) * BIG
    )
    if damping and prev_v2f_t is not None:
        v2f_t = damping * prev_v2f_t + (1.0 - damping) * v2f_t
    return v2f_t, values
