"""Shape buckets: power-of-two-rounded padded dims shared by a tenant fleet.

Counterpart of ``pydcop_tpu/serve/bucket.py``.  The batch engine captures
one prologue graph and one chunk graph per bucket (and per power-of-two
class of the batch size), so two problems share those graphs exactly
when their PADDED dims match.  ``bucket_dims_of`` derives a problem's
bucket by rounding every ``DeviceDCOP`` dimension up to a power of two
(less than 2x padding waste; the number of buckets a fleet can populate
grows only logarithmically with problem size); ``pad_dev_to_bucket``
then pads the instance with the cost-neutral dead rows of
``parallel.mesh.pad_device_dcop_to``: dead state, not masked state, so
the solvers need no changes.

``pad_ell_classes`` does the same for MaxSum's ELL layout: each degree
class's variable count is rounded up to a power of two with dummy
variables (slots masked dead exactly like ``build_ell``'s intra-class
padding), so two graphs with the same padded span signature share the
ELL step, and one span table serves a whole batch's fan-in.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from ..compile.kernels import DeviceDCOP, EllLayout
from ..parallel.mesh import pad_device_dcop_to

__all__ = [
    "BucketDims",
    "bucket_dims_of",
    "pad_dev_to_bucket",
    "pad_ell_classes",
    "padded_spans",
    "pow2",
]


def pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), floor)
    return 1 << max(0, n - 1).bit_length()


class BucketDims(NamedTuple):
    """The padded DeviceDCOP dims identifying one shape bucket (all
    power-of-two-rounded; equal dims and equal algorithm statics = the
    same captured graphs)."""

    n_vars: int
    n_edges: int
    n_constraints: int
    max_domain: int
    #: (arity, padded constraint rows) per arity bucket
    bucket_sig: Tuple[Tuple[int, int], ...]
    dtype: str


def bucket_dims_of(compiled) -> BucketDims:
    """Bucket of a CompiledDCOP: every dim of the device representation
    rounded up to a power of two (variables and constraints reserve the
    one dead row the padding needs)."""
    n_edges_dev = max(compiled.n_edges, 1)
    n_cons_dev = max(compiled.n_constraints, 1)
    sig = tuple(
        (b.arity, pow2(b.tables.shape[0])) for b in compiled.buckets
    )
    next_edge = n_edges_dev + sum(
        (rows - b.tables.shape[0]) * b.arity
        for (_, rows), b in zip(sig, compiled.buckets)
    )
    return BucketDims(
        n_vars=pow2(compiled.n_vars + 1),
        n_edges=pow2(next_edge),
        n_constraints=pow2(n_cons_dev + 1),
        max_domain=compiled.max_domain,
        bucket_sig=sig,
        dtype=np.dtype(compiled.float_dtype).name,
    )


def pad_dev_to_bucket(dev: DeviceDCOP, dims: BucketDims) -> DeviceDCOP:
    """Pad a device problem to its bucket's dims (cost-neutral dead rows;
    see ``parallel.mesh.pad_device_dcop_to``)."""
    return pad_device_dcop_to(
        dev,
        dims.n_vars,
        dims.n_edges,
        dims.n_constraints,
        tuple(rows for _, rows in dims.bucket_sig),
    )


def padded_spans(
    spans: Tuple[Tuple[int, int], ...]
) -> Tuple[Tuple[int, int], ...]:
    """ELL span signature with each degree class's variable count rounded
    up to a power of two: the MaxSum component of the bucket key."""
    return tuple((pow2(nb), db) for nb, db in spans)


def pad_ell_classes(ell: EllLayout) -> EllLayout:
    """Pad an ELL layout so each degree class holds a power-of-two
    variable count (``padded_spans`` of the original).

    The pad columns are dummy variables of their class's degree: their
    slots carry all-zero tables, are masked out of every mean and min
    (``edge_valid_t`` False, ``real_row`` False) and are their own
    pair-permutation partner, exactly like ``build_ell``'s intra-class
    degree padding: both message planes stay exactly zero there every
    cycle, so fan-in sums, convergence checks and trajectories are slot
    for slot those of the unpadded layout."""
    target = padded_spans(ell.spans)
    d = ell.tabs_t.shape[0]
    # old slot / variable-column index per NEW position, -1 on class pads
    slot_parts = []
    var_parts = []
    off_e = off_v = 0
    for (nb, db), (tb, _) in zip(ell.spans, target):
        pad_n = tb - nb
        if db > 0:
            slot_parts.append(np.arange(off_e, off_e + nb * db))
            if pad_n:
                slot_parts.append(np.full(pad_n * db, -1, dtype=np.int64))
        var_parts.append(np.arange(off_v, off_v + nb))
        if pad_n:
            var_parts.append(np.full(pad_n, -1, dtype=np.int64))
        off_e += nb * db
        off_v += nb
    slot_map = (
        np.concatenate(slot_parts).astype(np.int64)
        if slot_parts else np.zeros(0, dtype=np.int64)
    )
    var_map = np.concatenate(var_parts).astype(np.int64)
    n_pad_new = len(slot_map)
    real_slot = slot_map >= 0
    new_of_old = np.empty(ell.n_pad, dtype=np.int64)
    new_of_old[slot_map[real_slot]] = np.flatnonzero(real_slot)

    edge_orig = np.full(n_pad_new, -1, dtype=ell.edge_orig.dtype)
    edge_orig[real_slot] = ell.edge_orig[slot_map[real_slot]]
    pair_perm = np.arange(n_pad_new, dtype=np.int32)
    pair_perm[real_slot] = new_of_old[
        ell.pair_perm[slot_map[real_slot]]
    ].astype(np.int32)
    tabs_t = np.zeros((d, d, n_pad_new), dtype=ell.tabs_t.dtype)
    tabs_t[:, :, real_slot] = ell.tabs_t[:, :, slot_map[real_slot]]
    edge_valid_t = np.zeros((d, n_pad_new), dtype=bool)
    edge_valid_t[:, real_slot] = ell.edge_valid_t[:, slot_map[real_slot]]
    dsize_edges = np.ones(n_pad_new, dtype=ell.dsize_edges.dtype)
    dsize_edges[real_slot] = ell.dsize_edges[slot_map[real_slot]]
    real_row = np.zeros((1, n_pad_new), dtype=bool)
    real_row[0, real_slot] = ell.real_row[0, slot_map[real_slot]]

    real_var = var_map >= 0
    var_perm = np.zeros(len(var_map), dtype=np.int32)
    var_perm[real_var] = ell.var_perm[var_map[real_var]]
    valid_ell = np.zeros((d, len(var_map)), dtype=bool)
    valid_ell[:, real_var] = ell.valid_ell_t[:, var_map[real_var]]
    valid_ell[0, ~real_var] = True  # pad columns: unread argmin lands on 0
    pos_of_var = np.empty(len(ell.pos_of_var), dtype=np.int32)
    new_var_pos = np.flatnonzero(real_var).astype(np.int32)
    pos_of_var[var_perm[real_var]] = new_var_pos[
        np.arange(real_var.sum())
    ]
    return EllLayout(
        spans=target,
        n_pad=n_pad_new,
        var_perm=var_perm,
        pos_of_var=pos_of_var,
        edge_orig=edge_orig,
        pair_perm=pair_perm,
        tabs_t=tabs_t,
        edge_valid_t=edge_valid_t,
        valid_ell_t=valid_ell,
        dsize_edges=dsize_edges,
        real_row=real_row,
    )
