"""Cost-neutral padding of a ``DeviceDCOP`` to explicit dimensions.

Counterpart of ``pad_device_dcop_to`` and ``_pad_device_dcop_to`` in
``pydcop_tpu/parallel/mesh.py``: the serving layer pads every instance of
a shape bucket to the same power-of-two dimensions, so a fleet of tenants
shares one pair of captured graphs.  The padding is dead state, not
masked state, so no solver changes for it:

- dead variables have a one-value domain (slot 0 valid), zero unary
  costs and degree 0, so they never move and cost nothing;
- padded constraint rows of a bucket have all-zero tables, their slots
  on the first dead variable and their constraint id on the first dead
  constraint; each slot gets its own edge row;
- edge rows past the padded buckets' belong to the first dead variable
  and the first dead constraint, and read the sentinel zero row of
  ``f2v_perm``.

Every padded edge belongs to the first dead variable, whose id exceeds
every real one, so the edges stay sorted by variable; ``f2v_perm`` and
the fan-in segment layouts are rebuilt at the padded size.  The
mesh-sharded layouts of the JAX module are not ported (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..compile.kernels import (
    DeviceBucket,
    DeviceDCOP,
    build_f2v_perm,
    onto_layout,
    segment_offsets,
)

__all__ = ["pad_device_dcop_to"]


def pad_device_dcop_to(
    dev: DeviceDCOP,
    n_vars: int,
    n_edges: int,
    n_constraints: int,
    bucket_rows: Sequence[int],
) -> DeviceDCOP:
    """``dev`` padded to the target dims with cost-neutral dead rows;
    ``bucket_rows`` gives the target constraint rows of each arity
    bucket (aligned with ``dev.buckets``).  The targets must leave at
    least one dead variable and one dead constraint, and room for every
    padded bucket slot's edge row."""
    if n_vars <= dev.n_vars:
        raise ValueError(
            f"target n_vars {n_vars} must exceed {dev.n_vars} (the pad "
            "reserves at least one dead variable row)"
        )
    if n_constraints <= dev.n_constraints:
        raise ValueError(
            f"target n_constraints {n_constraints} must exceed "
            f"{dev.n_constraints}"
        )
    if len(bucket_rows) != len(dev.buckets):
        raise ValueError(
            f"{len(bucket_rows)} bucket row targets for "
            f"{len(dev.buckets)} arity buckets"
        )
    next_edge = dev.n_edges + sum(
        (r - b.tables_flat.shape[0]) * b.arity
        for r, b in zip(bucket_rows, dev.buckets)
    )
    if n_edges < next_edge:
        raise ValueError(
            f"target n_edges {n_edges} cannot hold {next_edge} rows "
            "(real edges + padded bucket slots)"
        )
    for r, b in zip(bucket_rows, dev.buckets):
        if r < b.tables_flat.shape[0]:
            raise ValueError(
                f"bucket row target {r} below real row count "
                f"{b.tables_flat.shape[0]}"
            )
    return _pad_device_dcop_to(
        dev, n_vars, n_edges, n_constraints, tuple(bucket_rows)
    )


def _pad_rows(x: torch.Tensor, n: int, value) -> torch.Tensor:
    if n == 0:
        return x
    return torch.cat([x, x.new_full((n,) + tuple(x.shape[1:]), value)])


def _pad_device_dcop_to(
    dev: DeviceDCOP,
    n_vars_p: int,
    n_edges_p: int,
    n_cons_p: int,
    bucket_rows: Sequence[int],
) -> DeviceDCOP:
    pad_v = n_vars_p - dev.n_vars
    dead_var = dev.n_vars  # first dead variable id
    dead_con = dev.n_constraints
    device = dev.unary.device

    # bucket padding first: each padded constraint slot gets its own edge
    next_edge = dev.n_edges
    buckets = []
    for n_c_p, b in zip(bucket_rows, dev.buckets):
        pad_c = n_c_p - b.tables_flat.shape[0]
        if pad_c == 0:
            buckets.append(b)
            continue
        pad_edge_ids = next_edge + torch.arange(
            pad_c * b.arity, dtype=b.edge_ids.dtype, device=device
        ).reshape(pad_c, b.arity)
        next_edge += pad_c * b.arity
        buckets.append(DeviceBucket(
            arity=b.arity,
            tables_flat=_pad_rows(b.tables_flat, pad_c, 0.0),
            var_slots=_pad_rows(b.var_slots, pad_c, dead_var),
            edge_ids=torch.cat([b.edge_ids, pad_edge_ids]),
            con_ids=_pad_rows(b.con_ids, pad_c, dead_con),
        ))

    pad_e = n_edges_p - dev.n_edges
    valid_pad = torch.zeros(
        (pad_v, dev.max_domain), dtype=torch.bool, device=device
    )
    valid_pad[:, 0] = True  # one-value dead domain
    edge_var = _pad_rows(dev.edge_var, pad_e, dead_var)
    offsets = segment_offsets(edge_var.cpu().numpy(), n_vars_p)
    onto_perm, onto_offsets = onto_layout(offsets)

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return dataclasses.replace(
        dev,
        n_vars=n_vars_p,
        n_edges=n_edges_p,
        n_constraints=n_cons_p,
        domain_size=_pad_rows(dev.domain_size, pad_v, 1),
        valid_mask=torch.cat([dev.valid_mask, valid_pad]),
        unary=_pad_rows(dev.unary, pad_v, 0.0),
        edge_var=edge_var,
        edge_con=_pad_rows(dev.edge_con, pad_e, dead_con),
        var_degree=_pad_rows(dev.var_degree, pad_v, 0),
        buckets=tuple(buckets),
        # rebuilt at the padded size: padded bucket rows get real stacked
        # positions, wholly dead edge rows the sentinel
        f2v_perm=idx(build_f2v_perm(
            [b.edge_ids.cpu().numpy() for b in buckets], n_edges_p
        )),
        fan_in_offsets=idx(offsets),
        fan_in_onto_perm=idx(onto_perm),
        fan_in_onto_offsets=idx(onto_offsets),
    )
