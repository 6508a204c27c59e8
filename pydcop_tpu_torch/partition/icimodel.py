"""Analytic ICI model: cross-shard bytes per cycle from a partition.

The port's copy of ``pydcop_tpu/partition/icimodel.py``.  "ICI" names the
link between the shards of a sharded solve (NVLink between cards); the
model depends only on the partition, the domain and the plane dtype.

The sharded ELL MaxSum cycle performs exactly ONE cross-shard data
motion: the pair-permutation gather of the variable->factor message
plane.  Every edge slot whose partner variable lives on another shard
pulls that partner's ``[D]`` message column across once per cycle, so
the traffic is a pure function of the partition, the domain size and the
plane dtype:

    bytes/cycle = cross_slots * D * itemsize

with ``cross_slots`` = the number of (constraint, slot) incidences whose
two scope variables land in different parts (for binary constraints,
twice the edge cut).  ``ici_block`` is the ``partition`` block of the
capture records (configs 4 and 9 of ``tools/capture_configs.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["plane_itemsize", "ici_model", "ici_block"]


def plane_itemsize(compiled, plane_dtype: str = "f32") -> int:
    """Bytes per message-plane element: the solve-time plane dtype when
    given ("bf16" halves the gather traffic), else the compiled float
    dtype."""
    if plane_dtype == "bf16":
        return 2
    return int(np.dtype(compiled.float_dtype).itemsize)


# graftflow: batchable
def cross_bytes_per_cycle(
    cross_slots, max_domain: int, itemsize: int
):
    """Modeled ICI bytes per solver cycle for a given cross-slot count —
    elementwise, so it maps over batched counts unchanged."""
    return cross_slots * max_domain * itemsize


def ici_model(
    compiled,
    assign: Optional[np.ndarray],
    n_shards: int,
    plane_dtype: str = "f32",
) -> Dict[str, float]:
    """Modeled per-cycle ICI traffic of a sharded ELL solve under a
    partition.

    ``assign`` is the per-variable part id in the compiled problem's
    numbering; ``None`` means the contiguous row-chunk blocking of the
    CURRENT numbering (what ``build_ell`` does by default).  Returns
    ``incidence`` (fraction of edge slots whose partner is cross-shard —
    comparable 1:1 with ``ell_cross_shard_frac``), ``cross_slots``,
    ``total_slots`` and ``bytes_per_cycle``."""
    if n_shards <= 1 or compiled.n_edges == 0:
        return {
            "n_shards": int(n_shards),
            "incidence": 0.0,
            "cross_slots": 0,
            "total_slots": int(compiled.n_edges),
            "bytes_per_cycle": 0,
        }
    n = compiled.n_vars
    if assign is None:
        chunk = (n + n_shards) // n_shards
        assign = np.minimum(
            np.arange(n) // chunk, n_shards - 1
        )
    else:
        assign = np.asarray(assign, dtype=np.int64)
        if assign.shape != (n,):
            raise ValueError(
                f"assign must be [{n}] per-variable part ids, got "
                f"shape {assign.shape}"
            )
    cross = 0
    total = 0
    for b in compiled.buckets:
        if b.arity < 2 or b.n_constraints == 0:
            continue
        parts = assign[b.var_slots]  # [n_c, a]
        # a slot is cross when any scope partner is in another part
        # (arity 2: both slots cross iff the two vars differ)
        mismatch = (parts[:, :, None] != parts[:, None, :]).any(axis=2)
        cross += int(mismatch.sum())
        total += int(parts.size)
    itemsize = plane_itemsize(compiled, plane_dtype)
    return {
        "n_shards": int(n_shards),
        "incidence": (cross / total) if total else 0.0,
        "cross_slots": cross,
        "total_slots": total,
        "bytes_per_cycle": int(
            cross_bytes_per_cycle(cross, compiled.max_domain, itemsize)
        ),
    }


def ici_block(
    compiled,
    n_shards: int,
    plane_dtype: str = "f32",
    strategies: tuple = ("bfs", "multilevel"),
    effort: str = "fast",
) -> Dict[str, object]:
    """The ``partition`` block of bench/MULTICHIP records: order wall,
    cross-shard incidence and modeled ICI bytes/cycle per strategy, side
    by side (ROADMAP item 2's explicit ask).  ``effort`` is forwarded to
    the multilevel partitioner ("fast" skips the pairwise-polish stages
    — about half the wall for ~1% worse cut, the right default inside
    bench loops)."""
    import time

    from .multilevel import ell_shard_assignment, partition_order

    out: Dict[str, object] = {
        "n_shards": int(n_shards),
        "plane_dtype": plane_dtype,
        "n_vars": int(compiled.n_vars),
        "n_edges": int(compiled.n_edges),
    }
    for strategy in strategies:
        t0 = time.perf_counter()
        if strategy == "bfs":
            # one source of truth with the solver's blocking rule
            assign, _tag = ell_shard_assignment(
                compiled, n_shards, None, "bfs"
            )
        elif strategy == "multilevel":
            _, assign, _ = partition_order(
                compiled, n_shards, effort=effort
            )
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
        wall = time.perf_counter() - t0
        model = ici_model(compiled, assign, n_shards, plane_dtype)
        out[strategy] = {
            "order_wall_s": round(wall, 4),
            "incidence": round(model["incidence"], 4),
            "cross_slots": model["cross_slots"],
            "ici_bytes_per_cycle": model["bytes_per_cycle"],
        }
    return out
