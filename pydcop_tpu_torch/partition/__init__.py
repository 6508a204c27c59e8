"""Multilevel graph partitioning and the analytic cross-shard model.

Counterpart of ``pydcop_tpu/partition/``: ``multilevel_assign``, the
k-way partitioner into parts of exact sizes (``distribution.tpu_part``
places computations on agents with it); the row orderings of a sharded
ELL layout (``variable_graph``, ``chunk_targets``, ``partition_order``,
``ell_shard_assignment``); and ``icimodel``, the cross-shard bytes a
cycle of a partition (``ici_model``, ``ici_block``).  The sharded solve
those orderings feed is not ported.
"""

from .icimodel import ici_block, ici_model, plane_itemsize
from .multilevel import (
    chunk_targets,
    ell_shard_assignment,
    multilevel_assign,
    partition_order,
    variable_graph,
)

__all__ = [
    "chunk_targets",
    "ell_shard_assignment",
    "ici_block",
    "ici_model",
    "multilevel_assign",
    "partition_order",
    "plane_itemsize",
    "variable_graph",
]
