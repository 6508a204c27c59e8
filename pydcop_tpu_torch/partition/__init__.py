"""Multilevel graph partitioning.

Counterpart of ``pydcop_tpu/partition/``, the part that
``distribution.tpu_part`` needs: ``multilevel_assign``, the k-way
partitioner into parts of exact sizes.  The sharded ELL layout's row
orderings and the ICI cost model are not ported.
"""

from .multilevel import multilevel_assign

__all__ = ["multilevel_assign"]
