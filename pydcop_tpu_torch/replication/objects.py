"""Replica-distribution objects.

The port's copy of ``pydcop_tpu/replication/objects.py`` (pyDCOP's
``ReplicaDistribution``): the mapping {computation -> [replica host
agents]} produced by replica placement, consumed by the repair.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from ..utils.simple_repr import SimpleRepr

__all__ = ["ReplicaDistribution"]

class ReplicaDistribution(SimpleRepr):
    _repr_fields = ("mapping",)

    def __init__(self, mapping: Dict[str, Iterable[str]]) -> None:
        self._mapping: Dict[str, List[str]] = {
            c: list(agents) for c, agents in mapping.items()
        }

    @property
    def mapping(self) -> Dict[str, List[str]]:
        return {c: list(a) for c, a in self._mapping.items()}

    @property
    def computations(self) -> List[str]:
        return list(self._mapping)

    def agents_for_computation(self, computation: str) -> List[str]:
        return list(self._mapping[computation])

    def replica_count(self, computation: str) -> int:
        return len(self._mapping.get(computation, []))

    def computations_for_agent(self, agent: str) -> List[str]:
        return [
            c for c, agents in self._mapping.items() if agent in agents
        ]

    @classmethod
    def _from_repr(cls, mapping):
        return cls(mapping)

    def __eq__(self, other):
        return (
            isinstance(other, ReplicaDistribution)
            and other._mapping == self._mapping
        )

    def __repr__(self) -> str:
        return f"ReplicaDistribution({self._mapping})"
