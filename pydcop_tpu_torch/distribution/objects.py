"""Distribution objects: computations mapped onto agents, and hints.

Counterpart of ``pydcop_tpu/distribution/objects.py``, copied:
``Distribution`` (agent -> computations, with the reverse lookup) is what
``distribution.tpu_part`` returns, ``ImpossibleDistributionException``
what it raises, and ``DistributionHints`` what the YAML loader keeps
from a file's ``distribution_hints`` block.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..utils.simple_repr import SimpleRepr

__all__ = [
    "Distribution",
    "DistributionHints",
    "ImpossibleDistributionException",
]


class ImpossibleDistributionException(Exception):
    pass


class Distribution(SimpleRepr):
    """{agent name -> list of computation names}, with reverse lookup.

    >>> d = Distribution({'a1': ['c1', 'c2'], 'a2': ['c3']})
    >>> d.agent_for('c3')
    'a2'
    >>> sorted(d.computations_hosted('a1'))
    ['c1', 'c2']
    """

    _repr_fields = ("mapping",)

    def __init__(self, mapping: Dict[str, List[str]]) -> None:
        self._mapping: Dict[str, List[str]] = {
            a: list(cs) for a, cs in mapping.items()
        }
        self._by_computation: Dict[str, str] = {}
        for a, cs in self._mapping.items():
            for c in cs:
                if c in self._by_computation:
                    raise ValueError(
                        f"computation {c} hosted on both "
                        f"{self._by_computation[c]} and {a}"
                    )
                self._by_computation[c] = a

    @property
    def mapping(self) -> Dict[str, List[str]]:
        return {a: list(cs) for a, cs in self._mapping.items()}

    @property
    def agents(self) -> List[str]:
        return list(self._mapping)

    @property
    def computations(self) -> List[str]:
        return list(self._by_computation)

    def agent_for(self, computation: str) -> str:
        try:
            return self._by_computation[computation]
        except KeyError:
            raise KeyError(f"computation {computation} not distributed")

    def has_computation(self, computation: str) -> bool:
        return computation in self._by_computation

    def computations_hosted(self, agent: str) -> List[str]:
        return list(self._mapping.get(agent, []))

    def host_on_agent(self, agent: str, computations: List[str]) -> None:
        for c in computations:
            prev = self._by_computation.get(c)
            if prev is not None:
                self._mapping[prev].remove(c)
            self._by_computation[c] = agent
            self._mapping.setdefault(agent, []).append(c)

    def remove_computation(self, computation: str) -> None:
        agent = self._by_computation.pop(computation)
        self._mapping[agent].remove(computation)

    def remove_agent(self, agent: str) -> List[str]:
        orphaned = self._mapping.pop(agent, [])
        for c in orphaned:
            del self._by_computation[c]
        return orphaned

    def is_hosted(self, computations) -> bool:
        if isinstance(computations, str):
            computations = [computations]
        return all(c in self._by_computation for c in computations)

    def __eq__(self, other):
        return (
            isinstance(other, Distribution)
            and other._by_computation == self._by_computation
        )

    def __repr__(self) -> str:
        return f"Distribution({self._mapping})"


class DistributionHints(SimpleRepr):
    """User-provided placement hints: ``must_host`` (agent -> computations that
    must run there) and ``host_with`` (computation -> computations to colocate)."""

    _repr_fields = ("must_host", "host_with")

    def __init__(
        self,
        must_host: Optional[Dict[str, List[str]]] = None,
        host_with: Optional[Dict[str, List[str]]] = None,
    ) -> None:
        self._must_host = {a: list(cs) for a, cs in (must_host or {}).items()}
        self._host_with = {c: list(cs) for c, cs in (host_with or {}).items()}

    @property
    def must_host(self) -> Dict[str, List[str]]:
        return {a: list(cs) for a, cs in self._must_host.items()}

    @property
    def host_with(self) -> Dict[str, List[str]]:
        return {c: list(cs) for c, cs in self._host_with.items()}

    def must_host_on(self, agent: str) -> List[str]:
        return list(self._must_host.get(agent, []))

    def host_with_computation(self, computation: str) -> List[str]:
        # colocation is symmetric: union of both directions
        out = set(self._host_with.get(computation, []))
        for c, cs in self._host_with.items():
            if computation in cs:
                out.add(c)
        out.discard(computation)
        return sorted(out)

    def __eq__(self, other):
        return (
            isinstance(other, DistributionHints)
            and other._must_host == self._must_host
            and other._host_with == self._host_with
        )
