"""Distribution hints, as the YAML loader reads them.

Counterpart of ``DistributionHints`` in ``pydcop_tpu/distribution/objects.py``,
copied: the loader validates a file's ``distribution_hints`` block and
keeps it on the ``DCOP``.  The distribution layer itself (placement of
computations on agents) is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..utils.simple_repr import SimpleRepr

__all__ = ["DistributionHints"]


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
