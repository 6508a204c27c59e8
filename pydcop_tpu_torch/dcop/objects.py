"""DCOP model objects: the minimal ``Domain``.

Counterpart of ``pydcop_tpu/dcop/objects.py`` (``Domain`` only): the
compiled representation keeps one ``Domain`` per variable so a solve can
decode value indices back to domain values
(``CompiledDCOP.assignment_from_indices``).  Variables, agents and the
object-level DCOP are a later slice of the port.
"""

from __future__ import annotations

from typing import Iterable, Tuple

__all__ = ["Domain"]


class Domain:
    """A named, ordered, finite set of values.

    >>> d = Domain('colors', 'color', ['R', 'G', 'B'])
    >>> len(d), d.index('G'), d.values[2]
    (3, 1, 'B')
    """

    def __init__(self, name: str, domain_type: str, values: Iterable) -> None:
        self._name = name
        self._domain_type = domain_type
        self._values = tuple(values)
        self._index = {v: i for i, v in enumerate(self._values)}

    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return self._domain_type

    @property
    def values(self) -> Tuple:
        return self._values

    def index(self, value) -> int:
        try:
            return self._index[value]
        except KeyError:
            raise ValueError(f"{value!r} is not in domain {self._name}")

    def __len__(self) -> int:
        return len(self._values)

    def __repr__(self) -> str:
        return f"Domain({self._name}, {self._domain_type}, {self._values})"
