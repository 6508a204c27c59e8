"""Lightweight object <-> plain-data serialization.

Counterpart of ``pydcop_tpu/utils/simple_repr.py``, copied: model objects
(variables, constraints, agent definitions, algorithm definitions) must
round-trip through plain dicts/lists so they can be written to YAML/JSON.
Classes declare ``_repr_fields`` (constructor kwarg names) or override
``_simple_repr_extra``; a module-qualified ``__qualname__`` key makes
``from_repr`` self-describing.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

__all__ = ["SimpleRepr", "simple_repr", "from_repr", "SimpleReprException"]


class SimpleReprException(Exception):
    pass


def _encode(value: Any) -> Any:
    if isinstance(value, SimpleRepr):
        return simple_repr(value)
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, frozenset):
        return sorted(_encode(v) for v in value)
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    # numpy scalars and arrays
    item = getattr(value, "item", None)
    if item is not None and getattr(value, "shape", None) == ():
        return value.item()
    tolist = getattr(value, "tolist", None)
    if tolist is not None:
        return value.tolist()
    raise SimpleReprException(f"cannot build a simple repr for {value!r}")


def _decode(value: Any) -> Any:
    if isinstance(value, dict):
        if "__qualname__" in value:
            return from_repr(value)
        return {k: _decode(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v) for v in value]
    return value


class SimpleRepr:
    """Mixin: subclasses set ``_repr_fields`` = tuple of constructor kwargs,
    each matching an attribute named either ``<field>`` or ``_<field>``."""

    _repr_fields: tuple = ()

    def _simple_repr(self) -> Dict[str, Any]:
        r: Dict[str, Any] = {
            "__qualname__": type(self).__qualname__,
            "__module__": type(self).__module__,
        }
        for field in self._repr_fields:
            if hasattr(self, field):
                v = getattr(self, field)
            elif hasattr(self, "_" + field):
                v = getattr(self, "_" + field)
            else:
                raise SimpleReprException(
                    f"{type(self).__name__} declares repr field {field!r} "
                    "but has no matching attribute"
                )
            r[field] = _encode(v)
        return r


def simple_repr(obj: Any) -> Any:
    if isinstance(obj, SimpleRepr):
        return obj._simple_repr()
    return _encode(obj)


def from_repr(r: Any) -> Any:
    if not isinstance(r, dict) or "__qualname__" not in r:
        return _decode(r)
    module = importlib.import_module(r["__module__"])
    cls = module
    for part in r["__qualname__"].split("."):
        cls = getattr(cls, part)
    kwargs = {
        k: _decode(v)
        for k, v in r.items()
        if k not in ("__qualname__", "__module__")
    }
    build = getattr(cls, "_from_repr", None)
    if build is not None:
        return build(**kwargs)
    return cls(**kwargs)
