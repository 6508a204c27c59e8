"""Algorithm parameter definitions, the solve result and the registry.

Counterpart of ``pydcop_tpu/algorithms/__init__.py`` (``AlgoParameterDef``,
``check_param_value``, ``prepare_algo_params``, ``AlgorithmDef``,
``ComputationDef``, ``SolveResult``, ``load_algorithm_module``).  An algorithm module exports ``GRAPH_TYPE``,
``algo_params`` and ``solve(compiled, params, n_cycles, seed, ...,
device=...)``.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

from ..utils.simple_repr import SimpleRepr

__all__ = [
    "AlgoParameterDef",
    "AlgorithmDef",
    "ComputationDef",
    "SolveResult",
    "check_param_value",
    "load_algorithm_module",
    "prepare_algo_params",
    "warn_inert_params",
]


class AlgoParameterDef(NamedTuple):
    """Typed declaration of one algorithm parameter."""

    name: str
    type: str  # 'str' | 'int' | 'float' | 'bool'
    values: Optional[List[Any]] = None  # allowed values, if enumerated
    default_value: Any = None


def check_param_value(value: Any, param_def: AlgoParameterDef) -> Any:
    """Coerce + validate one parameter value against its definition."""
    if value is None:
        return param_def.default_value
    try:
        if param_def.type == "int":
            coerced: Any = int(value)
        elif param_def.type == "float":
            coerced = float(value)
        elif param_def.type == "bool":
            if isinstance(value, str):
                low = value.lower()
                if low in ("true", "1", "yes"):
                    coerced = True
                elif low in ("false", "0", "no"):
                    coerced = False
                else:
                    raise ValueError(value)
            else:
                coerced = bool(value)
        else:
            coerced = str(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"invalid value {value!r} for parameter {param_def.name} "
            f"(expected {param_def.type})"
        )
    if param_def.values is not None and coerced not in param_def.values:
        raise ValueError(
            f"invalid value {coerced!r} for parameter {param_def.name}: "
            f"allowed values are {param_def.values}"
        )
    return coerced


def prepare_algo_params(
    params: Dict[str, Any], params_defs: Sequence[AlgoParameterDef]
) -> Dict[str, Any]:
    """Full param dict: defaults applied, unknown names rejected, values
    validated.

    >>> defs = [AlgoParameterDef('variant', 'str', ['A', 'B'], 'A'),
    ...         AlgoParameterDef('p', 'float', None, 0.7)]
    >>> prepare_algo_params({'p': '0.5'}, defs) == \
            {'variant': 'A', 'p': 0.5}
    True
    """
    defs = {p.name: p for p in params_defs}
    unknown = set(params) - set(defs)
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {sorted(unknown)}; "
            f"supported: {sorted(defs)}"
        )
    return {
        name: check_param_value(params.get(name), p)
        for name, p in defs.items()
    }


class AlgorithmDef(SimpleRepr):
    """An algorithm selection: name + mode (min/max) + validated params."""

    _repr_fields = ("algo", "mode", "params")

    def __init__(
        self,
        algo: str,
        params: Optional[Dict[str, Any]] = None,
        mode: str = "min",
    ) -> None:
        self._algo = algo
        self._mode = mode
        self._params = dict(params or {})

    @classmethod
    def build_with_default_param(
        cls,
        algo: str,
        params: Optional[Dict[str, Any]] = None,
        mode: str = "min",
        parameters_definitions: Optional[Sequence[AlgoParameterDef]] = None,
    ) -> "AlgorithmDef":
        if parameters_definitions is None:
            parameters_definitions = load_algorithm_module(algo).algo_params
        full = prepare_algo_params(params or {}, parameters_definitions)
        return cls(algo, full, mode)

    @property
    def algo(self) -> str:
        return self._algo

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._params)

    def param_value(self, name: str) -> Any:
        return self._params[name]

    @classmethod
    def _from_repr(cls, algo, mode, params):
        return cls(algo, params, mode)

    def __eq__(self, other):
        return (
            isinstance(other, AlgorithmDef)
            and other.algo == self.algo
            and other.mode == self.mode
            and other.params == self.params
        )

    def __repr__(self) -> str:
        return f"AlgorithmDef({self._algo}, {self._mode}, {self._params})"


class ComputationDef(SimpleRepr):
    """The deployable unit: a computation-graph node + the algorithm to run
    on it.  The agent runtime serializes it and ships it to the hosting
    agent at deploy time."""

    _repr_fields = ("node", "algo")

    def __init__(self, node, algo: AlgorithmDef) -> None:
        self._node = node
        self._algo = algo

    @property
    def node(self):
        return self._node

    @property
    def algo(self) -> AlgorithmDef:
        return self._algo

    @property
    def name(self) -> str:
        return self._node.name

    @classmethod
    def _from_repr(cls, node, algo):
        return cls(node, algo)

    def __eq__(self, other):
        return (
            isinstance(other, ComputationDef)
            and other.node == self.node
            and other.algo == self.algo
        )

    def __repr__(self) -> str:
        return f"ComputationDef({self.name}, {self._algo.algo})"


class SolveResult(NamedTuple):
    """Result of a batched solve."""

    assignment: Dict[str, Any]
    cost: float
    violations: int
    cycles: int
    msg_count: int
    msg_size: int
    cost_curve: Optional[List[float]] = None
    status: str = "FINISHED"


def warn_inert_params(
    given_params: Optional[Dict[str, Any]],
    inert: Dict[str, str],
    params_defs: Sequence[AlgoParameterDef] = (),
) -> None:
    """Warn when a parameter that an algorithm accepts only for
    compatibility with the reference is given a value other than its
    default.  Modules declare such parameters in ``inert_params: Dict[name,
    reason]``; a default value (also the string form of one) asks for
    nothing the algorithm fails to deliver and stays silent."""
    import warnings

    defs = {p.name: p for p in params_defs}
    for name in sorted(set(given_params or {}) & set(inert)):
        if name in defs:
            try:
                value = check_param_value(given_params[name], defs[name])
            except ValueError:
                value = given_params[name]  # invalid: prepare will raise
            if value == defs[name].default_value:
                continue
        warnings.warn(
            f"parameter {name!r} is accepted for reference compatibility "
            f"but has no effect here: {inert[name]}",
            UserWarning,
            stacklevel=3,
        )


def load_algorithm_module(algo_name: str):
    """Import an algorithm module of the port and check its contract."""
    try:
        mod = importlib.import_module(f"{__name__}.{algo_name}")
    except ImportError as e:
        raise ImportError(
            f"no algorithm module named {algo_name!r}: {e}"
        ) from e
    for attr in ("GRAPH_TYPE", "algo_params", "solve"):
        if not hasattr(mod, attr):
            raise AttributeError(
                f"algorithm module {algo_name} does not export {attr}"
            )
    return mod
