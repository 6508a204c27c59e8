"""Algorithm parameter definitions and the solve result.

Counterpart of ``pydcop_tpu/algorithms/__init__.py`` (``AlgoParameterDef``,
``check_param_value``, ``prepare_algo_params``, ``SolveResult``).  An
algorithm module exports ``algo_params`` and ``solve(compiled, params,
n_cycles, seed, device=...)``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence

__all__ = [
    "AlgoParameterDef",
    "SolveResult",
    "check_param_value",
    "prepare_algo_params",
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
