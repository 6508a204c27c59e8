"""Constraints (relations) over variables.

Counterpart of ``pydcop_tpu/dcop/relations.py``, copied: the dense
``NAryMatrixRelation`` (a cost hypercube over the scope), the
expression-backed ``NAryFunctionRelation``, ``constraint_from_str``,
``relation_from_str``, ``join`` and ``projection``.  Every relation can be
tabulated to a dense table, the form ``compile/core.py`` lowers.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.expressions import ExpressionFunction, load_source_module
from ..utils.simple_repr import SimpleRepr, from_repr
from .objects import Domain, Variable

__all__ = [
    "Constraint",
    "RelationProtocol",
    "ZeroAryRelation",
    "UnaryFunctionRelation",
    "UnaryBooleanRelation",
    "NAryFunctionRelation",
    "NAryMatrixRelation",
    "ConditionalRelation",
    "AsNAryFunctionRelation",
    "relation_from_str",
    "constraint_from_str",
    "constraint_from_external_definition",
    "assignment_matrix",
    "generate_assignment",
    "generate_assignment_as_dict",
    "assignment_cost",
    "find_arg_optimal",
    "find_optimal",
    "optimal_cost_value",
    "find_optimum",
    "join",
    "projection",
    "add_var_to_rel",
    "count_var_match",
    "is_compatible",
    "filter_assignment_dict",
    "find_dependent_relations",
    "DEFAULT_TYPE",
]

DEFAULT_TYPE = np.float64


class Constraint(SimpleRepr):
    """Base class for all relations (cost functions over variables)."""

    def __init__(self, name: str, variables: Sequence[Variable]) -> None:
        self._name = name
        self._variables = tuple(variables)

    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return "generic"

    @property
    def dimensions(self) -> List[Variable]:
        return list(self._variables)

    @property
    def arity(self) -> int:
        return len(self._variables)

    @property
    def scope_names(self) -> List[str]:
        return [v.name for v in self._variables]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(v.domain) for v in self._variables)

    def __call__(self, *args, **kwargs) -> float:
        if args and not kwargs:
            if len(args) != self.arity:
                raise ValueError(
                    f"{self.name} expects {self.arity} positional values"
                )
            kwargs = dict(zip(self.scope_names, args))
        return self.get_value_for_assignment(kwargs)

    def get_value_for_assignment(self, assignment: Dict[str, Any]) -> float:
        raise NotImplementedError

    def has_variable(self, variable: Union[str, Variable]) -> bool:
        name = variable if isinstance(variable, str) else variable.name
        return name in self.scope_names

    def slice(self, partial: Dict[str, Any]) -> "Constraint":
        """Constraint over the remaining scope with some variables fixed."""
        return self.tabulate().slice(partial)

    def tabulate(self) -> "NAryMatrixRelation":
        """Lower to a dense cost hypercube (the compile-time path to the device)."""
        m = NAryMatrixRelation(self._variables, name=self._name)
        arr = np.empty(m.shape, dtype=DEFAULT_TYPE)
        names = self.scope_names
        domains = [v.domain.values for v in self._variables]
        for idx in np.ndindex(*m.shape) if m.shape else [()]:
            assignment = {n: domains[i][idx[i]] for i, n in enumerate(names)}
            arr[idx] = self.get_value_for_assignment(assignment)
        return NAryMatrixRelation(self._variables, arr, name=self._name)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._name}, {self.scope_names})"


# Alias for familiarity with the reference naming.
RelationProtocol = Constraint


class ZeroAryRelation(Constraint):
    """A constant relation (reference relations.py:218)."""

    _repr_fields = ("name", "value")

    def __init__(self, name: str, value: float) -> None:
        super().__init__(name, ())
        self.value = value

    def get_value_for_assignment(self, assignment: Dict[str, Any]) -> float:
        return self.value

    def __eq__(self, other):
        return (
            isinstance(other, ZeroAryRelation)
            and other.name == self.name
            and other.value == self.value
        )

    def __hash__(self):
        return hash((self._name, self.value))


class UnaryFunctionRelation(Constraint):
    """A unary relation from a python callable or expression."""

    def __init__(
        self,
        name: str,
        variable: Variable,
        rel_function: Union[Callable, ExpressionFunction],
    ) -> None:
        super().__init__(name, (variable,))
        self._fn = rel_function

    @property
    def expression(self) -> Optional[str]:
        if isinstance(self._fn, ExpressionFunction):
            return self._fn.expression
        return None

    def get_value_for_assignment(self, assignment: Dict[str, Any]) -> float:
        val = assignment[self._variables[0].name]
        if isinstance(self._fn, ExpressionFunction):
            return self._fn(**{self._variables[0].name: val})
        return self._fn(val)

    def __eq__(self, other):
        return (
            isinstance(other, UnaryFunctionRelation)
            and other.name == self.name
            and other.dimensions == self.dimensions
            and getattr(other, "_fn", None) == self._fn
        )

    def __hash__(self):
        return hash((self._name, self._variables))


class UnaryBooleanRelation(UnaryFunctionRelation):
    """Truthiness of the variable value as 0/1 (reference relations.py:392)."""

    def __init__(self, name: str, variable: Variable) -> None:
        super().__init__(name, variable, lambda v: 1 if v else 0)


class NAryFunctionRelation(Constraint):
    """An n-ary relation given by a python function.

    If ``f`` is an ``ExpressionFunction`` the scope can be inferred from its
    free variables.
    """

    def __init__(
        self,
        f: Union[Callable, ExpressionFunction],
        variables: Sequence[Variable],
        name: Optional[str] = None,
        f_kwargs: bool = True,
    ) -> None:
        super().__init__(name or getattr(f, "__name__", "rel"), variables)
        self._fn = f
        self._f_kwargs = f_kwargs or isinstance(f, ExpressionFunction)

    @property
    def function(self):
        return self._fn

    @property
    def expression(self) -> Optional[str]:
        if isinstance(self._fn, ExpressionFunction):
            return self._fn.expression
        return None

    def get_value_for_assignment(self, assignment: Dict[str, Any]) -> float:
        kwargs = {n: assignment[n] for n in self.scope_names}
        if self._f_kwargs:
            return self._fn(**kwargs)
        return self._fn(*[kwargs[n] for n in self.scope_names])

    def __eq__(self, other):
        return (
            isinstance(other, NAryFunctionRelation)
            and other.name == self.name
            and other.dimensions == self.dimensions
            and other._fn == self._fn
        )

    def __hash__(self):
        return hash((self._name, self._variables))

    def _simple_repr(self):
        if not isinstance(self._fn, ExpressionFunction):
            raise TypeError(
                "only expression-based n-ary relations are serializable; "
                "tabulate() first"
            )
        return {
            "__qualname__": "NAryFunctionRelation",
            "__module__": type(self).__module__,
            "name": self._name,
            "expression": self._fn.expression,
            "variables": [v._simple_repr() for v in self._variables],
        }

    @classmethod
    def _from_repr(cls, name, expression, variables):
        vs = [from_repr(v) for v in variables]
        return cls(ExpressionFunction(expression), vs, name=name)


def AsNAryFunctionRelation(*variables: Variable):
    """Decorator: lift a plain python function to an NAryFunctionRelation
    (reference relations.py:616).

    >>> x = Variable('x', [0, 1]); y = Variable('y', [0, 1])
    >>> @AsNAryFunctionRelation(x, y)
    ... def add(x, y):
    ...     return x + y
    >>> add(1, 1)
    2
    """

    def decorate(fn: Callable) -> NAryFunctionRelation:
        return NAryFunctionRelation(
            fn, variables, name=fn.__name__, f_kwargs=False
        )

    return decorate


class NAryMatrixRelation(Constraint):
    """Dense cost hypercube over the scope — the device-native constraint form.

    Axis ``i`` of the array indexes the domain of ``variables[i]`` in domain
    order.  (Reference: relations.py:672-906, but here the array ops are
    vectorized.)

    >>> x = Variable('x', ['a', 'b']); y = Variable('y', ['a', 'b'])
    >>> r = NAryMatrixRelation([x, y], np.array([[1, 2], [3, 4.]]))
    >>> r(x='b', y='a')
    3.0
    """

    def __init__(
        self,
        variables: Sequence[Variable],
        matrix: Optional[np.ndarray] = None,
        name: Optional[str] = None,
    ) -> None:
        super().__init__(name or "rel", variables)
        shape = tuple(len(v.domain) for v in variables)
        if matrix is None:
            matrix = np.zeros(shape, dtype=DEFAULT_TYPE)
        else:
            matrix = np.asarray(matrix, dtype=DEFAULT_TYPE)
            if matrix.shape != shape:
                raise ValueError(
                    f"matrix shape {matrix.shape} does not match the scope's "
                    f"domain sizes {shape} (axis i must index variables[i])"
                )
        self._m = matrix

    @property
    def matrix(self) -> np.ndarray:
        return self._m

    @property
    def type(self) -> str:
        return "matrix"

    def _indices(self, assignment: Dict[str, Any]) -> Tuple[int, ...]:
        return tuple(
            v.domain.index(assignment[v.name]) for v in self._variables
        )

    def get_value_for_assignment(
        self, assignment: Union[Dict[str, Any], List]
    ) -> float:
        if isinstance(assignment, list):
            assignment = dict(zip(self.scope_names, assignment))
        if self.arity == 0:
            return float(self._m.reshape(()))
        return float(self._m[self._indices(assignment)])

    def set_value_for_assignment(
        self, assignment: Dict[str, Any], value: float
    ) -> "NAryMatrixRelation":
        """Return a new relation with one cell changed (immutable update)."""
        m = self._m.copy()
        m[self._indices(assignment)] = value
        return NAryMatrixRelation(self._variables, m, name=self._name)

    def slice(self, partial: Dict[str, Any]) -> "NAryMatrixRelation":
        """Fix some variables: index their axes, keep the rest."""
        unknown = set(partial) - set(self.scope_names)
        if unknown:
            raise ValueError(f"slice variables {unknown} not in scope")
        index: List[Any] = []
        remaining: List[Variable] = []
        for v in self._variables:
            if v.name in partial:
                index.append(v.domain.index(partial[v.name]))
            else:
                index.append(slice(None))
                remaining.append(v)
        return NAryMatrixRelation(
            remaining, self._m[tuple(index)], name=self._name
        )

    def tabulate(self) -> "NAryMatrixRelation":
        return self

    def __eq__(self, other):
        return (
            isinstance(other, NAryMatrixRelation)
            and other.name == self.name
            and other.dimensions == self.dimensions
            and np.array_equal(other._m, self._m)
        )

    def __hash__(self):
        return hash((self._name, self._variables))

    def _simple_repr(self):
        return {
            "__qualname__": "NAryMatrixRelation",
            "__module__": type(self).__module__,
            "name": self._name,
            "variables": [v._simple_repr() for v in self._variables],
            "matrix": self._m.tolist(),
        }

    @classmethod
    def _from_repr(cls, name, variables, matrix):
        vs = [from_repr(v) for v in variables]
        return cls(vs, np.array(matrix), name=name)

    @classmethod
    def from_func_relation(cls, rel: Constraint) -> "NAryMatrixRelation":
        return rel.tabulate()


class ConditionalRelation(Constraint):
    """``if condition(assignment): consequence(assignment)`` (reference
    relations.py:948)."""

    def __init__(
        self,
        condition: Constraint,
        consequence: Constraint,
        name: Optional[str] = None,
        return_value_if_false: float = 0,
    ) -> None:
        scope: List[Variable] = list(condition.dimensions)
        for v in consequence.dimensions:
            if v not in scope:
                scope.append(v)
        super().__init__(name or f"if_{condition.name}", scope)
        self._condition = condition
        self._consequence = consequence
        self._if_false = return_value_if_false

    def get_value_for_assignment(self, assignment: Dict[str, Any]) -> float:
        cond = self._condition.get_value_for_assignment(
            {n: assignment[n] for n in self._condition.scope_names}
        )
        if cond:
            return self._consequence.get_value_for_assignment(
                {n: assignment[n] for n in self._consequence.scope_names}
            )
        return self._if_false


def relation_from_str(
    name: str, expression: str, all_variables: Iterable[Variable]
) -> NAryFunctionRelation:
    """Build an intentional constraint from a python expression; the scope is
    the expression's free variables (reference relations.py:1275)."""
    f = ExpressionFunction(expression)
    by_name = {v.name: v for v in all_variables}
    scope = []
    for vname in sorted(f.variable_names):
        if vname not in by_name:
            raise ValueError(
                f"variable {vname!r} of constraint {name} is not defined"
            )
        scope.append(by_name[vname])
    return NAryFunctionRelation(f, scope, name=name)


constraint_from_str = relation_from_str


def constraint_from_external_definition(
    name: str,
    source_file: str,
    expression: str,
    all_variables: Iterable[Variable],
) -> NAryFunctionRelation:
    """Intentional constraint whose expression calls functions from an external
    python file via ``source.``  (reference relations.py:1314)."""
    module = load_source_module(source_file)
    f = ExpressionFunction(expression, source_module=module)
    by_name = {v.name: v for v in all_variables}
    scope = [by_name[v] for v in sorted(f.variable_names)]
    return NAryFunctionRelation(f, scope, name=name)


# ---------------------------------------------------------------------------
# assignment helpers
# ---------------------------------------------------------------------------


def assignment_matrix(variables: Sequence[Variable], default: float = 0):
    """Dense array over the joint domain, filled with ``default``."""
    shape = tuple(len(v.domain) for v in variables)
    return np.full(shape, default, dtype=DEFAULT_TYPE)


def generate_assignment(variables: Sequence[Variable]):
    """Iterate all assignments as value lists, last variable fastest."""
    for combo in itertools.product(*[v.domain.values for v in variables]):
        yield list(combo)


def generate_assignment_as_dict(variables: Sequence[Variable]):
    names = [v.name for v in variables]
    for combo in itertools.product(*[v.domain.values for v in variables]):
        yield dict(zip(names, combo))


def assignment_cost(
    assignment: Dict[str, Any],
    constraints: Iterable[Constraint],
    infinity: float = float("inf"),
) -> float:
    """Total cost of an assignment over the given constraints."""
    cost = 0.0
    for c in constraints:
        cost += c.get_value_for_assignment(
            {n: assignment[n] for n in c.scope_names}
        )
    return cost


def find_arg_optimal(
    variable: Variable, relation: Constraint, mode: str = "min"
) -> Tuple[List[Any], float]:
    """Values of ``variable`` optimizing a unary relation over it.

    Returns (list of optimal values, optimal cost) — vectorized over the
    tabulated relation.
    """
    if relation.arity != 1 or relation.dimensions[0].name != variable.name:
        raise ValueError(
            f"find_arg_optimal needs a unary relation on {variable.name}"
        )
    table = relation.tabulate().matrix
    opt = table.min() if mode == "min" else table.max()
    idx = np.nonzero(np.isclose(table, opt))[0]
    return [variable.domain[int(i)] for i in idx], float(opt)


def find_optimal(
    relation: Constraint, partial: Dict[str, Any], mode: str = "min"
) -> Tuple[List[Dict[str, Any]], float]:
    """All optimal assignments of the relation's free variables, given a
    partial assignment."""
    sliced = relation.tabulate().slice(partial) if partial else relation.tabulate()
    table = sliced.matrix
    opt = table.min() if mode == "min" else table.max()
    free = sliced.dimensions
    out = []
    for idx in zip(*np.nonzero(np.isclose(table, opt))):
        out.append(
            {v.name: v.domain[int(i)] for v, i in zip(free, idx)}
        )
    if not free and table.shape == ():
        out = [{}]
    return out, float(opt)


def optimal_cost_value(
    variable: Variable, mode: str = "min"
) -> Tuple[Any, float]:
    """Best value and cost w.r.t. the variable's own unary cost."""
    costs = np.array(variable.cost_vector(), dtype=DEFAULT_TYPE)
    i = int(np.argmin(costs) if mode == "min" else np.argmax(costs))
    return variable.domain[i], float(costs[i])


def find_optimum(relation: Constraint, mode: str = "min") -> float:
    """Global optimum of a relation over its whole joint domain."""
    table = relation.tabulate().matrix
    return float(table.min() if mode == "min" else table.max())


# ---------------------------------------------------------------------------
# join / projection — DPOP's math, as broadcast ops
# ---------------------------------------------------------------------------


def _aligned(
    rel: NAryMatrixRelation, scope: Sequence[Variable]
) -> np.ndarray:
    """View of rel's matrix expanded/transposed to the given union scope."""
    names = [v.name for v in scope]
    # transpose rel's axes into union order, then insert broadcast axes for
    # union variables absent from rel's scope
    order_in_union = [n for n in names if n in rel.scope_names]
    perm = [rel.scope_names.index(n) for n in order_in_union]
    m = np.transpose(rel.matrix, perm)
    out_index = tuple(
        slice(None) if n in rel.scope_names else None for n in names
    )
    return m[out_index]


def join(u1: Constraint, u2: Constraint) -> NAryMatrixRelation:
    """Pointwise sum over the union of scopes (reference relations.py:1672) —
    implemented as one numpy broadcast-add."""
    m1 = u1.tabulate()
    m2 = u2.tabulate()
    scope: List[Variable] = list(m1.dimensions)
    for v in m2.dimensions:
        if v.name not in [s.name for s in scope]:
            scope.append(v)
    a = _aligned(m1, scope)
    b = _aligned(m2, scope)
    return NAryMatrixRelation(
        scope, a + b, name=f"joined_{u1.name}_{u2.name}"
    )


def projection(
    rel: Constraint, variable: Variable, mode: str = "min"
) -> NAryMatrixRelation:
    """Optimize one variable out: reduce its axis (reference
    relations.py:1717)."""
    m = rel.tabulate()
    if variable.name not in m.scope_names:
        raise ValueError(
            f"cannot project {variable.name}: not in scope of {rel.name}"
        )
    axis = m.scope_names.index(variable.name)
    reduced = m.matrix.min(axis=axis) if mode == "min" else m.matrix.max(axis=axis)
    remaining = [v for v in m.dimensions if v.name != variable.name]
    return NAryMatrixRelation(
        remaining, reduced, name=f"{rel.name}_proj_{variable.name}"
    )


def add_var_to_rel(
    name: str,
    original_relation: Constraint,
    variable: Variable,
    f: Callable,
) -> NAryFunctionRelation:
    """Extend a relation with one extra variable combined via ``f(original
    cost, var value)`` (reference relations.py:1131)."""

    def extended(**kwargs):
        val = kwargs.pop(variable.name)
        return f(original_relation.get_value_for_assignment(kwargs), val)

    return NAryFunctionRelation(
        extended,
        list(original_relation.dimensions) + [variable],
        name=name,
    )


def count_var_match(var_names, relation: Constraint) -> int:
    """Number of the relation's dimensions whose names appear in
    ``var_names`` (reference relations.py:1139) — used by distribution
    heuristics to score agent/constraint affinity."""
    return sum(1 for v in relation.dimensions if v.name in var_names)


def is_compatible(
    assignment1: Dict[str, Any], assignment2: Dict[str, Any]
) -> bool:
    """True when two (potentially partial) assignments agree on every
    variable they share (reference relations.py:1257)."""
    return all(
        assignment1[k] == assignment2[k]
        for k in assignment1.keys() & assignment2.keys()
    )


def filter_assignment_dict(
    assignment: Dict[str, Any], target_vars: Sequence[Variable]
) -> Dict[str, Any]:
    """Restrict an assignment to the given variables (reference
    relations.py:1535)."""
    names = {v.name for v in target_vars}
    return {k: v for k, v in assignment.items() if k in names}


def find_dependent_relations(
    variable: Variable,
    constraints: Sequence[Constraint],
    ext_var_assignment: Optional[Dict[str, Any]] = None,
) -> List[Constraint]:
    """Constraints whose scope contains ``variable`` (reference
    relations.py:1219).  With ``ext_var_assignment``, a constraint only
    counts if it still has dimensions after slicing those (external)
    variables out — a ConditionalRelation whose condition variable is
    assigned may collapse to a constant and stop depending on anything."""
    out: List[Constraint] = []
    for r in constraints:
        if not any(v.name == variable.name for v in r.dimensions):
            continue
        if ext_var_assignment:
            sliced = r.slice(
                filter_assignment_dict(ext_var_assignment, r.dimensions)
            )
            if not sliced.dimensions:
                continue
        out.append(r)
    return out
