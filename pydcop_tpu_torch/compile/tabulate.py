"""Fast lowering of constraints to dense cost tables.

The compile-time bottleneck for large problems (100k+ constraints) is
evaluating intentional python expressions over every joint assignment.  The
reference pyDCOP does exactly that inside its solve hot loop; here
(as in ``pydcop_tpu/compile/tabulate.py``, of which this is a copy) it
happens once, at compile time, and is vectorized: the expression AST is rewritten to numpy
(``A if C else B`` -> ``np.where(C, A, B)``, ``and/or/not`` -> logical ops)
and evaluated over meshgrid arrays of the whole joint domain in one shot.

A vectorized result is validated against scalar evaluation on a sample of
assignments; on any mismatch or failure we fall back to exact scalar
iteration, so this is purely an optimization.
"""

from __future__ import annotations

import ast
import builtins
import math
from typing import Dict, Optional, Sequence

import numpy as np

from ..dcop.objects import Variable
from ..dcop.relations import Constraint, NAryFunctionRelation, NAryMatrixRelation
from ..utils.expressions import ExpressionFunction

__all__ = ["tabulate_constraint", "clear_table_cache"]

_TABLE_CACHE: Dict = {}


def clear_table_cache() -> None:
    _TABLE_CACHE.clear()


class _NumpyRewriter(ast.NodeTransformer):
    """Rewrite scalar python expressions into numpy-broadcastable ones."""

    def visit_IfExp(self, node: ast.IfExp):
        self.generic_visit(node)
        return ast.Call(
            func=ast.Attribute(
                value=ast.Name(id="np", ctx=ast.Load()),
                attr="where",
                ctx=ast.Load(),
            ),
            args=[node.test, node.body, node.orelse],
            keywords=[],
        )

    def visit_BoolOp(self, node: ast.BoolOp):
        self.generic_visit(node)
        fn = "logical_and" if isinstance(node.op, ast.And) else "logical_or"
        out = node.values[0]
        for v in node.values[1:]:
            out = ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="np", ctx=ast.Load()),
                    attr=fn,
                    ctx=ast.Load(),
                ),
                args=[out, v],
                keywords=[],
            )
        return out

    def visit_UnaryOp(self, node: ast.UnaryOp):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="np", ctx=ast.Load()),
                    attr="logical_not",
                    ctx=ast.Load(),
                ),
                args=[node.operand],
                keywords=[],
            )
        return node

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        # abs/min/max/round over arrays
        if isinstance(node.func, ast.Name):
            mapping = {
                "abs": "abs",
                "min": "minimum",
                "max": "maximum",
                "round": "round",
            }
            if node.func.id in mapping and len(node.args) in (1, 2):
                return ast.Call(
                    func=ast.Attribute(
                        value=ast.Name(id="np", ctx=ast.Load()),
                        attr=mapping[node.func.id],
                        ctx=ast.Load(),
                    ),
                    args=node.args,
                    keywords=node.keywords,
                )
        return node


def _try_vectorized(
    expression: str,
    fixed_vars: Dict,
    variables: Sequence[Variable],
) -> Optional[np.ndarray]:
    try:
        tree = ast.parse(expression, mode="eval")
    except SyntaxError:
        return None  # multi-line function body: no vectorized path
    tree = _NumpyRewriter().visit(tree)
    ast.fix_missing_locations(tree)
    code = compile(tree, "<vectorized-constraint>", "eval")

    shape = tuple(len(v.domain) for v in variables)
    grids = np.meshgrid(
        *[np.asarray(v.domain.values) for v in variables], indexing="ij"
    )
    scope = {v.name: g for v, g in zip(variables, grids)}
    scope.update(fixed_vars)
    try:
        result = eval(  # noqa: S307
            code,
            {"__builtins__": builtins.__dict__, "np": np, "math": math},
            scope,
        )
    except Exception:
        return None
    try:
        out = np.broadcast_to(
            np.asarray(result, dtype=np.float64), shape
        ).copy()
    except Exception:
        return None
    return out


def tabulate_constraint(
    constraint: Constraint, cache: bool = True
) -> np.ndarray:
    """Dense cost table of a constraint over its joint domain, axis i indexing
    variables[i] in domain order.  Vectorized when possible, exact always."""
    if isinstance(constraint, NAryMatrixRelation):
        return constraint.matrix

    key = None
    if cache and isinstance(constraint, NAryFunctionRelation):
        fn = constraint.function
        if isinstance(fn, ExpressionFunction) and fn.source_module is None:
            key = (
                fn.expression,
                tuple(sorted(fn.fixed_vars.items())),
                tuple(v.name for v in constraint.dimensions),
                tuple(tuple(v.domain.values) for v in constraint.dimensions),
            )
            hit = _TABLE_CACHE.get(key)
            if hit is not None:
                return hit

    table = None
    if isinstance(constraint, NAryFunctionRelation):
        fn = constraint.function
        if isinstance(fn, ExpressionFunction) and fn.source_module is None:
            table = _try_vectorized(
                fn.expression, fn.fixed_vars, constraint.dimensions
            )
            if table is not None and not _validate(table, constraint):
                table = None

    if table is None:
        table = constraint.tabulate().matrix

    if key is not None:
        _TABLE_CACHE[key] = table
    return table


def _validate(
    table: np.ndarray, constraint: Constraint, samples: int = 4
) -> bool:
    """Spot-check the vectorized table against scalar evaluation."""
    rng = np.random.default_rng(0)
    shape = table.shape
    names = constraint.scope_names
    domains = [v.domain.values for v in constraint.dimensions]
    checks = {tuple(0 for _ in shape), tuple(s - 1 for s in shape)}
    for _ in range(samples):
        checks.add(tuple(int(rng.integers(0, s)) for s in shape))
    for idx in checks:
        assignment = {
            n: domains[i][idx[i]] for i, n in enumerate(names)
        }
        expected = constraint.get_value_for_assignment(assignment)
        if not np.isclose(table[idx], float(expected), rtol=1e-9, atol=1e-12):
            return False
    return True
