"""Python-expression constraints, compiled once and tabulated to cost tables.

Counterpart of ``pydcop_tpu/utils/expressions.py``, copied with the same
AST checks, so an expression the JAX package refuses is refused here too.
A constraint (or a variable cost function) may be written as a python
expression over variable names, e.g. ``"10000 if v0 == v1 else 0"``.  The
expression is only evaluated at compile time, to lower the constraint into
a dense cost table (``compile/tabulate.py``); at solve time the table
lives on the device and the python function is never called again.
"""

from __future__ import annotations

import ast
import builtins
import importlib.util
import math
import random
import textwrap
from typing import Any, Callable, Dict, Iterable, Optional

__all__ = ["ExpressionFunction", "expression_variables", "load_source_module"]

# Names that can appear free in an expression without being DCOP variables.
_ALLOWED_GLOBALS = {
    name for name in dir(builtins) if not name.startswith("_")
} | {"math", "random"}


def expression_variables(expression: str) -> frozenset:
    """Free variable names of a python expression (or function body).

    Builtins, ``math``/``random`` and attribute roots named ``source`` are not
    variables (``source.f(x)`` refers to an external python file, see
    pyDCOP's docs/usage/file_formats/dcop_format.yml:124-133).
    """
    tree = ast.parse(_as_module(expression))
    names = set()
    assigned = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Store):
                assigned.add(node.id)
            else:
                names.add(node.id)
        elif isinstance(node, ast.FunctionDef):
            assigned.update(a.arg for a in node.args.args)
    return frozenset(
        n
        for n in names - assigned
        if n not in _ALLOWED_GLOBALS and n != "source"
    )


def _is_expression(code: str) -> bool:
    try:
        ast.parse(code, mode="eval")
        return True
    except SyntaxError:
        return False


def _returns_at_top_level(fn: ast.AST) -> bool:
    """Does the function return on ITS OWN body — not merely inside a
    nested def/lambda (whose return would not stop __expr__ from
    yielding None)?"""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Return):
            return True
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue  # a nested scope's return is not ours
        stack.extend(ast.iter_child_nodes(node))
    return False


def _as_module(code: str) -> str:
    """Wrap a multi-line function body into a module for ast analysis."""
    if _is_expression(code):
        return code
    # multi-line function body (must contain return); indent under a def
    body = "\n".join("    " + line for line in code.splitlines())
    return f"def __expr__():\n{body}\n"


def load_source_module(path: str):
    """Load an external python file declared via ``source:`` in YAML."""
    spec = importlib.util.spec_from_file_location("source", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # type: ignore[union-attr]
    return module


class ExpressionFunction:
    """A callable built from a python expression string.

    >>> f = ExpressionFunction("a + b * 2")
    >>> sorted(f.variable_names)
    ['a', 'b']
    >>> f(a=1, b=3)
    7
    >>> f.partial(b=3)(a=1)
    7

    Multi-line bodies with ``return`` are supported, as is the ``source.fn``
    external-file syntax (pass ``source_module``).
    """

    def __init__(
        self,
        expression: str,
        source_module=None,
        **fixed_vars: Any,
    ) -> None:
        self._expression = expression
        self._source_module = source_module
        self._fixed_vars = dict(fixed_vars)
        # normalize indentation before classifying: a mere leading space
        # (' v1 + v2', common in hand-written YAML) is an IndentationError
        # in eval mode and used to silently fall through to the
        # statement path, producing a function that returns None
        norm = textwrap.dedent(expression).strip("\n")
        all_vars = expression_variables(norm)
        unknown_fixed = set(fixed_vars) - set(all_vars)
        if unknown_fixed:
            raise ValueError(
                f"fixed variables {unknown_fixed} not in expression variables "
                f"{set(all_vars)}"
            )
        self._all_vars = all_vars
        self.variable_names = frozenset(all_vars - set(fixed_vars))

        env: Dict[str, Any] = {"math": math, "random": random}
        if source_module is not None:
            env["source"] = source_module
        if _is_expression(norm):
            code = compile(norm, "<dcop-expression>", "eval")
            self._fn: Callable[..., Any] = lambda kw: eval(  # noqa: S307
                code, {"__builtins__": builtins.__dict__, **env}, kw
            )
        else:
            args = ", ".join(sorted(all_vars))
            body = "\n".join("    " + l for l in norm.splitlines())
            src = f"def __expr__({args}):\n{body}\n"
            tree = ast.parse(src)  # raises SyntaxError with context
            if not _returns_at_top_level(tree.body[0]):
                # without this, the constraint would silently evaluate to
                # None for every assignment
                raise SyntaxError(
                    "multi-line expression must contain a return statement"
                )
            scope: Dict[str, Any] = {}
            exec(  # noqa: S102
                compile(tree, "<dcop-function>", "exec"),
                {"__builtins__": builtins.__dict__, **env},
                scope,
            )
            fn = scope["__expr__"]
            self._fn = lambda kw: fn(**kw)

    @property
    def expression(self) -> str:
        return self._expression

    @property
    def source_module(self):
        return self._source_module

    def __call__(self, *args, **kwargs) -> Any:
        if args:
            raise TypeError(
                "ExpressionFunction takes keyword arguments only "
                "(variable names are significant)"
            )
        scope = dict(self._fixed_vars)
        scope.update(kwargs)
        missing = self.variable_names - set(scope)
        if missing:
            raise TypeError(f"missing variable(s) {missing} for {self}")
        extra = set(scope) - self._all_vars
        if extra:
            # tolerate extra kwargs: callers often pass full assignments
            for k in extra:
                scope.pop(k)
        return self._fn(scope)

    def partial(self, **fixed: Any) -> "ExpressionFunction":
        merged = dict(self._fixed_vars)
        merged.update(fixed)
        return ExpressionFunction(
            self._expression, source_module=self._source_module, **merged
        )

    @property
    def fixed_vars(self) -> Dict[str, Any]:
        return dict(self._fixed_vars)

    def __repr__(self) -> str:
        return f"ExpressionFunction({self._expression!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ExpressionFunction)
            and other._expression == self._expression
            and other._fixed_vars == self._fixed_vars
        )

    def __hash__(self) -> int:
        return hash((self._expression, tuple(sorted(self._fixed_vars.items()))))
