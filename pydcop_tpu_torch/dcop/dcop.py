"""The DCOP problem container.

Counterpart of ``pydcop_tpu/dcop/dcop.py``, copied: ``DCOP``,
``solution_cost`` (which evaluates the relations themselves) and
``filter_dcop``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from .objects import AgentDef, Domain, ExternalVariable, Variable
from .relations import Constraint, RelationProtocol

__all__ = ["DCOP", "solution_cost", "filter_dcop"]

from ..constants import INFINITY as DEFAULT_INFINITY  # noqa: E402


class DCOP:
    """A Distributed Constraint Optimization Problem.

    Aggregates domains, variables, constraints and agents; evaluates global
    solution cost.  Constraints can be added with ``add_constraint`` or the
    ``+=`` sugar, which auto-registers their variables and domains.

    >>> from pydcop_tpu_torch.dcop.objects import Variable
    >>> from pydcop_tpu_torch.dcop.relations import constraint_from_str
    >>> d = DCOP('demo')
    >>> x = Variable('x', [0, 1]); y = Variable('y', [0, 1])
    >>> d += constraint_from_str('c1', 'x + y', [x, y])
    >>> sorted(d.variables)
    ['x', 'y']
    """

    def __init__(
        self,
        name: str = "dcop",
        objective: str = "min",
        description: str = "",
        domains: Optional[Dict[str, Domain]] = None,
        variables: Optional[Dict[str, Variable]] = None,
        constraints: Optional[Dict[str, Constraint]] = None,
        agents: Optional[Dict[str, AgentDef]] = None,
    ) -> None:
        if objective not in ("min", "max"):
            raise ValueError("objective must be 'min' or 'max'")
        self.name = name
        self.description = description
        self.objective = objective
        self.domains: Dict[str, Domain] = dict(domains or {})
        self.variables: Dict[str, Variable] = {}
        self.external_variables: Dict[str, ExternalVariable] = {}
        self.constraints: Dict[str, Constraint] = {}
        self._agents_def: Dict[str, AgentDef] = dict(agents or {})
        self.dist_hints = None
        for v in (variables or {}).values():
            self.add_variable(v)
        for c in (constraints or {}).values():
            self.add_constraint(c)

    # -- variables ---------------------------------------------------------

    def add_variable(self, v: Variable) -> None:
        if isinstance(v, ExternalVariable):
            self.external_variables[v.name] = v
        else:
            existing = self.variables.get(v.name)
            if existing is not None and existing != v:
                raise ValueError(
                    f"inconsistent redefinition of variable {v.name}"
                )
            self.variables[v.name] = v
        self.domains.setdefault(v.domain.name, v.domain)

    def variable(self, name: str) -> Variable:
        return self.variables[name]

    def get_variables(self) -> List[Variable]:
        return list(self.variables.values())

    @property
    def all_variables(self) -> List[Variable]:
        return list(self.variables.values()) + list(
            self.external_variables.values()
        )

    # -- constraints -------------------------------------------------------

    def add_constraint(self, c: Constraint) -> None:
        if c.name in self.constraints:
            raise ValueError(f"duplicate constraint name {c.name}")
        self.constraints[c.name] = c
        for v in c.dimensions:
            if (
                v.name not in self.variables
                and v.name not in self.external_variables
            ):
                self.add_variable(v)

    def __iadd__(self, c: Constraint) -> "DCOP":
        self.add_constraint(c)
        return self

    def constraint(self, name: str) -> Constraint:
        return self.constraints[name]

    # -- agents ------------------------------------------------------------

    def add_agents(self, agents: Union[Iterable[AgentDef], Dict[str, AgentDef]]):
        if isinstance(agents, dict):
            agents = agents.values()
        for a in agents:
            self._agents_def[a.name] = a

    @property
    def agents(self) -> Dict[str, AgentDef]:
        return dict(self._agents_def)

    def agent(self, name: str) -> AgentDef:
        return self._agents_def[name]

    # -- evaluation --------------------------------------------------------

    def solution_cost(
        self, assignment: Dict[str, Any], infinity: float = DEFAULT_INFINITY
    ) -> Tuple[float, int]:
        """(cost, violation_count) of a full assignment.

        A constraint whose cost is >= ``infinity`` (or infinite) counts as a
        violation and its cost is not accumulated (reference dcop.py:308).
        """
        cost, violations = 0.0, 0
        full = dict(assignment)
        for n, ev in self.external_variables.items():
            full.setdefault(n, ev.value)
        missing = set(self.variables) - set(full)
        if missing:
            raise ValueError(f"assignment misses variables {sorted(missing)}")
        for c in self.constraints.values():
            val = c.get_value_for_assignment(
                {n: full[n] for n in c.scope_names}
            )
            if val >= infinity or val == float("inf"):
                violations += 1
            else:
                cost += val
        for v in self.variables.values():
            if v.has_cost:
                cost += v.cost_for_val(full[v.name])
        return cost, violations

    def __repr__(self) -> str:
        return (
            f"DCOP({self.name}: {len(self.variables)} vars, "
            f"{len(self.constraints)} constraints, "
            f"{len(self._agents_def)} agents)"
        )


def solution_cost(
    dcop: DCOP, assignment: Dict[str, Any], infinity: float = DEFAULT_INFINITY
) -> Tuple[float, int]:
    return dcop.solution_cost(assignment, infinity)


def filter_dcop(
    dcop: DCOP, min_arity: int = 2, remove_var_costs: bool = True
) -> DCOP:
    """Strip constraints below ``min_arity`` (and optionally variable costs) —
    used before building computation graphs that only handle binary+
    constraints (reference dcop.py:370)."""
    filtered = DCOP(dcop.name, dcop.objective, dcop.description)
    filtered.add_agents(dcop.agents)
    for c in dcop.constraints.values():
        if c.arity >= min_arity:
            filtered.add_constraint(c)
    for v in dcop.variables.values():
        if v.name not in filtered.variables:
            filtered.add_variable(
                Variable(v.name, v.domain, v.initial_value)
                if remove_var_costs
                else v
            )
        elif remove_var_costs and v.has_cost:
            filtered.variables[v.name] = Variable(
                v.name, v.domain, v.initial_value
            )
        elif not remove_var_costs:
            filtered.variables[v.name] = v
    return filtered
