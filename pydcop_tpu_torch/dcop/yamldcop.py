"""YAML (de)serialization of DCOPs, agents and scenarios.

Counterpart of ``pydcop_tpu/dcop/yamldcop.py``, copied: the same on-disk
format (pyDCOP's) and the same ``dcop_yaml`` text.  Domains (extensive
values or ``[1 .. 10]`` ranges), variables with ``cost_function`` /
``noise_level``, external variables, intentional constraints (expression,
multi-line function body, external ``source`` file, ``partial``
application), extensional constraints (``values: {cost: "v1 v2 | v1 v3"}``
tables with ``default``), agents with capacity/extras, symmetric
``routes``, ``hosting_costs`` and ``distribution_hints``.  Multi-file merge
is supported by concatenating documents.  Text is parsed and written by
PyYAML's libyaml-backed ``CSafeLoader``/``CSafeDumper`` where PyYAML was
built with libyaml and they agree with its pure-Python safe loader and
dumper (several times faster on large problems), else by those.
"""

from __future__ import annotations

import os
import re
import shlex
from typing import Any, Dict, Iterable, List, Optional, Union

import yaml

from ..utils.expressions import ExpressionFunction, load_source_module
from .dcop import DCOP
from .objects import (
    AgentDef,
    Domain,
    ExternalVariable,
    Variable,
    VariableNoisyCostFunc,
    VariableWithCostFunc,
)
from .relations import (
    Constraint,
    NAryFunctionRelation,
    NAryMatrixRelation,
    assignment_matrix,
    constraint_from_external_definition,
    constraint_from_str,
)
from .scenario import DcopEvent, EventAction, Scenario

__all__ = [
    "load_dcop",
    "load_dcop_from_file",
    "dcop_yaml",
    "yaml_agents",
    "load_agents_from_file",
    "load_scenario",
    "load_scenario_from_file",
    "yaml_scenario",
    "DcopInvalidFormatError",
]

# libyaml's safe loader and dumper where PyYAML has them.  They give
# yaml.safe_load's objects and yaml.safe_dump's text except in two cases,
# which go to the pure-Python classes: libyaml folds a long double-quoted
# scalar at other places, and it accepts a tab that the pure-Python scanner
# refuses (a tab inside a plain scalar).
_CSafeLoader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
_CSafeDumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
# text that both loaders read alike: printable ASCII and line feeds
_PLAIN_TEXT = re.compile(r"[\x20-\x7e\n]*")


def _safe_load(text: str) -> Any:
    plain = _PLAIN_TEXT.fullmatch(text) is not None
    return yaml.load(text, Loader=_CSafeLoader if plain else yaml.SafeLoader)


def _safe_dump(data: Any) -> str:
    text = yaml.dump(data, Dumper=_CSafeDumper, default_flow_style=False,
                     sort_keys=False)
    if '"' in text:  # a double-quoted scalar may be folded otherwise
        text = yaml.safe_dump(data, default_flow_style=False,
                              sort_keys=False)
    return text


_RANGE_RE = re.compile(r"^\s*(-?\d+)\s*\.\.\s*(-?\d+)\s*$")


class DcopInvalidFormatError(Exception):
    pass


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load_dcop_from_file(filenames: Union[str, Iterable[str]]) -> DCOP:
    """Load a DCOP from one file or a list of files merged in order.

    Sections (domains, variables, constraints, agents, ...) from later files
    are merged entry-wise into earlier ones — NOT by yaml duplicate-key
    semantics, which would silently drop whole sections.
    """
    if isinstance(filenames, str):
        filenames = [filenames]
    filenames = list(filenames)
    merged: Dict[str, Any] = {}
    for f in filenames:
        with open(f, encoding="utf-8") as fh:
            data = _safe_load(fh.read())
        if not isinstance(data, dict):
            raise DcopInvalidFormatError(f"{f}: dcop yaml must be a mapping")
        for key, section in data.items():
            if (
                key in merged
                and isinstance(merged[key], dict)
                and isinstance(section, dict)
            ):
                merged[key].update(section)
            else:
                merged[key] = section
    main_dir = os.path.dirname(os.path.abspath(filenames[0]))
    return _load_dcop_data(merged, main_dir=main_dir)


def load_dcop(dcop_str: str, main_dir: str = ".") -> DCOP:
    data = _safe_load(dcop_str)
    if not isinstance(data, dict):
        raise DcopInvalidFormatError("dcop yaml must be a mapping")
    return _load_dcop_data(data, main_dir)


def _load_dcop_data(data: Dict[str, Any], main_dir: str = ".") -> DCOP:
    if "name" not in data:
        raise DcopInvalidFormatError("missing 'name' in dcop yaml")
    if "objective" not in data:
        # reference format requires it (yamldcop.py raises KeyError there;
        # tests/unit/test_dcop_serialization.py:115 pins the behavior)
        raise DcopInvalidFormatError("missing 'objective' in dcop yaml")
    dcop = DCOP(
        data["name"],
        data["objective"],
        data.get("description", ""),
    )

    domains = _build_domains(data.get("domains", {}))
    dcop.domains.update(domains)

    for v in _build_variables(data.get("variables", {}), domains).values():
        dcop.add_variable(v)
    for v in _build_external_variables(
        data.get("external_variables", {}), domains
    ).values():
        dcop.add_variable(v)

    for c in _build_constraints(
        data.get("constraints", {}), dcop, main_dir
    ).values():
        dcop.add_constraint(c)

    agents = _build_agents(
        data.get("agents", {}),
        data.get("routes", {}) or {},
        data.get("hosting_costs", {}) or {},
    )
    dcop.add_agents(agents)

    hints = data.get("distribution_hints")
    if hints:
        from ..distribution.objects import DistributionHints

        # validate references like the reference loader
        # (ref tests/unit/test_dcop_serialization.py:889-903)
        must_host = hints.get("must_host", {}) or {}
        agent_names = {a.name for a in agents}
        known = set(dcop.variables) | set(dcop.constraints)
        for agent, comps in must_host.items():
            if agent not in agent_names:
                raise ValueError(
                    f"distribution_hints.must_host: unknown agent {agent!r}"
                )
            for comp in comps:
                if comp not in known:
                    raise ValueError(
                        f"distribution_hints.must_host: unknown "
                        f"computation {comp!r} for agent {agent!r}"
                    )
        dcop.dist_hints = DistributionHints(
            must_host=must_host,
            host_with=hints.get("host_with", {}),
        )
    return dcop


def _expand_values(raw_values) -> List[Any]:
    # range written without brackets arrives as a bare string ('1 .. 10')
    if isinstance(raw_values, str):
        m = _RANGE_RE.match(raw_values)
        if not m:
            raise DcopInvalidFormatError(
                f"domain values must be a list or a range, got {raw_values!r}"
            )
        lo, hi = map(int, m.groups())
        return list(range(lo, hi + 1))
    if (
        len(raw_values) == 1
        and isinstance(raw_values[0], str)
        and _RANGE_RE.match(raw_values[0])
    ):
        lo, hi = map(int, _RANGE_RE.match(raw_values[0]).groups())
        return list(range(lo, hi + 1))
    return list(raw_values)


def _build_domains(raw: Dict[str, Any]) -> Dict[str, Domain]:
    domains = {}
    for name, d in (raw or {}).items():
        if "values" not in d:
            raise DcopInvalidFormatError(f"domain {name} has no values")
        values = _expand_values(d["values"])
        domains[name] = Domain(name, d.get("type", ""), values)
    return domains


def _build_variables(
    raw: Dict[str, Any], domains: Dict[str, Domain]
) -> Dict[str, Variable]:
    variables = {}
    for name, v in (raw or {}).items():
        v = v or {}
        try:
            domain = domains[v["domain"]]
        except KeyError:
            raise DcopInvalidFormatError(
                f"variable {name}: missing or unknown domain"
            )
        initial = v.get("initial_value")
        if initial is not None and initial not in domain:
            raise DcopInvalidFormatError(
                f"variable {name}: initial value {initial!r} not in domain"
            )
        if "cost_function" in v:
            try:
                cost_fn = ExpressionFunction(str(v["cost_function"]))
            except SyntaxError as e:
                raise DcopInvalidFormatError(
                    f"variable {name}: invalid cost_function "
                    f"{v['cost_function']!r}: {e}"
                ) from e
            if "noise_level" in v:
                variables[name] = VariableNoisyCostFunc(
                    name,
                    domain,
                    cost_fn,
                    initial,
                    noise_level=float(v["noise_level"]),
                )
            else:
                variables[name] = VariableWithCostFunc(
                    name, domain, cost_fn, initial
                )
        else:
            variables[name] = Variable(name, domain, initial)
    return variables


def _build_external_variables(
    raw: Dict[str, Any], domains: Dict[str, Domain]
) -> Dict[str, ExternalVariable]:
    out = {}
    for name, v in (raw or {}).items():
        domain = domains[v["domain"]]
        if "initial_value" not in v:
            raise DcopInvalidFormatError(
                f"external variable {name} requires an initial_value"
            )
        out[name] = ExternalVariable(name, domain, v["initial_value"])
    return out


def _build_constraints(
    raw: Dict[str, Any], dcop: DCOP, main_dir: str
) -> Dict[str, Constraint]:
    constraints: Dict[str, Constraint] = {}
    all_vars = dcop.all_variables
    for name, c in (raw or {}).items():
        ctype = c.get("type")
        if ctype == "intention":
            if "source" in c:
                src = c["source"]
                if not os.path.isabs(src):
                    src = os.path.join(main_dir, src)
                rel = constraint_from_external_definition(
                    name, src, str(c["function"]), all_vars
                )
            else:
                try:
                    rel = constraint_from_str(
                        name, str(c["function"]), all_vars
                    )
                except SyntaxError as e:
                    # a bare SyntaxError would not say WHICH constraint
                    raise DcopInvalidFormatError(
                        f"constraint {name}: invalid expression "
                        f"{c['function']!r}: {e}"
                    ) from e
            if "partial" in c:
                f = rel.function.partial(**c["partial"])
                by_name = {v.name: v for v in all_vars}
                scope = [by_name[n] for n in sorted(f.variable_names)]
                rel = NAryFunctionRelation(f, scope, name=name)
            constraints[name] = rel
        elif ctype == "extensional":
            constraints[name] = _build_extensional(name, c, dcop)
        else:
            raise DcopInvalidFormatError(
                f"constraint {name}: unknown type {ctype!r}"
            )
    return constraints


def _build_extensional(name: str, c: Dict[str, Any], dcop: DCOP) -> Constraint:
    var_names = c["variables"]
    if isinstance(var_names, str):
        var_names = [var_names]
    variables = []
    for vn in var_names:
        if vn in dcop.variables:
            variables.append(dcop.variables[vn])
        elif vn in dcop.external_variables:
            variables.append(dcop.external_variables[vn])
        else:
            raise DcopInvalidFormatError(
                f"extensional constraint {name}: unknown variable {vn}"
            )
    default = float(c.get("default", 0))
    matrix = assignment_matrix(variables, default)
    for value, assignments in (c.get("values") or {}).items():
        value = float(value)
        for assignment in str(assignments).split("|"):
            tokens = shlex.split(assignment.strip())
            if len(tokens) != len(variables):
                raise DcopInvalidFormatError(
                    f"extensional constraint {name}: assignment "
                    f"{assignment!r} does not match scope arity"
                )
            idx = tuple(
                v.domain.index(v.domain.to_domain_value(t))
                for v, t in zip(variables, tokens)
            )
            matrix[idx] = value
    return NAryMatrixRelation(variables, matrix, name=name)


def _build_agents(
    raw, routes: Dict[str, Any], hosting_costs: Dict[str, Any]
) -> List[AgentDef]:
    default_route = float(routes.get("default", 1))
    default_hosting = hosting_costs.get("default", 0)

    # route symmetry: collect pair costs, error on conflicting redefinition
    pair_routes: Dict[str, Dict[str, float]] = {}
    seen = set()
    for a, peers in routes.items():
        if a == "default":
            continue
        for b, cost in (peers or {}).items():
            key = tuple(sorted((a, b)))
            if key in seen:
                if pair_routes[a].get(b) != float(cost):
                    raise DcopInvalidFormatError(
                        f"route ({a}, {b}) defined twice with different costs"
                    )
                continue
            seen.add(key)
            pair_routes.setdefault(a, {})[b] = float(cost)
            pair_routes.setdefault(b, {})[a] = float(cost)

    agents = []
    if isinstance(raw, list):
        raw = {a: {} for a in raw}
    for name, props in (raw or {}).items():
        props = dict(props or {})
        capacity = props.pop("capacity", 100)
        hc = hosting_costs.get(name, {}) or {}
        agents.append(
            AgentDef(
                name,
                capacity=capacity,
                default_route=default_route,
                routes=pair_routes.get(name, {}),
                default_hosting_cost=hc.get("default", default_hosting),
                hosting_costs=hc.get("computations", {}),
                **props,
            )
        )
    return agents


def load_agents_from_file(filename: str) -> List[AgentDef]:
    with open(filename, encoding="utf-8") as fh:
        data = _safe_load(fh.read())
    return _build_agents(
        data.get("agents", {}),
        data.get("routes", {}) or {},
        data.get("hosting_costs", {}) or {},
    )


# ---------------------------------------------------------------------------
# dumping
# ---------------------------------------------------------------------------


def dcop_yaml(dcop: DCOP) -> str:
    data: Dict[str, Any] = {
        "name": dcop.name,
        "objective": dcop.objective,
    }
    if dcop.description:
        data["description"] = dcop.description

    data["domains"] = {
        d.name: {"values": list(d.values), **({"type": d.type} if d.type else {})}
        for d in dcop.domains.values()
    }

    from .objects import VariableWithCostDict

    variables = {}
    for v in dcop.variables.values():
        entry: Dict[str, Any] = {"domain": v.domain.name}
        if v.initial_value is not None:
            entry["initial_value"] = v.initial_value
        if isinstance(v, VariableNoisyCostFunc):
            entry["cost_function"] = v.cost_func.expression
            entry["noise_level"] = v.noise_level
        elif isinstance(v, VariableWithCostFunc):
            entry["cost_function"] = v.cost_func.expression
        elif isinstance(v, VariableWithCostDict):
            # no dict-cost syntax in the yaml format: encode the cost table as
            # a dict-literal indexing expression, semantics-preserving
            entry["cost_function"] = f"{v.costs!r}[{v.name}]"
        variables[v.name] = entry
    data["variables"] = variables

    if dcop.external_variables:
        data["external_variables"] = {
            v.name: {"domain": v.domain.name, "initial_value": v.value}
            for v in dcop.external_variables.values()
        }

    constraints = {}
    for c in dcop.constraints.values():
        if isinstance(c, NAryMatrixRelation):
            constraints[c.name] = _dump_extensional(c)
        elif (
            isinstance(c, NAryFunctionRelation)
            and c.expression is not None
            and getattr(c.function, "source_module", None) is None
        ):
            constraints[c.name] = {
                "type": "intention",
                "function": c.expression,
            }
        else:
            # source-file constraints (and opaque callables): the source path
            # is not recoverable, dump the tabulated cost table instead
            constraints[c.name] = _dump_extensional(c.tabulate())
    data["constraints"] = constraints

    if dcop.agents:
        data["agents"] = {
            a.name: {
                "capacity": a.capacity,
                **a.extra_attrs,
            }
            for a in dcop.agents.values()
        }
        routes: Dict[str, Any] = {}
        dumped = set()
        for a in dcop.agents.values():
            if a.default_route != 1:
                routes["default"] = a.default_route
            for b, cost in a.routes.items():
                key = tuple(sorted((a.name, b)))
                if key in dumped:
                    continue
                dumped.add(key)
                routes.setdefault(key[0], {})[key[1]] = cost
        if routes:
            data["routes"] = routes
        hosting: Dict[str, Any] = {}
        for a in dcop.agents.values():
            entry = {}
            if a.default_hosting_cost:
                entry["default"] = a.default_hosting_cost
            if a.hosting_costs:
                entry["computations"] = a.hosting_costs
            if entry:
                hosting[a.name] = entry
        if hosting:
            data["hosting_costs"] = hosting

    return _safe_dump(data)


def _dump_extensional(c: NAryMatrixRelation) -> Dict[str, Any]:
    import numpy as np

    values: Dict[float, List[str]] = {}
    m = c.matrix
    flat_counts: Dict[float, int] = {}
    for idx in np.ndindex(*m.shape):
        val = float(m[idx])
        flat_counts[val] = flat_counts.get(val, 0) + 1
    default = max(flat_counts, key=flat_counts.get) if flat_counts else 0.0
    for idx in np.ndindex(*m.shape):
        val = float(m[idx])
        if val == default:
            continue
        tokens = " ".join(
            _dump_token(v.domain[i]) for v, i in zip(c.dimensions, idx)
        )
        values.setdefault(val, []).append(tokens)
    out: Dict[str, Any] = {
        "type": "extensional",
        "variables": c.scope_names,
        "default": default,
    }
    if values:
        out["values"] = {k: " | ".join(v) for k, v in values.items()}
    return out


def _dump_token(v) -> str:
    s = str(v)
    if " " in s:
        return f"'{s}'"
    return s


def yaml_agents(agents: Iterable[AgentDef]) -> str:
    data = {
        "agents": {
            a.name: {"capacity": a.capacity, **a.extra_attrs} for a in agents
        }
    }
    return _safe_dump(data)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def load_scenario_from_file(filename: str) -> Scenario:
    with open(filename, encoding="utf-8") as fh:
        return load_scenario(fh.read())


def load_scenario(scenario_str: str) -> Scenario:
    data = _safe_load(scenario_str)
    events = []
    for i, e in enumerate(data.get("events", [])):
        eid = e.get("id", f"e{i}")
        if "delay" in e:
            events.append(DcopEvent(eid, delay=float(e["delay"])))
        else:
            actions = []
            for a in e.get("actions", []):
                a = dict(a)
                atype = a.pop("type")
                actions.append(EventAction(atype, **a))
            events.append(DcopEvent(eid, actions=actions))
    return Scenario(events)


def yaml_scenario(scenario: Scenario) -> str:
    events = []
    for e in scenario.events:
        if e.is_delay:
            events.append({"id": e.id, "delay": e.delay})
        else:
            events.append(
                {
                    "id": e.id,
                    "actions": [
                        {"type": a.type, **a.args} for a in e.actions or []
                    ],
                }
            )
    return _safe_dump({"events": events})
