"""DCOP model objects: domains, variables, agents.

Counterpart of ``pydcop_tpu/dcop/objects.py``, copied.  These are
host-side, immutable definitions: the solver never touches them in its hot
path, since ``compile/core.py`` lowers them once to index arrays and
padded cost tables.  Unary costs are represented so they can be tabulated
over the whole domain in one shot (``cost_vector``).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from ..utils.expressions import ExpressionFunction
from ..utils.simple_repr import SimpleRepr

__all__ = [
    "Domain",
    "VariableDomain",
    "binary_domain",
    "Variable",
    "BinaryVariable",
    "VariableWithCostDict",
    "VariableWithCostFunc",
    "VariableNoisyCostFunc",
    "ExternalVariable",
    "AgentDef",
    "create_variables",
    "create_binary_variables",
    "create_agents",
]


class Domain(SimpleRepr):
    """A named, ordered, finite set of values.

    >>> d = Domain('colors', 'color', ['R', 'G', 'B'])
    >>> len(d), d.index('G'), d[2]
    (3, 1, 'B')
    """

    _repr_fields = ("name", "domain_type", "values")

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
    def domain_type(self) -> str:
        return self._domain_type

    @property
    def values(self) -> Tuple:
        return self._values

    def index(self, value) -> int:
        try:
            return self._index[value]
        except KeyError:
            raise ValueError(f"{value!r} is not in domain {self._name}")

    def to_domain_value(self, token: str):
        """Map a string token (e.g. from YAML extensional tables) back to the
        typed domain value."""
        for v in self._values:
            if v == token or str(v) == str(token):
                return v
        raise ValueError(f"{token!r} does not match any value of {self._name}")

    def __iter__(self):
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __getitem__(self, i: int):
        return self._values[i]

    def __contains__(self, v) -> bool:
        return v in self._index

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Domain)
            and other.name == self.name
            and other.values == self.values
            and other.type == self.type
        )

    def __hash__(self) -> int:
        return hash((self._name, self._domain_type, self._values))

    def __repr__(self) -> str:
        return f"Domain({self._name}, {self._domain_type}, {self._values})"


# Alias kept for familiarity with the reference API.
VariableDomain = Domain


def binary_domain(name: str = "binary") -> Domain:
    return Domain(name, "binary", (0, 1))


class Variable(SimpleRepr):
    """A decision variable with a domain and optional initial value."""

    _repr_fields = ("name", "domain", "initial_value")

    def __init__(
        self,
        name: str,
        domain: Union[Domain, Iterable],
        initial_value: Any = None,
    ) -> None:
        self._name = name
        if not isinstance(domain, Domain):
            domain = Domain(f"d_{name}", "unknown", tuple(domain))
        self._domain = domain
        if initial_value is not None and initial_value not in domain:
            raise ValueError(
                f"initial value {initial_value!r} not in domain of {name}"
            )
        self._initial_value = initial_value

    @property
    def name(self) -> str:
        return self._name

    @property
    def domain(self) -> Domain:
        return self._domain

    @property
    def initial_value(self):
        return self._initial_value

    @property
    def has_cost(self) -> bool:
        return False

    def cost_for_val(self, val) -> float:
        return 0.0

    def cost_vector(self) -> List[float]:
        """Unary cost for every domain value, in domain order (compile-time
        tabulation target)."""
        return [self.cost_for_val(v) for v in self._domain]

    def clone(self) -> "Variable":
        return Variable(self._name, self._domain, self._initial_value)

    def __eq__(self, other) -> bool:
        return (
            type(other) is type(self)
            and other.name == self.name
            and other.domain == self.domain
            and other.initial_value == self.initial_value
            # unary costs are part of the variable's identity: two defs of the
            # same variable with different costs must NOT compare equal, or
            # DCOP.add_variable's redefinition guard would silently keep one
            and other.cost_vector() == self.cost_vector()
        )

    def __hash__(self) -> int:
        # initial_value is part of identity, like the reference
        # (tests/unit/test_dcop_variables.py:153); eq already compares it
        return hash(
            (type(self).__name__, self._name, self._domain,
             self._initial_value)
        )

    def __repr__(self) -> str:
        return f"Variable({self._name}, {self._domain.name})"


class BinaryVariable(Variable):
    """A 0/1 variable (used by the repair DCOPs, reference objects.py:335)."""

    def __init__(self, name: str, initial_value: int = 0) -> None:
        super().__init__(name, binary_domain(), initial_value)

    def clone(self) -> "BinaryVariable":
        return BinaryVariable(self._name, self._initial_value)

    @classmethod
    def _from_repr(cls, name, domain=None, initial_value=0):
        return cls(name, initial_value if initial_value is not None else 0)


class VariableWithCostDict(Variable):
    """Variable with a per-value unary cost given as a dict."""

    _repr_fields = ("name", "domain", "costs", "initial_value")

    def __init__(
        self,
        name: str,
        domain: Union[Domain, Iterable],
        costs: Dict[Any, float],
        initial_value: Any = None,
    ) -> None:
        super().__init__(name, domain, initial_value)
        self._costs = dict(costs)

    @property
    def costs(self) -> Dict[Any, float]:
        return dict(self._costs)

    @property
    def has_cost(self) -> bool:
        return True

    def cost_for_val(self, val) -> float:
        return float(self._costs.get(val, 0.0))

    def clone(self) -> "VariableWithCostDict":
        return VariableWithCostDict(
            self._name, self._domain, self._costs, self._initial_value
        )


class VariableWithCostFunc(Variable):
    """Variable whose unary cost is a function (or expression) of its value."""

    def __init__(
        self,
        name: str,
        domain: Union[Domain, Iterable],
        cost_func: Union[Callable, ExpressionFunction],
        initial_value: Any = None,
    ) -> None:
        super().__init__(name, domain, initial_value)
        if isinstance(cost_func, ExpressionFunction):
            if cost_func.variable_names != frozenset({name}):
                raise ValueError(
                    f"cost function of {name} must depend only on {name}, "
                    f"got {set(cost_func.variable_names)}"
                )
        self._cost_func = cost_func

    @property
    def cost_func(self):
        return self._cost_func

    @property
    def has_cost(self) -> bool:
        return True

    def cost_for_val(self, val) -> float:
        if isinstance(self._cost_func, ExpressionFunction):
            return float(self._cost_func(**{self._name: val}))
        return float(self._cost_func(val))

    def clone(self) -> "VariableWithCostFunc":
        return VariableWithCostFunc(
            self._name, self._domain, self._cost_func, self._initial_value
        )

    def _simple_repr(self):
        r = {
            "__qualname__": type(self).__qualname__,
            "__module__": type(self).__module__,
            "name": self._name,
            "domain": self._domain._simple_repr(),
            "initial_value": self._initial_value,
        }
        if isinstance(self._cost_func, ExpressionFunction):
            r["cost_func"] = self._cost_func.expression
        else:
            raise TypeError(
                "only expression-based cost functions are serializable"
            )
        return r

    @classmethod
    def _from_repr(cls, name, domain, cost_func, initial_value=None):
        from ..utils.simple_repr import from_repr as _fr

        return cls(name, _fr(domain), ExpressionFunction(cost_func), initial_value)


class VariableNoisyCostFunc(VariableWithCostFunc):
    """Cost-function variable with bounded uniform noise added per value.

    Mirrors the reference's noise semantics (objects.py:547): at construction a
    noise sample in [0, noise_level) is drawn per domain value and added to the
    cost.  Unlike the reference we accept an explicit ``seed`` so runs are
    reproducible.
    """

    def __init__(
        self,
        name: str,
        domain: Union[Domain, Iterable],
        cost_func: Union[Callable, ExpressionFunction],
        initial_value: Any = None,
        noise_level: float = 0.02,
        seed: Optional[int] = None,
    ) -> None:
        super().__init__(name, domain, cost_func, initial_value)
        self._noise_level = noise_level
        # default seed must be stable across processes (hash() is randomized)
        import zlib

        self._seed = (
            seed if seed is not None else zlib.crc32(name.encode()) & 0xFFFF
        )
        rng = random.Random(self._seed)
        self._noise = {v: rng.uniform(0, noise_level) for v in self._domain}

    @property
    def noise_level(self) -> float:
        return self._noise_level

    def cost_for_val(self, val) -> float:
        return super().cost_for_val(val) + self._noise[val]

    def clone(self) -> "VariableNoisyCostFunc":
        c = VariableNoisyCostFunc(
            self._name,
            self._domain,
            self._cost_func,
            self._initial_value,
            self._noise_level,
            seed=self._seed,
        )
        c._noise = dict(self._noise)
        return c

    def _simple_repr(self):
        r = super()._simple_repr()
        r["__qualname__"] = type(self).__qualname__
        r["noise_level"] = self._noise_level
        r["seed"] = self._seed
        return r

    @classmethod
    def _from_repr(
        cls, name, domain, cost_func, initial_value=None, noise_level=0.02, seed=None
    ):
        from ..utils.simple_repr import from_repr as _fr

        return cls(
            name,
            _fr(domain),
            ExpressionFunction(cost_func),
            initial_value,
            noise_level=noise_level,
            seed=seed,
        )


class ExternalVariable(Variable):
    """A read-only input variable (sensor); supports value-change callbacks
    (reference objects.py:618-664)."""

    def __init__(
        self,
        name: str,
        domain: Union[Domain, Iterable],
        value: Any = None,
    ) -> None:
        super().__init__(name, domain, value)
        self._value = value if value is not None else self._domain[0]
        self._subscribers: List[Callable[[Any], None]] = []

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        if v == self._value:
            return
        if v not in self._domain:
            raise ValueError(f"{v!r} not in domain of external var {self._name}")
        self._value = v
        for cb in self._subscribers:
            cb(v)

    def subscribe(self, callback: Callable[[Any], None]) -> None:
        self._subscribers.append(callback)

    def unsubscribe(self, callback: Callable[[Any], None]) -> None:
        self._subscribers.remove(callback)

    def clone(self) -> "ExternalVariable":
        return ExternalVariable(self._name, self._domain, self._value)


def _name_range(name_or_indexes) -> List[str]:
    if isinstance(name_or_indexes, str):
        return [name_or_indexes]
    return [str(i) for i in name_or_indexes]


def create_variables(
    prefix: str,
    indexes,
    domain: Domain,
    separator: str = "_",
) -> Dict:
    """Mass-create variables named ``prefix + index`` (reference
    objects.py:258).  ``indexes`` may be an iterable or a tuple of iterables
    (cartesian product, keyed by tuples)."""
    variables = {}
    if isinstance(indexes, tuple) and all(
        not isinstance(i, (str, int)) for i in indexes
    ):
        import itertools

        for combo in itertools.product(*indexes):
            key = tuple(str(c) for c in combo)
            name = prefix + separator.join(key)
            variables[key] = Variable(name, domain)
    else:
        for i in indexes:
            name = f"{prefix}{i}"
            variables[str(i)] = Variable(name, domain)
    return variables


def create_binary_variables(
    prefix: str, indexes, separator: str = "_"
) -> Dict:
    variables = {}
    if isinstance(indexes, tuple) and all(
        not isinstance(i, (str, int)) for i in indexes
    ):
        import itertools

        for combo in itertools.product(*indexes):
            key = tuple(str(c) for c in combo)
            name = prefix + separator.join(key)
            variables[key] = BinaryVariable(name)
    else:
        for i in indexes:
            variables[str(i)] = BinaryVariable(f"{prefix}{i}")
    return variables


class AgentDef(SimpleRepr):
    """An agent definition: name, capacity, routes, hosting costs, plus any
    extra attributes (reference objects.py:669-841).

    >>> a = AgentDef('a1', capacity=100, foo='bar')
    >>> a.name, a.capacity, a.foo
    ('a1', 100, 'bar')
    >>> a.route('a2')
    1
    >>> a.hosting_cost('c1')
    0
    """

    def __init__(
        self,
        name: str,
        capacity: float = 100,
        default_route: float = 1,
        routes: Optional[Dict[str, float]] = None,
        default_hosting_cost: float = 0,
        hosting_costs: Optional[Dict[str, float]] = None,
        **extra: Any,
    ) -> None:
        self._name = name
        self._capacity = capacity
        self._default_route = default_route
        self._routes = dict(routes) if routes else {}
        self._default_hosting_cost = default_hosting_cost
        self._hosting_costs = dict(hosting_costs) if hosting_costs else {}
        self._extra = dict(extra)

    @property
    def name(self) -> str:
        return self._name

    @property
    def capacity(self):
        return self._capacity

    @property
    def default_route(self) -> float:
        return self._default_route

    @property
    def routes(self) -> Dict[str, float]:
        return dict(self._routes)

    @property
    def default_hosting_cost(self) -> float:
        return self._default_hosting_cost

    @property
    def hosting_costs(self) -> Dict[str, float]:
        return dict(self._hosting_costs)

    @property
    def extra_attrs(self) -> Dict[str, Any]:
        return dict(self._extra)

    def route(self, other_agent: str) -> float:
        if other_agent == self._name:
            return 0
        return self._routes.get(other_agent, self._default_route)

    def hosting_cost(self, computation: str) -> float:
        return self._hosting_costs.get(computation, self._default_hosting_cost)

    def __getattr__(self, item):
        # only called when normal lookup fails: expose extra attrs
        extra = self.__dict__.get("_extra", {})
        if item in extra:
            return extra[item]
        raise AttributeError(f"AgentDef has no attribute {item!r}")

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, AgentDef)
            and other.name == self.name
            and other.capacity == self.capacity
            and other._routes == self._routes
            and other._hosting_costs == self._hosting_costs
            and other._default_route == self._default_route
            and other._default_hosting_cost == self._default_hosting_cost
            and other._extra == self._extra
        )

    def __hash__(self) -> int:
        return hash(("AgentDef", self._name))

    def __repr__(self) -> str:
        return f"AgentDef({self._name})"

    def _simple_repr(self):
        r = {
            "__qualname__": "AgentDef",
            "__module__": type(self).__module__,
            "name": self._name,
            "capacity": self._capacity,
            "default_route": self._default_route,
            "routes": dict(self._routes),
            "default_hosting_cost": self._default_hosting_cost,
            "hosting_costs": dict(self._hosting_costs),
        }
        r.update(self._extra)
        return r


def create_agents(
    prefix: str,
    indexes,
    default_route: float = 1,
    routes: Optional[Dict[str, float]] = None,
    default_hosting_costs: float = 0,
    hosting_costs: Optional[Dict[str, float]] = None,
    **kwargs: Any,
) -> Dict[str, AgentDef]:
    """Mass-create agents ``prefix + index`` (reference objects.py:879)."""
    agents = {}
    for i in indexes:
        name = f"{prefix}{i}"
        agents[str(i)] = AgentDef(
            name,
            default_route=default_route,
            routes=routes or {},
            default_hosting_cost=default_hosting_costs,
            hosting_costs=hosting_costs or {},
            **kwargs,
        )
    return agents
