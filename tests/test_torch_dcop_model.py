"""The port's object-level model against the JAX package's, on the CPU.

Object-level problems cross between the packages as YAML text: the JAX
package's ``dcop_yaml``, then the port's ``load_dcop``; the port's own
``dcop_yaml`` is pinned text-equal to JAX's.  Compiled arrays are held
bit-identical (``np.array_equal`` and the same dtype) field by field.
Costs from ``solution_cost`` are float64 sums of the same relations in the
same order: equal exactly.
"""

from pathlib import Path

import numpy as np
import pytest
from test_torch_compile import _assert_compiled_equal

import pydcop_tpu.dcop as J
from pydcop_tpu.algorithms.base import finalize as jax_finalize
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_graph_coloring as jax_graph_coloring,
)
from pydcop_tpu.commands.generators.meetingscheduling import (
    generate_meeting_scheduling as jax_meetings,
)
from pydcop_tpu.compile.core import compile_dcop as jax_compile
from pydcop_tpu.compile.tabulate import tabulate_constraint as jax_tabulate
from pydcop_tpu.utils.expressions import ExpressionFunction as JaxExpression
import pydcop_tpu_torch.dcop as P
from pydcop_tpu_torch.algorithms import AlgorithmDef, base
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_graph_coloring,
)
from pydcop_tpu_torch.commands.generators.meetingscheduling import (
    generate_meeting_scheduling,
)
from pydcop_tpu_torch.compile.core import compile_dcop, table_bytes
from pydcop_tpu_torch.compile.tabulate import tabulate_constraint
from pydcop_tpu_torch.utils.expressions import ExpressionFunction
from pydcop_tpu_torch.utils.simple_repr import from_repr, simple_repr

INSTANCES = sorted(
    str(p)
    for p in (Path(__file__).parent / "instances").glob("*.yaml")
    if p.name != "chaos_kill_repair.yaml"  # a fault schedule, not a DCOP
)

# the object generators' problems: (generator name, kwargs)
GENERATED = {
    "gc_random": ("graph_coloring", dict(
        variables_count=40, colors_count=3, seed=2)),
    "gc_scalefree_soft": ("graph_coloring", dict(
        variables_count=60, colors_count=4, graph="scalefree", m_edge=2,
        soft=True, seed=7)),
    "gc_grid_hard": ("graph_coloring", dict(
        variables_count=25, colors_count=3, graph="grid", soft=False,
        seed=1)),
    "meetings": ("meetings", dict(
        slots_count=4, resources_count=10, events_count=10,
        max_resources_event=2, seed=5)),
    "meetings_config5": ("meetings", dict(
        slots_count=8, resources_count=30, events_count=30,
        max_resources_event=2, seed=5)),
}

# a YAML problem with everything the loader reads: ranges, extensional
# tables with a default, an expression and a multi-line function,
# partial application, a variable cost function, an external variable,
# agents with routes and hosting costs, and distribution hints
RICH_YAML = """
name: rich
objective: {objective}
domains:
  levels: {{values: [0 .. 3], type: level}}
  neg: {{values: '-2 .. 1'}}
  colors: {{values: [R, G, B]}}
variables:
  x: {{domain: levels, initial_value: 2}}
  y: {{domain: levels, cost_function: "0.25 * y"}}
  z: {{domain: neg}}
  c: {{domain: colors}}
external_variables:
  e: {{domain: levels, initial_value: 1}}
constraints:
  ext:
    type: extensional
    variables: [x, c]
    default: 0.5
    values:
      3: 1 R | 2 G
      0.1: 0 B
  fun:
    type: intention
    function: "abs(x - y) * 0.7 + (3 if z < 0 else 0.2)"
  multi:
    type: intention
    function: |
      if y == z:
          return 10000
      return 0.3 * (y + z) + e
  part:
    type: intention
    function: "x * y * 0.1 + e"
    partial: {{e: 2}}
agents:
  a1: {{capacity: 10}}
  a2: {{capacity: 20}}
routes:
  default: 2
  a1: {{a2: 5}}
hosting_costs:
  a1: {{default: 3, computations: {{x: 1}}}}
distribution_hints:
  must_host: {{a1: [x]}}
  host_with: {{x: [y]}}
"""


def _jax_generate(kind, kw):
    return (jax_graph_coloring if kind == "graph_coloring"
            else jax_meetings)(**kw)


def _port_generate(kind, kw):
    return (generate_graph_coloring if kind == "graph_coloring"
            else generate_meeting_scheduling)(**kw)


def _random_assignments(dcop, n, seed):
    rng = np.random.default_rng(seed)
    names = sorted(dcop.variables)
    return [
        {
            v: dcop.variables[v].domain.values[
                int(rng.integers(len(dcop.variables[v].domain)))
            ]
            for v in names
        }
        for _ in range(n)
    ]


@pytest.mark.parametrize("path", INSTANCES, ids=lambda p: Path(p).stem)
def test_instances_load_and_compile_like_jax(path):
    ref = J.load_dcop_from_file(path)
    port = P.load_dcop_from_file(path)
    assert P.dcop_yaml(port) == J.dcop_yaml(ref)
    rc, pc = jax_compile(ref), compile_dcop(port)
    _assert_compiled_equal(pc, rc)
    assert pc.dcop is port
    assert table_bytes(pc) == sum(b.tables.nbytes for b in rc.buckets) + (
        rc.unary.nbytes
    )
    for a, b in zip(pc.csr_adjacency(), rc.csr_adjacency()):
        assert np.array_equal(a, b)
    assert np.array_equal(pc.initial_indices(), rc.initial_indices())
    for assignment in _random_assignments(port, 20, seed=3):
        assert port.solution_cost(assignment) == ref.solution_cost(assignment)
        assert np.array_equal(
            pc.indices_from_assignment(assignment),
            rc.indices_from_assignment(assignment),
        )


@pytest.mark.parametrize("objective", ["min", "max"])
def test_rich_yaml_round_trips_and_costs_like_jax(objective):
    text = RICH_YAML.format(objective=objective)
    ref, port = J.load_dcop(text), P.load_dcop(text)
    assert P.dcop_yaml(port) == J.dcop_yaml(ref)
    # the port reads back the JAX package's dump, and its own
    again = P.load_dcop(J.dcop_yaml(ref))
    assert P.dcop_yaml(again) == J.dcop_yaml(ref)
    assert port.dist_hints == from_repr(simple_repr(port.dist_hints))
    assert port.dist_hints.must_host == ref.dist_hints.must_host
    assert port.dist_hints.host_with == ref.dist_hints.host_with
    rc, pc = jax_compile(ref), compile_dcop(port)
    _assert_compiled_equal(pc, rc)
    assert np.array_equal(pc.initial_indices(), rc.initial_indices())
    for infinity in (10000, 5):
        for assignment in _random_assignments(port, 20, seed=11):
            assert port.solution_cost(assignment, infinity) == (
                ref.solution_cost(assignment, infinity)
            )


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generators_give_jax_problems(name):
    kind, kw = GENERATED[name]
    ref, port = _jax_generate(kind, kw), _port_generate(kind, kw)
    text = J.dcop_yaml(ref)
    assert P.dcop_yaml(port) == text
    carried = P.load_dcop(text)
    rc = jax_compile(ref)
    for ported in (compile_dcop(port), compile_dcop(carried)):
        _assert_compiled_equal(ported, rc)
    for assignment in _random_assignments(port, 20, seed=5):
        assert port.solution_cost(assignment) == ref.solution_cost(assignment)


EXPRESSIONS = [
    ("10000 if a == b else 0", "ab"),
    ("abs(a - b) * 0.1 + c", "abc"),
    ("(a + b + c - 1) ** 2", "abc"),
    ("a * 2 if a > b and b != c else (b or c) * 0.3", "abc"),
    ("not a or b", "ab"),
    ("min(a, b) - max(b, c) / 3", "abc"),
    ("math.sqrt(a + b) + math.floor(c / 2)", "abc"),
    ("[1.5, 2, 3.25][a] * [0, 1, 4][b]", "ab"),
    ("x = a + b\nreturn x * x - c", "abc"),
    (" a - b", "ab"),  # a leading space, as hand-written YAML has
]


@pytest.mark.parametrize("expr, scope", EXPRESSIONS)
def test_constraint_from_str_tabulates_like_jax(expr, scope):
    out = []
    for pkg, tab in ((J, jax_tabulate), (P, tabulate_constraint)):
        d = pkg.Domain("d", "", [0, 1, 2])
        vs = [pkg.Variable(n, d) for n in scope]
        c = pkg.constraint_from_str("c", expr, vs)
        out.append((c.scope_names, tab(c)))
    (ref_scope, ref), (port_scope, port) = out
    assert port_scope == ref_scope
    assert port.dtype == ref.dtype and np.array_equal(port, ref)


REFUSED = [
    "a +",  # a syntax error
    "if a:\n    b = 1",  # a body with no return
    "def f():\n    return a\n",  # a return only inside a nested def
    "a ==",
    "lambda: ",
]


@pytest.mark.parametrize("expr", REFUSED)
def test_expressions_jax_refuses_are_refused(expr):
    with pytest.raises(Exception) as ref:
        JaxExpression(expr)
    with pytest.raises(type(ref.value)):
        ExpressionFunction(expr)


def test_unknown_fixed_variables_are_refused_alike():
    with pytest.raises(ValueError):
        JaxExpression("a + b", c=1)
    with pytest.raises(ValueError):
        ExpressionFunction("a + b", c=1)
    assert ExpressionFunction("a + b").partial(b=3)(a=1) == 4


@pytest.mark.parametrize("values, want", [
    ("[1 .. 10]", list(range(1, 11))),
    ("'-3 .. 2'", list(range(-3, 3))),
    ("[0 .. 0]", [0]),
    ("[a, b, 3]", ["a", "b", 3]),
])
def test_range_expansion(values, want):
    text = (
        "name: r\nobjective: min\n"
        f"domains:\n  d: {{values: {values}}}\n"
        "variables:\n  x: {domain: d}\n"
    )
    port, ref = P.load_dcop(text), J.load_dcop(text)
    assert list(port.domains["d"].values) == want
    assert port.domains["d"].values == ref.domains["d"].values


def test_bad_yaml_is_refused_alike():
    for text in (
        "name: n\ndomains: {}\n",  # no objective
        "objective: min\n",  # no name
        "name: n\nobjective: min\nvariables:\n  x: {domain: nope}\n",
        "name: n\nobjective: min\ndomains:\n  d: {values: '1 to 3'}\n",
    ):
        with pytest.raises(J.yamldcop.DcopInvalidFormatError):
            J.load_dcop(text)
        with pytest.raises(P.yamldcop.DcopInvalidFormatError):
            P.load_dcop(text)


# a problem whose exact cost the clamped float32 tables cannot give: its
# costs are decimals float32 does not hold, and one variable's cost
# function reaches ``infinity`` (a cost, not a violation, to
# ``solution_cost``; a violation to the tables' ``host_cost``)
REPAIR_YAML = """
name: repair
objective: min
domains:
  d: {values: [0, 1, 2]}
variables:
  x: {domain: d}
  y: {domain: d, cost_function: "10000 if y == 2 else 0.3"}
  z: {domain: d}
constraints:
  c1: {type: intention, function: "0.1 if x == y else 0.7"}
  c2: {type: intention, function: "float('inf') if y == z else 0.2 * z"}
"""


@pytest.mark.parametrize("values", [[0, 2, 1], [1, 1, 1], [2, 0, 2]])
def test_finalize_costs_the_relations_like_jax(values):
    ref, port = J.load_dcop(REPAIR_YAML), P.load_dcop(REPAIR_YAML)
    rc, pc = jax_compile(ref), compile_dcop(port)
    idx = np.asarray(values, dtype=np.int32)
    want = jax_finalize(rc, idx, cycles=1, msg_count=0, msg_size=0)
    got = base.finalize(pc, idx, cycles=1, msg_count=0, msg_size=0)
    assert got == tuple(want)
    assignment = pc.assignment_from_indices(idx)
    assert (got.cost, got.violations) == port.solution_cost(assignment)
    # the path the port took before: the clamped float32 tables
    assert pc.host_cost(idx) != (got.cost, got.violations)
    # an array-only problem still costs its tables
    pc.dcop = None
    assert base.finalize(pc, idx, 1, 0, 0).cost == pc.host_cost(idx)[0]


def test_algorithm_def_round_trips():
    a = AlgorithmDef.build_with_default_param(
        "maxsum", {"damping": "0.7"}, mode="max"
    )
    assert a.params["damping"] == 0.7 and a.mode == "max"
    assert from_repr(simple_repr(a)) == a
    with pytest.raises(ValueError, match="unknown parameter"):
        AlgorithmDef.build_with_default_param("dsa", {"nope": 1})
