"""DPOP of the port against the JAX package's, on the CPU.

The cases of the JAX package's ``TestDpop`` and ``TestDpopFusedWave``
(``tests/test_algorithms.py``), held against the JAX package on the same
problem (object-level problems carried across as YAML text).  DPOP is
exact: the costs of integer-valued tables are equal, and so are the
assignments, since both packages contract the same batches in the same
order and take the first minimum (``argmin``).  Where a table is drawn
from a float distribution the cost is held to rel 1e-5 against an
independent float64 DP.  DPOP's card tests are in
``test_torch_kernels.py``, which runs on the card without the JAX
package.
"""

import contextlib
import itertools
import random

import numpy as np
import pytest
import torch
from test_torch_engine import _ReplayedBody

import pydcop_tpu.dcop as J
from pydcop_tpu import solve_result as jax_solve_result
from pydcop_tpu.algorithms import dpop as jax_dpop
from pydcop_tpu.commands.generators.meetingscheduling import (
    generate_meeting_scheduling as jax_meetings,
)
from pydcop_tpu.compile.core import compile_dcop as jax_compile
import pydcop_tpu_torch.dcop as P
from pydcop_tpu_torch.algorithms import dpop
from pydcop_tpu_torch.api import solve_result
from pydcop_tpu_torch.commands.generators.meetingscheduling import (
    generate_meeting_scheduling,
)
from pydcop_tpu_torch.compile.core import compile_dcop
from pydcop_tpu_torch.compile.direct import compile_from_edges

CONFIG_5 = dict(slots_count=8, resources_count=30, events_count=30,
                max_resources_event=2, seed=5)
SMALL_MEETINGS = dict(slots_count=4, resources_count=10, events_count=10,
                      max_resources_event=2, seed=5)


def _both(text):
    """The JAX package's DCOP and the port's, from one YAML text."""
    return J.load_dcop(text), P.load_dcop(text)


def _chain_yaml():
    return """
name: chain
objective: min
domains: {c: {values: [R, G]}}
variables: {x: {domain: c}, y: {domain: c}, z: {domain: c}}
constraints:
  c1: {type: intention, function: "10 if x == y else 0"}
  c2: {type: intention, function: "10 if y == z else 0"}
"""


def _random_binary_yaml(trial, rng, n=6, n_c=8, d=3, objective="min"):
    lines = [f"name: t{trial}", f"objective: {objective}",
             f"domains: {{d: {{values: [0 .. {d - 1}]}}}}", "variables:"]
    lines += [f"  v{i}: {{domain: d}}" for i in range(n)]
    lines.append("constraints:")
    for k in range(n_c):
        i, j = rng.sample(range(n), 2)
        coeffs = [rng.randint(0, 9) for _ in range(d * d)]
        expr = f"[{','.join(map(str, coeffs))}][v{i}*{d}+v{j}]"
        lines.append(f'  c{k}: {{type: intention, function: "{expr}"}}')
    return "\n".join(lines) + "\n"


def _brute_force(dcop):
    names = sorted(dcop.variables)
    best = None
    for combo in itertools.product(
        *(dcop.variables[n].domain.values for n in names)
    ):
        cost, _ = dcop.solution_cost(dict(zip(names, combo)))
        if best is None or cost < best:
            best = cost
    return best


def _same(port, ref):
    """Result dicts equal in every field but ``time``."""
    assert {k: v for k, v in port.items() if k != "time"} == {
        k: v for k, v in ref.items() if k != "time"
    }


def test_chain_optimal():
    ref, port = _both(_chain_yaml())
    r = solve_result(port, "dpop", device="cpu")
    assert r["cost"] == 0.0 and r["violation"] == 0 and r["cycle"] == 1
    _same(r, jax_solve_result(ref, "dpop"))


def test_random_binary_matches_brute_force_and_jax():
    rng = random.Random(7)
    for trial in range(4):
        ref, port = _both(_random_binary_yaml(trial, rng))
        r = solve_result(port, "dpop", device="cpu")
        assert r["cost"] == _brute_force(port)
        _same(r, jax_solve_result(ref, "dpop"))


def test_ternary_constraint():
    ref, port = _both("""
name: tern
objective: min
domains: {d: {values: [0, 1]}}
variables: {x: {domain: d}, y: {domain: d}, z: {domain: d}}
constraints:
  c1: {type: intention, function: "(x + y + z - 1) ** 2"}
  c2: {type: intention, function: "3 * x"}
""")
    r = solve_result(port, "dpop", device="cpu")
    assert r["cost"] == 0.0 and r["assignment"]["x"] == 0
    _same(r, jax_solve_result(ref, "dpop"))


def test_forest():
    # two disconnected components, each solved at its own root
    ref, port = _both("""
name: forest
objective: min
domains: {d: {values: [0, 1]}}
variables: {a: {domain: d}, b: {domain: d}, c: {domain: d}, e: {domain: d}}
constraints:
  c1: {type: intention, function: "0 if a != b else 5"}
  c2: {type: intention, function: "0 if c != e else 7"}
""")
    r = solve_result(port, "dpop", device="cpu")
    assert r["cost"] == 0.0
    _same(r, jax_solve_result(ref, "dpop"))


def test_max_mode():
    rng = random.Random(3)
    for trial in range(3):
        ref, port = _both(_random_binary_yaml(trial, rng, objective="max"))
        r = solve_result(port, "dpop", device="cpu")
        names = sorted(port.variables)
        best = max(
            port.solution_cost(dict(zip(names, combo)))[0]
            for combo in itertools.product(range(3), repeat=len(names))
        )
        assert r["cost"] == best
        _same(r, jax_solve_result(ref, "dpop"))


def test_deep_tree_2k_vars_against_numpy_dp():
    # a deep random tree (depth ~800, more levels than the fused wave's
    # batch cap, so it streams); exact up to float32 sums, checked against
    # an independent float64 DP to rel 1e-5
    n = 2000
    rng = np.random.default_rng(3)
    parents = np.array([rng.integers(max(0, i - 4), i) for i in range(1, n)])
    edges = np.stack([parents, np.arange(1, n)], axis=1)
    tables = rng.uniform(0, 10, size=(len(edges), 3, 3)).astype(np.float32)
    c = compile_from_edges(n, 3, edges, tables)
    r = dpop.solve(c, {}, device="cpu")
    assert c._device_consts[("dpop_fused_plan",)] is None
    util = np.zeros((n, 3))
    for i in range(n - 1, 0, -1):
        p = parents[i - 1]
        util[p] += (tables[i - 1].astype(np.float64) + util[i]).min(axis=1)
    assert r.cost == pytest.approx(float(util[0].min()), rel=1e-5)


def test_chunked_fallback_matches_in_core_and_jax(monkeypatch):
    rng = random.Random(11)
    text = _random_binary_yaml(0, rng, n=7, n_c=10)
    ref, port = _both(text)
    want = jax_dpop.solve(jax_compile(ref), {})
    baseline = dpop.solve(compile_dcop(port), {}, device="cpu")
    monkeypatch.setattr(dpop, "MAX_JOINT_ELEMS", 9)
    monkeypatch.setattr(dpop, "CHUNK_ELEMS", 9)
    chunks = dpop.solve.chunks
    chunked = dpop.solve(compile_dcop(port), {}, device="cpu")
    assert dpop.solve.chunks > chunks
    assert chunked == baseline
    assert tuple(chunked) == tuple(want)


def _meetings(kw):
    return compile_dcop(generate_meeting_scheduling(**kw))


def _random_tree(pkg, compile_fn):
    rng = np.random.default_rng(17)
    n = 200
    d = pkg.Domain("d", "", [0, 1, 2])
    vs = [pkg.Variable(f"v{i}", d) for i in range(n)]
    dcop = pkg.DCOP("tree")
    for i in range(1, n):
        p = int(rng.integers(0, i))
        w = rng.integers(0, 7, size=(3, 3))
        expr = "[" + ",".join(
            "[" + ",".join(str(int(x)) for x in row) + "]" for row in w
        ) + f"][v{p}][v{i}]"
        dcop += pkg.constraint_from_str(f"c{i}", expr, [vs[p], vs[i]])
    dcop.add_agents([])
    return compile_fn(dcop)


@pytest.mark.parametrize("case", ["meetings", "tree"])
def test_fused_matches_streaming_and_jax(case, monkeypatch):
    if case == "meetings":
        make = lambda: _meetings(SMALL_MEETINGS)  # noqa: E731
        ref = jax_compile(jax_meetings(**SMALL_MEETINGS))
    else:
        make = lambda: _random_tree(P, compile_dcop)  # noqa: E731
        ref = _random_tree(J, jax_compile)
    want = jax_dpop.solve(ref, {})
    c1, c2 = make(), make()
    fused = dpop.solve(c1, {}, device="cpu")
    assert c1._device_consts[("dpop_fused_plan",)] is not None
    monkeypatch.setattr(dpop, "_plan_fused_wave", lambda *a: None)
    stream = dpop.solve(c2, {}, device="cpu")
    assert fused == stream
    assert tuple(fused) == tuple(want)


def test_config5_full_size_like_jax():
    ref = jax_dpop.solve(jax_compile(jax_meetings(**CONFIG_5)), {})
    c = _meetings(CONFIG_5)
    r = dpop.solve(c, {}, device="cpu")
    assert c._device_consts[("dpop_fused_plan",)] is not None
    assert (r.cost, r.violations, r.msg_count, r.msg_size) == (
        248.0, 0, 78, 67_261
    )
    assert tuple(r) == tuple(ref)


def test_deep_chain_streams():
    # one batch per level on a chain: the descriptor cap routes deep
    # trees to the streaming path
    n = dpop.FUSED_WAVE_MAX_BATCHES + 40
    d = P.Domain("d", "", [0, 1])
    vs = [P.Variable(f"v{i}", d) for i in range(n)]
    dcop = P.DCOP("chain")
    for i in range(n - 1):
        dcop += P.constraint_from_str(
            f"c{i}", f"1 if v{i} == v{i+1} else 0", [vs[i], vs[i + 1]]
        )
    dcop.add_agents([])
    c = compile_dcop(dcop)
    r = dpop.solve(c, {}, device="cpu")
    assert c._device_consts[("dpop_fused_plan",)] is None
    assert r.cost == 0.0


def test_warm_fused_solve_builds_and_uploads_nothing():
    c = _meetings(SMALL_MEETINGS)
    cold = dpop.solve(c, {}, device="cpu")
    cached = dict(c._device_consts)
    warm = dpop.solve(c, {}, device="cpu")
    assert warm == cold
    assert c._device_consts.keys() == cached.keys()
    assert all(c._device_consts[k] is v for k, v in cached.items())


def test_elems_budget_routes_to_streaming(monkeypatch):
    fused = dpop.solve(_meetings(SMALL_MEETINGS), {}, device="cpu")
    monkeypatch.setattr(dpop, "FUSED_WAVE_MAX_ELEMS", 8)
    c = _meetings(SMALL_MEETINGS)
    r = dpop.solve(c, {}, device="cpu")
    assert c._device_consts[("dpop_fused_plan",)] is None
    assert r == fused


def test_captured_wave_rehearsed_on_the_cpu(monkeypatch):
    # the card's runner (warm-up, one capture, replays reading the
    # captured output), rehearsed on the CPU with a graph that reruns its
    # body: the same argmin tables as the eager wave
    c = _meetings(SMALL_MEETINGS)
    eager = dpop.solve(c, {}, device="cpu")
    wave = c._device_consts[("dpop_fused_wave", "cpu")]
    want = wave.run()
    monkeypatch.setattr(dpop, "_capture", _ReplayedBody)
    monkeypatch.setattr(dpop, "_side_stream",
                        lambda device: contextlib.nullcontext())
    captures, replays = dpop.solve.captures, dpop.solve.replays
    wave.capture()
    assert np.array_equal(wave.run(), want)
    assert np.array_equal(wave.run(), want)
    assert dpop.solve.captures == captures + 1
    assert dpop.solve.replays == replays + 2
    assert dpop.solve(c, {}, device="cpu") == eager
    assert dpop.solve.captures == captures + 1


def test_memory_guard(monkeypatch):
    for mod in (jax_dpop, dpop):
        monkeypatch.setattr(mod, "MAX_OUTPUT_ELEMS", 8)
    with pytest.raises(MemoryError, match="induced width"):
        jax_dpop.solve(jax_compile(jax_meetings(**SMALL_MEETINGS)), {})
    with pytest.raises(MemoryError, match="induced width"):
        dpop.solve(_meetings(SMALL_MEETINGS), {}, device="cpu")


def test_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="mesh"):
        dpop.solve(_meetings(SMALL_MEETINGS), {}, mesh=object(),
                   device="cpu")


def test_solve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dpop.solve(_meetings(SMALL_MEETINGS), {})


@pytest.mark.parametrize("kw", [SMALL_MEETINGS, CONFIG_5])
def test_batches_and_gather_maps_are_jax_s(kw):
    # every batch of the UTIL wave: the same nodes, source layout and
    # segments as the JAX package's _batch_layout, and the gather map the
    # port builds on the device equal to the one JAX builds with numpy
    ref = jax_compile(jax_meetings(**kw))
    port = _meetings(kw)
    jtree, ptree = jax_dpop._Tree(ref), dpop._Tree(port)
    d = port.max_domain
    loc = {}
    schedules = zip(
        jax_dpop._wave_schedule(ref, jtree, d),
        dpop._wave_schedule(port, ptree, d),
    )
    for bid, ((jkind, jbatch, jm), (kind, batch, m)) in enumerate(schedules):
        assert (jkind, jbatch, jm) == (kind, batch, m)
        if kind != "batch":
            continue
        want = jax_dpop._batch_layout(ref, jtree, batch, m, d, loc.get)
        got = dpop._batch_layout(port, ptree, batch, m, d, loc.get)
        for f in ("unary_only", "size", "ng_pad", "src_pad", "est_elems"):
            assert getattr(got, f) == getattr(want, f), f
        assert np.array_equal(got.group_ids, want.group_ids)
        for (bi, rows), (jbi, jrows) in zip(got.bucket_rows,
                                            want.bucket_rows):
            assert bi == jbi and np.array_equal(rows, jrows)
        assert [(k, None if r is None else list(r), n)
                for k, r, n in got.child_parts] == [
            (k, None if r is None else list(r), n)
            for k, r, n in want.child_parts
        ]
        if not want.unary_only:
            assert np.array_equal(got.seg_ids, want.seg_ids)
            gathered = dpop._gather_matrix(got, d, "cpu").numpy()
            assert gathered.dtype == want.idx_mat.dtype
            assert np.array_equal(gathered, want.idx_mat)
        for slot, i in enumerate(batch):
            loc[i] = (bid, slot, got.size // d)
