"""Health telemetry (``telemetry/pulse.py`` and the engine's health
rows) against the JAX package, both on the CPU.

- The host side is the JAX package's module copied: the same schema, and
  ``analyze``, ``flip_summary``, the flight recorder and the postmortem
  rendering give JAX's outputs on the same inputs.
- Every engine solver's health rows equal JAX's on the same problem,
  seed and params.  Bit for bit: ``cost`` and ``best_cost`` (``evaluate``
  in XLA's order), ``flips``, ``churn``, ``flipback``, ``violations``
  (counts and one float32 division), the local-search ``residual`` (a
  maximum) and ``aux`` (the mean gain, summed with ``xla_sum``), DBA's
  weight delta and GDBA's modifier delta (``xla_sum``) and their
  ``aux``.  The MaxSum family's ``residual`` and ``aux`` are the largest
  change of each message plane in a cycle: the planes are JAX's bit for
  bit (float32 planes damped in XLA's FMA form, ``damp``'s ``fma``), so
  these two fields are too.
- Pulse changes no result: the trajectory with pulse on is the one
  with pulse off, and a solve makes as many host syncs with pulse on as
  off; with pulse off the graphs are those captured without it (a warm
  pulse-off solve after a pulse-on one captures nothing).
"""

import contextlib
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch
from test_torch_engine import _ReplayedBody
from test_torch_lanes import port_of

from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_coloring,
)
from pydcop_tpu.commands.generators.mixedproblem import (
    generate_mixed_problem as jax_mixed_problem,
)
from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
from pydcop_tpu_torch.algorithms import base
from pydcop_tpu_torch.compile.core import compile_dcop
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Domain, Variable
from pydcop_tpu_torch.dcop.relations import constraint_from_str
from pydcop_tpu_torch.telemetry.pulse import (
    HEALTH_FIELDS,
    HEALTH_WIDTH,
    POSTMORTEM_FORMAT,
    FlightRecorder,
    analyze,
    flip_summary,
    load_postmortem,
    pulse,
    render_postmortem,
)

# the modules (each package's ``telemetry`` exports the singleton
# ``pulse`` under the module's name)
jax_pulse_mod = importlib.import_module("pydcop_tpu.telemetry.pulse")
pulse_mod = importlib.import_module("pydcop_tpu_torch.telemetry.pulse")

F = {name: i for i, name in enumerate(HEALTH_FIELDS)}


def row(cost=0.0, best=0.0, flips=0.0, churn=0.0, flipback=0.0,
        residual=0.0, aux=0.0, violations=0.0):
    r = [0.0] * HEALTH_WIDTH
    r[F["cost"]], r[F["best_cost"]], r[F["flips"]] = cost, best, flips
    r[F["churn"]], r[F["flipback"]] = churn, flipback
    r[F["residual"]], r[F["aux"]], r[F["violations"]] = (
        residual, aux, violations,
    )
    return r


@pytest.fixture
def pulse_on():
    """Both packages' monitors on for one test, reset both ways."""
    for p in (pulse, jax_pulse_mod.pulse):
        p.reset()
        p.enabled = True
    yield pulse
    for p in (pulse, jax_pulse_mod.pulse):
        p.enabled = False
        p.reset()


# ---------------------------------------------------------------------------
# the host side: the JAX package's outputs on the same inputs
# ---------------------------------------------------------------------------


def test_schema_is_jax_s():
    assert HEALTH_FIELDS == jax_pulse_mod.HEALTH_FIELDS == (
        "cost", "best_cost", "flips", "churn", "flipback",
        "residual", "aux", "violations",
    )
    assert HEALTH_WIDTH == jax_pulse_mod.HEALTH_WIDTH == 8
    assert POSTMORTEM_FORMAT == jax_pulse_mod.POSTMORTEM_FORMAT
    assert pulse_mod.DIAGNOSES == jax_pulse_mod.DIAGNOSES


BIG = 1.0e9
STREAMS = {
    "no_data": ([], {}),
    "still_improving": ([row(cost=10 - i, best=10 - i) for i in range(10)],
                        {}),
    "converged": ([row(cost=3.0, best=3.0)] * 10, {}),
    "converged_after_early_churn": (
        [row(cost=5.0, best=0.0, flips=3, churn=1.0)]
        + [row(cost=0.0, best=0.0)] * 15, {}),
    "oscillating_period_3": (
        [row(cost=c, best=4.0, flips=2, churn=0.5)
         for c in [4.0, 7.0, 5.0] * 8], {}),
    "oscillating_flipback": (
        [row(cost=10.0, best=10.0, flips=2, churn=1.0, flipback=1.0)] * 12,
        {}),
    "big_base_improving": (
        [row(cost=BIG - 10.0 * i, best=BIG - 10.0 * i, flips=1, churn=0.1)
         for i in range(32)], {}),
    "big_base_oscillating": (
        [row(cost=BIG + (10.0 if i % 2 else -10.0), best=BIG - 10.0,
             flips=2, churn=1.0) for i in range(32)], {}),
    "one_flipper": ([row(cost=5.0, best=5.0, flips=1.0, churn=1e-5)] * 32,
                    {}),
    "old_flipback": (
        [row(cost=10.0, best=10.0, flips=2, churn=1.0, flipback=1.0)] * 24
        + [row(cost=10.0, best=10.0, flips=2, churn=1.0, flipback=0.0)] * 8,
        {"tail": 32}),
    "stalled_plateau": (
        [row(cost=c, best=5.0, flips=1, churn=0.3)
         for c in [5.0, 6.0, 5.5, 7.0, 5.3, 6.6, 5.9, 7.1, 5.2, 6.1, 5.7,
                   7.3, 5.6, 6.9, 5.8, 6.3]], {}),
    "window_limits_lookback": (
        [row(cost=10.0 - i, best=10.0 - i) for i in range(10)]
        + [row(cost=1.0, best=1.0)] * 40, {"tail": 32}),
}
EXPECTED = {
    "no_data": "no-data", "still_improving": "still-improving",
    "converged": "converged", "converged_after_early_churn": "converged",
    "oscillating_period_3": "oscillating(period=3)",
    "oscillating_flipback": "oscillating(period=2)",
    "big_base_improving": "still-improving",
    "big_base_oscillating": "oscillating(period=2)",
    "one_flipper": "stalled-plateau", "old_flipback": "stalled-plateau",
    "stalled_plateau": "stalled-plateau",
    "window_limits_lookback": "converged",
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_analyze_gives_jax_s_diagnosis(case):
    rows, kw = STREAMS[case]
    got = analyze(rows, **kw)
    assert got == jax_pulse_mod.analyze(rows, **kw)
    assert got["diagnosis_full"] == EXPECTED[case]


@pytest.mark.parametrize("counts, cycles", [
    ([0, 0, 5, 1, 9], 10), ([], 0), ([3] * 7 + [0] * 5, 4),
    (list(range(12)), 20),
])
def test_flip_summary_is_jax_s(counts, cycles):
    assert flip_summary(counts, cycles) == jax_pulse_mod.flip_summary(
        counts, cycles
    )


def _recorders():
    out = []
    for cls in (FlightRecorder, jax_pulse_mod.FlightRecorder):
        r = cls(capacity=4)
        r.reset({"algo": "t", "seed": 3})
        r.record([row(cost=float(i)) for i in range(10)], start_cycle=0)
        r.set_flip_summary(flip_summary([0, 4, 1], cycles=10))
        out.append(r)
    return out


def test_flight_recorder_ring_is_jax_s():
    ours, theirs = (r.snapshot() for r in _recorders())
    ours.pop("time"), theirs.pop("time")
    assert ours == theirs
    assert ours["start_cycle"] == 6 and len(ours["rows"]) == 4
    assert [x[F["cost"]] for x in ours["rows"]] == [6.0, 7.0, 8.0, 9.0]
    assert _recorders()[0].ring() == _recorders()[1].ring()


def test_dump_once_per_reason_class_and_readable_by_jax(pulse_on,
                                                        tmp_path):
    rec = pulse_on.recorder
    rec.reset({"algo": "t", "seed": 3})
    rec.record([row(cost=1.0)], 0)
    p = str(tmp_path / "pm.json")
    assert rec.maybe_dump("solve-timeout", p) == p
    assert rec.maybe_dump("solve-timeout", p) is None
    assert rec.maybe_dump("agent-crash:a1", p) == p
    assert rec.maybe_dump("agent-crash:a2", p) is None
    doc = jax_pulse_mod.load_postmortem(p)
    assert doc == load_postmortem(p)
    assert doc["reason"] == "agent-crash:a1" and doc["meta"]["seed"] == 3
    assert render_postmortem(doc) == jax_pulse_mod.render_postmortem(doc)


def test_dump_is_a_no_op_with_pulse_off(tmp_path):
    pulse.reset()
    assert pulse.enabled is False
    pulse.recorder.record([row()], 0)
    assert pulse.recorder.maybe_dump("x", str(tmp_path / "no.json")) is None
    assert not (tmp_path / "no.json").exists()


def test_load_rejects_foreign_json(tmp_path):
    p = tmp_path / "other.json"
    for text in ('{"hello": 1}', "[1, 2, 3]"):
        p.write_text(text)
        with pytest.raises(ValueError, match="not a pydcop_tpu postmortem"):
            load_postmortem(str(p))


@pytest.mark.parametrize("window", [4, 8, 16])
def test_render_timeline_is_jax_s(window):
    doc = {
        "format": POSTMORTEM_FORMAT,
        "reason": "solve-timeout",
        "fingerprint": "abc",
        "meta": {"algo": "dsa"},
        "start_cycle": 0,
        "rows": [row(cost=3.0, best=3.0)] * 12
        + [row(cost=4.0 + (i % 2), best=3.0, flips=2, churn=0.5)
           for i in range(12)],
        "flip_summary": flip_summary([0, 4], cycles=24),
    }
    text = render_postmortem(doc, window=window)
    assert text == jax_pulse_mod.render_postmortem(doc, window=window)
    assert "1/2 frozen" in text


def test_jsonl_stream_is_jax_s(pulse_on, tmp_path):
    paths = []
    for p, name in ((pulse, "ours"), (jax_pulse_mod.pulse, "theirs")):
        path = str(tmp_path / f"{name}.jsonl")
        p.stream_open(path)
        p.begin_run({"algo": "dsa", "n_vars": 3})
        p.publish([row(cost=2.0, best=2.0, flips=1, churn=0.5)] * 3, 0)
        p.publish([row(cost=1.0, best=1.0)], 3)
        p.finish_run([1, 0, 2])
        p.stream_close()
        paths.append(path)
    ours, theirs = (
        [json.loads(line) for line in open(path, encoding="utf-8")]
        for path in paths
    )
    assert ours == theirs and len(ours) == 6


# ---------------------------------------------------------------------------
# the health rows of every engine solver against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problems():
    coloring = jax_coloring(120, 3, graph="scalefree", m_edge=2, seed=11)
    mixed = dataclasses.replace(
        jax_compile_dcop(jax_mixed_problem(30, 20, 0.3, arity=3, seed=1)),
        dcop=None,
    )
    return {
        "coloring": (coloring, port_of(coloring)),
        "mixed": (mixed, port_of(mixed)),
    }


#: (module, params, problem)
HEALTH_CASES = {
    "dsa": ("dsa", {}, "coloring"),
    "adsa": ("adsa", {}, "coloring"),
    "dsatuto": ("dsatuto", {}, "coloring"),
    "mgm": ("mgm", {"break_mode": "random"}, "coloring"),
    "mgm2_arity3": ("mgm2", {}, "mixed"),
    "mixeddsa": ("mixeddsa", {}, "mixed"),
    "dba": ("dba", {}, "coloring"),
    "gdba": ("gdba", {}, "coloring"),
    "maxsum_ell": ("maxsum", {"layout": "ell", "damping": 0.7}, "coloring"),
    "maxsum_lanes": ("maxsum", {"layout": "lanes"}, "mixed"),
    "maxsum_edges_bf16": (
        "maxsum", {"layout": "edges", "precision": "bf16"}, "coloring"),
    "amaxsum": ("amaxsum", {}, "coloring"),
}


def _pulse_extras(mod, run_cycles_owner, *args, **kwargs):
    """``mod.solve`` with the extras of its ``run_cycles`` call kept."""
    seen = {}
    orig = run_cycles_owner.run_cycles

    def spy(*a, **k):
        out = orig(*a, **k)
        seen["extras"] = out[2]
        return out

    run_cycles_owner.run_cycles = spy
    try:
        result = mod.solve(*args, **kwargs)
    finally:
        run_cycles_owner.run_cycles = orig
    return result, seen["extras"]


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_health_rows_equal_jax_s(case, problems, pulse_on):
    name, params, problem = HEALTH_CASES[case]
    ref, port = problems[problem]
    jmod = importlib.import_module(f"pydcop_tpu.algorithms.{name}")
    pmod = importlib.import_module(f"pydcop_tpu_torch.algorithms.{name}")
    jres, jex = _pulse_extras(jmod, jmod, ref, dict(params), n_cycles=20,
                              seed=3)
    pres, pex = _pulse_extras(pmod, pmod, port, dict(params), n_cycles=20,
                              seed=3, device="cpu")
    assert pres.cost == jres.cost and pres.assignment == jres.assignment
    want = np.asarray(jex["pulse"]["health"], dtype=np.float32)
    got = pex["pulse"]["health"]
    assert got.shape == want.shape == (pres.cycles, HEALTH_WIDTH)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(pex["pulse"]["flip_count"],
                          np.asarray(jex["pulse"]["flip_count"]))
    assert pex["pulse"]["report"]["diagnosis"] == (
        jex["pulse"]["report"]["diagnosis"]
    )
    assert pex["pulse"]["fields"] == HEALTH_FIELDS


# ---------------------------------------------------------------------------
# hand-computed rows on the port's object-level problems
# ---------------------------------------------------------------------------


def _compiled(build):
    dcop = build()
    dcop.add_agents([])
    return compile_dcop(dcop)


def unary_pull(n=3):
    d = Domain("c", "", ["R", "G", "B"])
    dcop = DCOP("unary_pull")
    for i in range(n):
        v = Variable(f"v{i}", d)
        dcop += constraint_from_str(f"u{i}", f"0 if v{i} == 'R' else 5", [v])
    return dcop


def equality_pair():
    d = Domain("c", "", ["R", "G"])
    x, y = Variable("x", d), Variable("y", d)
    dcop = DCOP("pair")
    dcop += constraint_from_str("c1", "10 if x != y else 0", [x, y])
    return dcop


def chain():
    d = Domain("c", "", ["R", "G"])
    x, y, z = Variable("x", d), Variable("y", d), Variable("z", d)
    dcop = DCOP("chain")
    dcop += constraint_from_str("c1", "10 if x == y else 0", [x, y])
    dcop += constraint_from_str("c2", "10 if y == z else 0", [y, z])
    return dcop


def recorded_rows():
    return np.asarray(pulse.recorder.snapshot()["rows"], dtype=np.float32)


def test_mgm_unary_pull_settles_in_one_cycle(pulse_on):
    from pydcop_tpu_torch.algorithms import mgm

    mgm.solve(_compiled(unary_pull), {}, n_cycles=12, seed=0, device="cpu")
    rows = recorded_rows()
    assert rows.shape == (12, HEALTH_WIDTH)
    k = rows[0, F["flips"]]
    assert rows[0, F["churn"]] == pytest.approx(k / 3.0)
    assert np.all(rows[1:, F["flips"]] == 0.0)
    assert np.all(rows[:, F["residual"]] == 0.0)
    assert np.all(rows[:, F["cost"]] == 0.0)
    report = pulse.last_report
    assert report["diagnosis"] == "converged"
    assert report["flip_summary"]["frozen"] == 3 - int(k)


def test_dsa_equality_pair_oscillates_with_period_2(pulse_on):
    from pydcop_tpu_torch.algorithms import dsa

    c = _compiled(equality_pair)
    for seed in range(12):
        pulse.reset()
        dsa.solve(c, {"probability": 1.0}, n_cycles=16, seed=seed,
                  device="cpu")
        rows = recorded_rows()
        if rows[0, F["cost"]] == 10.0:
            break
    else:
        pytest.fail("no seed produced a mismatched init in 12 tries")
    assert np.all(rows[:, F["churn"]] == 1.0)
    assert np.all(rows[:, F["flips"]] == 2.0)
    assert np.all(rows[1:, F["flipback"]] == 1.0)
    assert pulse.last_report["diagnosis"] == "oscillating(period=2)"


def test_maxsum_tree_residuals_reach_zero(pulse_on):
    from pydcop_tpu_torch.algorithms import maxsum

    maxsum.solve(_compiled(chain), {"damping": 0.0, "stop_cycle": 40},
                 n_cycles=40, seed=0, device="cpu")
    rows = recorded_rows()
    assert rows[-1, F["residual"]] == 0.0 and rows[-1, F["aux"]] == 0.0
    assert pulse.last_report["diagnosis"] == "converged"


def test_session_publishes_a_stream_a_run(pulse_on):
    from pydcop_tpu_torch.algorithms.maxsum_dynamic import DynamicMaxSum

    dcop = chain()
    dcop.add_agents([])
    session = DynamicMaxSum(dcop, {"damping": 0.5}, device="cpu")
    for n in (6, 9):
        session.run(n)
        assert len(recorded_rows()) == n
        assert pulse.last_report["cycles"] == n


# ---------------------------------------------------------------------------
# pulse changes no result and no count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, params", [
    ("dsa", {}), ("mgm2", {}), ("dba", {}),
    ("maxsum", {"damping": 0.7}),
])
def test_trajectory_and_host_syncs_unchanged_by_pulse(name, params,
                                                      problems):
    mod = importlib.import_module(f"pydcop_tpu_torch.algorithms.{name}")
    port = problems["coloring"][1]
    out = {}
    for on in (False, True):
        pulse.reset()
        pulse.enabled = on
        syncs = base.run_cycles.host_syncs
        try:
            res = mod.solve(port, dict(params), n_cycles=70, seed=5,
                            collect_curve=True, device="cpu")
        finally:
            pulse.enabled = False
        out[on] = (res, base.run_cycles.host_syncs - syncs)
    (r_off, s_off), (r_on, s_on) = out[False], out[True]
    assert r_on == r_off
    assert s_on == s_off == 3  # looks after 16 and 48 cycles, the result


def test_rows_the_same_with_a_timeout(problems, pulse_on):
    from pydcop_tpu_torch.algorithms import dsa

    port = problems["coloring"][1]
    streams = []
    for timeout in (None, 3600.0):
        pulse.reset()
        dsa.solve(port, {}, n_cycles=40, seed=3, timeout=timeout,
                  device="cpu")
        streams.append(recorded_rows())
    assert streams[0].shape == (40, HEALTH_WIDTH)
    assert np.array_equal(streams[0], streams[1])


def test_pulse_off_graphs_are_the_ones_captured_without_it(problems,
                                                           monkeypatch):
    # the card's runner rehearsed on the CPU: a pulse-on solve captures
    # its own graphs, and a pulse-off solve after it finds the graphs it
    # captured before, so its counts are those of a warm solve
    from pydcop_tpu_torch.algorithms import maxsum

    port = problems["coloring"][1]
    params = {"damping": 0.7}
    want = maxsum.solve(port, dict(params), n_cycles=30, seed=7,
                        device="cpu")
    monkeypatch.setattr(base, "_capture", _ReplayedBody)
    monkeypatch.setattr(base, "_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        base, "_runner",
        lambda compiled, solver, dev, consts: base._graphs(
            compiled, solver, dev, consts
        ),
    )
    counts = []
    for on in (False, True, False, True):
        pulse.reset()
        pulse.enabled = on
        before = (base.run_cycles.captures, base.run_cycles.host_syncs,
                  base.run_cycles.replays)
        try:
            res = maxsum.solve(port, dict(params), n_cycles=30, seed=7,
                               device="cpu")
        finally:
            pulse.enabled = False
        counts.append(tuple(
            a - b for a, b in zip(
                (base.run_cycles.captures, base.run_cycles.host_syncs,
                 base.run_cycles.replays), before)
        ))
        assert res == want
    cold_off, cold_on, warm_off, warm_on = counts
    assert cold_off[0] == cold_on[0] == 2
    assert warm_off[0] == warm_on[0] == 0
    assert warm_off[1:] == warm_on[1:] == cold_off[1:]
