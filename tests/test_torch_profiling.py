"""The port's profiling layer against the JAX package's, on the CPU.

Bars: the host compile census (``compile_dcop``, ``compile_from_edges``)
publishes JAX's counts, gauges and span arguments for the same sequence
of calls; the capture census counts a cold solve's runner build as a
compile and a warm solve's reuse as a hit, for each entry point (the
cycle engine, the serve batch, DPOP's fused wave, the branch and bound),
and a warm serve bucket counts no fresh compile; the card's runner,
rehearsed on the CPU, dumps one DOT file a capture under ``--dump-hlo``
and none when warm; the ``torch.profiler`` session writes a trace and
stops idempotently, an absent profiler is counted and warned about in
JAX's words, and ``solve --profile-out`` gives the result JSON of a solve
without it, with the engine's ranges in the trace.
"""

import contextlib
import importlib
import io
import json
import os
import types

import numpy as np
import pytest

import pydcop_tpu.telemetry as jax_tel
from pydcop_tpu.commands import _utils as jax_utils
from pydcop_tpu.compile import core as jax_core
from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
from pydcop_tpu.compile.direct import (
    compile_from_edges as jax_compile_from_edges,
)
from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load_dcop
from pydcop_tpu.telemetry.profiling import (
    readback_census as jax_readback_census,
)
from pydcop_tpu_torch import telemetry as tel
from pydcop_tpu_torch.algorithms import base, dpop, dsa, maxsum, syncbb
from pydcop_tpu_torch.commands import _utils
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_coloring_arrays,
)
from pydcop_tpu_torch.compile import core
from pydcop_tpu_torch.compile.core import compile_dcop
from pydcop_tpu_torch.compile.direct import compile_from_edges
from pydcop_tpu_torch.dcop.yamldcop import load_dcop

prof = importlib.import_module("pydcop_tpu_torch.telemetry.profiling")

INSTANCE = os.path.join(os.path.dirname(__file__), "instances",
                        "graph_coloring.yaml")

YAML = """
name: prof_test
objective: min
domains:
  colors: {values: [R, G, B]}
variables:
  v1: {domain: colors}
  v2: {domain: colors}
  v3: {domain: colors}
constraints:
  c1:
    type: intention
    function: "10 if v1 == v2 else 0"
  c2:
    type: intention
    function: "3 if v2 == v3 else 1"
agents: [a1, a2, a3]
"""


@pytest.fixture(autouse=True)
def _clean_telemetry():
    tel.telemetry_off()
    jax_tel.telemetry_off()
    yield
    tel.stop_profiling()
    jax_tel.stop_profiling()
    tel.telemetry_off()
    jax_tel.telemetry_off()


def _census(registry=None):
    """{(metric, labels): value} of the compile.* metrics."""
    registry = registry or tel.metrics_registry
    out = {}
    for name, snap in registry.snapshot()["metrics"].items():
        if not name.startswith("compile."):
            continue
        for entry in snap.get("values", []):
            v = entry["value"]
            if isinstance(v, dict):
                v = v["count"]
            out[(name, tuple(sorted((entry.get("labels") or {}).items())))] = v
    return out


def _spans(tracer, name):
    return [e["args"] for e in tracer.events() if e["name"] == name]


# -- the host compile census -------------------------------------------


def test_compile_census_is_jaxs(monkeypatch):
    # the same sequence of compiles, each package's registry and tracer
    # on: equal counts, gauges and span arguments
    monkeypatch.setattr(core, "_seen_fingerprints", set())
    monkeypatch.setattr(jax_core, "_seen_fingerprints", set())
    rng = np.random.default_rng(4)
    edges = rng.integers(0, 12, (20, 2)).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    table = rng.random((3, 3)).astype(np.float32)
    for t, reg in ((tel.tracer, tel.metrics_registry),
                   (jax_tel.tracer, jax_tel.metrics_registry)):
        t.enabled = reg.enabled = True
    for _ in range(2):
        compile_dcop(load_dcop(YAML))
        jax_compile_dcop(jax_load_dcop(YAML))
        compile_from_edges(12, 3, edges, table)
        jax_compile_from_edges(12, 3, edges, table)
    got, want = _census(), _census(jax_tel.metrics_registry)
    assert set(got) == set(want)
    for key in got:
        if key[0] != "compile.host_seconds":  # a wall: counts only
            assert got[key] == want[key], key
    assert got[("compile.runs", ())] == 4
    assert got[("compile.host_repeat_compiles", ())] == 2
    for name in ("compile.compile_dcop", "compile.compile_from_edges"):
        assert _spans(tel.tracer, name) == _spans(jax_tel.tracer, name)
        assert len(_spans(tel.tracer, name)) == 2
    for name in ("compile.scan_constraints", "compile.build_buckets",
                 "compile.sort_edges"):
        assert len(_spans(tel.tracer, name)) == len(
            _spans(jax_tel.tracer, name)) == 2


def test_compile_census_off_records_nothing():
    compile_dcop(load_dcop(YAML))
    assert _census() == {}
    assert tel.tracer.events() == []


# -- the capture census -------------------------------------------------


def _cold_then_warm(solve, label):
    """jit census rows of a cold and a warm call of ``solve``."""
    tel.metrics_registry.reset()
    tel.metrics_registry.enabled = True
    solve()
    cold = prof.jit_census().get(label)
    tel.metrics_registry.reset()
    solve()
    warm = prof.jit_census().get(label)
    tel.metrics_registry.enabled = False
    return cold, warm


@pytest.mark.parametrize("name", ["maxsum", "dsa"])
def test_cold_solve_compiles_and_warm_solve_hits(name):
    mod = {"maxsum": maxsum, "dsa": dsa}[name]
    compiled = generate_coloring_arrays(30, 3, graph="random", p_edge=0.2,
                                        seed=5)
    cold, warm = _cold_then_warm(
        lambda: mod.solve(compiled, {}, n_cycles=12, seed=1,
                          device="cpu"),
        "solve.run_cycles",
    )
    assert cold["compiles"] >= 1
    assert warm == {"compiles": 0, "hits": 1, "dispatches": 1}


def test_serve_batch_census_and_fresh_compiles(monkeypatch):
    from collections import OrderedDict

    from pydcop_tpu_torch.serve import SolveRequest, batch, solve_batched

    # no slot of an earlier test: the first batch builds its runner
    monkeypatch.setattr(batch, "_slots", OrderedDict())
    reqs = [
        SolveRequest(f"t{i}", generate_coloring_arrays(
            16, 3, graph="grid", seed=700 + i), "dsa", {}, 9, i)
        for i in range(3)
    ]
    events = []
    cold, warm = _cold_then_warm(
        lambda: solve_batched(reqs, device="cpu", observer=events.append),
        "serve.run_batch",
    )
    assert cold["compiles"] == 1 and cold["hits"] == 0
    assert warm == {"compiles": 0, "hits": 1, "dispatches": 1}
    # the observer's fresh_compiles agree with the census
    assert [ev["fresh_compiles"] for ev in events] == [1, 0]


def test_dpop_fused_wave_census():
    from pydcop_tpu_torch.commands.generators.meetingscheduling import (
        generate_meeting_scheduling,
    )

    compiled = compile_dcop(generate_meeting_scheduling(
        slots_count=4, resources_count=6, events_count=5,
        max_resources_event=2, seed=5,
    ))
    cold, warm = _cold_then_warm(
        lambda: dpop.solve(compiled, {}, device="cpu"), "dpop.fused_wave"
    )
    assert cold == {"compiles": 1, "hits": 0, "dispatches": 1}
    assert warm == {"compiles": 0, "hits": 1, "dispatches": 1}


def test_branch_bound_census():
    compiled = compile_dcop(load_dcop(YAML))
    cold, warm = _cold_then_warm(
        lambda: syncbb.solve(compiled, {}, device="cpu"), "bb.search"
    )
    assert cold["compiles"] >= 1
    assert warm["compiles"] == 0 and warm["hits"] >= 1


def test_census_labels_name_their_jax_labels():
    assert set(prof.JAX_LABELS) == {
        "solve.run_cycles", "serve.run_batch", "dpop.fused_wave",
        "bb.search",
    }
    assert "solve._solve_fused" in prof.JAX_LABELS["solve.run_cycles"]


def test_census_schemas_are_jaxs():
    compiled = generate_coloring_arrays(20, 3, graph="random", p_edge=0.2,
                                        seed=9)
    tel.metrics_registry.enabled = True
    maxsum.solve(compiled, {}, n_cycles=6, seed=0, device="cpu")
    rec = prof.jit_census()["solve.run_cycles"]
    assert set(rec) == {"compiles", "hits", "dispatches"}
    assert set(prof.readback_census()) == set(jax_readback_census())
    rb = prof.readback_census()
    assert rb["readbacks"] == 1 and rb["windows"] >= 1


def test_compile_metrics_on_a_build():
    compiled = generate_coloring_arrays(25, 3, graph="random", p_edge=0.2,
                                        seed=13)
    tel.metrics_registry.enabled = True
    tel.tracer.enabled = True
    dsa.solve(compiled, {}, n_cycles=5, seed=0, device="cpu")
    got = _census()
    fn = (("fn", "solve.run_cycles"),)
    assert got[("compile.jit_compiles", fn)] == 1
    assert got[("compile.jit_seconds", fn)] == 1
    # no counterpart of XLA's cost analysis, and no allocator on the CPU
    assert got[("compile.analysis_unavailable",
                (("api", "cost_analysis"),) + fn)] == 1
    assert got[("compile.analysis_unavailable",
                (("api", "memory_analysis"),) + fn)] == 1
    assert got[("compile.memory_bytes",
                fn + (("kind", "argument"),))] > 0
    spans = _spans(tel.tracer, "compile.jit")
    assert len(spans) == 1 and spans[0]["fn"] == "solve.run_cycles"


def test_census_off_costs_no_metric():
    compiled = generate_coloring_arrays(15, 3, graph="random", p_edge=0.3,
                                        seed=21)
    builds = prof.profiling.builds
    dsa.solve(compiled, {}, n_cycles=5, seed=0, device="cpu")
    assert prof.profiling.builds == builds + 1
    assert prof.jit_census() == {}


# -- the card's runner rehearsed on the CPU: captures and graph dumps ---


class _FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: records its
    capture's body calls through ``torch.cuda.graph`` and writes a DOT
    file on ``debug_dump``."""

    made = []

    def __init__(self, keep_graph=False):
        self.keep_graph, self.debug = keep_graph, False
        _FakeGraph.made.append(self)

    def enable_debug_mode(self):
        self.debug = True

    def debug_dump(self, path):
        assert self.debug and self.keep_graph
        with open(path, "w") as f:
            f.write("digraph dot {}\n")

    def replay(self):
        self.body()

    def pool(self):
        return None


def _rehearse(monkeypatch):
    """Route the CPU solve through ``_Graphs`` and ``base._capture`` with
    a fake graph whose replay reruns the captured body."""
    import torch

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(
        torch.cuda, "graph",
        lambda g, pool=None, capture_error_mode=None: (
            contextlib.nullcontext()))
    real_capture = base._capture

    def capture(body, pool=None):
        g = real_capture(body, pool)  # runs the body once, as a capture
        g.body = body
        return g

    monkeypatch.setattr(base, "_capture", capture)
    monkeypatch.setattr(base, "_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        base, "_runner",
        lambda compiled, solver, dev, consts: base._graphs(
            compiled, solver, dev, consts),
    )


def test_dump_hlo_writes_a_dot_file_a_capture(monkeypatch, tmp_path):
    _rehearse(monkeypatch)
    compiled = generate_coloring_arrays(20, 3, graph="random", p_edge=0.2,
                                        seed=31)
    want = dsa.solve(compiled, {}, n_cycles=10, seed=2, device="cpu")
    compiled = generate_coloring_arrays(20, 3, graph="random", p_edge=0.2,
                                        seed=31)
    hlo = tmp_path / "hlo"
    tel.metrics_registry.enabled = True
    tel.start_profiling(hlo_dir=str(hlo))
    try:
        _FakeGraph.made.clear()
        cold = dsa.solve(compiled, {}, n_cycles=10, seed=2, device="cpu")
        assert all(g.debug and g.keep_graph for g in _FakeGraph.made)
        files = sorted(os.listdir(hlo))
        # the prologue's and the chunk's capture
        assert files == ["solve.run_cycles.1.graph.dot",
                         "solve.run_cycles.2.graph.dot"]
        warm = dsa.solve(compiled, {}, n_cycles=10, seed=2, device="cpu")
        assert sorted(os.listdir(hlo)) == files  # a cached graph: none
    finally:
        tel.stop_profiling()
    assert cold == warm == want
    got = _census()
    assert got[("compile.hlo_dumps", (("fn", "solve.run_cycles"),))] == 2
    # without --dump-hlo: no debug mode, no file (5 cycles: a chunk of 8
    # iterations, graphs of their own)
    _FakeGraph.made.clear()
    dsa.solve(compiled, {}, n_cycles=5, seed=2, device="cpu")
    assert _FakeGraph.made and not any(g.debug for g in _FakeGraph.made)


def test_dump_hlo_on_the_cpu_counts_no_graph(tmp_path):
    compiled = generate_coloring_arrays(16, 3, graph="random", p_edge=0.3,
                                        seed=41)
    tel.metrics_registry.enabled = True
    tel.start_profiling(hlo_dir=str(tmp_path / "hlo"))
    try:
        dsa.solve(compiled, {}, n_cycles=4, seed=0, device="cpu")
    finally:
        tel.stop_profiling()
    assert not (tmp_path / "hlo").exists()
    assert _census()[("compile.analysis_unavailable",
                      (("api", "as_text"), ("fn", "solve.run_cycles")))] == 1


# -- the profiler session ------------------------------------------------


def test_start_stop_roundtrip_writes_a_trace(tmp_path):
    out = tmp_path / "prof"
    tel.start_profiling(profile_dir=str(out))
    assert tel.profiling.enabled and tel.profiling.profiler_active
    with tel.device_annotation("solve.test.fused"):
        pass
    tel.stop_profiling()
    assert not tel.profiling.profiler_active
    assert not tel.profiling.enabled
    (trace,) = os.listdir(out)
    assert trace.endswith(".pt.trace.json")
    names = {e.get("name") for e in json.load(open(out / trace))[
        "traceEvents"]}
    assert "solve.test.fused" in names


def test_stop_is_idempotent():
    tel.stop_profiling()
    tel.stop_profiling()
    assert not tel.profiling.enabled
    assert tel.device_annotation("x") is tel.device_annotation("y")


def _finish_stderr(utils, args, *extra):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        utils.finish_telemetry(args, *extra)
    return err.getvalue()


def test_absent_profiler_is_counted_and_warned_as_jax(monkeypatch,
                                                      tmp_path):
    import jax.profiler
    import torch

    def boom(*a, **k):
        raise RuntimeError("profiler not supported here")

    args = types.SimpleNamespace(profile_out=str(tmp_path / "p"),
                                 dump_hlo=None)
    monkeypatch.setattr(torch.profiler, "profile", boom)
    _utils.start_telemetry(args)
    assert tel.profiling.enabled and not tel.profiling.profiler_active
    assert tel.metrics_registry.get(
        "device.profiler_unavailable").value() == 1
    with tel.device_annotation("solve.x.fused"):
        pass
    got = _finish_stderr(_utils, args)
    monkeypatch.setattr(jax.profiler, "start_trace", boom)
    bridge = jax_utils.start_telemetry(args)
    want = _finish_stderr(jax_utils, args, bridge)
    assert got == want
    assert got.startswith("warning: device profiler unavailable "
                          "(RuntimeError: profiler not supported here)")


def test_failed_export_is_reported(monkeypatch, tmp_path):
    tel.start_profiling(profile_dir=str(tmp_path / "p"))

    def boom(session, profile_dir):
        raise OSError("disk full")

    monkeypatch.setattr(prof, "_export_trace", boom)
    tel.stop_profiling()
    assert tel.profiling.profiler_error.startswith(
        "stop_trace failed: OSError: disk full")


def _cli_json(argv, capsys):
    from pydcop_tpu_torch.dcop_cli import main

    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    out.pop("time")
    return out


def test_profiled_solve_gives_the_same_json(tmp_path, capsys):
    base_argv = ["--device", "cpu", "solve", "-a", "maxsum", "-n", "20",
                 INSTANCE]
    plain = _cli_json(base_argv, capsys)
    pdir, hdir = tmp_path / "prof", tmp_path / "hlo"
    profiled = _cli_json(
        base_argv[:-1] + ["--profile-out", str(pdir), "--dump-hlo",
                          str(hdir), INSTANCE],
        capsys,
    )
    assert profiled == plain
    (trace,) = os.listdir(pdir)
    names = {e.get("name") for e in json.load(open(pdir / trace))[
        "traceEvents"]}
    assert {"solve.maxsum.fused", "solve.maxsum.readback"} <= names
    legacy = _cli_json(
        base_argv[:-1] + ["--profile", str(tmp_path / "tb"), INSTANCE],
        capsys,
    )
    assert legacy == plain
    assert any(f.endswith(".pt.trace.json")
               for f in os.listdir(tmp_path / "tb"))


def test_timeout_solve_annotates_chunks(tmp_path):
    compiled = generate_coloring_arrays(20, 3, graph="random", p_edge=0.2,
                                        seed=3)
    out = tmp_path / "prof"
    tel.start_profiling(profile_dir=str(out))
    try:
        maxsum.solve(compiled, {"damping": 0.5}, n_cycles=40, seed=0,
                     timeout=60.0, device="cpu")
    finally:
        tel.stop_profiling()
    (trace,) = os.listdir(out)
    names = [e.get("name") for e in json.load(open(out / trace))[
        "traceEvents"]]
    assert "solve.maxsum.chunk" in names
    assert "solve.maxsum.fused" not in names
    assert "solve.maxsum.readback" in names
