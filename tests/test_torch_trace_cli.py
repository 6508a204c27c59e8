"""The engine's window and read-back spans and ``solve --trace-out /
--metrics-out``, against the JAX package's CLI, on the CPU.

A readback window is the span of device cycles between two host syncs.
The port's windows end at its own looks (``kind="chunk"``) where the JAX
package's fused solve has one window (``kind="fused"``), so the pins are
the names, categories and fields of the spans, the metric names, and the
cycles the windows add up to: every cycle of the solve, once.  A serving
batch is one window (``kind="batch"``).
"""

import json
import subprocess
import sys

import pytest
from test_torch_api import ROOT, _path
from test_torch_serve import _reqs

from pydcop_tpu_torch import dcop_cli
from pydcop_tpu_torch.serve import solve_batched
from pydcop_tpu_torch.telemetry import metrics_registry, tracer

WINDOW_METRICS = ("solve.windows", "solve.device_cycles", "device.chunk_ms",
                  "solve.readback_bytes", "solve.readback_seconds")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLI's trace, metrics and result for DSA, 300 cycles."""
    tmp = tmp_path_factory.mktemp("jax")
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu", "solve", "-a", "dsa", "-n",
         "300", "--trace-out", str(tmp / "t.json"), "--metrics-out",
         str(tmp / "m.json"), _path("graph_coloring")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return (json.loads((tmp / "t.json").read_text()),
            json.loads((tmp / "m.json").read_text()),
            json.loads(proc.stdout))


def _spans(trace, name):
    return [e for e in trace["traceEvents"] if e.get("name") == name]


def _port_solve(tmp_path, *opts):
    out = tmp_path / "r.json"
    rc = dcop_cli.main(["--device", "cpu", "--output", str(out), "solve",
                        "-a", "dsa", *opts, _path("graph_coloring")])
    assert rc == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("n_cycles", ["300", "10"])
def test_spans_and_metrics_are_jax_s(jax_run, tmp_path, n_cycles):
    jtrace, jmetrics, _ = jax_run
    result = _port_solve(
        tmp_path, "-n", n_cycles, "--trace-out", str(tmp_path / "t.json"),
        "--metrics-out", str(tmp_path / "m.json"))
    trace = json.loads((tmp_path / "t.json").read_text())
    metrics = json.loads((tmp_path / "m.json").read_text())
    assert not tracer.enabled and not metrics_registry.enabled
    for name in ("solve.window", "solve.readback"):
        want = _spans(jtrace, name)[0]
        got = _spans(trace, name)
        assert got, name
        for span in got:
            assert span["cat"] == want["cat"] == "device"
            assert span["ph"] == want["ph"] == "X"
            assert set(span["args"]) == set(want["args"])
    windows = _spans(trace, "solve.window")
    assert {w["args"]["kind"] for w in windows} == {"chunk"}
    assert {w["args"]["phase"] for w in windows} == {"dsa"}
    # the windows tile the solve: each starts where the last ended
    offsets = [w["args"]["offset"] for w in windows]
    cycles = [w["args"]["cycles"] for w in windows]
    assert offsets == [sum(cycles[:i]) for i in range(len(cycles))]
    assert sum(cycles) == result["cycle"] == int(n_cycles)
    # the port looks after 16, 48, 112 and 240 cycles, then reads back
    assert len(windows) == (5 if n_cycles == "300" else 1)
    assert set(WINDOW_METRICS) <= set(metrics["metrics"])
    assert set(metrics["metrics"]) <= set(jmetrics["metrics"])
    m = metrics["metrics"]
    for name in WINDOW_METRICS:
        assert m[name]["kind"] == jmetrics["metrics"][name]["kind"]
        assert m[name]["help"] == jmetrics["metrics"][name]["help"]
    assert m["solve.device_cycles"]["values"][0]["value"] == int(n_cycles)
    assert m["solve.windows"]["values"][0]["value"] == len(windows)
    assert (m["device.chunk_ms"]["bucket_bounds"]
            == jmetrics["metrics"]["device.chunk_ms"]["bucket_bounds"])
    assert m["device.chunk_ms"]["values"][0]["labels"] == {
        "kind": "chunk", "phase": "dsa"}
    readback = _spans(trace, "solve.readback")
    assert len(readback) == 1
    assert (m["solve.readback_bytes"]["values"][0]["value"]
            == readback[0]["args"]["bytes"] > 0)


def test_jsonl_trace_and_export_errors_go_to_stderr(tmp_path, capsys):
    _port_solve(tmp_path, "-n", "20", "--trace-out",
                str(tmp_path / "t.jsonl"))
    lines = [json.loads(x) for x in
             (tmp_path / "t.jsonl").read_text().splitlines()]
    assert sum(e["args"]["cycles"] for e in lines
               if e.get("name") == "solve.window") == 20
    capsys.readouterr()
    result = _port_solve(
        tmp_path, "-n", "20", "--trace-out",
        str(tmp_path / "missing" / "t.json"), "--metrics-out",
        str(tmp_path / "missing" / "m.json"))
    assert result["cycle"] == 20
    err = capsys.readouterr().err
    assert "could not write --trace-out" in err
    assert "could not write --metrics-out" in err


def test_a_batch_is_one_window(tmp_path):
    reqs = _reqs("dsa", {}, (9, 9, 16), 12)
    tracer.reset()
    tracer.enabled = True
    try:
        out = solve_batched(reqs, device="cpu")
    finally:
        tracer.enabled = False
    windows = [e for e in tracer.events() if e.get("name") == "solve.window"]
    tracer.reset()
    # two buckets: a window each, every tenant's cycles once
    assert sorted(w["args"]["kind"] for w in windows) == ["batch", "batch"]
    assert sum(w["args"]["cycles"] for w in windows) == sum(
        tr.result.cycles for tr in out.values()) == 36
