"""The port's ``telemetry`` verb and its trace modules (``summary``,
``stitch``) against the JAX package's, on the CPU.

Bars: on the same files (a JSON and a JSONL trace of each package's own
``solve --trace-out``, a hand-made trace with schema errors, a broken
file), ``summarize_trace``, ``format_summary`` and ``stitch_traces`` give
the JAX package's values; the verb's ``--json`` summary, ``--validate``,
``stitch``, ``--prom`` (classic and ``--openmetrics``) and ``--metrics``
print the JAX verb's text, and its exit codes on the error cases are the
JAX verb's.
"""

import json

import pytest
from test_torch_api import _path

from pydcop_tpu import dcop_cli as jax_cli
from pydcop_tpu.telemetry import stitch as jax_stitch
from pydcop_tpu.telemetry import summary as jax_summary
from pydcop_tpu_torch import dcop_cli
from pydcop_tpu_torch.telemetry import stitch, summary


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Trace and metrics files of both packages' ``solve``, and a broken
    and a schema-violating trace."""
    d = tmp_path_factory.mktemp("telemetry")
    out = {}
    problem = _path("graph_coloring")
    for pkg, main, pre in (("port", dcop_cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, ["--platform", "cpu"])):
        for ext in ("json", "jsonl"):
            trace = d / f"{pkg}.{ext}"
            metrics = d / f"{pkg}-{ext}-metrics.json"
            rc = main([*pre, "--output", str(d / f"{pkg}-{ext}.out"),
                       "solve", "-a", "maxsum", "-n", "20",
                       "--trace-out", str(trace),
                       "--metrics-out", str(metrics), problem])
            assert rc == 0
            out[f"{pkg}_{ext}"] = str(trace)
            out[f"{pkg}_metrics_{ext}"] = str(metrics)
    broken = d / "broken.json"
    broken.write_text('{"traceEvents": [{"name": ')
    out["broken"] = str(broken)
    bad = d / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 5, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": "late", "pid": 1, "tid": 1},
        {"ph": "i", "ts": 3, "pid": 1, "tid": 1},
        {"name": "c", "ph": "?", "ts": 1, "pid": 1, "tid": 1},
    ]}))
    out["bad"] = str(bad)
    empty = d / "empty.jsonl"
    empty.write_text("")
    out["empty"] = str(empty)
    return out


TRACES = ("port_json", "port_jsonl", "jax_json", "jax_jsonl", "bad")


@pytest.mark.parametrize("name", TRACES)
def test_summaries_are_jaxs(files, name):
    got = summary.summarize_trace(files[name])
    assert got == jax_summary.summarize_trace(files[name])
    assert summary.format_summary(got[0], top=5) == \
        jax_summary.format_summary(got[0], top=5)
    if name.startswith("port"):
        assert "solve.window" in got[0]["spans"] and not got[1]
    if name == "bad":
        assert got[1]


@pytest.mark.parametrize("name", ["broken", "empty"])
def test_broken_trace_raises_as_jaxs(files, name):
    with pytest.raises(ValueError) as got:
        summary.load_trace(files[name])
    with pytest.raises(ValueError) as want:
        jax_summary.load_trace(files[name])
    assert str(got.value) == str(want.value)


def test_stitch_is_jaxs(files):
    paths = [files[n] for n in ("port_json", "jax_jsonl", "port_jsonl")]
    got = stitch.stitch_traces(paths)
    assert got == jax_stitch.stitch_traces(paths)
    assert stitch.flow_stats(got[0]["traceEvents"]) == \
        jax_stitch.flow_stats(got[0]["traceEvents"])
    both = stitch.stitch_traces([files["broken"], files["port_json"]],
                                skip_unreadable=True)
    assert both == jax_stitch.stitch_traces(
        [files["broken"], files["port_json"]], skip_unreadable=True)
    assert both[1]["skipped"]


def _verb(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys):
    port = _verb(dcop_cli.main, ["telemetry", *argv], capsys)
    jax = _verb(jax_cli.main, ["--platform", "cpu", "telemetry", *argv],
                capsys)
    return port, jax


@pytest.mark.parametrize("args", [
    ["--json", "{port_json}"], ["--json", "{jax_jsonl}"],
    ["{port_jsonl}", "--top", "3"], ["{jax_json}"],
    ["--validate", "--json", "{bad}"], ["--validate", "{port_json}"],
    ["--prom", "{port_metrics_json}"],
    ["--prom", "{jax_metrics_jsonl}", "--openmetrics"],
    ["--metrics", "{port_metrics_jsonl}"],
    ["--metrics", "{jax_metrics_json}", "--json"],
    ["--metrics", "{port_metrics_json}", "--json", "{port_json}"],
])
def test_verb_prints_the_jax_verbs_text(files, args, capsys):
    argv = [a.format(**files) for a in args]
    (rc, out, err), (jrc, jout, jerr) = _both(argv, capsys)
    assert (rc, out) == (jrc, jout)
    assert out
    if "--validate" in args:
        assert rc == (1 if "{bad}" in args else 0)
        assert err == jerr


@pytest.mark.parametrize("args, code", [
    ([], 2),
    (["{port_json}", "{jax_json}"], 2),
    (["--validate", "--metrics", "{port_metrics_json}"], 2),
    (["{broken}"], 1),
    (["{empty}", "--json"], 1),
    (["/nonexistent/trace.json"], 1),
    (["--metrics", "{broken}"], 1),
    (["--prom", "/nonexistent/metrics.json"], 1),
    (["stitch", "{port_json}"], 2),
    (["stitch", "-o", "{out}"], 2),
])
def test_verb_exit_codes_are_jaxs(files, args, code, capsys, tmp_path):
    argv = [a.format(out=str(tmp_path / "m.json"), **files) for a in args]
    (rc, out, err), (jrc, jout, jerr) = _both(argv, capsys)
    assert rc == jrc == code
    assert (out, err) == (jout, jerr)


def test_verb_stitch_writes_the_jax_verbs_trace(files, capsys, tmp_path):
    inputs = [files["port_json"], files["jax_json"]]
    outs = []
    for tag, main, pre in (("port", dcop_cli.main, []),
                           ("jax", jax_cli.main, ["--platform", "cpu"])):
        path = tmp_path / f"{tag}.json"
        rc, out, _ = _verb(main, [*pre, "telemetry", "stitch", *inputs,
                                  "-o", str(path), "--json"], capsys)
        assert rc == 0
        outs.append((json.loads(out), json.loads(path.read_text())))
    assert outs[0] == outs[1]
    assert len(outs[0][0]["files"]) == 2
