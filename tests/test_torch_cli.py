"""The port's CLI against the JAX package's, on the CPU.

``python -m pydcop_tpu_torch --device cpu solve`` must print the JAX
CLI's JSON (``python -m pydcop_tpu solve`` under ``JAX_PLATFORMS=cpu``),
``time`` excepted, under the bar of ``test_torch_api.py`` (MaxSum's cost
within rel 1e-5, a cost curve within rel 1e-6, every other field equal).
Without a card and without ``--device cpu`` it refuses; the options of
the JAX CLI's other modes are refused as not ported.  ``--pulse-out``,
``--checkpoint``/``--resume``, ``--fault-schedule`` (on ``solve`` and
``serve``) and the CSV metrics run, and the host-only
``checkpoints`` and ``postmortem`` verbs read the files either package
writes.
"""

import json
import os
import subprocess
import sys

import pytest
from test_torch_api import ROOT, _path, assert_same_result

import pydcop_tpu_torch as P
from pydcop_tpu_torch import dcop_cli


def _run(cmd, env=None):
    return subprocess.run(
        cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})),
    )


# (algo, extra solve options) the CLIs are run with
CLI_CASES = [
    ("maxsum", ["-p", "damping:0.7", "-n", "50"]),
    ("dsa", ["-n", "30", "--seed", "4", "--collect_curve"]),
    ("mgm", ["-n", "20", "-d", "adhoc"]),
    ("mgm2", ["-n", "20", "-i", "0.5"]),
    ("dpop", []),
]


@pytest.mark.parametrize("algo, opts", CLI_CASES)
def test_cli_prints_the_jax_cli_json(algo, opts, tmp_path):
    args = ["solve", "-a", algo, *opts, _path("graph_coloring")]
    port = subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
         "--output", str(tmp_path / "port.json"), *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    ref = _run([sys.executable, "-m", "pydcop_tpu", *args],
               env={"JAX_PLATFORMS": "cpu"})
    out, err = port.communicate(timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.returncode == 0, err[-2000:]
    assert_same_result(
        json.loads((tmp_path / "port.json").read_text()),
        json.loads(ref.stdout), algo,
    )


def test_cli_stdout_is_the_json_text():
    port = _run([sys.executable, "-m", "pydcop_tpu_torch", "--device",
                 "cpu", "solve", "-a", "dpop", _path("ising_4x4")])
    assert port.returncode == 0, port.stderr[-2000:]
    got = json.loads(port.stdout)
    want = P.solve_result(P.load_dcop_from_file(_path("ising_4x4")), "dpop",
                          distribution="oneagent", device="cpu")
    assert_same_result(got, want, "dpop")
    assert port.stdout == json.dumps(
        dict(got), indent=2, default=str, sort_keys=True
    ) + "\n"


def test_cli_without_a_card_exits_nonzero():
    # no card visible and no --device cpu: a clear refusal, no result
    port = _run([sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a",
                 "dpop", _path("graph_coloring")],
                env={"CUDA_VISIBLE_DEVICES": ""})
    assert port.returncode != 0
    assert "--device cpu" in port.stderr
    assert port.stdout == ""


@pytest.mark.parametrize("option", [
    ["-m", "thread"], ["--profile", "p"], ["--uiport", "9"],
    ["--dump-hlo", "h"],
    ["--profile-out", "prof"], ["--metrics-port", "9"], ["--delay", "0.1"],
])
def test_cli_refuses_options_not_ported(option, capsys):
    rc = dcop_cli.main(["--device", "cpu", "solve", "-a", "dsa", *option,
                        _path("graph_coloring")])
    assert rc == 2
    assert "not ported yet" in capsys.readouterr().err


def test_cli_refuses_global_options_not_ported(capsys):
    rc = dcop_cli.main(["--device", "cpu", "--platform", "cpu", "solve",
                        "-a", "dsa", _path("graph_coloring")])
    assert rc == 2
    assert "--platform is not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("option", [
    ["--slo-interval", "5"], ["--peer", "http://x", "--peer", "http://y"],
    ["--slo", "p99<250ms"], ["--slo-file", "s.yaml"], ["--peer", "http://x"],
    ["--slo", "p50<10ms", "--slo-interval", "1"],
])
def test_serve_refuses_options_not_ported(option, capsys):
    rc = dcop_cli.main(["--device", "cpu", "serve", "--port", "0", *option])
    assert rc == 2
    assert "not ported yet" in capsys.readouterr().err


def test_serve_verb_serves_then_drains(tmp_path):
    # python -m pydcop_tpu_torch --device cpu serve: announces its port,
    # solves a POSTed YAML problem, drains after --duration and writes
    # the drain's summary
    import time
    import urllib.request

    out = tmp_path / "serve.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
         "--output", str(out), "serve", "--port", "0", "--window-ms", "5",
         "--duration", "20"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVE_PORT="), proc.stderr.read()
        base = f"http://127.0.0.1:{int(line.split('=')[1])}"
        with open(_path("graph_coloring")) as f:
            body = json.dumps({"dcop_yaml": f.read(), "algo": "dsa",
                               "n_cycles": 10, "tenant": "cli"}).encode()
        req = urllib.request.Request(base + "/solve", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read()) == {"tenant": "cli"}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/result/cli") as resp:
                row = json.loads(resp.read())
            if row["status"] == "done":
                break
            time.sleep(0.05)
        assert row["status"] == "done" and row["cycles"] == 10
        stop = urllib.request.Request(base + "/shutdown", data=b"{}",
                                      method="POST")
        with urllib.request.urlopen(stop, timeout=60) as resp:
            assert json.loads(resp.read()) == {"state": "draining"}
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()
        proc.communicate()
    summary = json.loads(out.read_text())
    assert summary["drained"] is True
    assert (summary["solves"], summary["dead_letters"]) == (1, 0)
    assert summary["tenant_counts"] == {"done": 1}


def test_cli_solve_runs_with_a_fault_schedule(tmp_path, caplog):
    # a schedule without a process kill: the direct solve logs that it
    # ignores the agent kill and the message rule, and gives the plain
    # solve's JSON
    sched = tmp_path / "f.yaml"
    sched.write_text("seed: 1\nevents:\n  - kill: a1\n    at: 0.0\n"
                     "  - drop: '*'\n    p: 0.5\n")
    want = _solve(tmp_path, "ref")
    assert _solve(tmp_path, "chaos", "--fault-schedule", str(sched)) == want
    assert "direct mode ignores them" in caplog.text


def test_serve_verb_runs_with_a_fault_schedule(tmp_path):
    # serve --fault-schedule: a kill of "dead*" at t=0 kills the tenant
    # that matches it, a dead letter, and solves the other one
    import time
    import urllib.request

    sched = tmp_path / "f.yaml"
    sched.write_text("events:\n  - kill: 'dead*'\n    at: 0.0\n")
    out = tmp_path / "serve.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
         "--output", str(out), "serve", "--port", "0", "--window-ms",
         "200", "--duration", "30", "--fault-schedule", str(sched)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVE_PORT="), proc.stderr.read()
        base = f"http://127.0.0.1:{int(line.split('=')[1])}"
        with open(_path("graph_coloring")) as f:
            text = f.read()
        for tenant in ("dead-1", "alive"):
            body = json.dumps({"dcop_yaml": text, "algo": "dsa",
                               "n_cycles": 10, "tenant": tenant}).encode()
            req = urllib.request.Request(base + "/solve", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert json.loads(resp.read()) == {"tenant": tenant}
        rows = {}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and len(rows) < 2:
            for tenant in ("dead-1", "alive"):
                with urllib.request.urlopen(base + f"/result/{tenant}") as r:
                    row = json.loads(r.read())
                if row["status"] in ("done", "killed", "failed"):
                    rows[tenant] = row
            time.sleep(0.05)
        assert rows["dead-1"]["status"] == "killed"
        assert rows["dead-1"]["error"] == "killed by chaos schedule"
        assert rows["alive"]["status"] == "done"
        stop = urllib.request.Request(base + "/shutdown", data=b"{}",
                                      method="POST")
        with urllib.request.urlopen(stop, timeout=60) as resp:
            assert json.loads(resp.read()) == {"state": "draining"}
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()
        proc.communicate()
    summary = json.loads(out.read_text())
    assert (summary["solves"], summary["dead_letters"]) == (1, 1)
    assert summary["tenant_counts"] == {"done": 1, "killed": 1}


def test_serve_verb_needs_the_card_unless_asked(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = dcop_cli.main(["serve", "--port", "0", "--duration", "1"])
    assert rc == 2
    assert "--device cpu" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# durable solves, pulse and the host-only verbs
# ---------------------------------------------------------------------------


def _solve(tmp_path, name, *opts, algo="dsa", n=30):
    out = tmp_path / f"{name}.json"
    rc = dcop_cli.main(["--device", "cpu", "--output", str(out), "solve",
                        "-a", algo, "-n", str(n), *opts,
                        _path("graph_coloring")])
    assert rc == 0
    result = json.loads(out.read_text())
    result.pop("time")
    return result


def test_checkpoint_then_resume_gives_the_uninterrupted_json(tmp_path):
    want = _solve(tmp_path, "ref")
    ck = tmp_path / "ck"
    assert _solve(tmp_path, "ck", "--checkpoint", str(ck),
                  "--checkpoint-every", "8", "--checkpoint-keep", "5") == want
    assert sorted(p.name for p in ck.glob("*.npz")) == [
        f"ckpt-c{c:09d}.npz" for c in (8, 16, 24)
    ]
    # a file, or a directory (its newest checkpoint)
    for resume in (ck / "ckpt-c000000008.npz", ck):
        assert _solve(tmp_path, "res", "--resume", str(resume)) == want


def test_run_metrics_are_labelled_in_absolute_cycles_after_a_resume(
    tmp_path
):
    ck = tmp_path / "ck"
    _solve(tmp_path, "ck", "--checkpoint", str(ck), "--checkpoint-every",
           "10", "--run_metrics", str(tmp_path / "full.csv"))
    _solve(tmp_path, "res", "--resume", str(ck / "ckpt-c000000010.npz"),
           "--run_metrics", str(tmp_path / "res.csv"),
           "--end_metrics", str(tmp_path / "end.csv"))
    full = (tmp_path / "full.csv").read_text().splitlines()
    res = (tmp_path / "res.csv").read_text().splitlines()
    assert full[0] == res[0] == "cycle,cost"
    assert len(full) == 31 and res[1:] == full[11:]
    assert res[1].startswith("11,")
    end = (tmp_path / "end.csv").read_text().splitlines()
    assert end[0] == "time,status,cost,violation,cycle,msg_count,msg_size"
    assert end[1].split(",")[1:3] == ["FINISHED", str(
        json.loads((tmp_path / "res.json").read_text())["cost"]
    )]


def test_a_resume_against_another_seed_is_refused(tmp_path):
    from pydcop_tpu_torch.utils.checkpoint import CheckpointError

    ck = tmp_path / "ck"
    _solve(tmp_path, "ck", "--checkpoint", str(ck), "--checkpoint-every",
           "10")
    with pytest.raises(CheckpointError, match="seed"):
        _solve(tmp_path, "res", "--resume", str(ck), "--seed", "9")


def test_checkpoints_verb_lists_inspects_and_prunes(tmp_path, capsys):
    ck = tmp_path / "ck"
    _solve(tmp_path, "ck", "--checkpoint", str(ck), "--checkpoint-every",
           "8", "--checkpoint-keep", "5")
    capsys.readouterr()
    # host-only: no --device cpu needed, with or without a card
    assert dcop_cli.main(["checkpoints", "list", str(ck)]) == 0
    listing = capsys.readouterr().out
    assert "3 checkpoint(s)" in listing and "dsa" in listing
    assert dcop_cli.main(["--output", str(tmp_path / "l.json"),
                          "checkpoints", "list", str(ck)]) == 0
    listed = json.loads((tmp_path / "l.json").read_text())["checkpoints"]
    assert [m["cycle"] for m in listed] == [8, 16, 24]
    assert dcop_cli.main(["--output", str(tmp_path / "i.json"),
                          "checkpoints", "inspect", str(ck)]) == 0
    inspected = json.loads((tmp_path / "i.json").read_text())
    assert inspected["manifest"]["cycle"] == 24
    assert dcop_cli.main(["--output", str(tmp_path / "p.json"),
                          "checkpoints", "prune", str(ck), "--keep",
                          "1"]) == 0
    assert json.loads((tmp_path / "p.json").read_text())["removed"] == 2
    assert len(list(ck.glob("*.npz"))) == 1


def test_pulse_out_streams_the_jax_schema(tmp_path):
    from pydcop_tpu_torch.telemetry.pulse import HEALTH_FIELDS, pulse

    stream = tmp_path / "pulse.jsonl"
    _solve(tmp_path, "p", "--pulse-out", str(stream))
    assert pulse.enabled is False
    lines = [json.loads(x) for x in stream.read_text().splitlines()]
    assert lines[0]["event"] == "begin"
    assert lines[0]["meta"]["algo"] == "dsa"
    rows = [x for x in lines if "cycle" in x and "event" not in x]
    assert [r["cycle"] for r in rows] == list(range(1, 31))
    assert set(rows[0]) == {"cycle", *HEALTH_FIELDS}
    assert lines[-1]["event"] == "diagnosis"


def test_postmortem_verb_renders_a_timeout_dump(tmp_path):
    from pydcop_tpu.telemetry.pulse import load_postmortem as jax_load
    from pydcop_tpu.telemetry.pulse import (
        render_postmortem as jax_render,
    )

    # a subprocess: the global --timeout arms an alarm
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
         "-t", "0.5", "solve", "-a", "dsa", "-n", "10000000",
         "--pulse-out", "p.jsonl", _path("graph_coloring")],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout)["status"] == "TIMEOUT"
    dump = tmp_path / "postmortem.json"
    doc = jax_load(str(dump))
    assert doc["reason"] == "solve-timeout" and doc["rows"]
    rendered = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "postmortem",
         str(dump)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert rendered.returncode == 0, rendered.stderr[-2000:]
    assert rendered.stdout == jax_render(doc) + "\n"
    assert "solve-timeout" in rendered.stdout
