"""The port's CLI against the JAX package's, on the CPU.

``python -m pydcop_tpu_torch --device cpu solve`` must print the JAX
CLI's JSON (``python -m pydcop_tpu solve`` under ``JAX_PLATFORMS=cpu``),
``time`` excepted, under the bar of ``test_torch_api.py`` (MaxSum's cost
within rel 1e-5, a cost curve within rel 1e-6, every other field equal).
Without a card and without ``--device cpu`` it refuses; the options of
the JAX CLI's other modes are refused as not ported.
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
    ["-m", "thread"], ["--trace-out", "t.json"], ["--mem-guard"],
    ["--fault-schedule", "f.yaml"], ["--checkpoint", "ck"], ["--resume", "ck"],
    ["--run_metrics", "m.csv"], ["--delay", "0.1"],
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
    ["--fault-schedule", "f.yaml"], ["--no-pulse"], ["--checkpoint", "ck"],
    ["--slo", "p99<250ms"], ["--slo-file", "s.yaml"], ["--peer", "http://x"],
    ["--mem-guard"],
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


def test_serve_verb_needs_the_card_unless_asked(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = dcop_cli.main(["serve", "--port", "0", "--duration", "1"])
    assert rc == 2
    assert "--device cpu" in capsys.readouterr().err
