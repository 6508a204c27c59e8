"""The port's ``run`` verb against the JAX package's, on the CPU.

``python -m pydcop_tpu_torch --device cpu run`` and ``python -m
pydcop_tpu run`` (``JAX_PLATFORMS=cpu``) on the same files: a generated
soft coloring with one agent per variable and their routes, a
scenario of removals (two at once among them) and an arrival, an agent
kill in the fault schedule, k = 2 in both replication modes.  Their JSON
must be equal apart from ``time``: the solve, every repair's metrics and
the chaos report.  ``--resume`` of a killed scenario run skips the
events its checkpoint records as played and ends where the
uninterrupted run ends; a message rule, and a ``-d`` method the port
does not have yet, exit 2 with their named refusals.  Every subprocess
wait is bounded.
"""

import json
import os
import subprocess
import sys

import pytest
from test_torch_api import ROOT

from pydcop_tpu_torch.commands.generators.agents import (
    generate_agent_defs,
    generate_agents_from_variables,
)
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_graph_coloring,
)
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

SCENARIO = """events:
- id: init
  delay: 1.0
- id: e0
  actions:
  - type: remove_agent
    agent: a00002
- id: d0
  delay: 0.3
- id: e1
  actions:
  - type: add_agent
    agent: a00100
- id: d1
  delay: 0.3
- id: e2
  actions:
  - type: remove_agent
    agent: a00005
  - type: remove_agent
    agent: a00007
- id: end
  delay: 0.4
"""
# the kill comes first: its repair holds the repair lock before the
# scenario's first removal, so the repairs come in one order in both runs
KILL = "seed: 3\nevents:\n  - kill: a00009\n    at: 0.2\n"


def _files(tmp_path):
    # capacity to spare, and routes under the arrival's (default) 1.0:
    # under a capacity race the negotiation's refusals follow the
    # threads' timing, and the newcomer, of capacity 100, would be raced
    # for; with room for every replica it places as the oracle does, in
    # either package
    dcop = generate_graph_coloring(12, 3, graph="scalefree", m_edge=2,
                                   soft=True, seed=4)
    comps = sorted(dcop.variables)
    dcop._agents_def.clear()
    dcop.add_agents(generate_agent_defs(
        generate_agents_from_variables(comps), capacity=10000,
        computations=comps, default_route=1, routes_range=0.9, seed=2))
    files = {"problem": tmp_path / "problem.yaml",
             "scenario": tmp_path / "scenario.yaml",
             "kill": tmp_path / "kill.yaml"}
    files["problem"].write_text(dcop_yaml(dcop))
    files["scenario"].write_text(SCENARIO)
    files["kill"].write_text(KILL)
    return {k: str(v) for k, v in files.items()}


def _start(package, args, env=None):
    cmd = [sys.executable, "-m", package]
    if package == "pydcop_tpu_torch":
        cmd += ["--device", "cpu"]
    return subprocess.Popen(
        cmd + args, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})),
    )


def _both(args):
    """The port's and JAX's CLI on ``args``, at once: (rc, json, stderr)
    of each."""
    procs = [_start(p, args) for p in ("pydcop_tpu_torch", "pydcop_tpu")]
    out = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=240)
        out.append((proc.returncode,
                    json.loads(stdout) if stdout.strip() else None, stderr))
    return out


def _without_time(result):
    return {k: v for k, v in result.items() if k != "time"}


@pytest.mark.parametrize("algo, mode", [
    ("maxsum", "distributed"), ("maxsum", "local"),
])
def test_run_prints_the_jax_cli_json(algo, mode, tmp_path):
    f = _files(tmp_path)
    args = ["run", "-a", algo, "-d", "adhoc", "-n", "40", "-s",
            f["scenario"], "-k", "2", "--replication-mode", mode,
            "--fault-schedule", f["kill"], f["problem"]]
    (rc, port, err), (jax_rc, jax, jax_err) = _both(args)
    assert jax_rc == 0, jax_err[-2000:]
    assert rc == 0, err[-2000:]
    assert _without_time(port) == _without_time(jax)
    assert port["status"] == "FINISHED"
    # every removal repaired, the two at once included, the kill too
    assert len(port["repair_metrics"]) == 4
    assert all(r["repair_status"] == "FINISHED"
               for r in port["repair_metrics"] if r["orphans"])
    assert port["chaos"]["counts"] == {"kill": 1}


def test_two_simultaneous_removals_with_k2(tmp_path):
    f = _files(tmp_path)
    scenario = tmp_path / "two.yaml"
    scenario.write_text(
        "events:\n- id: e0\n  delay: 0.2\n- id: e1\n  actions:\n"
        "  - type: remove_agent\n    agent: a00003\n"
        "  - type: remove_agent\n    agent: a00004\n")
    args = ["run", "-a", "mgm2", "-d", "adhoc", "-n", "30", "-s",
            str(scenario), "-k", "2", f["problem"]]
    (rc, port, err), (jax_rc, jax, jax_err) = _both(args)
    assert jax_rc == 0, jax_err[-2000:]
    assert rc == 0, err[-2000:]
    assert _without_time(port) == _without_time(jax)
    assert len(port["repair_metrics"]) == 2
    assert len(port["assignment"]) == 12


def _manifest_with_cursor(ck, cursor, proc, timeout=180.0):
    """Wait (bounded) for a checkpoint of ``proc``'s run whose manifest
    records ``cursor`` played scenario events; its path, or None."""
    import time

    from pydcop_tpu_torch.durability import list_manifests

    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline and proc.poll() is None:
        if ck.is_dir():
            for man in list_manifests(str(ck)):
                if (man.get("extra") or {}).get("scenario_cursor") == cursor:
                    return man
        time.sleep(0.1)
    return None


def test_resume_skips_the_played_scenario_events(tmp_path):
    # the run is killed (SIGKILL, as a crash) once a checkpoint records
    # every event of the scenario played; its resume skips them all,
    # repairs nothing, and ends where the uninterrupted run ends
    f = _files(tmp_path)
    ck = tmp_path / "ck"
    base = ["run", "-a", "dsa", "-n", "3000", "-s", f["scenario"]]
    ref = _start("pydcop_tpu_torch", base + [f["problem"]])
    killed = _start("pydcop_tpu_torch", base + [
        "--checkpoint", str(ck), "--checkpoint-every", "50", f["problem"]])
    try:
        assert _manifest_with_cursor(ck, 7, killed) is not None
    finally:
        killed.kill()
        killed.communicate(timeout=60)
    resumed = _start("pydcop_tpu_torch", ["-v", "2"] + base + [
        "--resume", str(ck), f["problem"]])
    out, err = resumed.communicate(timeout=240)
    ref_out, ref_err = ref.communicate(timeout=240)
    assert ref.returncode == 0, ref_err[-2000:]
    assert resumed.returncode == 0, err[-2000:]
    assert "skipping 7 already-played scenario event(s)" in err
    got, want = json.loads(out), json.loads(ref_out)
    for key in ("status", "assignment", "cost", "violation", "cycle"):
        assert got[key] == want[key], key
    assert got["repair_metrics"] == []
    assert len(want["repair_metrics"]) == 3


def test_message_rules_are_refused(tmp_path, capsys):
    from pydcop_tpu_torch import dcop_cli

    f = _files(tmp_path)
    sched = tmp_path / "rules.yaml"
    sched.write_text("seed: 1\nevents:\n  - drop: '*'\n    p: 0.5\n")
    rc = dcop_cli.main(["--device", "cpu", "run", "-a", "dsa", "-s",
                        f["scenario"], "-k", "2", "--fault-schedule",
                        str(sched), f["problem"]])
    assert rc == 2
    err = capsys.readouterr().err
    assert "message rules" in err and "chaos verb" in err
    assert "Queue 1, item 1" in err


@pytest.mark.parametrize("verb", [
    ["run", "-s", "SCENARIO"], ["solve", "-m", "thread"],
    ["solve", "-m", "process"],
])
def test_distribution_not_ported_is_refused(verb, tmp_path, capsys):
    from pydcop_tpu_torch import dcop_cli

    f = _files(tmp_path)
    verb = [f["scenario"] if a == "SCENARIO" else a for a in verb]
    rc = dcop_cli.main(["--device", "cpu", verb[0], "-a", "dsa", "-d",
                        "gh_cgdp", *verb[1:], f["problem"]])
    assert rc == 2
    err = capsys.readouterr().err
    assert "'gh_cgdp' is not ported yet" in err
    assert "Queue 1, item 2" in err
