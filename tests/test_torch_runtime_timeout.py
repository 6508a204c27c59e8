"""The agent runtime's ``--timeout`` on the CPU: the device solve stops
at its next look and its thread is joined, so the command exits 0 with
the JAX package's ``TIMEOUT`` JSON instead of aborting at the
interpreter's exit (rc 134, "terminate called without an active
exception", while a ``device-solve`` thread was still inside torch).

``solve -m thread`` (DSA, and MaxSum with ``-d adhoc``) and ``run``
(DSA with a scenario and k = 2), each for 3,000,000 cycles under ``-t
8`` on a 30-variable soft coloring, beside ``python -m pydcop_tpu``
under ``JAX_PLATFORMS=cpu``: equal JSON but for ``time``."""

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
from pydcop_tpu_torch.commands.generators.scenario import generate_scenario
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, yaml_scenario


def _files(tmp_path):
    dcop = generate_graph_coloring(30, 3, graph="scalefree", m_edge=2,
                                   soft=True, seed=3)
    comps = sorted(dcop.variables)
    dcop._agents_def.clear()
    dcop.add_agents(generate_agent_defs(
        generate_agents_from_variables(comps), capacity=10000,
        computations=comps, default_route=1, routes_range=0.9, seed=3))
    problem, scenario = tmp_path / "col30.yaml", tmp_path / "scen.yaml"
    problem.write_text(dcop_yaml(dcop))
    scenario.write_text(yaml_scenario(generate_scenario(
        2, 1, 0.5, 0.5, 0.5, sorted(dcop.agents), seed=7)))
    return str(problem), str(scenario)


@pytest.mark.parametrize("case", ["solve_dsa", "solve_maxsum", "run_dsa"])
def test_thread_mode_timeout_exits_0_with_the_jax_json(case, tmp_path):
    problem, scenario = _files(tmp_path)
    args = {
        "solve_dsa": ["solve", "-a", "dsa", "-m", "thread"],
        "solve_maxsum": ["solve", "-a", "maxsum", "-d", "adhoc", "-m",
                         "thread"],
        "run_dsa": ["run", "-a", "dsa", "-s", scenario, "-k", "2"],
    }[case] + ["-n", "3000000", problem]
    # one intra-op thread: the case needs none, and a CPU shared with
    # other test processes then keeps its timings
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", package, *extra, "-t", "8", *args],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env)
        for package, extra in (("pydcop_tpu_torch", ["--device", "cpu"]),
                               ("pydcop_tpu", []))
    ]
    (port_out, port_err), (jax_out, jax_err) = [
        p.communicate(timeout=120) for p in procs]
    assert procs[1].returncode == 0, jax_err[-2000:]
    assert procs[0].returncode == 0, port_err[-2000:]
    assert "terminate called" not in port_err
    port, jax = json.loads(port_out), json.loads(jax_out)
    assert port["status"] == "TIMEOUT"
    assert port.pop("time") < 30 and jax.pop("time") < 30
    assert port == jax
