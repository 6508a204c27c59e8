"""Scenario replay (``durability/replay.py``'s ``ScenarioSession``)
against the JAX package, on the CPU.

A ``DynamicMaxSum`` session driven by a scenario: delay events advance
cycles, ``swap_factor`` and ``set_external`` events change the problem,
runtime events are refused, and a checkpoint follows every event with
the event cursor in its manifest.  The pins: the uninterrupted play is
the JAX package's (every cost after a delay event and the final result);
a resume from every checkpoint lands on the uninterrupted trajectory; a
JAX scenario checkpoint resumes in the port onto JAX's trajectory, and a
port checkpoint in the JAX package onto the port's.  Damping 0.3: the
session damps both float32 planes in XLA's FMA form.
"""

import pytest

from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load_dcop
from pydcop_tpu.dcop.yamldcop import load_scenario as jax_load_scenario
from pydcop_tpu.durability import CheckpointManager as JaxManager
from pydcop_tpu.durability import list_manifests as jax_list_manifests
from pydcop_tpu.durability.replay import ScenarioSession as JaxSession
from pydcop_tpu_torch.dcop.yamldcop import load_dcop, load_scenario
from pydcop_tpu_torch.durability import (
    REPLAY_ACTIONS,
    CheckpointManager,
    ScenarioSession,
    latest_checkpoint,
    list_manifests,
    read_manifest,
)
from pydcop_tpu_torch.utils.checkpoint import CheckpointError

YAML = """
name: t
objective: min
domains: {d: {values: [0, 1, 2]}}
variables:
  v1: {domain: d}
  v2: {domain: d}
  v3: {domain: d}
  v4: {domain: d}
external_variables:
  s: {domain: d, initial_value: 0}
constraints:
  c12: {type: intention, function: 1.0 if v1 == v2 else 0.0}
  c23: {type: intention, function: 1.0 if v2 == v3 else 0.0}
  c13: {type: intention, function: 0.5 if v1 == v3 else 0.0}
  c34: {type: intention, function: 0.7 if v3 == v4 else 0.2}
  c4s: {type: intention, function: 0.0 if v4 == s else 2.0}
agents: [a1, a2, a3, a4]
"""

SCENARIO = """
events:
  - id: warm
    delay: 20
  - id: flip
    actions:
      - {type: swap_factor, constraint: c12,
         function: "3.0 if v1 != v2 else 0.0"}
  - id: settle
    delay: 20
  - id: sensor
    actions:
      - {type: set_external, name: s, value: 2}
  - id: more
    delay: 10
  - id: flip2
    actions:
      - {type: swap_factor, constraint: c23,
         function: "2.0 if v2 != v3 else 0.1"}
  - id: finish
    delay: 15
"""

PARAMS = {"damping": 0.3}
N_EVENTS = 7


def _port(tmp=None, **kw):
    mgr = CheckpointManager(str(tmp), keep=100) if tmp is not None else None
    return ScenarioSession(load_dcop(YAML), load_scenario(SCENARIO),
                           params=dict(PARAMS), seed=5, manager=mgr,
                           device="cpu", **kw)


def _jax(tmp=None):
    mgr = JaxManager(str(tmp), keep=100) if tmp is not None else None
    return JaxSession(jax_load_dcop(YAML), jax_load_scenario(SCENARIO),
                      params=dict(PARAMS), seed=5, manager=mgr)


def _played(sess):
    try:
        return sess.play(), list(sess.cost_trace), sess.cursor
    finally:
        sess.close()


def _same(got, want):
    assert (got.cost, got.assignment, got.cycles, got.msg_count) == (
        want.cost, want.assignment, want.cycles, want.msg_count)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    r, trace, cursor = _played(_port(tmp))
    return r, trace, cursor, tmp


def test_uninterrupted_play_is_jax_s(uninterrupted):
    r, trace, cursor, _ = uninterrupted
    jr, jtrace, jcursor = _played(_jax())
    assert cursor == jcursor == N_EVENTS
    assert trace == jtrace and len(trace) == 4
    _same(r, jr)
    assert r.cycles == 65


def _by_cursor(manifests):
    # an action event's checkpoint overwrites the delay's before it (same
    # cycle): the newest manifest of a cycle wins
    return {m["extra"]["scenario_cursor"]: m["checkpoint_path"]
            for m in manifests}


def test_resume_from_every_checkpoint(uninterrupted):
    r_full, trace, _, tmp = uninterrupted
    paths = _by_cursor(list_manifests(str(tmp)))
    assert len(paths) >= 4
    for cursor, path in sorted(paths.items()):
        sess = ScenarioSession.resume(
            load_dcop(YAML), load_scenario(SCENARIO), path,
            params=dict(PARAMS), device="cpu")
        assert sess.cursor == cursor
        r, got, _ = _played(sess)
        if cursor == N_EVENTS:
            assert r is None and got == []
            continue
        _same(r, r_full)
        assert got == trace[len(trace) - len(got):]


def test_jax_checkpoints_resume_in_the_port_and_back(tmp_path,
                                                     uninterrupted):
    jr, jtrace, _ = _played(_jax(tmp_path / "jax"))
    r_full, trace, _, tmp = uninterrupted
    for cursor, path in sorted(_by_cursor(
            jax_list_manifests(str(tmp_path / "jax"))).items()):
        if cursor == N_EVENTS:
            continue
        r, got, _ = _played(ScenarioSession.resume(
            load_dcop(YAML), load_scenario(SCENARIO), path,
            params=dict(PARAMS), device="cpu"))
        _same(r, jr)
        assert got == jtrace[len(jtrace) - len(got):]
    # and a port checkpoint in the JAX package
    paths = _by_cursor(list_manifests(str(tmp)))
    path = paths[sorted(paths)[1]]
    r, got, _ = _played(JaxSession.resume(
        jax_load_dcop(YAML), jax_load_scenario(SCENARIO), path,
        params=dict(PARAMS)))
    _same(r, r_full)
    assert got == trace[-len(got):]


def test_manifest_speaks_the_session_dialect(uninterrupted):
    _, _, _, tmp = uninterrupted
    man = read_manifest(latest_checkpoint(str(tmp)))
    assert man["kind"] == "session"
    assert man["algo"] == "maxsum_dynamic"
    assert man["cycles_done"] == 65 and man["cycle"] == 65
    assert man["plane_layout"] == "lanes"
    assert man["extra"]["scenario_cursor"] == N_EVENTS


def test_a_checkpoint_of_another_problem_is_refused(uninterrupted):
    _, _, _, tmp = uninterrupted
    other = YAML.replace("0.5 if v1 == v3", "0.9 if v1 == v3")
    with pytest.raises(CheckpointError, match="DIFFERENT problem"):
        ScenarioSession.resume(load_dcop(other), load_scenario(SCENARIO),
                               latest_checkpoint(str(tmp)),
                               params=dict(PARAMS), device="cpu")


def test_runtime_actions_are_refused():
    assert REPLAY_ACTIONS == ("swap_factor", "set_external")
    bad = load_scenario("events:\n  - id: x\n    actions:\n"
                        "      - {type: remove_agent, agent: a1}\n")
    sess = ScenarioSession(load_dcop(YAML), bad, params=dict(PARAMS),
                           device="cpu")
    try:
        with pytest.raises(ValueError, match="agent-runtime"):
            sess.play()
    finally:
        sess.close()


def test_run_outside_the_scenario_checkpoints(tmp_path):
    sess = _port(tmp_path)
    try:
        r = sess.run(12)
        assert r.cycles == 12
        man = read_manifest(latest_checkpoint(str(tmp_path)))
        assert (man["cycle"], man["extra"]["scenario_cursor"]) == (12, 0)
    finally:
        sess.close()
