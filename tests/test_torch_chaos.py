"""The port's fault schedules and chaos controller against the JAX
package's, on the CPU.

- Schedules parse, round-trip and refuse bad events as the JAX package's
  do (``to_dict`` and error text equal).
- The controller's decisions, event log and action counts for a
  message-rule schedule are the JAX package's bit for bit, however the
  sending threads interleave; device faults are consumed once each.
- The kill timeline fires agent kills through a callback and ends the
  whole process with ``os._exit(exit_code)`` on a ``kill_process``, in
  both packages.
- ``solve --fault-schedule`` through the CLI, in subprocesses under a
  timeout: a process kill mid-solve and one due after the solve returned
  both exit with the schedule's code and write no result, as the JAX
  CLI does, and ``solve --resume`` then prints the uninterrupted JSON
  (the JAX package's).  A schedule of agent kills only logs the JAX
  warning and leaves the solve alone.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import pytest
from test_torch_api import ROOT, _path, assert_same_result

import pydcop_tpu as J
from pydcop_tpu import chaos as jax_chaos
from pydcop_tpu_torch import chaos
from pydcop_tpu_torch import dcop_cli

SCHEDULES = [
    """
seed: 42
events:
  - kill: a2
    at: 0.2
  - drop: "value_*"
    p: 0.5
  - delay: "*"
    p: 0.3
    seconds: 0.01
  - duplicate: "ping"
    count: 1
  - transport_error: "*"
    p: 0.1
  - reorder: "*"
    p: 0.2
    seconds: 0.02
  - device_fault: 2
""",
    "seed: 1\nevents:\n  - kill_process: true\n    at: 2.5\n",
    "events:\n  - kill_process: 1.5\n",
    "events:\n  - kill_process: true\n    exit_code: 9\n",
    "seed: 5\nevents:\n  - drop: m*\n    dest: c2\n    src: 'c*'\n",
    "",
    "seed: 3\n",
]

BAD = [
    "events:\n  - kill_process: false\n",
    "events:\n  - kill_process:\n",
    "events:\n  - frobnicate: x\n",
    "events:\n  - drop: '*'\n    p: 1.5\n",
    "events:\n  - 3\n",
    "just a string",
    "- a list\n",
]


@pytest.mark.parametrize("text", SCHEDULES)
def test_schedule_parses_as_jax(text):
    port = chaos.load_fault_schedule(text)
    ref = jax_chaos.load_fault_schedule(text)
    assert port.to_dict() == ref.to_dict()
    assert (port.seed, port.device_faults) == (ref.seed, ref.device_faults)
    assert [k.to_dict() for k in port.kills] == [
        k.to_dict() for k in ref.kills]
    assert [k.to_dict() for k in port.process_kills] == [
        k.to_dict() for k in ref.process_kills]
    # the dict form round-trips
    assert chaos.FaultSchedule.from_dict(port.to_dict()) == port


def test_schedule_file_parses_as_jax(tmp_path):
    path = _path("chaos_kill_repair")
    port = chaos.load_fault_schedule(path)
    assert port.to_dict() == jax_chaos.load_fault_schedule(path).to_dict()
    assert port.kills


@pytest.mark.parametrize("text", BAD)
def test_bad_schedule_is_refused_as_jax(text):
    with pytest.raises((ValueError, AttributeError)) as want:
        jax_chaos.load_fault_schedule(text)
    with pytest.raises(want.type) as got:
        chaos.load_fault_schedule(text)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(action="explode", pattern="*"),
    dict(action="drop", pattern="*", p=-0.1),
])
def test_bad_rule_is_refused_as_jax(kw):
    with pytest.raises(ValueError) as want:
        jax_chaos.MessageRule(**kw)
    with pytest.raises(ValueError) as got:
        chaos.MessageRule(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [
    ("c1", "c2", "value_change"), ("c1", "c2", "metrics"),
    ("c1", "other", "value_change"), ("x1", "c2", "value_change"),
])
def test_rule_matching_is_jax(args):
    kw = dict(action="drop", pattern="value_*", dest="c2", src="c*")
    assert chaos.MessageRule(**kw).matches(*args) == \
        jax_chaos.MessageRule(**kw).matches(*args)


@pytest.mark.parametrize("seed, stream, n", [
    (0, "s", 0), (1, "s", 7), (2**40, "serve.delay|0|t3", 0),
    (-5, "a>b:algo", 12345),
])
def test_unit_draw_is_jax(seed, stream, n):
    assert chaos.unit_draw(seed, stream, n) == \
        jax_chaos.unit_draw(seed, stream, n)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------


def _schedule(pkg, seed=99):
    return pkg.FaultSchedule(seed=seed, events=[
        pkg.MessageRule(action="drop", pattern="algo", p=0.3),
        pkg.MessageRule(action="delay", pattern="*", p=0.4, seconds=0.0),
        pkg.MessageRule(action="duplicate", pattern="mgt", p=0.5,
                        count=3),
        pkg.MessageRule(action="reorder", pattern="*", dest="c3", p=0.6,
                        seconds=0.01),
        pkg.MessageRule(action="transport_error", pattern="algo",
                        src="c2", p=0.2),
    ])


SENDS = [("c1", "c2", "algo"), ("c1", "c3", "mgt"), ("c2", "c1", "algo"),
         ("c2", "c3", "algo")] * 30


def _decisions(controller, sends):
    out = []
    for src, dest, mtype in sends:
        d = controller.on_send("ag1", "ag2", src, dest, mtype)
        out.append((d.drop, d.transport_error, d.delay_s, d.duplicates,
                    d.clean))
    return out


@pytest.mark.parametrize("seed", [99, 100, 7])
def test_decisions_log_and_counts_are_jax(seed, tmp_path):
    port = chaos.ChaosController(_schedule(chaos, seed))
    ref = jax_chaos.ChaosController(_schedule(jax_chaos, seed))
    assert _decisions(port, SENDS) == _decisions(ref, SENDS)
    assert port.event_log() and port.event_log() == ref.event_log()
    assert port.action_counts() == ref.action_counts()
    port.dump(str(tmp_path / "port.json"))
    ref.dump(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()


def _threaded_log(pkg, order_seed):
    controller = pkg.ChaosController(_schedule(pkg))
    rng = random.Random(order_seed)
    streams = [[(f"w{w}", "c3", "algo")] * 50 for w in range(4)]

    def worker(sends, pause):
        for s in sends:
            if pause:
                time.sleep(0)
            controller.on_send("ag1", "ag2", *s)

    threads = [threading.Thread(target=worker, args=(s, rng.random() < 0.5))
               for s in streams]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return controller.event_log(), controller.action_counts()


@pytest.mark.parametrize("order_seed", [1, 2, 3])
def test_log_is_jax_across_thread_interleavings(order_seed):
    port = _threaded_log(chaos, order_seed)
    assert port[0]
    assert port == _threaded_log(jax_chaos, order_seed + 10)


def test_device_faults_are_consumed_once_each_as_jax():
    port = chaos.ChaosController(
        chaos.FaultSchedule(events=[chaos.DeviceFault(count=2)]))
    ref = jax_chaos.ChaosController(
        jax_chaos.FaultSchedule(events=[jax_chaos.DeviceFault(count=2)]))
    got = [port.device_fault() for _ in range(4)]
    assert got == [ref.device_fault() for _ in range(4)]
    assert got == [True, True, False, False]
    assert port.event_log() == ref.event_log()


def test_timeline_fires_agent_kills_through_the_callback():
    sched = chaos.FaultSchedule(events=[
        chaos.KillEvent("a2", at=0.05), chaos.KillEvent("a1", at=0.0),
        chaos.KillEvent("a3", at=30.0),
    ])
    controller = chaos.ChaosController(sched)
    killed = []
    controller.start(killed.append)
    controller.start(killed.append)  # idempotent
    deadline = time.monotonic() + 10
    while len(killed) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not controller.wait_timeline(timeout=0.05)  # a3 still due
    controller.stop()
    assert controller.wait_timeline(timeout=5)
    assert killed == ["a1", "a2"]
    assert controller.action_counts() == {"kill": 2}
    assert [e["agent"] for e in controller.event_log()] == ["a1", "a2"]


def test_timeline_without_a_runtime_skips_agent_kills(caplog):
    controller = chaos.ChaosController(
        chaos.FaultSchedule(events=[chaos.KillEvent("a1", at=0.0)]))
    controller.start(None)
    assert controller.wait_timeline(timeout=10)
    assert "agent kill of a1 skipped" in caplog.text
    assert controller.event_log() == []


KILL_SNIPPET = """
import sys, time
from {pkg}.chaos import ChaosController, FaultSchedule, KillProcessEvent
c = ChaosController(FaultSchedule(events=[KillProcessEvent(at=0.2,
                                                           exit_code=41)]))
c.start(None)
print("armed", flush=True)
time.sleep(30)
print("not killed", flush=True)
"""


def test_process_kill_ends_the_process_as_jax():
    procs = {
        pkg: subprocess.Popen(
            [sys.executable, "-c", KILL_SNIPPET.format(pkg=pkg)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
        )
        for pkg in ("pydcop_tpu_torch", "pydcop_tpu")
    }
    for pkg, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        assert proc.returncode == 41, (pkg, err[-2000:])
        assert out == "armed\n"
        assert "killing PROCESS" in err


# ---------------------------------------------------------------------------
# solve --fault-schedule through the CLI
# ---------------------------------------------------------------------------

SOLVE = ["solve", "-a", "dsa", "--seed", "3"]

# the port's CLI in a process whose first solve has already run: that
# solve's lazy torch imports (~2 s on an idle CPU, far more on a loaded
# one) then fall before the schedule's timeline starts, not inside it
PORT_CLI_WARM = """
import sys
from pydcop_tpu_torch import load_dcop_from_file, solve_result
from pydcop_tpu_torch.dcop_cli import main
solve_result(load_dcop_from_file(sys.argv[1]), "dsa", n_cycles=2,
             device="cpu")
sys.exit(main(sys.argv[2:]))
"""


def _cli(pkg, args):
    if pkg == "pydcop_tpu_torch":
        cmd = [sys.executable, "-c", PORT_CLI_WARM,
               _path("graph_coloring"), "--device", "cpu"]
    else:
        cmd = [sys.executable, "-m", pkg]
    return subprocess.Popen(
        cmd + args, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )


def _finish(proc, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    return proc.returncode, out, err


def _manifest_cycles(directory):
    return sorted(
        json.loads(p.read_text())["cycle"] for p in directory.glob("*.json")
    )


def _jax_json(n_cycles):
    return J.solve_result(
        J.load_dcop_from_file(_path("graph_coloring")), "dsa",
        distribution="oneagent", n_cycles=n_cycles, seed=3,
    )


def test_solve_process_kill_mid_solve_then_resume(tmp_path):
    # the kill is due 2 s after the solve starts: after its first
    # snapshot (50 cycles, ~0.3 s in at ~4 ms a cycle on an idle CPU)
    # and well before its end (~6 s in)
    n = 1500
    sched = tmp_path / "kill.yaml"
    sched.write_text("seed: 0\nevents:\n  - kill_process: true\n"
                     "    at: 2.0\n")
    ck = tmp_path / "ck"
    rc, out, err = _finish(_cli("pydcop_tpu_torch", [
        *SOLVE, "-n", str(n), "--checkpoint", str(ck),
        "--checkpoint-every", "50", "--checkpoint-keep", "100",
        "--fault-schedule", str(sched), _path("graph_coloring")]))
    assert rc == 137, err[-2000:]
    assert out == ""
    cycles = _manifest_cycles(ck)
    assert cycles and cycles[-1] < n, cycles
    assert cycles == list(range(50, cycles[-1] + 1, 50))
    rc, out, err = _finish(_cli("pydcop_tpu_torch", [
        *SOLVE, "-n", str(n), "--resume", str(ck),
        _path("graph_coloring")]))
    assert rc == 0, err[-2000:]
    assert_same_result(json.loads(out), _jax_json(n), "dsa")


def test_solve_process_kill_after_return_exits_as_jax_then_resume(
        tmp_path):
    # the kill is due 4 s after the solve starts, long after its 100
    # cycles: the process still dies at 4 s, before it prints a result,
    # as the JAX CLI's does; the snapshots cover the whole solve
    n = 100
    sched = tmp_path / "kill.yaml"
    sched.write_text("events:\n  - kill_process: 4.0\n")
    ck = tmp_path / "ck"
    port = _cli("pydcop_tpu_torch", [
        *SOLVE, "-n", str(n), "--checkpoint", str(ck),
        "--checkpoint-every", "50", "--fault-schedule", str(sched),
        _path("graph_coloring")])
    ref = _cli("pydcop_tpu", [
        *SOLVE, "-n", str(n), "--checkpoint", str(tmp_path / "jax_ck"),
        "--checkpoint-every", "50", "--fault-schedule", str(sched),
        _path("graph_coloring")])
    t0 = time.monotonic()
    rc, out, err = _finish(port)
    assert time.monotonic() - t0 >= 4.0
    ref_rc, ref_out, ref_err = _finish(ref)
    assert rc == ref_rc == 137, (err[-2000:], ref_err[-2000:])
    assert out == ref_out == ""
    assert _manifest_cycles(ck) == [50, 100]
    rc, out, err = _finish(_cli("pydcop_tpu_torch", [
        *SOLVE, "-n", str(n), "--resume", str(ck),
        _path("graph_coloring")]))
    assert rc == 0, err[-2000:]
    assert_same_result(json.loads(out), _jax_json(n), "dsa")


def test_solve_with_agent_kills_only_warns_and_solves(tmp_path, caplog):
    sched = tmp_path / "agents.yaml"
    sched.write_text("events:\n  - kill: a1\n    at: 0.0\n"
                     "  - kill: a2\n    at: 0.1\n  - device_fault: 1\n")
    out = tmp_path / "out.json"
    assert dcop_cli.main(["--device", "cpu", "--output", str(out), *SOLVE,
                          "-n", "30", "--fault-schedule", str(sched),
                          _path("graph_coloring")]) == 0
    assert (
        "--fault-schedule: agent kills / message rules / device faults "
        "need the agent runtime; direct mode ignores them"
    ) in caplog.text
    assert_same_result(json.loads(out.read_text()), _jax_json(30), "dsa")
