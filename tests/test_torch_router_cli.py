"""``python -m pydcop_tpu_torch --device cpu router --spawn 2`` end to
end, on the CPU.

The router spawns two serve workers (``ROUTER_WORKER`` lines), places
four small DSA tenants of two buckets by affinity, one bucket a worker,
and each result is the port's solo ``solve_result`` of the same problem
and seed.  Two long tenants of the first bucket go out, and their worker
is SIGKILLed while they run: the router fails them over to the survivor,
where they finish with the solo results too.  The victim is restarted
on its port; the ``fleet`` verb reads both workers live, and both state
directories once the router's SIGTERM drain (rc 0, its report JSON) has
made the workers write their manifests.  Without ``--device cpu`` here
(no card) the spawned worker exits before it announces, and so does the
router, nonzero.  Every spawned pid is reaped and every wait bounded.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
from test_torch_api import ROOT

from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_graph_coloring,
)
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop

CLI = [sys.executable, "-m", "pydcop_tpu_torch"]
SHORT, LONG = 20, 2000


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _until(what, cond, timeout=90.0, every=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(every)
    raise AssertionError(f"timed out waiting for {what}")


def _announced(proc, prefix, timeout=120.0):
    """The lines ``proc`` prints up to the first starting with
    ``prefix`` (read on a thread, so the wait is bounded), then drains
    the rest of its output in the background."""
    lines, found = [], threading.Event()

    def read():
        for line in proc.stdout:
            if not found.is_set():
                lines.append(line.strip())
                if line.startswith(prefix):
                    found.set()

    threading.Thread(target=read, daemon=True).start()
    found.wait(timeout)
    assert found.is_set(), f"no {prefix} line: {lines}"
    return lines


def _solo(text, seed, n_cycles):
    from pydcop_tpu_torch.api import solve_result

    return solve_result(load_dcop(text), "dsa", n_cycles=n_cycles,
                        seed=seed, device="cpu")


def _same(rec, want, tid):
    assert rec["status"] == "done", (tid, rec)
    assert (rec["assignment"], rec["cost"], rec["violations"],
            rec["cycles"]) == (want["assignment"], want["cost"],
                               want["violation"], want["cycle"]), tid


def _reap(pids):
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


@pytest.fixture
def env(tmp_path):
    e = dict(os.environ)
    e["PYDCOP_TPU_STATE_DIR"] = str(tmp_path / "state_env")
    return e


def test_router_spawns_places_fails_over_and_drains(tmp_path, env):
    state = tmp_path / "state"
    out = tmp_path / "router.json"
    texts = {
        "a": dcop_yaml(generate_graph_coloring(9, 3, graph="grid", seed=4)),
        "b": dcop_yaml(generate_graph_coloring(16, 3, graph="grid",
                                               seed=5)),
    }
    router = subprocess.Popen(
        [*CLI, "--device", "cpu", "--output", str(out), "router",
         "--spawn", "2", "--port", "0", "--placement", "affinity",
         "--state-dir", str(state), "--interval", "0.25",
         "--stale-after", "4", "--window-ms", "20"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    pids, procs = [], [router]
    try:
        lines = _announced(router, "ROUTER_PORT=")
        workers = {}
        for line in lines:
            if line.startswith("ROUTER_WORKER "):
                f = dict(kv.split("=", 1) for kv in line.split()[1:])
                workers[f["name"]] = (int(f["pid"]), int(f["port"]))
                pids.append(int(f["pid"]))
        assert sorted(workers) == ["w0", "w1"]
        base = f"http://127.0.0.1:{lines[-1].split('=', 1)[1]}"
        _until("two workers up",
               lambda: _get(base + "/status")["workers_up"] == 2)

        # four tenants, two buckets: one bucket a worker, the solo results
        tenants = {"a0": ("a", 3), "a1": ("a", 4), "b0": ("b", 5),
                   "b1": ("b", 6)}
        placed = {}
        for tid, (key, seed) in tenants.items():
            code, doc = _post(base + "/solve", {
                "dcop_yaml": texts[key], "algo": "dsa", "n_cycles": SHORT,
                "seed": seed, "tenant": tid})
            assert code == 200 and doc["tenant"] == tid
            placed[tid] = doc["worker"]
        assert placed["a0"] == placed["a1"] != placed["b0"] == placed["b1"]
        for tid, (key, seed) in tenants.items():
            rec = _until(f"{tid} done", lambda: (
                lambda r: r if r["status"] == "done" else None)(
                    _get(f"{base}/result/{tid}")))
            _same(rec, _solo(texts[key], seed, SHORT), tid)
        status = _get(base + "/status")
        buckets = status["placement"]["buckets"]
        assert sorted(buckets.values()) == ["w0", "w1"]

        # two long tenants of bucket a; their worker is killed mid-solve
        victim = placed["a0"]
        survivor = "w1" if victim == "w0" else "w0"
        for tid, seed in (("long0", 7), ("long1", 8)):
            code, doc = _post(base + "/solve", {
                "dcop_yaml": texts["a"], "algo": "dsa", "n_cycles": LONG,
                "seed": seed, "tenant": tid})
            assert code == 200 and doc["worker"] == victim
        os.kill(workers[victim][0], signal.SIGKILL)
        for tid, seed in (("long0", 7), ("long1", 8)):
            # done, and in the router's own cache (with its history)
            rec = _until(f"{tid} failed over", lambda: (
                lambda r: r if "history" in r else None)(
                    _get(f"{base}/result/{tid}")), timeout=180)
            _same(rec, _solo(texts["a"], seed, LONG), tid)
            assert [(h["event"], h.get("worker"), h.get("from"))
                    for h in rec["history"]] == [
                ("forward", victim, None),
                ("resolve-from-scratch", None, victim),
                ("forward", survivor, None), ("complete", survivor, None)]
        status = _get(base + "/status")
        assert status["admission"]["failovers"] == 1
        assert status["admission"]["from_scratch"] == 2

        # the victim restarted in place
        vport = workers[victim][1]
        revived = subprocess.Popen(
            [*CLI, "--device", "cpu", "serve", "--port", str(vport),
             "--window-ms", "20", "--checkpoint", str(state / victim)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        procs.append(revived)
        pids.append(revived.pid)
        _announced(revived, "SERVE_PORT=")
        _until("the victim back", lambda: _get(base + "/status")[
            "workers_up"] == 2, timeout=60)

        # the fleet verb over both live workers
        urls = [f"{w}=http://127.0.0.1:{workers[w][1]}" for w in workers]
        fleet = subprocess.run([*CLI, "fleet", "--once", *urls], cwd=ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=120)
        assert fleet.returncode == 0, fleet.stderr
        doc = json.loads(fleet.stdout)
        assert doc["workers_up"] == 2
        assert doc["workers"][survivor]["solves"] == 4

        # SIGTERM drains the router (and, after it, its workers)
        router.send_signal(signal.SIGTERM)
        assert router.wait(timeout=180) == 0
        report = json.loads(out.read_text())
        assert report["drained"] is True and report["state"] == "drained"
        assert report["tenant_counts"] == {"done": 6}
        assert report["admission"]["failovers"] == 1
        assert revived.wait(timeout=120) == 0
        manifest = json.loads((state / "router-manifest.json").read_text())
        assert manifest["kind"] == "router" and len(manifest["tenants"]) == 6

        # the fleet verb over both state directories: the workers wrote
        # their manifests at the drain (both are gone now)
        fleet = subprocess.run(
            [*CLI, "fleet", "--once", "--manifest", str(state)], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=120)
        assert fleet.returncode == 1, fleet.stderr
        doc = json.loads(fleet.stdout)
        assert doc["workers_total"] == 2 and doc["workers_up"] == 0
        assert sorted(doc["workers"]) == sorted(
            f"127.0.0.1:{port}" for _, port in workers.values())
    finally:
        _reap(pids)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)


def test_router_without_a_card_exits_nonzero(tmp_path, env):
    env = dict(env, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [*CLI, "router", "--spawn", "1", "--port", "0", "--state-dir",
         str(tmp_path / "s")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert "never announced" in run.stderr
    assert "ROUTER_PORT=" not in run.stdout
