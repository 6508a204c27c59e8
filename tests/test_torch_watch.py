"""The port's ``watch`` verb against the JAX package's, on the CPU.

Bars: ``_render_frame``, ``sparkline`` and ``_fmt_bytes`` give the JAX
verb's text on the same status and metrics documents (seeded, with the
pulse, SLO, durability, replication and memory blocks, agents and
reliability counters), and ``_render_fleet_frame`` the JAX verb's
``--fleet`` text on the same fleet status documents and rates;
``watch --once --json`` against a port ``ServeServer`` on the CPU, and
``watch --fleet --once [--json]`` against the port's ``fleet`` verb
federating it, return their documents in a process that never imports
torch; an unreachable surface exits 1, a single worker's or a fleet's.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
from test_torch_api import ROOT

from pydcop_tpu.commands import watch as jax_watch
from pydcop_tpu_torch.commands import watch


def _status(rng, i):
    doc = {"status": ["RUNNING", "serve", "FINISHED"][i % 3],
           "time": float(rng.uniform(0, 100)), "cycle": int(i * 7),
           "cost": float(rng.normal())}
    if i % 2:
        doc["best_cost"] = float(rng.normal())
        doc["cycles_to_best"] = int(rng.integers(100))
        doc["cost_curve"] = rng.normal(size=int(rng.integers(1, 200))
                                       ).tolist()
    if i % 3 == 0:
        doc["pulse"] = {"diagnosis": "converging", "cycle": 12,
                        "churn": float(rng.uniform()),
                        "residual": float(rng.uniform()),
                        "violations": 3,
                        "churn_series": rng.uniform(size=30).tolist()}
    if i % 4 != 3:
        doc["slo"] = {"objectives": {
            "availability": {"budget_remaining": float(rng.uniform(-1, 1)),
                             "burn_fast": float(rng.uniform(0, 30)),
                             "good": 30, "bad": 8,
                             "alert": ["fast", None][i % 2]},
            "p99_latency": {"budget_remaining": 1.0, "burn_fast": 0.0,
                            "good": 38, "bad": 0, "alert": None}},
            "transitions": 2}
    if i == 2:
        doc["durability"] = {"checkpoints": 3, "directory": "/ck",
                             "every_cycles": 64,
                             "resumed_from": {"cycle": 128},
                             "extra": {"scenario_cursor": 2}}
        doc["replication"] = {"mode": "k", "ktarget": 2, "visits": 5,
                              "refusals": 1, "retractions": 0,
                              "below_target": ["c1", "c2"]}
    doc["memory"] = {"bytes_in_use": int(rng.integers(1 << 40)),
                     "peak_bytes": 1 << 33, "limit_bytes": 80 << 30,
                     "headroom_pct": float(rng.uniform(0, 100)),
                     "guard": {"enabled": bool(i % 2), "reserve_pct": 10},
                     "refusals_total": i}
    if i % 2 == 0:
        doc["agents"] = {"a1": {"queue": 3, "parked": 0,
                                "dead_letters": 1}}
        doc["dead_letters"] = i
    return doc


def _metrics(rng, i):
    def values(n, labels=()):
        return [{"labels": dict(zip(labels, (f"a{j}",))),
                 "value": float(rng.integers(1000))} for j in range(n)]
    out = {
        "solve.device_cycles": {"kind": "counter", "values": values(1)},
        "solve.windows": {"kind": "counter", "values": values(1)},
        "solve.readback_bytes": {"kind": "counter", "values": values(1)},
        "mem.predicted_bytes": {"kind": "gauge", "values": values(2)},
        "comms.messages_sent": {"kind": "counter",
                                "values": values(2, ("agent",))},
        "comms.messages_received": {"kind": "counter",
                                    "values": values(1, ("agent",))},
        "chaos.events": {"kind": "counter", "values": values(1)},
        "serve.batch_size": {"kind": "histogram", "values": [
            {"labels": {}, "value": {"count": 4, "sum": 9.0,
                                     "buckets": [1, 3]}}]},
    }
    return {k: v for j, (k, v) in enumerate(out.items()) if (i + j) % 5}


@pytest.mark.parametrize("i", range(8))
def test_frame_is_jaxs(i):
    rng = np.random.default_rng(i)
    status, metrics = _status(rng, i), _metrics(rng, i)
    rates = {"a0": {"msg_s": float(rng.uniform(0, 50))}} if i % 2 else {}
    got = watch._render_frame(status, metrics, rates)
    assert got == jax_watch._render_frame(status, metrics, rates)
    assert got.startswith("status: ")


@pytest.mark.parametrize("width", [1, 7, 60])
def test_sparkline_and_bytes_are_jaxs(width):
    rng = np.random.default_rng(width)
    for series in ([], [None, 1.0], [3.0] * 5, rng.normal(size=500).tolist(),
                   list(range(width))):
        assert watch.sparkline(series, width) == jax_watch.sparkline(
            series, width)
    for n in (None, 0, 1023, 1024, 1.5e6, -4096, 1 << 45, 3.2e9):
        assert watch._fmt_bytes(n) == jax_watch._fmt_bytes(n)


@pytest.mark.parametrize("prev, cur, dt", [(0, 10, 2.0), (10, 4, 1.0),
                                           (3, 3, 0.0), (1, 5, -1.0)])
def test_clamped_rate_is_jaxs(prev, cur, dt):
    from pydcop_tpu.telemetry.federate import clamped_rate

    assert watch.clamped_rate(prev, cur, dt) == clamped_rate(prev, cur, dt)


def _watch(*argv):
    code = ("import runpy, sys; sys.argv = ['pydcop_tpu_torch', *sys.argv[1:]]"
            "\ntry:\n    runpy.run_module('pydcop_tpu_torch', "
            "run_name='__main__')\nexcept SystemExit as e:\n"
            "    rc = e.code\nprint('TORCH_IMPORTED=%s' % ('torch' in "
            "sys.modules), file=sys.stderr)\nsys.exit(rc)")
    return subprocess.run([sys.executable, "-c", code, "watch", *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)


def test_watch_once_json_reads_a_port_server():
    from test_torch_serve import _reqs

    from pydcop_tpu_torch.serve import ServeServer
    from pydcop_tpu_torch.telemetry import metrics_registry

    metrics_registry.reset()
    metrics_registry.enabled = True
    srv = ServeServer(port=0, window_ms=5, device="cpu")
    try:
        (req,) = _reqs("dsa", {}, (9,), 6, seed0=3)
        srv.wait(srv.submit(req, trace="00000000000000aa"), timeout=120)
        out = _watch(f"http://127.0.0.1:{srv.http.port}", "--once",
                     "--json")
        frame = _watch(f"http://127.0.0.1:{srv.http.port}", "--once")
    finally:
        srv.shutdown()
        metrics_registry.enabled = False
        metrics_registry.reset()
    assert out.returncode == 0, out.stderr
    assert "TORCH_IMPORTED=False" in out.stderr
    doc = json.loads(out.stdout)
    assert doc["status"]["tenants"]["dsa0"]["trace"] == "00000000000000aa"
    assert doc["status"]["solves"] == 1
    assert doc["metrics"]["serve.solves"]["values"][0]["value"] == 1.0
    assert frame.returncode == 0 and frame.stdout.startswith("status: serve")


def test_watch_unreachable_and_fleet(capsys):
    from pydcop_tpu_torch import dcop_cli

    # a port nothing listens on
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rc = dcop_cli.main(["watch", f"http://127.0.0.1:{port}", "--once"])
    assert rc == 1 and "no metrics surface" in capsys.readouterr().err
    rc = dcop_cli.main(["watch", "--fleet", f"http://127.0.0.1:{port}",
                        "--once"])
    assert rc == 1 and "fleet verb first" in capsys.readouterr().err


def _fleet_status(rng, n_workers):
    workers = {}
    for i in range(n_workers):
        row = {"url": f"http://127.0.0.1:{9000 + i}",
               "up": bool(rng.integers(2)), "stale": bool(i % 3 == 2),
               "age_s": None if i == 0 else float(rng.uniform(0, 30)),
               "scrapes": int(rng.integers(100)), "failures": 0,
               "retries": 0, "resets": int(rng.integers(3))}
        if i % 2:
            row.update(state="serving", queue_depth=int(rng.integers(9)),
                       queue_watermark=int(rng.integers(9, 20)),
                       solves=int(rng.integers(1000)),
                       occupancy_pct=round(float(rng.uniform(0, 100)), 1),
                       mem_bytes_in_use=int(rng.integers(1 << 34)),
                       mem_headroom_pct=round(float(rng.uniform(0, 99)), 1),
                       pulse=["healthy", "oscillating"][i % 4 == 1],
                       burn_fast=round(float(rng.uniform(0, 30)), 3),
                       solves_s=round(float(rng.uniform(0, 50)), 2))
            if row["burn_fast"] > 14.4:
                row["alert"] = "availability:fast"
            if i % 4 == 3:
                row["mem_refusals"] = int(rng.integers(1, 5))
        workers[f"w{i}"] = row
    status = {"status": "fleet", "workers": workers,
              "workers_total": n_workers,
              "workers_up": sum(r["up"] for r in workers.values()),
              "fleet": {"solves": int(rng.integers(5000)),
                        "queue_depth": int(rng.integers(30)),
                        "dead_letters": int(rng.integers(3)),
                        "solves_s": round(float(rng.uniform(0, 99)), 2)}}
    if n_workers % 2:
        status["slo"] = {"fleet": {"objectives": {
            "availability": {"budget_remaining": float(rng.uniform()),
                             "burn_fast": float(rng.uniform(0, 40)),
                             "good": 970, "bad": 30, "alert": "fast",
                             "worst_worker": "w1"},
            "lat": {"budget_remaining": 1.0, "burn_fast": 0.0,
                    "good": 1000, "bad": 0, "alert": None,
                    "worst_worker": "w0"}}}}
    return status


@pytest.mark.parametrize("n_workers", [0, 1, 2, 5, 8])
def test_fleet_frame_is_jaxs(n_workers):
    rng = np.random.default_rng(n_workers)
    status = _fleet_status(rng, n_workers)
    for rates in ({}, {f"w{i}": float(rng.uniform(0, 9))
                       for i in range(0, n_workers, 2)}):
        frame = watch._render_fleet_frame(status, rates)
        assert frame == jax_watch._render_fleet_frame(status, rates)
        assert frame.startswith(f"fleet: {status['workers_up']}/"
                                f"{n_workers} workers up")


def test_watch_fleet_reads_the_fleet_verb():
    from test_torch_serve import _reqs

    from pydcop_tpu_torch.serve import ServeServer
    from pydcop_tpu_torch.telemetry import metrics_registry

    metrics_registry.reset()
    metrics_registry.enabled = True
    srv = ServeServer(port=0, window_ms=5, device="cpu")
    fleet = None
    try:
        (req,) = _reqs("dsa", {}, (9,), 6, seed0=3)
        srv.wait(srv.submit(req), timeout=120)
        fleet = subprocess.Popen(
            [sys.executable, "-m", "pydcop_tpu_torch", "fleet", "--port",
             "0", "--interval", "0.2", "--duration", "60",
             f"w0=http://127.0.0.1:{srv.http.port}"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        line = fleet.stdout.readline()
        assert line.startswith("FLEET_PORT="), line
        url = f"http://127.0.0.1:{line.strip().split('=', 1)[1]}"
        out = _watch("--fleet", url, "--once", "--json")
        frame = _watch("--fleet", url, "--once")
    finally:
        if fleet is not None:
            fleet.terminate()
            fleet.wait(timeout=60)
        srv.shutdown()
        metrics_registry.enabled = False
        metrics_registry.reset()
    assert out.returncode == 0, out.stderr
    assert "TORCH_IMPORTED=False" in out.stderr
    doc = json.loads(out.stdout)
    assert doc["status"]["workers_up"] == 1
    assert doc["status"]["workers"]["w0"]["solves"] == 1
    assert doc["metrics"]["fleet.worker_up"]["values"] == [
        {"labels": {"worker": "w0"}, "value": 1.0}]
    assert frame.returncode == 0
    assert frame.stdout.startswith("fleet: 1/1 workers up  solves=1")
