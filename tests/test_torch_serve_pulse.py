"""Serving with pulse on (health rows in the vmapped chunk graphs) and
fleet checkpoints, against the JAX package, on the CPU.

- ``solve_batched`` with pulse on gives each vmap tenant the health rows
  of the port's ``solve_one`` bit for bit, and its flip counters are
  JAX's batched ones.  MaxSum's rows (grids at damping 0.7) are JAX's
  batched rows bit for bit: JAX's vmapped serving program damps in XLA's
  FMA form as its solo program does.  The local-search rows (DSA at bench
  config 8's tenant shapes, MGM) are JAX's, solo and batched, bit for bit
  but for the three fields that are float sums over the bucket's rows
  (``cost``, ``best_cost``, ``aux``): XLA vectorizes those reductions
  where they are fused with the gathers that make them (ROADMAP, "Known
  divergences"), in another way in the vmapped program than in the solo
  one, so JAX's own batched rows leave its own solo rows in the last bits
  there; the port keeps one order, XLA's unfused one, and those fields are
  held to rel 1e-6.  Fused mode gives no rows, as in JAX.
- Pulse on makes as many host syncs as pulse off; a warm batch captures
  nothing, and pulse on and off capture different graphs.
- ``ServeServer.status()``'s pulse blocks and ``drain()``'s fleet manifest
  are JAX's key for key (``wrote_unix_s`` and ``endpoint`` excepted).
- The ``serve`` verb: pulse rows by default, ``--no-pulse``, and
  ``--checkpoint [DIR]`` drained by SIGTERM.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
from test_torch_api import ROOT, _path
from test_torch_engine import _ReplayedBody
from test_torch_serve import _reqs

from pydcop_tpu.serve import ServeServer as JaxServer
from pydcop_tpu.serve import solve_batched as jax_solve_batched
from pydcop_tpu.serve import solve_one as jax_solve_one
from pydcop_tpu.telemetry.pulse import pulse as jax_pulse
from pydcop_tpu_torch.algorithms import base
from pydcop_tpu_torch.serve import ServeServer, solve_batched, solve_one
from pydcop_tpu_torch.serve import batch as serve_batch
from pydcop_tpu_torch.telemetry.pulse import HEALTH_FIELDS, HEALTH_WIDTH, pulse

#: the health fields that are float sums (XLA's vmapped program orders
#: some of them otherwise than its solo program)
SUM_FIELDS = [HEALTH_FIELDS.index(f) for f in ("cost", "best_cost", "aux")]


@pytest.fixture
def pulse_on():
    for p in (pulse, jax_pulse):
        p.reset()
        p.enabled = True
    yield
    for p in (pulse, jax_pulse):
        p.enabled = False
        p.reset()


#: (algo, params, tenant sizes, cycles): bench config 8's DSA tenants
#: (3x3 and 4x4 grids), MaxSum grid tenants
CASES = {
    "dsa": ("dsa", {}, (9, 9, 16, 16, 9), 20),
    "dsa-C": ("dsa", {"variant": "C"}, (9, 16), 16),
    "mgm": ("mgm", {}, (9, 16, 16), 12),
    "maxsum": ("maxsum", {"damping": 0.7}, (49, 49, 25), 20),
    "maxsum-bf16": ("maxsum", {"damping": 0.7, "precision": "bf16"},
                    (49, 25), 16),
}


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(
        np.uint32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_health_rows_are_jax_s(case, pulse_on):
    algo, params, sizes, cycles = CASES[case]
    got = solve_batched(_reqs(algo, params, sizes, cycles), device="cpu")
    jreqs = _reqs(algo, params, sizes, cycles, jax=True)
    want = jax_solve_batched(jreqs)
    for jreq in jreqs:
        tenant = jreq.tenant
        tr = got[tenant]
        jp, pp = want[tenant].extras["pulse"], tr.extras["pulse"]
        assert tr.result.cycles == want[tenant].result.cycles
        assert pp["health"].shape == (tr.result.cycles, HEALTH_WIDTH)
        port_solo = solve_one(
            _reqs(algo, params, sizes, cycles)[int(tenant[-1])],
            device="cpu").extras["pulse"]["health"]
        assert np.array_equal(_bits(pp["health"]), _bits(port_solo))
        jax_solo = jax_solve_one(jreq).extras["pulse"]["health"]
        exact = [i for i in range(HEALTH_WIDTH)
                 if algo == "maxsum" or i not in SUM_FIELDS]
        for ref in (jp["health"], jax_solo):
            assert np.array_equal(_bits(pp["health"])[:, exact],
                                  _bits(ref)[:, exact])
            np.testing.assert_allclose(pp["health"], ref, rtol=1e-6)
        assert np.array_equal(pp["flip_count"],
                              np.asarray(jp["flip_count"]))
        assert pp["flip_count"].shape == (sizes[int(tenant[-1])],)


def test_batch_rows_are_solve_one_s_with_a_stability_stop(pulse_on):
    # MaxSum stops on stable messages: tenants of one batch stop at
    # different cycles, and each keeps only its live rows
    reqs = _reqs("maxsum", {"damping": 0.5}, (25, 25, 25, 25), 200,
                 seed0=910)
    out = solve_batched(reqs, device="cpu")
    cycles = set()
    for r in reqs:
        one = solve_one(r, device="cpu")
        got, want = out[r.tenant].extras["pulse"], one.extras["pulse"]
        assert np.array_equal(_bits(got["health"]), _bits(want["health"]))
        assert np.array_equal(got["flip_count"], want["flip_count"])
        cycles.add(one.result.cycles)
    assert len(cycles) > 1 and min(cycles) < 200


def test_pulse_off_and_fused_mode_give_no_rows(pulse_on):
    reqs = _reqs("dsa", {}, (9, 16), 10)
    out = solve_batched(reqs, mode="fused", device="cpu")
    assert all("pulse" not in tr.extras for tr in out.values())
    pulse.enabled = False
    out = solve_batched(reqs, device="cpu")
    assert all("pulse" not in tr.extras for tr in out.values())


@pytest.fixture
def graph_runner(monkeypatch):
    """The card's batch runner rehearsed on the CPU."""
    monkeypatch.setattr(base, "_capture", _ReplayedBody)
    monkeypatch.setattr(base, "_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        base, "_runner",
        lambda compiled, solver, dev, consts: base._graphs(
            compiled, solver, dev, consts),
    )
    monkeypatch.setattr(serve_batch, "_slots", type(serve_batch._slots)())


def test_pulse_keeps_host_syncs_and_warm_batches_capture_nothing(
        graph_runner, pulse_on):
    reqs = _reqs("dsa", {}, (16, 16, 16), 40, seed0=930)
    other = [r._replace(tenant=f"o{i}") for i, r in enumerate(
        _reqs("dsa", {}, (16, 16, 16), 40, seed0=960))]

    def batch(rs):
        captures = base.run_cycles.captures
        syncs = base.run_cycles.host_syncs
        out = solve_batched(rs, device="cpu")
        return (out, base.run_cycles.captures - captures,
                base.run_cycles.host_syncs - syncs)

    on, cap_on, syncs_on = batch(reqs)
    assert cap_on == 2
    warm, cap_warm, syncs_warm = batch(other)
    assert cap_warm == 0 and syncs_warm == syncs_on
    pulse.enabled = False
    off, cap_off, syncs_off = batch(reqs)
    assert cap_off == 2  # pulse off: the graphs captured without it
    assert syncs_off == syncs_on
    assert batch(other)[1] == 0
    for r in reqs:
        assert "pulse" not in off[r.tenant].extras
        assert off[r.tenant].result.assignment == (
            on[r.tenant].result.assignment)
    pulse.enabled = True
    for r in other:
        want = solve_one(r, device="cpu").extras["pulse"]
        assert np.array_equal(_bits(warm[r.tenant].extras["pulse"]["health"]),
                              _bits(want["health"]))


def _serve(server_cls, reqs, tmp_path, **kw):
    srv = server_cls(window_ms=2000.0, max_batch=len(reqs),
                     checkpoint_dir=str(tmp_path), **kw)
    try:
        for r in reqs:
            srv.submit(r)
        for r in reqs:
            assert srv.wait(r.tenant, timeout=120)["status"] == "done"
        status = srv.status()
    finally:
        assert srv.drain(timeout=120)
    with open(srv.fleet_checkpoint_path) as f:
        return status, json.load(f)


def test_server_pulse_blocks_and_fleet_manifest_are_jax_s(pulse_on,
                                                          tmp_path):
    algo, params, sizes, cycles = CASES["dsa"]
    status, manifest = _serve(
        ServeServer, _reqs(algo, params, sizes, cycles), tmp_path / "port",
        device="cpu")
    jstatus, jmanifest = _serve(
        JaxServer, _reqs(algo, params, sizes, cycles, jax=True),
        tmp_path / "jax")
    assert sorted(status["tenants"]) == sorted(jstatus["tenants"])
    for tenant, row in status["tenants"].items():
        assert row["pulse"] == jstatus["tenants"][tenant]["pulse"]
        # JAX's rows also carry a trace id (request spans: not ported)
        assert set(row) == set(jstatus["tenants"][tenant]) - {"trace"}
    assert os.path.basename(manifest.pop("endpoint") or "x") == "x"
    manifest.pop("wrote_unix_s")
    jmanifest.pop("endpoint")
    jmanifest.pop("wrote_unix_s")
    assert manifest == jmanifest
    assert manifest["kind"] == "fleet"
    assert set(manifest["tenants"]) == {f"dsa{i}" for i in range(5)}


def _post_and_wait(base_url, tenant):
    with open(_path("graph_coloring")) as f:
        body = json.dumps({"dcop_yaml": f.read(), "algo": "dsa",
                           "n_cycles": 10, "tenant": tenant}).encode()
    req = urllib.request.Request(base_url + "/solve", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert json.loads(resp.read()) == {"tenant": tenant}
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        with urllib.request.urlopen(f"{base_url}/result/{tenant}") as resp:
            row = json.loads(resp.read())
        if row["status"] == "done":
            return row
        time.sleep(0.05)
    raise AssertionError(f"tenant {tenant} not done: {row}")


@pytest.mark.parametrize("flags", [["--checkpoint"], ["--no-pulse",
                                                      "--checkpoint", "ck"]])
def test_serve_verb_pulse_and_checkpoint_drained_by_sigterm(flags,
                                                            tmp_path):
    out = tmp_path / "serve.json"
    env = dict(os.environ, PYDCOP_TPU_STATE_DIR=str(tmp_path / "state"))
    flags = [str(tmp_path / f) if f == "ck" else f for f in flags]
    proc = subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
         "--output", str(out), "serve", "--port", "0", "--window-ms", "5",
         "--duration", "120", *flags],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVE_PORT="), line
        row = _post_and_wait(
            f"http://127.0.0.1:{int(line.split('=')[1])}", "cli")
        assert row["cycles"] == 10
        if "--no-pulse" in flags:
            assert "pulse" not in row
        else:
            assert row["pulse"]["cycles"] == 10
            assert set(row["pulse"]) == {"diagnosis", "churn", "residual",
                                         "violations", "cycles"}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()
        proc.communicate()
    summary = json.loads(out.read_text())
    want_dir = (tmp_path / "ck" if "--no-pulse" in flags
                else tmp_path / "state" / "checkpoints")
    assert summary["fleet_checkpoint"] == str(want_dir /
                                             "fleet-manifest.json")
    manifest = json.loads((want_dir / "fleet-manifest.json").read_text())
    assert manifest["kind"] == "fleet" and manifest["state"] == "drained"
    assert manifest["tenants"]["cli"]["status"] == "done"
    assert manifest["worker"].startswith("127.0.0.1:")
