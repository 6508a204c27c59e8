"""The port's memory plane (``pydcop_tpu_torch/telemetry/memplane.py``)
against the JAX package's ``pydcop_tpu/telemetry/memplane.py``, on the CPU.

The model's exact components (``problem``, ``layout_consts``, ``state``)
are held to the bytes of the port's own tensors on the same problem: the
``DeviceDCOP``, the constants an algorithm hands the engine and its
initial state.  The components both packages count alike (``anytime``,
``pulse``, ``curve``), the shapes, the guard's refusals (``breach``), the
``solve`` CLI's ERROR result and the ``memplan`` verb's verdicts are held
to the JAX package's.  Test names follow ``tests/test_memplane.py`` where
they mirror one.
"""

import argparse
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from pydcop_tpu import dcop_cli as jax_cli
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_coloring,
)
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_graph_coloring as jax_graph_coloring,
)
from pydcop_tpu.commands.generators.ising import (
    generate_ising_arrays as jax_ising,
)
from pydcop_tpu.dcop.yamldcop import dcop_yaml as jax_dcop_yaml
from pydcop_tpu.telemetry import memplane as jax_mem
from pydcop_tpu.telemetry import telemetry_off as jax_telemetry_off
from pydcop_tpu_torch import api, dcop_cli
from pydcop_tpu_torch.dcop.yamldcop import load_dcop
from pydcop_tpu_torch.interop import compiled_from_numpy
from pydcop_tpu_torch.random import PRNGKey
from pydcop_tpu_torch.serve import ServeServer, SolveRequest
from pydcop_tpu_torch.telemetry import metrics_registry
from pydcop_tpu_torch.telemetry.memplane import (
    GIB,
    MemoryBudgetExceeded,
    device_generation,
    device_limit_bytes,
    hbm_capacity_bytes,
    max_batch_k,
    max_vars_per_device,
    memguard,
    memory_status,
    predict_solve_bytes,
    sample_device_memory,
    shape_of,
    synthetic_shape,
)

BREACH_KEYS = {
    "reason", "context", "predicted_bytes", "limit_bytes", "reserve_pct",
    "budget_bytes", "dominant_component", "components",
}


@pytest.fixture(autouse=True)
def _guard_off():
    memguard.reset()
    yield
    memguard.reset()
    metrics_registry.reset()
    metrics_registry.enabled = False
    jax_telemetry_off()


def port_of(ref):
    """The port's CompiledDCOP for the JAX one's arrays."""
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    fields["buckets"] = [dataclasses.asdict(b) for b in ref.buckets]
    return compiled_from_numpy(fields)


# bench configs 2, 3 and 4, scaled down
PROBLEMS = {
    "config2": lambda: jax_coloring(300, 5, graph="random", p_edge=0.05,
                                    seed=11),
    "config3": lambda: jax_ising(12, 14, seed=3),
    "config4": lambda: jax_coloring(2000, 3, graph="scalefree", m_edge=2,
                                    seed=7),
}
_CACHE = {}


def problem(name):
    if name not in _CACHE:
        ref = PROBLEMS[name]()
        _CACHE[name] = (ref, port_of(ref))
    return _CACHE[name]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_shape_of_matches_compiled(name):
    ref, port = problem(name)
    assert shape_of(port)._asdict() == jax_mem.shape_of(ref)._asdict()
    assert shape_of(port).n_edges == port.n_edges


@pytest.mark.parametrize("args", [
    (1000, 3, 4.0, 2, 4), (777, 5, 2.5, 2, 4), (10, 2, 3.0, 3, 2),
    (123_456, 16, 7.0, 2, 8),
])
def test_synthetic_shape_headline_numbers(args):
    assert synthetic_shape(*args)._asdict() == (
        jax_mem.synthetic_shape(*args)._asdict()
    )


def _leaves(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _leaves(y, out)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _leaves(getattr(x, f.name), out)
    return out


def _solve_tensors(compiled, algo, params):
    """(DeviceDCOP, constants, initial state) of the port's solve of
    ``compiled``: the engine's arguments, caught before it runs."""
    mod = importlib.import_module(f"pydcop_tpu_torch.algorithms.{algo}")
    seen = {}

    class Caught(Exception):
        pass

    def spy(compiled, dev, init, *args, consts=(), **kwargs):
        seen.update(dev=dev, init=init, consts=consts)
        raise Caught

    orig, mod.run_cycles = mod.run_cycles, spy
    try:
        with pytest.raises(Caught):
            mod.solve(compiled, dict(params), n_cycles=2, device="cpu")
    finally:
        mod.run_cycles = orig
    key = torch.tensor(PRNGKey(0), dtype=torch.int64)
    state = seen["init"](seen["dev"], key, *seen["consts"])
    return seen["dev"], seen["consts"], state


EXACT_CASES = [
    ("config2", "maxsum", {"layout": "ell"}),
    ("config2", "maxsum", {"layout": "lanes"}),
    ("config2", "maxsum", {"layout": "edges"}),
    ("config2", "maxsum", {"layout": "ell", "precision": "bf16"}),
    ("config2", "maxsum", {"layout": "edges", "start_messages": "all"}),
    ("config4", "maxsum", {"layout": "ell"}),
    ("config4", "maxsum", {"layout": "pallas"}),
    ("config4", "dsa", {}),
    ("config4", "mgm", {}),
    ("config4", "mgm2", {}),
    ("config4", "gdba", {}),
    ("config4", "dba", {}),
    ("config4", "adsa", {}),
    ("config4", "dsatuto", {}),
    ("config3", "mgm2", {}),
    ("config3", "maxsum", {}),
]


@pytest.mark.parametrize("name, algo, params", EXACT_CASES)
def test_exact_components_count_the_ports_tensors(name, algo, params):
    _ref, port = problem(name)
    dev, consts, state = _solve_tensors(port, algo, params)
    const_tensors = {id(t): t for t in _leaves(consts, [])}
    # a tensor is counted once however many constants share its storage
    consts_bytes = sum({
        t.data_ptr(): t.nbytes for t in const_tensors.values()
    }.values())
    # the state's fields that are not constants (MaxSum's two planes are
    # one zero tensor at init: each field counts)
    state_bytes = sum(
        t.nbytes for t in _leaves(state, []) if id(t) not in const_tensors
    )
    got = predict_solve_bytes(port, algo, params)["components"]
    assert got["problem"] == sum(t.nbytes for t in _leaves(dev, []))
    assert got["layout_consts"] == consts_bytes
    assert got["state"] == state_bytes


@pytest.mark.parametrize("kw", [
    {}, {"pulse_on": True}, {"collect_curve": True, "n_cycles": 100},
    {"pulse_on": True, "n_cycles": 3, "batch_k": 4},
    {"collect_curve": True, "n_cycles": 1000, "batch_k": 2, "mesh": 2},
])
@pytest.mark.parametrize("algo", ["maxsum", "dsa", "mgm2"])
def test_shared_components_equal_jax(algo, kw):
    ref, port = problem("config4")
    got = predict_solve_bytes(port, algo, {}, **kw)["components"]
    want = jax_mem.predict_solve_bytes(ref, algo, {}, **kw)["components"]
    for k in ("anytime", "pulse", "curve", "donation_saved"):
        assert got[k] == want[k], k
    assert set(got) == set(want)


def test_components_sum_to_total():
    pred = predict_solve_bytes(algo="maxsum", shape=synthetic_shape(1000, 3))
    informational = {"serve_padding", "donation_saved"}
    total = sum(
        v for k, v in pred["components"].items() if k not in informational
    )
    assert total == pred["total_bytes"] == pred["per_device_bytes"]
    assert pred["dominant"] not in informational
    assert set(pred) == set(jax_mem.predict_solve_bytes(
        algo="maxsum", shape=jax_mem.synthetic_shape(1000, 3)))


def test_batch_k_scales_per_instance_parts():
    s = synthetic_shape(500, 3)
    one = predict_solve_bytes(algo="dsa", shape=s, batch_k=1)
    eight = predict_solve_bytes(algo="dsa", shape=s, batch_k=8)
    assert one["total_bytes"] < eight["total_bytes"] < 8 * one["total_bytes"]


def test_mesh_divides_per_device_bytes():
    s = synthetic_shape(4000, 3)
    one = predict_solve_bytes(algo="maxsum", shape=s, mesh=1)
    four = predict_solve_bytes(algo="maxsum", shape=s, mesh=4)
    assert four["per_device_bytes"] < one["per_device_bytes"]


@pytest.mark.parametrize("algo", ["dsa", "maxsum", "mgm2"])
def test_serve_bucket_charges_pow2_padding(algo):
    s = synthetic_shape(600, 3)
    exact = predict_solve_bytes(algo=algo, shape=s)
    bucketed = predict_solve_bytes(algo=algo, shape=s, serve_bucket=True)
    assert bucketed["total_bytes"] > exact["total_bytes"]
    # the padding is the bucket's total less the shape's, in the port's
    # model as in the JAX package's
    padded = jax_mem._bucketed(jax_mem.synthetic_shape(600, 3))
    assert bucketed["shape"] == padded._asdict()
    assert bucketed["components"]["serve_padding"] == (
        predict_solve_bytes(algo=algo, shape=padded)["total_bytes"]
        - exact["total_bytes"]
    )


def test_device_table_has_the_h100():
    assert hbm_capacity_bytes("NVIDIA H100 80GB HBM3") == 80 * GIB
    assert device_generation("NVIDIA H100 80GB HBM3")[1] == 3350.0
    assert device_generation("NVIDIA H100 PCIe")[0] == "h100 pcie"
    assert device_generation("NVIDIA H100 NVL")[0] == "h100 nvl"
    assert hbm_capacity_bytes("warp core") is None
    assert hbm_capacity_bytes("TPU v5e") is None


@pytest.mark.parametrize("algo", ["maxsum", "dsa", "mgm2", "gdba"])
def test_max_vars_per_device_monotone_in_limit(algo):
    small = max_vars_per_device(algo, 3, 4.0, 1 * GIB)
    big = max_vars_per_device(algo, 3, 4.0, 16 * GIB)
    assert 0 < small < big
    pred = predict_solve_bytes(
        algo=algo, shape=synthetic_shape(small, 3, degree=4.0))
    assert pred["total_bytes"] <= 1 * GIB * 0.9
    over = predict_solve_bytes(
        algo=algo, shape=synthetic_shape(small + 1, 3, degree=4.0))
    assert over["total_bytes"] > 1 * GIB * 0.9


@pytest.mark.parametrize("algo", ["dsa", "maxsum"])
def test_max_batch_k_fits_budget(algo):
    budget = 64 * 1024 * 1024
    k = max_batch_k(algo, 3, 1000, 4.0, budget)
    assert k >= 1
    shape = synthetic_shape(1000, 3, degree=4.0)
    fit = predict_solve_bytes(algo=algo, shape=shape, batch_k=k,
                              serve_bucket=True)
    assert fit["total_bytes"] <= budget * 0.9
    over = predict_solve_bytes(algo=algo, shape=shape, batch_k=k + 1,
                               serve_bucket=True)
    assert over["total_bytes"] > budget * 0.9
    assert max_batch_k(algo, 3, 1000, 4.0, 2 * budget) >= k


# ---------------------------------------------------------------------------
# the live plane
# ---------------------------------------------------------------------------


def test_sample_degrades_gracefully_on_cpu():
    metrics_registry.reset()
    metrics_registry.enabled = True
    assert sample_device_memory("test", "cpu") is None
    assert device_limit_bytes("cpu") is None
    unavailable = metrics_registry.snapshot()["metrics"][
        "mem.stats_unavailable"]["values"]
    assert any(v["labels"].get("api") == "memory_stats"
               for v in unavailable)
    doc = memory_status()
    assert doc["stats_available"] is False and doc["bytes_in_use"] is None


def test_limit_override_feeds_gauge_and_status():
    metrics_registry.reset()
    metrics_registry.enabled = True
    memguard.configure(limit_bytes=123 * 1024 * 1024)
    assert device_limit_bytes("cpu") == 123 * 1024 * 1024
    sample_device_memory("test", "cpu")
    snap = metrics_registry.snapshot()["metrics"]
    assert snap["mem.limit_bytes"]["values"][0]["value"] == 123 * 1024 * 1024
    st = memory_status()
    assert st["limit_bytes"] == 123 * 1024 * 1024
    assert st["guard"]["limit_bytes"] == 123 * 1024 * 1024
    assert st["refusals_total"] == 0


def test_solve_publishes_predicted_bytes():
    from pydcop_tpu_torch.algorithms import dsa

    _ref, port = problem("config4")
    metrics_registry.reset()
    metrics_registry.enabled = True
    memguard.configure(enabled=True, limit_bytes=1 * GIB)
    dsa.solve(port, {}, n_cycles=5, seed=0, device="cpu")
    snap = metrics_registry.snapshot()["metrics"]
    assert snap["mem.predicted_bytes"]["values"][0]["value"] == (
        predict_solve_bytes(port, "dsa", {}, n_cycles=5)["total_bytes"]
    )
    # the engine sampled at solve start and at its windows
    assert memory_status()["point"] in ("chunk", "solve_end")


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["dsa", "maxsum", "mgm2", "gdba"])
def test_direct_solve_refusal_names_the_breach(algo):
    ref, _ = problem("config4")
    port = port_of(ref)  # no solve has cached tensors on it
    mod = importlib.import_module(f"pydcop_tpu_torch.algorithms.{algo}")
    jax_mod = importlib.import_module(f"pydcop_tpu.algorithms.{algo}")
    metrics_registry.reset()
    metrics_registry.enabled = True
    for guard in (memguard, jax_mem.memguard):
        guard.configure(enabled=True, reserve_pct=10.0, limit_bytes=1024)
    with pytest.raises(MemoryBudgetExceeded) as exc:
        mod.solve(port, {}, n_cycles=5, seed=0, device="cpu")
    with pytest.raises(jax_mem.MemoryBudgetExceeded) as jax_exc:
        jax_mod.solve(ref, {}, n_cycles=5, seed=0)
    breach = exc.value.breach
    assert set(breach) == set(jax_exc.value.breach) == BREACH_KEYS
    assert set(breach["components"]) == set(
        jax_exc.value.breach["components"])
    assert breach["reason"] == "memory_budget" and breach["context"] == "solve"
    assert breach["limit_bytes"] == 1024 and breach["budget_bytes"] == 921
    assert breach["predicted_bytes"] == predict_solve_bytes(
        port, algo, {}, n_cycles=5)["total_bytes"]
    assert "predicted" in str(exc.value) and "budget" in str(exc.value)
    # refused before the upload: the problem has no device tensors
    assert ("dev", "cpu") not in port.__dict__.get("_device_consts", {})
    refusals = metrics_registry.snapshot()["metrics"][
        "mem.refusals_total"]["values"]
    assert any(v["labels"].get("reason") == "solve" and v["value"] >= 1
               for v in refusals)
    assert memory_status()["refusals_total"] >= 1


def test_solve_result_refusal_like_jax():
    import pydcop_tpu.api as jax_api
    from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load_dcop

    text = jax_dcop_yaml(jax_graph_coloring(30, 3, graph="random",
                                            p_edge=0.2, seed=2))
    for guard in (memguard, jax_mem.memguard):
        guard.configure(enabled=True, limit_bytes=2048)
    with pytest.raises(MemoryBudgetExceeded) as exc:
        api.solve_result(load_dcop(text), "maxsum", device="cpu")
    with pytest.raises(jax_mem.MemoryBudgetExceeded) as jax_exc:
        jax_api.solve_result(jax_load_dcop(text), "maxsum")
    assert set(exc.value.breach) == set(jax_exc.value.breach)
    assert exc.value.breach["dominant_component"] in exc.value.breach[
        "components"]


def test_no_limit_known_never_refuses():
    from pydcop_tpu_torch.algorithms import dsa

    _ref, port = problem("config2")
    memguard.configure(enabled=True)  # no override, and a CPU has no limit
    assert dsa.solve(port, {}, n_cycles=3, seed=0,
                     device="cpu").assignment is not None


def test_serve_admission_refuses_at_the_door():
    _ref, port = problem("config2")
    srv = ServeServer(port=None, window_ms=5, device="cpu")
    try:
        memguard.configure(enabled=True, limit_bytes=1024)
        with pytest.raises(MemoryBudgetExceeded) as exc:
            srv.submit(SolveRequest("big", port, "dsa", {}, 10, 0))
        assert exc.value.breach["context"] == "serve"
        assert exc.value.breach["components"]["serve_padding"] > 0
        # the refused tenant never entered the queue
        assert "big" not in srv.status()["tenants"]
        memguard.reset()
        tenant = srv.submit(SolveRequest("small", port, "dsa", {}, 5, 0))
        assert srv.wait(tenant, timeout=120)["status"] == "done"
    finally:
        memguard.reset()
        srv.shutdown(drain=True)


def test_serve_http_structured_503_with_breach():
    import urllib.error
    import urllib.request

    metrics_registry.reset()
    metrics_registry.enabled = True  # the refusal counter is gated
    srv = ServeServer(port=0, window_ms=5, device="cpu")
    base_url = f"http://127.0.0.1:{srv.http.port}"
    try:
        memguard.configure(enabled=True, limit_bytes=1024)
        body = json.dumps({
            "dcop_yaml": jax_dcop_yaml(jax_graph_coloring(
                9, 3, graph="grid", seed=5, extensive=True)),
            "algo": "dsa", "n_cycles": 5, "tenant": "oom",
        }).encode()
        req = urllib.request.Request(base_url + "/solve", data=body,
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 503
        doc = json.loads(exc.value.read())
        assert set(doc["mem"]) == BREACH_KEYS
        assert doc["mem"]["predicted_bytes"] > doc["mem"]["budget_bytes"]
        with urllib.request.urlopen(base_url + "/status", timeout=30) as r:
            mem_st = json.loads(r.read())["memory"]
        assert mem_st["guard"]["enabled"] is True
        assert mem_st["refusals_total"] >= 1
    finally:
        memguard.reset()
        srv.shutdown(drain=True)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def coloring_file(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(jax_dcop_yaml(jax_graph_coloring(
        40, 3, graph="random", p_edge=0.1, seed=3)))
    return path


@pytest.mark.parametrize("flags", [
    ["--mem-limit-bytes", "4096"],
    ["--mem-guard", "--mem-limit-bytes", "4096", "--mem-reserve-pct", "20"],
])
def test_solve_cli_error_json_like_jax(flags, coloring_file, tmp_path):
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    rc = dcop_cli.main(["--device", "cpu", "--output", str(port_out),
                        "solve", "-a", "maxsum", "-n", "5", *flags,
                        str(coloring_file)])
    jax_rc = jax_cli.main(["--output", str(jax_out), "solve", "-a",
                           "maxsum", "-n", "5", *flags, str(coloring_file)])
    assert rc == jax_rc == 1
    got, want = json.loads(port_out.read_text()), json.loads(
        jax_out.read_text())
    assert set(got) == set(want) == {"status", "error", "mem"}
    assert got["status"] == want["status"] == "ERROR"
    assert set(got["mem"]) == set(want["mem"]) == BREACH_KEYS
    assert got["mem"]["budget_bytes"] == want["mem"]["budget_bytes"]


def test_solve_cli_mem_guard_without_limit_solves(coloring_file, tmp_path):
    out = tmp_path / "r.json"
    rc = dcop_cli.main(["--device", "cpu", "--output", str(out), "solve",
                        "-a", "dsa", "-n", "5", "--mem-guard",
                        str(coloring_file)])
    assert rc == 0
    assert json.loads(out.read_text())["status"] == "FINISHED"


def test_serve_cli_accepts_mem_guard_flags():
    from pydcop_tpu_torch.commands import serve

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command")
    serve.set_parser(sub)
    args = parser.parse_args(["serve", "--mem-guard", "--mem-reserve-pct",
                              "5", "--mem-limit-bytes", "1000"])
    # the verb refuses no option since --peer was ported: the flags reach
    # run_cmd as parsed
    assert args.func is serve.run_cmd and args.peer == []
    assert (args.mem_guard, args.mem_reserve_pct,
            args.mem_limit_bytes) == (True, 5.0, 1000)


def _memplan(module, *argv):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command")
    module.set_parser(sub)
    args = parser.parse_args(["memplan", *argv])
    args.output = None
    return args.func(args)


def _port_memplan(*argv):
    from pydcop_tpu_torch.commands import memplan

    return _memplan(memplan, *argv)


def test_breakdown_and_verdict_pinned(capsys):
    rc = _port_memplan("--algo", "maxsum", "--n-vars", "100000",
                       "--domain", "3", "--degree", "4", "--device", "h100")
    assert rc == 0
    out = capsys.readouterr().out
    assert "memplan — algo maxsum (family maxsum, layout ell)" in out
    assert "shape: 100000 vars, domain 3, 400000 edges" in out
    assert ("device h100 80gb hbm3: limit 80.00 GiB, reserve 10% -> budget"
            in out)
    assert "verdict: FITS" in out
    assert "dominant component:" in out


def test_refuse_verdict(capsys):
    rc = _port_memplan("--algo", "maxsum", "--n-vars", "100000",
                       "--domain", "3", "--limit-bytes",
                       str(16 * 1024 * 1024))
    assert rc == 0
    assert "verdict: REFUSE" in capsys.readouterr().out


@pytest.mark.parametrize("algo, limit", [
    ("maxsum", 16 * 1024 * 1024), ("maxsum", 64 * GIB),
    ("mgm2", 1024 * 1024), ("mgm2", 8 * GIB), ("dsa", 4096),
    ("gdba", 32 * GIB),
])
def test_memplan_verdict_like_jax(algo, limit, capsys):
    from pydcop_tpu.commands import memplan as jax_memplan

    argv = ["--algo", algo, "--n-vars", "100000", "--domain", "3",
            "--limit-bytes", str(limit), "--json"]
    assert _port_memplan(*argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert _memplan(jax_memplan, *argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    assert set(got["plan"]) == set(want["plan"])
    assert got["fits"] == want["fits"]
    for k in ("algo", "limit_bytes", "device", "reserve_pct",
              "budget_bytes"):
        assert got[k] == want[k], k


def test_capacity_answers(capsys):
    import re

    rc = _port_memplan("--algo", "maxsum", "--domain", "3", "--degree", "4",
                       "--n-vars", "100000", "--device", "h100",
                       "--max-vars", "--max-batch-k")
    assert rc == 0
    out = capsys.readouterr().out
    (n_vars,) = re.findall(r"max vars/device \(maxsum, D=3, degree 4\): "
                           r"(\d+)", out)
    (batch_k,) = re.findall(r"max batch-K \(maxsum, D=3, 100000 vars\): "
                            r"(\d+)", out)
    assert int(n_vars) == max_vars_per_device("maxsum", 3, 4.0, 80 * GIB)
    assert int(batch_k) == max_batch_k("maxsum", 3, 100000, 4.0, 80 * GIB)
    assert int(n_vars) > 100000 and int(batch_k) >= 1


def test_json_mode(capsys):
    rc = _port_memplan("--algo", "mgm2", "--n-vars", "1000", "--domain",
                       "2", "--device", "h100 pcie", "--json")
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["fits"] is True
    assert doc["plan"]["total_bytes"] > 0
    assert doc["device"] == "h100 pcie"


def test_errors_without_shape_or_limit(capsys):
    assert _port_memplan("--algo", "maxsum") == 2
    assert _port_memplan("--algo", "maxsum", "--domain", "3",
                         "--max-vars") == 2
    assert _port_memplan("--algo", "maxsum", "--n-vars", "10", "--domain",
                         "3", "--device", "v5e") == 2
    assert "unknown device" in capsys.readouterr().err


def test_dcop_file_exact_shape(capsys, tmp_path):
    f = tmp_path / "c.yaml"
    f.write_text(
        """
name: t
objective: min
domains: {d: {values: [0, 1, 2]}}
variables: {v1: {domain: d}, v2: {domain: d}, v3: {domain: d}}
constraints:
  c12: {type: intention, function: 1.0 if v1 == v2 else 0.0}
  c23: {type: intention, function: 1.0 if v2 == v3 else 0.0}
agents: [a1, a2, a3]
"""
    )
    rc = _port_memplan(str(f), "-a", "dsa", "--device", "h100")
    assert rc == 0
    out = capsys.readouterr().out
    assert "shape: 3 vars, domain 3, 4 edges, 2 constraints" in out
    assert "verdict: FITS" in out


def test_memplan_is_a_host_only_verb(capsys):
    # no --device cpu, no card: the verb runs
    assert dcop_cli.main(["memplan", "--n-vars", "1000", "--domain", "3",
                          "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["plan"]["layout"] == "ell"
    assert np.isclose(doc["plan"]["total_bytes"], predict_solve_bytes(
        algo="maxsum", shape=synthetic_shape(1000, 3))["total_bytes"])
