"""The ``capture`` verb against the JAX package's, on the CPU.

Bars: ``capture --device cpu --configs 2`` writes a bundle whose config-2
record has the cost and violations of the JAX package's config-2 record
and its keys, but for the device-specific ones named here (the census
label, XLA's cost analysis and memory analysis, the Pallas sub-block);
the manifest names torch and the budget block says why it is empty;
``--force`` resumes into a bundle and keeps its configs; config 1 gives
JAX's skipped record without a reference checkout and config 10 refuses
by name; bad arguments exit 2; without a card and without ``--device
cpu`` the verb refuses, while ``capture diff`` needs no card.
"""

import importlib.util
import json
import os

import pytest

import pydcop_tpu.telemetry as jax_tel
from pydcop_tpu_torch.dcop_cli import main
from pydcop_tpu_torch.tools import capture_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_all():
    spec = importlib.util.spec_from_file_location(
        "bench_all_capture_test", os.path.join(ROOT, "bench_all.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    out = str(root / "bundle")
    rc = main(["--device", "cpu", "--output", str(root / "payload.json"),
               "capture", "-o", out, "--configs", "2", "--no-profiler"])
    with open(root / "payload.json") as f:
        payload = json.load(f)
    return {"out": out, "rc": rc, "payload": payload, "root": root}


@pytest.fixture(scope="module")
def jax_record(tmp_path_factory):
    # JAX's config-2 record on the CPU, its Pallas sub-block left out
    # (the interpreter's timing: a plumbing datum)
    old = os.environ.get("PYDCOP_TPU_STATE_DIR")
    os.environ["PYDCOP_TPU_STATE_DIR"] = str(
        tmp_path_factory.mktemp("jax_state"))
    orig = jax_tel.ell_kernel_block
    jax_tel.ell_kernel_block = lambda c, reps=10, **kw: orig(
        c, reps=reps, time_pallas=False)
    try:
        return _bench_all().run_config("2")
    finally:
        jax_tel.ell_kernel_block = orig
        jax_tel.telemetry_off()
        if old is None:
            os.environ.pop("PYDCOP_TPU_STATE_DIR", None)
        else:
            os.environ["PYDCOP_TPU_STATE_DIR"] = old


def _record(bundle, key):
    with open(os.path.join(bundle["out"], "records",
                           f"config_{key}.json")) as f:
        return json.load(f)


def test_capture_config2_is_jaxs(bundle, jax_record):
    assert bundle["rc"] == 0
    rec = _record(bundle, "2")
    assert (rec["cost"], rec["violations"]) == (
        jax_record["cost"], jax_record["violations"])
    assert set(rec) == set(jax_record)
    # device-specific: XLA's memory_analysis peak and cost analysis have
    # no counterpart on the CPU (JAX's record has them only when its
    # warm-up compiled, not in a process whose jit cache is warm); the
    # census names the port's label
    for block, key in (("memory", "model_ratio"),
                       ("roofline", "achieved_gflops")):
        assert key not in rec[block]
        assert set(rec[block]) | {key} == set(jax_record[block]) | {key}
    for block in ("compile", "telemetry", "pulse"):
        assert set(rec[block]) == set(jax_record[block]), block
    assert rec["roofline"]["traffic_bytes_per_cycle"] == (
        jax_record["roofline"]["traffic_bytes_per_cycle"])
    assert set(rec["census"]["jit"]) == {"solve.run_cycles"}
    assert set(jax_record["census"]["jit"]) == {"solve._solve_fused"}
    assert rec["census"]["jit"]["solve.run_cycles"] == (
        jax_record["census"]["jit"]["solve._solve_fused"])
    assert set(rec["census"]["readback"]) == set(
        jax_record["census"]["readback"])
    assert set(rec["kernel"]) - set(jax_record["kernel"]) == {
        "ell_minplus"}
    assert rec["kernel"]["traffic_bytes_per_cycle"] == (
        jax_record["kernel"]["traffic_bytes_per_cycle"])
    assert rec["telemetry"]["cost_curve"] == (
        jax_record["telemetry"]["cost_curve"])


def test_bundle_layout_and_manifest(bundle):
    out = bundle["out"]
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "pydcop_tpu.capture/1"
    env = manifest["environment"]
    assert env["device"] == "cpu" and "torch" in env and "cuda" in env
    assert "power_limit" not in env  # no card
    assert "not ported" in manifest["budget"]["error"]
    assert manifest["configs"]["2"]["attribution"] == "ok"
    assert os.path.isdir(os.path.join(out, "hlo", "config_2"))
    assert not os.path.exists(os.path.join(out, "profile"))
    assert bundle["payload"]["warnings"] == []
    assert bundle["payload"]["device"] == "cpu"
    # a clean self-diff
    assert main(["capture", "diff", out, out]) == 0


def test_force_resumes_and_keeps_configs(bundle):
    out = bundle["out"]
    assert main(["--device", "cpu", "capture", "-o", out, "--configs",
                 "1", "--no-profiler"]) == 2  # a bundle: --force needed
    assert main(["--device", "cpu", "capture", "-o", out, "--configs",
                 "1", "--no-profiler", "--force"]) == 0
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest["configs"]) == {"1", "2"}


def test_skipped_and_refused_configs(monkeypatch):
    monkeypatch.delenv(capture_configs.REFERENCE_ENV, raising=False)
    got = capture_configs.run_config("1", device="cpu")
    want = _bench_all().run_config("1")
    assert set(got) == set(want) == {"metric", "value", "skipped",
                                     "config"}
    assert got["metric"] == want["metric"] and got["value"] is None
    refused = capture_configs.run_config("10", device="cpu")
    assert refused["value"] is None
    assert "8 devices" in refused["error"]
    assert "sharded ELL" in refused["error"]


def test_config_tables_are_jaxs():
    ba = _bench_all()
    assert capture_configs.DEFAULT_CONFIGS == ba.DEFAULT_CONFIGS
    assert capture_configs.KERNEL_CONFIGS == ba.KERNEL_CONFIGS
    assert capture_configs.METRIC_NAMES == ba.METRIC_NAMES
    assert set(capture_configs.CONFIGS) == set(ba.CONFIGS)


@pytest.mark.parametrize("argv", [
    ["--device", "cpu", "capture", "--configs", "2"],  # no -o
    ["--device", "cpu", "capture", "-o", "x", "--configs", "11"],
    ["--device", "cpu", "capture", "frobnicate"],
    ["capture", "-o", "x", "--configs", "2"],  # the card, and none
])
def test_bad_arguments_exit_2(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(argv) == 2
    assert not os.path.exists(tmp_path / "x" / "manifest.json")
