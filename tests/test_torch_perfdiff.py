"""The port's capture bundles and ``capture diff`` against the JAX
package's, on synthetic bundles.

Bars: the port's ``perfdiff`` writes the JAX package's bundle files byte
for byte, and on the same comparands (bundles built in ``tmp_path`` with
a known per-op regression, a dispatch-count change and a recompile; a
records file, a wrapped records file, a history glob) gives JAX's
``diff_sides`` JSON, JAX's ``format_diff`` text byte for byte, and the
``capture diff`` verb JAX's output and exit code (0 clean, 1 significant,
2 an unreadable comparand).
"""

import argparse
import contextlib
import copy
import io
import json
import os

import pytest

from pydcop_tpu.commands import capture as jax_capture
from pydcop_tpu.telemetry import perfdiff as jax_perfdiff
from pydcop_tpu_torch.commands import capture
from pydcop_tpu_torch.telemetry import perfdiff


def _ell_record(metric="maxsum_1k_random_wall", value=0.10, device="cpu",
                config="2"):
    """A synthetic capture record with the full observability surface
    (compile, census, roofline and kernel blocks; the port's fused
    ``minplus`` row and its gather row charged no time)."""
    return {
        "metric": metric,
        "value": value,
        "unit": "s",
        "cost": 42.0,
        "violations": 0,
        "cycles": 60,
        "device": device,
        "config": config,
        "telemetry": {"windows": 3, "readback_bytes": 8016},
        "compile": {"jit_compiles": 1, "jit_cache_hits": 0},
        "census": {
            "jit": {
                "solve.run_cycles": {
                    "compiles": 0, "hits": 1, "dispatches": 1,
                },
            },
            "readback": {"windows": 3, "readbacks": 1},
        },
        "roofline": {
            "traffic_bytes_per_cycle": 773400,
            "achieved_gbps": 1.68,
        },
        "memory": {"predicted_bytes": 1837140, "measured_peak_bytes": None},
        "kernel": {
            "layout": "ell",
            "step_ms": 0.46,
            "attributed_pct": 98.5,
            "ops": {
                "pair_gather": {"ms": 0.0, "share_pct": 0.0, "gbps": None,
                                "fused_into": "minplus"},
                "minplus": {"ms": 0.235, "share_pct": 51.1, "gbps": 1.8,
                            "fused": ["pair_gather"]},
                "variable_step": {"ms": 0.218, "share_pct": 47.4,
                                  "gbps": 1.0},
                "readback": {"ms": 0.01, "bytes": 8016, "per_solve": True},
            },
        },
    }


def _mgm2_record(value=0.20):
    rec = _ell_record(metric="mgm2_ising10k_wall", value=value, config="3")
    rec["kernel"] = {
        "algo": "mgm2",
        "step_ms": 6.0,
        "attributed_pct": 95.0,
        "phases": {
            "value": {"ms": 1.0, "share_pct": 16.7},
            "offer": {"ms": 2.0, "share_pct": 33.3},
            "gain": {"ms": 3.0, "share_pct": 50.0},
        },
    }
    return rec


def _write_bundle(mod, out, recs):
    manifest = mod.new_manifest(
        environment={"device": "gpu"}, created="2026-10-18T00:00:00"
    )
    mod.write_manifest(out, manifest)
    for rec in recs:
        mod.append_record(out, rec, manifest)
    return out


@pytest.fixture()
def bundles(tmp_path):
    """``base`` and ``fresh`` (minplus x4 and a doubled wall; a warm
    solve dispatching twice; a recompile in the timed run; a memory
    growth), written by the port."""
    base_recs = [
        _ell_record(),
        _mgm2_record(),
        _ell_record(metric="dpop_meetings_wall", value=0.05, config="5"),
    ]
    fresh_recs = copy.deepcopy(base_recs)
    fresh_recs[0]["value"] = 0.20
    fresh_recs[0]["kernel"]["ops"]["minplus"]["ms"] = 0.94
    fresh_recs[0]["memory"]["predicted_bytes"] = 9 << 20
    fresh_recs[1]["value"] = 0.40
    fresh_recs[1]["census"]["jit"]["solve.run_cycles"].update(
        {"hits": 2, "dispatches": 2}
    )
    fresh_recs[2]["value"] = 0.11
    fresh_recs[2]["census"]["jit"]["solve.run_cycles"].update(
        {"compiles": 1, "dispatches": 2}
    )
    return {
        "base": _write_bundle(perfdiff, str(tmp_path / "base"), base_recs),
        "fresh": _write_bundle(perfdiff, str(tmp_path / "fresh"),
                               fresh_recs),
        "recs": (base_recs, fresh_recs),
        "tmp": tmp_path,
    }


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_bundle_files_are_jaxs(bundles):
    base_recs, _ = bundles["recs"]
    jax_out = _write_bundle(jax_perfdiff, str(bundles["tmp"] / "jax"),
                            base_recs)
    assert _files(bundles["base"]) == _files(jax_out)
    assert perfdiff.BUNDLE_FORMAT == jax_perfdiff.BUNDLE_FORMAT
    assert perfdiff.DIFF_FORMAT == jax_perfdiff.DIFF_FORMAT


@pytest.mark.parametrize("pair", [("base", "fresh"), ("fresh", "base"),
                                  ("base", "base")])
@pytest.mark.parametrize("all_metrics", [False, True])
def test_diff_json_and_text_are_jaxs(bundles, pair, all_metrics):
    a, b = (bundles[k] for k in pair)
    got = perfdiff.diff_sides(perfdiff.load_side(a), perfdiff.load_side(b))
    want = jax_perfdiff.diff_sides(
        jax_perfdiff.load_side(a), jax_perfdiff.load_side(b)
    )
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert perfdiff.format_diff(got, all_metrics=all_metrics) == (
        jax_perfdiff.format_diff(want, all_metrics=all_metrics)
    )
    if pair == ("base", "fresh"):
        assert got["significant"]
        assert any(md["flags"] for md in got["metrics"])


def test_records_and_history_comparands_are_jaxs(tmp_path):
    raw = tmp_path / "BENCH_a.json"
    raw.write_text(json.dumps(_ell_record()) + "\n")
    wrapped = tmp_path / "BENCH_b.json"
    wrapped.write_text(json.dumps({
        "tail": json.dumps(_ell_record(value=0.3)),
    }))
    for i, (value, device) in enumerate(
        [(0.1, "gpu"), (0.2, "gpu"), (0.3, "gpu"), (9.9, "cpu")]
    ):
        (tmp_path / f"BENCH_r{i}.json").write_text(
            json.dumps(_ell_record(value=value, device=device)) + "\n"
        )
    for spec, device in ((str(raw), None), (str(wrapped), None),
                         (str(tmp_path / "BENCH_r*.json"), "gpu"),
                         (str(tmp_path / "BENCH_r*.json"), None)):
        got = perfdiff.load_side(spec, device=device)
        want = jax_perfdiff.load_side(spec, device=device)
        assert got == want
    with pytest.raises(FileNotFoundError):
        perfdiff.load_side(str(tmp_path / "none_*.json"))


@pytest.mark.parametrize("record", [
    _ell_record(), _mgm2_record(), {"metric": "x", "value": 1.0},
    dict(_ell_record(), kernel={"error": "RuntimeError: boom"}),
    dict(_ell_record(), kernel={"layout": "ell", "skipped": "no edges"}),
])
def test_attribution_rows_are_jaxs(record):
    assert perfdiff.attribution_state(record) == (
        jax_perfdiff.attribution_state(record)
    )
    assert perfdiff.op_rows(record) == jax_perfdiff.op_rows(record)


def _run_diff(mod, spec, json_out=None, all_metrics=False):
    args = argparse.Namespace(
        spec=["diff"] + spec, diff_json=json_out, all_metrics=all_metrics,
        device=None, diff_device=None,
    )
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.run_cmd(args)
    return rc, out.getvalue()


@pytest.mark.parametrize("case", ["clean", "regressed", "missing",
                                  "arity"])
def test_capture_diff_verb_is_jaxs(bundles, case):
    spec = {
        "clean": [bundles["base"], bundles["base"]],
        "regressed": [bundles["base"], bundles["fresh"]],
        "missing": [bundles["base"], str(bundles["tmp"] / "nowhere")],
        "arity": [bundles["base"]],
    }[case]
    tmp = bundles["tmp"]
    got = _run_diff(capture, spec, str(tmp / "port.json"))
    want = _run_diff(jax_capture, spec, str(tmp / "jax.json"))
    assert got == want
    assert got[0] == {"clean": 0, "regressed": 1, "missing": 2,
                      "arity": 2}[case]
    if case in ("clean", "regressed"):
        assert (tmp / "port.json").read_text() == (
            tmp / "jax.json").read_text()


def test_capture_diff_through_the_cli_needs_no_card(bundles, capsys):
    # the global --device defaults to the card; `capture diff` is host
    # only and runs without one
    import torch

    from pydcop_tpu_torch.dcop_cli import main

    assert not torch.cuda.is_available()
    rc = main(["capture", "diff", bundles["base"], bundles["fresh"]])
    assert rc == 1
    assert capsys.readouterr().out == _run_diff(
        jax_capture, [bundles["base"], bundles["fresh"]])[1]


def test_budget_error_block_is_skipped_and_site_flags_are_jaxs(bundles):
    # the port's manifest carries an error budget block (no static
    # census): no flag; JAX's site census on both sides: JAX's flags
    for name in ("base", "fresh"):
        mpath = os.path.join(bundles[name], "manifest.json")
        with open(mpath) as fh:
            manifest = json.load(fh)
        manifest["budget"] = capture._budget_block()
        with open(mpath, "w") as fh:
            json.dump(manifest, fh)
    side = perfdiff.load_side(bundles["base"])
    assert perfdiff.diff_sides(side, side)["flags"] == []
    for name, sites in (("base", 1), ("fresh", 2)):
        mpath = os.path.join(bundles[name], "manifest.json")
        with open(mpath) as fh:
            manifest = json.load(fh)
        manifest["budget"] = {"census": {"solve.run_cycles": {
            "region": "base.py:run_cycles", "dispatch_sites": sites,
            "readback_sites": 1,
        }}, "problems": []}
        with open(mpath, "w") as fh:
            json.dump(manifest, fh)
    a, b = bundles["base"], bundles["fresh"]
    got = perfdiff.diff_sides(perfdiff.load_side(a), perfdiff.load_side(b))
    want = jax_perfdiff.diff_sides(jax_perfdiff.load_side(a),
                                   jax_perfdiff.load_side(b))
    assert got["flags"] == want["flags"]
    assert "budget: solve.run_cycles.dispatch_sites 1 -> 2" in got["flags"]
