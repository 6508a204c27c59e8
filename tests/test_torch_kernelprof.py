"""The port's per-op kernel blocks against the JAX package's, on the CPU.

Bars: on the same problem, ``ell_kernel_block`` has JAX's keys (its
``pallas`` sub-block replaced by the ``ell_minplus`` one) and JAX's
analytic bytes per op and per cycle, the fused gather charged no time;
``mgm2_phase_block`` has JAX's keys and phases and lands each phase in
``device.chunk_ms``; a block the ELL layout cannot represent degrades to
JAX's ``skipped`` block and is counted; the HBM peak is None off the
card.
"""

import numpy as np
import pytest

import pydcop_tpu.telemetry as jax_tel
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_coloring,
)
from pydcop_tpu.commands.generators.ising import (
    generate_ising_arrays as jax_ising,
)
from pydcop_tpu.telemetry.kernelprof import (
    ell_kernel_block as jax_ell_kernel_block,
)
from pydcop_tpu.telemetry.kernelprof import (
    mgm2_phase_block as jax_mgm2_phase_block,
)
from pydcop_tpu_torch import telemetry as tel
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_coloring_arrays,
)
from pydcop_tpu_torch.commands.generators.ising import generate_ising_arrays
from pydcop_tpu_torch.telemetry.kernelprof import (
    ell_kernel_block,
    hbm_peak_gbps,
    mgm2_phase_block,
)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    tel.telemetry_off()
    jax_tel.telemetry_off()
    yield
    tel.telemetry_off()
    jax_tel.telemetry_off()


def _keys(block):
    return {k: set(v) if isinstance(v, dict) else None
            for k, v in block.items()}


@pytest.mark.parametrize("gen", [
    dict(n=200, graph="random", p_edge=0.03, seed=3),
    dict(n=300, graph="scalefree", m_edge=2, seed=7),
])
def test_ell_block_is_jaxs(gen):
    n = gen.pop("n")
    port = ell_kernel_block(generate_coloring_arrays(n, 3, **gen), reps=3,
                            device="cpu")
    jax = jax_ell_kernel_block(jax_coloring(n, 3, **gen), reps=3,
                               time_pallas=False)
    # the device-specific keys: the port's kernel sub-block
    assert set(port) - set(jax) == {"ell_minplus"}
    assert set(jax) - set(port) == set()
    assert set(port["ops"]) == set(jax["ops"])
    for name in ("pair_gather", "minplus", "variable_step"):
        extra = set(port["ops"][name]) - set(jax["ops"][name])
        assert extra == {"pair_gather": {"fused_into", "plain_gather_ms"},
                         "minplus": {"fused"},
                         "variable_step": set()}[name]
        assert port["ops"][name]["bytes"] == jax["ops"][name]["bytes"]
    for key in ("d", "n_pad", "traffic_bytes_per_cycle", "layout",
                "device", "peak_gbps"):
        assert port[key] == jax[key], key
    # the gather is inside the one ell_minplus launch: no time of its own
    assert port["ops"]["pair_gather"]["ms"] == 0.0
    assert port["ops"]["pair_gather"]["fused_into"] == "minplus"
    assert port["ops"]["minplus"]["ms"] > 0
    assert port["attributed_pct"] > 0
    # the CPU runs the plain version: no kernel time
    assert port["ell_minplus"]["kernel"] is False
    assert port["ell_minplus"]["kernel_ms"] is None
    assert port["ell_minplus"]["plain_ms"] > 0
    # the port's packed read-back: [final | best | 4 status words] int32
    assert port["ops"]["readback"]["bytes"] == 4 * (2 * n + 4)


def test_mgm2_phase_block_is_jaxs():
    port = mgm2_phase_block(generate_ising_arrays(6, 6, seed=3), reps=2,
                            device="cpu")
    jax = jax_mgm2_phase_block(jax_ising(6, 6, seed=3), reps=2)
    assert _keys(port) == _keys(jax)
    assert list(port["phases"]) == list(jax["phases"]) == [
        "value", "offer", "response", "gain", "go"]
    for ph in port["phases"].values():
        assert set(ph) == {"ms", "share_pct"} and ph["ms"] > 0


def test_mgm2_phases_land_in_chunk_ms():
    tel.metrics_registry.enabled = True
    mgm2_phase_block(generate_ising_arrays(5, 5, seed=1), reps=2,
                     device="cpu")
    hist = tel.metrics_registry.get("device.chunk_ms")
    phases = {dict(e["labels"])["phase"]
              for e in hist.snapshot()["values"]
              if dict(e["labels"]).get("kind") == "phase"}
    assert phases == {f"mgm2.{p}" for p in
                      ("value", "offer", "response", "gain", "go")}


class _NoEdges:
    n_edges = 0
    buckets = ()


class _Ternary:
    n_edges = 3

    class _B:
        arity = 3

    buckets = (_B(),)


@pytest.mark.parametrize("problem, reason", [
    (_NoEdges(), "no edges"), (_Ternary(), "non-binary constraints"),
])
def test_degraded_block_is_counted_as_jax(problem, reason):
    tel.metrics_registry.enabled = True
    jax_tel.metrics_registry.enabled = True
    got = ell_kernel_block(problem, device="cpu")
    want = jax_ell_kernel_block(problem)
    assert got == want == {"layout": "ell", "skipped": reason}
    for reg in (tel.metrics_registry, jax_tel.metrics_registry):
        assert reg.get("kernelprof.degraded").value(reason=reason) == 1.0


def test_hbm_peak_is_none_off_the_card():
    assert hbm_peak_gbps() is None
    assert hbm_peak_gbps("cpu") is None
    assert np.isclose(dict(tel.kernelprof.HBM_PEAK_GBPS)["h100 80gb hbm3"],
                      3350.0)
