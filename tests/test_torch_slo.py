"""The port's SLO engine (``pydcop_tpu_torch.telemetry.slo``) against the
JAX package's, on the CPU.

Bars: ``parse_objective`` gives equal objectives, or the same exception
type and message, on every spec of the JAX package's SLO tests and more;
``load_slo_file`` reads a file to equal objectives and options; two
engines, one of each package, driven by the same injected clock and the
same seeded stream of ``record_request`` calls give equal ``report()``,
``status_block()``, ``bench_block()``, transitions, ``slo.*`` metrics and
postmortem documents (the postmortem's wall ``time`` aside).
"""

import dataclasses
import json

import numpy as np
import pytest

from pydcop_tpu.telemetry import slo as jax_slo
from pydcop_tpu.telemetry.metrics import metrics_registry as jax_registry
from pydcop_tpu.telemetry.pulse import pulse as jax_pulse
from pydcop_tpu_torch.telemetry import slo
from pydcop_tpu_torch.telemetry.metrics import metrics_registry
from pydcop_tpu_torch.telemetry.pulse import pulse

SPECS = [
    # JAX's test_slo.py
    "p99<250ms", "p95<=2s@30m", "lat=p99<500ms@2h", "availability>=99.9%",
    "availability>=0.95", "dead_letter_rate<=0.5%", "p99<100ms",
    "availability>=99%", "dead_letter_rate<=1%", "p99<1s", "p99<2s",
    # the bad ones
    "p99", "latency<1s", "p99<", "availability>=150%", "p0<1s", "p100<1s",
    "p99<1s@", "nonsense",
    # more
    "p50<30s", "p99.9<10ms@90s", "avail=availability>=0.999@1h",
    " p90 < 1.5s ", "dead_letter_rate<=0.0%", "availability>=100%",
    "p99<0ms", "x=", "=p99<1s", "P99<1S", "p99<1m", "p99<1h",
]


def _outcome(module, spec):
    try:
        return ("ok", dataclasses.asdict(module.parse_objective(spec)))
    except Exception as e:  # noqa: BLE001 (the outcome is compared)
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_objective_is_jaxs(spec):
    got = _outcome(slo, spec)
    assert got == _outcome(jax_slo, spec)
    if got[0] == "ok":
        o = slo.parse_objective(spec)
        assert o.describe() == jax_slo.parse_objective(spec).describe()
        assert o.windows() == jax_slo.parse_objective(spec).windows()


@pytest.mark.parametrize("text", [
    "objectives:\n  - p99<250ms\n  - name: avail\n    kind: availability\n"
    "    target: 0.999\n    window_s: 600\nfast_burn: 10\n"
    "eval_interval_s: 0.5\n",
    "objectives:\n  - kind: latency\n    target: 0.9\n    threshold_s: 2\n"
    "slow_burn: 3\n",
    "- just\n- a list\n",
    "objectives:\n  - 7\n",
])
def test_load_slo_file_is_jaxs(text, tmp_path):
    path = tmp_path / "slo.yaml"
    path.write_text(text)

    def load(module):
        try:
            objectives, options = module.load_slo_file(str(path))
        except Exception as e:  # noqa: BLE001 (the outcome is compared)
            return type(e).__name__, str(e)
        return [dataclasses.asdict(o) for o in objectives], options

    assert load(slo) == load(jax_slo)


@pytest.fixture
def registries():
    for reg in (metrics_registry, jax_registry):
        reg.reset()
        reg.enabled = True
    for p in (pulse, jax_pulse):
        p.reset()
    yield
    for reg in (metrics_registry, jax_registry):
        reg.enabled = False
        reg.reset()


def _slo_metrics(reg):
    snap = reg.snapshot()["metrics"]
    return {k: v for k, v in snap.items() if k.startswith("slo.")}


STATUSES = ("done", "done", "done", "failed", "killed")


@pytest.mark.parametrize("seed, specs", [
    (0, ("p99<100ms", "availability>=99%")),
    (1, ("lat=p90<50ms@600s", "dead_letter_rate<=5%", "availability>=0.9")),
    (2, ("p50<30s", "availability>=99%@120s")),
])
def test_engines_driven_alike_report_alike(seed, specs, registries,
                                           tmp_path):
    rng = np.random.default_rng(seed)
    t = [0.0]
    engines = [
        module.SloEngine(
            [module.parse_objective(s) for s in specs],
            clock=lambda: t[0], eval_interval_s=0.5,
            postmortem_path=str(tmp_path / f"{name}.json"),
        )
        for name, module in (("port", slo), ("jax", jax_slo))
    ]
    bad_rate = [0.02, 0.6, 0.0, 0.3]
    for step in range(160):
        # phases of healthy and bad traffic: alerts fire and resolve
        rate = bad_rate[(step // 40) % len(bad_rate)]
        for _ in range(int(rng.integers(0, 4))):
            status = (STATUSES[int(rng.integers(3, 5))]
                      if rng.random() < rate else "done")
            latency = float(rng.exponential(0.04 if rate < 0.1 else 0.3))
            phases = {k: float(rng.uniform(0, latency))
                      for k in ("queue", "assemble", "dispatch", "solve",
                                "readback")}
            tenant = f"t{int(rng.integers(1 << 20))}"
            trace = f"{int(rng.integers(1 << 62)):016x}"
            for eng in engines:
                eng.record_request(tenant, status, latency,
                                   dead_letter=status != "done",
                                   trace=trace, phases=phases)
        t[0] += float(rng.uniform(0.5, 20.0))
        for eng in engines:
            eng.evaluate()
        if step % 37 == 0:
            port, jax = engines
            assert port.status_block() == jax.status_block()
    port, jax = engines
    assert port.transitions == jax.transitions
    assert port.transitions  # some alert fired
    assert port.report() == jax.report()
    assert port.status_block() == jax.status_block()
    assert port.bench_block() == jax.bench_block()
    assert port.alerts_active() == jax.alerts_active()
    assert _slo_metrics(metrics_registry) == _slo_metrics(jax_registry)
    docs = []
    for eng in engines:
        with open(eng.postmortem_path) as f:
            doc = json.load(f)
        doc.pop("time")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["reason"].startswith("slo-alert:")


def test_background_evaluator_stops_with_a_final_tick(registries,
                                                      tmp_path):
    eng = slo.SloEngine([slo.parse_objective("availability>=99%")],
                        eval_interval_s=0.05,
                        postmortem_path=str(tmp_path / "pm.json"))
    eng.start()
    eng.start()  # idempotent
    for i in range(10):
        eng.record_request(f"t{i}", "killed", 0.01, dead_letter=True)
    eng.stop(final_tick=True)
    assert ("availability", "fast") in eng.alerts_active()
    assert (tmp_path / "pm.json").is_file()
    assert eng.report()["objectives"][0]["bad"] == 10
