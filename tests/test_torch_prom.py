"""The port's Prometheus text and live metrics surface against the JAX
package's, on the CPU.

Bars: ``render_prometheus`` (classic text 0.0.4 and OpenMetrics with
exemplars) gives the JAX package's bytes on seeded random registry
snapshots, label values with quotes, backslashes and newlines among
them; ``parse_prometheus_text`` reads either text back to the
snapshot's values; ``MetricsHttpServer`` serves the same ``/metrics``,
``/metrics.json`` and ``/status`` bodies as the JAX package's on the
same snapshot, mounts routes by longest prefix, answers a broken
callback with 500 and keeps serving.
"""

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from pydcop_tpu.infrastructure.ui import MetricsHttpServer as JaxSurface
from pydcop_tpu.telemetry import prom as jax_prom
from pydcop_tpu_torch.infrastructure import MetricsHttpServer
from pydcop_tpu_torch.telemetry import prom
from pydcop_tpu_torch.telemetry.metrics import MetricsRegistry

LABEL_VALUES = ("a", "b c", 'q"uote', "back\\slash", "new\nline", "",
                "x=y,z", "ü")


def random_snapshot(seed: int):
    """A registry snapshot of seeded counters, gauges and histograms
    (with exemplars), filled through the port's registry."""
    rng = np.random.default_rng(seed)
    reg = MetricsRegistry(enabled=True)
    names = ["serve.solves", "solve.best_cost", "serve.phase_seconds",
             "comms.messages_sent", "compile.flops_total", "9lead.digit",
             "mem.bytes-in-use", "slo.events"]
    for i, name in enumerate(names):
        kind = ("counter", "gauge", "histogram")[int(rng.integers(3))]
        help_text = ["", "a help\ntext", f"help {i} with \\ and \""][
            int(rng.integers(3))]
        if kind == "counter":
            m = reg.counter(name, help_text)
        elif kind == "gauge":
            m = reg.gauge(name, help_text)
        else:
            m = reg.histogram(name, help_text, buckets=sorted(
                set(np.round(rng.uniform(0.0, 5.0, 4), 3).tolist())))
        for _ in range(int(rng.integers(1, 6))):
            labels = {}
            for key in ("phase", "bucket", "worker")[:int(rng.integers(3))]:
                labels[key] = LABEL_VALUES[int(rng.integers(
                    len(LABEL_VALUES)))]
            value = float(rng.choice([0.0, 1.0, 2.5, 1e16, -3.0,
                                      float(rng.normal()), math.inf]))
            if kind == "counter":
                m.inc(abs(value) if math.isfinite(value) else 1.0,
                      **labels)
            elif kind == "gauge":
                m.set(value, **labels)
            else:
                trace = (f"{int(rng.integers(1 << 62)):016x}"
                         if rng.random() < 0.7 else None)
                m.observe(abs(float(rng.normal())) * 3, exemplar_=trace,
                          **labels)
    return reg.snapshot()


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_render_is_jaxs_byte_for_byte(seed, openmetrics):
    snap = random_snapshot(seed)
    got = prom.render_prometheus(snap, openmetrics=openmetrics)
    assert got == jax_prom.render_prometheus(snap, openmetrics=openmetrics)
    assert got.endswith("# EOF\n") == openmetrics
    assert ("trace_id" in got) == (openmetrics and "exemplars" in
                                   json.dumps(snap))


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_parse_round_trips(seed, openmetrics):
    snap = random_snapshot(seed)
    text = prom.render_prometheus(snap, openmetrics=openmetrics)
    parsed = prom.parse_prometheus_text(text)
    assert parsed == jax_prom.parse_prometheus_text(text)
    assert parsed["eof"] == openmetrics
    samples = {(s["name"], tuple(sorted(s["labels"].items()))): s
               for s in parsed["samples"]}
    exemplars = 0
    for raw, metric in snap["metrics"].items():
        name = prom._name(raw)
        for entry in metric["values"]:
            labels = tuple(sorted(entry["labels"].items()))
            if metric["kind"] == "histogram":
                v = entry["value"]
                count = samples[(name + "_count", labels)]
                assert count["value"] == v["count"]
                assert samples[(name + "_sum", labels)]["value"] == \
                    pytest.approx(v["sum"], rel=1e-12)
                exemplars += len(v.get("exemplars", {}))
                continue
            if metric["kind"] == "counter" and not name.endswith("_total"):
                name_s = name + "_total"
            else:
                name_s = name
            want = entry["value"]
            assert samples[(name_s, labels)]["value"] == (
                want if math.isinf(want) else pytest.approx(want, rel=1e-12))
    seen = [s["exemplar"] for s in parsed["samples"] if s["exemplar"]]
    assert len(seen) == (exemplars if openmetrics else 0)
    for ex in seen:
        assert set(ex["labels"]) == {"trace_id"} and "ts" in ex


def test_content_types_are_jaxs():
    assert prom.PROMETHEUS_CONTENT_TYPE == jax_prom.PROMETHEUS_CONTENT_TYPE
    assert prom.OPENMETRICS_CONTENT_TYPE == jax_prom.OPENMETRICS_CONTENT_TYPE


def _get(base, path, headers=None):
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_surface_serves_jaxs_bodies():
    snap = random_snapshot(11)
    status = {"status": "serve", "state": "serving", "n": 3}
    surfaces = [cls(port=0, status_cb=lambda: status,
                    snapshot_cb=lambda: snap)
                for cls in (MetricsHttpServer, JaxSurface)]
    try:
        bases = [f"http://127.0.0.1:{s.port}" for s in surfaces]
        for path, headers in (
            ("/metrics", None), ("/metrics?format=openmetrics", None),
            ("/metrics", {"Accept": "application/openmetrics-text"}),
            ("/metrics.json", None), ("/status", None), ("/", None),
        ):
            got, want = (_get(b, path, headers) for b in bases)
            assert got == want, path
            assert got[0] == 200
        assert json.loads(_get(bases[0], "/metrics.json")[2]) == snap
    finally:
        for s in surfaces:
            s.shutdown()


def test_surface_routes_by_longest_prefix_and_survives_errors():
    calls = []

    def route(tag):
        def cb(path, body):
            calls.append((tag, path, body))
            return 201, {"tag": tag, "path": path}
        return cb

    def broken(path, body):
        raise RuntimeError("boom")

    surface = MetricsHttpServer(port=0, routes={
        ("GET", "/a"): route("a"),
        ("GET", "/a/b"): route("ab"),
        ("POST", "/a"): lambda p, b: (202, {"len": len(b)},
                                      {"Retry-After": "7"}),
        ("GET", "/broken"): broken,
        # a built-in GET route comes first
        ("GET", "/metrics"): route("never"),
    }, status_cb=lambda: 1 / 0)
    base = f"http://127.0.0.1:{surface.port}"
    try:
        assert _get(base, "/a/x")[0] == 201
        assert json.loads(_get(base, "/a/b/c")[2])["tag"] == "ab"
        assert json.loads(_get(base, "/a/bc")[2])["tag"] == "a"
        req = urllib.request.Request(base + "/a", data=b"12345",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 202
            assert resp.headers["Retry-After"] == "7"
            assert json.loads(resp.read()) == {"len": 5}
        code, _, body = _get(base, "/broken")
        assert code == 500 and json.loads(body) == {"error": "boom"}
        assert _get(base, "/status")[0] == 500  # a broken status callback
        code, _, body = _get(base, "/nowhere")
        assert code == 404 and "no route" in json.loads(body)["error"]
        # still serving after the errors
        code, ctype, _ = _get(base, "/metrics")
        assert code == 200 and ctype == prom.PROMETHEUS_CONTENT_TYPE
        assert [c[0] for c in calls] == ["a", "ab", "a"]
    finally:
        surface.shutdown()
        surface.shutdown()  # a second close returns
