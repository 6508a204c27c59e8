"""The port's fleet federation against the JAX package's, on the CPU.

Both packages' ``FleetCollector`` and ``FleetSlo`` scrape the same
scripted fake workers through an injected fetch, with explicit clocks.
The script (made from a numpy seed) holds counters, histograms and
gauges rising over fourteen sweeps, a counter reset on one worker in
the middle of the run (a restart), one dropped scrape on another that
the in-sweep retry recovers, a third worker that dies and whose series
age past ``stale_after_s``, and a burst of bad ``slo.events`` that trips
the fleet's fast-burn alert.  Bars: ``snapshot()`` (but its wall
``time``), ``status()``, ``counter_sum()``, ``status_block()``,
``metrics_block()`` and the annotated transitions are equal document for
document after every sweep; the three target sources read the same
files alike; ``RetryPolicy`` draws the same jitter from the same seed.
"""

import json

import numpy as np
import pytest

from pydcop_tpu.infrastructure.retry import RetryPolicy as JaxRetryPolicy
from pydcop_tpu.telemetry import federate as jax_federate
from pydcop_tpu.telemetry.slo import parse_objective as jax_parse_objective
from pydcop_tpu_torch.infrastructure.retry import RetryPolicy
from pydcop_tpu_torch.telemetry import federate
from pydcop_tpu_torch.telemetry.slo import parse_objective

WORKERS = ("w0", "w1", "w2")
STEPS = 14
DT = 2.0
T0 = 1000.0
RESET_STEP = 4  # w1 restarts: its counters start again from 0
DROP_STEP = 5  # w0's first fetch of the sweep fails, the retry recovers
DEAD_FROM = 6  # w2 answers nothing from here on
BURST = (7, 8, 9)  # w0 reports many bad availability events
OBJECTIVES = ("availability>=99%@300s", "lat=p99<250ms@300s")
DIAGNOSES = ("healthy", "oscillating", "stalled", "frozen")


@pytest.fixture(autouse=True)
def _state_dir(tmp_path, monkeypatch):
    # an alert's postmortem goes to the state directory: keep it here
    monkeypatch.setenv("PYDCOP_TPU_STATE_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)


def _script(seed=0):
    """{step: {worker: (metrics doc, status doc)}}: cumulative counters
    from seeded increments, w1's started again at RESET_STEP."""
    rng = np.random.default_rng(seed)
    out = {}
    cum = {w: {} for w in WORKERS}
    for step in range(STEPS):
        out[step] = {}
        for w in WORKERS:
            if w == "w1" and step == RESET_STEP:
                cum[w] = {}
            c = cum[w]

            def bump(key, lo, hi):
                c[key] = c.get(key, 0.0) + float(rng.integers(lo, hi))
                return c[key]

            solves = bump("solves", 1, 6)
            events = []
            for obj in ("availability", "lat"):
                good = bump(f"{obj}/good", 5, 20)
                bad_hi = 40 if (w == "w0" and step in BURST
                                and obj == "availability") else 2
                bad = bump(f"{obj}/bad", 0, bad_hi)
                events += [
                    {"labels": {"objective": obj, "outcome": "good"},
                     "value": good},
                    {"labels": {"objective": obj, "outcome": "bad"},
                     "value": bad},
                ]
            buckets = [bump(f"h{i}", 0, 4) for i in range(3)]
            hist = {"buckets": list(np.cumsum(buckets)),
                    "sum": bump("hsum", 1, 9) / 7.0,
                    "count": float(np.sum(buckets))}
            metrics = {
                "serve.solves": {"kind": "counter", "help": "solves",
                                 "values": [{"labels": {}, "value": solves}]},
                "slo.events": {"kind": "counter", "help": "slo events",
                               "values": events},
                "serve.request_seconds": {
                    "kind": "histogram", "help": "request seconds",
                    "bucket_bounds": [0.1, 1.0, 10.0],
                    "values": [{"labels": {"bucket": "b0"}, "value": hist}]},
                "serve.batch_occupancy_pct": {
                    "kind": "gauge", "help": "occupancy",
                    "values": [{"labels": {},
                                "value": float(rng.uniform(10, 100))}]},
                "mem.bytes_in_use": {
                    "kind": "gauge", "help": "bytes",
                    "values": [{"labels": {},
                                "value": float(rng.integers(1, 1 << 30))}]},
                "serve.note": {"kind": "untyped", "help": "",
                               "values": [{"labels": {"k": w},
                                           "value": step}]},
            }
            burn = float(rng.uniform(0, 20))
            status = {
                "status": "serve", "state": "serving",
                "queue_depth": int(rng.integers(0, 5)),
                "queue_depth_watermark": int(rng.integers(5, 9)),
                "solves": int(solves), "batches": int(step + 1),
                "dead_letters": int(rng.integers(0, 2)),
                "tenants": {
                    f"t{i}": {"pulse": {"diagnosis": DIAGNOSES[
                        int(rng.integers(len(DIAGNOSES)))]}}
                    for i in range(3)},
                "slo": {"objectives": {"availability": {
                    "burn_fast": burn,
                    "alert": "fast" if burn > 14.4 else None}}},
            }
            if step % 3 == 0:
                status["memory"] = {"bytes_in_use": int(rng.integers(1e6)),
                                    "headroom_pct": float(rng.uniform(0, 99)),
                                    "refusals_total": int(step)}
            out[step][w] = (metrics, status)
    return out


class FakeFleet:
    """The scripted endpoints: ``fetch(url)`` answers the current step's
    documents, None for a dead worker and once for the dropped scrape."""

    def __init__(self, script):
        self.script = script
        self.step = 0
        self.dropped = set()
        self.calls = []

    def fetch(self, url):
        self.calls.append(url)
        name = url.split("//", 1)[1].split("/", 1)[0]
        if name == "w2" and self.step >= DEAD_FROM:
            return None
        if (name == "w0" and self.step == DROP_STEP
                and self.step not in self.dropped):
            self.dropped.add(self.step)
            return None
        metrics, status = self.script[self.step][name]
        doc = metrics if url.endswith("/metrics.json") else status
        if url.endswith("/metrics.json"):
            return {"time": 0.0, "metrics": json.loads(json.dumps(doc))}
        return json.loads(json.dumps(doc))


def _plane(mod, retry_cls, parse, fleet):
    targets = [mod.FleetTarget(w, f"http://{w}") for w in WORKERS]
    collector = mod.FleetCollector(
        targets, interval_s=DT, stale_after_s=10.0,
        clock=lambda: T0, fetch=fleet.fetch,
        scrape_retry=retry_cls(max_attempts=2, base_delay=0.0,
                               max_delay=0.0, jitter="none"),
    )
    slo = mod.FleetSlo(collector, [parse(s) for s in OBJECTIVES],
                       clock=lambda: T0)
    return collector, slo


def _documents(collector, slo, now):
    snap = collector.snapshot(now=now)
    snap.pop("time")
    snap["metrics"].update(slo.metrics_block())
    return {
        "snapshot": snap,
        "status": collector.status(now=now),
        "slo": slo.status_block(),
        "transitions": slo.transitions,
        "sums": [collector.counter_sum("slo.events", worker=w,
                                       objective=o, outcome=k)
                 for w in (None, *WORKERS)
                 for o in ("availability", "lat")
                 for k in ("good", "bad")],
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collector_and_fleet_slo_are_jaxs(seed):
    script = _script(seed)
    fleet, jax_fleet = FakeFleet(script), FakeFleet(script)
    collector, slo = _plane(federate, RetryPolicy, parse_objective, fleet)
    jax_collector, jax_slo = _plane(jax_federate, JaxRetryPolicy,
                                    jax_parse_objective, jax_fleet)
    seen = []
    for step in range(STEPS):
        now = T0 + DT * step
        for f, c, s in ((fleet, collector, slo),
                        (jax_fleet, jax_collector, jax_slo)):
            f.step = step
            c.poll(now=now)
            s.evaluate(now=now)
        got = _documents(collector, slo, now)
        want = _documents(jax_collector, jax_slo, now)
        assert got == want, f"step {step}"
        assert fleet.calls == jax_fleet.calls
        seen.append(got)

    # the script did what it says: a reset folded into a monotone total,
    # the dropped scrape retried without a down, the dead worker's series
    # dropped once stale, and the burst fired the fleet's fast alert
    last = seen[-1]
    rows = last["status"]["workers"]
    assert rows["w1"]["resets"] >= 1 and rows["w0"]["retries"] == 1
    assert rows["w0"]["up"] and rows["w0"]["failures"] == 0
    assert not rows["w2"]["up"] and rows["w2"]["stale"]
    solves = [
        {v["labels"]["worker"]: v["value"] for v in
         doc["snapshot"]["metrics"]["fleet.worker_solves_total"]["values"]}
        for doc in seen]
    assert all(a["w1"] <= b["w1"] for a, b in zip(solves, solves[1:]))
    assert not any(v["labels"].get("worker") == "w2" for v in
                   last["snapshot"]["metrics"]["serve.solves"]["values"])
    assert any(t["state"] == "firing" and t["severity"] == "fast"
               and t["worst_worker"] == "w0" for t in last["transitions"])


def test_clamped_rate_lives_in_federate_and_is_jaxs():
    from pydcop_tpu_torch.commands import watch

    assert watch.clamped_rate is federate.clamped_rate
    for prev, cur, dt in ((0, 10, 2.0), (10, 4, 1.0), (3, 3, 0.0),
                          (1, 5, -1.0), (2.5, 7.25, 0.5)):
        assert federate.clamped_rate(prev, cur, dt) == \
            jax_federate.clamped_rate(prev, cur, dt)


def test_target_sources_are_jaxs(tmp_path):
    specs = ["http://127.0.0.1:9010", "w1=127.0.0.1:9011/",
             "b=https://h:1/x", "localhost:8080"]
    assert federate.targets_from_args(specs) == [
        tuple(t) for t in jax_federate.targets_from_args(specs)]

    fleet_files = {
        "map.yaml": "workers:\n  w0: http://127.0.0.1:9010\n"
                    "  w1: {url: \"127.0.0.1:9011\"}\n",
        "list.yaml": "workers:\n  - http://a:1\n  - {name: x, url: b:2}\n"
                     "  - {url: http://c:3/}\n",
        "bad.yaml": "nodes: []\n",
        "scalar.yaml": "workers: 3\n",
    }
    for name, text in fleet_files.items():
        path = tmp_path / name
        path.write_text(text)
        outcomes = []
        for mod in (federate, jax_federate):
            try:
                outcomes.append([tuple(t) for t in
                                 mod.targets_from_fleet_file(str(path))])
            except ValueError as e:
                outcomes.append(("ValueError", str(e)))
        assert outcomes[0] == outcomes[1], name

    state = tmp_path / "state"
    docs = {
        "w0": {"kind": "fleet", "endpoint": "http://127.0.0.1:9010",
               "worker": "127.0.0.1:9010"},
        "w1": {"kind": "fleet", "endpoint": "127.0.0.1:9011/"},
        "w2": {"kind": "fleet", "endpoint": None},
    }
    for sub, doc in docs.items():
        (state / sub).mkdir(parents=True)
        (state / sub / "fleet-manifest.json").write_text(json.dumps(doc))
    (state / "junk").mkdir()
    (state / "junk" / "fleet-manifest.json").write_text("{not json")
    for path in (state, state / "w0" / "fleet-manifest.json"):
        assert federate.targets_from_manifest(str(path)) == [
            tuple(t) for t in jax_federate.targets_from_manifest(str(path))]
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (federate, jax_federate):
        with pytest.raises(ValueError, match="no fleet manifest"):
            mod.targets_from_manifest(str(empty))


def test_collector_refuses_what_jaxs_refuses():
    for mod in (federate, jax_federate):
        with pytest.raises(ValueError, match="at least one target"):
            mod.FleetCollector([])
        with pytest.raises(ValueError, match="duplicate"):
            mod.FleetCollector([mod.FleetTarget("a", "http://x"),
                                mod.FleetTarget("a", "http://y")])


@pytest.mark.parametrize("jitter", ["full", "equal", "none"])
def test_retry_policy_draws_jaxs_schedule(jitter):
    ours = RetryPolicy(max_attempts=6, base_delay=0.05, max_delay=0.7,
                       jitter=jitter, seed=11)
    theirs = JaxRetryPolicy(max_attempts=6, base_delay=0.05, max_delay=0.7,
                            jitter=jitter, seed=11)
    assert [ours.backoff(a) for a in range(8)] == [
        theirs.backoff(a) for a in range(8)]
    assert [ours.sleep_duration(a) for a in range(20)] == [
        theirs.sleep_duration(a) for a in range(20)]
    # no attempt left: no sleep, False
    assert not ours.sleep_before_retry(5, ours.start())
    for cls in (RetryPolicy, JaxRetryPolicy):
        with pytest.raises(ValueError, match="max_attempts"):
            cls(max_attempts=0)
        with pytest.raises(ValueError, match="jitter"):
            cls(jitter="sometimes")


def test_http_fetch_of_a_dead_endpoint_is_none():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert federate._http_fetch(f"http://127.0.0.1:{port}/status",
                                timeout=2.0) is None
