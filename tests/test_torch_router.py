"""The port's HA router against the JAX package's, on the CPU.

Both packages' ``Router`` run side by side on the same fake fleet (an
injected fetch for the scrapes and results, an injected post for the
forwards and window pushes) with explicit ``now``; each router has its
own copy of the fleet, driven by the same script.  Bars, compared
document for document: the answers of ``submit``, the placement map and
the sequence of forwards (tenant, worker, seed), sheds and defers by
priority under a tripped fast burn and their release, the ``POST
/window`` widen and narrow sequence, failover (terminal results adopted
from a ``fleet-manifest.json`` that the port's own ``ServeServer``
wrote, the rest solved again from scratch with the original seed, none
solved twice), deadline expiry, and ``status()`` and ``result()``.
Placement takes the ``tpu_part`` path: no fallback is logged.
"""

import json
import logging
import shutil

import pytest

from pydcop_tpu.infrastructure.retry import RetryPolicy as JaxRetryPolicy
from pydcop_tpu.serve import router as jax_router_mod
from pydcop_tpu.telemetry import federate as jax_federate
from pydcop_tpu.telemetry.metrics import metrics_registry as jax_registry
from pydcop_tpu.telemetry.slo import parse_objective as jax_parse_objective
from pydcop_tpu_torch.infrastructure.retry import RetryPolicy
from pydcop_tpu_torch.serve import router as router_mod
from pydcop_tpu_torch.telemetry import federate
from pydcop_tpu_torch.telemetry.metrics import metrics_registry
from pydcop_tpu_torch.telemetry.slo import parse_objective

PORT = (router_mod, federate, RetryPolicy, parse_objective)
JAX = (jax_router_mod, jax_federate, JaxRetryPolicy, jax_parse_objective)


@pytest.fixture(autouse=True)
def _registries(tmp_path, monkeypatch):
    # the router's own SLO engine counts into its package's registry
    monkeypatch.setenv("PYDCOP_TPU_STATE_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    for reg in (metrics_registry, jax_registry):
        reg.reset()
        reg.enabled = True
    yield
    for reg in (metrics_registry, jax_registry):
        reg.enabled = False
        reg.reset()


def _yaml_vars(n):
    rows = "\n".join(f"  v{i}: {{domain: d}}" for i in range(n))
    return f"variables:\n{rows}\nconstraints: {{}}\n"


def _spec(tenant, n_vars, algo="dsa", seed=0, **extra):
    spec = {"dcop_yaml": _yaml_vars(n_vars), "algo": algo, "n_cycles": 10,
            "seed": seed, "tenant": tenant,
            "trace": tenant.encode().hex().rjust(16, "0")[-16:]}
    spec.update(extra)
    return spec


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class FakeFleet:
    """Workers behind URLs: ``fetch`` is their scrape and result surface,
    ``post`` their ``/solve`` and ``/window``; each worker can die for
    scrapes and posts apart, hold its tenants unfinished, or report a
    queue.  ``forwards`` records every accepted ``/solve`` in order."""

    def __init__(self, urls):
        self.urls = dict(urls)  # name -> base URL
        self.by_url = {u: n for n, u in self.urls.items()}
        self.scrape_dead = set()
        self.post_dead = set()
        self.hold = set()
        self.queue = {}
        self.state = {}
        self.tenants = {n: {} for n in self.urls}
        self.forwards = []
        self.windows = []
        self.metrics = {n: {} for n in self.urls}

    def _worker(self, url):
        for base, name in self.by_url.items():
            if url.startswith(base + "/"):
                return name, url[len(base):]
        raise AssertionError(f"unexpected url {url}")

    def fetch(self, url):
        name, path = self._worker(url)
        if name in self.scrape_dead:
            return None
        if path == "/metrics.json":
            return {"time": 0.0,
                    "metrics": json.loads(json.dumps(self.metrics[name]))}
        if path == "/status":
            return {"status": "serve",
                    "state": self.state.get(name, "serving"),
                    "queue_depth": self.queue.get(name, 0),
                    "solves": len(self.tenants[name])}
        if path.startswith("/result/"):
            rec = self.tenants[name].get(path.rsplit("/", 1)[1])
            return dict(rec) if rec is not None else None
        raise AssertionError(f"unexpected fetch {url}")

    def post(self, url, doc):
        name, path = self._worker(url)
        if name in self.post_dead:
            return None
        if path == "/window":
            self.windows.append((name, doc["window_ms"]))
            return 200, {"window_ms": doc["window_ms"]}
        assert path == "/solve", url
        if self.state.get(name, "serving") != "serving":
            return 503, {"error": "draining", "state": self.state[name],
                         "peers": []}
        tid = doc["tenant"]
        self.forwards.append((tid, name, doc.get("seed"), doc["trace"]))
        done = name not in self.hold
        self.tenants[name][tid] = {
            "tenant": tid, "status": "done" if done else "running",
            "cost": 100.0 + float(doc.get("seed", 0)),
            "assignment": {"v0": int(doc.get("seed", 0)) % 3},
            "worker_seen": name,
        }
        return 200, {"tenant": tid, "trace": doc["trace"]}


class Pair:
    """The two routers, each on its own copy of the fleet."""

    def __init__(self, urls, clock=None, **kw):
        self.clock = clock or Clock()
        self.fleets = (FakeFleet(urls), FakeFleet(urls))
        self.routers = []
        for (mod, fed, retry_cls, parse), fleet in zip((PORT, JAX),
                                                       self.fleets):
            opts = dict(kw)
            for key in ("objectives", "router_objectives"):
                if key in opts:
                    opts[key] = [parse(s) for s in opts[key]]
            if "state_dir" in opts:
                opts["state_dir"] = opts["state_dir"][mod is jax_router_mod]
            self.routers.append(mod.Router(
                [fed.FleetTarget(n, u) for n, u in sorted(urls.items())],
                clock=self.clock, fetch=fleet.fetch, post=fleet.post,
                scrape_retry=None,
                retry=retry_cls(max_attempts=2, base_delay=0.001,
                                max_delay=0.002, jitter="none"),
                **opts))

    def each(self, fn):
        """``fn(router, fleet)`` on both, the answers (port, jax)."""
        return tuple(fn(r, f) for r, f in zip(self.routers, self.fleets))

    def same(self, fn):
        got, want = self.each(fn)
        assert got == want
        return got

    def tick(self, dt=1.0):
        now = self.clock.advance(dt)
        self.each(lambda r, f: r.tick(now=now))

    def submit(self, spec):
        now = self.clock()
        return self.same(lambda r, f: r.submit(dict(spec), now=now))

    def fleet_op(self, fn):
        for f in self.fleets:
            fn(f)

    def check_documents(self, tenants=()):
        now = self.clock()
        self.same(lambda r, f: r.status(now=now))
        for tid in tenants:
            self.same(lambda r, f: r.result(tid))
        self.same(lambda r, f: (f.forwards, f.windows))

    def close(self):
        self.each(lambda r, f: r.collector.stop())


def _urls(n):
    return {f"w{i}": f"http://fake{i}:90{i}" for i in range(n)}


def test_affinity_key_is_jaxs():
    specs = [{"algo": "dsa", "dcop_yaml": _yaml_vars(n)} for n in
             (0, 1, 2, 3, 9, 40, 1023, 1024)]
    specs += [{"dcop_yaml": "variables: [1"}, {"algo": "maxsum"},
              {"algo": "mgm", "dcop_yaml": "variables: {a: {domain: d}}\n"
               "constraints: {c1: {}, c2: {}, c3: {}}\n"}]
    for spec in specs:
        assert router_mod.affinity_key(spec) == \
            jax_router_mod.affinity_key(spec)
    assert router_mod.PRIORITIES == jax_router_mod.PRIORITIES
    assert router_mod.MANIFEST_FORMAT == __import__(
        "pydcop_tpu_torch.durability.manager",
        fromlist=["MANIFEST_FORMAT"]).MANIFEST_FORMAT


def test_placement_and_forwards_are_jaxs(caplog):
    pair = Pair(_urls(3))
    pair.tick()
    sizes = [2, 3, 9, 17, 40, 5, 2, 70, 33, 3]
    algos = ["dsa", "maxsum", "mgm"]
    tenants = []
    with caplog.at_level(logging.ERROR):
        for i, n in enumerate(sizes):
            tid = f"t{i}"
            tenants.append(tid)
            code, payload, headers = pair.submit(
                _spec(tid, n, algo=algos[i % 3], seed=i))
            assert code == 200 and headers is None
            if i % 4 == 3:
                pair.tick()
        pair.tick()
        # a second round into a census that no longer changes: each
        # tenant lands on the worker its bucket is placed on
        n_first = len(pair.fleets[0].forwards)
        for i, n in enumerate(sizes):
            tenants.append(f"u{i}")
            pair.submit(_spec(f"u{i}", n, algo=algos[i % 3], seed=50 + i))
        pair.tick()
    assert not [r for r in caplog.records if "falling back" in r.message]
    pair.check_documents(tenants)
    status = pair.routers[0].status(now=pair.clock())
    buckets = status["placement"]["buckets"]
    assert len(set(buckets.values())) == 3
    for tid, worker, _seed, _trace in pair.fleets[0].forwards[n_first:]:
        assert buckets[status["tenants"][tid]["bucket"]] == worker
    assert all(rec["status"] == "done" for rec in status["tenants"].values())
    # a duplicate id and bad requests answer alike
    pair.submit(_spec("t0", 2))
    pair.submit({"dcop_yaml": _yaml_vars(2), "priority": "urgent",
                 "tenant": "p", "trace": "1"})
    pair.submit({"algo": "dsa", "tenant": "q", "trace": "2"})
    pair.check_documents(["t0", "unknown"])
    pair.close()


def test_round_robin_and_draining_workers_are_jaxs():
    pair = Pair(_urls(3), placement="round_robin")
    pair.tick()
    pair.fleet_op(lambda f: f.state.update(w1="draining"))
    pair.tick()
    for i in range(7):
        pair.submit(_spec(f"r{i}", 2 + i, seed=i))
    pair.tick()
    pair.check_documents([f"r{i}" for i in range(7)])
    assert {w for _, w, _, _ in pair.fleets[0].forwards} == {"w0", "w2"}
    pair.close()


def _burning(pair):
    """Trip the router's own availability objective into a fast burn, as
    bad forward outcomes do."""
    pair.tick()
    for r in pair.routers:
        for i in range(20):
            r.engine.record_request(f"warm{i}", "failed", 0.01)
    pair.clock.advance(1.0)
    now = pair.clock()
    pair.each(lambda r, f: r.engine.evaluate(now))
    assert pair.same(lambda r, f: r.admission_mode()) == "shedding"


def test_shed_defer_and_release_under_fast_burn_are_jaxs():
    pair = Pair(_urls(2), router_objectives=["fwd=availability>=99%@300s"],
                defer_max_s=5.0)
    _burning(pair)
    answers = [pair.submit(_spec(f"{p}{i}", 2 + i, seed=i, priority=p))
               for i in range(2) for p in ("low", "normal", "high")]
    codes = [code for code, _, _ in answers]
    assert codes == [503, 202, 200, 503, 202, 200]
    shed = answers[0]
    assert shed[1]["shed"] and shed[1]["peers"] and \
        shed[2]["Retry-After"] == "2"
    pair.check_documents(["low0", "normal0", "high0", "normal1"])
    # good traffic and time: the fast windows drain, admission reopens
    # and the parked tenants go out
    for step in range(8):
        pair.clock.advance(1.0)
        for r in pair.routers:
            for i in range(10):
                r.engine.record_request(f"ok{step}-{i}", "done", 0.01)
        now = pair.clock()
        pair.each(lambda r, f: r.tick(now=now))
        pair.check_documents(["normal0", "normal1"])
    assert pair.same(lambda r, f: r.admission_mode()) == "open"
    status = pair.routers[0].status(now=pair.clock())
    assert status["admission"]["released"] == 2
    assert status["admission"]["shed"] == 2
    assert status["tenants"]["normal1"]["status"] == "done"
    pair.close()


def _slo_events(good, bad):
    return {"slo.events": {"kind": "counter", "help": "", "values": [
        {"labels": {"objective": "availability", "outcome": "good"},
         "value": float(good)},
        {"labels": {"objective": "availability", "outcome": "bad"},
         "value": float(bad)}]}}


def test_a_fleet_slo_alert_gates_admission_as_jaxs():
    # the workers' own slo.events, federated: w1 burns its budget, the
    # fleet's fast alert names it and gates admission until it clears
    pair = Pair(_urls(2), objectives=["availability>=99%@300s"])
    pair.fleet_op(lambda f: f.metrics.update(w0=_slo_events(100, 0),
                                             w1=_slo_events(100, 0)))
    pair.tick()
    pair.fleet_op(lambda f: f.metrics.update(w1=_slo_events(110, 60)))
    pair.tick()
    assert pair.same(lambda r, f: r.admission_mode()) == "shedding"
    codes = [pair.submit(_spec(f"{p}0", 3, priority=p))[0]
             for p in ("low", "normal", "high")]
    assert codes == [503, 202, 200]
    pair.check_documents(["low0", "normal0", "high0"])
    status = pair.routers[0].status(now=pair.clock())
    assert status["admission"]["alerts"] == ["fleet:availability"]
    assert any(t["worst_worker"] == "w1"
               for t in status["slo"]["transitions"])
    for step in range(1, 12):
        pair.fleet_op(lambda f: f.metrics.update(
            w0=_slo_events(100 + 50 * step, 0),
            w1=_slo_events(110 + 50 * step, 60)))
        pair.tick()
        pair.check_documents(["normal0"])
    assert pair.same(lambda r, f: r.admission_mode()) == "open"
    assert pair.routers[0].result("normal0")["status"] == "done"
    pair.close()


def test_defer_is_bounded_by_defer_max_under_sustained_burn():
    pair = Pair(_urls(2), router_objectives=["fwd=availability>=99%@300s"],
                defer_max_s=5.0)
    _burning(pair)
    assert pair.submit(_spec("slow", 3, priority="normal"))[0] == 202
    for _ in range(7):
        pair.clock.advance(1.0)
        for r in pair.routers:
            for i in range(3):
                r.engine.record_request(f"b{pair.clock()}{i}", "failed",
                                        0.01)
        now = pair.clock()
        pair.each(lambda r, f: r.tick(now=now))
        pair.check_documents(["slow"])
    assert pair.routers[0].result("slow")["status"] == "done"
    pair.close()


def test_window_widen_and_narrow_sequence_is_jaxs():
    pair = Pair(_urls(2), window_base_ms=25.0, idle_ticks_to_widen=2,
                window_max_factor=4.0)
    for _ in range(7):
        pair.tick()
    pair.fleet_op(lambda f: f.queue.update(w0=5))
    pair.tick()
    pair.fleet_op(lambda f: f.queue.update(w0=0))
    for _ in range(3):
        pair.tick()
    pair.check_documents()
    windows = pair.fleets[0].windows
    assert [ms for w, ms in windows if w == "w0"] == [50.0, 100.0, 25.0,
                                                      50.0]
    pair.close()


def _manifest_from_a_port_server(directory, tenants):
    """A real ``fleet-manifest.json``: the port's ``ServeServer`` on the
    CPU solves ``tenants`` (id -> seed) and drains.  Returns its
    endpoint URL and the manifest."""
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_coloring_arrays,
    )
    from pydcop_tpu_torch.serve import ServeServer, SolveRequest

    srv = ServeServer(port=0, window_ms=5, device="cpu",
                      checkpoint_dir=str(directory))
    try:
        for tid, seed in tenants.items():
            srv.submit(SolveRequest(
                tid, generate_coloring_arrays(9, 3, graph="grid", seed=1),
                "dsa", {}, 10, seed))
        for tid in tenants:
            assert srv.wait(tid, timeout=120)["status"] == "done"
        endpoint = f"http://127.0.0.1:{srv.http.port}"
    finally:
        srv.shutdown()
    doc = json.loads((directory / "fleet-manifest.json").read_text())
    assert doc["kind"] == "fleet" and doc["endpoint"] == endpoint
    return endpoint, doc


def test_failover_adopts_the_manifest_and_resolves_the_rest(tmp_path):
    # w0's manifest, written by a port server, holds a0 and a1 done
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    endpoint, manifest = _manifest_from_a_port_server(
        ours / "w0", {"a0": 5, "a1": 6})
    shutil.copytree(ours, theirs)
    urls = {"w0": endpoint, "w1": "http://fake1:901"}
    pair = Pair(urls, state_dir=(str(ours), str(theirs)))
    pair.tick()
    pair.fleet_op(lambda f: f.hold.add("w0"))
    # one bucket: every tenant on the worker that owns it
    owner = None
    for i, tid in enumerate(["a0", "a1", "b0", "b1"]):
        code, payload, _ = pair.submit(_spec(tid, 9, seed=5 + i))
        assert code == 200
        owner = owner or payload["worker"]
        assert payload["worker"] == owner == "w0"
    pair.tick()
    pair.check_documents(["a0", "b0"])
    # w0 dies: its scrapes and forwards fail
    pair.fleet_op(lambda f: (f.scrape_dead.add("w0"),
                             f.post_dead.add("w0")))
    pair.tick()
    pair.tick()
    pair.check_documents(["a0", "a1", "b0", "b1"])
    r, fleet = pair.routers[0], pair.fleets[0]
    status = r.status(now=pair.clock())
    assert status["admission"]["failovers"] == 1
    assert status["admission"]["adopted"] == 2
    assert status["admission"]["from_scratch"] == 2
    events = [e["event"] for e in status["events"]]
    assert events.count("failover") == 1
    for tid in ("a0", "a1"):
        rec = r.result(tid)
        row = manifest["tenants"][tid]
        assert rec["result_source"] == "manifest" and rec["owner"] == "w0"
        assert (rec["status"], rec["cost"], rec["assignment"]) == (
            row["status"], row["cost"], row["assignment"])
    # the rest solved again on the survivor with their own seeds, each
    # tenant forwarded once a worker: none solved twice
    seeds = {"b0": 7, "b1": 8}
    resolved = [(t, w, s) for t, w, s, _ in fleet.forwards if w == "w1"]
    assert resolved == [("b0", "w1", 7), ("b1", "w1", 8)]
    for tid in seeds:
        rec = r.result(tid)
        assert rec["status"] == "done" and rec["cost"] == 100.0 + seeds[tid]
        assert [h["event"] for h in rec["history"]] == [
            "forward", "resolve-from-scratch", "forward", "complete"]
    for f in pair.fleets:
        assert [t for t, _, _, _ in f.forwards] == ["a0", "a1", "b0", "b1",
                                                    "b0", "b1"]
    # both routers wrote their ownership manifests alike
    docs = [json.loads((d / "router-manifest.json").read_text())
            for d in (ours, theirs)]
    for doc in docs:
        doc.pop("wrote_unix_s")
    assert docs[0] == docs[1] and docs[0]["kind"] == "router"
    pair.close()


def test_failed_forward_fails_the_worker_over_before_its_scrape_does():
    pair = Pair(_urls(2))
    pair.tick()
    pair.fleet_op(lambda f: f.hold.update({"w0", "w1"}))
    answers = [pair.submit(_spec(f"s{i}", 2, seed=i)) for i in range(2)]
    owner = answers[0][1]["worker"]
    # the owner still scrapes as up but refuses every forward
    pair.fleet_op(lambda f: f.post_dead.add(owner))
    pair.submit(_spec("s2", 2, seed=2))
    pair.tick()
    pair.check_documents(["s0", "s1", "s2"])
    status = pair.routers[0].status(now=pair.clock())
    assert status["admission"]["failovers"] == 1
    assert any(e["event"] == "worker-suspect" and e["reason"]
               == "failed-forward" for e in status["events"])
    pair.close()


def test_deadline_expiry_is_jaxs():
    pair = Pair(_urls(1), tenant_deadline_s=10.0)
    pair.fleet_op(lambda f: (f.scrape_dead.add("w0"),
                             f.post_dead.add("w0")))
    pair.tick()
    code, payload, _ = pair.submit(_spec("doomed", 2))
    assert code == 202 and payload["reason"] == "no-worker"
    pair.tick(11.0)
    pair.check_documents(["doomed"])
    rec = pair.routers[0].result("doomed")
    assert rec["status"] == "failed" and rec["error"] == "deadline exceeded"
    pair.close()


def test_drain_answers_a_structured_503_and_writes_the_manifest(tmp_path):
    ours, theirs = tmp_path / "o", tmp_path / "t"
    pair = Pair(_urls(2), state_dir=(str(ours), str(theirs)))
    pair.tick()
    pair.submit(_spec("d0", 2))
    pair.each(lambda r, f: r.drain(timeout=5.0))
    code, payload, headers = pair.submit(_spec("late", 2))
    assert code == 503 and payload["state"] == "drained"
    assert headers == {"Retry-After": "8"}
    docs = [json.loads((d / "router-manifest.json").read_text())
            for d in (ours, theirs)]
    for doc in docs:
        doc.pop("wrote_unix_s")
    assert docs[0] == docs[1]
    assert docs[0]["state"] == "drained"
    pair.close()


def test_http_routes_answer_what_jaxs_answer():
    import urllib.error
    import urllib.request

    urls = _urls(2)
    fleets = (FakeFleet(urls), FakeFleet(urls))
    routers = [
        mod.Router([fed.FleetTarget(n, u) for n, u in sorted(urls.items())],
                   port=0, fetch=f.fetch, post=f.post, scrape_retry=None)
        for (mod, fed, _, _), f in zip((PORT, JAX), fleets)]

    def call(router, path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.http.port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        for r in routers:
            r.tick()
        answers = []
        for r in routers:
            answers.append([
                call(r, "/solve", _spec("h0", 3)),
                call(r, "/result/h0"),
                call(r, "/result/nobody"),
                call(r, "/healthz"),
            ])
        assert answers[0] == answers[1]
        assert answers[0][0][0] == 200 and answers[0][2][0] == 404
        for r in routers:
            code, doc = call(r, "/fleet/status")
            assert code == 200 and doc["workers_up"] == 2
    finally:
        for r in routers:
            r.shutdown(drain=False)
