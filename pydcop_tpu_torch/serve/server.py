"""The serving front end: a micro-batching solve server for one card.

Counterpart of the core of ``pydcop_tpu/serve/server.py``: one worker
thread takes tenants from a queue, waits ``window_ms`` after the first
for more (up to ``max_batch``), and solves them as one
``solve_batched`` call (mode ``vmap`` or ``fused``).  Each tenant moves
through ``queued``, ``running`` and one terminal state: ``done``,
``failed`` (its solve raised or was refused) or ``killed`` (``kill``:
dropped before it ran, or its result discarded).  ``drain`` stops
accepting, finishes the queue and stops the worker; terminal records
past ``TENANT_RETAIN`` are evicted oldest first.

With a ``port`` (0 picks a free one), a small HTTP front end of the
standard library serves:

- ``POST /solve``: a JSON body ``{"dcop_yaml", "algo", "params",
  "n_cycles", "seed", "tenant"?}``; the YAML goes through the port's
  loader and ``compile_dcop``; answers ``{"tenant"}``, or 503 while
  draining;
- ``GET /result/<tenant>``: the tenant's record (404 when unknown);
- ``GET /status``: the server's state, counts, queue depth and queue
  latency p50/p99, and the latest tenants' rows (with pulse on, each
  done tenant's health block: ``telemetry.pulse.analyze`` of its rows);
- ``POST /shutdown``: answers, then drains in the background.

With a ``checkpoint_dir``, a drain writes the fleet checkpoint
``fleet-manifest.json`` there: the tenant census with each terminal
tenant's result, in the JAX package's manifest format (``kind:
fleet``), written atomically.

With a ``fault_schedule`` (``chaos.FaultSchedule``), as in the JAX
package: a ``delay`` rule whose ``dest`` matches a tenant id holds that
tenant alone for ``seconds`` before it may enter a batch (with ``p`` <
1, decided by the schedule's keyed hash, so the same tenants every run),
and a timed ``kill`` whose name matches a tenant id kills it when it
rides a batch dispatched at or after ``at``: its solve still runs with
the batch, its result is dropped (``killed``, a dead letter), and the
batch's other tenants keep their own results.

SLO objectives, memory admission, peer discovery from sibling fleet
manifests, trace ids, ``/metrics`` and the HA router are not ported
(ROADMAP).
"""

from __future__ import annotations

import fnmatch
import http.server
import itertools
import json
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

from ..compile.kernels import resolve_device
from ..telemetry.pulse import analyze as analyze_pulse
from .batch import SolveRequest, TenantResult, solve_batched

logger = logging.getLogger(__name__)

__all__ = ["ServeServer", "TENANT_RETAIN", "TENANT_STATES"]

TENANT_STATES = ("queued", "running", "done", "failed", "killed")
_TERMINAL = ("done", "failed", "killed")

#: terminal tenant records kept; older ones are evicted and GET /result
#: answers 'unknown' for them.  Queued and running tenants are never
#: evicted.
TENANT_RETAIN = 4096

#: queue-latency samples kept for the p50/p99 surface
LATENCY_SAMPLES = 2048

#: the latest tenants listed by ``status()``
STATUS_TENANTS = 256


def _percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals)
                                                         - 1)))))
    return sorted_vals[i]


def _bucket_str(key: Any) -> str:
    """A compact bucket label (``dsa/v16e32d3n16``)."""
    if isinstance(key, str):
        return key
    return (
        f"{key.algo}/v{key.dims.n_vars}e{key.dims.n_edges}"
        f"d{key.dims.max_domain}n{key.n_pad}"
    )


class ServeServer:
    """Micro-batching solve server: one worker thread, one device."""

    def __init__(
        self,
        port: Optional[int] = None,
        window_ms: float = 25.0,
        max_batch: int = 32,
        host: str = "127.0.0.1",
        mode: str = "vmap",
        device="cuda",
        checkpoint_dir: Optional[str] = None,
        fault_schedule: Any = None,
    ) -> None:
        if mode not in ("vmap", "fused"):
            raise ValueError(f"unknown serve batch mode {mode!r}")
        self.device = resolve_device(device)
        self._host = host
        #: a drain writes the fleet checkpoint here (``_write_fleet_
        #: checkpoint``); its path lands in ``fleet_checkpoint_path``
        self.checkpoint_dir = checkpoint_dir
        self.fleet_checkpoint_path: Optional[str] = None
        self.window_s = max(0.0, window_ms) / 1e3
        self.max_batch = max(1, int(max_batch))
        self.mode = mode
        #: the chaos schedule: tenant holds (``delay`` rules) and timed
        #: tenant kills (``kill`` events), or None
        self.fault_schedule = fault_schedule
        self._queue: "queue.Queue[str]" = queue.Queue()
        self._tenants: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self._state = "serving"
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._ids = itertools.count()
        self._t0 = time.monotonic()
        self._kills_fired: set = set()
        self._latencies: List[float] = []
        self._queue_hwm = 0
        self._buckets_seen: set = set()
        self.batches = 0
        self.solves = 0
        self.dead_letters = 0
        self.degraded = 0  # batches with a group that fell back to solo
        self.http: Optional[_HttpFront] = None
        self._worker = threading.Thread(
            target=self._run, name="serve-worker", daemon=True
        )
        self._worker.start()
        if port is not None:
            self.http = _HttpFront(self, host, port)

    # -- submission ----------------------------------------------------

    def submit(self, req: SolveRequest) -> str:
        """Enqueue one tenant solve; returns the tenant id (the request's,
        or a generated ``t<n>`` that no tenant has).  Raises RuntimeError
        while draining: a drain promises that nothing new enters the queue
        (the put happens under the lock of the state check, so a drain
        cannot miss it)."""
        now = time.monotonic()
        with self._lock:
            if self._state != "serving":
                raise RuntimeError(
                    f"server is {self._state}: not accepting tenants"
                )
            tenant = req.tenant
            while not tenant or (
                not req.tenant and tenant in self._tenants
            ):
                tenant = f"t{next(self._ids)}"  # a free generated id
            if tenant in self._tenants:
                raise ValueError(f"tenant id {tenant!r} already known")
            hold_s = self._chaos_hold_s(tenant)
            rec = {
                "status": "queued",
                "request": req._replace(tenant=tenant),
                "algo": req.algo,
                "n_cycles": req.n_cycles,
                "submitted_s": now,
            }
            if hold_s:
                rec["hold_until_s"] = now + hold_s
            self._tenants[tenant] = rec
            self._queue.put(tenant)
            self._queue_hwm = max(self._queue_hwm, self._queue.qsize())
        if hold_s:
            logger.info(
                "chaos delay: tenant %s held %.3fs before dispatch",
                tenant, hold_s,
            )
        return tenant

    def _chaos_hold_s(self, tenant: str) -> float:
        """Seconds the schedule's ``delay`` rules hold this tenant before
        it may enter a batch (0: none).  A rule with p < 1 decides by the
        schedule's keyed hash, never a shared PRNG, so the same schedule
        holds the same tenants every run."""
        sched = self.fault_schedule
        if sched is None or not getattr(sched, "rules", None):
            return 0.0
        from ..chaos.schedule import unit_draw

        total = 0.0
        for i, rule in enumerate(sched.rules):
            if rule.action != "delay":
                continue
            if not rule.matches("serve", tenant, "solve"):
                continue
            if rule.p < 1.0 and unit_draw(
                sched.seed, f"serve.delay|{i}|{tenant}", 0
            ) >= rule.p:
                continue
            total += rule.seconds
        return total

    def kill(self, tenant: str) -> bool:
        """Kill a tenant that has not finished: a queued one never runs,
        a running one's result is discarded.  Its co-batched tenants are
        untouched.  False when the tenant is unknown or already
        terminal."""
        with self._lock:
            rec = self._tenants.get(tenant)
            if rec is None or rec["status"] in _TERMINAL:
                return False
            rec["kill"] = True
            if rec["status"] == "queued":
                self._finish_killed(rec, time.monotonic())
            return True

    def _finish_killed(self, rec: Dict[str, Any], now: float) -> None:
        rec["status"] = "killed"
        rec["error"] = "killed"
        rec["finished_s"] = now
        rec.pop("request", None)
        self.dead_letters += 1

    def result(self, tenant: str) -> Dict[str, Any]:
        """One tenant's public record (what GET /result/<id> answers)."""
        with self._lock:
            rec = self._tenants.get(tenant)
            if rec is None:
                return {"tenant": tenant, "status": "unknown"}
            out = {"tenant": tenant, "status": rec["status"],
                   "algo": rec["algo"]}
            for k in ("cost", "violations", "cycles", "best_cost",
                      "cycles_to_best", "assignment", "error", "bucket",
                      "batch_size", "queue_ms", "pulse", "degraded"):
                if k in rec:
                    out[k] = rec[k]
            return out

    def wait(self, tenant: str, timeout: float = 60.0) -> Dict[str, Any]:
        """Poll until the tenant reaches a terminal state (or ``timeout``
        seconds passed)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rec = self.result(tenant)
            if rec["status"] in _TERMINAL + ("unknown",):
                return rec
            time.sleep(0.005)
        return self.result(tenant)

    def status(self) -> Dict[str, Any]:
        """The server's state: the latest ``STATUS_TENANTS`` tenants' rows
        (with a done tenant's pulse block when pulse was on), tenant
        counts by state, queue depth and its high-water mark, batches,
        solves, dead letters, degraded batches and the queue latency's p50
        and p99 (ms, submit to dispatch)."""
        with self._lock:
            lat = sorted(self._latencies[-LATENCY_SAMPLES:])
            rows = {}
            for tid, rec in list(self._tenants.items())[-STATUS_TENANTS:]:
                row = {"status": rec["status"], "algo": rec["algo"]}
                for k in ("cost", "best_cost", "cycles", "cycles_to_best",
                          "bucket", "batch_size", "queue_ms", "error",
                          "pulse"):
                    if k in rec:
                        row[k] = rec[k]
                rows[tid] = row
            counts: Dict[str, int] = {}
            for rec in self._tenants.values():
                counts[rec["status"]] = counts.get(rec["status"], 0) + 1
            return {
                "status": "serve",
                "mode": self.mode,
                "device": str(self.device),
                "state": self._state,
                "queue_depth": self._queue.qsize(),
                "queue_depth_watermark": self._queue_hwm,
                "buckets": len(self._buckets_seen),
                "tenants": rows,
                "tenant_counts": counts,
                "batches": self.batches,
                "solves": self.solves,
                "dead_letters": self.dead_letters,
                "degraded": self.degraded,
                "queue_ms": {
                    "p50": _percentile(lat, 0.50),
                    "p99": _percentile(lat, 0.99),
                },
            }

    # -- lifecycle -----------------------------------------------------

    def drain(self, timeout: float = 120.0) -> bool:
        """Graceful stop: accept nothing more, finish every queued tenant,
        stop the worker, and (with ``checkpoint_dir``) write the fleet
        checkpoint.  True when the queue drained in time."""
        with self._lock:
            if self._state == "serving":
                self._state = "draining"
        self._stop.set()
        ok = self._drained.wait(timeout)
        with self._lock:
            self._state = "drained" if ok else "drain-timeout"
        if self.checkpoint_dir:
            try:
                self.fleet_checkpoint_path = self._write_fleet_checkpoint()
            except OSError:
                logger.exception("fleet checkpoint write failed")
        return ok

    def _write_fleet_checkpoint(self) -> str:
        """The drain's record, as the JAX package writes it: one JSON
        manifest (``kind: fleet``, the solver checkpoints' format) with
        the whole tenant census, terminal tenants with their results and
        the others listed, written atomically; array-free, so it reads
        anywhere.  Returns its path."""
        from ..durability.manager import MANIFEST_FORMAT
        from ..utils.checkpoint import atomic_write_json

        with self._lock:
            tenants = {}
            for tid, rec in self._tenants.items():
                row = {"status": rec["status"], "algo": rec["algo"]}
                for k in ("cost", "violations", "cycles", "best_cost",
                          "cycles_to_best", "assignment", "error",
                          "bucket", "batch_size", "n_cycles"):
                    if k in rec:
                        row[k] = rec[k]
                tenants[tid] = row
            worker = (f"{self._host}:{self.http.port}"
                      if self.http is not None else None)
            manifest = {
                "format": MANIFEST_FORMAT,
                "kind": "fleet",
                "wrote_unix_s": time.time(),
                "endpoint": None if worker is None else f"http://{worker}",
                "worker": worker,
                "state": self._state,
                "mode": self.mode,
                "batches": self.batches,
                "solves": self.solves,
                "dead_letters": self.dead_letters,
                "tenants": tenants,
            }
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.checkpoint_dir, "fleet-manifest.json")
        atomic_write_json(path, manifest, indent=2, sort_keys=True,
                          default=str)
        logger.info("fleet checkpoint: %d tenant(s) -> %s", len(tenants),
                    path)
        return path

    def shutdown(self, drain: bool = True, timeout: float = 120.0) -> bool:
        """Drain (or just stop the worker), then close the HTTP front."""
        ok = self.drain(timeout) if drain else True
        if not drain:
            with self._lock:
                self._state = "stopped"
            self._stop.set()
        if self.http is not None:
            self.http.close()
        return ok

    def wait_drained(self, timeout: float = 120.0) -> bool:
        """Block until a drain (started here or by POST /shutdown) has
        emptied the queue."""
        return self._drained.wait(timeout)

    # -- the worker ----------------------------------------------------

    def _next_ready(self, timeout: float) -> str:
        """Pop the next tenant that may be dispatched.  A tenant held by a
        ``delay`` rule is put back until its release time: the hold
        applies to that tenant alone, so the tenants batched beside it
        never wait for someone else's injected stall."""
        if self.fault_schedule is None:
            return self._queue.get(timeout=timeout)
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining < 0:
                raise queue.Empty
            tid = self._queue.get(timeout=max(0.0, remaining))
            with self._lock:
                rec = self._tenants.get(tid)
                hold = rec.get("hold_until_s", 0.0) if rec else 0.0
            now = time.monotonic()
            if hold <= now:
                return tid
            self._queue.put(tid)
            time.sleep(min(0.005, hold - now))

    def _run(self) -> None:
        while True:
            try:
                first = self._next_ready(0.05)
            except queue.Empty:
                if self._stop.is_set() and not self._queue.qsize():
                    break
                continue
            batch = [first]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0 and not self._stop.is_set():
                    break
                try:
                    batch.append(self._next_ready(max(0.0, remaining)))
                except queue.Empty:
                    break
            try:
                self._dispatch(batch)
            except Exception:  # noqa: BLE001 (the loop must survive)
                logger.exception("serve batch dispatch failed")
                now = time.monotonic()
                with self._lock:
                    for tid in batch:
                        rec = self._tenants.get(tid)
                        if rec and rec["status"] in ("queued", "running"):
                            rec["status"] = "failed"
                            rec["error"] = "dispatch error (see log)"
                            rec["finished_s"] = now
                            rec.pop("request", None)
                            self.dead_letters += 1
        self._drained.set()

    def _fired_kills(self) -> List[str]:
        """Tenant-id patterns of the schedule's kills due by now, each
        fired once."""
        if self.fault_schedule is None:
            return []
        elapsed = time.monotonic() - self._t0
        out = []
        for ev in self.fault_schedule.kills:
            key = (ev.agent, ev.at)
            if ev.at <= elapsed and key not in self._kills_fired:
                self._kills_fired.add(key)
                out.append(ev.agent)
        return out

    def _dispatch(self, tenant_ids: List[str]) -> None:
        now = time.monotonic()
        reqs, running = [], []
        with self._lock:
            for tid in tenant_ids:
                rec = self._tenants[tid]
                if rec["status"] != "queued":
                    continue  # killed while it waited
                rec["status"] = "running"
                q_ms = (now - rec["submitted_s"]) * 1e3
                rec["queue_ms"] = round(q_ms, 3)
                self._latencies.append(q_ms)
                if len(self._latencies) > 2 * LATENCY_SAMPLES:
                    del self._latencies[:-LATENCY_SAMPLES]
                reqs.append(rec["request"])
                running.append(tid)
        if not reqs:
            return
        degraded = solve_batched.degraded
        # the schedule's kills due before or while this batch runs: the
        # victims' solves still run (the batch is one program), their
        # results are dropped, and only theirs
        kill_patterns = self._fired_kills()
        results = solve_batched(reqs, max_batch=self.max_batch,
                                mode=self.mode, device=self.device)
        kill_patterns += self._fired_kills()
        with self._lock:
            if solve_batched.degraded != degraded:
                self.degraded += 1
            done = time.monotonic()
            for tid in running:
                rec = self._tenants[tid]
                tr: Optional[TenantResult] = results.get(tid)
                rec["finished_s"] = done
                # a terminal record never runs again: drop the request,
                # which pins the compiled problem and its cached tensors
                rec.pop("request", None)
                if rec.get("kill"):
                    self._finish_killed(rec, done)
                elif any(fnmatch.fnmatchcase(tid, pat)
                         for pat in kill_patterns):
                    self._finish_killed(rec, done)
                    rec["error"] = "killed by chaos schedule"
                elif tr is None or tr.result is None:
                    rec["status"] = "failed"
                    rec["error"] = (tr.extras if tr else {}).get(
                        "error", "no result"
                    )
                    self.dead_letters += 1
                else:
                    self._record_done(rec, tr)
                    self.solves += 1
            self.batches += 1
            self._evict_terminal()

    def _record_done(self, rec: Dict[str, Any], tr: TenantResult) -> None:
        rec["status"] = "done"
        rec["cost"] = tr.result.cost
        rec["violations"] = tr.result.violations
        rec["cycles"] = tr.result.cycles
        rec["assignment"] = tr.result.assignment
        rec["best_cost"] = tr.extras.get("best_cost")
        rec["cycles_to_best"] = tr.extras.get("cycles_to_best")
        if "bucket" in tr.extras:
            rec["bucket"] = _bucket_str(tr.extras["bucket"])
            self._buckets_seen.add(rec["bucket"])
        if "batch_size" in tr.extras:
            rec["batch_size"] = tr.extras["batch_size"]
        if "degraded" in tr.extras:
            rec["degraded"] = tr.extras["degraded"]
        pulse_blk = tr.extras.get("pulse")
        if pulse_blk is not None and pulse_blk.get("health") is not None:
            a = analyze_pulse(pulse_blk["health"])
            rec["pulse"] = {
                "diagnosis": a.get("diagnosis_full", a.get("diagnosis")),
                "churn": round(float(a.get("churn_now", 0.0) or 0.0), 4),
                "residual": float(a.get("residual_now", 0.0) or 0.0),
                "violations": int(a.get("violations", 0) or 0),
                "cycles": a.get("cycles", 0),
            }

    def _evict_terminal(self) -> None:
        """Drop the oldest terminal records past TENANT_RETAIN (the caller
        holds the lock): the memory bound of a long-lived server."""
        excess = len(self._tenants) - TENANT_RETAIN
        if excess <= 0:
            return
        for tid in [t for t, r in self._tenants.items()
                    if r["status"] in _TERMINAL][:excess]:
            del self._tenants[tid]

    # -- HTTP routes ---------------------------------------------------

    def http_solve(self, body: bytes):
        from ..compile.core import compile_dcop
        from ..dcop.yamldcop import load_dcop

        spec = json.loads(body.decode("utf-8"))
        req = SolveRequest(
            tenant=spec.get("tenant") or "",
            compiled=compile_dcop(load_dcop(spec["dcop_yaml"])),
            algo=spec.get("algo", "dsa"),
            params=spec.get("params") or {},
            n_cycles=int(spec.get("n_cycles", 100)),
            seed=int(spec.get("seed", 0)),
        )
        try:
            tenant = self.submit(req)
        except RuntimeError as e:
            with self._lock:
                state = self._state
            return 503, {"error": str(e), "state": state}
        return 200, {"tenant": tenant}

    def http_result(self, tenant: str):
        rec = self.result(tenant)
        return (404 if rec["status"] == "unknown" else 200), rec

    def http_shutdown(self):
        # answer first, drain in the background: the reply must not wait
        # behind the queue
        threading.Thread(target=self.shutdown, kwargs={"drain": True},
                         daemon=True).start()
        return 200, {"state": "draining"}


class _HttpFront:
    """The server's HTTP routes on a threading ``http.server``."""

    def __init__(self, server: ServeServer, host: str, port: int) -> None:
        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: the log has it
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, doc: Dict[str, Any]) -> None:
                data = json.dumps(doc, default=str).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n else b""

            def do_GET(self):
                if self.path == "/status":
                    return self._reply(200, server.status())
                if self.path.startswith("/result/"):
                    return self._reply(
                        *server.http_result(self.path.rsplit("/", 1)[-1])
                    )
                return self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                body = self._body()
                try:
                    if self.path == "/solve":
                        return self._reply(*server.http_solve(body))
                    if self.path == "/shutdown":
                        return self._reply(*server.http_shutdown())
                except Exception as e:  # noqa: BLE001 (a bad request)
                    return self._reply(
                        400, {"error": f"{type(e).__name__}: {e}"}
                    )
                return self._reply(404, {"error": f"no route {self.path}"})

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="serve-http", daemon=True
        )
        self._lock = threading.Lock()
        self._closed = False
        self._thread.start()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.httpd.shutdown()
        self.httpd.server_close()
