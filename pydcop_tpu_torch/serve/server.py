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

With a ``port`` (0 picks a free one), the routes are mounted on the
live metrics surface (``infrastructure.MetricsHttpServer``), beside its
``GET /metrics`` (Prometheus text, OpenMetrics with exemplars on
``?format=openmetrics``) and ``GET /metrics.json``:

- ``POST /solve``: a JSON body ``{"dcop_yaml", "algo", "params",
  "n_cycles", "seed", "tenant"?, "trace"?}``; the YAML goes through the
  port's loader and ``compile_dcop``; answers ``{"tenant", "trace"}``,
  400 on a body it cannot read, or 503 while draining (with
  ``retry_after_s``, a ``Retry-After`` header and the ``peers`` list);
- ``GET /result/<tenant>``: the tenant's record (404 when unknown);
- ``GET /status``: the server's state, counts, queue depth and queue
  latency p50/p99, the latest tenants' rows (with pulse on, each done
  tenant's health block: ``telemetry.pulse.analyze`` of its rows), the
  ``memory`` block and, with an SLO engine, the ``slo`` block;
- ``GET /healthz``: 200 while serving, else 503, with ``{state,
  queue_depth}``: a draining server is alive but takes no tenant;
- ``POST /window``: ``{"window_ms"}``, clamped to [0, 10 s], the
  micro-batching window of the next batch (400 on a bad body);
- ``GET /slo`` (with an SLO engine): its report;
- ``POST /shutdown``: answers, then drains in the background.

Every tenant carries a trace id: the caller's (``submit(req,
trace=)``, ``"trace"`` of ``POST /solve``; a resubmit may pass the id of
an earlier attempt) or a fresh 16-hex one, echoed in the answer, in
``/result`` and in the ``/status`` row.  With the metrics registry, the
tracer or an SLO engine on, each dispatched batch reports its phases
(``serve.batch``'s observer) and the server attributes them to every
tenant that rode it: the ``serve.phase_seconds`` histogram by phase
(``PHASES``) and bucket with the trace id as exemplar,
``serve.request_seconds`` at the result, the spans ``serve.batch``,
``serve.{assemble,dispatch,solve,readback}``, ``serve.cold_compile`` (a
dispatch that captured graphs), ``serve.queued`` and ``serve.request``,
the ``serve.result_ready`` instant and the request's flow points, and
the SLO engine's ``record_request`` of each terminal tenant.  The
``serve.*`` metrics carry the JAX package's names.

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

Behind the HA router (``serve.router``) a server is one worker of a
fleet: ``peers`` are its fellow workers' base URLs (the verb's
``--peer``), to which ``peers()`` adds the endpoints that sibling
``fleet-manifest.json`` files record beside its ``checkpoint_dir``; a
structured 503 hands that list to the rejected client.
"""

from __future__ import annotations

import fnmatch
import itertools
import json
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..compile.kernels import resolve_device
from ..telemetry.memplane import MemoryBudgetExceeded, memguard, memory_status
from ..telemetry.metrics import metrics_registry
from ..telemetry.metrics import percentile as _percentile
from ..telemetry.pulse import analyze as analyze_pulse
from ..telemetry.tracing import tracer
from .batch import SolveRequest, TenantResult, solve_batched

logger = logging.getLogger(__name__)

__all__ = ["PHASES", "ServeServer", "TENANT_RETAIN", "TENANT_STATES"]

TENANT_STATES = ("queued", "running", "done", "failed", "killed")
_TERMINAL = ("done", "failed", "killed")

#: the phases ``serve.phase_seconds`` splits a request's latency into
PHASES = ("queue", "assemble", "dispatch", "solve", "readback")

#: terminal tenant records kept; older ones are evicted and GET /result
#: answers 'unknown' for them.  Queued and running tenants are never
#: evicted.
TENANT_RETAIN = 4096

#: queue-latency samples kept for the p50/p99 surface
LATENCY_SAMPLES = 2048

#: the latest tenants listed by ``status()``
STATUS_TENANTS = 256

_m_queue_seconds = metrics_registry.histogram(
    "serve.queue_seconds",
    "tenant queue latency (submit to batch dispatch start)",
)
_m_dead_letters = metrics_registry.counter(
    "serve.dead_letters",
    "tenant results dropped (chaos kills, failed solves)",
)
_m_tenants = metrics_registry.gauge(
    "serve.tenants", "tenants known to the serve loop, by state"
)
_m_fleet_ckpt = metrics_registry.counter(
    "serve.fleet_checkpoints",
    "fleet checkpoints written by graceful drains (graftdur)",
)
_m_request_seconds = metrics_registry.histogram(
    "serve.request_seconds",
    "end-to-end request latency (submit to result-ready)",
)
_m_phase_seconds = metrics_registry.histogram(
    "serve.phase_seconds",
    "request latency per lifecycle phase and shape bucket",
)
_m_queue_depth = metrics_registry.gauge(
    "serve.queue_depth", "tenants waiting in the micro-batching queue"
)
_m_queue_hwm = metrics_registry.gauge(
    "serve.queue_depth_watermark",
    "high-water mark of the micro-batching queue this run",
)
_m_occupancy = metrics_registry.gauge(
    "serve.batch_occupancy_pct",
    "real (non-pad) fraction of the last dispatched batch, percent",
)
_m_bucket_census = metrics_registry.gauge(
    "serve.bucket_cache_size",
    "distinct shape buckets dispatched so far (executable-cache pressure)",
)
_m_chaos_delays = metrics_registry.counter(
    "serve.chaos_delays",
    "tenants held back by a chaos delay rule before dispatch",
)


def _bucket_str(key: Any) -> str:
    """A compact bucket label (``dsa/v16e32d3n16``)."""
    if isinstance(key, str):
        return key
    return (
        f"{key.algo}/v{key.dims.n_vars}e{key.dims.n_edges}"
        f"d{key.dims.max_domain}n{key.n_pad}"
    )




class ServeServer:
    """Micro-batching solve server: one worker thread, one device.

    ``slo``: an ``telemetry.slo.SloEngine`` that classifies every
    terminal tenant against its objectives; the server starts its
    evaluator, stops it with a final tick at the drain, mounts ``GET
    /slo`` and adds its block to ``/status``.  It counts into the metrics
    registry, which the caller turns on (the ``serve`` verb does)."""

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
        slo: Any = None,
        peers: Optional[Sequence[str]] = None,
    ) -> None:
        if mode not in ("vmap", "fused"):
            raise ValueError(f"unknown serve batch mode {mode!r}")
        self.device = resolve_device(device)
        self._host = host
        #: fellow workers' base URLs, handed to rejected clients so they
        #: can fail over without guessing (``--peer`` on the verb; sibling
        #: fleet manifests fill in the rest: ``peers()``)
        self._peers = [str(p).rstrip("/") for p in (peers or []) if p]
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
        self.slo = slo
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
        self._batch_seq = itertools.count(1)
        self.batches = 0
        self.solves = 0
        self.dead_letters = 0
        self.degraded = 0  # batches with a group that fell back to solo
        self.http = None
        if self.slo is not None:
            self.slo.start()
        self._worker = threading.Thread(
            target=self._run, name="serve-worker", daemon=True
        )
        self._worker.start()
        if port is not None:
            from ..infrastructure.ui import MetricsHttpServer

            routes = {
                ("POST", "/solve"): self._http_solve,
                ("GET", "/result"): self._http_result,
                ("GET", "/healthz"): self._http_healthz,
                ("POST", "/window"): self._http_window,
                ("POST", "/shutdown"): self._http_shutdown,
            }
            if self.slo is not None:
                routes[("GET", "/slo")] = self._http_slo
            self.http = MetricsHttpServer(port=port, host=host,
                                          status_cb=self.status,
                                          routes=routes)

    def _observing(self) -> bool:
        """Whether the request lifecycle is recorded: the registry or the
        tracer on, or an SLO engine (each dispatch checks anew)."""
        return (tracer.enabled or metrics_registry.enabled
                or self.slo is not None)

    # -- submission ----------------------------------------------------

    def submit(self, req: SolveRequest, trace: Optional[str] = None) -> str:
        """Enqueue one tenant solve; returns the tenant id (the request's,
        or a generated ``t<n>`` that no tenant has).  Raises RuntimeError
        while draining: a drain promises that nothing new enters the queue
        (the put happens under the lock of the state check, so a drain
        cannot miss it).  With the memory guard on, a tenant whose
        bucket-padded solve cannot fit the device is refused first
        (``MemoryBudgetExceeded``, a RuntimeError) instead of entering a
        batch that would run the card out of memory for every tenant in
        it.  ``trace``: the request's trace id (a fresh one when None)."""
        rid = str(trace) if trace else os.urandom(8).hex()
        now = time.monotonic()
        if memguard.enabled:
            # outside the lock: the model is host arithmetic
            memguard.check(
                req.compiled, req.algo, req.params,
                context="serve", n_cycles=req.n_cycles,
                serve_bucket=True, device=self.device,
            )
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
                # the tracer's clock, for the request's spans
                "submitted_pc": time.perf_counter(),
                "trace": rid,
            }
            if hold_s:
                rec["hold_until_s"] = now + hold_s
            if tracer.enabled:
                rec["flow_id"] = tracer.new_flow_id()
            self._tenants[tenant] = rec
            self._queue.put(tenant)
            depth = self._queue.qsize()
            self._queue_hwm = max(self._queue_hwm, depth)
            hwm = self._queue_hwm
        if hold_s:
            _m_chaos_delays.inc()
            logger.info(
                "chaos delay: tenant %s held %.3fs before dispatch",
                tenant, hold_s,
            )
        if metrics_registry.enabled:
            _m_queue_depth.set(depth)
            _m_queue_hwm.set(hwm)
        if tracer.enabled:
            # the request's flow starts here; it goes through the batch it
            # rides to its result
            tracer.flow_point(
                "s", "serve.submit", rec["flow_id"], cat="serve",
                flow_name="serve.request", tenant=tenant, trace=rid,
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
        finals = []
        with self._lock:
            rec = self._tenants.get(tenant)
            if rec is None or rec["status"] in _TERMINAL:
                return False
            rec["kill"] = True
            if rec["status"] == "queued":
                self._finish_killed(rec, time.monotonic())
                if self._observing():
                    rec["finished_pc"] = time.perf_counter()
                    finals.append(self._final_row(tenant, rec))
        self._finish_requests(finals)
        return True

    def _finish_killed(self, rec: Dict[str, Any], now: float) -> None:
        rec["status"] = "killed"
        rec["error"] = "killed"
        rec["finished_s"] = now
        rec.pop("request", None)
        self.dead_letters += 1
        _m_dead_letters.inc()

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
                      "batch_size", "queue_ms", "pulse", "degraded",
                      "trace", "phases", "batch_seq", "cold_compile"):
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
        solves, dead letters, degraded batches, the queue latency's p50
        and p99 (ms, submit to dispatch), the ``memory`` block (the
        latest live sample, the guard's settings and refusals) and, with
        an SLO engine, its ``slo`` block."""
        with self._lock:
            lat = sorted(self._latencies[-LATENCY_SAMPLES:])
            rows = {}
            for tid, rec in list(self._tenants.items())[-STATUS_TENANTS:]:
                row = {"status": rec["status"], "algo": rec["algo"]}
                for k in ("cost", "best_cost", "cycles", "cycles_to_best",
                          "bucket", "batch_size", "queue_ms", "error",
                          "trace", "pulse"):
                    if k in rec:
                        row[k] = rec[k]
                rows[tid] = row
            counts: Dict[str, int] = {}
            for rec in self._tenants.values():
                counts[rec["status"]] = counts.get(rec["status"], 0) + 1
            out = {
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
                # the latest live memory sample and the guard's settings
                "memory": memory_status(),
            }
        if self.slo is not None:
            # outside the server's lock: the engine reads its own state
            # under its own lock
            out["slo"] = self.slo.status_block()
        return out

    def peers(self) -> List[str]:
        """Fellow workers' base URLs: the configured ``peers`` plus the
        endpoints that sibling fleet manifests record under the
        checkpoint directory's parent (``fleet --manifest`` reads the
        same files).  Own endpoint excluded; best effort, never raises."""
        own = (f"http://{self._host}:{self.http.port}"
               if self.http is not None else None)
        out: List[str] = []
        seen: set = set()
        for url in self._peers:
            if url != own and url not in seen:
                seen.add(url)
                out.append(url)
        if self.checkpoint_dir:
            parent = os.path.dirname(os.path.abspath(self.checkpoint_dir))
            try:
                entries = sorted(os.listdir(parent))
            except OSError:
                entries = []
            for entry in entries:
                path = os.path.join(parent, entry, "fleet-manifest.json")
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue
                url = str(doc.get("endpoint") or "").rstrip("/")
                if url and url != own and url not in seen:
                    seen.add(url)
                    out.append(url)
        return out

    # -- lifecycle -----------------------------------------------------

    def drain(self, timeout: float = 120.0) -> bool:
        """Graceful stop: accept nothing more, finish every queued tenant,
        stop the worker, run the SLO engine's last tick and (with
        ``checkpoint_dir``) write the fleet checkpoint.  True when the
        queue drained in time."""
        with self._lock:
            if self._state == "serving":
                self._state = "draining"
        self._stop.set()
        ok = self._drained.wait(timeout)
        with self._lock:
            self._state = "drained" if ok else "drain-timeout"
        if self.slo is not None:
            # after the queue drained: the requests that finished since
            # the last periodic tick reach the burn rates too
            self.slo.stop(final_tick=True)
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
        _m_fleet_ckpt.inc()
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
            if self.slo is not None:
                self.slo.stop(final_tick=True)
        if self.http is not None:
            self.http.shutdown()
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
            # POST /window's new value applies from the next batch on
            with self._lock:
                window_s = self.window_s
            deadline = time.monotonic() + window_s
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
                finals = []
                with self._lock:
                    for tid in batch:
                        rec = self._tenants.get(tid)
                        if rec and rec["status"] in ("queued", "running"):
                            rec["status"] = "failed"
                            rec["error"] = "dispatch error (see log)"
                            rec["finished_s"] = now
                            rec.pop("request", None)
                            self.dead_letters += 1
                            _m_dead_letters.inc()
                            finals.append(self._final_row(tid, rec))
                self._finish_requests(finals)
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
        # the request lifecycle is recorded only while something reads it:
        # otherwise the dispatch costs these flag checks
        observing = self._observing()
        reqs, running = [], []
        with self._lock:
            for tid in tenant_ids:
                rec = self._tenants[tid]
                if rec["status"] != "queued":
                    continue  # killed while it waited
                rec["status"] = "running"
                rec["started_s"] = now
                q_ms = (now - rec["submitted_s"]) * 1e3
                rec["queue_ms"] = round(q_ms, 3)
                self._latencies.append(q_ms)
                if len(self._latencies) > 2 * LATENCY_SAMPLES:
                    del self._latencies[:-LATENCY_SAMPLES]
                _m_queue_seconds.observe(q_ms / 1e3)
                reqs.append(rec["request"])
                running.append(tid)
        if not reqs:
            return
        degraded = solve_batched.degraded
        # the schedule's kills due before or while this batch runs: the
        # victims' solves still run (the batch is one program), their
        # results are dropped, and only theirs
        kill_patterns = self._fired_kills()
        results = solve_batched(
            reqs, max_batch=self.max_batch, mode=self.mode,
            device=self.device,
            observer=self._on_batch_event if observing else None,
        )
        kill_patterns += self._fired_kills()
        finals: List[Dict[str, Any]] = []
        with self._lock:
            if solve_batched.degraded != degraded:
                self.degraded += 1
            done = time.monotonic()
            for tid in running:
                rec = self._tenants[tid]
                tr: Optional[TenantResult] = results.get(tid)
                rec["finished_s"] = done
                if observing:
                    rec["finished_pc"] = time.perf_counter()
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
                    _m_dead_letters.inc()
                else:
                    self._record_done(rec, tr)
                    self.solves += 1
                if observing:
                    finals.append(self._final_row(tid, rec))
            self.batches += 1
            self._evict_terminal()
            if metrics_registry.enabled:
                for state in TENANT_STATES:
                    _m_tenants.set(
                        sum(1 for r in self._tenants.values()
                            if r["status"] == state),
                        state=state,
                    )
        self._finish_requests(finals)

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

    # -- the request lifecycle -------------------------------------------

    def _on_batch_event(self, ev: Dict[str, Any]) -> None:
        """One dispatched group's phases (``serve.batch``'s observer),
        given to every tenant that rode it: the phase histograms (the
        tenants' trace ids as exemplars), the saturation gauges, the
        batch's spans and each tenant's queued span and flow step."""
        bucket = _bucket_str(ev["bucket"])
        seq = next(self._batch_seq)
        occupancy = 100.0 * ev["k_real"] / max(1, ev["k_pad"])
        t_solved = ev["t_solved"] or ev["t_dispatched"]
        segments = (
            ("assemble", ev["t_start"], ev["t_assembled"]),
            ("dispatch", ev["t_assembled"], ev["t_dispatched"]),
            ("solve", ev["t_dispatched"], t_solved),
            ("readback", t_solved, ev["t_done"]),
        )
        rows = []
        with self._lock:
            self._buckets_seen.add(bucket)
            n_buckets = len(self._buckets_seen)
            for tid in ev["tenants"]:
                rec = self._tenants.get(tid)
                if rec is None:
                    continue
                sub_pc = rec.get("submitted_pc")
                phases = {name: max(0.0, b - a) for name, a, b in segments}
                phases["queue"] = (max(0.0, ev["t_start"] - sub_pc)
                                   if sub_pc is not None else 0.0)
                rec["phases"] = {k: round(v, 6) for k, v in phases.items()}
                rec["batch_seq"] = seq
                rec.setdefault("bucket", bucket)
                if ev["fresh_compiles"]:
                    # the capture's stall belongs to the tenants that rode
                    # the batch that paid it
                    rec["cold_compile"] = True
                rows.append((tid, rec.get("trace"), rec.get("flow_id"),
                             sub_pc, phases))
        if metrics_registry.enabled:
            _m_occupancy.set(occupancy)
            _m_bucket_census.set(n_buckets)
            _m_queue_depth.set(self._queue.qsize())
            for _tid, trace, _flow, _sub, phases in rows:
                for name, v in phases.items():
                    _m_phase_seconds.observe(v, exemplar_=trace, phase=name,
                                             bucket=bucket)
        if tracer.enabled:
            tenants = list(ev["tenants"])
            tracer.complete(
                "serve.batch", ev["t_start"], ev["t_done"] - ev["t_start"],
                cat="serve", batch=seq, bucket=bucket, k_real=ev["k_real"],
                k_pad=ev["k_pad"], occupancy_pct=round(occupancy, 1),
                fresh_compiles=ev["fresh_compiles"], tenants=tenants,
            )
            for name, a, b in segments:
                tracer.complete(f"serve.{name}", a, b - a, cat="serve",
                                batch=seq, bucket=bucket, tenants=tenants)
            if ev["fresh_compiles"]:
                # the graphs captured inside this dispatch, and who paid
                tracer.complete(
                    "serve.cold_compile", ev["t_assembled"],
                    ev["t_dispatched"] - ev["t_assembled"], cat="serve",
                    batch=seq, bucket=bucket,
                    fresh_compiles=ev["fresh_compiles"], paid_by=tenants,
                )
            for tid, trace, flow_id, sub_pc, _phases in rows:
                if sub_pc is not None:
                    tracer.complete(
                        "serve.queued", sub_pc,
                        max(0.0, ev["t_start"] - sub_pc), cat="serve",
                        tenant=tid, trace=trace, batch=seq, bucket=bucket,
                    )
                if flow_id is not None:
                    tracer.flow_point(
                        "t", "serve.batch.enter", flow_id, cat="serve",
                        flow_name="serve.request", tenant=tid, trace=trace,
                        batch=seq, bucket=bucket,
                    )

    def _final_row(self, tid: str, rec: Dict[str, Any]) -> Dict[str, Any]:
        """What ``_finish_requests`` needs of a terminal tenant, taken
        under the lock (the caller holds it)."""
        return {
            "tenant": tid,
            "trace": rec.get("trace"),
            "flow_id": rec.get("flow_id"),
            "submitted_s": rec.get("submitted_s", 0.0),
            "finished_s": rec.get("finished_s", 0.0),
            "submitted_pc": rec.get("submitted_pc"),
            "finished_pc": rec.get("finished_pc"),
            "status": rec["status"],
            "bucket": rec.get("bucket"),
            "batch_seq": rec.get("batch_seq"),
            "cold_compile": rec.get("cold_compile", False),
            "phases": rec.get("phases"),
        }

    def _finish_requests(self, rows: List[Dict[str, Any]]) -> None:
        """The result side of each terminal tenant's lifecycle, outside
        the lock: the end-to-end latency (its trace id the exemplar), the
        ``serve.request`` span over its whole life, the result instant and
        the flow's end, and the SLO engine's classification."""
        for r in rows:
            latency = max(0.0, r["finished_s"] - r["submitted_s"])
            dead = r["status"] in ("failed", "killed")
            if metrics_registry.enabled:
                _m_request_seconds.observe(latency, exemplar_=r["trace"])
            if tracer.enabled:
                if r["submitted_pc"] is not None and r["finished_pc"]:
                    tracer.complete(
                        "serve.request", r["submitted_pc"],
                        max(0.0, r["finished_pc"] - r["submitted_pc"]),
                        cat="serve", tenant=r["tenant"], trace=r["trace"],
                        status=r["status"], bucket=r["bucket"],
                        batch=r["batch_seq"],
                        cold_compile=r["cold_compile"],
                    )
                tracer.instant("serve.result_ready", cat="serve",
                               tenant=r["tenant"], trace=r["trace"],
                               status=r["status"])
                if r["flow_id"] is not None:
                    tracer.flow_point(
                        "f", "serve.result", r["flow_id"], cat="serve",
                        flow_name="serve.request", tenant=r["tenant"],
                        trace=r["trace"], status=r["status"],
                    )
            if self.slo is not None:
                self.slo.record_request(
                    r["tenant"], r["status"], latency, dead_letter=dead,
                    trace=r["trace"], phases=r["phases"],
                )

    # -- HTTP routes (on the metrics surface) ----------------------------

    def _http_solve(self, path: str, body: bytes):
        from ..compile.core import compile_dcop
        from ..dcop.yamldcop import load_dcop

        try:
            spec = json.loads(body.decode("utf-8"))
            req = SolveRequest(
                tenant=spec.get("tenant") or "",
                compiled=compile_dcop(load_dcop(spec["dcop_yaml"])),
                algo=spec.get("algo", "dsa"),
                params=spec.get("params") or {},
                n_cycles=int(spec.get("n_cycles", 100)),
                seed=int(spec.get("seed", 0)),
            )
        except Exception as e:  # noqa: BLE001 (a body it cannot read)
            return 400, {"error": f"{type(e).__name__}: {e}"}
        # a resubmit passing its first attempt's trace id keeps both on
        # one timeline
        rid = str(spec.get("trace") or "") or os.urandom(8).hex()
        try:
            tenant = self.submit(req, trace=rid)
        except ValueError as e:  # a known tenant id
            return 400, {"error": str(e)}
        except RuntimeError as e:
            with self._lock:
                state = self._state
            retry_after = 2
            # where to go (the peers) and when to come back
            doc = {"error": str(e), "state": state,
                   "retry_after_s": retry_after, "peers": self.peers()}
            if isinstance(e, MemoryBudgetExceeded):
                # "never fits here", not "busy now": the breach's numbers
                doc["mem"] = e.breach
            return 503, doc, {"Retry-After": str(retry_after)}
        return 200, {"tenant": tenant, "trace": rid}

    def _http_result(self, path: str, body: bytes):
        rec = self.result(path.rsplit("/", 1)[-1])
        return (404 if rec["status"] == "unknown" else 200), rec

    def _http_healthz(self, path: str, body: bytes):
        """Readiness: 200 only while taking tenants.  A draining server is
        alive but answers 503, so a router leaves it out while its queue
        empties."""
        with self._lock:
            state = self._state
            depth = self._queue.qsize()
        return (200 if state == "serving" else 503), {
            "state": state, "queue_depth": depth}

    def _http_window(self, path: str, body: bytes):
        """The micro-batching window, retuned live: clamped to [0, 10 s],
        from the next batch on."""
        try:
            spec = json.loads(body.decode("utf-8")) if body else {}
            window_ms = float(spec["window_ms"])
        except (KeyError, TypeError, ValueError):
            return 400, {"error": "expected {'window_ms': <float>}"}
        window_ms = min(10_000.0, max(0.0, window_ms))
        with self._lock:
            self.window_s = window_ms / 1e3
        return 200, {"window_ms": window_ms}

    def _http_slo(self, path: str, body: bytes):
        return 200, self.slo.report()

    def _http_shutdown(self, path: str, body: bytes):
        # answer first, drain in the background: the reply must not wait
        # behind the queue
        threading.Thread(target=self.shutdown, kwargs={"drain": True},
                         daemon=True).start()
        return 200, {"state": "draining"}
