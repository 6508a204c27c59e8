"""The HA serve fleet: an SLO-driven router over N serve workers.

The port's own copy of ``pydcop_tpu/serve/router.py``, with the same
decisions and the same documents: N
:class:`~pydcop_tpu_torch.serve.server.ServeServer` workers (each a
``python -m pydcop_tpu_torch serve`` process on the card) behind one
router, so losing a worker is an SLO blip, not an outage.  Three
responsibilities:

- **Placement** — tenants are routed by *bucket affinity*: requests
  hash to an :func:`affinity_key` (algorithm + power-of-two problem
  class, the cheap prefix of ``serve.batch.BucketKey``) and buckets are
  laid onto workers by the placement engine that places computations on
  agents (``distribution/tpu_part``).  Same-bucket tenants land on the
  same worker, so the fleet captures each bucket's CUDA graphs once
  instead of once per worker.  ``placement="round_robin"`` keeps the
  classic spray for A/B runs.
- **Admission control** — a fleet-SLO-fed control loop: when a
  fast-burn alert trips (on the federated worker objectives or on the
  router's own forward-outcome objectives), low-priority tenants are
  *shed* (structured 503 + ``Retry-After`` + live peer list) and
  normal-priority tenants are *deferred* (parked router-side, released
  when the burn clears or ``defer_max_s`` elapses); high priority is
  always admitted.  Every shed/defer decision is a structured event and
  a counter (``router.shed_total{reason,priority}``).  When queues sit
  idle and nothing burns, the loop *widens* the workers' micro-batch
  windows (``POST /window``) to trade latency headroom for batch
  occupancy, and narrows them back the moment queues build or an alert
  fires.
- **Failover** — a killed worker is detected by the
  ``fleet.worker_up`` flip (bounded scrape retry first — one dropped
  connection is not a death) or by a forward that exhausts its
  :class:`~pydcop_tpu_torch.infrastructure.retry.RetryPolicy`.  The
  victim's non-terminal tenants are re-admitted onto surviving workers:
  terminal results left in the victim's ``fleet-manifest.json`` are
  ADOPTED (the ownership transfer is recorded — a tenant is never
  solved twice), everything else is re-solved from scratch with the
  original seed (``router.resolve_from_scratch``) — bit-identical to the
  uninterrupted solve, since a batched tenant keeps the bits of its solo
  solve.  Per-tenant deadlines bound the whole recovery, so a flapping
  worker degrades to slow, not lost.

Host-only, stdlib and numpy: the router imports no torch and touches no
device; only its workers do.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import replace
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from ..infrastructure.retry import RetryPolicy
from ..telemetry.federate import (
    FleetCollector,
    FleetSlo,
    FleetTarget,
    _http_fetch,
)
from ..telemetry.metrics import metrics_registry
from ..telemetry.slo import (
    DEFAULT_FAST_BURN,
    DEFAULT_SLOW_BURN,
    Objective,
    SloEngine,
)

__all__ = ["Router", "affinity_key", "PRIORITIES"]

logger = logging.getLogger("pydcop_tpu_torch.serve.router")

#: admission classes, most to least protected
PRIORITIES = ("high", "normal", "low")

#: structured router events kept for /status
EVENTS_CAP = 512

#: tenant rows included in /status
STATUS_TENANTS = 64

_TERMINAL = ("done", "failed", "killed")

#: the manifests' format tag, ``durability.manager.MANIFEST_FORMAT`` (that
#: module imports torch, which the router must not)
MANIFEST_FORMAT = "graftdur-v1"


def _pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) (host twin of
    ``serve.bucket.pow2`` — that module imports the device stack)."""
    n = max(int(n), int(floor))
    p = 1
    while p < n:
        p <<= 1
    return p


def _atomic_write_json(path: str, doc: Dict[str, Any]) -> None:
    """``utils.checkpoint.atomic_write_json(path, doc, indent=2,
    sort_keys=True, default=str)``, without that module's torch import:
    a temporary file, then ``os.replace``."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    os.replace(tmp, path)


def affinity_key(spec: Dict[str, Any]) -> str:
    """The routing bucket of one ``/solve`` request: algorithm plus the
    power-of-two class of the problem's variable and constraint counts —
    the cheap, compile-free prefix of ``serve.batch.BucketKey``.  Equal
    keys co-locate (and so share captured graphs on their worker);
    unequal keys merely land in different buckets, exactly like the
    serve layer's own bucketing — correctness never depends on it.

    >>> affinity_key({"algo": "dsa", "dcop_yaml": "variables: {a: {domain: d}}"})
    'dsa/v2c1'
    """
    algo = str(spec.get("algo") or "dsa")
    try:
        # yaml.safe_load's document, through libyaml where it reads the
        # text alike (the YAML loader's choice, several times faster on a
        # large problem)
        from ..dcop.yamldcop import _safe_load

        doc = _safe_load(spec.get("dcop_yaml") or "") or {}
        n_vars = len(doc.get("variables") or {})
        n_cons = len(doc.get("constraints") or {})
    except Exception:  # noqa: BLE001 — unparseable specs still route
        return f"{algo}/v0c0"
    return f"{algo}/v{_pow2(n_vars + 1)}c{_pow2(max(n_cons, 1))}"


def _http_post(
    url: str, doc: Dict[str, Any], timeout: float = 10.0
) -> Optional[Tuple[int, Dict[str, Any]]]:
    """POST ``doc`` as JSON; ``(status, body)`` for any HTTP answer
    (including 4xx/5xx — a structured rejection is data), None on
    transport failure (the worker is unreachable)."""
    import urllib.error
    import urllib.request

    data = json.dumps(doc, default=str).encode("utf-8")
    req = urllib.request.Request(
        url,
        data=data,
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read().decode("utf-8")
            return resp.getcode(), (json.loads(body) if body else {})
    except urllib.error.HTTPError as e:
        try:
            body = e.read().decode("utf-8")
            return e.code, (json.loads(body) if body else {})
        except (OSError, ValueError):
            return e.code, {}
    except (urllib.error.URLError, OSError, ValueError, TimeoutError):
        return None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

_m_shed = metrics_registry.counter(
    "router.shed_total",
    "tenants shed by admission control, by reason and priority",
)
# workers' memory-budget refusals as the ROUTER sees them — a
# mem-refused tenant must not be retried against the same worker (the
# breach is a property of the problem's bucket, not of load), so the
# refusal is surfaced per worker for placement decisions
_m_mem_refused = metrics_registry.counter(
    "router.mem_refusals_total",
    "forwards rejected by a worker's memory guard, by worker",
)
_m_deferred = metrics_registry.counter(
    "router.deferred_total", "tenants deferred by admission control"
)
_m_released = metrics_registry.counter(
    "router.released_total", "deferred tenants released to a worker"
)
_m_forwards = metrics_registry.counter(
    "router.forwards_total", "tenant forwards accepted, per worker"
)
_m_fwd_retries = metrics_registry.counter(
    "router.forward_retries_total", "forward transport attempts retried"
)
_m_failovers = metrics_registry.counter(
    "router.failovers_total", "worker failovers handled, per worker"
)
_m_from_scratch = metrics_registry.counter(
    "router.resolve_from_scratch",
    "victim tenants re-solved from scratch on a surviving worker",
)
_m_adopted = metrics_registry.counter(
    "router.adopted_results",
    "victim tenant results adopted from durable fleet manifests",
)
_m_window_adj = metrics_registry.counter(
    "router.window_adjust_total",
    "micro-batch window retunes pushed to workers, by direction",
)
_g_admission = metrics_registry.gauge(
    "router.admission_open", "1 while no fast-burn alert gates admission"
)
_g_placeable = metrics_registry.gauge(
    "router.workers_placeable", "workers currently eligible for placement"
)
_g_tenants = metrics_registry.gauge(
    "router.tenants", "router tenant census by status"
)

#: sentinel: "use the module default scrape-retry policy"
_DEFAULT = object()


class Router:
    """SLO-driven router over a fleet of serve workers (module
    docstring).  All control-loop entry points (:meth:`tick`,
    :meth:`submit`) accept an explicit ``now`` and every transport is
    injectable, so unit tests drive the whole failure lifecycle
    deterministically with fake clocks and fake fleets."""

    def __init__(
        self,
        targets: Sequence[FleetTarget],
        port: Optional[int] = None,
        host: str = "127.0.0.1",
        placement: str = "affinity",
        interval_s: float = 0.5,
        stale_after_s: float = 10.0,
        objectives: Sequence[Objective] = (),
        router_objectives: Sequence[Objective] = (),
        fast_burn: float = DEFAULT_FAST_BURN,
        slow_burn: float = DEFAULT_SLOW_BURN,
        retry: Optional[RetryPolicy] = None,
        scrape_retry: Any = _DEFAULT,
        tenant_deadline_s: float = 120.0,
        defer_max_s: float = 15.0,
        window_base_ms: float = 25.0,
        window_max_factor: float = 4.0,
        idle_ticks_to_widen: int = 3,
        state_dir: Optional[str] = None,
        result_poll_batch: int = 64,
        clock: Callable[[], float] = time.monotonic,
        fetch: Optional[Callable[[str], Optional[Dict[str, Any]]]] = None,
        post: Optional[
            Callable[[str, Dict[str, Any]], Optional[Tuple[int, Dict[str, Any]]]]
        ] = None,
    ) -> None:
        if placement not in ("affinity", "round_robin"):
            raise ValueError(f"unknown placement strategy {placement!r}")
        self.placement = placement
        self.interval_s = max(0.05, float(interval_s))
        self.tenant_deadline_s = float(tenant_deadline_s)
        self.defer_max_s = float(defer_max_s)
        self.window_base_ms = float(window_base_ms)
        self.window_max_factor = max(1.0, float(window_max_factor))
        self.idle_ticks_to_widen = max(1, int(idle_ticks_to_widen))
        self.state_dir = state_dir
        self.result_poll_batch = max(1, int(result_poll_batch))
        #: forwards ride a RetryPolicy (infrastructure/retry.py) with the
        #: per-tenant deadline folded in — a flapping worker degrades to
        #: slow, not lost
        self.retry = retry or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=0.5, jitter="full"
        )
        self._clock = clock
        self._fetch = fetch or _http_fetch
        self._post = post or _http_post
        kwargs: Dict[str, Any] = {}
        if scrape_retry is not _DEFAULT:
            kwargs["scrape_retry"] = scrape_retry
        self.collector = FleetCollector(
            targets,
            interval_s=interval_s,
            stale_after_s=stale_after_s,
            clock=clock,
            fetch=fetch,
            **kwargs,
        )
        self._targets_by_name: Dict[str, FleetTarget] = {
            t.name: t for t in self.collector.targets
        }
        self.fleet_slo: Optional[FleetSlo] = (
            FleetSlo(
                self.collector,
                objectives,
                fast_burn=fast_burn,
                slow_burn=slow_burn,
                clock=clock,
            )
            if objectives
            else None
        )
        #: the router's OWN objectives, classified over forward outcomes
        #: (accepted = good; transport-exhausted / rejected / deadline-
        #: expired = bad) — the burn signal a worker kill produces even
        #: when the dead worker can no longer report its own slo.events
        self.engine: Optional[SloEngine] = (
            SloEngine(
                router_objectives,
                fast_burn=fast_burn,
                slow_burn=slow_burn,
                clock=clock,
                publish_metrics=True,
                # alert postmortems land next to the ownership manifest,
                # not in whatever directory the process happens to run in
                # (no state_dir -> None: the engine defaults into
                # $PYDCOP_TPU_STATE_DIR, never the cwd)
                postmortem_path=os.path.join(
                    state_dir, "router_slo_postmortem.json"
                )
                if state_dir
                else None,
            )
            if router_objectives
            else None
        )
        self._lock = threading.Lock()
        self._t0 = clock()
        self._ids = itertools.count()
        self._rr_seq = itertools.count()
        self._state = "serving"
        self._tenants: Dict[str, Dict[str, Any]] = {}
        self._events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=EVENTS_CAP
        )
        self._bucket_counts: Dict[str, int] = {}
        self._bucket_map: Dict[str, str] = {}
        self._placed_for: Tuple[str, ...] = ()
        self._suspect: set = set()
        self._was_live: Dict[str, bool] = {}
        self._idle_ticks = 0
        self._window_factor = 1.0
        self._counts: Dict[str, int] = {
            "shed": 0,
            "deferred": 0,
            "released": 0,
            "failovers": 0,
            "adopted": 0,
            "from_scratch": 0,
            "deadline_expired": 0,
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.http = None
        if port is not None:
            from ..infrastructure.ui import MetricsHttpServer

            routes: Dict[Any, Callable] = {
                ("POST", "/solve"): self._http_solve,
                ("GET", "/result"): self._http_result,
                ("GET", "/healthz"): self._http_healthz,
                ("GET", "/fleet/status"): self._http_fleet_status,
                ("POST", "/shutdown"): self._http_shutdown,
            }
            if self.fleet_slo is not None:
                routes[("GET", "/fleet/slo")] = self._http_fleet_slo
            if self.engine is not None:
                routes[("GET", "/slo")] = self._http_slo
            self.http = MetricsHttpServer(
                port=port,
                host=host,
                status_cb=self.status,
                snapshot_cb=self.snapshot,
                routes=routes,
            )

    # -- worker liveness ----------------------------------------------

    def _target(self, worker: str) -> Optional[FleetTarget]:
        return self._targets_by_name.get(worker)

    def _live_workers(
        self,
        now: Optional[float] = None,
        rows: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> List[str]:
        """Workers eligible for placement: scraped up, not draining
        (satellite: a draining worker is healthy but must not receive
        new tenants), and not suspected dead by a failed forward."""
        if rows is None:
            rows = self.collector.status(now=now)["workers"]
        with self._lock:
            suspect = set(self._suspect)
        out = []
        for name in sorted(rows):
            row = rows[name]
            if not row.get("up") or name in suspect:
                continue
            state = row.get("state")
            if state is not None and state != "serving":
                continue
            out.append(name)
        return out

    def _live_urls(self, now: Optional[float] = None) -> List[str]:
        return [
            self._targets_by_name[w].url
            for w in self._live_workers(now)
            if w in self._targets_by_name
        ]

    # -- placement (tpu_part, third use) -------------------------------

    def _compute_placement(
        self,
        buckets: Sequence[str],
        counts: Dict[str, int],
        workers: Sequence[str],
    ) -> Dict[str, str]:
        """Lay affinity buckets onto workers through the multilevel
        partitioner: one ComputationNode per bucket (same-algorithm
        buckets chain-linked so related shapes co-locate when they
        must share), equal-capacity AgentDefs per live worker — the
        exact ``distribution/tpu_part`` path that places computations
        on agents, reused verbatim for tenants on workers."""
        workers = sorted(workers)
        buckets = sorted(buckets)
        if not buckets or not workers:
            return {}
        if len(workers) == 1:
            return {b: workers[0] for b in buckets}
        try:
            from ..computations_graph.objects import (
                ComputationGraph,
                ComputationNode,
                Link,
            )
            from ..dcop.objects import AgentDef
            from ..distribution import tpu_part

            links_of: Dict[str, List[Link]] = {b: [] for b in buckets}
            by_algo: Dict[str, List[str]] = {}
            for b in buckets:
                by_algo.setdefault(b.split("/", 1)[0], []).append(b)
            for group in by_algo.values():
                for a, b in zip(group, group[1:]):
                    link = Link((a, b))
                    links_of[a].append(link)
                    links_of[b].append(link)
            graph = ComputationGraph(
                nodes=[
                    ComputationNode(b, "bucket", links=links_of[b])
                    for b in buckets
                ]
            )
            agents = [AgentDef(w, capacity=100.0) for w in workers]

            def _load(_node: Any, _neigh: str) -> float:
                return 1.0

            dist = tpu_part.distribute(
                graph, agents, communication_load=_load
            )
            return {b: dist.agent_for(b) for b in buckets}
        except Exception:  # noqa: BLE001 — placement must never drop traffic
            logger.exception(
                "tpu_part placement failed; falling back to modulo spread"
            )
            return {
                b: workers[i % len(workers)] for i, b in enumerate(buckets)
            }

    def _pick_worker(
        self, akey: str, excluded: set, now: Optional[float] = None
    ) -> Optional[str]:
        live_all = self._live_workers(now)
        live = [w for w in live_all if w not in excluded]
        if not live:
            return None
        if self.placement == "round_robin":
            with self._lock:
                i = next(self._rr_seq)
            return live[i % len(live)]
        key = tuple(sorted(live_all))
        with self._lock:
            # recompute the sticky bucket->worker map whenever the live
            # worker set or the bucket census changed under it
            if key != self._placed_for or not (
                set(self._bucket_counts) <= set(self._bucket_map)
            ):
                self._bucket_map = self._compute_placement(
                    list(self._bucket_counts),
                    dict(self._bucket_counts),
                    list(key),
                )
                self._placed_for = key
            mapped = self._bucket_map.get(akey)
        if mapped in live:
            return mapped
        # the placed worker is excluded mid-forward: stable fallback
        return live[hash(akey) % len(live)]

    # -- admission ------------------------------------------------------

    def _alerts_fast(self) -> List[str]:
        """Fast-burn alerts currently firing, across the federated
        worker objectives and the router's own forward objectives."""
        out: List[str] = []
        if self.fleet_slo is not None:
            out += [
                f"fleet:{name}"
                for name, sev in self.fleet_slo.fleet_engine.alerts_active()
                if sev == "fast"
            ]
        if self.engine is not None:
            out += [
                f"router:{name}"
                for name, sev in self.engine.alerts_active()
                if sev == "fast"
            ]
        return sorted(out)

    def admission_mode(self) -> str:
        return "shedding" if self._alerts_fast() else "open"

    def submit(
        self, spec: Dict[str, Any], now: Optional[float] = None
    ) -> Tuple[int, Dict[str, Any], Optional[Dict[str, str]]]:
        """Admit one ``/solve`` request: ``(status, payload, headers)``.

        200 = forwarded to a worker, 202 = deferred (parked router-side,
        released by the control loop), 503 = shed (structured, with
        ``Retry-After`` and the live peer list so clients can fail over
        without guessing)."""
        now = self._clock() if now is None else now
        priority = str(spec.get("priority") or "normal")
        if priority not in PRIORITIES:
            return (
                400,
                {
                    "error": f"unknown priority {priority!r} "
                    f"(expected one of {PRIORITIES})"
                },
                None,
            )
        if not spec.get("dcop_yaml"):
            return 400, {"error": "missing dcop_yaml"}, None
        trace = str(spec.get("trace") or "") or os.urandom(8).hex()
        retry_after = max(1, int(round(self.defer_max_s / 2.0)))
        with self._lock:
            state = self._state
        if state != "serving":
            return (
                503,
                {
                    "error": f"router is {state}: not accepting tenants",
                    "state": state,
                    "retry_after_s": retry_after,
                    "peers": self._live_urls(now),
                },
                {"Retry-After": str(retry_after)},
            )
        akey = affinity_key(spec)
        alerts = self._alerts_fast()
        with self._lock:
            tid = str(spec.get("tenant") or "") or (
                f"r{next(self._ids)}-{os.urandom(3).hex()}"
            )
            if tid in self._tenants:
                return 409, {"error": f"tenant id {tid!r} already known"}, None
            if alerts and priority == "low":
                self._counts["shed"] += 1
            else:
                body = {
                    k: spec[k]
                    for k in ("dcop_yaml", "algo", "params", "n_cycles", "seed")
                    if k in spec
                }
                self._tenants[tid] = {
                    "spec": body,
                    "priority": priority,
                    "akey": akey,
                    "trace": trace,
                    "status": "deferred",
                    # claimed by the submitting thread: the control
                    # loop's flush must not race the synchronous
                    # placement below, or the same tenant gets POSTed
                    # to a worker twice
                    "placing": True,
                    "worker": None,
                    "force": False,
                    "submitted_s": now,
                    "deadline_s": now + self.tenant_deadline_s,
                    "history": [],
                }
                self._bucket_counts[akey] = (
                    self._bucket_counts.get(akey, 0) + 1
                )
        if alerts and priority == "low":
            _m_shed.inc(reason="fast-burn", priority=priority)
            self._event(
                now, "shed",
                tenant=tid, priority=priority, reason="fast-burn",
                alerts=alerts,
            )
            return (
                503,
                {
                    "error": "admission shed: fast-burn alert active",
                    "shed": True,
                    "tenant": tid,
                    "reason": "fast-burn",
                    "priority": priority,
                    "alerts": alerts,
                    "retry_after_s": retry_after,
                    "peers": self._live_urls(now),
                },
                {"Retry-After": str(retry_after)},
            )
        if alerts and priority == "normal":
            with self._lock:
                self._counts["deferred"] += 1
                self._tenants[tid]["placing"] = False
            _m_deferred.inc(reason="fast-burn", priority=priority)
            self._event(
                now, "defer",
                tenant=tid, priority=priority, reason="fast-burn",
                alerts=alerts,
            )
            return (
                202,
                {
                    "tenant": tid,
                    "trace": trace,
                    "deferred": True,
                    "reason": "fast-burn",
                },
                None,
            )
        placed = self._forward(tid, now)
        with self._lock:
            rec = self._tenants.get(tid)
            if rec is not None:
                rec["placing"] = False
        if placed:
            with self._lock:
                worker = self._tenants[tid].get("worker")
            return 200, {"tenant": tid, "trace": trace, "worker": worker}, None
        with self._lock:
            self._counts["deferred"] += 1
        _m_deferred.inc(reason="no-worker", priority=priority)
        self._event(
            now, "defer", tenant=tid, priority=priority, reason="no-worker"
        )
        return (
            202,
            {
                "tenant": tid,
                "trace": trace,
                "deferred": True,
                "reason": "no-worker",
            },
            None,
        )

    # -- forwarding -----------------------------------------------------

    def _forward(self, tid: str, now: float) -> bool:
        """Place + forward one parked tenant; False leaves it deferred
        (no live worker, or every candidate failed)."""
        excluded: set = set()
        for _ in range(len(self.collector.targets)):
            with self._lock:
                rec = self._tenants.get(tid)
                if rec is None or rec["status"] not in ("deferred",):
                    return rec is not None and rec["status"] == "forwarded"
                akey = rec["akey"]
            worker = self._pick_worker(akey, excluded, now)
            if worker is None:
                return False
            ok, answered = self._post_solve(worker, tid, now)
            if ok:
                return True
            excluded.add(worker)
            if not answered:
                # transport exhausted: treat the worker as down and
                # rescue whatever else it owned (failed forward is one
                # of the two failover triggers)
                self._note_suspect(worker, now, reason="failed-forward")
        return False

    def _post_solve(
        self, worker: str, tid: str, now: float
    ) -> Tuple[bool, bool]:
        """One worker's forward attempt loop under the RetryPolicy:
        ``(accepted, answered)``.  ``answered`` False means transport
        death (every attempt failed to reach the worker)."""
        target = self._target(worker)
        if target is None:
            return False, True
        with self._lock:
            rec = self._tenants.get(tid)
            if rec is None:
                return False, True
            body = dict(rec["spec"])
            body["tenant"] = tid
            body["trace"] = rec["trace"]
            deadline_left = rec["deadline_s"] - now
        if deadline_left <= 0:
            return False, True
        policy = replace(
            self.retry,
            deadline=(
                min(self.retry.deadline, deadline_left)
                if self.retry.deadline is not None
                else deadline_left
            ),
        )
        started = policy.start()
        t_fwd = self._clock()
        attempt = 0
        while True:
            res = self._post(target.url + "/solve", body)
            if res is not None:
                code, doc = res
                if code == 200:
                    with self._lock:
                        rec = self._tenants.get(tid)
                        if rec is not None:
                            rec["status"] = "forwarded"
                            rec["worker"] = worker
                            rec["history"].append(
                                {
                                    "t": round(now - self._t0, 3),
                                    "event": "forward",
                                    "worker": worker,
                                }
                            )
                    _m_forwards.inc(worker=worker)
                    self._slo_record(tid, "done", self._clock() - t_fwd)
                    return True, True
                # an ANSWERED rejection (draining worker's structured
                # 503, bad request): no point retrying the same worker
                self._slo_record(tid, "failed", self._clock() - t_fwd)
                mem = (doc or {}).get("mem")
                if mem:
                    # a memory-guard refusal: keep the breach on the tenant
                    # record (visible in /fleet/status detail) and count
                    # it per worker — the structured error distinguishes
                    # "will never fit this worker" from "busy"
                    _m_mem_refused.inc(worker=worker)
                    with self._lock:
                        rec = self._tenants.get(tid)
                        if rec is not None:
                            rec["mem_refusal"] = mem
                self._event(
                    now, "forward-rejected",
                    tenant=tid, worker=worker, code=code,
                    state=(doc or {}).get("state"),
                    **({"mem_reason": mem.get("reason")} if mem else {}),
                )
                return False, True
            attempt += 1
            _m_fwd_retries.inc(worker=worker)
            if not policy.sleep_before_retry(attempt - 1, started):
                break
        self._slo_record(tid, "failed", self._clock() - t_fwd)
        return False, False

    def _slo_record(self, tenant: str, status: str, latency_s: float) -> None:
        if self.engine is not None:
            self.engine.record_request(tenant, status, latency_s)

    # -- failover -------------------------------------------------------

    def _note_suspect(self, worker: str, now: float, reason: str) -> None:
        with self._lock:
            fresh = worker not in self._suspect
            self._suspect.add(worker)
        if fresh:
            self._event(now, "worker-suspect", worker=worker, reason=reason)
            self._failover(worker, now, reason=reason)

    def _check_workers(self, now: float) -> None:
        """Walk the collector's up/down view: clear suspicions the
        scrape refutes, fail over workers the scrape says died."""
        rows = self.collector.status(now=now)["workers"]
        downs: List[str] = []
        with self._lock:
            for name in sorted(rows):
                up = bool(rows[name].get("up"))
                if up and name in self._suspect:
                    self._suspect.discard(name)
                was = self._was_live.get(name)
                self._was_live[name] = up
                if was and not up:
                    downs.append(name)
        for name in downs:
            self._failover(name, now, reason="scrape-down")

    def _failover(self, victim: str, now: float, reason: str) -> None:
        """Re-admit the victim's non-terminal tenants onto survivors.
        Terminal results in the victim's durable fleet manifest are
        adopted (never re-run); the rest re-solve from scratch with
        their original seeds — bit-identical, a batched tenant keeping
        the bits of its solo solve."""
        with self._lock:
            victims = [
                tid
                for tid, rec in self._tenants.items()
                if rec["status"] == "forwarded" and rec.get("worker") == victim
            ]
            for tid in victims:
                # claim atomically: a concurrent failover of the same
                # worker (scrape flip + failed forward racing) must not
                # rescue a tenant twice
                self._tenants[tid]["status"] = "failing-over"
            if victims:
                self._counts["failovers"] += 1
        if not victims:
            return
        _m_failovers.inc(worker=victim)
        self._event(
            now, "failover", worker=victim, reason=reason,
            tenants=len(victims),
        )
        manifest = self._manifest_tenants(victim)
        rescued: List[str] = []
        for tid in sorted(victims):
            row = manifest.get(tid)
            with self._lock:
                rec = self._tenants.get(tid)
                if rec is None or rec["status"] != "failing-over":
                    continue
                if row and row.get("status") in _TERMINAL:
                    # ownership transfer recorded; the tenant is NOT
                    # solved twice — the manifest result IS the solve
                    rec["status"] = row["status"]
                    result = dict(row)
                    result["tenant"] = tid
                    result["result_source"] = "manifest"
                    result["owner"] = victim
                    rec["result"] = result
                    rec["history"].append(
                        {
                            "t": round(now - self._t0, 3),
                            "event": "adopt",
                            "from": victim,
                        }
                    )
                    self._counts["adopted"] += 1
                    adopted = True
                else:
                    rec["status"] = "deferred"
                    rec["worker"] = None
                    rec["force"] = True
                    rec["history"].append(
                        {
                            "t": round(now - self._t0, 3),
                            "event": "resolve-from-scratch",
                            "from": victim,
                        }
                    )
                    self._counts["from_scratch"] += 1
                    adopted = False
            if adopted:
                _m_adopted.inc()
                self._event(now, "adopt", tenant=tid, worker=victim)
            else:
                _m_from_scratch.inc()
                rescued.append(tid)
        for tid in rescued:
            self._forward(tid, now)
        self._write_manifest()

    def _manifest_tenants(self, worker: str) -> Dict[str, Any]:
        """The victim's freshest ``fleet-manifest.json`` tenant
        census (empty when no state dir / no matching manifest)."""
        if not self.state_dir:
            return {}
        target = self._target(worker)
        url = target.url.rstrip("/") if target is not None else None
        best_t = -1.0
        tenants: Dict[str, Any] = {}
        candidates = [os.path.join(self.state_dir, "fleet-manifest.json")]
        try:
            entries = sorted(os.listdir(self.state_dir))
        except OSError:
            entries = []
        candidates += [
            os.path.join(self.state_dir, e, "fleet-manifest.json")
            for e in entries
        ]
        for path in candidates:
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if doc.get("kind") != "fleet":
                continue
            endpoint = str(doc.get("endpoint") or "").rstrip("/")
            if not (
                (url and endpoint == url) or doc.get("worker") == worker
            ):
                continue
            t = float(doc.get("wrote_unix_s") or 0.0)
            if t > best_t:
                best_t = t
                tenants = doc.get("tenants") or {}
        return tenants

    # -- the control loop ----------------------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        """One control-loop step: scrape, evaluate burn, react.
        Deterministic when driven with an explicit ``now``."""
        now = self._clock() if now is None else now
        self.collector.poll(now=now)
        if self.fleet_slo is not None:
            self.fleet_slo.evaluate(now)
        if self.engine is not None:
            self.engine.evaluate(now)
        self._check_workers(now)
        self._poll_results(now)
        self._expire_deadlines(now)
        self._flush_deferred(now)
        self._tune_windows(now)
        self._publish_gauges(now)

    def _poll_results(self, now: float) -> None:
        """Pull terminal results for forwarded tenants into the router's
        own cache (bounded batch per tick) — after this, a worker death
        cannot lose a result the fleet already produced."""
        with self._lock:
            pending = [
                (tid, rec["worker"])
                for tid, rec in self._tenants.items()
                if rec["status"] == "forwarded" and rec.get("worker")
            ]
        for tid, worker in pending[: self.result_poll_batch]:
            target = self._target(worker)
            if target is None:
                continue
            doc = self._fetch(f"{target.url}/result/{tid}")
            if not doc:
                continue
            st = doc.get("status")
            if st not in _TERMINAL:
                continue
            with self._lock:
                rec = self._tenants.get(tid)
                if rec is None or rec["status"] != "forwarded":
                    continue
                rec["status"] = st
                result = dict(doc)
                result.setdefault("result_source", "worker")
                rec["result"] = result
                rec["history"].append(
                    {
                        "t": round(now - self._t0, 3),
                        "event": "complete",
                        "worker": worker,
                        "status": st,
                    }
                )

    def _expire_deadlines(self, now: float) -> None:
        with self._lock:
            expired = [
                tid
                for tid, rec in self._tenants.items()
                if rec["status"] in ("deferred", "forwarded")
                and now >= rec["deadline_s"]
            ]
            for tid in expired:
                rec = self._tenants[tid]
                rec["status"] = "failed"
                rec["error"] = "deadline exceeded"
                rec["history"].append(
                    {"t": round(now - self._t0, 3), "event": "deadline"}
                )
                self._counts["deadline_expired"] += 1
        for tid in expired:
            self._event(now, "deadline-expired", tenant=tid)
            self._slo_record(tid, "failed", self.tenant_deadline_s)

    def _flush_deferred(self, now: float, force: bool = False) -> None:
        """Release parked tenants: always when admission is open or the
        tenant is high priority / a failover rescue; normal-priority
        holds are bounded by ``defer_max_s`` even under sustained burn
        (deferred means slow, never lost)."""
        mode = self.admission_mode()
        with self._lock:
            ready = []
            for tid, rec in self._tenants.items():
                if rec["status"] != "deferred" or rec.get("placing"):
                    continue
                if (
                    force
                    or rec.get("force")
                    or mode == "open"
                    or rec["priority"] == "high"
                    or (
                        rec["priority"] == "normal"
                        and now - rec["submitted_s"] >= self.defer_max_s
                    )
                ):
                    ready.append(tid)
        for tid in ready:
            if self._forward(tid, now):
                with self._lock:
                    self._counts["released"] += 1
                _m_released.inc()

    def _tune_windows(self, now: float) -> None:
        """Widen the workers' micro-batch windows when the fleet idles
        (batch occupancy for free), narrow back to base the moment
        queues build or an alert fires."""
        rows = self.collector.status(now=now)["workers"]
        live = self._live_workers(now, rows=rows)
        qsum = sum(int(rows[w].get("queue_depth") or 0) for w in live)
        alerting = bool(self._alerts_fast())
        direction = None
        with self._lock:
            if alerting or qsum > 0:
                self._idle_ticks = 0
                if self._window_factor > 1.0:
                    self._window_factor = 1.0
                    direction = "narrow"
            else:
                self._idle_ticks += 1
                if (
                    self._idle_ticks >= self.idle_ticks_to_widen
                    and self._window_factor < self.window_max_factor
                ):
                    self._window_factor = min(
                        self.window_max_factor, self._window_factor * 2.0
                    )
                    self._idle_ticks = 0
                    direction = "widen"
            window_ms = self.window_base_ms * self._window_factor
        if direction is None:
            return
        _m_window_adj.inc(direction=direction)
        self._event(
            now, "window-adjust",
            direction=direction, window_ms=round(window_ms, 2),
        )
        for w in live:
            target = self._target(w)
            if target is not None:
                self._post(target.url + "/window", {"window_ms": window_ms})

    def _publish_gauges(self, now: float) -> None:
        if not metrics_registry.enabled:
            return
        with self._lock:
            counts: Dict[str, int] = {}
            for rec in self._tenants.values():
                counts[rec["status"]] = counts.get(rec["status"], 0) + 1
        for st, n in counts.items():
            _g_tenants.set(float(n), status=st)
        _g_placeable.set(float(len(self._live_workers(now))))
        _g_admission.set(0.0 if self._alerts_fast() else 1.0)

    def _event(self, now: float, kind: str, **fields: Any) -> None:
        ev = {"t": round(now - self._t0, 3), "event": kind, **fields}
        with self._lock:
            self._events.append(ev)
        logger.warning(
            "router-event %s", json.dumps(ev, sort_keys=True, default=str)
        )

    # -- public read surface --------------------------------------------

    def result(self, tenant: str) -> Dict[str, Any]:
        """One tenant's record: the router's cached terminal result when
        it has one, a live proxy to the owning worker otherwise."""
        with self._lock:
            rec = self._tenants.get(tenant)
            if rec is None:
                return {"tenant": tenant, "status": "unknown"}
            if rec.get("result") is not None:
                out = dict(rec["result"])
                out["tenant"] = tenant
                out["status"] = rec["status"]
                out["priority"] = rec["priority"]
                out["history"] = list(rec["history"])
                return out
            st = rec["status"]
            worker = rec.get("worker")
            out = {
                "tenant": tenant,
                "status": st,
                "priority": rec["priority"],
            }
            if "error" in rec:
                out["error"] = rec["error"]
            if "mem_refusal" in rec:
                out["mem_refusal"] = rec["mem_refusal"]
        if st == "forwarded" and worker:
            target = self._target(worker)
            doc = (
                self._fetch(f"{target.url}/result/{tenant}")
                if target is not None
                else None
            )
            if doc:
                doc = dict(doc)
                doc["worker"] = worker
                return doc
            out["worker"] = worker
        return out

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = self._clock() if now is None else now
        fleet = self.collector.status(now=now)
        alerts = self._alerts_fast()
        with self._lock:
            rows: Dict[str, Dict[str, Any]] = {}
            for tid, rec in list(self._tenants.items())[-STATUS_TENANTS:]:
                row = {
                    "status": rec["status"],
                    "priority": rec["priority"],
                    "bucket": rec["akey"],
                }
                if rec.get("worker"):
                    row["worker"] = rec["worker"]
                res = rec.get("result") or {}
                for k in ("cost", "best_cost", "cycles", "queue_ms"):
                    if k in res:
                        row[k] = res[k]
                if "error" in rec:
                    row["error"] = rec["error"]
                rows[tid] = row
            counts: Dict[str, int] = {}
            for rec in self._tenants.values():
                counts[rec["status"]] = counts.get(rec["status"], 0) + 1
            out: Dict[str, Any] = {
                "status": "router",
                "state": self._state,
                "placement": {
                    "strategy": self.placement,
                    "buckets": dict(self._bucket_map),
                    "bucket_counts": dict(self._bucket_counts),
                },
                "admission": {"mode": (
                    "shedding" if alerts else "open"
                ), "alerts": alerts, **dict(self._counts)},
                "window": {
                    "base_ms": self.window_base_ms,
                    "factor": self._window_factor,
                },
                "tenants": rows,
                "tenant_counts": counts,
                "events": list(self._events)[-32:],
            }
        out["workers"] = fleet["workers"]
        out["workers_total"] = fleet["workers_total"]
        out["workers_up"] = fleet["workers_up"]
        out["fleet"] = fleet["fleet"]
        if self.fleet_slo is not None:
            out["slo"] = self.fleet_slo.status_block()
        if self.engine is not None:
            out["router_slo"] = self.engine.status_block()
        return out

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The /metrics.json document: the federated worker registry
        plus the fleet SLO series plus the router's OWN local series
        (``router.*``, its forward-objective ``slo.*``) re-labeled
        ``worker="router"`` so nothing collides with a worker series."""
        snap = self.collector.snapshot(now=now)
        if self.fleet_slo is not None:
            snap["metrics"].update(self.fleet_slo.metrics_block())
        local = metrics_registry.snapshot().get("metrics", {})
        for name, m in sorted(local.items()):
            dst = snap["metrics"].setdefault(
                name,
                {"kind": m.get("kind"), "help": m.get("help", ""), "values": []},
            )
            if dst.get("kind") != m.get("kind"):
                continue
            for entry in m.get("values", []):
                labels = dict(entry.get("labels") or {})
                labels["worker"] = "router"
                dst["values"].append(
                    {"labels": labels, "value": entry.get("value")}
                )
        return snap

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        """Spawn the background control loop (idempotent)."""
        self._stop.clear()
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, name="router-loop", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("router tick failed")
            self._stop.wait(self.interval_s)

    def stop_loop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)

    def drain(self, timeout: float = 60.0) -> bool:
        """Graceful shutdown: stop admitting, flush every parked tenant,
        wait for the in-flight ones to reach a terminal state, record
        the ownership manifest.  True when nothing was left pending."""
        with self._lock:
            self._state = "draining"
        self._event(self._clock(), "drain-start")
        self.stop_loop()
        deadline = time.monotonic() + timeout
        pending = 0
        while time.monotonic() < deadline:
            try:
                self.tick()
                self._flush_deferred(self._clock(), force=True)
            except Exception:  # noqa: BLE001
                logger.exception("drain tick failed")
            with self._lock:
                pending = sum(
                    1
                    for rec in self._tenants.values()
                    if rec["status"]
                    in ("deferred", "forwarded", "failing-over")
                )
            if pending == 0:
                break
            time.sleep(min(self.interval_s, 0.25))
        ok = pending == 0
        with self._lock:
            self._state = "drained" if ok else "drain-timeout"
        self._event(self._clock(), "drain-done", drained=ok, pending=pending)
        self._write_manifest()
        return ok

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> bool:
        ok = self.drain(timeout) if drain else True
        if not drain:
            self.stop_loop()
        self.collector.stop()
        if self.http is not None:
            self.http.shutdown()
        return ok

    def _write_manifest(self) -> None:
        """The router's durable ownership record (``kind: router``):
        every tenant's status, owner and transfer history, so an
        operator can always answer 'who solved tenant X'."""
        if not self.state_dir:
            return
        with self._lock:
            tenants = {
                tid: {
                    "status": rec["status"],
                    "priority": rec["priority"],
                    "bucket": rec["akey"],
                    "worker": rec.get("worker"),
                    "history": list(rec["history"]),
                }
                for tid, rec in self._tenants.items()
            }
            doc = {
                "format": MANIFEST_FORMAT,
                "kind": "router",
                "wrote_unix_s": time.time(),
                "state": self._state,
                "placement": {
                    "strategy": self.placement,
                    "buckets": dict(self._bucket_map),
                },
                "admission": dict(self._counts),
                "tenants": tenants,
            }
        try:
            os.makedirs(self.state_dir, exist_ok=True)
            _atomic_write_json(
                os.path.join(self.state_dir, "router-manifest.json"), doc
            )
        except OSError:
            logger.exception("router manifest write failed")

    # -- HTTP routes ----------------------------------------------------

    def _http_solve(self, path: str, body: bytes):
        spec = json.loads(body.decode("utf-8"))
        code, payload, headers = self.submit(spec)
        if headers:
            return code, payload, headers
        return code, payload

    def _http_result(self, path: str, body: bytes):
        tenant = path.rsplit("/", 1)[-1]
        rec = self.result(tenant)
        return (404 if rec.get("status") == "unknown" else 200), rec

    def _http_healthz(self, path: str, body: bytes):
        with self._lock:
            state = self._state
        return (200 if state == "serving" else 503), {"state": state}

    def _http_fleet_status(self, path: str, body: bytes):
        return 200, self.status()

    def _http_fleet_slo(self, path: str, body: bytes):
        return 200, self.fleet_slo.status_block()

    def _http_slo(self, path: str, body: bytes):
        return 200, self.engine.report()

    def _http_shutdown(self, path: str, body: bytes):
        threading.Thread(
            target=self.shutdown, kwargs={"drain": True}, daemon=True
        ).start()
        return 200, {"state": "draining"}
