"""Multi-worker metrics federation, fleet SLOs and worker health.

The port's own copy of ``pydcop_tpu/telemetry/federate.py``: the same
merge, the same reset rules and the same documents, so a collector of
either package scraping the same workers publishes the same snapshot.
:class:`FleetCollector` polls N worker endpoints (``/metrics.json`` and
``/status``) on an interval and merges them into one **federated
snapshot**, in the document shape of ``MetricsRegistry.snapshot()``, so
``prom.render_prometheus``, the ``telemetry --prom`` converter and every
other snapshot consumer work on it unchanged.

Merge semantics:

- **labeling** — every scraped series gains a ``worker=<name>`` label;
  the worker name comes from the target source (CLI ``NAME=URL`` pairs,
  a YAML fleet file, or the serve workers' ``fleet-manifest.json``
  endpoints).
- **counter monotonicity** — counters get per-worker, per-series reset
  detection: a raw value falling below the previous sample means the
  worker restarted, so the previous value is folded into a cumulative
  offset and the published series keeps rising.  A fleet total summed
  over workers therefore never jumps backwards through a restart.
  Histograms get the same treatment elementwise (bucket counts, sum,
  count).  Resets are counted in ``fleet.counter_resets_total``.
- **staleness** — a scrape gets a small bounded in-sweep retry
  (``infrastructure/retry.py`` RetryPolicy, 2 jittered attempts by
  default) before the sweep counts as failed, so ONE dropped connection
  never flips ``fleet.worker_up`` — with an HA router acting on that
  flip, a flap would otherwise trigger a spurious failover.  A worker
  whose sweep still fails after the retry is marked down on that same
  sweep (``fleet.worker_up{worker} = 0`` — real deaths are detected at
  poll latency, not N·poll), and its last-known series keep being
  served only until ``stale_after_s``; past that they are DROPPED from
  the snapshot rather than silently served forever.
  ``fleet.scrape_age_seconds{worker}`` always tells how old a worker's
  data is, ``fleet.scrape_retries_total{worker}`` how flappy its
  transport has been.
- **meta-series** — ``fleet.worker_up``, ``fleet.scrape_age_seconds``,
  ``fleet.scrapes_total``, ``fleet.scrape_failures_total``,
  ``fleet.counter_resets_total``, ``fleet.workers`` /
  ``fleet.workers_up``, and ``fleet.worker_solves_total`` (a monotone
  counter derived from each worker's ``/status`` solve count, so
  ``watch --fleet`` can compute solves/s from counter deltas with the
  same clamp-on-reset rule).

:class:`FleetSlo` evaluates the SAME objective grammar and SRE
multiwindow burn rates (``telemetry/slo.py``) over the federated
``slo.events`` — one :class:`~pydcop_tpu_torch.telemetry.slo.SloEngine`
per worker plus one fleet-aggregate engine, each fed through the
pluggable ``counter_source`` hook — and annotates fleet alert
transitions with the **worst worker** (highest fast-window burn at trip
time).

Deterministic on purpose: ``poll(now=...)`` / ``evaluate(now=...)`` take
explicit clocks and the fetcher is injectable, so tests drive the whole
plane against fake endpoints without sleeping.  Stdlib only, like
``telemetry.metrics``: the host-only ``fleet``, ``router`` and ``watch``
verbs import it without torch.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

from ..infrastructure.retry import RetryPolicy
from .slo import (
    DEFAULT_FAST_BURN,
    DEFAULT_SLOW_BURN,
    Objective,
    SloEngine,
)

__all__ = [
    "FleetCollector",
    "FleetSlo",
    "FleetTarget",
    "clamped_rate",
    "default_scrape_retry",
    "targets_from_args",
    "targets_from_fleet_file",
    "targets_from_manifest",
]

logger = logging.getLogger("pydcop_tpu_torch.telemetry.federate")

LabelKey = Tuple[Tuple[str, str], ...]

#: sentinel: "build the default scrape-retry policy" (pass
#: ``scrape_retry=None`` to disable retries entirely)
_DEFAULT_SCRAPE_RETRY = object()


def default_scrape_retry() -> RetryPolicy:
    """The bounded in-sweep scrape retry: 2 attempts, tiny jittered
    backoff — enough to ride out one dropped connection, small enough
    that a real death still flips ``fleet.worker_up`` on the same
    sweep."""
    return RetryPolicy(
        max_attempts=2, base_delay=0.05, max_delay=0.2, jitter="full"
    )


class FleetTarget(NamedTuple):
    """One worker endpoint: a stable name (becomes the ``worker`` label)
    and the base URL of its live metrics surface."""

    name: str
    url: str


def clamped_rate(prev: float, cur: float, dt: float) -> float:
    """Per-second rate from two cumulative counter samples, clamped at 0
    when the counter went BACKWARDS (worker restart): the reset sample
    contributes no rate and the next delta re-baselines from the new
    origin.  Shared by ``watch`` and the collector so the two surfaces
    can never disagree on what a rate across a restart means."""
    if dt <= 0:
        return 0.0
    return max(0.0, cur - prev) / dt


# ---------------------------------------------------------------------------
# target sources
# ---------------------------------------------------------------------------


def _norm_url(url: str) -> str:
    url = url.strip().rstrip("/")
    if not url.startswith(("http://", "https://")):
        url = "http://" + url
    return url


def _default_name(url: str) -> str:
    """host:port of the URL — the stable worker name when none given."""
    rest = url.split("://", 1)[-1]
    return rest.split("/", 1)[0]


def targets_from_args(specs: Sequence[str]) -> List[FleetTarget]:
    """Targets from CLI positionals: ``URL`` or ``NAME=URL`` each."""
    out: List[FleetTarget] = []
    for spec in specs:
        if "=" in spec.split("://", 1)[0]:
            name, url = spec.split("=", 1)
            out.append(FleetTarget(name.strip(), _norm_url(url)))
        else:
            url = _norm_url(spec)
            out.append(FleetTarget(_default_name(url), url))
    return out


def targets_from_fleet_file(path: str) -> List[FleetTarget]:
    """Targets from a YAML fleet file::

        workers:
          w0: http://127.0.0.1:9010
          w1: {url: "http://127.0.0.1:9011"}

    or a list of ``URL`` strings / ``{name, url}`` mappings."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f)
    if not isinstance(data, dict) or "workers" not in data:
        raise ValueError(f"{path}: fleet file needs a 'workers' section")
    workers = data["workers"]
    out: List[FleetTarget] = []
    if isinstance(workers, dict):
        for name, v in workers.items():
            url = v["url"] if isinstance(v, dict) else v
            out.append(FleetTarget(str(name), _norm_url(str(url))))
    elif isinstance(workers, list):
        for i, v in enumerate(workers):
            if isinstance(v, dict):
                url = _norm_url(str(v["url"]))
                out.append(FleetTarget(str(v.get("name") or f"w{i}"), url))
            else:
                url = _norm_url(str(v))
                out.append(FleetTarget(_default_name(url), url))
    else:
        raise ValueError(f"{path}: 'workers' must be a mapping or list")
    return out


def targets_from_manifest(path: str) -> List[FleetTarget]:
    """Targets from the serve workers' fleet manifests: ``path`` is one
    ``fleet-manifest.json`` or a directory searched for
    ``fleet-manifest.json`` / ``*/fleet-manifest.json``.  Serve workers
    record their scrape ``endpoint`` in the manifest on every graceful
    drain (serve/server.py), so a fleet that checkpoints into a shared
    state directory is its own service registry.  Manifests without an
    endpoint (a server without an HTTP front) are skipped with a log
    line."""
    import glob
    import os

    if os.path.isdir(path):
        paths = sorted(
            glob.glob(os.path.join(path, "fleet-manifest.json"))
            + glob.glob(os.path.join(path, "*", "fleet-manifest.json"))
        )
    else:
        paths = [path]
    out: List[FleetTarget] = []
    for p in paths:
        try:
            with open(p, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("fleet manifest %s unreadable: %s", p, e)
            continue
        endpoint = doc.get("endpoint")
        if not endpoint:
            logger.warning(
                "fleet manifest %s records no endpoint — skipped", p
            )
            continue
        url = _norm_url(str(endpoint))
        name = str(doc.get("worker") or _default_name(url))
        out.append(FleetTarget(name, url))
    if not out:
        raise ValueError(
            f"{path}: no fleet manifest with a worker endpoint found"
        )
    return out


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------


def _http_fetch(url: str, timeout: float = 2.0) -> Optional[Dict[str, Any]]:
    """GET ``url`` as JSON; None on any transport/decode failure (a dead
    worker is data, not an exception)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except (urllib.error.URLError, OSError, ValueError, TimeoutError):
        return None


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class FleetCollector:
    """Polls worker endpoints and merges them into a federated snapshot.

    ``fetch(url) -> dict | None`` is injectable (tests run against fake
    endpoints); the default does an HTTP GET with a short timeout.
    :meth:`poll` is one synchronous sweep — deterministic when driven
    with an explicit ``now`` — and :meth:`start` spawns the background
    loop the ``fleet`` verb runs (poll, then the optional ``on_tick``
    callback, every ``interval_s``)."""

    def __init__(
        self,
        targets: Sequence[FleetTarget],
        interval_s: float = 1.0,
        stale_after_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        fetch: Optional[Callable[[str], Optional[Dict[str, Any]]]] = None,
        scrape_retry: Any = _DEFAULT_SCRAPE_RETRY,
    ) -> None:
        names = [t.name for t in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker names in {names}")
        if not targets:
            raise ValueError("fleet collector needs at least one target")
        self.targets: Tuple[FleetTarget, ...] = tuple(targets)
        self.interval_s = max(0.05, float(interval_s))
        self.stale_after_s = float(stale_after_s)
        self._clock = clock
        self._fetch = fetch or _http_fetch
        #: bounded in-sweep retry before a scrape counts as failed
        #: (None disables — every transport error is an instant down)
        self.scrape_retry: Optional[RetryPolicy] = (
            default_scrape_retry()
            if scrape_retry is _DEFAULT_SCRAPE_RETRY
            else scrape_retry
        )
        self._lock = threading.Lock()
        #: per-worker scrape state: last raw metrics + status docs, the
        #: up flag, scrape bookkeeping and the solves rate sample
        self._workers: Dict[str, Dict[str, Any]] = {
            t.name: {
                "url": t.url,
                "up": False,
                "last_ok": None,
                "scrapes": 0,
                "failures": 0,
                "retries": 0,
                "resets": 0,
                "metrics": None,
                "status": None,
                "solves_mono": 0.0,  # monotone solves (offset applied)
                "solves_raw": None,  # last raw /status solves sample
                "solves_prev": None,  # (t, monotone) of previous poll
                "solves_rate": None,
            }
            for t in self.targets
        }
        #: (metric, worker, labelkey) -> {"last": raw, "offset": float}
        #: — the counter reset-detection state
        self._counter_state: Dict[Tuple[str, str, LabelKey], Dict[str, Any]] = {}
        #: same, for histograms: last/offset per (buckets, sum, count)
        self._hist_state: Dict[Tuple[str, str, LabelKey], Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- polling -------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> None:
        """One sweep over every target: fetch ``/metrics.json`` +
        ``/status`` (with the bounded scrape retry), update per-series
        counter offsets, mark up/down."""
        now = self._clock() if now is None else now
        for t in self.targets:
            metrics, status, retried = self._scrape(t)
            with self._lock:
                w = self._workers[t.name]
                w["scrapes"] += 1
                w["retries"] += retried
                if metrics is None or status is None:
                    w["failures"] += 1
                    w["up"] = False
                    continue
                w["up"] = True
                w["last_ok"] = now
                w["metrics"] = metrics.get("metrics", {})
                w["status"] = status
                self._absorb_counters(t.name, w["metrics"])
                self._absorb_solves(t.name, w, status, now)

    def _scrape(
        self, t: FleetTarget
    ) -> Tuple[Optional[Dict[str, Any]], Optional[Dict[str, Any]], int]:
        """One worker's scrape with the bounded in-sweep retry:
        ``(metrics, status, retried_attempts)``.  A transient drop is
        retried under the RetryPolicy BEFORE the sweep reports failure
        (and before ``fleet.worker_up`` flips — a flip now means the
        worker really was unreachable ``max_attempts`` times in a row);
        a healthy worker costs exactly the two fetches it always did."""
        policy = self.scrape_retry
        started = policy.start() if policy is not None else 0.0
        attempt = 0
        while True:
            metrics = self._fetch(t.url + "/metrics.json")
            status = self._fetch(t.url + "/status")
            if metrics is not None and status is not None:
                return metrics, status, attempt
            if policy is None or not policy.sleep_before_retry(
                attempt, started
            ):
                return metrics, status, attempt
            attempt += 1

    def _absorb_counters(
        self, worker: str, metrics: Dict[str, Any]
    ) -> None:
        """Update reset-detection state from one scrape (lock held)."""
        w = self._workers[worker]
        for name, m in metrics.items():
            kind = m.get("kind")
            if kind == "counter":
                for entry in m.get("values", []):
                    key = (name, worker, _label_key(entry.get("labels", {})))
                    raw = float(entry.get("value", 0.0))
                    st = self._counter_state.setdefault(
                        key, {"last": 0.0, "offset": 0.0}
                    )
                    if raw < st["last"]:
                        # worker restarted: fold the pre-restart total
                        # into the offset so the published series keeps
                        # rising through the reset
                        st["offset"] += st["last"]
                        w["resets"] += 1
                    st["last"] = raw
            elif kind == "histogram":
                for entry in m.get("values", []):
                    v = entry.get("value") or {}
                    key = (name, worker, _label_key(entry.get("labels", {})))
                    buckets = [float(b) for b in v.get("buckets", [])]
                    cnt = float(v.get("count", 0))
                    st = self._hist_state.setdefault(
                        key,
                        {
                            "last": ([], 0.0, 0.0),
                            "offset": ([0.0] * len(buckets), 0.0, 0.0),
                        },
                    )
                    lb, ls, lc = st["last"]
                    ob, os_, oc = st["offset"]
                    if len(ob) < len(buckets):
                        ob = ob + [0.0] * (len(buckets) - len(ob))
                    if cnt < lc:
                        ob = [
                            o + p
                            for o, p in zip(
                                ob, lb + [0.0] * (len(ob) - len(lb))
                            )
                        ]
                        os_ += ls
                        oc += lc
                        w["resets"] += 1
                    st["last"] = (buckets, float(v.get("sum", 0.0)), cnt)
                    st["offset"] = (ob, os_, oc)

    def _absorb_solves(
        self,
        worker: str,
        w: Dict[str, Any],
        status: Dict[str, Any],
        now: float,
    ) -> None:
        """Derive the monotone ``fleet.worker_solves_total`` sample and
        the solves/s rate from the worker's ``/status`` solve count
        (lock held).  Same reset rule as real counters."""
        solves = status.get("solves")
        if not isinstance(solves, (int, float)):
            return
        raw = float(solves)
        prev_raw = w["solves_raw"]
        if prev_raw is None:
            w["solves_mono"] = raw
        elif raw < prev_raw:
            # restart: fold the whole pre-reset monotone total into the
            # offset, same rule as real counters
            w["solves_mono"] = w["solves_mono"] + raw
        else:
            w["solves_mono"] = w["solves_mono"] + (raw - prev_raw)
        w["solves_raw"] = raw
        prev = w["solves_prev"]
        if prev is not None:
            pt, pv = prev
            w["solves_rate"] = clamped_rate(pv, w["solves_mono"], now - pt)
        w["solves_prev"] = (now, w["solves_mono"])

    # -- counter reads (the fleet SLO source) --------------------------

    def counter_sum(
        self,
        name: str,
        worker: Optional[str] = None,
        **labels: Any,
    ) -> float:
        """Reset-adjusted counter total across the fleet (or one
        ``worker``), summed over series whose labels contain ``labels``.
        This is what :class:`FleetSlo` evaluates burn rates over."""
        want = {(k, str(v)) for k, v in labels.items()}
        total = 0.0
        with self._lock:
            for (mname, wname, lkey), st in self._counter_state.items():
                if mname != name:
                    continue
                if worker is not None and wname != worker:
                    continue
                if not want <= set(lkey):
                    continue
                total += st["offset"] + st["last"]
        return total

    def worker_names(self) -> List[str]:
        return [t.name for t in self.targets]

    # -- the federated snapshot ----------------------------------------

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The federated registry view: every live worker's series
        re-labeled with ``worker=`` (counters/histograms reset-adjusted),
        plus the ``fleet.*`` meta-series.  Same document shape as
        ``MetricsRegistry.snapshot()``, so ``render_prometheus`` and
        every snapshot consumer work unchanged."""
        now = self._clock() if now is None else now
        metrics: Dict[str, Dict[str, Any]] = {}

        def _metric(name: str, kind: str, help_: str) -> Dict[str, Any]:
            return metrics.setdefault(
                name, {"kind": kind, "help": help_, "values": []}
            )

        up_rows, age_rows, scr_rows, fail_rows = [], [], [], []
        retry_rows, reset_rows, solve_rows = [], [], []
        n_up = 0
        with self._lock:
            for t in self.targets:
                w = self._workers[t.name]
                fresh = (
                    w["last_ok"] is not None
                    and now - w["last_ok"] <= self.stale_after_s
                )
                if w["up"]:
                    n_up += 1
                lbl = {"worker": t.name}
                up_rows.append(
                    {"labels": dict(lbl), "value": 1.0 if w["up"] else 0.0}
                )
                if w["last_ok"] is not None:
                    age_rows.append(
                        {
                            "labels": dict(lbl),
                            "value": round(now - w["last_ok"], 3),
                        }
                    )
                scr_rows.append(
                    {"labels": dict(lbl), "value": float(w["scrapes"])}
                )
                fail_rows.append(
                    {"labels": dict(lbl), "value": float(w["failures"])}
                )
                retry_rows.append(
                    {"labels": dict(lbl), "value": float(w["retries"])}
                )
                reset_rows.append(
                    {"labels": dict(lbl), "value": float(w["resets"])}
                )
                if w["solves_raw"] is not None:
                    solve_rows.append(
                        {"labels": dict(lbl), "value": w["solves_mono"]}
                    )
                if not fresh or not w["metrics"]:
                    # stale: the worker's own series are DROPPED — the
                    # meta-series above are the only trace it leaves
                    continue
                for name, m in w["metrics"].items():
                    kind = m.get("kind", "untyped")
                    out = _metric(name, kind, m.get("help") or "")
                    if kind == "histogram" and "bucket_bounds" in m:
                        out.setdefault(
                            "bucket_bounds", m["bucket_bounds"]
                        )
                    for entry in m.get("values", []):
                        labels = dict(entry.get("labels", {}))
                        labels["worker"] = t.name
                        key = (
                            name,
                            t.name,
                            _label_key(entry.get("labels", {})),
                        )
                        if kind == "counter":
                            st = self._counter_state.get(key)
                            val = (
                                st["offset"] + st["last"]
                                if st
                                else float(entry.get("value", 0.0))
                            )
                            out["values"].append(
                                {"labels": labels, "value": val}
                            )
                        elif kind == "histogram":
                            st = self._hist_state.get(key)
                            v = entry.get("value") or {}
                            if st:
                                lb, ls, lc = st["last"]
                                ob, os_, oc = st["offset"]
                                buckets = [
                                    o + b
                                    for o, b in zip(
                                        ob + [0.0] * (len(lb) - len(ob)),
                                        lb,
                                    )
                                ]
                                v = {
                                    "buckets": buckets,
                                    "sum": os_ + ls,
                                    "count": oc + lc,
                                }
                            out["values"].append(
                                {"labels": labels, "value": v}
                            )
                        else:
                            out["values"].append(
                                {
                                    "labels": labels,
                                    "value": entry.get("value", 0.0),
                                }
                            )
        metrics["fleet.worker_up"] = {
            "kind": "gauge",
            "help": "1 while the worker's last scrape succeeded",
            "values": up_rows,
        }
        if age_rows:
            metrics["fleet.scrape_age_seconds"] = {
                "kind": "gauge",
                "help": "seconds since the worker's last successful scrape",
                "values": age_rows,
            }
        metrics["fleet.scrapes_total"] = {
            "kind": "counter",
            "help": "scrape attempts per worker",
            "values": scr_rows,
        }
        metrics["fleet.scrape_failures_total"] = {
            "kind": "counter",
            "help": "failed scrapes per worker",
            "values": fail_rows,
        }
        metrics["fleet.scrape_retries_total"] = {
            "kind": "counter",
            "help": "in-sweep scrape retries per worker (flap suppression)",
            "values": retry_rows,
        }
        metrics["fleet.counter_resets_total"] = {
            "kind": "counter",
            "help": "counter resets detected (worker restarts)",
            "values": reset_rows,
        }
        if solve_rows:
            metrics["fleet.worker_solves_total"] = {
                "kind": "counter",
                "help": "monotone solve count per worker (reset-adjusted)",
                "values": solve_rows,
            }
        metrics["fleet.workers"] = {
            "kind": "gauge",
            "help": "workers the collector polls",
            "values": [{"labels": {}, "value": float(len(self.targets))}],
        }
        metrics["fleet.workers_up"] = {
            "kind": "gauge",
            "help": "workers whose last scrape succeeded",
            "values": [{"labels": {}, "value": float(n_up)}],
        }
        return {"time": time.time(), "metrics": metrics}

    # -- the worker table ----------------------------------------------

    @staticmethod
    def _pulse_digest(status: Dict[str, Any]) -> Optional[str]:
        """The worker's dominant non-healthy tenant pulse diagnosis, or
        'healthy' when every diagnosed tenant is — one cell of the
        fleet table, not the full per-tenant rows."""
        counts: Dict[str, int] = {}
        for rec in (status.get("tenants") or {}).values():
            diag = (rec.get("pulse") or {}).get("diagnosis")
            if diag:
                counts[diag] = counts.get(diag, 0) + 1
        if not counts:
            return None
        unhealthy = {d: n for d, n in counts.items() if d != "healthy"}
        if not unhealthy:
            return "healthy"
        return max(sorted(unhealthy), key=lambda d: unhealthy[d])

    @staticmethod
    def _gauge_value(
        metrics: Optional[Dict[str, Any]], name: str
    ) -> Optional[float]:
        m = (metrics or {}).get(name)
        if not m:
            return None
        vals = [e.get("value") for e in m.get("values", [])]
        vals = [float(v) for v in vals if isinstance(v, (int, float))]
        return vals[-1] if vals else None

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/fleet/status`` document: one row per worker (up/down,
        scrape age, queue depth + watermark, solves + solves/s, batch
        occupancy, pulse digest, burn rate) plus fleet aggregates."""
        now = self._clock() if now is None else now
        rows: Dict[str, Dict[str, Any]] = {}
        agg = {"solves": 0.0, "queue_depth": 0, "dead_letters": 0,
               "solves_s": 0.0}
        n_up = 0
        with self._lock:
            for t in self.targets:
                w = self._workers[t.name]
                st = w["status"] or {}
                stale = (
                    w["last_ok"] is None
                    or now - w["last_ok"] > self.stale_after_s
                )
                row: Dict[str, Any] = {
                    "url": w["url"],
                    "up": bool(w["up"]),
                    "stale": stale,
                    "age_s": (
                        round(now - w["last_ok"], 3)
                        if w["last_ok"] is not None
                        else None
                    ),
                    "scrapes": w["scrapes"],
                    "failures": w["failures"],
                    "retries": w["retries"],
                    "resets": w["resets"],
                }
                if w["up"]:
                    n_up += 1
                if st and not stale:
                    row["state"] = st.get("state") or st.get("status")
                    for k_out, k_in in (
                        ("queue_depth", "queue_depth"),
                        ("queue_watermark", "queue_depth_watermark"),
                        ("solves", "solves"),
                        ("batches", "batches"),
                        ("dead_letters", "dead_letters"),
                    ):
                        if k_in in st:
                            row[k_out] = st[k_in]
                    occ = self._gauge_value(
                        w["metrics"], "serve.batch_occupancy_pct"
                    )
                    if occ is not None:
                        row["occupancy_pct"] = round(occ, 1)
                    cross = self._gauge_value(
                        w["metrics"], "mesh.ell_cross_frac"
                    )
                    if cross is not None:
                        # mesh observability rides along: per-host
                        # cross-shard incidence for ICI-model validation
                        row["cross_frac"] = round(cross, 4)
                    # memory columns: the worker's live memory plane
                    # (status block when the worker publishes it, mem.*
                    # gauges otherwise) + its OOM-guard refusal count
                    mem_b = st.get("memory") or {}
                    in_use = mem_b.get("bytes_in_use")
                    if in_use is None:
                        in_use = self._gauge_value(
                            w["metrics"], "mem.bytes_in_use"
                        )
                    if in_use is not None:
                        row["mem_bytes_in_use"] = int(in_use)
                    headroom = mem_b.get("headroom_pct")
                    if headroom is None:
                        headroom = self._gauge_value(
                            w["metrics"], "mem.headroom_pct"
                        )
                    if headroom is not None:
                        row["mem_headroom_pct"] = round(
                            float(headroom), 1
                        )
                    if mem_b.get("refusals_total"):
                        row["mem_refusals"] = int(mem_b["refusals_total"])
                    pulse = self._pulse_digest(st)
                    if pulse is not None:
                        row["pulse"] = pulse
                    slo_b = st.get("slo") or {}
                    burns = [
                        ob.get("burn_fast", 0.0)
                        for ob in (slo_b.get("objectives") or {}).values()
                    ]
                    if burns:
                        row["burn_fast"] = round(max(burns), 3)
                        alerts = [
                            f"{name}:{ob['alert']}"
                            for name, ob in sorted(
                                (slo_b.get("objectives") or {}).items()
                            )
                            if ob.get("alert")
                        ]
                        if alerts:
                            row["alert"] = ",".join(alerts)
                    if w["solves_rate"] is not None:
                        row["solves_s"] = round(w["solves_rate"], 2)
                        agg["solves_s"] += w["solves_rate"]
                    agg["solves"] += float(st.get("solves") or 0)
                    agg["queue_depth"] += int(st.get("queue_depth") or 0)
                    agg["dead_letters"] += int(st.get("dead_letters") or 0)
                rows[t.name] = row
        return {
            "status": "fleet",
            "workers": rows,
            "workers_total": len(self.targets),
            "workers_up": n_up,
            "fleet": {
                "solves": int(agg["solves"]),
                "queue_depth": agg["queue_depth"],
                "dead_letters": agg["dead_letters"],
                "solves_s": round(agg["solves_s"], 2),
            },
        }

    # -- lifecycle -----------------------------------------------------

    def start(
        self, on_tick: Optional[Callable[[], None]] = None
    ) -> None:
        """Spawn the background poll loop (idempotent); ``on_tick`` runs
        after every sweep — the ``fleet`` verb hangs the fleet-SLO
        evaluation there."""
        self._stop.clear()
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run,
                args=(on_tick,),
                name="fleet-collector",
                daemon=True,
            )
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)

    def _run(self, on_tick: Optional[Callable[[], None]]) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
                if on_tick is not None:
                    on_tick()
            except Exception:  # noqa: BLE001 — the collector must survive
                logger.exception("fleet poll failed")
            self._stop.wait(self.interval_s)


# ---------------------------------------------------------------------------
# fleet SLOs
# ---------------------------------------------------------------------------


class FleetSlo:
    """The same objective grammar and multiwindow burn rates, evaluated
    over federated ``slo.events``: one engine per worker (per-worker
    budgets) plus one fleet-aggregate engine, all fed through
    ``SloEngine(counter_source=...)`` reading the collector's
    reset-adjusted counters.  Fleet alert transitions are annotated with
    the **worst worker** — the one burning its fast window hardest at
    transition time — so a page names where to look first."""

    def __init__(
        self,
        collector: FleetCollector,
        objectives: Sequence[Objective],
        fast_burn: float = DEFAULT_FAST_BURN,
        slow_burn: float = DEFAULT_SLOW_BURN,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.collector = collector
        self.objectives = tuple(objectives)
        self._clock = clock
        self._lock = threading.Lock()
        self._opts = {"fast_burn": fast_burn, "slow_burn": slow_burn}

        def _fleet_source(objective: str) -> Tuple[float, float]:
            return (
                collector.counter_sum(
                    "slo.events", objective=objective, outcome="good"
                ),
                collector.counter_sum(
                    "slo.events", objective=objective, outcome="bad"
                ),
            )

        self.fleet_engine = SloEngine(
            objectives,
            counter_source=_fleet_source,
            publish_metrics=False,
            clock=clock,
            **self._opts,
        )
        self.worker_engines: Dict[str, SloEngine] = {
            name: self._worker_engine(name)
            for name in collector.worker_names()
        }
        #: fleet transitions annotated with the worst worker; the
        #: engines' own lists stay un-annotated
        self.transitions: List[Dict[str, Any]] = []
        self._seen_seq = 0

    def _worker_engine(self, worker: str) -> SloEngine:
        def _source(objective: str) -> Tuple[float, float]:
            return (
                self.collector.counter_sum(
                    "slo.events",
                    worker=worker,
                    objective=objective,
                    outcome="good",
                ),
                self.collector.counter_sum(
                    "slo.events",
                    worker=worker,
                    objective=objective,
                    outcome="bad",
                ),
            )

        return SloEngine(
            self.objectives,
            counter_source=_source,
            publish_metrics=False,
            clock=self._clock,
            **self._opts,
        )

    def worst_worker(self, objective: str) -> Optional[str]:
        """The worker burning the objective's fast window hardest (ties
        break by name for determinism); None before any evaluation."""
        best: Optional[Tuple[float, str]] = None
        for name in sorted(self.worker_engines):
            eng = self.worker_engines[name]
            with eng._lock:
                burn = eng._burns.get(objective, {}).get("fast_long", 0.0)
            if best is None or burn > best[0]:
                best = (burn, name)
        return best[1] if best else None

    def evaluate(self, now: Optional[float] = None) -> None:
        """One tick: every worker engine first (their burns feed the
        worst-worker annotation), then the fleet engine; new fleet
        transitions are captured and annotated."""
        now = self._clock() if now is None else now
        for name in sorted(self.worker_engines):
            self.worker_engines[name].evaluate(now)
        self.fleet_engine.evaluate(now)
        fresh = [
            t
            for t in self.fleet_engine.transitions
            if t["seq"] > self._seen_seq
        ]
        if not fresh:
            return
        with self._lock:
            for tr in fresh:
                tr = dict(tr)
                tr["worst_worker"] = self.worst_worker(tr["objective"])
                self.transitions.append(tr)
                self._seen_seq = max(self._seen_seq, tr["seq"])
                logger.warning(
                    "fleet slo-alert state=%s objective=%s severity=%s "
                    "worst_worker=%s",
                    tr["state"], tr["objective"], tr["severity"],
                    tr["worst_worker"],
                )

    def status_block(self) -> Dict[str, Any]:
        """The ``slo`` block of ``/fleet/status``: the aggregate
        engine's view plus per-worker budget/burn and the annotated
        transitions."""
        block = self.fleet_engine.status_block()
        for name, ob in block["objectives"].items():
            ob["worst_worker"] = self.worst_worker(name)
        with self._lock:
            transitions = [dict(t) for t in self.transitions]
        return {
            "fleet": block,
            "workers": {
                name: eng.status_block()
                for name, eng in sorted(self.worker_engines.items())
            },
            "transitions": transitions,
        }

    def metrics_block(self) -> Dict[str, Dict[str, Any]]:
        """``fleet.slo.*`` series for the federated snapshot (the
        engines publish nothing themselves): burn rate, budget remaining
        and alert state per objective, for the aggregate (no ``worker``
        label) and each worker."""
        burn_rows: List[Dict[str, Any]] = []
        budget_rows: List[Dict[str, Any]] = []
        alert_rows: List[Dict[str, Any]] = []

        def _add(engine: SloEngine, extra: Dict[str, str]) -> None:
            with engine._lock:
                burns = {k: dict(v) for k, v in engine._burns.items()}
                budget = dict(engine._budget_left)
                alerts = {k: dict(v) for k, v in engine._alerts.items()}
            for oname, wins in sorted(burns.items()):
                for win, b in sorted(wins.items()):
                    burn_rows.append(
                        {
                            "labels": {
                                "objective": oname,
                                "window": win,
                                **extra,
                            },
                            "value": round(b, 6),
                        }
                    )
            for oname, left in sorted(budget.items()):
                budget_rows.append(
                    {
                        "labels": {"objective": oname, **extra},
                        "value": round(left, 6),
                    }
                )
            for oname, sevs in sorted(alerts.items()):
                for sev, on in sorted(sevs.items()):
                    alert_rows.append(
                        {
                            "labels": {
                                "objective": oname,
                                "severity": sev,
                                **extra,
                            },
                            "value": 1.0 if on else 0.0,
                        }
                    )

        _add(self.fleet_engine, {})
        for name in sorted(self.worker_engines):
            _add(self.worker_engines[name], {"worker": name})
        return {
            "fleet.slo.burn_rate": {
                "kind": "gauge",
                "help": "federated burn rate per objective and window",
                "values": burn_rows,
            },
            "fleet.slo.error_budget_remaining": {
                "kind": "gauge",
                "help": "federated error budget left per objective",
                "values": budget_rows,
            },
            "fleet.slo.alert_active": {
                "kind": "gauge",
                "help": "1 while the federated burn-rate alert fires",
                "values": alert_rows,
            },
        }
