"""graftslo: declarative SLOs, error budgets, multi-window burn-rate alerts.

The port's own copy of ``pydcop_tpu/telemetry/slo.py``, unchanged: the
same grammar, burn windows, alert states and postmortem document, so an
engine of either package fed the same requests reports the same.

The serving layer (graftserve) turned the system into a multi-tenant
service; this module gives that service the SRE contract the rest of the
observability stack lacks: **objectives** ("p99 request latency under
250 ms", "99.9% of requests succeed") declared up front, an **error
budget** derived from each objective, and **burn-rate alerts** in the
multi-window form of the Google SRE Workbook (ch. 5): page when the
budget is burning fast enough to exhaust within hours (both a long and a
short window above the *fast* threshold — the short window makes the
alert reset quickly once the incident ends), ticket on the slower pair.

How it composes (docs/observability.md, graftslo):

- the serving layer classifies every terminal request against each
  objective and counts it into the ``slo.events`` counter
  (good/bad per objective) — exact per-request classification, so burn
  rates are reproducible bit-for-bit under a seeded chaos schedule;
- :class:`SloEngine` is a background evaluator **over the metrics
  registry**: each tick samples the counters, keeps a time-indexed ring,
  and computes budget consumption + four burn rates per objective
  (fast/slow x long/short windows — the Workbook's multiwindow shape,
  with window ratios sized to service-scale SLO periods; see
  :meth:`Objective.windows`), published as ``slo.*`` gauges, the
  ``/slo`` endpoint, the ``/status`` block the ``watch`` verb renders,
  and structured alert log lines;
- alert **transitions** (firing/resolved) are recorded, and the first
  trip per objective writes a postmortem through the graftpulse
  flight-recorder path — same ``POSTMORTEM_FORMAT``, with an ``slo``
  block naming the violated objective, the burn rates at trip time and
  the recent bad requests (trace ids included), renderable by
  ``pydcop_tpu postmortem``.

Objective grammar (``--slo`` on ``pydcop_tpu serve``, or a YAML file):

- ``p99<250ms`` / ``p95<=1s``       latency: the named percentile of
  request latency must stay under the bound — equivalently, at least
  that fraction of requests must finish within it (the countable form
  burn rates need);
- ``availability>=99.9%``           fraction of requests ending ``done``;
- ``dead_letter_rate<=0.1%``        fraction of requests dead-lettered;
- optional ``name=`` prefix and ``@WINDOW`` suffix:
  ``lat=p99<500ms@1800s`` (window default 3600 s; units s/m/h).

Stdlib-only, same constraint as ``telemetry.metrics``.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import metrics_registry, percentile as _percentile

__all__ = [
    "DEFAULT_FAST_BURN",
    "DEFAULT_SLOW_BURN",
    "Objective",
    "SloEngine",
    "load_slo_file",
    "parse_objective",
]

logger = logging.getLogger("pydcop_tpu.telemetry.slo")

#: burn-rate thresholds of the SRE Workbook's recommended multiwindow
#: pairs (14.4 = 2% of a 30-day budget in one hour; 6 = 5% in six hours)
DEFAULT_FAST_BURN = 14.4
DEFAULT_SLOW_BURN = 6.0

OBJECTIVE_KINDS = ("latency", "availability", "dead_letters")

#: alert severities, evaluated in this order so transition logs are
#: deterministic when both trip on the same tick
SEVERITIES = ("fast", "slow")


@dataclass(frozen=True)
class Objective:
    """One declarative objective: a target *good fraction* plus what
    counts as good.  ``budget`` is the tolerated bad fraction; burn rate
    = (observed bad fraction) / budget, so burn 1.0 spends the budget
    exactly over the window and burn 14.4 exhausts it ~14x early."""

    name: str
    kind: str  # one of OBJECTIVE_KINDS
    target: float  # good-fraction target in (0, 1)
    threshold_s: float = 0.0  # latency bound (latency kind only)
    window_s: float = 3600.0  # SLO compliance window (budget period)

    def __post_init__(self) -> None:
        if self.kind not in OBJECTIVE_KINDS:
            raise ValueError(
                f"objective {self.name!r}: unknown kind {self.kind!r} "
                f"(expected one of {OBJECTIVE_KINDS})"
            )
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"objective {self.name!r}: target {self.target} must be "
                "a fraction strictly inside (0, 1) — 100% leaves no "
                "error budget to burn"
            )
        if self.kind == "latency" and self.threshold_s <= 0:
            raise ValueError(
                f"objective {self.name!r}: latency objectives need a "
                "positive threshold"
            )
        if self.window_s <= 0:
            raise ValueError(
                f"objective {self.name!r}: window must be positive"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def windows(self) -> Dict[str, Tuple[float, float]]:
        """severity -> (long, short) alert windows: the Workbook's
        multiwindow SHAPE (long window for significance, a 12x-shorter
        window so a fired alert resets promptly) with ratios sized for
        service-scale compliance windows rather than the book's 30-day
        example — fast pair = (window/60, window/720) (60 s / 5 s on
        the default 1 h window), slow pair = (window/10, window/120)
        (6 min / 30 s).  With the book's 30-day period the book's own
        1h/5m pair falls out of /720 and /8640; here the window is the
        serving layer's, typically hours, and /720 of an hour would be
        smaller than an evaluator tick."""
        w = self.window_s
        return {
            "fast": (w / 60.0, w / 720.0),
            "slow": (w / 10.0, w / 120.0),
        }

    def is_good(
        self, status: str, latency_s: float, dead_letter: bool
    ) -> bool:
        """Classify one terminal request against this objective."""
        if self.kind == "latency":
            return status == "done" and latency_s <= self.threshold_s
        if self.kind == "availability":
            return status == "done"
        return not dead_letter  # dead_letters

    def describe(self) -> str:
        if self.kind == "latency":
            pct = 100.0 * self.target
            pct_s = f"{pct:g}"
            return (
                f"p{pct_s} latency <= {self.threshold_s * 1e3:g} ms"
            )
        if self.kind == "availability":
            return f"availability >= {100.0 * self.target:g}%"
        return f"dead-letter rate <= {100.0 * self.budget:g}%"


# ---------------------------------------------------------------------------
# the objective grammar
# ---------------------------------------------------------------------------

_RE_LATENCY = re.compile(
    r"^p(?P<pct>\d+(?:\.\d+)?)\s*<=?\s*(?P<num>\d+(?:\.\d+)?)\s*"
    r"(?P<unit>ms|s)$"
)
_RE_AVAIL = re.compile(
    r"^availability\s*>=?\s*(?P<num>\d+(?:\.\d+)?)\s*(?P<pct>%)?$"
)
_RE_DEAD = re.compile(
    r"^dead_letter(?:_rate|s)?\s*<=?\s*(?P<num>\d+(?:\.\d+)?)\s*"
    r"(?P<pct>%)?$"
)
_RE_WINDOW = re.compile(r"^(?P<num>\d+(?:\.\d+)?)\s*(?P<unit>s|m|h)?$")


def _parse_window(text: str) -> float:
    m = _RE_WINDOW.match(text.strip())
    if not m:
        raise ValueError(f"bad SLO window {text!r} (expected e.g. 600s/5m/1h)")
    return float(m.group("num")) * {"s": 1.0, "m": 60.0, "h": 3600.0}[
        m.group("unit") or "s"
    ]


def parse_objective(spec: str) -> Objective:
    """One objective from the ``--slo`` grammar (module docstring).

    >>> parse_objective("p99<250ms").threshold_s
    0.25
    >>> parse_objective("avail=availability>=99.9%@30m").window_s
    1800.0
    """
    text = spec.strip()
    name = None
    if "=" in text.split("<", 1)[0].split(">", 1)[0]:
        name, text = text.split("=", 1)
        name = name.strip()
    window_s = 3600.0
    if "@" in text:
        text, window = text.rsplit("@", 1)
        window_s = _parse_window(window)
    text = text.strip()
    m = _RE_LATENCY.match(text)
    if m:
        pct = float(m.group("pct"))
        if not 0.0 < pct < 100.0:
            raise ValueError(
                f"bad SLO spec {spec!r}: percentile must be in (0, 100)"
            )
        thr = float(m.group("num")) * (
            1e-3 if m.group("unit") == "ms" else 1.0
        )
        return Objective(
            name=name or f"p{m.group('pct')}_latency",
            kind="latency",
            target=pct / 100.0,
            threshold_s=thr,
            window_s=window_s,
        )
    m = _RE_AVAIL.match(text)
    if m:
        target = float(m.group("num"))
        if m.group("pct"):
            target /= 100.0
        return Objective(
            name=name or "availability",
            kind="availability",
            target=target,
            window_s=window_s,
        )
    m = _RE_DEAD.match(text)
    if m:
        budget = float(m.group("num"))
        if m.group("pct"):
            budget /= 100.0
        return Objective(
            name=name or "dead_letters",
            kind="dead_letters",
            target=1.0 - budget,
            window_s=window_s,
        )
    raise ValueError(
        f"bad SLO spec {spec!r}: expected pNN<DURATION, "
        "availability>=PCT or dead_letter_rate<=PCT "
        "(optionally NAME=... and ...@WINDOW)"
    )


def load_slo_file(path: str) -> Tuple[List[Objective], Dict[str, Any]]:
    """(objectives, engine options) from an SLO YAML file.

    ``objectives`` entries are either grammar strings or mappings with
    the :class:`Objective` fields; top-level ``fast_burn`` /
    ``slow_burn`` / ``eval_interval_s`` become engine options."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: SLO file must be a mapping")
    objectives: List[Objective] = []
    for i, raw in enumerate(data.get("objectives") or []):
        if isinstance(raw, str):
            objectives.append(parse_objective(raw))
        elif isinstance(raw, dict):
            kind = raw.get("kind", "availability")
            objectives.append(
                Objective(
                    name=str(raw.get("name") or f"{kind}_{i}"),
                    kind=kind,
                    target=float(raw["target"]),
                    threshold_s=float(raw.get("threshold_s", 0.0)),
                    window_s=float(raw.get("window_s", 3600.0)),
                )
            )
        else:
            raise ValueError(
                f"{path}: objective {i} must be a string or mapping"
            )
    options = {
        k: float(data[k])
        for k in ("fast_burn", "slow_burn", "eval_interval_s")
        if k in data
    }
    return objectives, options


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_c_events = metrics_registry.counter(
    "slo.events",
    "terminal requests classified against each objective (good/bad)",
)
_g_burn = metrics_registry.gauge(
    "slo.burn_rate",
    "error-budget burn rate per objective and alert window",
)
_g_budget = metrics_registry.gauge(
    "slo.error_budget_remaining",
    "fraction of the objective's error budget left in its window",
)
_g_alert = metrics_registry.gauge(
    "slo.alert_active", "1 while the burn-rate alert is firing"
)
_c_transitions = metrics_registry.counter(
    "slo.alert_transitions", "alert state transitions (firing/resolved)"
)

#: requests kept for the /slo recent view and phase percentiles
LEDGER_CAP = 4096

#: recent bad requests included in an alert postmortem
POSTMORTEM_REQUESTS = 32


class SloEngine:
    """Error budgets + multi-window burn-rate alerting over the registry.

    The serving layer calls :meth:`record_request` for every terminal
    request; :meth:`evaluate` (one tick — driven by the background
    thread :meth:`start` spawns, or called directly with an explicit
    ``now`` for deterministic tests) samples the ``slo.events``
    counters, computes burn rates, and walks the per-objective alert
    state machines.  Everything observable lives behind
    :meth:`report` (the ``/slo`` endpoint), :meth:`status_block` (the
    ``/status`` block), the ``slo.*`` metrics, and :attr:`transitions`.
    """

    def __init__(
        self,
        objectives: Sequence[Objective],
        fast_burn: float = DEFAULT_FAST_BURN,
        slow_burn: float = DEFAULT_SLOW_BURN,
        eval_interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        postmortem_path: Optional[str] = None,
        counter_source: Optional[
            Callable[[str], Tuple[float, float]]
        ] = None,
        publish_metrics: bool = True,
    ) -> None:
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        #: graftfleet: where the (good, bad) counts per objective come
        #: from.  None (the default) reads this process's ``slo.events``
        #: counter — the single-worker serve path.  A callable
        #: ``objective_name -> (good, bad)`` re-points the SAME burn
        #: math at any other ledger: the federated collector passes a
        #: source summing ``slo.events`` across scraped workers (or
        #: filtered to one worker), so fleet-wide budgets evaluate with
        #: exactly the objective grammar and multiwindow alerting the
        #: single-process engine uses.
        self.counter_source = counter_source
        #: False suppresses the ``slo.*`` gauge/counter writes on
        #: evaluate — fleet engines (one per worker plus the aggregate)
        #: would otherwise stomp each other's series in the local
        #: registry; their state is published through the federated
        #: snapshot instead (``telemetry/federate.py``).
        self.publish_metrics = publish_metrics
        self.objectives: Tuple[Objective, ...] = tuple(objectives)
        self.burn_thresholds = {"fast": fast_burn, "slow": slow_burn}
        self.eval_interval_s = max(0.05, float(eval_interval_s))
        # default into the bench state dir, NEVER the cwd: a bare
        # SloEngine used to litter (and get committed as) a root-level
        # slo_postmortem.json — same no-littering rule as the pulse
        # postmortems and the batch progress markers
        if postmortem_path is None:
            postmortem_path = os.path.join(
                os.environ.get("PYDCOP_TPU_STATE_DIR") or ".bench_state",
                "slo_postmortem.json",
            )
        self.postmortem_path = postmortem_path
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        #: (t, {objective: (good, bad)}) counter samples, pruned past the
        #: longest window any objective needs
        self._samples: List[Tuple[float, Dict[str, Tuple[float, float]]]] = []
        #: objective -> severity -> firing?
        self._alerts: Dict[str, Dict[str, bool]] = {
            o.name: {sev: False for sev in SEVERITIES}
            for o in self.objectives
        }
        self._burns: Dict[str, Dict[str, float]] = {
            o.name: {} for o in self.objectives
        }
        self._budget_left: Dict[str, float] = {
            o.name: 1.0 for o in self.objectives
        }
        self._transitions: List[Dict[str, Any]] = []
        self._seq = itertools.count(1)
        self._dumped: set = set()
        self._ledger: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._keep_s = max(
            (o.window_s for o in self.objectives), default=3600.0
        ) + 4 * self.eval_interval_s

    # -- recording -----------------------------------------------------

    def record_request(
        self,
        tenant: str,
        status: str,
        latency_s: float,
        dead_letter: bool = False,
        trace: Optional[str] = None,
        phases: Optional[Dict[str, float]] = None,
    ) -> None:
        """Classify one TERMINAL request against every objective and
        count it.  Called by the serve loop at result-ready time; the
        classification is a pure function of (status, latency,
        dead_letter), which is what makes a seeded chaos run's burn
        rates bit-reproducible."""
        bad_for: List[str] = []
        for o in self.objectives:
            good = o.is_good(status, latency_s, dead_letter)
            if not good:
                bad_for.append(o.name)
            _c_events.inc(
                1.0, objective=o.name, outcome="good" if good else "bad"
            )
        row = {
            "t": round(self._clock() - self._t0, 6),
            "tenant": tenant,
            "status": status,
            "latency_s": round(float(latency_s), 6),
            "dead_letter": bool(dead_letter),
        }
        if bad_for:
            row["bad_for"] = bad_for
        if trace:
            row["trace"] = trace
        if phases:
            row["phases"] = {
                k: round(float(v), 6) for k, v in phases.items()
            }
        with self._lock:
            self._ledger.append(row)
            del self._ledger[:-LEDGER_CAP]

    # -- evaluation ----------------------------------------------------

    def _counts(self) -> Dict[str, Tuple[float, float]]:
        """Current (good, bad) per objective, read back from the
        registry (or the pluggable ``counter_source``) — the engine
        evaluates what the metrics say, so an operator's dashboard and
        the alert math can never disagree."""
        if self.counter_source is not None:
            return {
                o.name: tuple(self.counter_source(o.name))
                for o in self.objectives
            }
        return {
            o.name: (
                _c_events.value(objective=o.name, outcome="good"),
                _c_events.value(objective=o.name, outcome="bad"),
            )
            for o in self.objectives
        }

    @staticmethod
    def _burn(
        now_counts: Tuple[float, float],
        base_counts: Tuple[float, float],
        budget: float,
    ) -> float:
        good = now_counts[0] - base_counts[0]
        bad = now_counts[1] - base_counts[1]
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / budget

    def _base_at(
        self, samples, t: float
    ) -> Dict[str, Tuple[float, float]]:
        """The newest sample at or before ``t`` — the subtraction base of
        a window ending now.  Before the run is ``window`` old, the base
        is the zero origin: burn is judged on everything seen so far."""
        base: Dict[str, Tuple[float, float]] = {}
        for sample_t, counts in samples:
            if sample_t > t:
                break
            base = counts
        return base

    def evaluate(self, now: Optional[float] = None) -> None:
        """One evaluator tick: sample counters, recompute burn rates and
        budgets, walk the alert state machines, publish gauges."""
        now = self._clock() if now is None else now
        counts = self._counts()
        fired: List[Dict[str, Any]] = []
        with self._lock:
            self._samples.append((now, counts))
            cutoff = now - self._keep_s
            while len(self._samples) > 1 and self._samples[0][0] < cutoff:
                self._samples.pop(0)
            samples = list(self._samples)
            for o in self.objectives:
                burns: Dict[str, float] = {}
                for sev, (long_w, short_w) in o.windows().items():
                    for tag, w in (("long", long_w), ("short", short_w)):
                        base = self._base_at(samples, now - w).get(
                            o.name, (0.0, 0.0)
                        )
                        burns[f"{sev}_{tag}"] = self._burn(
                            counts[o.name], base, o.budget
                        )
                base = self._base_at(samples, now - o.window_s).get(
                    o.name, (0.0, 0.0)
                )
                window_burn = self._burn(counts[o.name], base, o.budget)
                # burn 1.0 sustained over the full window spends the
                # budget exactly; remaining = the unspent fraction
                budget_left = 1.0 - window_burn * min(
                    1.0, (now - self._t0) / o.window_s
                )
                self._burns[o.name] = burns
                self._budget_left[o.name] = budget_left
                for sev in SEVERITIES:
                    thr = self.burn_thresholds[sev]
                    active = self._alerts[o.name][sev]
                    if not active and (
                        burns[f"{sev}_long"] >= thr
                        and burns[f"{sev}_short"] >= thr
                    ):
                        self._alerts[o.name][sev] = True
                        fired.append(
                            self._transition(
                                now, o, sev, "firing", burns, budget_left
                            )
                        )
                    elif active and burns[f"{sev}_long"] < thr:
                        self._alerts[o.name][sev] = False
                        fired.append(
                            self._transition(
                                now, o, sev, "resolved", burns,
                                budget_left,
                            )
                        )
        # metrics + logs + postmortems OUTSIDE the lock: gauge writes
        # take per-metric locks and the dump does file I/O
        for o in self.objectives if self.publish_metrics else ():
            for win, b in self._burns[o.name].items():  # graftlint: disable=lock-unguarded-read (replaced whole dict under lock; values immutable)
                _g_burn.set(b, objective=o.name, window=win)
            _g_budget.set(
                self._budget_left[o.name], objective=o.name  # graftlint: disable=lock-unguarded-read (float read, replaced atomically)
            )
            for sev in SEVERITIES:
                _g_alert.set(
                    1.0 if self._alerts[o.name][sev] else 0.0,  # graftlint: disable=lock-unguarded-read (bool read)
                    objective=o.name, severity=sev,
                )
        for tr in fired:
            self._announce(tr)

    def _transition(
        self,
        now: float,
        o: Objective,
        severity: str,
        state: str,
        burns: Dict[str, float],
        budget_left: float,
    ) -> Dict[str, Any]:
        """Record one alert transition (caller holds the lock)."""
        tr = {
            "seq": next(self._seq),
            "t": round(now - self._t0, 3),
            "objective": o.name,
            "describe": o.describe(),
            "severity": severity,
            "state": state,
            "burn_long": round(burns[f"{severity}_long"], 4),
            "burn_short": round(burns[f"{severity}_short"], 4),
            "threshold": self.burn_thresholds[severity],
            "budget_remaining": round(budget_left, 4),
        }
        self._transitions.append(tr)
        return tr

    def _announce(self, tr: Dict[str, Any]) -> None:
        """The side effects of a transition: the structured alert log
        line, the transition counter, and (first trip per objective)
        the postmortem dump."""
        log = logger.warning if tr["state"] == "firing" else logger.info
        log(
            "slo-alert state=%s objective=%s severity=%s burn_long=%.2f "
            "burn_short=%.2f threshold=%.1f budget_remaining=%.3f (%s)",
            tr["state"], tr["objective"], tr["severity"],
            tr["burn_long"], tr["burn_short"], tr["threshold"],
            tr["budget_remaining"], tr["describe"],
        )
        if self.publish_metrics:
            _c_transitions.inc(
                1.0,
                objective=tr["objective"],
                severity=tr["severity"],
                state=tr["state"],
            )
        if tr["state"] == "firing":
            with self._lock:
                first = tr["objective"] not in self._dumped
                self._dumped.add(tr["objective"])
            if first:
                try:
                    self.write_postmortem(tr)
                except OSError:
                    with self._lock:
                        # transient write failure must not suppress a
                        # later dump of this objective (pulse.py's rule)
                        self._dumped.discard(tr["objective"])

    # -- postmortem ----------------------------------------------------

    def write_postmortem(self, transition: Dict[str, Any]) -> str:
        """A tripped SLO leaves a dump: the graftpulse postmortem format
        (so ``pydcop_tpu postmortem`` renders it) with whatever health
        rows the flight recorder holds, plus an ``slo`` block naming the
        violated objective, the burn rates at trip time, the transition
        history and the recent bad requests with their trace ids."""
        from .pulse import HEALTH_FIELDS, POSTMORTEM_FORMAT, pulse

        rows, start_cycle = pulse.recorder.ring()
        with self._lock:
            bad_recent = [
                r for r in self._ledger
                if transition["objective"] in r.get("bad_for", ())
            ][-POSTMORTEM_REQUESTS:]
            transitions = list(self._transitions)
        doc = {
            "format": POSTMORTEM_FORMAT,
            "time": time.time(),
            "reason": f"slo-alert:{transition['objective']}",
            "meta": {"objective": transition["objective"]},
            "fingerprint": "slo",
            "fields": list(HEALTH_FIELDS),
            "start_cycle": start_cycle,
            "rows": rows,
            "slo": {
                "objective": transition["objective"],
                "describe": transition["describe"],
                "severity": transition["severity"],
                "burn_long": transition["burn_long"],
                "burn_short": transition["burn_short"],
                "threshold": transition["threshold"],
                "budget_remaining": transition["budget_remaining"],
                "transitions": transitions,
                "bad_requests": bad_recent,
            },
        }
        parent = os.path.dirname(self.postmortem_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.postmortem_path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
        logger.warning("slo postmortem -> %s", self.postmortem_path)
        return self.postmortem_path

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        """Spawn the background evaluator (idempotent)."""
        # the Event is its own synchronization: clear it before the
        # thread exists so the first wait() cannot see a stale stop
        self._stop.clear()
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, name="slo-evaluator", daemon=True
            )
            self._thread.start()

    def stop(self, final_tick: bool = True) -> None:
        """Stop the evaluator; by default run one last tick so requests
        recorded between the final periodic tick and the drain still
        reach the burn math."""
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        if final_tick:
            self.evaluate()

    def _run(self) -> None:
        while not self._stop.wait(self.eval_interval_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 — the evaluator must survive
                logger.exception("slo evaluator tick failed")

    # -- surfaces ------------------------------------------------------

    @property
    def transitions(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(t) for t in self._transitions]

    def alerts_active(self) -> List[Tuple[str, str]]:
        """(objective, severity) pairs currently firing."""
        with self._lock:
            return [
                (name, sev)
                for name, sevs in self._alerts.items()
                for sev, on in sevs.items()
                if on
            ]

    def phase_percentiles(
        self, quantiles: Sequence[float] = (0.5, 0.99)
    ) -> Dict[str, Dict[str, float]]:
        """p50/p99 (by default) per recorded phase plus the end-to-end
        request latency, from the request ledger."""
        with self._lock:
            rows = [dict(r) for r in self._ledger]
        series: Dict[str, List[float]] = {"request": []}
        for r in rows:
            series["request"].append(r["latency_s"])
            for k, v in (r.get("phases") or {}).items():
                series.setdefault(k, []).append(v)
        out: Dict[str, Dict[str, float]] = {}
        for name, vals in series.items():
            vals.sort()
            out[name] = {
                f"p{round(q * 100):g}": round(_percentile(vals, q), 6)
                for q in quantiles
                if vals
            }
        return out

    def report(self) -> Dict[str, Any]:
        """The ``/slo`` endpoint payload: full objective state."""
        counts = self._counts()
        with self._lock:
            burns = {k: dict(v) for k, v in self._burns.items()}
            budget = dict(self._budget_left)
            alerts = {k: dict(v) for k, v in self._alerts.items()}
            transitions = [dict(t) for t in self._transitions]
            n_requests = len(self._ledger)
            recent = [dict(r) for r in self._ledger[-16:]]
        return {
            "objectives": [
                {
                    "name": o.name,
                    "kind": o.kind,
                    "describe": o.describe(),
                    "target": o.target,
                    "threshold_s": o.threshold_s or None,
                    "window_s": o.window_s,
                    "good": counts[o.name][0],
                    "bad": counts[o.name][1],
                    "budget_remaining": round(budget[o.name], 4),
                    "burn": burns[o.name],
                    "alerts": alerts[o.name],
                }
                for o in self.objectives
            ],
            "burn_thresholds": dict(self.burn_thresholds),
            "transitions": transitions,
            "requests": n_requests,
            "recent": recent,
            "phase_percentiles": self.phase_percentiles(),
        }

    def status_block(self) -> Dict[str, Any]:
        """The compact ``slo`` block of ``/status`` (what ``watch``
        renders as the budget/burn line)."""
        counts = self._counts()
        with self._lock:
            return {
                "objectives": {
                    o.name: {
                        "describe": o.describe(),
                        "good": counts[o.name][0],
                        "bad": counts[o.name][1],
                        "budget_remaining": round(
                            self._budget_left[o.name], 4
                        ),
                        "burn_fast": round(
                            self._burns[o.name].get("fast_long", 0.0), 3
                        ),
                        "alert": next(
                            (
                                sev for sev in SEVERITIES
                                if self._alerts[o.name][sev]
                            ),
                            None,
                        ),
                    }
                    for o in self.objectives
                },
                "transitions": len(self._transitions),
            }

    def bench_block(self) -> Dict[str, Any]:
        """The ``slo`` block of a serving bench record: budget
        consumption + per-phase percentiles (bench_all config 8)."""
        counts = self._counts()
        with self._lock:
            budget = dict(self._budget_left)
            transitions = len(self._transitions)
        return {
            "objectives": {
                o.name: {
                    "describe": o.describe(),
                    "good": int(counts[o.name][0]),
                    "bad": int(counts[o.name][1]),
                    "budget_remaining": round(budget[o.name], 4),
                }
                for o in self.objectives
            },
            "transitions": transitions,
            "phases": self.phase_percentiles(),
        }


def objective_dict(o: Objective) -> Dict[str, Any]:
    """JSON-friendly view of an objective (docs/file_formats)."""
    return asdict(o)
