"""Prometheus-style metrics registry: labeled counters, gauges, histograms.

The port's own copy of ``pydcop_tpu/telemetry/metrics.py`` (the port
imports nothing of the JAX package), unchanged: pulse and durability
write their ``solve.pulse.*`` and ``durability.*`` series here.

The host-side counterpart of the per-agent op-count metrics the reference
collects through its orchestrator (``agents.py:717`` / the DCOP literature's
logical-time metric): a process-wide registry (``metrics_registry``,
mirroring ``event_bus``) that any layer — compile, solver loop, messaging,
control plane — writes into, with one lock per metric and a JSON snapshot
export consumed by ``--metrics-out`` and bench records.

Disabled by default, exactly like ``event_bus``: every write checks the
registry's ``enabled`` flag FIRST and returns before touching a lock or
allocating — instrumented hot paths (message delivery, solver readbacks)
cost one attribute read when telemetry is off.

Stdlib-only on purpose: this module is imported by host-only CLI verbs and
the bench watchdog parent, neither of which may pull in jax.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metrics_registry",
    "percentile",
]

LabelKey = Tuple[Tuple[str, str], ...]


def percentile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an ALREADY-SORTED sequence (None when
    empty) — the one definition behind the serve /status queue p50/p99
    and the graftslo phase percentiles, so the two surfaces can never
    disagree on what a percentile means."""
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    """Canonical hashable form of a label set (values stringified so a
    snapshot round-trips through JSON without type drift)."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Common machinery: one lock + a label-keyed value table per metric."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, Any] = {}

    def labels(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(k) for k in self._values]

    def _snapshot_values(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {"labels": dict(k), "value": v}
                for k, v in sorted(self._values.items())
            ]

    def snapshot(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "help": self.help,
            "values": self._snapshot_values(),
        }

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    """Monotonically increasing value per label set."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Last-written value per label set."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._values[key] = float(value)

    def add(self, amount: float, **labels: Any) -> None:
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


# default histogram buckets: latency-shaped, 10 us .. 10 s (seconds)
DEFAULT_BUCKETS = (
    1e-5, 1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 5e-1, 1.0, 5.0, 10.0,
)


class Histogram(_Metric):
    """Cumulative bucket counts + sum + count per label set.

    ``observe(..., exemplar_=id)`` attaches an OpenMetrics exemplar to
    the bucket the value lands in — the LAST observation wins per bucket,
    so every histogram bucket carries a recent trace id an alert
    investigation can jump to (graftslo; rendered by
    ``prom.render_prometheus(openmetrics=True)``).  Exemplar keys are
    stored as strings so a snapshot round-trips through JSON unchanged.
    """

    kind = "histogram"

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        help: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(registry, name, help)
        self.buckets = tuple(sorted(buckets))

    def observe(
        self,
        value: float,
        exemplar_: Optional[str] = None,
        **labels: Any,
    ) -> None:
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            entry = self._values.get(key)
            if entry is None:
                entry = {
                    "buckets": [0] * (len(self.buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
                self._values[key] = entry
            # first bucket whose upper bound holds the value; the last
            # slot is the +Inf overflow bucket
            idx = bisect.bisect_left(self.buckets, value)
            entry["buckets"][idx] += 1
            entry["sum"] += value
            entry["count"] += 1
            if exemplar_ is not None:
                entry.setdefault("exemplars", {})[str(idx)] = {
                    "trace_id": str(exemplar_),
                    "value": float(value),
                    "ts": time.time(),
                }

    def count(self, **labels: Any) -> int:
        with self._lock:
            entry = self._values.get(_label_key(labels))
            return int(entry["count"]) if entry else 0

    def sum(self, **labels: Any) -> float:
        with self._lock:
            entry = self._values.get(_label_key(labels))
            return float(entry["sum"]) if entry else 0.0

    def _snapshot_values(self) -> List[Dict[str, Any]]:
        # deep-copy the entries: the base implementation returns the live
        # mutable dicts, and a /metrics scrape serializing them while a
        # solve observes concurrently would read TORN values (count
        # bumped, bucket list not yet) — the scrape must be a consistent
        # point-in-time view (tests/test_serve.py pins this under load)
        with self._lock:
            return [
                {
                    "labels": dict(k),
                    "value": {
                        "buckets": list(v["buckets"]),
                        "sum": v["sum"],
                        "count": v["count"],
                        **(
                            {"exemplars": {
                                b: dict(e)
                                for b, e in v["exemplars"].items()
                            }}
                            if "exemplars" in v else {}
                        ),
                    },
                }
                for k, v in sorted(self._values.items())
            ]

    def snapshot(self) -> Dict[str, Any]:
        out = super().snapshot()
        out["bucket_bounds"] = list(self.buckets) + ["+Inf"]
        return out


class MetricsRegistry:
    """Name -> metric registry with get-or-create accessors.

    ``enabled`` gates every WRITE; reads (snapshot/export) always work so a
    caller can disable collection and then dump what was gathered.
    """

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(self, name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"cannot re-register as {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable view of every metric's current values."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {
            "time": time.time(),
            "metrics": {
                name: m.snapshot()
                for name, m in sorted(metrics)
                if m._values
            },
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json() + "\n")

    def reset(self) -> None:
        """Clear all recorded values (metric definitions survive, so held
        references stay valid)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()


#: Process-wide singleton, mirroring ``infrastructure.events.event_bus``.
metrics_registry = MetricsRegistry()
