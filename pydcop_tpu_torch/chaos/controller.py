"""Chaos controller: turns a :class:`~.schedule.FaultSchedule` into live
fault decisions and a deterministic event log.

The port's copy of ``pydcop_tpu/chaos/controller.py``.  One controller
serves a whole run: a message layer asks it what to do with each
outbound message (``on_send``), a device solve whether to fail a step
(``device_fault``), and a timeline thread fires the timed kill events
(``start``): agent kills through a callback, whole-process kills with
``os._exit``.  All decisions are keyed-hash draws (``schedule.unit_draw``),
so the log, sorted canonically, is the same for the same seed and
schedule.  The port has no agent runtime: its ``solve`` arms only the
process kills (``start(None)``), and ``serve`` reads the schedule's
tenant kills and delays itself.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..telemetry.metrics import metrics_registry
from .schedule import FaultSchedule, MessageRule, unit_draw

__all__ = ["ChaosController", "FaultDecision"]

logger = logging.getLogger("pydcop_tpu_torch.chaos")

_m_chaos_events = metrics_registry.counter(
    "chaos.events", "injected fault events, by action"
)


class FaultDecision:
    """What to do with one outbound message: the matched actions in rule
    order.  ``drop``/``transport_error`` are terminal; ``delay_s`` > 0
    means sleep before sending; ``duplicates`` adds extra sends."""

    __slots__ = ("drop", "transport_error", "delay_s", "duplicates")

    def __init__(self) -> None:
        self.drop = False
        self.transport_error = False
        self.delay_s = 0.0
        self.duplicates = 0

    @property
    def clean(self) -> bool:
        return not (
            self.drop
            or self.transport_error
            or self.delay_s
            or self.duplicates
        )


class ChaosController:
    """Live fault injection driven by a schedule.

    Thread-safe: per-stream sequence counters and the event log are
    guarded by one lock; no message send ever happens under it."""

    def __init__(self, schedule: FaultSchedule) -> None:
        self.schedule = schedule
        self.seed = schedule.seed
        self._rules: List[MessageRule] = schedule.rules
        self._lock = threading.Lock()
        self._stream_seq: Dict[str, int] = {}
        self._rule_firings: Dict[int, int] = {}
        self._log: List[Dict[str, Any]] = []
        self._device_faults_left = schedule.device_faults
        self._device_fault_n = 0
        # written once by start() (idempotence guarded by _timeline_started
        # under the lock), then only read — never touched under the lock
        self._kill_thread: Optional[threading.Thread] = None
        self._timeline_started = False
        self._stop_evt = threading.Event()
        self._action_counts: Dict[str, int] = {}

    # -- message faults ------------------------------------------------

    def on_send(
        self,
        src_agent: str,
        dest_agent: str,
        sender_comp: str,
        dest_comp: str,
        msg_type: str,
    ) -> FaultDecision:
        """Decide the fate of one outbound message.  One keyed draw per
        matching rule; every firing is logged."""
        decision = FaultDecision()
        if not self._rules:
            return decision
        stream = f"{sender_comp}>{dest_comp}:{msg_type}"
        fired: List[Dict[str, Any]] = []
        with self._lock:
            n = self._stream_seq.get(stream, 0)
            self._stream_seq[stream] = n + 1
            for rule_id, rule in enumerate(self._rules):
                if not rule.matches(sender_comp, dest_comp, msg_type):
                    continue
                draw = unit_draw(self.seed, f"{rule_id}|{stream}", n)
                if draw >= rule.p:
                    continue
                if rule.count is not None:
                    if self._rule_firings.get(rule_id, 0) >= rule.count:
                        continue
                    self._rule_firings[rule_id] = (
                        self._rule_firings.get(rule_id, 0) + 1
                    )
                entry = {
                    "stream": stream,
                    "n": n,
                    "rule": rule_id,
                    "action": rule.action,
                    "draw": round(draw, 9),
                }
                self._log.append(entry)
                fired.append(entry)
                self._action_counts[rule.action] = (
                    self._action_counts.get(rule.action, 0) + 1
                )
                if rule.action == "drop":
                    decision.drop = True
                elif rule.action == "transport_error":
                    decision.transport_error = True
                elif rule.action == "delay":
                    decision.delay_s += rule.seconds
                elif rule.action == "reorder":
                    decision.delay_s += rule.seconds * draw
                elif rule.action == "duplicate":
                    decision.duplicates += 1
        for entry in fired:
            if metrics_registry.enabled:
                _m_chaos_events.inc(action=entry["action"])
            logger.debug(
                "chaos: %s %s#%d (rule %d)",
                entry["action"], entry["stream"], entry["n"], entry["rule"],
            )
        return decision

    # -- device faults ---------------------------------------------------

    def device_fault(self) -> bool:
        """True exactly once per scheduled device fault: the caller must
        fail that solve step."""
        with self._lock:
            if self._device_faults_left <= 0:
                return False
            self._device_faults_left -= 1
            n = self._device_fault_n
            self._device_fault_n += 1
            self._log.append(
                {"stream": "_device", "n": n, "action": "device_fault"}
            )
            self._action_counts["device_fault"] = (
                self._action_counts.get("device_fault", 0) + 1
            )
        if metrics_registry.enabled:
            _m_chaos_events.inc(action="device_fault")
        logger.warning("chaos: injecting device step fault #%d", n)
        return True

    # -- kill timeline ---------------------------------------------------

    def start(self, kill_cb: Optional[Callable[[str], None]]) -> None:
        """Start the timeline thread firing the schedule's kill events —
        agent kills through ``kill_cb(agent_name)``, whole-process kills
        (a durable solve's crash model) via ``os._exit``.  ``kill_cb=None``
        (direct-mode runs: no agents exist) arms ONLY the process kills;
        scheduled agent kills are logged as skipped.  Idempotent per
        controller."""
        kills = sorted(
            list(self.schedule.kills) + list(self.schedule.process_kills),
            key=lambda k: (
                k.at, getattr(k, "agent", ""),
            ),
        )
        with self._lock:
            if self._timeline_started:
                return
            self._timeline_started = True
        if not kills:
            return
        self._kill_thread = threading.Thread(
            target=self._run_timeline,
            args=(kills, kill_cb),
            name="chaos-timeline",
            daemon=True,
        )
        self._kill_thread.start()

    def _run_timeline(self, kills, kill_cb) -> None:
        from .schedule import KillProcessEvent

        t0 = time.monotonic()
        for n, k in enumerate(kills):
            wait = k.at - (time.monotonic() - t0)
            if wait > 0 and self._stop_evt.wait(wait):
                return
            if self._stop_evt.is_set():
                return
            if isinstance(k, KillProcessEvent):
                # abrupt whole-process death: nothing below this line runs.
                # The log entry cannot outlive the process — what survives
                # is what was already durably on disk (the checkpoints
                # this event exists to exercise)
                logger.warning(
                    "chaos: killing PROCESS (t=%.3fs, exit %d)",
                    k.at, k.exit_code,
                )
                import os
                import sys

                try:
                    sys.stderr.flush()
                    sys.stdout.flush()
                except Exception:  # noqa: BLE001 — dying anyway
                    pass
                os._exit(k.exit_code)
            if kill_cb is None:
                logger.warning(
                    "chaos: agent kill of %s skipped — no agent runtime "
                    "in this mode (direct-mode run)", k.agent,
                )
                continue
            # logged at FIRE time, not schedule time: a run whose timeout
            # cancels the tail of the timeline must not report kills that
            # never happened (Orchestrator.run waits for the timeline, so
            # a completed run always fires — and logs — the full schedule)
            with self._lock:
                self._log.append(
                    {
                        "stream": "_timeline",
                        "n": n,
                        "action": "kill",
                        "agent": k.agent,
                        "at": k.at,
                    }
                )
                self._action_counts["kill"] = (
                    self._action_counts.get("kill", 0) + 1
                )
            if metrics_registry.enabled:
                _m_chaos_events.inc(action="kill")
            logger.warning("chaos: killing agent %s (t=%.3fs)", k.agent, k.at)
            try:
                kill_cb(k.agent)
            except Exception:
                logger.exception("chaos: kill of %s failed", k.agent)

    def wait_timeline(self, timeout: Optional[float] = None) -> bool:
        """Block until every timeline event has fired AND its callback
        (crash + repair) returned.  The schedule defines the run's fault
        timeline: a kill due at t=0.15s happens even when the solve
        returned at t=0.05s — otherwise replaying the same schedule would
        exercise different faults depending on machine speed.  Returns
        False if the timeline is still running at ``timeout``."""
        t = self._kill_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def stop(self) -> None:
        """Cancel pending timeline events (already-fired ones stand)."""
        self._stop_evt.set()
        t = self._kill_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    # -- the event log ---------------------------------------------------

    def event_log(self) -> List[Dict[str, Any]]:
        """Canonical log: sorted by (stream, n, rule) so two runs of the
        same seed + schedule compare bit-identical regardless of thread
        interleaving."""
        with self._lock:
            return sorted(
                (dict(e) for e in self._log),
                key=lambda e: (e["stream"], e["n"], e.get("rule", -1)),
            )

    def action_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._action_counts)

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "seed": self.seed,
                    "events": self.event_log(),
                    "counts": self.action_counts(),
                },
                f,
                indent=2,
                sort_keys=True,
            )
            f.write("\n")
