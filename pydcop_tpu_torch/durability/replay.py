"""Replayable dynamic workloads: scenario-driven DynamicMaxSum sessions
with durable, resumable checkpoints.

Counterpart of ``pydcop_tpu/durability/replay.py``.  A device session
has no wall clock worth replaying: what makes a dynamic workload
reproducible is how many cycles ran between changes.  A
:class:`ScenarioSession` drives a
:class:`~pydcop_tpu_torch.algorithms.maxsum_dynamic.DynamicMaxSum`
session by a :class:`~pydcop_tpu_torch.dcop.scenario.Scenario` whose

- delay events advance ``int(delay)`` cycles of belief propagation (not
  seconds: the replay does not depend on the machine's speed), and
- action events change the problem mid-session: ``swap_factor`` (args
  ``constraint`` or ``name``, and ``function``, an expression over the
  same scope: the reference's ``change_factor_function``) and
  ``set_external`` (args ``name`` and ``value``, an ExternalVariable
  update).  Agent arrival and removal events belong to the agent
  runtime's scenario player and are refused.

After every event the session checkpoints through a
:class:`~.manager.CheckpointManager`, in the JAX package's format: the
session's leaves (``DynamicMaxSum._saved``), and a manifest with the
event cursor, the progress counters and ``plane_layout``.  So
:meth:`ScenarioSession.resume` restarts a killed workload from any
checkpoint of either package, replays the remaining events, and lands on
the uninterrupted run's trajectory bit for bit (per-cycle keys are
functions of the session seed and its cycle count).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from ..dcop.dcop import DCOP
from ..dcop.scenario import DcopEvent, EventAction, Scenario
from ..utils.checkpoint import CheckpointError
from .manager import (
    CheckpointManager,
    problem_fingerprint,
    read_manifest,
    resolve_checkpoint_path,
)

__all__ = ["ScenarioSession", "REPLAY_ACTIONS"]

logger = logging.getLogger("pydcop_tpu_torch.durability.replay")

#: the action types a device-session replay understands
REPLAY_ACTIONS = ("swap_factor", "set_external")


class ScenarioSession:
    """A durable, replayable dynamic MaxSum workload.

    Usage::

        sess = ScenarioSession(dcop, scenario, manager=mgr)
        result = sess.play()          # runs every event, checkpointing

        # the process is killed; later, from any checkpoint:
        sess = ScenarioSession.resume(dcop, scenario, mgr.directory)
        result = sess.play()          # replays the remaining events only
    """

    def __init__(
        self,
        dcop: DCOP,
        scenario: Scenario,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        manager: Optional[CheckpointManager] = None,
        device="cuda",
    ) -> None:
        from ..algorithms.maxsum_dynamic import DynamicMaxSum

        self.dcop = dcop
        self.scenario = scenario
        self.manager = manager
        self.session = DynamicMaxSum(dcop, params=params, seed=seed,
                                     device=device)
        self.cursor = 0  # the next scenario event to play
        self.cost_trace: List[float] = []  # the cost after each delay event
        self.last_result = None

    # -- events --------------------------------------------------------

    def _apply_action(self, action: EventAction) -> None:
        args = action.args
        if action.type == "swap_factor":
            from ..dcop.relations import relation_from_str

            name = args.get("constraint") or args.get("name")
            new = relation_from_str(
                name, str(args["function"]), self.dcop.variables.values()
            )
            self.session.change_factor_function(name, new)
        elif action.type == "set_external":
            self.dcop.external_variables[args["name"]].value = args["value"]
        else:
            raise ValueError(
                f"scenario action {action.type!r} is an agent-runtime "
                f"event (the orchestrator's scenario player); a "
                f"device-session replay understands {REPLAY_ACTIONS}"
            )

    def _play_event(self, event: DcopEvent) -> None:
        if event.is_delay:
            r = self.session.run(int(event.delay))
            self.cost_trace.append(r.cost)
            self.last_result = r
        else:
            for action in event.actions or []:
                self._apply_action(action)

    # -- driving -------------------------------------------------------

    def play(self):
        """Play every remaining event (from ``self.cursor``), with one
        checkpoint an event when a manager is attached.  Returns the last
        delay event's SolveResult (None if no delay event was left)."""
        events = self.scenario.events
        for i in range(self.cursor, len(events)):
            self._play_event(events[i])
            self.cursor = i + 1
            if self.manager is not None:
                self.checkpoint()
        return self.last_result

    def run(self, n_cycles: int):
        """Advance cycles outside the scenario (``DynamicMaxSum.run``),
        then checkpoint."""
        r = self.session.run(n_cycles)
        self.last_result = r
        if self.manager is not None:
            self.checkpoint()
        return r

    # -- durability ----------------------------------------------------

    def checkpoint(self) -> str:
        """One snapshot: the warm message state, the progress counters
        and the event cursor, under the changed problem's fingerprint."""
        s = self.session
        # rebind: a factor swap changes this one workload's fingerprint
        self.manager.rebind(
            s.compiled, "maxsum_dynamic", s.seed,
            float(s.params.get("noise") or 0.0), s._cycles_done,
        )
        return self.manager.save_carry(
            s._saved(),
            s._cycles_done,
            best_cost=(
                self.last_result.cost if self.last_result is not None
                else None
            ),
            kind="session",
            extra={"scenario_cursor": self.cursor},
            # the metadata DynamicMaxSum.restore reads: one manifest
            # serves the manager's tools and the session's restore
            manifest_fields={
                "cycles_done": s._cycles_done,
                "msg_count": s._msg_count,
                "plane_layout": "lanes" if s._lanes else "edges",
            },
        )

    @classmethod
    def resume(
        cls,
        dcop: DCOP,
        scenario: Scenario,
        path: str,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        manager: Optional[CheckpointManager] = None,
        device="cuda",
    ) -> "ScenarioSession":
        """A session rebuilt from a checkpoint (a file, or a directory
        whose newest checkpoint wins), its cursor after the events the
        dead run played.  A checkpoint of another problem is refused by
        its manifest's fingerprint."""
        path = resolve_checkpoint_path(path)
        manifest = read_manifest(path)
        self = cls(
            dcop, scenario, params=params,
            seed=int(manifest.get("seed", seed)), manager=manager,
            device=device,
        )
        self.cursor = int(
            (manifest.get("extra") or {}).get("scenario_cursor", 0)
        )
        # a checkpoint holds the message state, not the changed problem:
        # the scenario is the record of the changes, so the action events
        # already played are applied again (deterministic) before the
        # state is restored against the resulting tables; the fingerprint
        # is of the changed problem, so it is checked after them
        for event in scenario.events[: self.cursor]:
            if not event.is_delay:
                for action in event.actions or []:
                    self._apply_action(action)
        want = problem_fingerprint(self.session.compiled)
        got = manifest.get("fingerprint")
        if got is not None and got != want:
            raise CheckpointError(
                f"checkpoint {path} is from a DIFFERENT problem: manifest "
                f"fingerprint {got} (algo {manifest.get('algo')!r}) vs "
                f"this problem's {want} after replaying {self.cursor} "
                f"scenario event(s): refusing to resume the session"
            )
        self.session.restore(path)
        logger.info(
            "resumed dynamic session at cycle %s, scenario cursor %d/%d "
            "(%s)", manifest.get("cycle"), self.cursor,
            len(scenario.events), path,
        )
        return self

    def close(self) -> None:
        self.session.close()
