"""Decentralized k-resilience: UCS replication negotiation, replica
retraction and elasticity.

The port's copy of ``pydcop_tpu/resilience/``: pyDCOP's
``replication/dist_ucs_hostingcosts.py`` run as a real *distributed*
protocol (the AAMAS-2018 k-resilient replica placement): owner agents
negotiate replica hosts with visit/accept/refuse messages over the
ordinary control plane, capacity races resolve by refusal at message
time, accepted hosts publish replicas to discovery, and the retraction
path (pyDCOP's ``remove_replica``) shrinks placements on capacity loss,
migration or k-target decrease.

Two modes, selected by ``Orchestrator(replication_mode=...)`` /
``--replication-mode``:

* ``"distributed"`` (default): the negotiation protocol above; the
  orchestrator learns placements only from the owners' round reports and
  the hosts' retraction notices.
* ``"local"``: the centralized UCS
  (:func:`..replication.replicate_computations`): each owner ranks hosts
  locally from orchestrator-shipped agent definitions and ships replicas
  directly.  On a quiet network both modes place identically, so
  ``local`` trades the weaker failure model for O(k) messages per
  computation.

Everything here runs on the agents' threads and imports no torch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..infrastructure.orchestrator import REPLICATION_MODES
from ..telemetry.metrics import metrics_registry
from .messages import (
    CapacityMessage,
    ReplicaRetractedMessage,
    UCSAcceptMessage,
    UCSCommitMessage,
    UCSRefuseMessage,
    UCSReleaseMessage,
    UCSVisitMessage,
)
from .negotiation import (
    ReplicationComputation,
    footprint_of_def,
    replication_name,
)

__all__ = [
    "REPLICATION_MODES",
    "ReplicationComputation",
    "footprint_of_def",
    "replication_name",
    "replication_status_block",
    "CapacityMessage",
    "ReplicaRetractedMessage",
    "UCSAcceptMessage",
    "UCSCommitMessage",
    "UCSRefuseMessage",
    "UCSReleaseMessage",
    "UCSVisitMessage",
]


def _counter_total(name: str) -> int:
    m = metrics_registry.get(name)
    if m is None:
        return 0
    return int(sum(v["value"] for v in m.snapshot()["values"]))


def replication_status_block(
    mgt: Any, ktarget: Optional[int], mode: str
) -> Optional[Dict[str, Any]]:
    """The ``replication`` block of the orchestrator's ``/status`` payload:
    mode, k-target, achieved per-computation levels and the protocol
    counters.  ``None`` until a replication was requested."""
    if ktarget is None:
        return None
    levels = dict(mgt.replication_levels)
    return {
        "mode": mode,
        "ktarget": ktarget,
        "levels": levels,
        "below_target": sorted(
            c for c, n in levels.items() if n < ktarget
        ),
        "visits": _counter_total("replication.visits"),
        "refusals": _counter_total("replication.refusals"),
        "retractions": _counter_total("replication.retractions"),
        "visit_timeouts": _counter_total("replication.visit_timeouts"),
    }
