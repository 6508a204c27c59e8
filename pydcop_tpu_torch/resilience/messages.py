"""The message taxonomy of the decentralized replication protocol.

The port's copy of ``pydcop_tpu/resilience/messages.py`` (pyDCOP's
``replication/dist_ucs_hostingcosts.py`` messages): the uniform-cost
search negotiation speaks visit / accept / refuse between one owner agent and candidate replica
hosts, commit / release to finalize or retract a tentative reservation,
and ``replica_retracted`` upward to the orchestrator so its placement view
(``AgentsMgt.replica_hosts``, the directory, ``/status`` levels) tracks
hosts shedding replicas (pyDCOP's ``remove_replica``).

Every type is declared here and handled on
:class:`~.negotiation.ReplicationComputation` (or
``AgentsMgt`` for the upward ones).
"""

from __future__ import annotations

from ..infrastructure.computations import message_type

__all__ = [
    "UCSVisitMessage",
    "UCSAcceptMessage",
    "UCSRefuseMessage",
    "UCSCommitMessage",
    "UCSReleaseMessage",
    "ReplicaRetractedMessage",
    "CapacityMessage",
]

#: owner -> candidate: "can you host a replica of ``comp``?"  Carries the
#: serialized ComputationDef (replication is definition shipping, like
#: pyDCOP's) plus the owner's name/address so the candidate can route the
#: reply without a directory round-trip.  ``path_cost`` is the owner's
#: route-path cost to the candidate — echoed back for debuggability.
UCSVisitMessage = message_type(
    "ucs_visit", ["comp", "comp_def", "path_cost", "owner", "address"]
)

#: candidate -> owner: a tentative reservation was taken.  ``hosting_cost``
#: is the candidate's own hosting cost for ``comp`` — the owner completes
#: the UCS total (path + hosting) with it; hosting costs are *discovered*
#: during the search, never assumed known.
UCSAcceptMessage = message_type(
    "ucs_accept", ["comp", "host", "hosting_cost"]
)

#: candidate -> owner: cannot host (``reason``: "capacity" when the ledger
#: has no room, "owner" when the candidate now owns the computation itself).
#: Capacity races between owners resolve exactly here, at message time.
UCSRefuseMessage = message_type("ucs_refuse", ["comp", "host", "reason"])

#: owner -> candidate: the tentative reservation won — store the replica
#: and publish it to discovery.
UCSCommitMessage = message_type("ucs_commit", ["comp", "owner"])

#: owner -> candidate: drop the reservation.  For a tentative reservation
#: this is bookkeeping; for a committed replica it is the retraction path
#: (k-target decrease, a cheaper host displacing an incumbent on
#: re-replication).
UCSReleaseMessage = message_type("ucs_release", ["comp", "owner"])

#: host -> orchestrator: a committed replica was removed (released by its
#: owner, shed on capacity loss, or dropped on migration) — the
#: orchestrator prunes ``replica_hosts``/directory/levels accordingly.
ReplicaRetractedMessage = message_type(
    "replica_retracted", ["agent", "comp", "reason"]
)

#: orchestrator -> host: the agent's effective capacity changed
#: (``Orchestrator.set_agent_capacity``); the host re-checks its ledger and
#: sheds the most expensive replicas until it fits again.
CapacityMessage = message_type("replica_capacity", ["capacity"])
