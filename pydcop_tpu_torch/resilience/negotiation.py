"""The decentralized UCS replication negotiation.

The port's copy of ``pydcop_tpu/resilience/negotiation.py`` (pyDCOP's
``replication/dist_ucs_hostingcosts.py``: ``UCSReplication``,
``replicate(k)``, ``remove_replica``), host only: every agent hosts a ``_replication_<agent>`` computation that plays both
sides of the protocol —

* **owner side**: for each hosted computation, walk candidate hosts in
  increasing (route-path + hosting) cost with *real messages*.  The walk is
  a lazy uniform-cost search: candidates are visited in increasing
  route-path cost; a visit discovers the candidate's hosting cost (and
  takes a tentative capacity reservation) or is refused; a priced candidate
  is committed as soon as its total cost cannot be beaten by any unvisited
  one (hosting costs are non-negative, so ``total <= cheapest unvisited
  path`` suffices).  On a quiet network this provably selects exactly the
  ``k`` cheapest hosts of the centralized oracle
  (:func:`..replication.ucs_replica_hosts`) with the same
  ``(cost, name)`` tie-breaks — the property tested by the quiet-network
  equivalence suite.

* **candidate side**: a per-agent capacity ledger (own deployed
  computations + reserved/committed replicas, footprints from the
  algorithm's ``computation_memory``).  A visit that fits takes a tentative
  reservation and answers *accept*; one that does not answers *refuse* —
  capacity races between concurrent owners are resolved by refusal at
  message time, with no global knowledge anywhere.

Retraction (pyDCOP's ``remove_replica``): committed replicas are released
when the owner's new round selects a cheaper host, when the k-target
decreases, when the host's capacity shrinks (most-expensive-first shedding)
or when the computation migrates onto its own replica host.  Every
retraction unpublishes the replica from discovery and reports upward
(``replica_retracted``), so placements can *shrink*.

Failure model: the state machine is single-threaded on the agent loop (no
locks, like every computation); visit timeouts treat a silent candidate as
a refusal, tentative reservations expire after ``reservation_ttl`` so a
crashed owner cannot leak capacity, and a commit whose reservation already
expired reports ``replica_retracted`` instead of silently diverging.
"""

from __future__ import annotations

import heapq
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from ..infrastructure.communication import MSG_MGT
from ..infrastructure.computations import (
    MessagePassingComputation,
    register,
)
from ..infrastructure.orchestrator import (
    ComputationReplicatedMessage,
    ORCHESTRATOR_MGT,
)
from ..replication.path_utils import owner_paths
from ..telemetry.metrics import metrics_registry
from ..telemetry.tracing import tracer
from .messages import (
    ReplicaRetractedMessage,
    UCSAcceptMessage,
    UCSCommitMessage,
    UCSRefuseMessage,
    UCSReleaseMessage,
    UCSVisitMessage,
)

__all__ = ["ReplicationComputation", "footprint_of_def", "replication_name"]

logger = logging.getLogger("pydcop_tpu_torch.resilience")

# one counter family per protocol verb; labeled by agent so /status can
# show totals while Prometheus keeps the per-agent split
_m_visits = metrics_registry.counter(
    "replication.visits", "ucs_visit messages received, by candidate agent"
)
_m_accepts = metrics_registry.counter(
    "replication.accepts", "tentative reservations taken, by candidate"
)
_m_refusals = metrics_registry.counter(
    "replication.refusals", "visits refused (capacity/owner), by candidate"
)
_m_retractions = metrics_registry.counter(
    "replication.retractions",
    "committed replicas removed (released/shed/migrated), by host",
)
_m_timeouts = metrics_registry.counter(
    "replication.visit_timeouts",
    "visits that timed out and were treated as refusals, by owner",
)


def replication_name(agent_name: str) -> str:
    """The replication computation's name on ``agent_name``."""
    return f"_replication_{agent_name}"


def footprint_of_def(comp_def: Any) -> float:
    """Capacity footprint of a computation definition — the algorithm
    module's ``computation_memory`` (1.0 when the algorithm declares none).
    Owner and candidate both use THIS helper, so the ledger the candidate
    enforces is exactly the load the owner advertises."""
    from ..algorithms import load_algorithm_module

    try:
        mod = load_algorithm_module(comp_def.algo.algo)
    except Exception:
        return 1.0
    fn = getattr(mod, "computation_memory", None)
    if fn is None:
        return 1.0
    try:
        return float(fn(comp_def.node))
    except (NotImplementedError, ValueError, AttributeError):
        return 1.0


class ReplicationComputation(MessagePassingComputation):
    """Both halves of the replication protocol on one agent (see module doc)."""

    def __init__(
        self,
        agent: Any,
        visit_timeout: float = 2.0,
        reservation_ttl: float = 30.0,
    ) -> None:
        super().__init__(replication_name(agent.name))
        self.agent = agent
        #: a silent candidate (killed mid-negotiation, dropped message)
        #: counts as a refusal after this many seconds
        self.visit_timeout = visit_timeout
        #: tentative reservations expire after this long — a crashed owner
        #: must not leak candidate capacity forever
        self.reservation_ttl = reservation_ttl
        # candidate-side ledger: (owner, comp) -> reservation record
        self._reservations: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._capacity_override: Optional[float] = None
        # incremental deployed-load accumulator: rescanning agent.deployed
        # on every deploy ack would make large deployments O(n^2) — the
        # exact trap the deploy path already dodged twice.  The footprints
        # of new deployments are summed when the ledger is first read
        # (``_pending_defs``): pricing reads the algorithm's module, which
        # imports torch, and an agent that never prices a replica (no
        # replication round) never imports it
        self._deployed_load = 0.0
        self._deployed_seen: set = set()
        self._pending_defs: List[Any] = []
        # owner-side negotiation state: one round at a time, one
        # negotiation (and one outstanding visit) at a time within it
        self._round: Optional[Dict[str, Any]] = None
        self._neg: Optional[Dict[str, Any]] = None
        #: comp -> hosts selected by the last finished negotiation; the
        #: diff against a new round's selection drives retraction
        self._my_replica_hosts: Dict[str, List[str]] = {}
        self.add_periodic_action(0.1, self._on_tick)

    # ------------------------------------------------------------------
    # owner side: one round = (re)negotiate every hosted computation
    # ------------------------------------------------------------------

    def start_round(
        self, k: int, agents: Dict[str, Any], round_id: Any = None
    ) -> None:
        """Negotiate ``k`` replicas for every deployed computation against
        the ``agents`` membership view (name -> address).  Called on the
        agent thread by the ``replication`` management handler; the ack
        (``ComputationReplicatedMessage``, echoing ``round_id``) is posted
        when the round finishes — possibly at *partial k* when fewer
        hosts can accept."""
        if self._round is not None:
            # a re-replication request preempts the active round: release
            # what the in-flight negotiation priced, and REMEMBER what it
            # already committed (commits are sent eagerly) — merged into
            # _my_replica_hosts so the new round's retraction diff can
            # release those hosts if they lose; dropping them here would
            # leak their capacity and discovery entries forever
            logger.info(
                "%s: new replication round preempts the active one",
                self.name,
            )
            if self._neg is not None:
                self._release_priced(self._neg)
                comp = self._neg["comp"]
                merged = list(
                    dict.fromkeys(
                        self._my_replica_hosts.get(comp, [])
                        + self._neg["committed"]
                    )
                )
                self._my_replica_hosts[comp] = merged
                self._neg = None
        others = [a for a in agents if a != self.agent.name]
        self._round = {
            "k": int(k),
            "agents": dict(agents),
            "round_id": round_id,
            # one UCS over the route graph per ROUND: path costs depend
            # only on the membership view, not on the computation
            "dist": owner_paths(
                self.agent.name, self._route_cost,
                [self.agent.name] + others,
            ),
            "others": others,
            "placements": {},
            "pending": sorted(self.agent.deployed),
            "t0": time.perf_counter(),
        }
        self._next_negotiation()

    def _next_negotiation(self) -> None:
        rnd = self._round
        if rnd is None:
            return
        while rnd["pending"]:
            comp = rnd["pending"].pop(0)
            holder = self.agent._computations.get(comp)
            comp_def = getattr(holder, "computation_def", None)
            if comp_def is None:
                continue
            dist = rnd["dist"]
            frontier = [
                (dist.get(a, float("inf")), a) for a in rnd["others"]
            ]
            heapq.heapify(frontier)
            self._neg = {
                "comp": comp,
                "comp_def": comp_def,
                "k": rnd["k"],
                "frontier": frontier,
                "path": dict(dist),
                "priced": [],
                "committed": [],
                "outstanding": None,
                "t0": time.perf_counter(),
                "visits": 0,
                "refusals": 0,
                "timeouts": 0,
            }
            self._advance()
            return
        self._finish_round()

    def _route_to(self, host: str) -> None:
        """Route to ``host``'s replication computation from the round's
        membership view, registered as the round first writes to it (a
        visit, or the release of a previous round's replica; commits and
        releases follow a visit).  Registering every agent's route when
        the round starts, as the JAX package does, costs each agent a
        route an agent: with hundreds of agents their rounds' starts,
        serialized by the interpreter's lock, spread over seconds, and a
        visit to an agent that had not started its own round yet waited
        for it, close to the visits' 2 s timeout."""
        self.agent.messaging.register_route(
            replication_name(host), host, self._round["agents"][host]
        )

    def _route_cost(self, a: str, b: str) -> float:
        # the owner legitimately knows only its OWN routes; other hops
        # default to 1.0 — same knowledge model as the centralized oracle
        # run agent-side, so quiet-network placements agree exactly
        if a == self.agent.name and self.agent.agent_def is not None:
            return float(self.agent.agent_def.route(b))
        return 1.0

    def _advance(self) -> None:
        neg = self._neg
        if neg is None:
            return
        while True:
            if neg["outstanding"] is not None:
                return
            if len(neg["committed"]) >= neg["k"]:
                self._finish_negotiation(neg)
                return
            top_priced = neg["priced"][0] if neg["priced"] else None
            top_frontier = neg["frontier"][0] if neg["frontier"] else None
            if top_priced is not None and (
                top_frontier is None or top_priced[0] < top_frontier[0]
            ):
                # UCS commit rule: hosting costs are >= 0, so no unvisited
                # candidate (cheapest remaining path top_frontier[0]) can
                # undercut this priced total.  STRICT <: on an exact cost
                # tie an unvisited candidate with hosting 0 could match
                # the priced total and win the (cost, name) tie-break —
                # keep visiting so placements equal the oracle's exactly
                _total, host = heapq.heappop(neg["priced"])
                self.post_msg(
                    replication_name(host),
                    UCSCommitMessage(
                        comp=neg["comp"], owner=self.agent.name
                    ),
                    MSG_MGT,
                )
                neg["committed"].append(host)
                continue
            if top_frontier is not None:
                path_cost, cand = heapq.heappop(neg["frontier"])
                self._route_to(cand)
                neg["outstanding"] = (cand, time.monotonic())
                neg["visits"] += 1
                self.post_msg(
                    replication_name(cand),
                    UCSVisitMessage(
                        comp=neg["comp"],
                        comp_def=neg["comp_def"],
                        path_cost=path_cost,
                        owner=self.agent.name,
                        address=self.agent.communication.address,
                    ),
                    MSG_MGT,
                )
                return
            # frontier and priced both exhausted: partial k is a RESULT,
            # not a failure — the achieved level is reported upward
            self._finish_negotiation(neg)
            return

    def _release_priced(self, neg: Dict[str, Any]) -> None:
        for _total, host in neg["priced"]:
            self.post_msg(
                replication_name(host),
                UCSReleaseMessage(comp=neg["comp"], owner=self.agent.name),
                MSG_MGT,
            )
        neg["priced"] = []

    def _finish_negotiation(self, neg: Dict[str, Any]) -> None:
        rnd = self._round
        comp = neg["comp"]
        self._release_priced(neg)
        # retraction diff: hosts selected by a PREVIOUS round that lost to
        # cheaper candidates (or to a smaller k) get an explicit release
        for host in self._my_replica_hosts.get(comp, []):
            if host not in neg["committed"] and host in rnd["agents"]:
                self._route_to(host)
                self.post_msg(
                    replication_name(host),
                    UCSReleaseMessage(comp=comp, owner=self.agent.name),
                    MSG_MGT,
                )
        self._my_replica_hosts[comp] = list(neg["committed"])
        rnd["placements"][comp] = list(neg["committed"])
        if len(neg["committed"]) < neg["k"]:
            logger.warning(
                "%s: %s replicated at partial k: %d/%d (visits=%d "
                "refusals=%d timeouts=%d)",
                self.name, comp, len(neg["committed"]), neg["k"],
                neg["visits"], neg["refusals"], neg["timeouts"],
            )
        if tracer.enabled:
            t0 = neg["t0"]
            tracer.complete(
                "replication.negotiate", t0, time.perf_counter() - t0,
                cat="replication", comp=comp, owner=self.agent.name,
                k=neg["k"], placed=len(neg["committed"]),
                visits=neg["visits"], refusals=neg["refusals"],
                timeouts=neg["timeouts"],
            )
        self._neg = None
        self._next_negotiation()

    def _finish_round(self) -> None:
        rnd, self._round = self._round, None
        self.post_msg(
            ORCHESTRATOR_MGT,
            ComputationReplicatedMessage(
                agent=self.agent.name, replica_hosts=rnd["placements"],
                round=rnd["round_id"],
            ),
            MSG_MGT,
        )
        logger.debug(
            "%s: replication round done: %s", self.name, rnd["placements"]
        )

    # -- owner side: replies -------------------------------------------

    @register("ucs_accept")
    def _on_accept(self, sender: str, msg, t: float) -> None:
        neg = self._neg
        host = msg.host
        if (
            neg is None
            or neg["comp"] != msg.comp
            or neg["outstanding"] is None
            or neg["outstanding"][0] != host
        ):
            # a DUPLICATED accept (at-least-once transport, chaos
            # 'duplicate' faults) for a reservation the active negotiation
            # still holds priced or committed must be ignored, not
            # released — releasing it would strand the later commit
            if neg is not None and neg["comp"] == msg.comp:
                if host in neg["committed"] or any(
                    h == host for _t, h in neg["priced"]
                ):
                    return
            # a genuinely late accept (the visit already timed out, or the
            # round was preempted): unless this host ended up selected
            # anyway, tell it to drop the reservation so no capacity leaks
            if host not in self._my_replica_hosts.get(msg.comp, []):
                self.post_msg(
                    replication_name(host),
                    UCSReleaseMessage(
                        comp=msg.comp, owner=self.agent.name
                    ),
                    MSG_MGT,
                )
            return
        neg["outstanding"] = None
        # hosting costs are clamped at 0 for ORDERING so the UCS commit
        # rule stays sound; the oracle applies the same clamp
        total = neg["path"].get(host, 1.0) + max(
            0.0, float(msg.hosting_cost)
        )
        heapq.heappush(neg["priced"], (total, host))
        self._advance()

    @register("ucs_refuse")
    def _on_refuse(self, sender: str, msg, t: float) -> None:
        neg = self._neg
        if (
            neg is None
            or neg["comp"] != msg.comp
            or neg["outstanding"] is None
            or neg["outstanding"][0] != msg.host
        ):
            return
        neg["outstanding"] = None
        neg["refusals"] += 1
        self._advance()

    # ------------------------------------------------------------------
    # candidate side: the capacity ledger
    # ------------------------------------------------------------------

    def _capacity(self) -> float:
        if self._capacity_override is not None:
            return self._capacity_override
        if self.agent.agent_def is not None:
            return float(self.agent.agent_def.capacity)
        return float("inf")

    def _remaining_capacity(self) -> float:
        if self._pending_defs:
            for comp_def in self._pending_defs:
                self._deployed_load += footprint_of_def(comp_def)
            self._pending_defs = []
        used = self._deployed_load + sum(
            r["footprint"] for r in self._reservations.values()
        )
        return self._capacity() - used

    def _hosting_cost(self, comp: str) -> float:
        if self.agent.agent_def is None:
            return 0.0
        return float(self.agent.agent_def.hosting_cost(comp))

    # every visit MUST price or refuse — a silent exit path is exactly
    # the shape that stalls the owner's frontier walk until the visit
    # timeout charges this host with a phantom refusal
    @register("ucs_visit")
    def _on_visit(self, sender: str, msg, t: float) -> None:
        owner = msg.owner
        self.agent.messaging.register_route(
            replication_name(owner), owner, msg.address
        )
        if metrics_registry.enabled:
            _m_visits.inc(agent=self.agent.name)
        key = (owner, msg.comp)
        existing = self._reservations.get(key)
        if existing is None:
            # the same computation under a DIFFERENT owner (it migrated
            # after its old owner died): transfer the reservation to the
            # new owner instead of charging the footprint twice — the old
            # key would otherwise never be reclaimed (committed entries
            # don't TTL-expire) and the phantom charge would make this
            # host refuse replicas it has room for
            stale = [
                k for k in self._reservations
                if k[1] == msg.comp and k[0] != owner
            ]
            if stale:
                rec = self._reservations.pop(stale[0])
                for k2 in stale[1:]:
                    self._reservations.pop(k2, None)
                self._reservations[key] = existing = rec
        if existing is not None:
            # idempotent re-visit (re-replication round over an incumbent
            # host): already paid for, accept at no extra charge
            existing["t"] = time.monotonic()
            self.post_msg(
                replication_name(owner),
                UCSAcceptMessage(
                    comp=msg.comp, host=self.agent.name,
                    hosting_cost=self._hosting_cost(msg.comp),
                ),
                MSG_MGT,
            )
            return
        if msg.comp in self._deployed_seen:
            # the candidate OWNS the computation (migration landed it
            # here): a replica would be pointless.  (_deployed_seen is
            # the set twin of agent.deployed — the list would make every
            # visit O(hosted).)
            self._refuse(owner, msg.comp, "owner")
            return
        footprint = footprint_of_def(msg.comp_def)
        if footprint <= self._remaining_capacity():
            self._reservations[key] = {
                "footprint": footprint,
                "comp_def": msg.comp_def,
                "committed": False,
                "t": time.monotonic(),
            }
            if metrics_registry.enabled:
                _m_accepts.inc(agent=self.agent.name)
            self.post_msg(
                replication_name(owner),
                UCSAcceptMessage(
                    comp=msg.comp, host=self.agent.name,
                    hosting_cost=self._hosting_cost(msg.comp),
                ),
                MSG_MGT,
            )
        else:
            self._refuse(owner, msg.comp, "capacity")

    def _refuse(self, owner: str, comp: str, reason: str) -> None:
        if metrics_registry.enabled:
            _m_refusals.inc(agent=self.agent.name, reason=reason)
        logger.debug(
            "%s: refusing replica of %s for %s (%s)",
            self.name, comp, owner, reason,
        )
        self.post_msg(
            replication_name(owner),
            UCSRefuseMessage(
                comp=comp, host=self.agent.name, reason=reason
            ),
            MSG_MGT,
        )

    @register("ucs_commit")
    def _on_commit(self, sender: str, msg, t: float) -> None:
        key = (msg.owner, msg.comp)
        r = self._reservations.get(key)
        if r is None:
            # the reservation expired (owner stalled past reservation_ttl)
            # or was released by a preempting round: without the shipped
            # definition nothing can be hosted — report the divergence
            # upward instead of leaving the owner's view silently wrong
            logger.warning(
                "%s: commit for %s/%s without a live reservation",
                self.name, msg.owner, msg.comp,
            )
            self.post_msg(
                ORCHESTRATOR_MGT,
                ReplicaRetractedMessage(
                    agent=self.agent.name, comp=msg.comp,
                    reason="lost-reservation",
                ),
                MSG_MGT,
            )
            return
        if r["committed"]:
            return  # duplicated commit (at-least-once transport)
        r["committed"] = True
        self.agent.replica_store[msg.comp] = r["comp_def"]
        self.agent.discovery.register_replica(msg.comp)

    @register("ucs_release")
    def _on_release(self, sender: str, msg, t: float) -> None:
        key = (msg.owner, msg.comp)
        r = self._reservations.pop(key, None)
        if r is not None and r["committed"]:
            self._retract(msg.comp, "released")

    def adopt_replica(self, owner: str, comp: str, comp_def: Any) -> None:
        """Ledger entry + publication for a replica shipped OUTSIDE the
        negotiation (``store_replica``, the ``replication_mode="local"``
        fast path): capacity is not re-checked — local mode's documented
        deviation — but the replica still lives in the same ledger so
        shedding and retraction treat both modes alike."""
        self._reservations[(owner, comp)] = {
            "footprint": footprint_of_def(comp_def),
            "comp_def": comp_def,
            "committed": True,
            "t": time.monotonic(),
        }
        self.agent.replica_store[comp] = comp_def
        self.agent.discovery.register_replica(comp)

    def _retract(self, comp: str, reason: str) -> None:
        # keep the store entry if ANOTHER owner still has it committed
        # (a comp re-owned after migration can be replicated twice here)
        still_committed = any(
            r["committed"]
            for (_o, c), r in self._reservations.items()
            if c == comp
        )
        if not still_committed and comp in self.agent.replica_store:
            del self.agent.replica_store[comp]
            self.agent.discovery.unregister_replica(comp)
        if metrics_registry.enabled:
            _m_retractions.inc(agent=self.agent.name, reason=reason)
        logger.info(
            "%s: retracted replica of %s (%s)", self.name, comp, reason
        )
        self.post_msg(
            ORCHESTRATOR_MGT,
            ReplicaRetractedMessage(
                agent=self.agent.name, comp=comp, reason=reason
            ),
            MSG_MGT,
        )

    @register("replica_capacity")
    def _on_capacity(self, sender: str, msg, t: float) -> None:
        self._capacity_override = float(msg.capacity)
        logger.info(
            "%s: capacity set to %.1f", self.name, self._capacity_override
        )
        self._shed_if_over()

    def on_deployed(self, comp: str) -> None:
        """Hook from the deploy handler: a computation landing on this
        agent consumes capacity and may shadow its own replica here.
        Called once per deploy ack — everything here must be O(1)-ish in
        the hosted count (see ``_deployed_load``)."""
        if comp not in self._deployed_seen:
            self._deployed_seen.add(comp)
            holder = self.agent._computations.get(comp)
            comp_def = getattr(holder, "computation_def", None)
            if comp_def is not None:
                self._pending_defs.append(comp_def)
        if not self._reservations:
            return  # nothing to shadow or shed — the common deploy path
        keys = [k for k in self._reservations if k[1] == comp]
        if keys:
            committed = any(
                self._reservations[k]["committed"] for k in keys
            )
            for k in keys:
                del self._reservations[k]
            if committed:
                self._retract(comp, "migrated")
        self._shed_if_over()

    def _shed_if_over(self) -> None:
        """Capacity loss: drop the most expensive committed replicas until
        the ledger fits again (pyDCOP's ``remove_replica``: the
        half of the protocol that makes placements able to SHRINK)."""
        while self._remaining_capacity() < 0:
            committed = [
                (self._hosting_cost(c), c, key)
                for key, r in self._reservations.items()
                for c in [key[1]]
                if r["committed"]
            ]
            if not committed:
                break
            _cost, comp, key = max(committed)
            del self._reservations[key]
            self._retract(comp, "capacity")

    # ------------------------------------------------------------------
    # timeouts (agent-loop tick, same thread as every handler)
    # ------------------------------------------------------------------

    def _on_tick(self) -> None:
        now = time.monotonic()
        neg = self._neg
        if neg is not None and neg["outstanding"] is not None:
            cand, t_sent = neg["outstanding"]
            if now - t_sent >= self.visit_timeout:
                logger.warning(
                    "%s: visit of %s for %s timed out after %.1fs — "
                    "treating as refusal",
                    self.name, cand, neg["comp"], self.visit_timeout,
                )
                neg["outstanding"] = None
                neg["timeouts"] += 1
                if metrics_registry.enabled:
                    _m_timeouts.inc(agent=self.agent.name)
                self._advance()
        for key, r in list(self._reservations.items()):
            if not r["committed"] and now - r["t"] > self.reservation_ttl:
                del self._reservations[key]

    # -- introspection (tests, /status) --------------------------------

    def reservation_count(self, committed: Optional[bool] = None) -> int:
        if committed is None:
            return len(self._reservations)
        return sum(
            1
            for r in self._reservations.values()
            if r["committed"] == committed
        )
