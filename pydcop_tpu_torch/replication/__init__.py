"""Replica placement: k-resilience by shipping computation definitions.

The port's copy of ``pydcop_tpu/replication/__init__.py`` (pyDCOP's
``replication/dist_ucs_hostingcosts.py``, ``UCSReplication.replicate``):
every agent places k replicas of each hosted ``ComputationDef`` on other
agents, visiting candidates in increasing path cost (route costs plus the
candidate's hosting cost), subject to capacity; replica hosts publish
their replicas to discovery.  Replicas are serialized *definitions*, not
solver state (the solve's state is checkpointed by ``durability/``).

This module is the CENTRALIZED half (``replication_mode="local"``): each
owner runs the uniform-cost search locally over hosting costs and
capacities the orchestrator shipped with the request, then sends one
``store_replica`` message per replica: O(k) messages instead of a
negotiation, at the price of assuming orchestrator-accurate knowledge.
The *distributed* protocol (``replication_mode="distributed"``, the
default) lives in ``resilience/``; on a quiet network the two place
identically (:func:`ucs_replica_hosts` is the shared cost model), which
keeps this path a verifiable oracle.  Host only: no torch.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from .path_utils import owner_paths, ucs_paths

__all__ = ["replicate_computations", "hosting_cost_of", "ucs_replica_hosts",
           "rank_hosts"]

logger = logging.getLogger("pydcop_tpu_torch.replication")


def hosting_cost_of(agent_defs: Dict[str, Any], agent: str, comp: str) -> float:
    a = agent_defs.get(agent)
    if a is None:
        return 0.0
    try:
        return float(a.hosting_cost(comp))
    except Exception:
        return 0.0


def ucs_replica_hosts(
    owner: str,
    comp: str,
    k: int,
    agents: List[str],
    route_cost,
    hosting_cost,
) -> List[str]:
    """The k cheapest replica hosts for ``comp`` owned by ``owner``:
    candidates ranked by cheapest route-path cost from the owner plus the
    candidate's hosting cost for the computation (pyDCOP's UCS cost
    model, dist_ucs_hostingcosts.py:60-84).

    This is THE shared cost model of both replication modes: hosting costs
    are clamped at 0 (like the protocol's commit rule, which relies on
    non-negative terminal costs) and ties break on the agent name, so the
    distributed negotiation provably commits exactly this list on a quiet
    network."""
    return rank_hosts(owner, comp, k, agents,
                      ucs_paths(owner, route_cost, agents), hosting_cost)


def rank_hosts(
    owner: str,
    comp: str,
    k: int,
    agents: List[str],
    dist: Dict[str, float],
    hosting_cost,
) -> List[str]:
    """``ucs_replica_hosts`` given the owner's path costs ``dist``."""
    ranked = sorted(
        (a for a in agents if a != owner),
        key=lambda a: (
            dist.get(a, float("inf")) + max(0.0, hosting_cost(a, comp)),
            a,
        ),
    )
    return ranked[:k]


def replicate_computations(
    agent, k: int, agent_defs: Optional[Dict[str, Any]] = None
) -> Dict[str, List[str]]:
    """Agent-side centralized replication (``replication_mode="local"``):
    place k replicas of every deployed computation and ship their
    ComputationDefs to the chosen hosts.  Returns {computation: [hosts]}.

    ``agent`` is an OrchestratedAgent; the known agent list + addresses come
    from the replication request (stored on the agent as ``known_agents``).
    ``agent_defs`` — ``{name: simple_repr(AgentDef)}`` shipped by the
    orchestrator — supplies remote hosting costs and capacities; THIS is the
    orchestrator-accurate knowledge that makes local mode a deviation from
    pyDCOP's failure model (the distributed protocol discovers both
    by visiting).  Capacity is a static per-candidate filter here: cross-
    owner races cannot be modeled without messages, so contended capacity
    is exactly where the two modes may diverge (documented in
    docs/resilience.md)."""
    from ..infrastructure.communication import MSG_MGT
    from ..infrastructure.computations import Message
    from ..resilience.negotiation import footprint_of_def
    from ..utils.simple_repr import from_repr

    known: Dict[str, Any] = getattr(agent, "known_agents", {})
    others = [a for a in known if a != agent.name]
    if not others:
        logger.warning(
            "%s: no known agents to replicate on", agent.name
        )
        return {}

    defs: Dict[str, Any] = {}
    for name, rep in (agent_defs or {}).items():
        try:
            defs[name] = from_repr(rep)
        except Exception:
            logger.warning(
                "%s: undecodable AgentDef for %s in replication request",
                agent.name, name,
            )

    def route_cost(a: str, b: str) -> float:
        # same knowledge model as the distributed owner: only the owner's
        # OWN routes are known, other hops default to 1.0 — keeping the
        # two modes' path costs (and so their placements) comparable
        if agent.agent_def is not None and a == agent.name:
            return float(agent.agent_def.route(b))
        return 1.0

    def hosting_cost(a: str, comp: str) -> float:
        return hosting_cost_of(defs, a, comp)

    hosts_by_comp: Dict[str, List[str]] = {}
    for comp_name in sorted(agent.deployed):
        comp = agent.computation(comp_name)
        comp_def = getattr(comp, "computation_def", None)
        if comp_def is None:
            continue
        footprint = footprint_of_def(comp_def)
        candidates = [agent.name] + [
            a
            for a in others
            if a not in defs or float(defs[a].capacity) >= footprint
        ]
        # ranking is per computation: hosting costs differ per comp, and
        # fewer than k rankable hosts is a partial-k RESULT, not an error
        hosts = rank_hosts(
            agent.name, comp_name, k, candidates,
            owner_paths(agent.name, route_cost, candidates), hosting_cost,
        )
        for h in hosts:
            agent.messaging.register_route(f"_mgt_{h}", h, known[h])
            agent.orchestration.post_msg(
                f"_mgt_{h}",
                Message("store_replica", (comp_name, comp_def)),
                MSG_MGT,
            )
        hosts_by_comp[comp_name] = hosts
        if len(hosts) < k:
            logger.warning(
                "%s: %s replicated at partial k: %d/%d",
                agent.name, comp_name, len(hosts), k,
            )
        logger.info(
            "%s: replicas of %s on %s", agent.name, comp_name, hosts
        )
    return hosts_by_comp
