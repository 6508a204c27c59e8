"""Removal analysis: what breaks when agents leave.

The port's copy of ``pydcop_tpu/reparation/removal.py`` (pyDCOP's
``_removal_orphaned_computations``, ``_removal_candidate_agents``,
``_removal_candidate_computation_info``): given a departed agent, the
orphaned computations, the candidate host agents (replica holders when
replication ran, every survivor otherwise) and the per-candidate info
needed to set the repair DCOP up.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = [
    "removal_orphaned_computations",
    "removal_candidate_agents",
    "removal_candidate_computation_info",
]


def removal_orphaned_computations(
    distribution, removed_agent: str
) -> List[str]:
    """Computations that lose their host when ``removed_agent`` leaves
    (pyDCOP removal.py:38)."""
    return list(distribution.computations_hosted(removed_agent))


def removal_candidate_agents(
    orphans: List[str],
    survivors: Dict[str, Any],
    replica_hosts: Optional[Dict[str, List[str]]] = None,
) -> Dict[str, List[str]]:
    """Candidate hosts per orphan: the surviving replica holders when
    replication ran (pyDCOP removal.py:61 — only agents holding a replica
    can take a computation over), otherwise every survivor."""
    out: Dict[str, List[str]] = {}
    for comp in orphans:
        if replica_hosts and replica_hosts.get(comp):
            cands = [a for a in replica_hosts[comp] if a in survivors]
            if not cands:  # all replica holders died too: fall back to all
                cands = sorted(survivors)
        else:
            cands = sorted(survivors)
        out[comp] = cands
    return out


def removal_candidate_computation_info(
    comp: str, cg, distribution, removed_agent: str
) -> Dict[str, Any]:
    """The neighbor info a candidate host needs to price taking ``comp`` over
    (pyDCOP removal.py:101): neighbor computations and their current
    hosting agents (excluding the departed one)."""
    node = cg.computation(comp)
    neighbors: Dict[str, str] = {}
    for n in node.neighbors:
        try:
            a = distribution.agent_for(n)
        except (KeyError, ValueError):
            continue
        if a != removed_agent:
            neighbors[n] = a
    return {"computation": comp, "neighbors": neighbors}
