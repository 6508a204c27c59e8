"""Repair DCOPs: re-hosting orphaned computations after agent failures.

The port's copy of ``pydcop_tpu/reparation/__init__.py`` (pyDCOP's
``reparation/__init__.py``): the four constraint builders over binary
variables ``x_(computation, agent)``:
``create_computation_hosted_constraint`` (hard: each orphan hosted
exactly once), ``create_agent_capacity_constraint`` (hard),
``create_agent_hosting_constraint`` (soft hosting costs) and
``create_agent_comp_comm_constraint`` (soft communication costs: the
algorithm's ``communication_load`` times route costs).

pyDCOP solves this DCOP with MGM-2 distributed across the surviving
agents.  The JAX package and the port frame repair the same way, *as
just another DCOP*, and solve it with MGM-2 on the device:
``repair_dcop`` builds the problem, ``repair_distribution`` solves it on
``device`` (the card unless the caller asks for the CPU) and applies the
result.  The two fallbacks of the JAX package are kept as it has them:
a greedy placement when the repair DCOP is too large to tabulate, and
the cheapest candidate for an orphan that MGM-2 gave no host or several.
Each is counted (``repair_distribution.greedy``, ``.repicked`` and the
metrics ``repair.greedy_placements``, ``repair.repicked_orphans``).  A
failure of the solve itself is an error, never a reason to place
greedily.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from ..dcop.dcop import DCOP
from ..dcop.objects import AgentDef, BinaryVariable
from ..dcop.relations import NAryFunctionRelation
from ..telemetry.metrics import metrics_registry
from .removal import (
    removal_candidate_agents,
    removal_orphaned_computations,
)

__all__ = [
    "create_computation_hosted_constraint",
    "create_agent_capacity_constraint",
    "create_agent_hosting_constraint",
    "create_agent_comp_comm_constraint",
    "repair_dcop",
    "repair_distribution",
]

logger = logging.getLogger("pydcop_tpu_torch.reparation")

_m_greedy = metrics_registry.counter(
    "repair.greedy_placements",
    "repairs placed greedily: the repair DCOP was too large to tabulate",
)
_m_repicked = metrics_registry.counter(
    "repair.repicked_orphans",
    "orphans that MGM-2 gave no host or several, re-picked by hosting cost",
)

HARD = 10000.0


def binary_var_name(computation: str, agent: str) -> str:
    return f"x_{computation}__{agent}"


def create_computation_hosted_constraint(
    computation: str, candidate_vars: List[BinaryVariable]
):
    """Hard constraint: exactly one candidate agent hosts ``computation``
    (pyDCOP reparation/__init__.py:39)."""

    def hosted(**kw) -> float:
        return 0.0 if sum(kw.values()) == 1 else HARD

    return NAryFunctionRelation(
        hosted, candidate_vars, name=f"hosted_{computation}"
    )


def create_agent_capacity_constraint(
    agent: AgentDef,
    remaining_capacity: float,
    footprints: Dict[str, float],
    candidate_vars: Dict[str, BinaryVariable],
):
    """Hard constraint: the footprints of the orphans accepted by ``agent``
    must fit its remaining capacity (pyDCOP :70)."""
    comps = sorted(candidate_vars)
    variables = [candidate_vars[c] for c in comps]

    def capacity_ok(**kw) -> float:
        load = sum(
            footprints[c]
            for c in comps
            if kw[candidate_vars[c].name]
        )
        return 0.0 if load <= remaining_capacity else HARD

    return NAryFunctionRelation(
        capacity_ok, variables, name=f"capacity_{agent.name}"
    )


def create_agent_hosting_constraint(
    agent: AgentDef, candidate_vars: Dict[str, BinaryVariable]
):
    """Soft constraint: sum of hosting costs of the accepted orphans
    (pyDCOP :117)."""
    comps = sorted(candidate_vars)
    variables = [candidate_vars[c] for c in comps]

    def hosting(**kw) -> float:
        return float(
            sum(
                agent.hosting_cost(c)
                for c in comps
                if kw[candidate_vars[c].name]
            )
        )

    return NAryFunctionRelation(
        hosting, variables, name=f"hosting_{agent.name}"
    )


def create_agent_comp_comm_constraint(
    agent: AgentDef,
    computation: str,
    neighbor_agents: Dict[str, str],
    comm_loads: Dict[str, float],
    var: BinaryVariable,
):
    """Soft constraint: if ``agent`` hosts ``computation``, pay the
    communication cost to each neighbor computation's hosting agent —
    ``communication_load(comp, neighbor) x route(agent, neighbor_agent)``
    (pyDCOP :158).

    ``neighbor_agents``: neighbor computation -> hosting agent;
    ``comm_loads``: neighbor computation -> message load.
    """

    def comm(x) -> float:
        if not x:
            return 0.0
        return float(
            sum(
                comm_loads[n] * agent.route(neighbor_agents[n])
                for n in neighbor_agents
            )
        )

    return NAryFunctionRelation(
        comm, [var], name=f"comm_{computation}_{agent.name}", f_kwargs=False
    )


def _footprint(cg, comp_name: str, algo) -> float:
    from ..algorithms import load_algorithm_module

    mod = load_algorithm_module(algo.algo)
    fn = getattr(mod, "computation_memory", None)
    if fn is None:
        return 1.0
    try:
        return float(fn(cg.computation(comp_name)))
    except (NotImplementedError, ValueError, AttributeError):
        return 1.0


def _comm_load(cg, comp_name: str, neighbor: str, algo) -> float:
    from ..algorithms import load_algorithm_module

    mod = load_algorithm_module(algo.algo)
    fn = getattr(mod, "communication_load", None)
    if fn is None:
        return 1.0
    try:
        return float(fn(cg.computation(comp_name), neighbor))
    except (NotImplementedError, ValueError, AttributeError):
        return 1.0


def repair_dcop(
    cg,
    agent_defs: List[AgentDef],
    distribution,
    removed_agent: str,
    algo,
    replica_hosts: Optional[Dict[str, List[str]]] = None,
) -> Tuple[DCOP, Dict[str, Dict[str, BinaryVariable]]]:
    """Build the reparation DCOP for the orphans of ``removed_agent``.

    Returns (dcop, candidate_vars) with candidate_vars[comp][agent] the
    binary decision variable "agent hosts comp".
    """
    orphans = removal_orphaned_computations(distribution, removed_agent)
    survivors = {a.name: a for a in agent_defs if a.name != removed_agent}
    if not survivors:
        raise ValueError("no surviving agent to repair onto")

    candidates = removal_candidate_agents(
        orphans, survivors, replica_hosts
    )

    dcop = DCOP(f"repair_{removed_agent}", "min")
    candidate_vars: Dict[str, Dict[str, BinaryVariable]] = {}
    for comp in orphans:
        candidate_vars[comp] = {}
        for a in candidates[comp]:
            v = BinaryVariable(binary_var_name(comp, a))
            candidate_vars[comp][a] = v
            dcop.add_variable(v)

    # hard: each orphan hosted exactly once
    for comp in orphans:
        dcop.add_constraint(
            create_computation_hosted_constraint(
                comp, list(candidate_vars[comp].values())
            )
        )

    # per-agent: capacity (hard) + hosting costs (soft)
    footprints = {c: _footprint(cg, c, algo) for c in orphans}
    for a_name, a_def in survivors.items():
        agent_vars = {
            comp: candidate_vars[comp][a_name]
            for comp in orphans
            if a_name in candidate_vars[comp]
        }
        if not agent_vars:
            continue
        used = sum(
            _footprint(cg, c, algo)
            for c in distribution.computations_hosted(a_name)
        )
        remaining = max(0.0, float(a_def.capacity) - used)
        dcop.add_constraint(
            create_agent_capacity_constraint(
                a_def, remaining, footprints, agent_vars
            )
        )
        dcop.add_constraint(
            create_agent_hosting_constraint(a_def, agent_vars)
        )
        # soft: communication costs to the orphan's neighbors, priced at
        # their *current* hosting agents
        for comp, var in agent_vars.items():
            node = cg.computation(comp)
            neighbor_agents = {}
            comm_loads = {}
            for n in node.neighbors:
                try:
                    n_agent = distribution.agent_for(n)
                except (KeyError, ValueError):
                    continue
                if n_agent == removed_agent:
                    # neighbors orphaned with us have no current host;
                    # pyDCOP excludes the departed agent the same way
                    continue
                neighbor_agents[n] = n_agent
                comm_loads[n] = _comm_load(cg, comp, n, algo)
            if neighbor_agents:
                dcop.add_constraint(
                    create_agent_comp_comm_constraint(
                        a_def, comp, neighbor_agents, comm_loads, var
                    )
                )
    dcop.add_agents(list(survivors.values()))
    return dcop, candidate_vars


def repair_distribution(
    cg,
    agent_defs: List[AgentDef],
    distribution,
    removed_agent: str,
    algo,
    replica_hosts: Optional[Dict[str, List[str]]] = None,
    n_cycles: int = 30,
    seed: int = 0,
    device="cuda",
):
    """Solve the repair DCOP with MGM-2 on ``device`` and apply the
    winning placement (pyDCOP's decentralized repair, re-expressed as a
    compiled solve).  The solve is an auxiliary one: it never touches the
    run's checkpoints (``utils/solve_control.py``); on the card it runs on
    a stream of its own (``hopper_kernels.own_stream``).

    Returns (new_distribution, metrics).
    """
    from ..api import solve_result
    from ..compile.core import compile_dcop
    from ..distribution.objects import Distribution
    from ..utils.solve_control import auxiliary

    dcop, candidate_vars = repair_dcop(
        cg, agent_defs, distribution, removed_agent, algo, replica_hosts
    )
    try:
        # the tabulation guard is the only refusal that places greedily:
        # it raises here, before the device sees anything
        compiled = compile_dcop(dcop)
    except NotImplementedError:
        compiled = None
    if compiled is not None:
        from ..compile.hopper_kernels import own_stream

        # on a stream of its own: beside a main solve on the default
        # stream, every upload and read-back of the repair would queue
        # behind that solve's replays (seconds each on the card)
        with auxiliary(), own_stream(device):
            r = solve_result(
                dcop, "mgm2", n_cycles=n_cycles, seed=seed,
                compiled=compiled, device=device,
            )
        assignment = r["assignment"]
        status = {
            "repair_status": r["status"],
            "repair_cost": r["cost"],
            "repair_violation": r["violation"],
            "repair_cycles": r["cycle"],
        }
    else:
        # an agent with many orphan candidates makes its capacity/hosting
        # constraints span >MAX_TABLE_ELEMS assignments (compile/core.py
        # dense-tabulation guard).  pyDCOP's per-agent MGM-2 has no
        # such limit, so rather than failing the repair, fall back to a
        # greedy per-orphan placement (largest footprint first, cheapest
        # fitting agent).
        logger.warning(
            "repair DCOP too large to tabulate; using greedy placement"
        )
        repair_distribution.greedy += 1
        if metrics_registry.enabled:
            _m_greedy.inc()
        assignment, n_relaxed, greedy_cost = _greedy_repair_assignment(
            cg, agent_defs, distribution, removed_agent, algo,
            candidate_vars,
        )
        status = {
            "repair_status": "GREEDY",
            "repair_cost": greedy_cost,
            # placements that only fit by relaxing an agent's capacity are
            # real constraint violations and must be reported as such
            "repair_violation": n_relaxed,
            "repair_cycles": 0,
        }

    mapping = {
        a: list(distribution.computations_hosted(a))
        for a in distribution.agents
        if a != removed_agent
    }
    agent_defs_by_name = {a.name: a for a in agent_defs}
    migrated: Dict[str, str] = {}
    for comp, by_agent in candidate_vars.items():
        chosen = [a for a, v in by_agent.items() if assignment[v.name] == 1]
        if len(chosen) != 1:
            # repair solve failed to satisfy the hard hosted-exactly-once
            # constraint (0 hosts) or over-selected (2+): fall back to the
            # cheapest candidate by hosting cost (among the mgm2 picks when
            # there are several)
            logger.warning(
                "repair: orphan %s got %d hosts from mgm2, using greedy "
                "fallback", comp, len(chosen),
            )
            repair_distribution.repicked += 1
            if metrics_registry.enabled:
                _m_repicked.inc()
            pool = chosen if chosen else sorted(by_agent)
            chosen = [
                min(
                    pool,
                    key=lambda a: (
                        agent_defs_by_name[a].hosting_cost(comp)
                        if a in agent_defs_by_name
                        else 0.0,
                        a,
                    ),
                )
            ]
        mapping.setdefault(chosen[0], []).append(comp)
        migrated[comp] = chosen[0]
    new_dist = Distribution(mapping)
    metrics = dict(status, migrated=migrated)
    return new_dist, metrics


#: repairs placed greedily (the tabulation guard refused the repair DCOP)
repair_distribution.greedy = 0
#: orphans that MGM-2 gave no host or several, re-picked by hosting cost
repair_distribution.repicked = 0


def _greedy_repair_assignment(
    cg,
    agent_defs: List[AgentDef],
    distribution,
    removed_agent: str,
    algo,
    candidate_vars: Dict[str, Dict[str, BinaryVariable]],
) -> Tuple[Dict[str, int], int]:
    """Greedy per-orphan placement as a binary-variable assignment: largest
    footprint first, cheapest (hosting cost) candidate with remaining
    capacity; capacity is relaxed when nothing fits (mirrors the hard/soft
    split of the repair DCOP's constraints).

    Returns (assignment, n_relaxed, hosting_cost): n_relaxed counts
    placements that needed the capacity relaxation; hosting_cost is the
    summed hosting cost of the chosen placement."""
    survivors = {a.name: a for a in agent_defs if a.name != removed_agent}
    remaining = {}
    for name, a_def in survivors.items():
        used = sum(
            _footprint(cg, c, algo)
            for c in distribution.computations_hosted(name)
        )
        remaining[name] = max(0.0, float(a_def.capacity) - used)
    footprints = {c: _footprint(cg, c, algo) for c in candidate_vars}

    assignment = {
        v.name: 0
        for by_agent in candidate_vars.values()
        for v in by_agent.values()
    }
    n_relaxed = 0
    hosting_cost = 0.0
    for comp in sorted(candidate_vars, key=lambda c: (-footprints[c], c)):
        by_agent = candidate_vars[comp]
        fits = [
            a for a in by_agent if remaining.get(a, 0.0) >= footprints[comp]
        ]
        if not fits:
            n_relaxed += 1
        pool = fits or sorted(by_agent)
        chosen = min(
            pool,
            key=lambda a: (
                survivors[a].hosting_cost(comp) if a in survivors else 0.0,
                a,
            ),
        )
        remaining[chosen] = remaining.get(chosen, 0.0) - footprints[comp]
        if chosen in survivors:
            hosting_cost += float(survivors[chosen].hosting_cost(comp))
        assignment[by_agent[chosen].name] = 1
    return assignment, n_relaxed, hosting_cost
