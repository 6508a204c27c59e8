"""DBA: Distributed Breakout Algorithm (constraint satisfaction), batched.

Counterpart of ``pydcop_tpu/algorithms/dba.py``: 2-phase ok?/improve
cycles; each variable counts the constraints it would violate under each
candidate value, weighted by its own per-constraint weights, moves when it
holds the strictly-best improvement in its neighbourhood (ties to the
lowest variable id), and when stuck in a quasi-local-minimum increments
the weights of its violated constraints.  Termination: per-variable
counters, reset on inconsistency, min-synced over neighbourhoods each
cycle and incremented while consistent; a variable freezes at
``max_distance`` consistent cycles.

Parameters: ``infinity`` (the cost from which a constraint counts as
violated, 10000) and ``max_distance`` (the termination bound, 50).
Weights live per edge (constraint, variable) in one ``[n_edges]`` float32
vector and grow by exact increments of 1; a full ok+improve round is one
step of array ops (violation tests are gathers and compares, neighbourhood
maxima and minima scatter reductions over the directed neighbour pairs).
Reports the anytime best.  Its ``health`` hook gives the weight mass a
cycle added (summed in XLA's order) and the frozen fraction.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    _slot_costs,
    per_slot_to_edges,
    resolve_device,
    segment_max,
    segment_min,
    segment_sum,
    take_rows,
    xla_sum,
)
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from .base import (
    device_problem,
    extract_values,
    field_io,
    finalize,
    neighbor_pairs_dev,
    run_cycles,
)
from .dsa import _random_tiebreak_argmin, random_init_values
from .mgm import neighborhood_winner

GRAPH_TYPE = "constraints_hypergraph"

HEADER_SIZE = 100
UNIT_SIZE = 5

algo_params = [
    AlgoParameterDef("infinity", "int", None, 10000),
    AlgoParameterDef("max_distance", "int", None, 50),
]


class DbaState(NamedTuple):
    values: torch.Tensor  # [n_vars]
    weights: torch.Tensor  # [n_edges] per-(constraint, variable) weights
    counters: torch.Tensor  # [n_vars] int32 termination counters
    frozen: torch.Tensor  # [n_vars] bool: reached max_distance


def health(dev: DeviceDCOP, old_state: DbaState, new_state: DbaState):
    """The health hook (``telemetry/pulse.py``): residual = the breakout
    weight mass added this cycle (summed in XLA's order), aux = the
    fraction of live variables that the termination counter froze."""
    dw = xla_sum(new_state.weights - old_state.weights)
    live = dev.domain_size > 1
    n_live = torch.clamp(live.sum(), min=1).to(torch.float32)
    frozen = (new_state.frozen & live).sum().to(torch.float32) / n_live
    return torch.stack([dw.to(torch.float32), frozen])


#: the checkpoint form: JAX's state leaves, every one of which moves
carry_io = field_io("values", "weights", "counters", "frozen")


def _violations_per_slot(
    dev: DeviceDCOP, values: torch.Tensor, infinity: float
) -> torch.Tensor:
    """[n_edges, D] bool: is each edge's constraint violated when the
    edge's variable takes each candidate value (others at current)?"""
    blocks = [
        _slot_costs(bucket, dev.max_domain, values) >= infinity
        for bucket in dev.buckets
    ]  # [n_c, a, D] each
    if not blocks:
        return torch.zeros(
            (dev.n_edges, dev.max_domain), dtype=torch.bool,
            device=values.device,
        )
    return per_slot_to_edges(dev, blocks)


def neighborhood_max(
    x: torch.Tensor, neigh_src: torch.Tensor, neigh_dst: torch.Tensor,
    n_vars: int,
) -> torch.Tensor:
    """[n_vars] the largest ``x`` among each variable's neighbours, -inf
    for a variable with none (the symmetric pair list groups by
    ``neigh_src``, reading values at ``neigh_dst``)."""
    m = segment_max(x[neigh_dst], neigh_src, n_vars)
    return torch.where(torch.isfinite(m), m, -torch.inf)


@functools.lru_cache(maxsize=None)
def _make_step(infinity: float, max_distance: int):
    def step(
        dev: DeviceDCOP, state: DbaState, key, neigh_src, neigh_dst
    ) -> DbaState:
        n = dev.n_vars

        # --- ok? phase: weighted violation counts for every candidate
        viol = _violations_per_slot(dev, state.values, infinity)  # [E, D]
        weighted = viol * state.weights[:, None]
        evals = segment_sum(weighted, dev.fan_in_offsets, 0)  # [n, D]
        eval_cur = take_rows(evals, state.values[:, None])[:, 0]
        masked = torch.where(dev.valid_mask, evals, torch.inf)
        my_improve = eval_cur - torch.amin(masked, dim=-1)
        new_value = _random_tiebreak_argmin(key, evals, dev.valid_mask)
        consistent = eval_cur == 0

        # --- improve phase: the neighbourhood's winner moves (ties to the
        # lowest variable id)
        win = neighborhood_winner(
            my_improve,
            -torch.arange(n, dtype=evals.dtype, device=evals.device),
            neigh_src, neigh_dst, n,
        )
        can_move = win & (my_improve > 0)
        neigh_max = neighborhood_max(my_improve, neigh_src, neigh_dst, n)
        # a quasi-local-minimum survives only if no neighbour reports a
        # strictly better improvement
        quasi_local_min = (my_improve <= 0) & (
            neigh_max <= my_improve + 1e-9
        )

        # neighbour consistency + counter min-sync; as in JAX, an int32
        # segment max: a variable with no neighbour reads INT32_MIN, True
        neigh_incons = segment_max(
            (eval_cur[neigh_dst] > 0).to(torch.int32), neigh_src, n
        ) != 0
        consistent = consistent & ~neigh_incons
        neigh_counter_min = segment_min(
            state.counters[neigh_dst], neigh_src, n
        )
        counters = torch.minimum(state.counters, neigh_counter_min)
        counters = torch.where(consistent, counters + 1, 0)
        frozen = state.frozen | (counters >= max_distance)

        # weight increase on violated edges of quasi-local-minimum
        # variables
        viol_cur = torch.gather(
            viol, 1, state.values.long()[dev.edge_var][:, None]
        )[:, 0]
        bump = (
            viol_cur & quasi_local_min[dev.edge_var] & ~frozen[dev.edge_var]
        )
        weights = state.weights + bump.to(state.weights.dtype)

        values = torch.where(
            can_move & ~state.frozen, new_value, state.values
        )
        return DbaState(values, weights, counters, frozen)

    return step


def _init(dev: DeviceDCOP, key, *consts) -> DbaState:
    device = dev.unary.device
    return DbaState(
        values=random_init_values(dev, key),
        weights=torch.ones(dev.n_edges, dtype=dev.unary.dtype, device=device),
        counters=torch.zeros(dev.n_vars, dtype=torch.int32, device=device),
        frozen=torch.zeros(dev.n_vars, dtype=torch.bool, device=device),
    )


def solve(
    compiled: CompiledDCOP,
    params: Optional[Dict[str, Any]] = None,
    n_cycles: int = 100,
    seed: int = 0,
    collect_curve: bool = False,
    timeout: Optional[float] = None,
    device="cuda",
) -> SolveResult:
    """Solve ``compiled`` with DBA on ``device`` (the card unless the
    caller asks for the CPU); reports the best assignment seen."""
    params = prepare_algo_params(params or {}, algo_params)
    if compiled.objective != "min":
        raise ValueError(
            "DBA is a constraint satisfaction algorithm and only supports "
            "minimization"
        )
    device = resolve_device(device)
    dev = device_problem(
        compiled, device, "dba", params, n_cycles, collect_curve
    )
    neigh = neighbor_pairs_dev(compiled, device)
    values, curve, extras = run_cycles(
        compiled, dev, _init,
        _make_step(float(params["infinity"]), int(params["max_distance"])),
        extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        return_final=False,  # anytime best
        health=health,
        carry_io=carry_io,
        consts=neigh,
    )
    cycles = extras["cycles"]
    # ok? + improve per directed neighbour pair per cycle
    msg_count = 2 * int(neigh[0].shape[0]) * cycles
    return finalize(
        compiled, values, cycles, msg_count,
        msg_count * (UNIT_SIZE + HEADER_SIZE), curve,
        status="TIMEOUT" if extras["timed_out"] else "FINISHED",
    )


# the footprint models the agent runtime's distributions read (the JAX
# package's, host only)


def computation_memory(computation) -> float:
    """DBA stores one value per neighbor."""
    return float(len(computation.neighbors)) * UNIT_SIZE


def communication_load(src, target: str) -> float:
    """ok?/improve messages carry a value and an improvement."""
    return UNIT_SIZE + HEADER_SIZE
