"""Synchronous DSA (Distributed Stochastic Algorithm), batched.

Counterpart of ``pydcop_tpu/algorithms/dsa.py``: the same parameters
(probability 0.7, p_mode fixed/arity, variant A/B/C, stop_cycle) and the
same per-cycle rule: each variable computes its best value against its
neighbours' current values and switches to a random optimal value with
probability p when

- variant A: the local gain is strictly positive;
- variant B: gain > 0, or gain == 0 while some local constraint is not at
  its global optimum (preferring an optimal value other than the current);
- variant C: gain >= 0 (preferring another optimal value on ties).

Random initial values; ``p_mode="arity"`` uses p = 1.2 / sum(arity_c - 1)
per variable.  Every variable decides at once from ``local_costs``, with
explicit threefry keys: the cycle key is split into the choice key and
the switch key, bit-equal to the JAX package's draws.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    edge_constraint_costs,
    local_costs,
    resolve_device,
    segment_max,
    take_rows,
)
from ..random import split, uniform
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from .base import (
    cached_const,
    device_problem,
    extract_values,
    field_io,
    finalize,
    gain_health,
    pad_rows_np,
    run_cycles,
)

GRAPH_TYPE = "constraints_hypergraph"

HEADER_SIZE = 0
UNIT_SIZE = 1

algo_params = [
    AlgoParameterDef("probability", "float", None, 0.7),
    AlgoParameterDef("p_mode", "str", ["fixed", "arity"], "fixed"),
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
]


#: the health hook (``telemetry/pulse.py``): the local-search family's
#: largest and mean available gain
health = gain_health

#: the checkpoint form: JAX's state leaves, only ``values`` moves
carry_io = field_io("values")


class DsaState(NamedTuple):
    values: torch.Tensor  # [n_vars] current value indices
    probability: torch.Tensor  # [n_vars] per-variable switch probability
    con_optimum: torch.Tensor  # [n_constraints] min cost per constraint


def _random_tiebreak_argmin(
    key, costs: torch.Tensor, valid_mask: torch.Tensor, avoid=None
) -> torch.Tensor:
    """Pick uniformly among the (masked) argmin entries of each row; if
    ``avoid`` (current values) is given, prefer optimal entries other
    than it when any exist."""
    masked = torch.where(valid_mask, costs, torch.inf)
    best = torch.amin(masked, dim=-1, keepdim=True)
    is_best = masked <= best + 1e-9
    if avoid is not None:
        cand = torch.arange(costs.shape[-1], device=costs.device)
        others = is_best & (cand != avoid[:, None])
        has_other = others.any(dim=-1, keepdim=True)
        is_best = torch.where(has_other, others, is_best)
    scores = torch.where(is_best, uniform(key, costs.shape), -1.0)
    return torch.argmax(scores, dim=-1).to(torch.int32)


def dsa_decision(
    dev: DeviceDCOP,
    values: torch.Tensor,
    probability: torch.Tensor,
    con_optimum: torch.Tensor,
    variant: str,
    key,
):
    """One DSA evaluation for every variable at once: returns
    (switch [n_vars] bool, candidate [n_vars] value indices)."""
    k_choice, k_proba = split(key)
    costs = local_costs(dev, values)  # [n_vars, D]
    current_cost = take_rows(costs, values[:, None])[:, 0]
    masked = torch.where(dev.valid_mask, costs, torch.inf)
    best_cost = torch.amin(masked, dim=-1)
    delta = current_cost - best_cost  # >= 0

    avoid = values if variant in ("B", "C") else None
    candidate = _random_tiebreak_argmin(
        k_choice, costs, dev.valid_mask, avoid=avoid
    )

    improve = delta > 1e-9
    if variant == "A":
        want = improve
    elif variant == "B":
        # gain == 0 counts only when a local constraint is off its optimum
        ecosts = edge_constraint_costs(dev, values)
        violated_e = ecosts > con_optimum[dev.edge_con] + 1e-9
        # as in JAX, an int32 segment max: a variable with no constraint
        # reads INT32_MIN, which is True as a bool
        violated_v = segment_max(
            violated_e.to(torch.int32), dev.edge_var, dev.n_vars
        ) != 0
        want = improve | (~improve & violated_v)
    else:  # C
        want = improve | (delta <= 1e-9)

    lucky = uniform(k_proba, (dev.n_vars,)) < probability
    return want & lucky, candidate


@functools.lru_cache(maxsize=None)
def _make_step(variant: str):
    def step(dev: DeviceDCOP, state: DsaState, key, *consts) -> DsaState:
        switch, candidate = dsa_decision(
            dev, state.values, state.probability, state.con_optimum,
            variant, key,
        )
        values = torch.where(switch, candidate, state.values)
        return state._replace(values=values)

    return step


def _init_probability(compiled: CompiledDCOP, params: Dict) -> np.ndarray:
    p = np.full(compiled.n_vars, params["probability"], dtype=np.float64)
    if params["p_mode"] == "arity":
        # p = 1.2 / sum over the variable's constraints of (arity - 1)
        n_count = np.zeros(compiled.n_vars, dtype=np.float64)
        for b in compiled.buckets:
            for row in b.var_slots:
                for v in row:
                    n_count[v] += b.arity - 1
        with np.errstate(divide="ignore"):
            arity_p = np.where(n_count > 0, 1.2 / np.maximum(n_count, 1), 1.0)
        p = arity_p
    return p


def constraint_optima(compiled: CompiledDCOP, dev: DeviceDCOP):
    """[n_constraints] min possible cost of each constraint, padded to the
    device constraint count (variant B's violation test)."""

    def build():
        con_opt = np.zeros(max(compiled.n_constraints, 1), dtype=np.float64)
        for b in compiled.buckets:
            con_opt[b.con_ids] = b.tables.reshape(
                b.tables.shape[0], -1
            ).min(axis=1)
        return torch.as_tensor(
            pad_rows_np(con_opt, dev.n_constraints, 0.0),
            dtype=dev.unary.dtype, device=dev.unary.device,
        )

    return cached_const(
        compiled,
        ("con_optima", dev.n_constraints, str(dev.unary.device)),
        build,
    )


def random_init_values(dev: DeviceDCOP, key) -> torch.Tensor:
    """Uniform random valid value per variable."""
    u = uniform(key, (dev.n_vars,), device=dev.unary.device)
    return torch.floor(u * dev.domain_size).to(torch.int32)


def _init(dev: DeviceDCOP, key, probability, con_optimum) -> DsaState:
    return DsaState(
        values=random_init_values(dev, key),
        probability=probability,
        con_optimum=con_optimum,
    )


def _consts(compiled: CompiledDCOP, params: Dict, dev: DeviceDCOP):
    """The per-variable switch probability and the per-constraint optimum
    of a DSA solve, on ``dev``'s device, cached on the compiled problem."""
    probability = cached_const(
        compiled,
        (
            "dsa_probability", params["probability"], params["p_mode"],
            dev.n_vars, str(dev.unary.device),
        ),
        lambda: torch.as_tensor(
            pad_rows_np(
                _init_probability(compiled, params), dev.n_vars, 0.0
            ),
            dtype=dev.unary.dtype, device=dev.unary.device,
        ),
    )
    return probability, constraint_optima(compiled, dev)


def bucket_extra(compiled: CompiledDCOP, params: Dict) -> tuple:
    """The serving layer's bucket-key component: DSA's constants are
    shaped by the padded DeviceDCOP dims alone, so nothing extra."""
    return ()


def msg_per_cycle(compiled: CompiledDCOP):
    """The reference's message accounting per cycle: one value message
    per directed neighbour pair."""
    src, _dst = compiled.neighbor_pairs()
    return int(len(src)), int(len(src)) * UNIT_SIZE


def batch_plan(compiled: CompiledDCOP, dev: DeviceDCOP, params: Dict):
    """The serving layer's plan (``serve.batch``): the init, step and
    constants a solve uses, against the bucket-padded ``dev``."""
    from ..serve.batch import BatchPlan

    return BatchPlan(
        init=_init,
        step=_make_step(params["variant"]),
        extract=extract_values,
        consts=_consts(compiled, params, dev),
        convergence=None,
        same_count=4,
        noise=0.0,
        return_final=False,
        msg_per_cycle=msg_per_cycle(compiled),
        n_cycles_override=int(params["stop_cycle"] or 0),
        health=health,
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
    """Solve ``compiled`` with DSA on ``device`` (the card unless the
    caller asks for the CPU); reports the best assignment seen."""
    params = prepare_algo_params(params or {}, algo_params)
    if params["stop_cycle"]:
        n_cycles = params["stop_cycle"]
    device = resolve_device(device)
    dev = device_problem(
        compiled, device, "dsa", params, n_cycles, collect_curve
    )
    values, curve, extras = run_cycles(
        compiled, dev, _init, _make_step(params["variant"]), extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        consts=_consts(compiled, params, dev),
        return_final=False,  # anytime best
        health=health,
        carry_io=carry_io,
    )
    # one value message to each neighbour per cycle over the hypergraph
    src, _dst = compiled.neighbor_pairs()
    cycles = extras["cycles"]
    msg_count = int(len(src)) * cycles
    return finalize(
        compiled, values, cycles, msg_count, msg_count * UNIT_SIZE, curve,
        status="TIMEOUT" if extras["timed_out"] else "FINISHED",
    )


# the footprint models the agent runtime's distributions read (the JAX
# package's, host only)


def computation_memory(computation) -> float:
    """DSA only remembers one value per neighbor."""
    return float(len(computation.neighbors))


def communication_load(src, target: str) -> float:
    """One value per message."""
    return UNIT_SIZE + HEADER_SIZE
