"""MixedDSA: DSA for problems mixing hard and soft constraints, batched.

Counterpart of ``pydcop_tpu/algorithms/mixeddsa.py``: constraints are
classified hard (any forbidden entry among their valid tuples) or soft
once, on the host; each cycle every variable computes the
lexicographically-best value (fewest violated hard constraints, then
lowest soft cost) and switches

- with probability ``proba_hard`` when it reduces hard violations;
- with probability ``proba_soft`` when hard violations are equal but the
  soft cost improves;
- on a plateau (no improvement): with ``proba_hard`` to a *different*
  optimal value while hard conflicts remain, with ``proba_soft`` (variants
  B/C) while a soft constraint is off its optimum, and for variant C with
  ``min(proba_hard, proba_soft)`` even without conflicts.

Both per-candidate tiers come from the bucketed slot-cost gathers of the
local-cost layer, for every variable at once; the cycle key is split into
five threefry keys, bit-equal to the JAX package's draws.  Reports the
anytime best.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compile.core import BIG, CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    _slot_costs,
    edge_constraint_costs,
    fan_in_onto,
    per_slot_to_edges,
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
from .dsa import random_init_values

GRAPH_TYPE = "constraints_hypergraph"

#: the health hook (``telemetry/pulse.py``): the local-search family's
#: largest and mean available gain
health = gain_health

#: the checkpoint form: JAX's state leaves, of which only ``values`` moves
carry_io = field_io("values")

HEADER_SIZE = 0
UNIT_SIZE = 1
HARD_THRESHOLD = BIG / 2

algo_params = [
    AlgoParameterDef("proba_hard", "float", None, 0.7),
    AlgoParameterDef("proba_soft", "float", None, 0.5),
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
]


class MixedDsaState(NamedTuple):
    values: torch.Tensor  # [n_vars]
    con_hard: torch.Tensor  # [n_constraints] bool
    con_soft_opt: torch.Tensor  # [n_constraints] soft optimum (0 for hard)


def _hard_and_optima(compiled: CompiledDCOP) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side per-constraint classification: (is_hard, soft_optimum).
    Only valid table entries count (padding holds BIG and must not make
    everything look hard); validity comes from the scope variables'
    domain sizes."""
    n_c = max(compiled.n_constraints, 1)
    hard = np.zeros(n_c, dtype=bool)
    soft_opt = np.zeros(n_c, dtype=np.float64)
    d = compiled.max_domain
    for b in compiled.buckets:
        flat = b.tables.reshape(b.tables.shape[0], -1)
        # validity mask per row: all digit positions inside the domain
        positions = np.arange(flat.shape[1])
        valid = np.ones_like(flat, dtype=bool)
        for t in range(b.arity):
            stride = d ** (b.arity - 1 - t)
            digit = (positions // stride) % d
            sizes = compiled.domain_size[b.var_slots[:, t]]
            valid &= digit[None, :] < sizes[:, None]
        is_hard = (np.abs(flat) >= HARD_THRESHOLD) & valid
        hard[b.con_ids] = is_hard.any(axis=1)
        soft_opt[b.con_ids] = np.where(valid, flat, np.inf).min(axis=1)
    return hard, soft_opt


def _argmax_draw(key, allowed: torch.Tensor) -> torch.Tensor:
    """A uniformly drawn allowed entry of each row: the argmax of a
    uniform draw over the allowed entries (-1 elsewhere)."""
    scores = torch.where(allowed, uniform(key, allowed.shape), -1.0)
    return torch.argmax(scores, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _make_step(variant: str, proba_hard: float, proba_soft: float):
    def step(
        dev: DeviceDCOP, state: MixedDsaState, key, *consts
    ) -> MixedDsaState:
        keys = split(key, 5)
        k_choice, k_alt, kh, ks, kp = (keys[i] for i in range(5))
        d = dev.max_domain
        n = dev.n_vars

        # per-candidate hard-violation counts and soft costs; hard unary
        # constraints were folded into dev.unary at compile time, so
        # entries at >= HARD_THRESHOLD count in the hard tier
        unary_hard = dev.unary >= HARD_THRESHOLD
        hard_viol = unary_hard.to(dev.unary.dtype)
        soft_cost = torch.where(unary_hard, 0.0, dev.unary)
        viol_blocks, soft_blocks = [], []
        for bucket in dev.buckets:
            slot = _slot_costs(bucket, d, state.values)  # [n_c, a, D]
            c_hard = state.con_hard[bucket.con_ids][:, None, None]
            viol = (slot >= HARD_THRESHOLD) & c_hard
            viol_blocks.append(viol.to(dev.unary.dtype))
            soft_blocks.append(torch.where(c_hard, 0.0, slot))
        if viol_blocks:
            hard_viol = fan_in_onto(
                dev, hard_viol, per_slot_to_edges(dev, viol_blocks)
            )
            soft_cost = fan_in_onto(
                dev, soft_cost, per_slot_to_edges(dev, soft_blocks)
            )

        hard_masked = torch.where(dev.valid_mask, hard_viol, torch.inf)
        min_hard = torch.amin(hard_masked, dim=-1)
        at_min_hard = hard_masked <= min_hard[:, None] + 1e-9
        soft_masked = torch.where(at_min_hard, soft_cost, torch.inf)
        best_soft = torch.amin(soft_masked, dim=-1)
        bests = at_min_hard & (soft_masked <= best_soft[:, None] + 1e-9)

        hard_cur = take_rows(hard_viol, state.values[:, None])[:, 0]
        soft_cur = take_rows(soft_cost, state.values[:, None])[:, 0]
        delta_dcsp = hard_cur - min_hard
        delta_dcop = soft_cur - best_soft

        # uniform pick among bests; and among bests != current (plateaus)
        pick = _argmax_draw(k_choice, bests)
        cand = torch.arange(d, device=bests.device)
        others = bests & (cand != state.values[:, None])
        has_other = others.any(dim=-1)
        pick_other = _argmax_draw(k_alt, others)

        lucky_hard = uniform(kh, (n,)) < proba_hard
        lucky_soft = uniform(ks, (n,)) < proba_soft
        lucky_plateau = uniform(kp, (n,)) < min(proba_hard, proba_soft)

        # soft constraints off their optimum (the B/C plateau rule); an
        # int32 segment max, as in JAX: a variable with no constraint reads
        # INT32_MIN, which is True as a bool
        ecosts = edge_constraint_costs(dev, state.values)
        soft_violated_e = (~state.con_hard[dev.edge_con]) & (
            ecosts > state.con_soft_opt[dev.edge_con] + 1e-9
        )
        soft_violated_v = segment_max(
            soft_violated_e.to(torch.int32), dev.edge_var, n
        ) != 0

        improves_hard = delta_dcsp > 1e-9
        improves_soft = (~improves_hard) & (delta_dcop > 1e-9)
        plateau = (~improves_hard) & (~improves_soft)

        value = state.values
        # hard improvement
        take = improves_hard & lucky_hard
        value = torch.where(take, pick, value)
        switch = take
        # soft improvement
        take = improves_soft & lucky_soft
        value = torch.where(take & ~switch, pick, value)
        switch = switch | take
        # plateau escapes (to a different best value)
        escape = plateau & (hard_cur > 0) & has_other & lucky_hard
        if variant in ("B", "C"):
            escape = escape | (
                plateau & (hard_cur <= 0) & soft_violated_v & has_other
                & lucky_soft
            )
        if variant == "C":
            escape = escape | (
                plateau & (hard_cur <= 0) & ~soft_violated_v & has_other
                & lucky_plateau
            )
        value = torch.where(escape & ~switch, pick_other, value)
        return state._replace(values=value)

    return step


def _init(dev: DeviceDCOP, key, con_hard, con_soft_opt) -> MixedDsaState:
    return MixedDsaState(
        values=random_init_values(dev, key),
        con_hard=con_hard,
        con_soft_opt=con_soft_opt,
    )


def _consts(compiled: CompiledDCOP, dev: DeviceDCOP):
    """The per-constraint hard flags and soft optima on ``dev``'s device,
    padded to its constraint count, cached on the compiled problem."""

    def build():
        hard, soft_opt = _hard_and_optima(compiled)
        device = dev.unary.device
        return (
            torch.as_tensor(
                pad_rows_np(hard, dev.n_constraints, False), device=device
            ),
            torch.as_tensor(
                pad_rows_np(soft_opt, dev.n_constraints, 0.0),
                dtype=dev.unary.dtype, device=device,
            ),
        )

    return cached_const(
        compiled,
        ("mixeddsa_consts", dev.n_constraints, str(dev.unary.device)),
        build,
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
    """Solve ``compiled`` with MixedDSA on ``device`` (the card unless the
    caller asks for the CPU); reports the best assignment seen."""
    params = prepare_algo_params(params or {}, algo_params)
    if params["stop_cycle"]:
        n_cycles = params["stop_cycle"]
    device = resolve_device(device)
    dev = device_problem(
        compiled, device, "mixeddsa", params, n_cycles, collect_curve
    )
    values, curve, extras = run_cycles(
        compiled, dev, _init,
        _make_step(
            params["variant"],
            float(params["proba_hard"]),
            float(params["proba_soft"]),
        ),
        extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        consts=_consts(compiled, dev),
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
    return float(len(computation.neighbors))


def communication_load(src, target: str) -> float:
    return UNIT_SIZE + HEADER_SIZE
