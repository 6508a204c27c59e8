"""MGM (Monotone Gain Messages), batched.

Counterpart of ``pydcop_tpu/algorithms/mgm.py``: per cycle every variable
(1) exchanges values with its neighbours, (2) computes the best local gain
it could reach by moving, (3) exchanges gains, and (4) moves only if its
gain is strictly the neighbourhood maximum (ties broken by
``break_mode``: lexic, the lowest variable id wins, or random, a fresh
draw each cycle).  Monotone: the global cost never increases.  Both
message phases are array ops: gains come from ``local_costs`` for all
variables at once, and the neighbourhood maximum is a ``segment_max``
over the directed neighbour pairs.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    local_costs,
    masked_argmin,
    resolve_device,
    segment_max,
    take_rows,
)
from ..random import uniform
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from .base import (
    cached_const,
    device_problem,
    extract_values,
    field_io,
    finalize,
    gain_health,
    neighbor_pairs_dev,
    run_cycles,
)
from .dsa import random_init_values

GRAPH_TYPE = "constraints_hypergraph"

#: the health hook (``telemetry/pulse.py``): the local-search family's
#: largest and mean available gain
health = gain_health

#: the checkpoint form: JAX's state leaves, of which only ``values`` moves
carry_io = field_io("values")

HEADER_SIZE = 100
UNIT_SIZE = 5

algo_params = [
    AlgoParameterDef("break_mode", "str", ["lexic", "random"], "lexic"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
]


class MgmState(NamedTuple):
    values: torch.Tensor  # [n_vars]
    neigh_src: torch.Tensor  # [n_pairs] directed neighbour pairs, sorted
    neigh_dst: torch.Tensor  # [n_pairs]


def neighborhood_winner(
    gain: torch.Tensor,
    tiebreak: torch.Tensor,
    neigh_src: torch.Tensor,
    neigh_dst: torch.Tensor,
    n_vars: int,
) -> torch.Tensor:
    """[n_vars] bool: does each variable strictly win its neighbourhood on
    the lexicographic key (gain, tiebreak)?  ``tiebreak`` must be distinct
    across any two neighbours.  The pair list is symmetric, so the max
    over v's neighbours groups by ``neigh_src``, reading values at
    ``neigh_dst``; a variable with no neighbour reads ``-inf`` and wins."""
    n_gain = segment_max(gain[neigh_dst], neigh_src, n_vars)
    at_max = gain[neigh_dst] >= n_gain[neigh_src] - 1e-9
    n_tb = segment_max(
        torch.where(at_max, tiebreak[neigh_dst], -torch.inf), neigh_src,
        n_vars,
    )
    return (gain > n_gain + 1e-9) | (
        (gain >= n_gain - 1e-9) & (tiebreak > n_tb)
    )


@functools.lru_cache(maxsize=None)
def _make_step(break_random: bool):
    def step(dev: DeviceDCOP, state: MgmState, key, *consts) -> MgmState:
        costs = local_costs(dev, state.values)
        current = take_rows(costs, state.values[:, None])[:, 0]
        masked = torch.where(dev.valid_mask, costs, torch.inf)
        gain = current - torch.amin(masked, dim=-1)
        if break_random:
            tiebreak = uniform(key, (dev.n_vars,))
        else:
            # lexic: the lowest variable id wins ties
            tiebreak = -torch.arange(
                dev.n_vars, dtype=costs.dtype, device=costs.device
            )
        win = neighborhood_winner(
            gain, tiebreak, state.neigh_src, state.neigh_dst, dev.n_vars
        )
        move = win & (gain > 1e-9)  # monotone: only strict improvements
        values = torch.where(
            move, masked_argmin(costs, dev.valid_mask), state.values
        )
        return state._replace(values=values)

    return step


def _init(dev: DeviceDCOP, key, neigh_src, neigh_dst) -> MgmState:
    return MgmState(
        values=random_init_values(dev, key),
        neigh_src=neigh_src,
        neigh_dst=neigh_dst,
    )


def padded_neighbor_pairs(compiled, n_pairs: int, dev: DeviceDCOP):
    """Directed neighbour pairs padded to exactly ``n_pairs`` rows with
    (dead, dead) self-pairs on the first dead variable of a row-padded
    ``dev``, on its device: the appended source ids are >= every real id,
    so the src-sorted order holds, and the dead variable's 1-value domain
    means it can never move."""

    def build():
        src, dst = compiled.neighbor_pairs()
        pad = n_pairs - len(src)
        if pad < 0:
            raise ValueError(
                f"pair target {n_pairs} below real count {len(src)}"
            )
        dead = compiled.n_vars  # first dead row of the padded dev
        return tuple(
            torch.as_tensor(
                np.concatenate([a, np.full(pad, dead, dtype=a.dtype)]),
                device=dev.unary.device,
            )
            for a in (src, dst)
        )

    return cached_const(
        compiled,
        ("padded_neighbor_pairs", n_pairs, dev.n_vars,
         str(dev.unary.device)),
        build,
    )


def bucket_extra(compiled, params: Dict) -> tuple:
    """The serving layer's bucket-key component: the power-of-two-padded
    directed neighbour-pair count (the one MGM constant the DeviceDCOP
    dims do not determine)."""
    from ..serve.bucket import pow2

    src, _dst = compiled.neighbor_pairs()
    return (pow2(max(len(src), 1)),)


def msg_per_cycle(compiled):
    """One value and one gain message per directed neighbour pair per
    cycle."""
    src, _dst = compiled.neighbor_pairs()
    return 2 * int(len(src)), 2 * int(len(src)) * UNIT_SIZE


def serve_pair_count(compiled, dev: DeviceDCOP, padded: int) -> int:
    """The neighbour pairs a serving plan keeps: ``padded`` on a
    row-padded ``dev`` (the bucket), the real count on an unpadded one
    (the fused union, whose dead self-pairs would have no dead row to sit
    on; JAX's out-of-range gathers clamp them there, where they decide
    nothing, so the real pairs give the same bits)."""
    if dev.n_vars > compiled.n_vars:
        return padded
    return len(compiled.neighbor_pairs()[0])


def batch_plan(compiled, dev: DeviceDCOP, params: Dict):
    """The serving layer's plan: the solve's step and init with the
    neighbour pairs padded to the bucket's pair count."""
    from ..serve.batch import BatchPlan

    (n_pairs_p,) = bucket_extra(compiled, params)
    return BatchPlan(
        init=_init,
        step=_make_step(params["break_mode"] == "random"),
        extract=extract_values,
        consts=padded_neighbor_pairs(
            compiled, serve_pair_count(compiled, dev, n_pairs_p), dev
        ),
        convergence=None,
        same_count=4,
        noise=0.0,
        return_final=True,  # monotone
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
    """Solve ``compiled`` with MGM on ``device`` (the card unless the
    caller asks for the CPU); reports the final assignment, which is the
    best (MGM is monotone)."""
    params = prepare_algo_params(params or {}, algo_params)
    if params["stop_cycle"]:
        n_cycles = params["stop_cycle"]
    device = resolve_device(device)
    dev = device_problem(
        compiled, device, "mgm", params, n_cycles, collect_curve
    )
    neigh = neighbor_pairs_dev(compiled, device)
    values, curve, extras = run_cycles(
        compiled, dev, _init,
        _make_step(params["break_mode"] == "random"), extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        return_final=True,  # monotone: the final assignment is the best
        health=health,
        carry_io=carry_io,
        consts=neigh,
    )
    cycles = extras["cycles"]
    # per cycle: one value + one gain message per directed neighbour pair
    msg_count = 2 * int(neigh[0].shape[0]) * cycles
    return finalize(
        compiled, values, cycles, msg_count, msg_count * UNIT_SIZE, curve,
        status="TIMEOUT" if extras["timed_out"] else "FINISHED",
    )


# the footprint models the agent runtime's distributions read (the JAX
# package's, host only)


def computation_memory(computation) -> float:
    """MGM stores one value + one gain per neighbor."""
    return float(len(computation.neighbors)) * 2


def communication_load(src, target: str) -> float:
    """Value + gain messages per cycle."""
    return 2 * UNIT_SIZE + HEADER_SIZE
