"""A-DSA: asynchronous DSA, emulated with staggered activation phases.

Counterpart of ``pydcop_tpu/algorithms/adsa.py``: DSA's parameters
(``probability`` 0.7, ``variant`` A/B/C, ``stop_cycle``) and its decision
rule (``dsa.dsa_decision``), run inside the synchronous cycle loop as a
period of two half-steps.  Each cycle every variable draws a phase:
variables of the early half decide against the previous period's values,
those of the late half against the values the early movers left (a
red/black schedule), so agents act on partly updated views of their
neighbours, as asynchronous agents do.  The cycle key splits three ways
(phase, early decision, late decision), bit-equal to the JAX package's
draws.  ``period`` is accepted for the reference's parameter list and
has no effect: a cycle is a period.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import DeviceDCOP, resolve_device
from ..random import split, uniform
from . import (
    AlgoParameterDef,
    SolveResult,
    prepare_algo_params,
    warn_inert_params,
)
from .base import (
    cached_const,
    device_problem,
    extract_values,
    field_io,
    finalize,
    gain_health,
    run_cycles,
)
from .dsa import constraint_optima, dsa_decision, random_init_values

GRAPH_TYPE = "constraints_hypergraph"

#: the health hook (``telemetry/pulse.py``): the local-search family's
#: largest and mean available gain
health = gain_health

#: the checkpoint form: JAX's state leaves, of which only ``values`` moves
carry_io = field_io("values")

HEADER_SIZE = 0
UNIT_SIZE = 1

algo_params = [
    AlgoParameterDef("period", "float", None, 0.5),
    AlgoParameterDef("probability", "float", None, 0.7),
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
]

inert_params = {
    "period": (
        "one scan step IS one wake-up period; wall-clock pacing has no "
        "device-side meaning in the batched emulation"
    ),
}


class ADsaState(NamedTuple):
    values: torch.Tensor  # [n_vars]
    probability: torch.Tensor  # [n_vars]
    con_optimum: torch.Tensor  # [n_constraints]


@functools.lru_cache(maxsize=None)
def _make_step(variant: str):
    def step(dev: DeviceDCOP, state: ADsaState, key, *consts) -> ADsaState:
        k_phase, k1, k2 = split(key, 3)
        early = uniform(k_phase, (dev.n_vars,)) < 0.5
        # early half: against the previous period's values
        switch, cand = dsa_decision(
            dev, state.values, state.probability, state.con_optimum,
            variant, k1,
        )
        values = torch.where(switch & early, cand, state.values)
        # late half: against the partly updated values
        switch, cand = dsa_decision(
            dev, values, state.probability, state.con_optimum, variant, k2
        )
        values = torch.where(switch & ~early, cand, values)
        return state._replace(values=values)

    return step


def _init(dev: DeviceDCOP, key, probability, con_optimum) -> ADsaState:
    return ADsaState(
        values=random_init_values(dev, key),
        probability=probability,
        con_optimum=con_optimum,
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
    """Solve ``compiled`` with A-DSA on ``device`` (the card unless the
    caller asks for the CPU); reports the best assignment seen."""
    warn_inert_params(params, inert_params, algo_params)
    params = prepare_algo_params(params or {}, algo_params)
    if params["stop_cycle"]:
        n_cycles = params["stop_cycle"]
    device = resolve_device(device)
    dev = device_problem(
        compiled, device, "adsa", params, n_cycles, collect_curve
    )
    probability = cached_const(
        compiled,
        ("adsa_probability", params["probability"], dev.n_vars, str(device)),
        lambda: torch.full(
            (dev.n_vars,), params["probability"], dtype=dev.unary.dtype,
            device=device,
        ),
    )
    values, curve, extras = run_cycles(
        compiled, dev, _init, _make_step(params["variant"]), extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        consts=(probability, constraint_optima(compiled, dev)),
        return_final=False,
        health=health,
        carry_io=carry_io,
    )
    # each variable posts its value to every neighbour once a period
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
