"""DSA-tuto: the minimal teaching DSA, batched.

Counterpart of ``pydcop_tpu/algorithms/dsatuto.py``: a random initial
value, then each synchronous cycle every variable computes its best value
against its neighbours' current values and switches to the FIRST optimal
value, with a fixed probability of 0.5, when the gain is strictly
positive.  No parameters.  One step for all variables at once, from
``local_costs``, with one threefry draw a cycle, bit-equal to the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    local_costs,
    masked_argmin,
    resolve_device,
    take_rows,
)
from ..random import uniform
from . import SolveResult, prepare_algo_params
from .base import (
    device_problem,
    extract_values,
    field_io,
    finalize,
    gain_health,
    run_cycles,
)
from .dsa import random_init_values

GRAPH_TYPE = "constraints_hypergraph"

#: the health hook (``telemetry/pulse.py``): the local-search family's
#: largest and mean available gain
health = gain_health

#: the checkpoint form: JAX's state leaves, of which only ``values`` moves
carry_io = field_io("values")

UNIT_SIZE = 1

algo_params: list = []

PROBABILITY = 0.5  # fixed in the reference tutorial


class DsaTutoState(NamedTuple):
    values: torch.Tensor  # [n_vars]


def _init(dev: DeviceDCOP, key, *consts) -> DsaTutoState:
    return DsaTutoState(values=random_init_values(dev, key))


def _step(dev: DeviceDCOP, state: DsaTutoState, key, *consts) -> DsaTutoState:
    costs = local_costs(dev, state.values)
    current = take_rows(costs, state.values[:, None])[:, 0]
    # the first argmin, like the reference's arg_min[0]
    best_value = masked_argmin(costs, dev.valid_mask)
    best = take_rows(costs, best_value[:, None])[:, 0]
    improve = (current - best) > 1e-9
    lucky = uniform(key, (dev.n_vars,)) < PROBABILITY
    return DsaTutoState(
        values=torch.where(improve & lucky, best_value, state.values)
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
    """Solve ``compiled`` with DSA-tuto on ``device`` (the card unless the
    caller asks for the CPU); reports the best assignment seen."""
    prepare_algo_params(params or {}, algo_params)
    device = resolve_device(device)
    dev = device_problem(
        compiled, device, "dsatuto", params, n_cycles, collect_curve
    )
    values, curve, extras = run_cycles(
        compiled, dev, _init, _step, extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        return_final=False,
        health=health,
        carry_io=carry_io,
    )
    src, _ = compiled.neighbor_pairs()
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
    return UNIT_SIZE
