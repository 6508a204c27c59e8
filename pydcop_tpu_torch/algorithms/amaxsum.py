"""A-MaxSum: asynchronous MaxSum, emulated with random activation masks.

Counterpart of ``pydcop_tpu/algorithms/amaxsum.py``: MaxSum's messages and
parameters, with asynchrony as per-cycle Bernoulli wake masks inside the
synchronous loop.  Each cycle a random half of the factors and of the
variables recompute their outgoing messages (``uniform < ACTIVATION``
from a two-way split of the cycle key, bit-equal to the JAX package's
draws); the others keep sending their previous ones.  It runs on the
edges layout (``[n_edges, D]`` planes).  The state keeps each step's
unmasked candidates, and the stability stop compares the planes before
the step with them, so a sleeping computation whose pending update
differs is never counted stable.  ``start_messages`` is accepted and has
no effect: random subsets wake from the first cycle.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    damp,
    factor_step,
    masked_argmin,
    resolve_device,
    variable_step_with_select,
)
from ..random import split, uniform
from . import SolveResult, prepare_algo_params, warn_inert_params
from .base import (
    device_problem,
    extract_values,
    field_io,
    finalize,
    run_cycles,
)
from .maxsum import SAME_COUNT, health, plane_stable
from .maxsum import algo_params as _maxsum_params

GRAPH_TYPE = "factor_graph"

#: the checkpoint form: JAX's state leaves, every one of which moves
carry_io = field_io("v2f", "f2v", "values", "v2f_cand", "f2v_cand")

UNIT_SIZE = 1

# the agent runtime's footprint models: MaxSum's
from .maxsum import communication_load, computation_memory  # noqa: E402,F401

# the chance that a computation wakes in a cycle
ACTIVATION = 0.5

# MaxSum's parameters without the port's layout choices: A-MaxSum runs
# the edges layout in float32
algo_params = [
    p for p in _maxsum_params
    if p.name not in ("layout", "ordering", "precision")
]

inert_params = {
    "start_messages": (
        "the async emulation wakes random computation subsets from step 0, "
        "which subsumes the reference's staged leaf-first start modes"
    ),
}


class AMaxSumState(NamedTuple):
    v2f: torch.Tensor  # [n_edges, D]
    f2v: torch.Tensor  # [n_edges, D]
    values: torch.Tensor  # [n_vars], the fan-in total's argmin
    # this step's unmasked candidates: what every computation would have
    # sent had it been awake (the stability test reads them)
    v2f_cand: torch.Tensor  # [n_edges, D]
    f2v_cand: torch.Tensor  # [n_edges, D]


@functools.lru_cache(maxsize=None)
def _make_step(damping: float, damp_vars: bool, damp_factors: bool):
    """The A-MaxSum cycle; both planes are damped as one fused
    multiply-add (``damp``'s ``fma``), the form XLA's CPU compiler gives
    the JAX package's A-MaxSum program."""

    def step(
        dev: DeviceDCOP, state: AMaxSumState, key, *consts
    ) -> AMaxSumState:
        k_f, k_v = split(key)
        f_awake = uniform(k_f, (dev.n_constraints,)) < ACTIVATION
        f2v_new = factor_step(dev, state.v2f)
        if damp_factors and damping:
            f2v_new = damp(damping, state.f2v, f2v_new, fma=True)
        f2v = torch.where(
            f_awake[dev.edge_con][:, None], f2v_new, state.f2v
        )
        v_awake = uniform(k_v, (dev.n_vars,)) < ACTIVATION
        v2f_new, values = variable_step_with_select(
            dev, f2v, damping=damping if damp_vars else 0.0,
            prev_v2f=state.v2f, fma=True,
        )
        v2f = torch.where(v_awake[dev.edge_var][:, None], v2f_new, state.v2f)
        return AMaxSumState(
            v2f=v2f, f2v=f2v, values=values,
            v2f_cand=v2f_new, f2v_cand=f2v_new,
        )

    return step


def _init(dev: DeviceDCOP, key, *consts) -> AMaxSumState:
    zeros = dev.unary.new_zeros((dev.n_edges, dev.max_domain))
    return AMaxSumState(
        v2f=zeros, f2v=zeros,
        values=masked_argmin(dev.unary, dev.valid_mask),
        v2f_cand=zeros, f2v_cand=zeros,
    )


@functools.lru_cache(maxsize=None)
def _make_convergence(stability: float):
    """Converged only when every computation, awake or asleep, would
    re-derive its outgoing messages within ``stability``: the planes
    before the step against the step's unmasked candidates."""

    def converged(dev, old: AMaxSumState, new: AMaxSumState):
        return plane_stable(old.f2v, new.f2v_cand, stability) & plane_stable(
            old.v2f, new.v2f_cand, stability
        )

    return converged


def solve(
    compiled: CompiledDCOP,
    params: Optional[Dict[str, Any]] = None,
    n_cycles: int = 100,
    seed: int = 0,
    collect_curve: bool = False,
    timeout: Optional[float] = None,
    device="cuda",
) -> SolveResult:
    """Solve ``compiled`` with A-MaxSum on ``device`` (the card unless the
    caller asks for the CPU); reports the best assignment seen."""
    warn_inert_params(params, inert_params, algo_params)
    params = prepare_algo_params(params or {}, algo_params)
    if params["stop_cycle"]:
        n_cycles = params["stop_cycle"]
    damping = params["damping"]
    device = resolve_device(device)
    dev = device_problem(
        compiled, device, "amaxsum", params, n_cycles, collect_curve
    )
    values, curve, extras = run_cycles(
        compiled, dev, _init,
        _make_step(
            damping, params["damping_nodes"] in ("vars", "both"),
            params["damping_nodes"] in ("factors", "both"),
        ),
        extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        noise=params["noise"],
        return_final=False,
        health=health,
        carry_io=carry_io,
        # MaxSum's stability stop, off under an explicit stop_cycle
        convergence=(
            _make_convergence(params["stability"])
            if not params["stop_cycle"] else None
        ),
        same_count=SAME_COUNT,
    )
    cycles = extras["cycles"]
    # about ACTIVATION of each side emits a cycle
    msg_count = int(2 * compiled.n_edges * cycles * ACTIVATION)
    msg_size = msg_count * 2 * compiled.max_domain
    return finalize(
        compiled, values, cycles, msg_count, msg_size, curve,
        status="TIMEOUT" if extras["timed_out"] else "FINISHED",
    )
