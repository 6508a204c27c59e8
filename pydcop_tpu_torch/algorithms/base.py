"""The cycle-loop engine shared by the solvers.

Counterpart of the fused path of ``pydcop_tpu/algorithms/base.py``
(``_noised``, ``_track_best``, ``_fused_core``/``_while_chunk`` as driven
by ``run_cycles``, and ``finalize``).  A solver is a pair of functions
``init(dev, *consts) -> state`` and ``step(dev, state, *consts) -> state``
that the engine advances once per synchronous cycle of the whole
multi-agent system, with the same semantics as the JAX engine:

- tie-breaking noise is added to the unary plane first (one threefry draw
  of shape ``(n_vars, D)`` from ``PRNGKey(seed)``, bit-equal to jax's);
- the anytime best starts at the initial state's assignment and moves on a
  strict ``<`` improvement, with a 1-based ``best_cycle``;
- with a ``convergence`` test, the loop stops before a step once
  ``same_count`` consecutive cycles were stable.

The loop is a Python loop of eager device ops; the stability counter costs
one scalar read-back per cycle.  Timeout chunking, checkpoints and the
health telemetry of the JAX engine are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import DeviceDCOP, evaluate
from ..random import PRNGKey, uniform
from . import SolveResult

__all__ = ["cached_const", "run_cycles", "finalize", "extract_values"]


def extract_values(dev: DeviceDCOP, state) -> torch.Tensor:
    """Default ``extract``: the solver state's ``values`` field."""
    return state.values


def cached_const(compiled, key: Tuple, build: Callable[[], Any]):
    """Per-compiled-problem cache of solver constants (host layouts and
    device-resident operands): a warm solve rebuilds and uploads nothing.
    ``key`` must include every input the built value depends on beyond
    the compiled problem itself (params, the device)."""
    cache = compiled.__dict__.setdefault("_device_consts", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _noised(dev: DeviceDCOP, key, level: float) -> DeviceDCOP:
    """Add ``level * uniform`` tie-breaking noise to the valid slots of the
    unary plane (the reference's VariableNoisyCostFunc)."""
    draw = uniform(
        key, (dev.n_vars, dev.max_domain), device=dev.unary.device
    )
    noise = torch.where(dev.valid_mask, draw * level, 0.0)
    return dataclasses.replace(dev, unary=dev.unary + noise)


def _track_best(dev, state, extract, best_vals, best_cost, best_cycle,
                cycle: int):
    """Anytime-best update: this cycle's assignment replaces the best on a
    strict improvement, and ``best_cycle`` records the 1-based cycle at
    which the best was first attained (0 = never improved on)."""
    vals = extract(dev, state)
    cost = evaluate(dev, vals)
    better = cost < best_cost
    return (
        torch.where(better, vals, best_vals),
        torch.where(better, cost, best_cost),
        torch.where(better, cycle, best_cycle),
    )


def run_cycles(
    dev: DeviceDCOP,
    init: Callable,
    step: Callable,
    extract: Callable,
    n_cycles: int,
    seed: int = 0,
    convergence: Optional[Callable] = None,
    same_count: int = 4,
    consts: Tuple = (),
    noise: float = 0.0,
) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Drive a solver on ``dev``: noise, init, then up to ``n_cycles``
    steps with anytime-best tracking.  Returns the best value indices seen
    (on the host) and extras: ``best_cost`` (min-form, on the noised
    costs), ``cycles`` (steps run) and ``cycles_to_best``.

    ``convergence(dev, old_state, new_state) -> bool tensor``: when given,
    the loop stops once ``same_count`` consecutive steps were stable."""
    if noise:
        dev = _noised(dev, PRNGKey(seed), noise)
    state = init(dev, *consts)
    best_vals = extract(dev, state)
    best_cost = evaluate(dev, best_vals)
    best_cycle = torch.zeros((), dtype=torch.int32, device=best_cost.device)
    stable = 0
    cycles = 0
    while cycles < n_cycles:
        if convergence is not None and stable >= same_count:
            break
        new_state = step(dev, state, *consts)
        cycles += 1
        best_vals, best_cost, best_cycle = _track_best(
            dev, new_state, extract, best_vals, best_cost, best_cycle,
            cycles,
        )
        if convergence is not None:
            # the one host read-back of a cycle
            stable = stable + 1 if bool(
                convergence(dev, state, new_state)
            ) else 0
        state = new_state
    extras = {
        "best_cost": float(best_cost),
        "cycles": cycles,
        "cycles_to_best": int(best_cycle),
    }
    return best_vals.cpu().numpy(), extras


def finalize(
    compiled: CompiledDCOP,
    values_idx: np.ndarray,
    cycles: int,
    msg_count: int,
    msg_size: int,
) -> SolveResult:
    """Decode indices, compute the exact host-side cost (float64, with the
    reference's violation counting) and build the result."""
    assignment = compiled.assignment_from_indices(values_idx)
    cost, violations = compiled.host_cost(values_idx)
    return SolveResult(
        assignment=assignment,
        cost=cost,
        violations=violations,
        cycles=cycles,
        msg_count=msg_count,
        msg_size=msg_size,
    )
