"""Top-level solve API.

Counterpart of ``pydcop_tpu/api.py``: one call from a DCOP and an
algorithm name to the result dict, field for field the JAX package's
(``status``, ``assignment``, ``cost``, ``violation``, ``msg_count``,
``msg_size``, ``cycle``, ``time``, and ``distribution`` and
``cost_curve`` when asked for).  The problem is compiled to arrays and
solved on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Dict, Optional, Union

from .algorithms import AlgorithmDef, SolveResult, load_algorithm_module
from .compile.core import CompiledDCOP, compile_dcop
from .constants import INFINITY
from .dcop.dcop import DCOP

__all__ = ["solve", "solve_result", "INFINITY"]


def solve_result(
    dcop: DCOP,
    algo_def: Union[str, AlgorithmDef],
    distribution: Optional[str] = None,
    n_cycles: int = 100,
    seed: int = 0,
    collect_curve: bool = False,
    compiled: Optional[CompiledDCOP] = None,
    timeout: Optional[float] = None,
    infinity: float = INFINITY,
    device="cuda",
) -> Dict[str, Any]:
    """Solve and return the full metrics dict (the schema of pyDCOP's
    ``pydcop solve`` JSON output).

    ``timeout`` covers compile plus solve: the solver gets what remains
    and a solve that ran past it reports ``TIMEOUT``.  ``infinity``
    stands in for symbolic infinity when reporting hard-constraint
    violations; only the reported cost depends on it, so a value other
    than INFINITY re-evaluates the final assignment on the host."""
    if isinstance(algo_def, str):
        algo_def = AlgorithmDef.build_with_default_param(
            algo_def, mode=dcop.objective
        )
    algo_module = load_algorithm_module(algo_def.algo)

    t0 = time.perf_counter()
    if compiled is None:
        compiled = compile_dcop(dcop)
    solve_kwargs = {}
    if timeout is not None:
        # one-shot solvers (dpop) take no timeout
        remaining = max(0.05, timeout - (time.perf_counter() - t0))
        if "timeout" in inspect.signature(algo_module.solve).parameters:
            solve_kwargs["timeout"] = remaining
    result: SolveResult = algo_module.solve(
        compiled,
        params=algo_def.params,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        device=device,
        **solve_kwargs,
    )
    elapsed = time.perf_counter() - t0

    status = result.status
    if timeout is not None and elapsed > timeout:
        status = "TIMEOUT"

    cost, violations = result.cost, result.violations
    if infinity != INFINITY:
        # solvers report with the default infinity; re-evaluate the final
        # assignment under the requested one (host-side reporting only)
        if compiled.dcop is not None:
            cost, violations = compiled.dcop.solution_cost(
                result.assignment, infinity
            )
        else:
            cost, violations = compiled.host_cost(
                compiled.indices_from_assignment(result.assignment),
                infinity,
            )

    out = {
        "status": status,
        "assignment": result.assignment,
        "cost": cost,
        "violation": violations,
        "msg_count": result.msg_count,
        "msg_size": result.msg_size,
        "cycle": result.cycles,
        "time": elapsed,
    }
    if distribution is not None:
        out["distribution"] = distribution
    if result.cost_curve is not None:
        out["cost_curve"] = result.cost_curve
    return out


def solve(
    dcop: DCOP,
    algo_def: Union[str, AlgorithmDef],
    distribution: Optional[str] = "oneagent",
    timeout: Optional[float] = None,
    n_cycles: int = 100,
    seed: int = 0,
    device="cuda",
) -> Dict[str, Any]:
    """One-call solve returning the final assignment."""
    return solve_result(
        dcop,
        algo_def,
        distribution,
        n_cycles=n_cycles,
        seed=seed,
        timeout=timeout,
        device=device,
    )["assignment"]
