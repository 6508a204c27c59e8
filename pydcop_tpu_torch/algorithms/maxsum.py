"""Synchronous MaxSum (belief propagation on the factor graph), batched.

Counterpart of ``pydcop_tpu/algorithms/maxsum.py`` on its ELL layout:
factor->variable messages are min-marginals over the partner variable's
values (``factor_step_ell``, the Hopper kernel ``ell_minplus`` on the
card), variable->factor messages are the sum of the other factors' messages
plus unary costs, mean-normalized, with damping and tie-breaking noise on
the unary costs.  ``layout`` values ``"auto"``, ``"ell"`` and
``"ell_pallas"`` all run this one path; the JAX package's other layouts,
non-binary problems and bf16 planes raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    EllLayout,
    build_ell,
    factor_step_ell,
    masked_argmin,
    resolve_device,
    to_device,
    variable_step_with_select_ell,
)
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from .base import cached_const, extract_values, finalize, run_cycles

GRAPH_TYPE = "factor_graph"

STABILITY_COEFF = 0.1

algo_params = [
    AlgoParameterDef("damping", "float", None, 0.5),
    AlgoParameterDef(
        "damping_nodes", "str", ["vars", "factors", "both", "none"], "both"
    ),
    AlgoParameterDef("stability", "float", None, STABILITY_COEFF),
    AlgoParameterDef("noise", "float", None, 0.01),
    AlgoParameterDef(
        "start_messages", "str", ["leafs", "leafs_vars", "all"], "leafs"
    ),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    # physical layout of the message planes, as in the JAX package; only
    # the ELL layout is ported ("auto" and "ell_pallas" run it too)
    AlgoParameterDef(
        "layout", "str",
        ["auto", "edges", "lanes", "pallas", "ell", "ell_pallas"],
        "auto"
    ),
    # ELL shard-assignment strategy on sharded meshes; ignored on one device
    AlgoParameterDef(
        "ordering", "str",
        ["auto", "none", "bfs", "multilevel"],
        "auto"
    ),
    AlgoParameterDef("precision", "str", ["f32", "bf16"], "f32"),
]

#: layouts the port runs; every one reaches the ELL step and its kernel
ELL_LAYOUTS = ("auto", "ell", "ell_pallas")


@dataclass(frozen=True)
class EllCarry:
    """The unary plane permuted to ell variable order, computed once at
    init, after the noise was added."""

    unary_t: torch.Tensor  # [D, n_vars] in ell variable order


@dataclass(frozen=True)
class MaxSumState:
    v2f: torch.Tensor  # [D, n_pad] variable -> factor messages
    f2v: torch.Tensor  # [D, n_pad] factor -> variable messages
    # [n_vars] current best value per variable: the argmin of the fan-in
    # total, a byproduct of the variable half-cycle
    values: torch.Tensor
    cycle: int  # cycles completed so far
    aux: EllCarry


def _make_step(
    damping: float, damp_vars: bool, damp_factors: bool, wavefront: bool,
    ell_spans: Tuple[Tuple[int, int], ...],
):
    def step_ell(
        dev: DeviceDCOP, state: MaxSumState,
        act_v, act_f, pair_perm, tabs_t, pos_of_var,
        edge_valid_t, valid_ell_t, dsize_edges, real_row, var_perm,
    ) -> MaxSumState:
        i = state.cycle
        if wavefront:
            v2f_in = torch.where(i >= act_v[None, :], state.v2f, 0.0)
        else:
            v2f_in = state.v2f
        f2v = factor_step_ell(tabs_t, pair_perm, real_row, v2f_in)
        if wavefront:
            f2v = torch.where(i >= act_f[None, :], f2v, 0.0)
        if damp_factors and damping:
            f2v = damping * state.f2v + (1.0 - damping) * f2v
        v2f, values = variable_step_with_select_ell(
            ell_spans, state.aux.unary_t, valid_ell_t, edge_valid_t,
            dsize_edges, pos_of_var, real_row, f2v,
            damping=damping if damp_vars else 0.0,
            prev_v2f_t=state.v2f,
        )
        if wavefront:
            v2f = torch.where((i + 1) >= act_v[None, :], v2f, 0.0)
        return replace(state, v2f=v2f, f2v=f2v, values=values, cycle=i + 1)

    return step_ell


def init_ell(
    dev: DeviceDCOP,
    act_v, act_f, pair_perm, tabs_t, pos_of_var,
    edge_valid_t, valid_ell_t, dsize_edges, real_row, var_perm,
) -> MaxSumState:
    """Zero message planes; the selection is the unary argmin."""
    zeros = torch.zeros(
        (dev.max_domain, tabs_t.shape[2]), dtype=dev.unary.dtype,
        device=dev.unary.device,
    )
    return MaxSumState(
        v2f=zeros, f2v=zeros,
        values=masked_argmin(dev.unary, dev.valid_mask),
        cycle=0,
        # dev.unary is already noised here (run_cycles noises before init)
        aux=EllCarry(unary_t=dev.unary[var_perm].T.contiguous()),
    )


# SAME_COUNT: stop after this many consecutive stable cycles (reference
# maxsum.py:106 — computations stop resending after 4 identical messages)
SAME_COUNT = 4


def plane_stable(old: torch.Tensor, new: torch.Tensor, stability: float):
    """approx_match on one message plane: an entry is stable when
    unchanged at zero, or within ``stability`` relative change of its
    previous value; a change away from exactly zero is never stable."""
    both_zero = (old == 0.0) & (new == 0.0)
    within = (new - old).abs() <= stability * old.abs()
    return torch.all(both_zero | (within & (old != 0.0)))


def _make_convergence(stability: float):
    """Checked on both message planes: the assignment is read from f2v,
    which under damping can keep drifting after v2f stabilizes."""

    def converged(dev, old: MaxSumState, new: MaxSumState):
        return plane_stable(old.v2f, new.v2f, stability) & plane_stable(
            old.f2v, new.f2v, stability
        )

    return converged


def _var_components(compiled) -> np.ndarray:
    """Connected-component label per variable (variables sharing a
    constraint are connected), memoized on the compiled problem."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    def build():
        n = compiled.n_vars
        if compiled.n_edges == 0:
            return np.zeros(n, dtype=np.int64)
        # connect each edge's variable to the first var of its constraint
        order = np.argsort(compiled.edge_con, kind="stable")
        ev = compiled.edge_var[order]
        ec = compiled.edge_con[order]
        anchor = ev[np.searchsorted(ec, ec)]
        g = coo_matrix(
            (np.ones(len(ev), dtype=np.int8), (ev, anchor)), shape=(n, n)
        )
        return connected_components(g, directed=False)[1]

    return cached_const(compiled, ("var_components",), build)


def _var_starters(compiled, start_mode: str) -> np.ndarray:
    """[n_vars] bool: which variables emit from cycle 0 under
    ``start_messages``: all of them for ``all``/``leafs_vars``; for
    ``leafs``, degree-1 variables and variables with non-constant unary
    costs, plus every variable of a component that has no such starter."""
    if start_mode in ("all", "leafs_vars"):
        return np.ones(compiled.n_vars, dtype=bool)
    # ptp over VALID domain slots only: padded slots must not
    # make a constant nonzero unary cost look non-constant
    hi = np.where(compiled.valid_mask, compiled.unary, -np.inf).max(axis=1)
    lo = np.where(compiled.valid_mask, compiled.unary, np.inf).min(axis=1)
    has_unary = (hi - lo) > 0.0
    starters = (compiled.var_degree == 1) | has_unary
    if not starters.any():
        # no leafs anywhere (cyclic graph, no unary costs): the
        # reference protocol would deadlock; start everyone
        starters = np.ones_like(starters)
    elif not starters.all():
        # a starterless component would never activate: start it whole
        comp = _var_components(compiled)
        comp_has = np.zeros(int(comp.max()) + 1, dtype=bool)
        np.maximum.at(comp_has, comp, starters)
        starters = starters | ~comp_has[comp]
    return starters


# activation cycle sentinel for slots that never activate (padding)
NEVER = np.int32(2**30)


def activation_cycles(
    compiled, start_mode: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Precomputed wavefront: per-edge int32 arrays (act_v, act_f) giving
    the cycle at which the edge's variable / factor starts emitting.

    A factor sends once any of its variables has sent, a variable sends one
    cycle after any of its factors did: a multi-source BFS over the
    variable graph from the starters, so act_v[v] = BFS distance from the
    nearest starter and act_f[c] = min over the scope of act_v.  Cached on
    the compiled problem."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    def build():
        starters = _var_starters(compiled, start_mode)
        n = compiled.n_vars
        if starters.all():
            act_v = np.zeros(n, dtype=np.int32)
        else:
            src, dst = compiled.neighbor_pairs()
            g = coo_matrix(
                (np.ones(len(src), dtype=np.int8), (src, dst)), shape=(n, n)
            )
            dist = dijkstra(
                g, directed=True, unweighted=True,
                indices=np.flatnonzero(starters), min_only=True,
            )
            act_v = np.where(np.isfinite(dist), dist, NEVER).astype(np.int32)
        act_f = np.full(compiled.n_constraints, NEVER, dtype=np.int32)
        for b in compiled.buckets:
            act_f[b.con_ids] = act_v[b.var_slots].min(axis=1)
        return act_v[compiled.edge_var], act_f[compiled.edge_con]

    return cached_const(compiled, ("activation", start_mode), build)


def _ell_activation(compiled, ell: EllLayout, start_mode: str, device):
    """Wavefront activation arrays permuted to ELL slot order, on
    ``device`` (cached).  Padding slots get an unreachable activation
    cycle so both wavefront masks pin them to exact zeros."""

    def build():
        act_v, act_f = activation_cycles(compiled, start_mode)
        real = ell.edge_orig >= 0
        eo = ell.edge_orig[real]
        av = np.full(ell.n_pad, NEVER, dtype=np.int32)
        af = np.full(ell.n_pad, NEVER, dtype=np.int32)
        av[real] = act_v[eo]
        af[real] = act_f[eo]
        return (
            torch.as_tensor(av, device=device),
            torch.as_tensor(af, device=device),
        )

    return cached_const(compiled, ("ell_act", start_mode, str(device)), build)


def _ell_dev_arrays(compiled, ell: EllLayout, device) -> Tuple:
    """Device-resident ELL operand pack, cached per compiled problem and
    device (order matches the init_ell/step_ell signatures)."""

    def build():
        def idx(a):
            return torch.as_tensor(
                np.asarray(a, dtype=np.int64), device=device
            )

        return (
            torch.as_tensor(ell.pair_perm, device=device),  # int32: kernel
            torch.as_tensor(ell.tabs_t, device=device),
            idx(ell.pos_of_var),
            torch.as_tensor(ell.edge_valid_t, device=device),
            torch.as_tensor(ell.valid_ell_t, device=device),
            torch.as_tensor(ell.dsize_edges, device=device),
            torch.as_tensor(ell.real_row, device=device),
            idx(ell.var_perm),
        )

    return cached_const(compiled, ("ell_dev", str(device)), build)


def _check_supported(compiled: CompiledDCOP, params: Dict[str, Any]) -> None:
    if params["layout"] not in ELL_LAYOUTS:
        raise NotImplementedError(
            f"maxsum layout={params['layout']!r} is not ported yet; the "
            f"port runs the ELL layout ({', '.join(ELL_LAYOUTS)})"
        )
    if params["precision"] != "f32":
        raise NotImplementedError(
            "maxsum precision='bf16' is not ported yet; use 'f32'"
        )
    if compiled.n_edges == 0:
        raise NotImplementedError(
            "maxsum on a problem with no edges needs the lanes layout, "
            "which is not ported yet"
        )
    if any(b.arity != 2 for b in compiled.buckets):
        raise NotImplementedError(
            "maxsum on non-binary constraints needs the lanes layout, "
            "which is not ported yet"
        )


def solve(
    compiled: CompiledDCOP,
    params: Optional[Dict[str, Any]] = None,
    n_cycles: int = 100,
    seed: int = 0,
    timeout: Optional[float] = None,
    device="cuda",
) -> SolveResult:
    """Solve ``compiled`` with MaxSum on ``device`` (the card unless the
    caller asks for the CPU).  Reports the best assignment seen across
    cycles and the cycles actually run."""
    params = prepare_algo_params(params or {}, algo_params)
    _check_supported(compiled, params)
    if timeout is not None:
        raise NotImplementedError("maxsum timeout is not ported yet")
    device = resolve_device(device)
    if params["stop_cycle"]:
        n_cycles = params["stop_cycle"]
    damping = params["damping"]
    damp_vars = params["damping_nodes"] in ("vars", "both")
    damp_factors = params["damping_nodes"] in ("factors", "both")
    start_mode = params["start_messages"]
    wavefront = start_mode != "all"

    dev = cached_const(
        compiled, ("dev", str(device)), lambda: to_device(compiled, device)
    )
    ell = cached_const(compiled, ("ell_host",), lambda: build_ell(compiled))
    if wavefront:
        act_v, act_f = _ell_activation(compiled, ell, start_mode, device)
    else:
        act_v = act_f = torch.zeros(1, dtype=torch.int32, device=device)
    consts = (act_v, act_f) + _ell_dev_arrays(compiled, ell, device)
    step = _make_step(damping, damp_vars, damp_factors, wavefront, ell.spans)

    values, extras = run_cycles(
        dev, init_ell, step, extract_values,
        n_cycles=n_cycles,
        seed=seed,
        consts=consts,
        noise=params["noise"],
        # early exit once messages are stable for SAME_COUNT cycles (the
        # reference's approx_match termination), unless stop_cycle is set
        convergence=(
            _make_convergence(params["stability"])
            if not params["stop_cycle"]
            else None
        ),
        same_count=SAME_COUNT,
    )
    cycles = extras["cycles"]
    # 2 messages per edge per cycle (var->factor and factor->var), size = 2*D
    msg_count = 2 * compiled.n_edges * cycles
    msg_size = msg_count * 2 * compiled.max_domain
    return finalize(compiled, values, cycles, msg_count, msg_size)
