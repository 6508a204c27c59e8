"""Synchronous MaxSum (belief propagation on the factor graph), batched.

Counterpart of ``pydcop_tpu/algorithms/maxsum.py``: factor->variable
messages are min-marginals over the other variables' values,
variable->factor messages are the sum of the other factors' messages plus
unary costs, mean-normalized, with damping and tie-breaking noise on the
unary costs.  Three physical layouts of the message planes, as in the JAX
package, with identical math:

- ``"ell"`` (and ``"ell_pallas"``): the degree-bucketed layout, binary
  constraints only; its factor step is the Hopper kernel ``ell_minplus``
  on the card;
- ``"lanes"`` (and ``"pallas"``): ``[D, n_edges]`` planes, any arity;
  every arity-2 bucket runs the Hopper kernel ``factor_arity2_minplus``
  on the card;
- ``"edges"``: ``[n_edges, D]`` planes, any arity, plain PyTorch.

``"auto"`` runs ELL where it applies and lanes on problems ELL cannot
represent (non-binary constraints, no edges), as do ``"ell"`` and
``"ell_pallas"``.  ``precision="bf16"`` stores both message planes in
bfloat16 on every layout, as the JAX package's jitted step does: the
planes start as bf16 zeros, every op that reads them widens them to
float32 (both kernels take the bf16 plane and widen as they load), and
each step's new planes are rounded to bf16 (to nearest even) once, as
they are stored; tables, unary costs and ``evaluate`` stay float32.  The
solve runs on the cycle engine of ``base.py``: on the card, as replays
of a captured CUDA graph, the kernels inside it.
"""

from __future__ import annotations

import functools
import logging
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    EllLayout,
    LanesAux,
    bf16_scalar,
    build_ell,
    damp,
    factor_step,
    factor_step_ell,
    factor_step_lanes,
    lanes_aux,
    masked_argmin,
    resolve_device,
    to_device,
    variable_step_with_select,
    variable_step_with_select_ell,
    variable_step_with_select_lanes,
)
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from .base import (
    CarryIO,
    cached_const,
    device_problem,
    extract_values,
    finalize,
    run_cycles,
)

logger = logging.getLogger(__name__)

GRAPH_TYPE = "factor_graph"

HEADER_SIZE = 0
UNIT_SIZE = 1
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
    # physical layout of the message planes, as in the JAX package
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

@dataclass(frozen=True)
class EllCarry:
    """The unary plane permuted to ell variable order, computed once at
    init, after the noise was added."""

    unary_t: torch.Tensor  # [D, n_vars] in ell variable order


@dataclass(frozen=True)
class MaxSumState:
    # message planes: [D, n_pad] (ell), [D, n_edges] (lanes) or
    # [n_edges, D] (edges)
    v2f: torch.Tensor  # variable -> factor messages
    f2v: torch.Tensor  # factor -> variable messages
    # [n_vars] current best value per variable: the argmin of the fan-in
    # total, a byproduct of the variable half-cycle
    values: torch.Tensor
    cycle: torch.Tensor  # int32 cycles completed so far
    aux: Union[EllCarry, LanesAux, None]  # None on the edges layout


#: the message-plane dtype of each ``precision``
PLANE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def computation_memory(computation) -> float:
    """Footprint model of a factor-graph node (the JAX package's): a
    factor stores one cost vector per neighbor variable, a variable one
    per neighbor factor.  Host only; the IoT generator sizes its agents'
    capacities with it."""
    node_type = computation.type
    if node_type == "FactorComputation":
        return float(
            sum(len(v.domain) for v in computation.variables)
        )
    if node_type == "VariableComputation":
        return float(
            len(computation.variable.domain) * len(computation.links)
        )
    raise ValueError(
        f"invalid computation node type for maxsum: {computation}"
    )


def communication_load(src, target: str) -> float:
    """Message size over one factor-graph edge: the domain size."""
    if src.type == "VariableComputation":
        return UNIT_SIZE * len(src.variable.domain) + HEADER_SIZE
    if src.type == "FactorComputation":
        for v in src.variables:
            if v.name == target:
                return UNIT_SIZE * len(v.domain) + HEADER_SIZE
        raise ValueError(f"variable {target} not in factor {src.name}")
    raise ValueError(f"invalid computation node type for maxsum: {src}")


@functools.lru_cache(maxsize=None)
def _make_step(
    damping: float, damp_vars: bool, damp_factors: bool, wavefront: bool,
    layout: str, ell_spans: Tuple[Tuple[int, int], ...] = (),
    precision: str = "f32", fma_damping: bool = False,
):
    """The cycle of ``layout`` ("ell", "lanes" or "edges") with message
    planes stored in ``precision``; cached, so a warm solve finds its
    captured graphs under the same step.  ``fma_damping`` damps both
    float32 planes as one fused multiply-add (``damp``'s ``fma``: the
    ``damp_fma`` kernel on the card), as XLA's CPU compiler contracts the
    JAX package's MaxSum programs on every layout: the solve (fused,
    chunked, checkpointed, pulse on), the serving batch and the resident
    DynamicMaxSum session all set it.  bf16 planes ignore it."""
    var_damping = damping if damp_vars else 0.0
    plane_dtype = PLANE_DTYPES[precision]

    def store(state, v2f, f2v, values, i):
        # the store rounds (bf16); the computation above ran in float32
        return replace(
            state, v2f=v2f.to(plane_dtype), f2v=f2v.to(plane_dtype),
            values=values, cycle=i + 1,
        )

    def step_ell(
        dev: DeviceDCOP, state: MaxSumState, key,
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
            f2v = damp(damping, state.f2v, f2v, fma_damping)
        v2f, values = variable_step_with_select_ell(
            ell_spans, state.aux.unary_t, valid_ell_t, edge_valid_t,
            dsize_edges, pos_of_var, real_row, f2v,
            damping=var_damping, prev_v2f_t=state.v2f, fma=fma_damping,
        )
        if wavefront:
            v2f = torch.where((i + 1) >= act_v[None, :], v2f, 0.0)
        return store(state, v2f, f2v, values, i)

    if layout == "ell":
        return step_ell
    lanes = layout == "lanes"

    def edge_mask(mask):  # broadcast a per-edge mask over the domain axis
        return mask[None, :] if lanes else mask[:, None]

    def step(dev: DeviceDCOP, state: MaxSumState, key, act_v, act_f, *_):
        # *_: the lanes layout's static aux const, which init put in state
        i = state.cycle
        if wavefront:
            v2f_in = torch.where(edge_mask(i >= act_v), state.v2f, 0.0)
        else:
            v2f_in = state.v2f
        if lanes:
            f2v = factor_step_lanes(dev, state.aux, v2f_in)
        else:
            f2v = factor_step(dev, v2f_in)
        if wavefront:
            # a factor sends once any of its variables has
            f2v = torch.where(edge_mask(i >= act_f), f2v, 0.0)
        if damp_factors and damping:
            f2v = damp(damping, state.f2v, f2v, fma_damping)
        if lanes:
            v2f, values = variable_step_with_select_lanes(
                dev, state.aux, f2v, damping=var_damping,
                prev_v2f_t=state.v2f, fma=fma_damping,
            )
        else:
            v2f, values = variable_step_with_select(
                dev, f2v, damping=var_damping, prev_v2f=state.v2f,
                fma=fma_damping,
            )
        if wavefront:
            # a variable starts sending once any of its factors has sent
            v2f = torch.where(edge_mask((i + 1) >= act_v), v2f, 0.0)
        return store(state, v2f, f2v, values, i)

    return step


def _cycle_zero(dev: DeviceDCOP) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev.unary.device)


@functools.lru_cache(maxsize=None)
def _make_init(layout: str, precision: str = "f32"):
    """The initial state of ``layout``: zero message planes of
    ``precision``, and the unary argmin as the selection.  Cached, so a
    warm solve finds its captured graphs under the same function."""
    plane_dtype = PLANE_DTYPES[precision]

    def zeros(dev: DeviceDCOP, shape):
        return dev.unary.new_zeros(shape, dtype=plane_dtype)

    def init_ell(
        dev: DeviceDCOP, key,
        act_v, act_f, pair_perm, tabs_t, pos_of_var,
        edge_valid_t, valid_ell_t, dsize_edges, real_row, var_perm,
    ) -> MaxSumState:
        z = zeros(dev, (dev.max_domain, tabs_t.shape[2]))
        return MaxSumState(
            v2f=z, f2v=z,
            values=masked_argmin(dev.unary, dev.valid_mask),
            cycle=_cycle_zero(dev),
            # dev.unary is already noised here (run_cycles noises first)
            aux=EllCarry(unary_t=dev.unary[var_perm].T.contiguous()),
        )

    def init_lanes(
        dev: DeviceDCOP, key, act_v, act_f, aux: LanesAux
    ) -> MaxSumState:
        # aux is the problem's static lanes_aux, given the noised unary
        z = zeros(dev, (dev.max_domain, dev.n_edges))
        return MaxSumState(
            v2f=z, f2v=z,
            values=masked_argmin(dev.unary, dev.valid_mask),
            cycle=_cycle_zero(dev),
            aux=replace(aux, unary_t=dev.unary.T.contiguous()),
        )

    def init_edges(dev: DeviceDCOP, key, act_v, act_f) -> MaxSumState:
        z = zeros(dev, (dev.n_edges, dev.max_domain))
        return MaxSumState(
            v2f=z, f2v=z,
            values=masked_argmin(dev.unary, dev.valid_mask),
            cycle=_cycle_zero(dev),
            aux=None,
        )

    return {"ell": init_ell, "lanes": init_lanes, "edges": init_edges}[layout]


# SAME_COUNT: stop after this many consecutive stable cycles (reference
# maxsum.py:106 — computations stop resending after 4 identical messages)
SAME_COUNT = 4


def health(dev: DeviceDCOP, old_state, new_state) -> torch.Tensor:
    """The health hook (``telemetry/pulse.py``): residual = the max-abs
    change of the variable->factor plane this cycle, aux = the same of
    the factor->variable plane; bf16 planes are widened first, so both
    are exact in float32.  A-MaxSum and the resident session use it too
    (any state with ``v2f`` and ``f2v`` planes, of either orientation)."""
    r_v = (new_state.v2f.float() - old_state.v2f.float()).abs().max()
    r_f = (new_state.f2v.float() - old_state.f2v.float()).abs().max()
    return torch.stack([r_v, r_f])


def _save_leaves(state: MaxSumState, consts) -> list:
    """JAX's ``MaxSumState`` leaves: the planes, values and cycle, the
    wavefront activation arrays (the port's first two constants) and the
    layout's companions as JAX holds them (ELL: the permuted unary plane;
    lanes: the transposed tables, unary plane and valid mask)."""
    aux = state.aux
    if isinstance(aux, EllCarry):
        companions = [aux.unary_t]
    elif isinstance(aux, LanesAux):
        companions = [*aux.tables_t, aux.unary_t, aux.valid_t]
    else:
        companions = []
    return [
        state.v2f, state.f2v, state.values, state.cycle, consts[0],
        consts[1], *companions,
    ]


def _load_leaves(state: MaxSumState, leaves) -> MaxSumState:
    """The planes, values and cycle of JAX's leaves on a fresh state; the
    companions stay the ones built from the problem and the noise."""
    v2f, f2v, values, cycle = leaves[:4]
    return replace(state, v2f=v2f, f2v=f2v, values=values, cycle=cycle)


#: the checkpoint form of every layout
carry_io = CarryIO(_save_leaves, _load_leaves)


def plane_stable(old: torch.Tensor, new: torch.Tensor, stability: float):
    """approx_match on one message plane: an entry is stable when
    unchanged at zero, or within ``stability`` relative change of its
    previous value; a change away from exactly zero is never stable.

    bf16 planes compare as the JAX package's jitted check does: in bf16
    arithmetic, each op computed in float32 and rounded to bf16, with
    ``stability`` rounded to bf16."""
    both_zero = (old == 0.0) & (new == 0.0)
    if old.dtype == torch.bfloat16:
        o = old.float()
        diff = (new.float() - o).to(torch.bfloat16).float().abs()
        bound = (o.abs() * bf16_scalar(stability)).to(torch.bfloat16)
        within = diff <= bound.float()
    else:
        within = (new - old).abs() <= stability * old.abs()
    return torch.all(both_zero | (within & (old != 0.0)))


@functools.lru_cache(maxsize=None)
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
        if compiled.n_edges == 0:
            # the one dummy edge of an edgeless problem (to_device)
            z = np.zeros(1, dtype=np.int32)
            return z, z
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


def _ell_activation(compiled, ell: EllLayout, start_mode: str, device,
                    tag: str = "ell_act"):
    """Wavefront activation arrays permuted to ELL slot order, on
    ``device`` (cached under ``tag``: one per layout of the problem).
    Padding slots get an unreachable activation cycle so both wavefront
    masks pin them to exact zeros."""

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

    return cached_const(compiled, (tag, start_mode, str(device)), build)


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


def _edge_activation(compiled, start_mode: str, device):
    """The per-edge wavefront activation arrays on ``device`` (cached)."""

    def build():
        return tuple(
            torch.as_tensor(a, device=device)
            for a in activation_cycles(compiled, start_mode)
        )

    return cached_const(compiled, ("edge_act", start_mode, str(device)), build)


def resolve_layout(compiled: CompiledDCOP, layout: str) -> str:
    """The cycle a ``layout`` parameter runs: "ell", "lanes" or "edges".
    ``auto``, ``ell`` and ``ell_pallas`` run ELL where it applies and
    lanes where ELL cannot represent the problem; ``pallas`` is lanes
    (its arity-2 kernel runs on every lanes solve)."""
    if layout in ("auto", "ell", "ell_pallas"):
        if compiled.n_edges == 0:
            logger.info(
                "maxsum layout=%r runs as 'lanes' because the problem has "
                "no edges", layout,
            )
            return "lanes"
        if any(b.arity != 2 for b in compiled.buckets):
            logger.info(
                "maxsum layout=%r runs as 'lanes' because the problem has "
                "non-binary constraints", layout,
            )
            return "lanes"
        return "ell"
    return "lanes" if layout == "pallas" else layout


def _serve_ell(compiled: CompiledDCOP) -> EllLayout:
    """The serving layer's ELL layout: every degree class's variable count
    rounded up to a power of two (``serve.bucket.pad_ell_classes``), so
    two graphs with the same padded span signature share the step and one
    span table serves a batch.  Cached on the compiled problem."""
    from ..serve.bucket import pad_ell_classes

    return cached_const(
        compiled, ("serve_ell",),
        lambda: pad_ell_classes(
            cached_const(compiled, ("ell_host",), lambda: build_ell(compiled))
        ),
    )


def _serve_supported(compiled: CompiledDCOP) -> None:
    if compiled.n_edges == 0 or any(b.arity != 2 for b in compiled.buckets):
        from ..serve.batch import ServeUnsupported

        raise ServeUnsupported(
            "maxsum batch serving runs the ELL layout, which needs at "
            "least one edge and binary constraints only: serve this "
            "problem sequentially"
        )


def bucket_extra(compiled: CompiledDCOP, params: Dict) -> tuple:
    """The serving layer's bucket-key component: the padded ELL span
    signature, the step's static shape that the DeviceDCOP dims do not
    determine."""
    _serve_supported(compiled)
    return (_serve_ell(compiled).spans,)


def msg_per_cycle(compiled: CompiledDCOP):
    """Two messages per factor-graph edge per cycle, each of size 2*D (the
    reference's MaxSumMessage.size)."""
    mc = 2 * compiled.n_edges
    return mc, mc * 2 * compiled.max_domain


def batch_plan(compiled: CompiledDCOP, dev: DeviceDCOP, params: Dict):
    """The serving layer's plan: the ELL init and step on the class-padded
    layout, constants padded to the bucket's shapes.  The same math as
    the solo ELL solve slot for slot (class pads are dead slots, like
    ``build_ell``'s degree padding)."""
    from ..serve.batch import BatchPlan

    _serve_supported(compiled)
    ell = _serve_ell(compiled)
    start_mode = params["start_messages"]
    wavefront = start_mode != "all"
    device = dev.unary.device

    def build():
        if wavefront:
            act = _ell_activation(compiled, ell, start_mode, device,
                                  "serve_ell_act")
        else:
            act = (torch.zeros(1, dtype=torch.int32, device=device),) * 2
        pos = np.zeros(dev.n_vars, dtype=np.int64)
        pos[:len(ell.pos_of_var)] = ell.pos_of_var

        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        return act + (
            torch.as_tensor(ell.pair_perm, device=device),  # int32: kernel
            torch.as_tensor(ell.tabs_t, device=device),
            idx(pos),
            torch.as_tensor(ell.edge_valid_t, device=device),
            torch.as_tensor(ell.valid_ell_t, device=device),
            torch.as_tensor(ell.dsize_edges, device=device),
            torch.as_tensor(ell.real_row, device=device),
            idx(ell.var_perm),
        )

    consts = cached_const(
        compiled, ("serve_ell_consts", start_mode, dev.n_vars, str(device)),
        build,
    )
    precision = params["precision"]
    return BatchPlan(
        init=_make_init("ell", precision),
        step=_make_step(
            params["damping"],
            params["damping_nodes"] in ("vars", "both"),
            params["damping_nodes"] in ("factors", "both"),
            wavefront, "ell", ell.spans, precision, fma_damping=True,
        ),
        extract=extract_values,
        consts=consts,
        convergence=(
            _make_convergence(params["stability"])
            if not params["stop_cycle"] else None
        ),
        same_count=SAME_COUNT,
        noise=float(params["noise"]),
        return_final=False,  # anytime best, as the solo solve
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
    """Solve ``compiled`` with MaxSum on ``device`` (the card unless the
    caller asks for the CPU).  Reports the best assignment seen across
    cycles and the cycles actually run; ``status`` is ``"TIMEOUT"`` when
    ``timeout`` (seconds) ran out first."""
    params = prepare_algo_params(params or {}, algo_params)
    device = resolve_device(device)
    if params["stop_cycle"]:
        n_cycles = params["stop_cycle"]
    damping = params["damping"]
    damp_vars = params["damping_nodes"] in ("vars", "both")
    damp_factors = params["damping_nodes"] in ("factors", "both")
    start_mode = params["start_messages"]
    wavefront = start_mode != "all"
    layout = resolve_layout(compiled, params["layout"])

    dev = device_problem(
        compiled, device, "maxsum", params, n_cycles, collect_curve
    )
    inert = cached_const(
        compiled, ("inert_act", str(device)),
        lambda: torch.zeros(1, dtype=torch.int32, device=device),
    )
    if layout == "ell":
        ell = cached_const(
            compiled, ("ell_host",), lambda: build_ell(compiled)
        )
        if wavefront:
            act_v, act_f = _ell_activation(compiled, ell, start_mode, device)
        else:
            act_v = act_f = inert
        consts = (act_v, act_f) + _ell_dev_arrays(compiled, ell, device)
        spans = ell.spans
    else:
        if wavefront:
            act_v, act_f = _edge_activation(compiled, start_mode, device)
        else:
            act_v = act_f = inert
        consts = (act_v, act_f)
        if layout == "lanes":
            consts += (
                cached_const(
                    compiled, ("lanes_aux", str(device)),
                    lambda: lanes_aux(dev),
                ),
            )
        spans = ()
    precision = params["precision"]
    init = _make_init(layout, precision)
    step = _make_step(
        damping, damp_vars, damp_factors, wavefront, layout, spans,
        precision, fma_damping=True,
    )

    values, curve, extras = run_cycles(
        compiled, dev, init, step, extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        consts=consts,
        noise=params["noise"],
        # report the best assignment seen across cycles: BP oscillates
        return_final=False,
        # early exit once messages are stable for SAME_COUNT cycles (the
        # reference's approx_match termination), unless stop_cycle is set
        convergence=(
            _make_convergence(params["stability"])
            if not params["stop_cycle"]
            else None
        ),
        same_count=SAME_COUNT,
        health=health,
        carry_io=carry_io,
    )
    cycles = extras["cycles"]
    # 2 messages per edge per cycle (var->factor and factor->var), size = 2*D
    msg_count = 2 * compiled.n_edges * cycles
    msg_size = msg_count * 2 * compiled.max_domain
    return finalize(
        compiled, values, cycles, msg_count, msg_size, curve,
        status="TIMEOUT" if extras["timed_out"] else "FINISHED",
    )
