"""GDBA: Generalized Distributed Breakout (optimization), batched.

Counterpart of ``pydcop_tpu/algorithms/gdba.py`` ('Distributed Breakout
Algorithm: Beyond Satisfaction', Okamoto, Zivan and Nahon 2016): 2-phase
ok?/improve cycles over effective costs, each the base cost combined with
a per-(variable, constraint, assignment) modifier:

- ``modifier`` 'A' (additive, base 0) or 'M' (multiplicative, base 1);
- ``violation`` 'NZ' (cost != 0), 'NM' (cost != the table's minimum),
  'MX' (cost == the table's maximum);
- ``increase_mode`` 'E' (the current entry), 'R' (the own variable's
  row), 'C' (the others' column at the own current value), 'T' (the whole
  table).

A variable moves when it holds the best positive improvement in its
neighbourhood (ties to the lowest variable id); when nobody in its
neighbourhood can improve it bumps the modifiers of its violated
constraints.  Unary costs count once, and the 'C' mode bumps every
combination of the other variables with the own value fixed, as in the
JAX package.

Modifiers are dense float32 tensors shaped like the constraint tables,
one per (constraint, slot) edge: ``[n_c, arity, D**arity]`` per bucket,
growing by exact increments of 1.  Effective costs are one elementwise op
over gathered entries; the increase modes are masked adds on the same
tensors.  Reports the anytime best.  Its ``health`` hook gives the modifier
mass a cycle added (summed in XLA's order) and the largest modifier.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    _flat_index,
    _strides,
    fan_in_onto,
    per_slot_to_edges,
    resolve_device,
    take_rows,
    xla_sum,
)
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from .base import (
    cached_const,
    device_problem,
    extract_values,
    field_io,
    finalize,
    neighbor_pairs_dev,
    run_cycles,
)
from .dba import neighborhood_max
from .dsa import _random_tiebreak_argmin, random_init_values
from .mgm import neighborhood_winner

GRAPH_TYPE = "constraints_hypergraph"

HEADER_SIZE = 100
UNIT_SIZE = 5

algo_params = [
    AlgoParameterDef("modifier", "str", ["A", "M"], "A"),
    AlgoParameterDef("violation", "str", ["NZ", "NM", "MX"], "NZ"),
    AlgoParameterDef("increase_mode", "str", ["E", "R", "C", "T"], "E"),
]


class GdbaState(NamedTuple):
    values: torch.Tensor  # [n_vars]
    modifiers: Tuple[torch.Tensor, ...]  # per bucket [n_c, arity, D**arity]


def health(dev: DeviceDCOP, old_state: GdbaState, new_state: GdbaState):
    """The health hook (``telemetry/pulse.py``): residual = the modifier
    mass added across every bucket this cycle (each bucket's sum in XLA's
    order), aux = the largest modifier magnitude so far."""
    dm = torch.zeros((), dtype=torch.float32, device=dev.unary.device)
    mx = torch.zeros((), dtype=torch.float32, device=dev.unary.device)
    for new_m, old_m in zip(new_state.modifiers, old_state.modifiers):
        dm = dm + xla_sum((new_m - old_m).abs().reshape(-1)).to(
            torch.float32
        )
        mx = torch.maximum(mx, new_m.abs().max().to(torch.float32))
    return torch.stack([dm, mx])


#: the checkpoint form: JAX's state leaves, every one of which moves
carry_io = field_io("values", "modifiers")


def _eff_slot_costs(
    bucket, mod: torch.Tensor, d: int, values: torch.Tensor,
    modifier_mode: str,
) -> torch.Tensor:
    """[n_c, a, D]: effective cost of the bucket's constraints from each
    slot's viewpoint when that slot takes each candidate value (others at
    their current values)."""
    strides = _strides(bucket.arity, d)
    vals = values.long()[bucket.var_slots]  # [n_c, a]
    flat_full = _flat_index(vals, strides)
    cand = torch.arange(d, device=values.device)
    out = []
    for s in range(bucket.arity):
        offset = flat_full - vals[:, s] * strides[s]
        idx = offset[:, None] + cand * strides[s]  # [n_c, D]
        base = take_rows(bucket.tables_flat, idx)
        m = take_rows(mod[:, s, :], idx)
        out.append(base + m if modifier_mode == "A" else base * m)
    return torch.stack(out, dim=1)


def _increase_mask(
    increase_mode: str, vals: torch.Tensor, d: int, flat_len: int
) -> torch.Tensor:
    """[n_c, a, flat] (or broadcastable): the table entries each slot's
    modifier bump covers, for the bucket's current values ``vals``
    ([n_c, a])."""
    n_c, a = vals.shape
    if increase_mode == "T":
        return torch.ones((1, 1, flat_len), dtype=torch.bool,
                          device=vals.device)
    strides = _strides(a, d)
    positions = torch.arange(flat_len, device=vals.device)
    # digit of every flat position along each axis: [a, flat]
    digits = torch.stack([(positions // strides[t]) % d for t in range(a)])
    # match[c, t, flat]: the position agrees with slot t's current value
    match = digits[None, :, :] == vals[:, :, None]
    if increase_mode == "E":
        return match.all(dim=1, keepdim=True).expand(n_c, a, flat_len)
    if increase_mode == "C":  # own slot at its current value, others free
        return match
    # R: own slot free, every other slot at its current value
    rows = []
    for s in range(a):
        others = torch.ones((n_c, flat_len), dtype=torch.bool,
                            device=vals.device)
        for t in range(a):
            if t != s:
                others = others & match[:, t, :]
        rows.append(others)
    return torch.stack(rows, dim=1)


@functools.lru_cache(maxsize=None)
def _make_step(modifier_mode: str, violation_mode: str, increase_mode: str):
    def step(
        dev: DeviceDCOP, state: GdbaState, key,
        neigh_src, neigh_dst, table_min, table_max,
    ) -> GdbaState:
        d = dev.max_domain
        n = dev.n_vars

        # --- effective local evaluation for every candidate value
        blocks = [
            _eff_slot_costs(
                bucket, state.modifiers[bi], d, state.values, modifier_mode
            )
            for bi, bucket in enumerate(dev.buckets)
        ]  # [n_c, a, D] each
        evals = dev.unary
        if blocks:
            evals = fan_in_onto(dev, evals, per_slot_to_edges(dev, blocks))
        eval_cur = take_rows(evals, state.values[:, None])[:, 0]
        masked = torch.where(dev.valid_mask, evals, torch.inf)
        my_improve = eval_cur - torch.amin(masked, dim=-1)
        new_value = _random_tiebreak_argmin(key, evals, dev.valid_mask)

        # --- improve phase: the neighbourhood's winner moves (ties to the
        # lowest variable id)
        win = neighborhood_winner(
            my_improve,
            -torch.arange(n, dtype=evals.dtype, device=evals.device),
            neigh_src, neigh_dst, n,
        )
        can_move = win & (my_improve > 0)
        # nobody in the closed neighbourhood can improve: bump modifiers
        neigh_max = neighborhood_max(my_improve, neigh_src, neigh_dst, n)
        stuck = torch.maximum(my_improve, neigh_max) <= 1e-9

        # --- modifier increases on violated constraints of stuck variables
        new_modifiers: List[torch.Tensor] = []
        for bi, bucket in enumerate(dev.buckets):
            vals = state.values.long()[bucket.var_slots]  # [n_c, a]
            flat_full = _flat_index(vals, _strides(bucket.arity, d))
            base_cur = take_rows(bucket.tables_flat, flat_full[:, None])[:, 0]
            if violation_mode == "NZ":
                violated = base_cur != 0
            elif violation_mode == "NM":
                violated = base_cur != table_min[bi]
            else:  # MX
                violated = base_cur == table_max[bi]
            # this slot's variable is stuck and the constraint violated
            bump_slot = stuck[bucket.var_slots] & violated[:, None]
            mask = _increase_mask(
                increase_mode, vals, d, bucket.tables_flat.shape[1]
            )
            mod = state.modifiers[bi]
            new_modifiers.append(
                mod + (bump_slot[:, :, None] & mask).to(mod.dtype)
            )

        values = torch.where(can_move, new_value, state.values)
        return GdbaState(values, tuple(new_modifiers))

    return step


@functools.lru_cache(maxsize=None)
def _make_init(base: float):
    def init(dev: DeviceDCOP, key, *consts) -> GdbaState:
        mods = tuple(
            torch.full(
                (b.tables_flat.shape[0], b.arity, b.tables_flat.shape[1]),
                base, dtype=dev.unary.dtype, device=dev.unary.device,
            )
            for b in dev.buckets
        )
        return GdbaState(values=random_init_values(dev, key), modifiers=mods)

    return init


def _table_extrema(compiled: CompiledDCOP) -> Tuple[List, List]:
    """Per-bucket table min and max over valid entries (host arrays).

    Padding is excluded by the scope variables' domain sizes, not by
    magnitude: hard entries clamped to BIG must count, or MX never flags
    them.  ``compile_dcop`` negates the tables of a max problem; the
    NM/MX tests compare against the original table's extrema, so the
    roles swap: the original min is minus the negated table's max."""
    d = compiled.max_domain
    table_min, table_max = [], []
    for b in compiled.buckets:
        flat = b.tables.reshape(b.tables.shape[0], -1)
        positions = np.arange(flat.shape[1])
        valid = np.ones_like(flat, dtype=bool)
        for t in range(b.arity):
            stride = d ** (b.arity - 1 - t)
            digit = (positions // stride) % d
            sizes = compiled.domain_size[b.var_slots[:, t]]
            valid &= digit[None, :] < sizes[:, None]
        mins = np.where(valid, flat, np.inf).min(axis=1)
        maxs = np.where(valid, flat, -np.inf).max(axis=1)
        if compiled.objective == "max":
            mins, maxs = maxs, mins
        table_min.append(np.asarray(mins, dtype=compiled.float_dtype))
        table_max.append(np.asarray(maxs, dtype=compiled.float_dtype))
    return table_min, table_max


def _extrema_dev(compiled: CompiledDCOP, device) -> Tuple[Tuple, Tuple]:
    """``_table_extrema`` on ``device``, cached on the compiled problem."""

    def build():
        return tuple(
            tuple(torch.as_tensor(a, device=device) for a in arrays)
            for arrays in _table_extrema(compiled)
        )

    return cached_const(compiled, ("gdba_table_extrema", str(device)), build)


def solve(
    compiled: CompiledDCOP,
    params: Optional[Dict[str, Any]] = None,
    n_cycles: int = 100,
    seed: int = 0,
    collect_curve: bool = False,
    timeout: Optional[float] = None,
    device="cuda",
) -> SolveResult:
    """Solve ``compiled`` with GDBA on ``device`` (the card unless the
    caller asks for the CPU); reports the best assignment seen."""
    params = prepare_algo_params(params or {}, algo_params)
    device = resolve_device(device)
    dev = device_problem(
        compiled, device, "gdba", params, n_cycles, collect_curve
    )
    neigh = neighbor_pairs_dev(compiled, device)
    table_min, table_max = _extrema_dev(compiled, device)
    values, curve, extras = run_cycles(
        compiled, dev,
        _make_init(0.0 if params["modifier"] == "A" else 1.0),
        _make_step(
            params["modifier"], params["violation"], params["increase_mode"]
        ),
        extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        return_final=False,  # anytime best
        health=health,
        carry_io=carry_io,
        consts=(*neigh, table_min, table_max),
    )
    cycles = extras["cycles"]
    # ok? + improve per directed neighbour pair per cycle
    msg_count = 2 * int(neigh[0].shape[0]) * cycles
    return finalize(
        compiled, values, cycles, msg_count,
        msg_count * (UNIT_SIZE + HEADER_SIZE), curve,
        status="TIMEOUT" if extras["timed_out"] else "FINISHED",
    )


# the footprint models the agent runtime's distributions read (the JAX
# package's, host only)


def computation_memory(computation) -> float:
    """GDBA stores one value per neighbor plus modifier tables."""
    return float(len(computation.neighbors)) * UNIT_SIZE


def communication_load(src, target: str) -> float:
    return UNIT_SIZE + HEADER_SIZE
