"""MGM-2 (coordinated 2-variable moves), batched.

Counterpart of ``pydcop_tpu/algorithms/mgm2.py``: per cycle each variable
is an offerer with probability ``threshold``; offerers propose a
coordinated move over a shared constraint to ONE random neighbour;
non-offerers accept the best strictly positive offer; committed pairs
then compete with their neighbourhoods on the coordinated gain (both
partners must clear theirs, partner excluded); everyone else behaves
like MGM on its solo gain.  ``favor`` biases ties between unilateral and
coordinated moves.  Monotone like MGM.

The reference's five-phase message machine (Value/Offer/Response/Gain/Go)
is five functions of tensors composed into one step: offers are rows of a
directed offer-edge array sorted by source, offer selection and
acceptance are segment maxima (the destination side through the static
``pair_by_dst`` order), and the coordinated-gain matrix of every
offer edge comes from ``local_costs`` and the pairs' ``[D, D]`` tables.
Pairs that share a constraint of arity >= 3 coordinate too, over that
table sliced at the other scope variables' current values each cycle
(the ``dyn_*`` arrays of ``_offer_structure``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    local_costs,
    masked_argmin,
    resolve_device,
    segment_max,
    segment_offsets,
    segment_sum,
    take_rows,
)
from ..random import split, uniform
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from .base import (
    CarryIO,
    _flatten,
    _jax_dtype,
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

HEADER_SIZE = 100
UNIT_SIZE = 5

algo_params = [
    AlgoParameterDef("threshold", "float", None, 0.5),
    AlgoParameterDef(
        "favor", "str", ["unilateral", "no", "coordinated"], "unilateral"
    ),
    AlgoParameterDef("stop_cycle", "int", None, 0),
]

FAVOR_EPS = 1e-6


class Mgm2State(NamedTuple):
    values: torch.Tensor  # [n_vars]
    neigh_src: torch.Tensor  # [n_pairs] sorted
    neigh_dst: torch.Tensor  # [n_pairs]
    # directed offer edges (both orientations of each pair): src offers
    # to dst over pair_tables[k]; sorted by pair_src
    pair_src: torch.Tensor  # [n_off]
    pair_dst: torch.Tensor  # [n_off]
    pair_tables: torch.Tensor  # [n_off, D, D] (src value, dst value)
    pair_by_dst: torch.Tensor  # [n_off] argsort of pair_dst
    pair_dst_sorted: torch.Tensor  # [n_off] pair_dst[pair_by_dst]
    # per-cycle slices of arity >= 3 tables: entry e adds
    # dyn_flat[dyn_base[e] + sum_k values[dyn_other_ids[e, k]] *
    # dyn_other_strides[e, k] + x * stride_src[e] + y * stride_dst[e]]
    # into pair_tables[dyn_edge[e]]
    dyn_flat: torch.Tensor
    dyn_offsets: torch.Tensor  # [n_off + 1] segments of the sorted dyn_edge
    dyn_base: torch.Tensor  # [n_dyn]
    dyn_other_ids: torch.Tensor  # [n_dyn, K]
    dyn_other_strides: torch.Tensor  # [n_dyn, K]
    dyn_stride_src: torch.Tensor  # [n_dyn]
    dyn_stride_dst: torch.Tensor  # [n_dyn]


#: the health hook (``telemetry/pulse.py``): the local-search family's
#: largest and mean available gain
health = gain_health


def _save_leaves(state: Mgm2State, consts) -> List[torch.Tensor]:
    """JAX's ``Mgm2State`` leaves: the port keeps the segment bounds of
    the sorted ``dyn_edge`` where JAX keeps ``dyn_edge`` itself (int32,
    each offer edge's id repeated over its segment)."""
    counts = state.dyn_offsets[1:] - state.dyn_offsets[:-1]
    dyn_edge = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts
    )
    return [
        _jax_dtype(dyn_edge if name == "dyn_offsets" else x)
        for name in state._fields
        for x in _flatten(getattr(state, name), [])
    ]


#: the checkpoint form: only ``values`` moves, the offer structure is
#: rebuilt from the problem
carry_io = CarryIO(_save_leaves, field_io("values").load)


def _segment_pick(score, valid, seg, n_segments):
    """One winner per segment: the valid row with max score, as a bool
    mask with at most one True per segment (scores distinct within a
    segment, e.g. iid uniforms)."""
    m = segment_max(torch.where(valid, score, -torch.inf), seg, n_segments)
    return valid & (score >= m[seg]) & torch.isfinite(score)


def _dst_segment_max(values, state: Mgm2State, n_segments):
    """Max of per-offer-edge ``values`` grouped by destination variable,
    through the static destination order."""
    return segment_max(
        values[state.pair_by_dst], state.pair_dst_sorted, n_segments
    )


# The five protocol phases of one MGM-2 cycle.

MGM2_PHASES = ("value", "offer", "response", "gain", "go")


def _phase_value(dev: DeviceDCOP, values):
    """Value phase: everyone's local cost landscape under the current
    assignment: per-candidate costs, current cost, best unilateral gain
    and its candidate value."""
    costs = local_costs(dev, values)  # [n_vars, D]
    current = take_rows(costs, values[:, None])[:, 0]
    masked = torch.where(dev.valid_mask, costs, torch.inf)
    solo_gain = current - torch.amin(masked, dim=-1)
    solo_cand = masked_argmin(costs, dev.valid_mask)
    return costs, current, solo_gain, solo_cand


def _phase_offer(
    dev: DeviceDCOP, state: Mgm2State, k_role, k_offer, costs, current,
    threshold: float, has_dyn: bool,
):
    """Offer phase: role draw, one proposed edge per offerer, and the
    coordinated-gain matrix of every directed offer edge."""
    values = state.values
    src, dst, T = state.pair_src, state.pair_dst, state.pair_tables
    n_off, d = T.shape[0], T.shape[1]
    if has_dyn:
        # effective tables of the higher-arity shared constraints, sliced
        # at the other scope variables' current values: one [n_dyn, D, D]
        # gather and a sorted segment sum into the static pair tables
        base = state.dyn_base + (
            values.long()[state.dyn_other_ids] * state.dyn_other_strides
        ).sum(dim=1)
        ar = torch.arange(d, device=T.device)
        idx = (
            base[:, None, None]
            + ar[None, :, None] * state.dyn_stride_src[:, None, None]
            + ar[None, None, :] * state.dyn_stride_dst[:, None, None]
        )
        T = T + segment_sum(state.dyn_flat[idx], state.dyn_offsets, 0)
    offerer = uniform(k_role, (dev.n_vars,)) < threshold
    # each offerer proposes over ONE random incident edge
    offer_score = uniform(k_offer, (n_off,))
    chosen = _segment_pick(
        offer_score, offerer[src] & ~offerer[dst], src, dev.n_vars
    )

    # coordinated-gain matrix for every directed edge:
    # new(x,y) = L_src(x) + L_dst(y) - T(x, yd) - T(xs, y) + T(x, y)
    # old      = L_src(xs) + L_dst(yd) - T(xs, yd)
    xs, yd = values.long()[src], values.long()[dst]
    t_x_yd = take_rows(T, yd[:, None, None].expand(-1, d, 1))[:, :, 0]
    t_xs_y = T[torch.arange(n_off, device=T.device), xs]  # [n_off, D]
    new = (
        costs[src][:, :, None]
        + costs[dst][:, None, :]
        - t_x_yd[:, :, None]
        - t_xs_y[:, None, :]
        + T
    )
    pair_valid = (
        dev.valid_mask[src][:, :, None] & dev.valid_mask[dst][:, None, :]
    )
    new = torch.where(pair_valid, new, torch.inf)
    t_xs_yd = take_rows(t_x_yd, xs[:, None])[:, 0]
    old = current[src] + current[dst] - t_xs_yd
    flat = new.reshape(n_off, -1)
    best_idx = torch.argmin(flat, dim=1)
    offer_gain = old - torch.amin(flat, dim=1)
    off_x = (best_idx // T.shape[2]).to(torch.int32)
    off_y = (best_idx % T.shape[2]).to(torch.int32)
    return chosen, offer_gain, off_x, off_y


def _phase_response(
    dev: DeviceDCOP, state: Mgm2State, k_accept, chosen, offer_gain,
    off_x, off_y, solo_gain,
):
    """Response phase: each receiver accepts the best strictly positive
    offered gain; accepted pairs commit (partner id, coordinated values,
    coordinated gain) through sorted segment maxima."""
    n_vars = dev.n_vars
    values = state.values
    src, dst = state.pair_src, state.pair_dst
    # two-stage pick (max gain, then an iid-uniform tiebreak): jitter
    # added to the gain itself would vanish in float32
    offer_ok = chosen & (offer_gain > 1e-9)
    gain_max = _dst_segment_max(
        torch.where(offer_ok, offer_gain, -torch.inf), state, n_vars
    )
    at_max = offer_ok & (offer_gain >= gain_max[dst])
    accept_score = uniform(k_accept, (src.shape[0],))
    accept_max = _dst_segment_max(
        torch.where(at_max, accept_score, -torch.inf), state, n_vars
    )
    accepted = (
        at_max
        & (accept_score >= accept_max[dst])
        & torch.isfinite(accept_score)
    )

    # accepted edges are at most one per src AND per dst, so each
    # variable's commitment is a pair of segment maxima; integers reduce
    # as int32, as in JAX (a variable with no edge reads INT32_MIN)
    def _commit(src_val, dst_val, neutral):
        per_src = segment_max(
            torch.where(accepted, src_val, neutral), src, n_vars
        )
        per_dst = _dst_segment_max(
            torch.where(accepted, dst_val, neutral), state, n_vars
        )
        return torch.maximum(per_src, per_dst)

    partner = _commit(dst.to(torch.int32), src.to(torch.int32), -1)
    pair_val = _commit(off_x, off_y, -1)
    pair_val = torch.where(pair_val >= 0, pair_val, values)
    pair_gain_v = torch.clamp(
        _commit(offer_gain, offer_gain, 0.0), min=0.0
    ).to(solo_gain.dtype)
    return partner, pair_val, pair_gain_v


def _phase_gain(
    dev: DeviceDCOP, state: Mgm2State, k_tb, solo_gain, pair_gain_v,
    partner, favor: str,
):
    """Gain phase: announce (the coordinated gain for committed pairs, the
    solo gain otherwise) and find the strict neighbourhood winners, the
    committed partner excluded."""
    committed = partner >= 0
    # favor biases coordinated-vs-unilateral ties
    bias = {"unilateral": -FAVOR_EPS, "coordinated": FAVOR_EPS, "no": 0.0}[
        favor
    ]
    announced = torch.where(committed, pair_gain_v + bias, solo_gain)
    tiebreak = uniform(k_tb, (dev.n_vars,))
    contrib = announced[state.neigh_dst]
    is_partner_edge = state.neigh_dst == partner[state.neigh_src]
    contrib = torch.where(is_partner_edge, -torch.inf, contrib)
    n_max = segment_max(contrib, state.neigh_src, dev.n_vars)
    tb_contrib = torch.where(
        is_partner_edge | (contrib < n_max[state.neigh_src] - 1e-9),
        -torch.inf,
        tiebreak[state.neigh_dst],
    )
    n_tb = segment_max(tb_contrib, state.neigh_src, dev.n_vars)
    win = (announced > n_max + 1e-9) | (
        (announced >= n_max - 1e-9) & (tiebreak > n_tb)
    )
    return committed, win


def _phase_go(values, committed, win, partner, pair_val, solo_gain,
              solo_cand):
    """Go phase: winners move; coordinated pairs only when BOTH partners
    cleared their neighbourhoods, everyone else like MGM on a strictly
    positive solo gain."""
    safe_partner = torch.clamp(partner, min=0).long()
    pair_go = committed & win & win[safe_partner]
    solo_go = ~committed & win & (solo_gain > 1e-9)
    return torch.where(
        pair_go, pair_val, torch.where(solo_go, solo_cand, values)
    )


@functools.lru_cache(maxsize=None)
def _make_step(threshold: float, favor: str, has_pairs: bool,
               has_dyn: bool = False):
    def step(dev: DeviceDCOP, state: Mgm2State, key, *consts) -> Mgm2State:
        k_role, k_offer, k_accept, k_tb = split(key, 4)
        values = state.values
        costs, current, solo_gain, solo_cand = _phase_value(dev, values)

        partner = torch.full(
            (dev.n_vars,), -1, dtype=torch.int32, device=values.device
        )
        pair_val = values
        pair_gain_v = torch.zeros_like(solo_gain)

        if has_pairs:
            chosen, offer_gain, off_x, off_y = _phase_offer(
                dev, state, k_role, k_offer, costs, current,
                threshold, has_dyn,
            )
            partner, pair_val, pair_gain_v = _phase_response(
                dev, state, k_accept, chosen, offer_gain, off_x, off_y,
                solo_gain,
            )

        committed, win = _phase_gain(
            dev, state, k_tb, solo_gain, pair_gain_v, partner, favor
        )
        values = _phase_go(
            values, committed, win, partner, pair_val, solo_gain,
            solo_cand,
        )
        return state._replace(values=values)

    return step


def _init(dev: DeviceDCOP, key, *consts) -> Mgm2State:
    return Mgm2State(random_init_values(dev, key), *consts)


def _offer_structure(compiled: CompiledDCOP, max_domain: int):
    """Directed (src, dst, table) offer-edge arrays for coordinated moves,
    over EVERY shared constraint, as host numpy arrays equal to the JAX
    package's (the same numpy calls in the same order).

    Static part: pairs linked by binary constraints get one offer edge per
    direction whose [D, D] table is the SUM of all parallel binary
    constraints, so the coordinated-gain formula corrects the double count
    of every shared binary constraint at once.

    Dynamic part: pairs that co-occur in an arity >= 3 constraint
    coordinate over that constraint's table sliced at the other scope
    variables' current values, which changes every cycle; per (constraint
    occurrence, directed pair) entry this precomputes the flat base
    offset, the other variables' ids and strides, and the src/dst strides.
    Entries where the src or dst variable appears elsewhere in the same
    scope are skipped (the slice could not hold that duplicate fixed).

    Returns 12 arrays: 5 static-edge (src, dst, tables, by_dst,
    dst_sorted) + 7 dynamic-slice (flat, edge, base, other_ids,
    other_strides, stride_src, stride_dst)."""
    d = max_domain
    f = compiled.float_dtype

    # --- static binary part: unordered pair -> summed lo->hi table
    pair_table: Dict = {}
    binary = [b for b in compiled.buckets if b.arity == 2]
    if binary:
        b = binary[0]
        s0, s1 = b.var_slots[:, 0], b.var_slots[:, 1]
        keep = s0 != s1
        flip = (s0 > s1) & keep
        lo = np.where(flip, s1, s0)[keep]
        hi = np.where(flip, s0, s1)[keep]
        t = np.where(
            flip[keep, None, None], np.swapaxes(b.tables[keep], 1, 2),
            b.tables[keep],
        )
        for k in range(len(lo)):
            key = (int(lo[k]), int(hi[k]))
            if key in pair_table:
                pair_table[key] = pair_table[key] + t[k]
            else:
                pair_table[key] = t[k].astype(np.float64)

    # --- dynamic higher-arity part: per (occurrence, unordered pair)
    # entry metadata against a concatenation of the arity >= 3 buckets'
    # flat tables
    flat_parts = []
    flat_offset = 0
    entries: List = []  # (lo, hi, base, o_ids, o_strides, s_lo, s_hi)
    for hb in compiled.buckets:
        if hb.arity < 3:
            continue
        a = hb.arity
        strides = [d ** (a - 1 - p) for p in range(a)]
        per_con = d ** a
        for row in range(hb.n_constraints):
            slots = [int(v) for v in hb.var_slots[row]]
            base = flat_offset + row * per_con
            for pi in range(a):
                for pj in range(pi + 1, a):
                    i, j = slots[pi], slots[pj]
                    if i == j:
                        continue
                    others = [p for p in range(a) if p not in (pi, pj)]
                    if any(slots[p] in (i, j) for p in others):
                        continue  # duplicate of src/dst in scope: skip
                    (p_lo, p_hi) = (pi, pj) if i < j else (pj, pi)
                    entries.append((
                        min(i, j), max(i, j), base,
                        [slots[p] for p in others],
                        [strides[p] for p in others],
                        strides[p_lo], strides[p_hi],
                    ))
        flat_parts.append(np.asarray(hb.tables, dtype=f).reshape(-1))
        flat_offset += hb.n_constraints * per_con

    all_pairs = sorted(set(pair_table) | {(e[0], e[1]) for e in entries})
    if not all_pairs:
        z = np.zeros(0, dtype=np.int32)
        return (
            z, z, np.zeros((0, d, d), dtype=f), z, z,
            np.zeros(0, dtype=f), z, z,
            np.zeros((0, 1), dtype=np.int32),
            np.zeros((0, 1), dtype=np.int32), z, z,
        )
    pair_idx = {p: k for k, p in enumerate(all_pairs)}
    n_p = len(all_pairs)
    combined = np.zeros((n_p, d, d), dtype=np.float64)
    for p, tbl in pair_table.items():
        combined[pair_idx[p]] = tbl

    # directed edges: lo->hi at k, hi->lo at n_p + k, then src-sorted
    pl = np.array([p[0] for p in all_pairs], dtype=np.int64)
    ph = np.array([p[1] for p in all_pairs], dtype=np.int64)
    src = np.concatenate([pl, ph])
    dst = np.concatenate([ph, pl])
    tables = np.concatenate([combined, np.swapaxes(combined, 1, 2)])
    order = np.argsort(src, kind="stable")
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(len(order))
    src, dst, tables = src[order], dst[order], tables[order]
    by_dst = np.argsort(dst, kind="stable")

    # dynamic entries, one per direction, mapped to post-sort edge ids
    n_k = max((len(e[3]) for e in entries), default=0)
    n_e = 2 * len(entries)
    dyn_edge = np.zeros(n_e, dtype=np.int64)
    dyn_base = np.zeros(n_e, dtype=np.int64)
    dyn_o_ids = np.zeros((n_e, max(n_k, 1)), dtype=np.int64)
    dyn_o_str = np.zeros((n_e, max(n_k, 1)), dtype=np.int64)
    dyn_s_src = np.zeros(n_e, dtype=np.int64)
    dyn_s_dst = np.zeros(n_e, dtype=np.int64)
    for m, (i_lo, i_hi, base, o_ids, o_str, s_lo, s_hi) in enumerate(
        entries
    ):
        k = pair_idx[(i_lo, i_hi)]
        for w, (old_edge, s_s, s_d) in enumerate(
            ((k, s_lo, s_hi), (n_p + k, s_hi, s_lo))
        ):
            e = 2 * m + w
            dyn_edge[e] = inv_order[old_edge]
            dyn_base[e] = base
            dyn_o_ids[e, : len(o_ids)] = o_ids
            dyn_o_str[e, : len(o_str)] = o_str
            dyn_s_src[e] = s_s
            dyn_s_dst[e] = s_d
    eorder = np.argsort(dyn_edge, kind="stable")  # sorted segment sum
    dyn_flat = (
        np.concatenate(flat_parts) if flat_parts
        else np.zeros(0, dtype=f)
    )
    return (
        src.astype(np.int32),
        dst.astype(np.int32),
        tables.astype(f),
        by_dst.astype(np.int32),
        dst[by_dst].astype(np.int32),
        dyn_flat.astype(f),
        dyn_edge[eorder].astype(np.int32),
        dyn_base[eorder].astype(np.int32),
        dyn_o_ids[eorder].astype(np.int32),
        dyn_o_str[eorder].astype(np.int32),
        dyn_s_src[eorder].astype(np.int32),
        dyn_s_dst[eorder].astype(np.int32),
    )


def _offers_cached(compiled: CompiledDCOP, max_domain: int):
    return cached_const(
        compiled, ("mgm2_offers", max_domain, str(compiled.float_dtype)),
        lambda: _offer_structure(compiled, max_domain),
    )


def _padded_offers(compiled: CompiledDCOP, dev: DeviceDCOP, n_off_p: int):
    """The 12 offer-structure arrays with the directed offer-edge axis
    padded to ``n_off_p`` rows (host arrays): pad edges are (dead, dead)
    self-pairs on the first row past the real variables of a row-padded
    ``dev``, with all-zero tables, appended at the END so the src-sorted
    and dst-sorted orders both hold.  A dead offerer is never ``chosen``
    (its src and dst share one role draw), so pads are inert through
    every phase."""

    def build():
        offers = _offers_cached(compiled, dev.max_domain)
        src = offers[0]
        n_off = len(src)
        pad = n_off_p - n_off
        if pad < 0:
            raise ValueError(
                f"offer target {n_off_p} below real count {n_off}"
            )
        if pad == 0:
            return offers
        dead = np.int32(compiled.n_vars)
        dst, tables, by_dst = offers[1], offers[2], offers[3]
        src_p = np.concatenate([src, np.full(pad, dead, src.dtype)])
        dst_p = np.concatenate([dst, np.full(pad, dead, dst.dtype)])
        tables_p = np.concatenate(
            [tables, np.zeros((pad,) + tables.shape[1:], tables.dtype)]
        )
        by_dst_p = np.concatenate(
            [by_dst, n_off + np.arange(pad, dtype=by_dst.dtype)]
        )
        return (
            src_p, dst_p, tables_p, by_dst_p, dst_p[by_dst_p],
        ) + tuple(offers[5:])

    return cached_const(
        compiled, ("mgm2_padded_offers", n_off_p, dev.n_vars), build
    )


def _offers_dev(compiled: CompiledDCOP, dev: DeviceDCOP, n_off_p=None):
    """The offer structure as the step's tensors on ``dev``'s device, in
    ``Mgm2State`` order after the neighbour pairs: index arrays as int64,
    and the segment bounds of the sorted ``dyn_edge`` in its place.  With
    ``n_off_p``, the offer edges padded to that count (``_padded_offers``;
    the serving layer's buckets)."""
    device = dev.unary.device

    def build():
        (src, dst, tables, by_dst, dst_sorted, flat, edge, base, o_ids,
         o_str, s_src, s_dst) = (
            _offers_cached(compiled, dev.max_domain) if n_off_p is None
            else _padded_offers(compiled, dev, n_off_p)
        )

        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        return (
            idx(src), idx(dst), torch.as_tensor(tables, device=device),
            idx(by_dst), idx(dst_sorted),
            torch.as_tensor(flat, device=device),
            idx(segment_offsets(edge, len(src))),
            idx(base), idx(o_ids), idx(o_str), idx(s_src), idx(s_dst),
        )

    return cached_const(
        compiled,
        ("mgm2_offers_dev", dev.max_domain, str(device), n_off_p,
         dev.n_vars if n_off_p is not None else None),
        build,
    )


def bucket_extra(compiled: CompiledDCOP, params: Dict) -> tuple:
    """The serving layer's bucket-key component: the padded neighbour-pair
    and directed offer-edge counts.  Higher-arity offer structures (the
    per-cycle table slices) are shaped by the problem, so those problems
    are not batched: ``ServeUnsupported``."""
    from ..serve.batch import ServeUnsupported
    from ..serve.bucket import pow2

    if any(b.arity > 2 for b in compiled.buckets):
        raise ServeUnsupported(
            "mgm2 batch serving supports binary constraints only (the "
            "higher-arity offer slices are shaped by the problem): serve "
            "this problem sequentially"
        )
    src, _dst = compiled.neighbor_pairs()
    n_off = int(_offers_cached(compiled, compiled.max_domain)[0].shape[0])
    return (pow2(max(len(src), 1)), pow2(n_off) if n_off else 0)


def msg_per_cycle(compiled: CompiledDCOP):
    """Five protocol phases per directed neighbour pair per cycle."""
    src, _dst = compiled.neighbor_pairs()
    return 5 * int(len(src)), 5 * int(len(src)) * UNIT_SIZE


def batch_plan(compiled: CompiledDCOP, dev: DeviceDCOP, params: Dict):
    """The serving layer's plan: the five-phase step with the neighbour
    pairs and offer edges padded to the bucket's counts (the real counts
    on an unpadded ``dev``, see ``mgm.serve_pair_count``)."""
    from ..serve.batch import BatchPlan
    from .mgm import padded_neighbor_pairs, serve_pair_count

    n_pairs_p, n_off_p = bucket_extra(compiled, params)
    n_off = int(_offers_cached(compiled, dev.max_domain)[0].shape[0])
    neigh = padded_neighbor_pairs(
        compiled, serve_pair_count(compiled, dev, n_pairs_p), dev
    )
    padded = n_off_p and dev.n_vars > compiled.n_vars and n_off_p > n_off
    offers = _offers_dev(compiled, dev, n_off_p if padded else None)
    return BatchPlan(
        init=_init,
        step=_make_step(params["threshold"], params["favor"],
                        bool(n_off_p), False),
        extract=extract_values,
        consts=neigh + offers,
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
    """Solve ``compiled`` with MGM-2 on ``device`` (the card unless the
    caller asks for the CPU); reports the final assignment (monotone)."""
    params = prepare_algo_params(params or {}, algo_params)
    if params["stop_cycle"]:
        n_cycles = params["stop_cycle"]
    device = resolve_device(device)
    dev = device_problem(
        compiled, device, "mgm2", params, n_cycles, collect_curve
    )
    neigh = neighbor_pairs_dev(compiled, device)
    offers = _offers_dev(compiled, dev)
    has_pairs = bool(offers[0].shape[0])
    has_dyn = bool(offers[7].shape[0])
    values, curve, extras = run_cycles(
        compiled, dev, _init,
        _make_step(params["threshold"], params["favor"], has_pairs, has_dyn),
        extract_values,
        n_cycles=n_cycles,
        seed=seed,
        collect_curve=collect_curve,
        timeout=timeout,
        return_final=True,  # monotone
        health=health,
        carry_io=carry_io,
        consts=neigh + offers,
    )
    cycles = extras["cycles"]
    # 5 protocol phases per cycle (value/offer/response/gain/go)
    msg_count = 5 * int(neigh[0].shape[0]) * cycles
    return finalize(
        compiled, values, cycles, msg_count, msg_count * UNIT_SIZE, curve,
        status="TIMEOUT" if extras["timed_out"] else "FINISHED",
    )
