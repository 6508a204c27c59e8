"""Device memory: the byte model of a solve, the live memory plane and the
guard that refuses a solve that cannot fit.

The port's counterpart of ``pydcop_tpu/telemetry/memplane.py``.  Three
pieces:

- :func:`predict_solve_bytes`: a per-device byte model of one solve of
  the port, from a ``CompiledDCOP`` or a :class:`ProblemShape` alone (the
  ``memplan`` verb needs no card).  ``problem``, ``layout_consts`` and
  ``state`` count the port's own tensors: the ``DeviceDCOP`` (int64 index
  vectors, the fan-in offsets and gather maps), the tensors an algorithm
  passes the engine as constants, and the solver state that is not one of
  them.  ``anytime``, ``pulse``, ``curve`` and ``serve_padding`` count as
  the JAX package counts.  ``workspace`` is what a solve holds on top:
  the engine's carry and intermediates, the memory of its captured CUDA
  graphs, ``xla_tree_sum``'s scratch and ticket pool, as a factor of the
  family's dominant plane measured on the card (``chip_smoke.py``'s
  ``memory`` phase).
- :func:`sample_device_memory`: the live plane, ``mem.*`` gauges read from
  the CUDA caching allocator at solve start and at each readback window
  (host-side queries: no synchronization, no allocation).  A CPU device
  has no such statistics: the sample degrades and counts
  ``mem.stats_unavailable``.
- :data:`memguard`: the guard, checked before a solve uploads anything
  and at serve admission, that refuses with :class:`MemoryBudgetExceeded`
  (predicted bytes against the limit minus a reserve) instead of letting
  ``torch.OutOfMemoryError`` end the solve partway through an upload or a
  graph capture.

Stdlib only at import: the host-only ``memplan`` verb imports it; numpy
and torch are imported inside functions.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

from .metrics import metrics_registry

__all__ = [
    "DEVICE_GENERATIONS",
    "GIB",
    "MemoryBudgetExceeded",
    "ProblemShape",
    "device_generation",
    "device_limit_bytes",
    "hbm_capacity_bytes",
    "last_sample",
    "max_batch_k",
    "max_vars_per_device",
    "measured_peak_bytes",
    "memguard",
    "memory_status",
    "predict_solve_bytes",
    "sample_device_memory",
    "shape_of",
    "synthetic_shape",
]

GIB = 1 << 30

#: NVIDIA cards: (substring of ``torch.cuda.get_device_name``, in lower
#: case; HBM bandwidth in GB/s; HBM capacity in bytes), from NVIDIA's data
#: sheets.  Matched in order, so a longer name comes before its prefix.
#: The limit's fallback where the allocator cannot be asked.
DEVICE_GENERATIONS: Tuple[Tuple[str, float, int], ...] = (
    ("h100 80gb hbm3", 3350.0, 80 * GIB),  # H100 SXM5
    ("h100 nvl", 3900.0, 94 * GIB),
    ("h100 pcie", 2000.0, 80 * GIB),
    ("h200", 4800.0, 141 * GIB),
    ("a100-sxm4-80gb", 2039.0, 80 * GIB),
    ("a100 80gb pcie", 1935.0, 80 * GIB),
    ("a100-sxm4-40gb", 1555.0, 40 * GIB),
    ("a100-pcie-40gb", 1555.0, 40 * GIB),
)


def device_generation(device_kind: str) -> Optional[Tuple[str, float, int]]:
    """The row of :data:`DEVICE_GENERATIONS` matching a device name (the
    row's key in it, as in ``torch.cuda.get_device_name``'s), or a short
    name (in the row's key, as ``h100``: the first such row), or None (a
    CPU, an unlisted card)."""
    kind = str(device_kind).lower()
    for row in DEVICE_GENERATIONS:
        if kind and (row[0] in kind or kind in row[0]):
            return row
    return None


def hbm_capacity_bytes(device_kind: str) -> Optional[int]:
    """The HBM capacity of a device name's card, or None."""
    row = device_generation(device_kind)
    return row[2] if row is not None else None


def _pow2(n: int, floor: int = 1) -> int:
    n = max(int(n), floor)
    return 1 << max(0, n - 1).bit_length()


# --------------------------------------------------------------------------
# problem shapes: the device-free input of the model
# --------------------------------------------------------------------------


class ProblemShape(NamedTuple):
    """The dims the model needs, the JAX package's: extracted from a
    CompiledDCOP (:func:`shape_of`) or made from headline numbers
    (:func:`synthetic_shape`)."""

    n_vars: int
    max_domain: int
    n_edges: int
    n_constraints: int
    float_bytes: int
    #: cost-table bytes (sum over arity buckets of n_c * D**arity * s)
    table_bytes: int
    #: bucket index bytes at 4 bytes an index (var_slots + edge_ids +
    #: con_ids); the port holds them as int64, twice this
    index_bytes: int
    #: ELL padded edge-slot count (pow2 degree classes); 0 = no edges
    ell_n_pad: int


def shape_of(compiled) -> ProblemShape:
    """The exact shape of a CompiledDCOP (host-side numpy only)."""
    import numpy as np

    s = int(np.dtype(compiled.float_dtype).itemsize)
    table_b = index_b = 0
    for b in compiled.buckets:
        n_c = int(b.tables.shape[0])
        width = 1
        for d in b.tables.shape[1:]:
            width *= int(d)
        table_b += n_c * width * s
        # var_slots + edge_ids ([n_c, arity] each) + con_ids ([n_c])
        index_b += n_c * (2 * b.arity + 1) * 4
    deg = np.asarray(compiled.var_degree, dtype=np.int64)
    nz = deg[deg > 0]
    ell_pad = (
        int((2 ** np.ceil(np.log2(nz))).astype(np.int64).sum())
        if nz.size else 0
    )
    return ProblemShape(
        n_vars=int(compiled.n_vars),
        max_domain=int(compiled.max_domain),
        n_edges=max(int(compiled.n_edges), 1),
        n_constraints=max(int(compiled.n_constraints), 1),
        float_bytes=s,
        table_bytes=int(table_b),
        index_bytes=int(index_b),
        ell_n_pad=ell_pad,
    )


def synthetic_shape(
    n_vars: int,
    domain: int,
    degree: float = 4.0,
    arity: int = 2,
    float_bytes: int = 4,
) -> ProblemShape:
    """A shape from headline numbers: ``n_vars`` variables of ``domain``
    values with mean constraint ``degree``; ``n_edges = n_vars * degree``
    and each arity-``a`` constraint has ``a`` edges."""
    n_edges = max(1, int(round(n_vars * degree)))
    n_cons = max(1, n_edges // max(1, arity))
    table_b = n_cons * (domain ** arity) * float_bytes
    index_b = n_cons * (2 * arity + 1) * 4
    # uniform degree: every variable lands in the pow2(degree) class
    ell_pad = n_vars * _pow2(max(1, int(math.ceil(degree))))
    return ProblemShape(
        n_vars=int(n_vars),
        max_domain=int(domain),
        n_edges=n_edges,
        n_constraints=n_cons,
        float_bytes=int(float_bytes),
        table_bytes=int(table_b),
        index_bytes=int(index_b),
        ell_n_pad=int(ell_pad),
    )


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

#: algorithm -> model family.  An unlisted algorithm counts as "local",
#: the smallest family: the guard then refuses too little, not too much.
_FAMILY = {
    "maxsum": "maxsum",
    "amaxsum": "maxsum",
    "maxsum_dynamic": "maxsum",
    "dsa": "local",
    "dsatuto": "local",
    "adsa": "local",
    "mixeddsa": "local",
    "dba": "local",
    "gdba": "gdba",
    "mgm": "local",
    "mgm2": "mgm2",
    "dpop": "dpop",
}

#: What a solve holds beyond its problem, constants, state and anytime
#: carry (the engine's carry and intermediates, its graphs' memory), as a
#: factor of the family's dominant plane: the rise of
#: ``torch.cuda.max_memory_allocated`` over a cold solve, less the exact
#: components, over that plane, the largest of the runs rounded up (a
#: process whose allocator holds large free blocks charges a solve up to
#: a few percent more).  Measured on an H100 at config-4 shapes (config 3
#: for MGM-2, config 5 for DPOP) by ``chip_smoke.py``'s ``memory`` phase,
#: which holds config 6 to the fit.
_WORKSPACE = {
    "maxsum": 3.5,
    "maxsum_ell": 3.8,
    "local": 3.0,
    "gdba": 3.5,
    "mgm2": 4.3,
    "dpop": 0.7,
}

#: telemetry.pulse.HEALTH_WIDTH, kept a plain int so that the model
#: imports nothing of pulse
_HEALTH_WIDTH = 8

#: xla_tree_sum's windows and its ticket pool's least size (int32 tickets,
#: ``compile/hopper_kernels.py``)
_XLA_WINDOW = 32
_TICKET_POOL = 4096

_I64 = 8  # the port's index vectors
_F32 = 4  # the port's float32 problem tensors, whatever ``float_bytes``


def _maxsum_layout(shape: ProblemShape, params: Optional[Dict],
                   compiled=None) -> str:
    """The message layout a MaxSum solve runs: the port's
    ``maxsum.resolve_layout`` (``auto``, ``ell`` and ``ell_pallas`` run
    ELL where it applies, else lanes; ``pallas`` is lanes).  From a shape
    alone, ELL applies where the problem has edges."""
    layout = (params or {}).get("layout", "auto")
    if layout in ("auto", "ell", "ell_pallas"):
        if compiled is not None:
            binary = compiled.n_edges > 0 and all(
                b.arity == 2 for b in compiled.buckets
            )
        else:
            binary = bool(shape.ell_n_pad)
        return "ell" if binary else "lanes"
    return "lanes" if layout == "pallas" else layout


def _tree_scratch_bytes(n: int, rows: int = 1) -> int:
    """Float32 scratch of an ``xla_tree_sum`` launch over ``rows`` rows of
    ``n`` values (two levels of windows or more take scratch)."""
    if n <= _XLA_WINDOW * _XLA_WINDOW:
        return 0
    k2 = -(-(-(-n // _XLA_WINDOW)) // _XLA_WINDOW)
    return rows * (k2 + -(-k2 // _XLA_WINDOW)) * 4


def _neighbor_pairs(compiled, shape: ProblemShape) -> int:
    """Directed neighbour pairs: exact from a compiled problem, else two a
    binary constraint."""
    if compiled is not None:
        return int(len(compiled.neighbor_pairs()[0]))
    return shape.n_edges


def _dpop_util_bytes(compiled, shape: ProblemShape) -> int:
    """DPOP's UTIL hypercube bytes: the live-element estimates of the
    fused wave's batches (the port's planner, ``algorithms/dpop.py``)
    when a compiled problem plans as one wave, else separators of
    width 2."""
    if compiled is not None and compiled.n_vars:
        from ..algorithms.dpop import _plan_fused_wave, _Tree

        plan = _plan_fused_wave(compiled, _Tree(compiled), shape.max_domain)
        if plan is not None:
            return sum(int(desc.est_elems) for desc in plan.descs) * _F32
    return shape.n_vars * (shape.max_domain ** 2) * _F32


def _family_bytes(family: str, algo: str, shape: ProblemShape,
                  params: Optional[Dict], compiled, layout: Optional[str]):
    """(layout_consts, state, dominant plane, workspace key) of a solve:
    the tensors the algorithm passes the engine as constants, and those of
    its state that are not constants."""
    params = params or {}
    s = shape.float_bytes
    V, D, E = shape.n_vars, shape.max_domain, shape.n_edges
    C = shape.n_constraints
    tables = shape.table_bytes // s * _F32
    wavefront = params.get("start_messages", "leafs") != "all"
    values = V * 4  # int32 value indices
    if family == "maxsum":
        ps = 2 if params.get("precision") == "bf16" else 4
        if layout == "ell":
            P = shape.ell_n_pad
            act = 2 * P * 4 if wavefront else 4
            consts = (
                act
                + D * D * P * s      # tabs_t
                + P * 4              # pair_perm (int32)
                + 2 * V * _I64       # pos_of_var, var_perm
                + D * P + D * V      # edge_valid_t, valid_ell_t (bool)
                + P * s + P          # dsize_edges, real_row
            )
            # v2f + f2v [D, P], values, cycle, the noised unary_t [D, V]
            state = 2 * D * P * ps + values + 4 + D * V * _F32
            return consts, state, max(D * D * P * s, 2 * D * P * ps), \
                "maxsum_ell"
        act = 2 * E * 4 if wavefront else 4
        consts = act
        state = 2 * E * D * ps + values + 4
        if layout == "lanes":
            # lanes_aux: tables_t, the int32 edge columns, unary_t,
            # valid_t and two [D, V + 1] offset planes; the state's
            # unary_t is the noised plane
            consts += (
                tables + E * 4 + D * V * _F32 + D * V
                + 2 * D * (V + 1) * _I64
            )
            state += D * V * _F32
        return consts, state, 2 * E * D * ps + tables, "maxsum"
    if family == "mgm2":
        pairs = _neighbor_pairs(compiled, shape)
        # the neighbour pairs, then the offer edges of binary constraints
        # (both orientations of each linked pair): src, dst, by_dst,
        # dst_sorted, the [n_off, D, D] tables and the (empty) per-cycle
        # slices of higher arities
        n_off = pairs
        consts = (
            2 * pairs * _I64 + 4 * n_off * _I64 + n_off * D * D * s
            + (n_off + 1) * _I64
        )
        return consts, values, n_off * D * D * s + tables, "mgm2"
    if family == "gdba":
        pairs = _neighbor_pairs(compiled, shape)
        # neighbour pairs and each constraint's table minimum and maximum;
        # the state's modifiers are [n_c, arity, D**arity] a bucket
        consts = 2 * pairs * _I64 + 2 * C * s
        modifiers = 2 * tables
        return consts, values + modifiers, V * D * _F32 + tables + modifiers, \
            "gdba"
    if family == "dpop":
        util = _dpop_util_bytes(compiled, shape)
        return 0, util, util, "dpop"
    # the local-search family, algorithm by algorithm
    pairs = _neighbor_pairs(compiled, shape)
    consts, state = {
        "dsa": (V * 4 + C * 4, values),
        "adsa": (V * 4 + C * 4, values),
        "mgm": (2 * pairs * _I64, values),
        "dba": (2 * pairs * _I64, values + E * 4 + V * 4 + V),
        "mixeddsa": (C + C * 4, values),
        "dsatuto": (0, values),
    }.get(algo, (0, values * 3))
    return consts, state, V * D * _F32 + tables, "local"


def predict_solve_bytes(
    compiled=None,
    algo: str = "maxsum",
    params: Optional[Dict[str, Any]] = None,
    *,
    shape: Optional[ProblemShape] = None,
    mesh: int = 1,
    batch_k: int = 1,
    n_cycles: int = 64,
    pulse_on: bool = False,
    collect_curve: bool = False,
    serve_bucket: bool = False,
) -> Dict[str, Any]:
    """The per-device byte breakdown of one solve of the port.

    ``compiled`` (a CompiledDCOP: the exact shape, MaxSum's layout rule,
    the neighbour pairs, DPOP's planner) or ``shape`` (a
    :class:`ProblemShape`, planning without a card) must be given.
    ``mesh``: devices the problem's rows split across.  ``batch_k``: the
    serving batch width (per-instance parts multiply, the problem is
    shared).  ``serve_bucket``: round the shape up to its serving bucket
    first, as the serving layer pads a tenant.

    Returns ``{"components": {...}, "total_bytes", "per_device_bytes",
    "dominant", ...}``; components are bytes a device."""
    if shape is None:
        if compiled is None:
            raise ValueError("predict_solve_bytes needs compiled or shape")
        shape = shape_of(compiled)
    pad_delta = 0
    if serve_bucket:
        padded = _bucketed(shape)
        pad_delta = _plane_total(padded, algo, params) - _plane_total(
            shape, algo, params
        )
        shape = padded
        compiled = None  # the bucket's shape, not the problem's
    algo = str(algo)
    family = _FAMILY.get(algo, "local")
    s = shape.float_bytes
    V, D, E = shape.n_vars, shape.max_domain, shape.n_edges
    mesh = max(1, int(mesh))
    batch_k = max(1, int(batch_k))

    # the DeviceDCOP: tables (float32) and int64 bucket indices, unary,
    # valid mask, domain sizes and degrees, the constant, edge_var,
    # edge_con, f2v_perm, the fan-in offsets and the onto gather map with
    # its bounds
    problem = (
        shape.table_bytes // s * _F32 + 2 * shape.index_bytes
        + V * D * _F32 + V * D + 2 * V * _I64 + _F32
        + 3 * E * _I64 + 2 * (V + 1) * _I64 + (V + E) * _I64
    )

    layout = None
    if family == "maxsum":
        layout = _maxsum_layout(shape, params, compiled)
    layout_consts, state, dominant_plane, ws_key = _family_bytes(
        family, algo, shape, params, compiled, layout
    )

    # anytime-best carry and the packed read-back, as the JAX package
    # counts them
    anytime = V * 4 * 4
    n_pad_cycles = max(8, _pow2(max(1, int(n_cycles))))
    pulse_b = (
        (n_pad_cycles * _HEALTH_WIDTH + V) * 4 + V * 4 if pulse_on else 0
    )
    curve_b = n_pad_cycles * s if collect_curve else 0
    # evaluate's sums: the unary entries and each constraint's
    tree_sum = (
        _TICKET_POOL * 4 + _tree_scratch_bytes(V)
        + _tree_scratch_bytes(shape.n_constraints)
    )
    workspace = int(_WORKSPACE[ws_key] * dominant_plane) + tree_sum

    per_instance = state + anytime + pulse_b + curve_b + workspace
    if batch_k > 1:
        # each batched tenant noises its own unary plane
        per_instance += V * D * s
    components = {
        "problem": -(-problem // mesh),
        "layout_consts": layout_consts // mesh,
        "state": (state * batch_k) // mesh,
        "anytime": (anytime * batch_k) // mesh,
        "pulse": pulse_b * batch_k,
        "curve": curve_b * batch_k,
        "workspace": (workspace * batch_k) // mesh,
        "serve_padding": max(0, pad_delta),
        "donation_saved": 0,
    }
    total = sum(v for k, v in components.items() if k != "serve_padding")
    dominant = max(
        (k for k in components if k not in ("serve_padding", "donation_saved")),
        key=lambda k: components[k],
    )
    return {
        "algo": algo,
        "family": family,
        "layout": layout,
        "shape": shape._asdict(),
        "mesh": mesh,
        "batch_k": batch_k,
        "components": components,
        "per_instance_bytes": int(per_instance),
        "total_bytes": int(total),
        "per_device_bytes": int(total),
        "dominant": dominant,
    }


def _plane_total(shape: ProblemShape, algo, params) -> int:
    """The serve-padding delta's helper: the total of an unpadded shape."""
    return predict_solve_bytes(
        None, algo, params, shape=shape, serve_bucket=False
    )["total_bytes"]


def _bucketed(shape: ProblemShape) -> ProblemShape:
    """A shape's serving bucket: every dim pow2-rounded as the serving
    layer pads (variables and constraints keep a dead row)."""
    n_vars = _pow2(shape.n_vars + 1)
    n_cons = _pow2(shape.n_constraints + 1)
    n_edges = _pow2(shape.n_edges)
    scale = n_cons / max(1, shape.n_constraints)
    return shape._replace(
        n_vars=n_vars,
        n_edges=n_edges,
        n_constraints=n_cons,
        table_bytes=int(shape.table_bytes * scale),
        index_bytes=int(shape.index_bytes * scale),
        ell_n_pad=_pow2(shape.ell_n_pad) if shape.ell_n_pad else 0,
    )


# --------------------------------------------------------------------------
# capacity planning (memplan's answers without a card)
# --------------------------------------------------------------------------


def max_vars_per_device(
    algo: str,
    domain: int,
    degree: float,
    limit_bytes: int,
    *,
    reserve_pct: float = 10.0,
    params: Optional[Dict[str, Any]] = None,
    float_bytes: int = 4,
) -> int:
    """The largest ``n_vars`` whose predicted solve fits one device's limit
    minus the reserve, from the model alone."""
    budget = limit_bytes * (1.0 - reserve_pct / 100.0)

    def fits(n: int) -> bool:
        sh = synthetic_shape(n, domain, degree, float_bytes=float_bytes)
        return (
            predict_solve_bytes(None, algo, params, shape=sh)["total_bytes"]
            <= budget
        )

    if not fits(1):
        return 0
    lo, hi = 1, 2
    while fits(hi) and hi < 1 << 40:
        lo, hi = hi, hi * 2
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def max_batch_k(
    algo: str,
    domain: int,
    n_vars: int,
    degree: float,
    limit_bytes: int,
    *,
    reserve_pct: float = 10.0,
    params: Optional[Dict[str, Any]] = None,
    float_bytes: int = 4,
) -> int:
    """The largest serving batch K of the bucket this shape lands in that
    fits the limit minus the reserve (the problem is shared, the
    per-instance parts multiply)."""
    budget = limit_bytes * (1.0 - reserve_pct / 100.0)
    sh = synthetic_shape(n_vars, domain, degree, float_bytes=float_bytes)

    def fits(k: int) -> bool:
        pred = predict_solve_bytes(
            None, algo, params, shape=sh, batch_k=k, serve_bucket=True
        )
        return pred["total_bytes"] <= budget

    if not fits(1):
        return 0
    k = 1
    while fits(k * 2) and k < 1 << 20:
        k *= 2
    while fits(k + 1):
        k += 1
    return k


# --------------------------------------------------------------------------
# the live memory plane
# --------------------------------------------------------------------------

_m_in_use = metrics_registry.gauge(
    "mem.bytes_in_use", "device bytes currently allocated"
)
_m_peak = metrics_registry.gauge(
    "mem.peak_bytes", "peak device bytes allocated this process"
)
_m_limit = metrics_registry.gauge(
    "mem.limit_bytes",
    "device byte limit (the card's total memory, or the device table / "
    "the configured override)",
)
_m_headroom = metrics_registry.gauge(
    "mem.headroom_pct", "free device memory as a percent of the limit"
)
_m_predicted = metrics_registry.gauge(
    "mem.predicted_bytes", "the model's predicted bytes of the last solve"
)
_m_stats_unavailable = metrics_registry.counter(
    "mem.stats_unavailable",
    "device memory reads that degraded (a device without statistics)",
)
_m_refusals = metrics_registry.counter(
    "mem.refusals_total",
    "solves and admissions the memory guard refused",
)

_lock = threading.Lock()
_last: Dict[str, Any] = {}


def _cuda_device(device=None):
    """The CUDA device a sample reads, or None when ``device`` is not on
    the card (or no card is given and none is present)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _total_bytes(index: int) -> int:
    """The total memory of card ``index``; constant, so asked once."""
    import torch

    return int(torch.cuda.mem_get_info(index)[1])


def device_limit_bytes(device=None) -> Optional[int]:
    """The byte budget the guard compares against: the configured
    override, else the card's total memory (``mem_get_info``), else the
    device table's capacity for its name, else None (a CPU: the guard
    cannot refuse, and counts ``mem.stats_unavailable``)."""
    if memguard.limit_bytes is not None:
        return int(memguard.limit_bytes)
    cuda = _cuda_device(device)
    if cuda is None:
        return None
    try:
        return _total_bytes(cuda.index)
    except RuntimeError:
        import torch

        return hbm_capacity_bytes(torch.cuda.get_device_name(cuda.index))


def sample_device_memory(point: str = "solve", device=None
                         ) -> Optional[Dict[str, Any]]:
    """One live sample: the caching allocator's bytes in use and peak on
    ``device`` (default: the current card), host-side counters read with
    no synchronization and no allocation, published as the ``mem.*``
    gauges.  Returns the sample, or None on a device without statistics
    (counted; the limit gauge is still set)."""
    cuda = _cuda_device(device)
    limit = device_limit_bytes(device)
    sample: Dict[str, Any] = {
        "point": point,
        "platform": "gpu" if cuda is not None else "cpu",
        "limit_bytes": limit,
        "bytes_in_use": None,
        "peak_bytes": None,
        "headroom_pct": None,
        "stats_available": cuda is not None,
    }
    if metrics_registry.enabled and limit is not None:
        _m_limit.set(float(limit))
    if cuda is None:
        if metrics_registry.enabled:
            _m_stats_unavailable.inc(api="memory_stats")
        with _lock:
            _last.update(sample)
        return None
    import torch

    in_use = int(torch.cuda.memory_allocated(cuda))
    peak = int(torch.cuda.max_memory_allocated(cuda))
    sample["bytes_in_use"] = in_use
    sample["peak_bytes"] = peak
    if limit:
        sample["headroom_pct"] = 100.0 * (limit - in_use) / limit
    if metrics_registry.enabled:
        _m_in_use.set(float(in_use))
        _m_peak.set(float(peak))
        if sample["headroom_pct"] is not None:
            _m_headroom.set(sample["headroom_pct"])
    with _lock:
        _last.update(sample)
    return sample


def last_sample() -> Dict[str, Any]:
    """The latest live sample (perhaps degraded): what ``/status`` shows,
    without asking the device again."""
    with _lock:
        return dict(_last)


def memory_status() -> Dict[str, Any]:
    """The ``memory`` block of ``/status``: the latest sample, the guard's
    configuration and its refusal count."""
    doc = last_sample()
    doc.update(
        guard={
            "enabled": memguard.enabled,
            "reserve_pct": memguard.reserve_pct,
            "limit_bytes": memguard.limit_bytes,
        },
    )
    snap = metrics_registry.snapshot().get("metrics", {})
    ref = snap.get("mem.refusals_total")
    doc["refusals_total"] = (
        sum(v["value"] for v in ref["values"]) if ref else 0
    )
    return doc


def measured_peak_bytes(device=None) -> Optional[int]:
    """The caching allocator's peak bytes on ``device`` (default: the
    current card) since the process started or its last
    ``torch.cuda.reset_peak_memory_stats``: the measured side of the
    model.  None off the card."""
    cuda = _cuda_device(device)
    if cuda is None:
        return None
    import torch

    return int(torch.cuda.max_memory_allocated(cuda))


# --------------------------------------------------------------------------
# the guard
# --------------------------------------------------------------------------


class MemoryBudgetExceeded(RuntimeError):
    """A solve or admission the guard refused: its predicted bytes exceed
    the device limit minus the reserve.  ``breach`` carries the numbers
    (predicted, limit, reserve, budget, the dominant component and every
    component), which the serving front returns in its 503."""

    def __init__(
        self,
        predicted: int,
        limit: int,
        reserve_pct: float,
        prediction: Dict[str, Any],
        context: str = "solve",
    ):
        self.predicted = int(predicted)
        self.limit = int(limit)
        self.reserve_pct = float(reserve_pct)
        self.prediction = prediction
        self.context = context
        self.dominant = prediction.get("dominant")
        budget = int(limit * (1.0 - reserve_pct / 100.0))
        self.breach = {
            "reason": "memory_budget",
            "context": context,
            "predicted_bytes": self.predicted,
            "limit_bytes": self.limit,
            "reserve_pct": self.reserve_pct,
            "budget_bytes": budget,
            "dominant_component": self.dominant,
            "components": prediction.get("components", {}),
        }
        super().__init__(
            f"memory guard {context} refusal: predicted {self.predicted:,} B "
            f"exceeds device budget {budget:,} B "
            f"(limit {self.limit:,} B minus {reserve_pct:g}% reserve); "
            f"dominant component: {self.dominant} "
            f"({prediction.get('components', {}).get(self.dominant, 0):,} B)"
            " — refusing before the upload instead of a "
            "torch.OutOfMemoryError partway through the solve"
        )


class _MemGuard:
    """The process's guard configuration (the ``memguard`` singleton):
    off by default, one attribute check on the solve path."""

    def __init__(self):
        self.enabled = False
        self.reserve_pct = 10.0
        #: a byte limit in place of the device's (tests, CPU hosts,
        #: operators budgeting below the card)
        self.limit_bytes: Optional[int] = None

    def configure(
        self,
        enabled: Optional[bool] = None,
        reserve_pct: Optional[float] = None,
        limit_bytes: Optional[int] = None,
    ) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if reserve_pct is not None:
            self.reserve_pct = float(reserve_pct)
        if limit_bytes is not None:
            self.limit_bytes = int(limit_bytes)

    def reset(self) -> None:
        self.__init__()

    def check(
        self,
        compiled,
        algo: str,
        params: Optional[Dict[str, Any]] = None,
        *,
        context: str = "solve",
        batch_k: int = 1,
        n_cycles: int = 64,
        mesh: int = 1,
        pulse_on: bool = False,
        collect_curve: bool = False,
        serve_bucket: bool = False,
        device=None,
    ) -> Optional[Dict[str, Any]]:
        """Predict, compare with the limit of ``device`` (default: the
        current card) minus the reserve, and refuse.

        Returns the prediction (also the ``mem.predicted_bytes`` gauge),
        or None with the guard off.  Without a known limit (a CPU and no
        override) it refuses nothing and counts
        ``mem.stats_unavailable``.  Raises :class:`MemoryBudgetExceeded`
        on a breach."""
        if not self.enabled:
            return None
        pred = predict_solve_bytes(
            compiled, algo, params,
            batch_k=batch_k, n_cycles=n_cycles, mesh=mesh,
            pulse_on=pulse_on, collect_curve=collect_curve,
            serve_bucket=serve_bucket,
        )
        if metrics_registry.enabled:
            _m_predicted.set(float(pred["total_bytes"]))
        limit = device_limit_bytes(device)
        if limit is None:
            if metrics_registry.enabled:
                _m_stats_unavailable.inc(api="limit")
            return pred
        budget = limit * (1.0 - self.reserve_pct / 100.0)
        if pred["total_bytes"] > budget:
            _m_refusals.inc(reason=context)
            raise MemoryBudgetExceeded(
                pred["total_bytes"], limit, self.reserve_pct, pred, context
            )
        return pred


memguard = _MemGuard()
