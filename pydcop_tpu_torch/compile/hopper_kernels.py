"""Hand-written Hopper kernels, their plain PyTorch versions and launch counts.

Each kernel here replaces one Pallas TPU kernel of the JAX package
(``pydcop_tpu/compile/pallas_kernels.py``).  Its wrapper runs the plain
PyTorch version for tensors on the CPU, launches the CUDA kernel for
tensors on a card, and raises for anything else; there is no fallback from
a failed build or launch to the plain version.  Each kernel's launches are
counted in its wrapper's ``launches`` attribute, so a run can show that
its path went through the kernel.  A call made while a CUDA graph is
being captured launches nothing: it records one launch into the graph,
which ``capture_tally`` counts, and each replay of that graph adds the
tally to ``launches`` (``count_replay``).

Both kernels share one design for this card (``csrc/grid.cuh``): D is a
template parameter for D = 1..16, so each instantiation is fully unrolled
and starts a slot's loads ahead of its arithmetic, each message value
read once into registers; a thread takes up to four slots a pass, strided
by the grid's width so every stream stays coalesced; the grid is sized to
the card and walks the rest with a grid-stride loop; the read-once
streams are streaming loads, so they leave the scattered gathers' plane
in L2.  D > 16 runs a runtime-D kernel.  Neither falls back to the plain
version, and both give its bits exactly (adds, subtracts and mins in its
order; no fast-math).

``ell_minplus`` (``csrc/ell_minplus.cu``) replaces ``ell_minplus`` at
``pallas_kernels.py:167`` (body ``_ell_kernel``, ``:148``): MaxSum's ELL
factor half-cycle.  It is bound by bytes (65 B per slot at D=3 for 15
adds and mins).  It folds the pair gather, which the TPU path left to XLA
outside its kernel, into the kernel, so the partner plane is never
written and read back.  See the source for the rest of its design.

``factor_arity2_minplus`` (``csrc/factor_arity2_minplus.cu``) replaces
``factor_arity2_minplus`` at ``pallas_kernels.py:83`` (body
``_minplus_kernel``, ``:60``): both outgoing message planes of every
binary factor on the lanes layout.  It is bound by bytes (92 B per
constraint at D=3 for 48 adds, subtracts and mins).  It folds the two
slot gathers ``v2f_t[:, edge_ids[:, s]]``, which the TPU path ran as XLA
gathers outside its kernel, into the kernel, and makes one pass over the
table for both output planes.  See the source for the rest.

``xla_tree_sum`` (``csrc/xla_tree_sum.cu``) is the port's own kernel, not
a TPU kernel's: the float32 sums whose order decides a result, in the
order XLA's CPU compiler gives the JAX package (``xla_tree_levels``; the
plain versions define it).  Each sum site is one launch: ``xla_tree_sum``
(a strided stack of rows; MaxSum's domain sum reads its plane in place),
``tree_evaluate`` (``evaluate``'s gathers, sums and combine) and
``ell_fan_in`` (every degree class of MaxSum's ELL fan-in), all counted
in ``xla_tree_sum.launches``.  Rows over 1,024 values take tickets from a
zeroed pool that each launch leaves at zero (``_tickets``).  It is bound
by its launch at the sizes it runs at.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build

__all__ = [
    "bucket_costs_plain",
    "capture_tally",
    "count_replay",
    "ell_fan_in",
    "ell_fan_in_plain",
    "ell_minplus",
    "ell_minplus_plain",
    "factor_arity2_minplus",
    "factor_arity2_minplus_plain",
    "minplus_marginals_plain",
    "tree_evaluate",
    "tree_evaluate_plain",
    "xla_tree_levels",
    "xla_tree_sum",
    "xla_tree_sum_plain",
]


@functools.lru_cache(maxsize=None)
def _c_function(name: str, argtypes: tuple, variant: str = ""):
    """``<name><variant>_launch`` of ``csrc/<name>.cu``, built at first
    use and loaded with ctypes; every launch function returns
    cudaGetLastError()."""
    lib = ctypes.CDLL(str(_build.build_all((name,))[name]))
    fn = getattr(lib, f"{name}{variant}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


# the tallies of the graph captures in progress (capture_tally)
_tallies: List[Dict] = []


@contextlib.contextmanager
def capture_tally():
    """A dict that counts, by wrapper, the launches the wrappers record
    into CUDA graphs captured inside the ``with`` block."""
    tally: Dict = {}
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.remove(tally)


def count_replay(tally: Dict) -> None:
    """Add one replay's launches (a ``capture_tally`` of its graph) to
    the wrappers' ``launches`` counts."""
    for wrapper, n in tally.items():
        wrapper.launches += n


def _count_launch(wrapper) -> None:
    """One call of ``wrapper`` on the card: a launch now, or one recorded
    into the graph being captured on the current stream."""
    if torch.cuda.is_current_stream_capturing():
        for tally in _tallies:
            tally[wrapper] = tally.get(wrapper, 0) + 1
    else:
        wrapper.launches += 1


# the message planes a kernel takes, and the suffix of its launch function
_PLANE_DTYPES = (torch.float32, torch.bfloat16)
_PLANE_VARIANT = {torch.float32: "", torch.bfloat16: "_bf16"}

# v2f_t, pair_perm, tabs_t, real_row, out, d, n_pad, stream
_ELL_MINPLUS_ARGS = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
)


def ell_minplus_plain(
    v2f_t: torch.Tensor,  # [D, n_pad] f32 variable->factor plane
    pair_perm: torch.Tensor,  # [n_pad] int32 ELL slot of the partner edge
    tabs_t: torch.Tensor,  # [D, D, n_pad] f32 tab[own, partner, slot]
    real_row: torch.Tensor,  # [1, n_pad] bool, False on padding slots
) -> torch.Tensor:
    """``f2v[i, e] = min_j(tabs_t[i, j, e] + v2f_t[j, pair_perm[e]])``,
    exact 0 on padding slots: the same ops as the JAX package's jnp ELL
    factor step.  A bf16 ``v2f_t`` promotes exactly in the add; the
    result is float32."""
    f2v = torch.amin(tabs_t + v2f_t[:, pair_perm][None], dim=1)
    return torch.where(real_row, f2v, f2v.new_zeros(()))


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is on ``device``, of ``dtype`` (or one of a
    tuple of dtypes) and ``shape``, and contiguous."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def ell_minplus(
    v2f_t: torch.Tensor,
    pair_perm: torch.Tensor,
    tabs_t: torch.Tensor,
    real_row: torch.Tensor,
) -> torch.Tensor:
    """The ELL factor half-cycle: pair gather + table add + min over the
    partner's value + pad mask.  On CPU tensors this is
    :func:`ell_minplus_plain`; on CUDA tensors it launches
    ``csrc/ell_minplus.cu`` on the current stream (float32 tables, a
    float32 or bfloat16 plane, a float32 result)."""
    tensors = (v2f_t, pair_perm, tabs_t, real_row)
    if all(t.device.type == "cpu" for t in tensors):
        return ell_minplus_plain(v2f_t, pair_perm, tabs_t, real_row)
    device = v2f_t.device
    if device.type != "cuda":
        raise ValueError(f"ell_minplus runs on cpu or cuda, not {device}")
    d, n_pad = v2f_t.shape
    _check(v2f_t, "v2f_t", _PLANE_DTYPES, (d, n_pad), device)
    _check(pair_perm, "pair_perm", torch.int32, (n_pad,), device)
    _check(tabs_t, "tabs_t", torch.float32, (d, d, n_pad), device)
    _check(real_row, "real_row", torch.bool, (1, n_pad), device)
    out = tabs_t.new_empty((d, n_pad))
    fn = _c_function(
        "ell_minplus", _ELL_MINPLUS_ARGS, _PLANE_VARIANT[v2f_t.dtype]
    )
    with torch.cuda.device(device):
        rc = fn(
            v2f_t.data_ptr(), pair_perm.data_ptr(), tabs_t.data_ptr(),
            real_row.data_ptr(), out.data_ptr(), d, n_pad,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ell_minplus launch failed: CUDA error {rc}")
    _count_launch(ell_minplus)
    return out


ell_minplus.launches = 0


# v2f_t, e0, e1, tables_t, out0, out1, d, n_edges, n_c, stream
_FACTOR_ARITY2_ARGS = (ctypes.c_void_p,) * 6 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
)


def minplus_marginals_plain(
    tables_t: torch.Tensor,  # [D**a, n_c] lane-major flat tables
    in_msgs: Sequence[torch.Tensor],  # a planes [D, n_c], one per slot
) -> List[torch.Tensor]:
    """The a outgoing [D, n_c] planes of every arity-a factor, on
    lane-major planes: the broadcast-add ``((T + m_0) + m_1) + ...`` into
    the joint table, then per slot s the min over the other slots of
    ``total - m_s``.  The same ops in the same order as the JAX package's
    jnp lanes factor step."""
    a = len(in_msgs)
    d, n_c = in_msgs[0].shape
    msgs = []  # slot s's messages along axis s of [D]*a + [n_c]
    for s, m in enumerate(in_msgs):
        shape = [1] * a + [n_c]
        shape[s] = d
        msgs.append(m.reshape(shape))
    total = tables_t.reshape((d,) * a + (n_c,))
    for m in msgs:
        total = total + m
    outs = []
    for s in range(a):
        marg = total - msgs[s]
        axes = tuple(t for t in range(a) if t != s)
        outs.append(
            torch.amin(marg, dim=axes) if axes else marg.reshape(d, n_c)
        )
    return outs


def factor_arity2_minplus_plain(
    v2f_t: torch.Tensor,  # [D, n_edges] f32 variable->factor plane
    e0: torch.Tensor,  # [n_c] int32 edge id of each constraint's slot 0
    e1: torch.Tensor,  # [n_c] int32 edge id of each constraint's slot 1
    tables_t: torch.Tensor,  # [D*D, n_c] f32, row i*D+j = cost(i, j)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out0, out1)``, each [D, n_c]: with ``a = v2f_t[:, e0]`` and
    ``b = v2f_t[:, e1]`` and ``t = (T[i*D+j, c] + a[i, c]) + b[j, c]``,
    ``out0[i, c] = min_j(t - a[i, c])`` and
    ``out1[j, c] = min_i(t - b[j, c])``.  A bf16 plane promotes exactly
    in the adds and subtracts; the outputs are float32."""
    a = torch.index_select(v2f_t, 1, e0)
    b = torch.index_select(v2f_t, 1, e1)
    out0, out1 = minplus_marginals_plain(tables_t, [a, b])
    return out0, out1


def factor_arity2_minplus(
    v2f_t: torch.Tensor,
    e0: torch.Tensor,
    e1: torch.Tensor,
    tables_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both outgoing planes of every binary factor on the lanes layout:
    the two slot gathers, the table adds and the two min-marginals.  On
    CPU tensors this is :func:`factor_arity2_minplus_plain`; on CUDA
    tensors it launches ``csrc/factor_arity2_minplus.cu`` on the current
    stream (float32 tables, a float32 or bfloat16 plane, float32
    outputs)."""
    tensors = (v2f_t, e0, e1, tables_t)
    if all(t.device.type == "cpu" for t in tensors):
        return factor_arity2_minplus_plain(v2f_t, e0, e1, tables_t)
    device = v2f_t.device
    if device.type != "cuda":
        raise ValueError(
            f"factor_arity2_minplus runs on cpu or cuda, not {device}"
        )
    d, n_edges = v2f_t.shape
    n_c = e0.shape[0]
    _check(v2f_t, "v2f_t", _PLANE_DTYPES, (d, n_edges), device)
    _check(e0, "e0", torch.int32, (n_c,), device)
    _check(e1, "e1", torch.int32, (n_c,), device)
    _check(tables_t, "tables_t", torch.float32, (d * d, n_c), device)
    out0 = tables_t.new_empty((d, n_c))
    out1 = tables_t.new_empty((d, n_c))
    fn = _c_function(
        "factor_arity2_minplus", _FACTOR_ARITY2_ARGS,
        _PLANE_VARIANT[v2f_t.dtype],
    )
    with torch.cuda.device(device):
        rc = fn(
            v2f_t.data_ptr(), e0.data_ptr(), e1.data_ptr(),
            tables_t.data_ptr(), out0.data_ptr(), out1.data_ptr(),
            d, n_edges, n_c, torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"factor_arity2_minplus launch failed: CUDA error {rc}"
        )
    _count_launch(factor_arity2_minplus)
    return out0, out1


factor_arity2_minplus.launches = 0


#: XLA-CPU's window: a float sum over more elements than this is tree-summed
XLA_WINDOW = 32


def xla_tree_levels(n: int) -> List[Tuple[int, int, int, int]]:
    """The levels of a sum of ``n`` elements in XLA-CPU's tree order,
    each ``(n_in, k, lo, width)``: ``k`` windows of ``width`` over the
    ``n_in`` inputs padded with ``lo`` zeros in front (and the rest
    behind).  While more than 32 values are left, one level of windows of
    32 with symmetric padding (``lo = pad // 2``); then one window over
    the at most 32 values left, the final sequential reduce.  A single
    value is its own sum, with no level (XLA folds a one-element reduce
    away, so a -0.0 stays -0.0)."""
    if n == 1:
        return []
    levels = []
    while n > XLA_WINDOW:
        k = -(-n // XLA_WINDOW)
        levels.append((n, k, (k * XLA_WINDOW - n) // 2, XLA_WINDOW))
        n = k
    levels.append((n, 1, 0, n))
    return levels


def _tree_level_plain(
    x: torch.Tensor, k: int, lo: int, width: int
) -> torch.Tensor:
    """One level on the last axis: ``[..., n] -> [..., k]``, each window
    summed in index order from 0.0 by elementwise adds (exact IEEE
    operations, so the order is the one written)."""
    n = x.shape[-1]
    cols = torch.nn.functional.pad(x, (lo, k * width - lo - n)).reshape(
        *x.shape[:-1], k, width
    )
    acc = x.new_zeros((*x.shape[:-1], k))
    for i in range(width):
        acc = acc + cols[..., i]
    return acc


def xla_tree_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of a float32 tensor in XLA-CPU's tree
    order (:func:`xla_tree_levels`)."""
    for _, k, lo, width in xla_tree_levels(x.shape[-1]):
        x = _tree_level_plain(x, k, lo, width)
    return x[..., 0]


def _xla_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """:func:`xla_tree_sum_plain`, a bf16 ``x`` summed in float32 and
    rounded to bf16 once, as XLA sums a bf16 array."""
    if x.dtype == torch.bfloat16:
        return xla_tree_sum_plain(x.float()).to(torch.bfloat16)
    return xla_tree_sum_plain(x)


# Each row of n values of a launch of csrc/xla_tree_sum.cu over 1,024
# values (two levels of windows or more) takes a ticket (a counter the
# kernel leaves at zero) and scratch for its level-2 partials and the
# level after them; mirrors row_scratch in the source, which checks the
# sizes it is given.
_TWO_LEVELS = XLA_WINDOW * XLA_WINDOW


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _row_scratch(n: int) -> int:
    if n <= _TWO_LEVELS:
        return 0
    k2 = _cdiv(_cdiv(n, XLA_WINDOW), XLA_WINDOW)
    return k2 + _cdiv(k2, XLA_WINDOW)


def _tree_needs(segments) -> Tuple[int, int]:
    """(scratch floats, tickets) of segments of (n, rows)."""
    scratch = sum(rows * _row_scratch(n) for n, rows in segments)
    tickets = sum(rows for n, rows in segments if n > _TWO_LEVELS)
    return scratch, tickets


# the zeroed int32 ticket pools of each device; each launch leaves its
# tickets at zero.  A pool never goes: a captured graph keeps its address.
_ticket_pools: Dict[torch.device, List[torch.Tensor]] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 pool of at least ``n`` tickets on ``device``, made
    (outside any graph capture) the first time one this large is asked
    for."""
    pools = _ticket_pools.setdefault(device, [])
    if pools and pools[-1].numel() >= n:
        return pools[-1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"xla_tree_sum needs {n} tickets on {device}, more than any "
            "pool made so far, inside a graph capture: call it once "
            "outside the capture first"
        )
    pool = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    torch.cuda.current_stream(device).synchronize()
    pools.append(pool)
    return pool


def _tree_launch(name: str, argtypes: tuple, device, segments, extra=0):
    """(C launch function, scratch, tickets) of one tree-sum launch over
    ``segments`` of (n, rows): a fresh float32 scratch (plus ``extra``
    floats) and the device's ticket pool (plus ``extra`` tickets)."""
    scratch, tickets = _tree_needs(segments)
    return (
        _c_function("xla_tree_sum", argtypes, name),
        torch.empty(max(scratch + extra, 1), dtype=torch.float32,
                    device=device),
        _tickets(device, tickets + extra),
    )


def _run(fn, device, what: str, *args) -> None:
    """Call a launch function with the current stream; raise on a CUDA
    error or a refusal (-1: a buffer too small, a table too long)."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: error {rc}")
    _count_launch(xla_tree_sum)


def _scratch_args(scratch: torch.Tensor, tickets: torch.Tensor):
    return (scratch.data_ptr(), scratch.numel(), tickets.data_ptr(),
            tickets.numel())


def _on_cuda(tensors, what: str) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            f"{what} runs on cpu or one cuda device, not "
            f"{sorted({str(t.device) for t in tensors})}"
        )
    return device


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SCRATCH = (_P, _LL, _P, _LL)

# x, out, n, rows, inner, s_outer, s_inner, s_elem, scratch, tickets,
# stream
_ROWS_ARGS = (_P, _P) + (_LL,) * 6 + _SCRATCH + (_P,)


def _row_layout(x: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """``(rows, inner, s_outer, s_inner, s_elem)`` of the rows of a tensor
    of at most 3 dimensions, of any strides: row ``(o, i)`` starts at
    ``o * s_outer + i * s_inner``, its values ``s_elem`` apart."""
    if x.dim() == 0 or x.dim() > 3:
        raise ValueError(
            "xla_tree_sum takes 1 to 3 dimensions, got shape "
            f"{tuple(x.shape)}"
        )
    s_elem = x.stride(-1)
    if x.dim() == 1:
        return 1, 1, 0, 0, s_elem
    if x.dim() == 2:
        return x.shape[0], x.shape[0], 0, x.stride(0), s_elem
    return (x.shape[0] * x.shape[1], x.shape[1], x.stride(0), x.stride(1),
            s_elem)


def xla_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of a float32 tensor, in XLA-CPU's tree
    order.  On a CPU tensor this is :func:`xla_tree_sum_plain`; on a CUDA
    tensor (1 to 3 dimensions, of any strides: a [D, n] plane's domain
    axis is read in place) it is one launch of ``csrc/xla_tree_sum.cu``
    on the current stream, every row to its full tree."""
    if x.device.type == "cpu":
        return xla_tree_sum_plain(x)
    return _launch_rows(x, _on_cuda([x], "xla_tree_sum"))


def _launch_rows(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.float32")
    rows, inner, s_outer, s_inner, s_elem = _row_layout(x)
    out = x.new_empty(tuple(x.shape[:-1]))
    if rows == 0:
        return out
    n = x.shape[-1]
    fn, scratch, tickets = _tree_launch(
        "_rows", _ROWS_ARGS, device, [(n, rows)]
    )
    _run(fn, device, "xla_tree_sum", x.data_ptr(), out.data_ptr(), n, rows,
         inner, s_outer, s_inner, s_elem, *_scratch_args(scratch, tickets))
    return out


xla_tree_sum.launches = 0


def bucket_costs_plain(
    tables_flat: torch.Tensor,  # [n_c, D**a] float32
    var_slots: torch.Tensor,  # [n_c, a] int64
    d: int,
    values: torch.Tensor,  # [n_vars] value indices
) -> torch.Tensor:
    """[n_c] cost of each constraint of a bucket under ``values``: its
    table entry at the C-order flat index of its slots' values (integer,
    so exact in any order)."""
    vals = values.long()[var_slots]
    a = var_slots.shape[1]
    flat = vals[:, 0] * d ** (a - 1)
    for t in range(1, a):
        flat = flat + vals[:, t] * d ** (a - 1 - t)
    return torch.gather(tables_flat, 1, flat[:, None])[:, 0]


def tree_evaluate_plain(
    unary: torch.Tensor,  # [n_vars, D] float32
    values: torch.Tensor,  # [n_vars] int32 or int64 value indices
    buckets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    constant: torch.Tensor,  # scalar float32
) -> torch.Tensor:
    """``evaluate``'s total: the unary entries and each bucket's
    (``(tables_flat, var_slots)``) table entries under ``values``, each
    summed in XLA-CPU's tree order, combined as the JAX package combines
    them, ``unary + (0 + b0 + b1 + ...) + constant`` (Python's ``sum``
    starts from int 0)."""
    d = unary.shape[1]
    unary_cost = xla_tree_sum_plain(
        torch.gather(unary, 1, values.long()[:, None])[:, 0]
    )
    cons = sum(
        xla_tree_sum_plain(bucket_costs_plain(t, vs, d, values))
        for t, vs in buckets
    )
    return unary_cost + cons + constant


# values, values_i64, d, unary, unary_stride, n_vars, n_buckets, buckets,
# constant, out, scratch, tickets, stream
_EVALUATE_ARGS = (_P, ctypes.c_int, ctypes.c_int, _P, _LL, _LL, ctypes.c_int,
                  _P, _P, _P) + _SCRATCH + (_P,)
_VALUE_DTYPES = (torch.int32, torch.int64)


def tree_evaluate(
    unary: torch.Tensor,
    values: torch.Tensor,
    buckets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    constant: torch.Tensor,
) -> torch.Tensor:
    """``evaluate``'s total cost of an assignment, a 0-dim float32
    tensor.  On CPU tensors this is :func:`tree_evaluate_plain`; on CUDA
    tensors it is one launch of ``csrc/xla_tree_sum.cu`` (counted in
    ``xla_tree_sum.launches``) whose level 1 gathers each cost from the
    assignment and whose last warp combines the totals."""
    tensors = [unary, values, constant] + [t for b in buckets for t in b]
    if all(t.device.type == "cpu" for t in tensors):
        return tree_evaluate_plain(unary, values, buckets, constant)
    return _launch_evaluate(unary, values, buckets, constant,
                            _on_cuda(tensors, "tree_evaluate"))


def _launch_evaluate(unary, values, buckets, constant, device):
    n_vars, d = unary.shape
    if unary.dtype != torch.float32 or unary.stride(1) != 1:
        raise ValueError("unary must be float32 with unit-stride rows")
    _check(values, "values", _VALUE_DTYPES, (n_vars,), device)
    _check(constant, "constant", torch.float32, (), device)
    desc = []
    for tables, var_slots in buckets:
        n_c, a = var_slots.shape
        _check(tables, "tables_flat", torch.float32, (n_c, d ** a), device)
        _check(var_slots, "var_slots", torch.int64, (n_c, a), device)
        desc += [tables.data_ptr(), var_slots.data_ptr(), n_c, a]
    segments = [(n_vars, 1)] + [(vs.shape[0], 1) for _, vs in buckets]
    fn, scratch, tickets = _tree_launch(
        "_evaluate", _EVALUATE_ARGS, device, segments, extra=len(segments)
    )
    out = unary.new_empty(())
    desc = (ctypes.c_longlong * max(len(desc), 1))(*desc)
    _run(fn, device, "tree_evaluate", values.data_ptr(),
         int(values.dtype == torch.int64), d, unary.data_ptr(),
         unary.stride(0), n_vars, len(buckets), desc, constant.data_ptr(),
         out.data_ptr(), *_scratch_args(scratch, tickets))
    return out


def ell_fan_in_plain(
    spans: Sequence[Tuple[int, int]],
    unary_t: torch.Tensor,  # [D, V] float32, ell variable order
    f2v_t: torch.Tensor,  # [D, n_pad] float32 or bfloat16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MaxSum's ELL fan-in, class by class (``spans``: (nb, db) of each
    degree class in plane order): ``tot = xla_sum(seg) + u`` ([D, V]; a
    class of degree 0 is ``u``) and ``v2f_raw = tot - seg`` ([D, n_pad]),
    as the JAX package's ELL variable step computes them."""
    d = f2v_t.shape[0]
    tot_parts, v2f_parts = [], []
    off_e = off_v = 0
    for nb, db in spans:
        u = unary_t[:, off_v:off_v + nb]
        if db == 0:
            tot_parts.append(u)
        else:
            seg = f2v_t[:, off_e:off_e + nb * db].reshape(d, nb, db)
            tot_b = _xla_sum_plain(seg) + u
            tot_parts.append(tot_b)
            v2f_parts.append((tot_b[:, :, None] - seg).reshape(d, nb * db))
        off_e += nb * db
        off_v += nb
    tot = torch.cat(tot_parts, dim=1)
    if not v2f_parts:
        return tot, unary_t.new_zeros((d, 0))
    return tot, torch.cat(v2f_parts, dim=1)


# plane, d, n_pad, u, n_vars, n_classes, spans, tot, v2f, scratch,
# tickets, stream
_FAN_IN_ARGS = (_P, ctypes.c_int, _LL, _P, _LL, ctypes.c_int, _P, _P,
                _P) + _SCRATCH + (_P,)


@functools.lru_cache(maxsize=None)
def _span_table(spans: Tuple[Tuple[int, int], ...]):
    return (ctypes.c_longlong * (2 * len(spans)))(
        *(v for span in spans for v in span)
    )


def ell_fan_in(
    spans: Tuple[Tuple[int, int], ...],
    unary_t: torch.Tensor,
    f2v_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(tot, v2f_raw)`` of MaxSum's ELL fan-in over every degree class.
    On CPU tensors this is :func:`ell_fan_in_plain`; on CUDA tensors it is
    one launch of ``csrc/xla_tree_sum.cu`` (counted in
    ``xla_tree_sum.launches``) over all classes at once, writing both
    float32 planes whole (a float32 or bfloat16 ``f2v_t``)."""
    if unary_t.device.type == "cpu" and f2v_t.device.type == "cpu":
        return ell_fan_in_plain(spans, unary_t, f2v_t)
    return _launch_fan_in(spans, unary_t, f2v_t,
                          _on_cuda([unary_t, f2v_t], "ell_fan_in"))


def _launch_fan_in(spans, unary_t, f2v_t, device):
    d, n_pad = f2v_t.shape
    n_vars = unary_t.shape[1]
    _check(f2v_t, "f2v_t", _PLANE_DTYPES, (d, n_pad), device)
    _check(unary_t, "unary_t", torch.float32, (d, n_vars), device)
    segments = [(db, d * nb) for nb, db in spans]
    fn, scratch, tickets = _tree_launch(
        "_ell_fan_in" + _PLANE_VARIANT[f2v_t.dtype], _FAN_IN_ARGS, device,
        segments,
    )
    tot = unary_t.new_empty((d, n_vars))
    v2f = unary_t.new_empty((d, n_pad))
    _run(fn, device, "ell_fan_in", f2v_t.data_ptr(), d, n_pad,
         unary_t.data_ptr(), n_vars, len(spans), _span_table(tuple(spans)),
         tot.data_ptr(), v2f.data_ptr(), *_scratch_args(scratch, tickets))
    return tot, v2f
