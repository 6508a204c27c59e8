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
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build

__all__ = [
    "capture_tally",
    "count_replay",
    "ell_minplus",
    "ell_minplus_plain",
    "factor_arity2_minplus",
    "factor_arity2_minplus_plain",
    "minplus_marginals_plain",
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


# x, out, outer, inner, s_outer, s_inner, n, k, lo, width, stream
_XLA_TREE_SUM_ARGS = (ctypes.c_void_p,) * 2 + (ctypes.c_longlong,) * 7 + (
    ctypes.c_int, ctypes.c_void_p,
)

#: XLA-CPU's window: a float sum over more elements than this is tree-summed
XLA_WINDOW = 32


def xla_tree_levels(n: int) -> List[Tuple[int, int, int, int]]:
    """The launches of a sum of ``n`` elements in XLA-CPU's tree order,
    each ``(n_in, k, lo, width)``: ``k`` windows of ``width`` over the
    ``n_in`` inputs padded with ``lo`` zeros in front (and the rest
    behind).  While more than 32 values are left, one level of windows of
    32 with symmetric padding (``lo = pad // 2``); then one window over
    the at most 32 values left, the final sequential reduce.  A single
    value is its own sum, with no launch (XLA folds a one-element reduce
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


def _row_layout(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """``(outer, inner, s_outer, s_inner)`` of the rows of a tensor of at
    most 3 dimensions whose last axis is unit-stride (the kernel's strided
    stack of rows)."""
    if x.dim() > 3 or (x.dim() and x.stride(-1) != 1 and x.shape[-1] > 1):
        raise ValueError(
            "xla_tree_sum takes at most 3 dimensions with a unit-stride "
            f"last axis, got shape {tuple(x.shape)} strides {x.stride()}"
        )
    if x.dim() <= 1:
        return 1, 1, 0, 0
    if x.dim() == 2:
        return 1, x.shape[0], 0, x.stride(0)
    return x.shape[0], x.shape[1], x.stride(0), x.stride(1)


def xla_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of a float32 tensor, in XLA-CPU's tree
    order.  On a CPU tensor this is :func:`xla_tree_sum_plain`; on a CUDA
    tensor (at most 3 dimensions, the last unit-stride, the others of any
    stride) it launches ``csrc/xla_tree_sum.cu`` once a level of
    :func:`xla_tree_levels` (the last launch is the final reduce), on the
    current stream."""
    if x.device.type == "cpu":
        return xla_tree_sum_plain(x)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"xla_tree_sum runs on cpu or cuda, not {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.float32")
    lead = tuple(x.shape[:-1])
    outer, inner, s_outer, s_inner = _row_layout(x)
    fn = _c_function("xla_tree_sum", _XLA_TREE_SUM_ARGS)
    for n, k, lo, width in xla_tree_levels(x.shape[-1]):
        out = x.new_empty(lead + (k,))
        with torch.cuda.device(device):
            rc = fn(
                x.data_ptr(), out.data_ptr(), outer, inner, s_outer, s_inner,
                n, k, lo, width, torch.cuda.current_stream(device).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"xla_tree_sum launch failed: CUDA error {rc}")
        _count_launch(xla_tree_sum)
        # the next level reads this contiguous [rows, k] output
        x = out
        outer, inner, s_outer, s_inner = 1, outer * inner, 0, k
    return x[..., 0]


xla_tree_sum.launches = 0
