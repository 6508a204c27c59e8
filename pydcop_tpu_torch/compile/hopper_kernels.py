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

``branch_bound`` (``csrc/branch_bound.cu``) is the port's own kernel too:
the depth-first branch and bound of SyncBB and NCBB, the whole search in
one launch of one thread block whose first warp searches, its lanes in
step, computing a position's candidate row once a visit (``_bb_loop`` of
the JAX package's ``algorithms/_branch_bound.py`` is a
``lax.while_loop``, not a Pallas kernel).  It is bound by the latency of
its dependent steps.  Its plain version runs JAX's step in PyTorch, 256
masked steps between looks at the depth, as the JAX loop does.

``xla_tree_sum`` (``csrc/xla_tree_sum.cu``) is the port's own kernel, not
a TPU kernel's: the float32 sums whose order decides a result, in the
order XLA's CPU compiler gives the JAX package (``xla_tree_levels``; the
plain versions define it).  Each sum site is one launch: ``xla_tree_sum``
(a strided stack of rows; MaxSum's domain sum reads its plane in place),
``tree_evaluate`` (``evaluate``'s gathers, sums and combine) and
``ell_fan_in`` (every degree class of MaxSum's ELL fan-in), all counted
in ``xla_tree_sum.launches``.  Rows over 1,024 values take tickets from a
zeroed pool that each launch leaves at zero (``_tickets``).  The fan-in
and the domain sum stream their planes and are bound by bytes: the
fan-in's classes of up to 32 slots run as warp tiles (32 rows a warp,
staged through shared memory, the plane read once and both planes
written coalesced), the domain sum's rows of up to 32 values take a
short-row kernel of vector loads; one-row sums move a few MB at most,
near the cost of their one launch.  ``tree_evaluate`` is a kernel of its
own, bound by its dependent gathers (slots, the assignment, the table
entry) and the sectors they move: a block gathers and sums one level-2
window of 1,024 costs, takes one ticket of its instance, and the block
that draws the last one finishes every segment's sum and combines them.

``damp_fma`` (``csrc/damp_fma.cu``) is the port's own kernel too:
MaxSum's float32 damping ``d * prev + (1 - d) * new`` as the one fused
multiply-add XLA's CPU compiler makes of it in the JAX package's MaxSum
programs, ``fma(d, prev, e * new)`` with both roundings written as
intrinsics.  It is bound by bytes (12 B a value).  Its plain version
rounds the same way in float64, with round-to-odd.

The serving layer's batches: ``ell_minplus``, ``xla_tree_sum``,
``tree_evaluate``, ``ell_fan_in`` and ``damp_fma`` are each reached through a
``torch.library`` custom op whose vmap rule turns a call mapped over an
instance axis into the ``*_batched`` function: K instances of one shape
stacked on a leading axis, one launch for all of them on the card (the
sources' ``*_batched_launch`` entries; the rows sum folds the instances
into its outer stride), each instance the bits of its solo call.  Such a
launch counts in the wrapper's ``launches`` and in its
``batched.launches``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "branch_bound",
    "branch_bound_plain",
    "bucket_costs_plain",
    "capture_tally",
    "count_replay",
    "damp_constants",
    "damp_fma",
    "damp_fma_batched",
    "damp_fma_plain",
    "ell_fan_in",
    "ell_fan_in_batched",
    "ell_fan_in_plain",
    "ell_minplus",
    "ell_minplus_batched",
    "ell_minplus_plain",
    "factor_arity2_minplus",
    "factor_arity2_minplus_plain",
    "minplus_marginals_plain",
    "own_stream",
    "tree_evaluate",
    "tree_evaluate_batched",
    "tree_evaluate_plain",
    "xla_tree_levels",
    "xla_tree_sum",
    "xla_tree_sum_batched",
    "xla_tree_sum_plain",
]


#: one build at a time: two threads that solve at once (the agent
#: runtime's main solve and a repair's) may both reach a first use, and
#: a build's temporary file is named by the process only
_build_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use."""
    with _build_lock:
        return ctypes.CDLL(str(_build.build_all((name,))[name]))


@functools.lru_cache(maxsize=None)
def _c_function(name: str, argtypes: tuple, variant: str = ""):
    """``<name><variant>_launch`` of ``csrc/<name>.cu``, built at first
    use and loaded with ctypes; every launch function returns
    cudaGetLastError()."""
    return _bind(_library(name), f"{name}{variant}_launch", argtypes)


def _bind(library: ctypes.CDLL, symbol: str, argtypes: tuple):
    fn = getattr(library, symbol)
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
    for mine in _thread_tallies():
        for wrapper, n in tally.items():
            if getattr(wrapper, "__name__", None):
                mine[wrapper] = mine.get(wrapper, 0) + n


_local = threading.local()


def _thread_tallies() -> List[Dict]:
    return getattr(_local, "tallies", ())


@contextlib.contextmanager
def thread_tally():
    """A dict that counts, by wrapper, the launches made on the card by
    the current thread inside the ``with`` block (replays included): the
    share of the ``launches`` counts of one of the solves that several
    threads run at once (the agent runtime's main solve and a repair's).
    Its keys are the wrappers and ``xla_tree_sum.entries``' counts (each
    with a ``__name__``), not the batched counts."""
    tally: Dict = {}
    tallies = list(_thread_tallies())
    _local.tallies = tallies + [tally]
    try:
        yield tally
    finally:
        _local.tallies = tallies


class _Count:
    """A count of launches of its own: a wrapper's ``batched``, the
    launches it made for a whole batch of instances, or one of
    ``xla_tree_sum.entries``, the launches of one of its entry points
    (counted in the wrapper's ``launches`` too).  An entry's count has a
    ``__name__``, for the thread tallies."""

    def __init__(self, name: str = None) -> None:
        self.launches = 0
        self.__name__ = name


def _count_launch(wrapper, batched: bool = False, entry=None) -> None:
    """One call of ``wrapper`` on the card: a launch now, or one recorded
    into the graph being captured on the current stream.  A launch for a
    batch counts in ``wrapper.batched`` too, and one of an entry point
    in ``entry``."""
    counts = (wrapper,) + ((wrapper.batched,) if batched else ()) + (
        (entry,) if entry is not None else ())
    if torch.cuda.is_current_stream_capturing():
        for tally in _tallies:
            for c in counts:
                tally[c] = tally.get(c, 0) + 1
    else:
        for c in counts:
            c.launches += 1
        for mine in _thread_tallies():
            for c in counts:
                if getattr(c, "__name__", None):
                    mine[c] = mine.get(c, 0) + 1


# Each wrapper is reached through a torch.library custom op, whose vmap
# rule makes a call mapped over an instance axis (the serving layer's
# batches, algorithms/base.py's _map_instances) ONE launch for the whole
# batch (on the CPU, the plain version instance by instance).
_OPS = "pydcop_tpu_torch"


def _batch_first(batch_size: int, in_dims, args) -> List:
    """``args`` with the instance axis first: a mapped tensor's axis moved
    to 0, an unmapped tensor broadcast along a new axis 0 (lists of
    tensors element by element); other values as they are."""

    def one(x, d):
        if d is None:
            return x.expand(batch_size, *x.shape)
        return x.movedim(d, 0)

    out = []
    for a, d in zip(args, in_dims):
        if isinstance(a, torch.Tensor):
            out.append(one(a, d))
        elif isinstance(a, (list, tuple)) and all(
            isinstance(x, torch.Tensor) for x in a
        ):
            dims = d if isinstance(d, (list, tuple)) else [d] * len(a)
            out.append([one(x, dd) for x, dd in zip(a, dims)])
        else:
            out.append(a)
    return out


def _per_instance(plain: Callable, *args):
    """``plain`` called on each instance of ``args`` (batch-first tensors,
    lists of them, and other values as they are), its results stacked:
    the CPU's batched call, each instance's bits its solo call's (a vmap
    rule cannot map the plain version again)."""
    k = next(
        a.shape[0] if isinstance(a, torch.Tensor) else a[0].shape[0]
        for a in args
        if isinstance(a, torch.Tensor) or (
            isinstance(a, list) and a and isinstance(a[0], torch.Tensor))
    )

    def pick(a, i):
        if isinstance(a, torch.Tensor):
            return a[i]
        if isinstance(a, list) and all(
            isinstance(x, torch.Tensor) for x in a
        ):
            return [x[i] for x in a]
        return a

    outs = [plain(*(pick(a, i) for a in args)) for i in range(k)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(col) for col in zip(*outs))
    return torch.stack(outs)


def _fresh(out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """``out``, copied if it shares memory with an input (a custom op's
    result may not alias its operands: a one-element sum is a view)."""
    ptr = out.untyped_storage().data_ptr()
    if any(x.untyped_storage().data_ptr() == ptr for x in inputs):
        return out.clone()
    return out


def _host_or_card(tensors, what: str) -> torch.device:
    """The device of a call: the CPU, or one CUDA device; raises for
    anything else (a mix, or another device type)."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return torch.device("cpu")
    return _on_cuda(list(tensors), what)


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
    float32 or bfloat16 plane, a float32 result).  Mapped over an
    instance axis (``torch.func.vmap``) it is one launch for the whole
    batch (``ell_minplus_batched``), each instance's result the solo
    call's."""
    _host_or_card((v2f_t, pair_perm, tabs_t, real_row), "ell_minplus")
    return _ell_minplus_op(v2f_t, pair_perm, tabs_t, real_row)


ell_minplus.launches = 0
ell_minplus.batched = _Count()


@torch.library.custom_op(f"{_OPS}::ell_minplus", mutates_args=())
def _ell_minplus_op(
    v2f_t: torch.Tensor, pair_perm: torch.Tensor, tabs_t: torch.Tensor,
    real_row: torch.Tensor,
) -> torch.Tensor:
    if v2f_t.device.type == "cpu":
        return ell_minplus_plain(v2f_t, pair_perm, tabs_t, real_row)
    return _launch_ell_minplus(v2f_t, pair_perm, tabs_t, real_row, False)


@_ell_minplus_op.register_vmap
def _ell_minplus_vmap(info, in_dims, *args):
    return ell_minplus_batched(*_batch_first(info.batch_size, in_dims,
                                             args)), 0


def ell_minplus_batched(
    v2f_t: torch.Tensor,  # [K, D, n_pad]
    pair_perm: torch.Tensor,  # [K, n_pad] int32, instance-local slots
    tabs_t: torch.Tensor,  # [K, D, D, n_pad]
    real_row: torch.Tensor,  # [K, 1, n_pad]
) -> torch.Tensor:
    """``ell_minplus`` of K instances stacked on a leading axis, each
    instance's result its solo call's: on CPU tensors the plain version
    of each instance, on CUDA tensors one launch of
    ``csrc/ell_minplus.cu`` for the batch (counted in
    ``ell_minplus.launches`` and ``ell_minplus.batched.launches``)."""
    args = (v2f_t, pair_perm, tabs_t, real_row)
    if _host_or_card(args, "ell_minplus").type == "cpu":
        return _per_instance(ell_minplus_plain, *args)
    return _launch_ell_minplus(*(a.contiguous() for a in args), True)


# v2f_t, pair_perm, tabs_t, real_row, out, d, n_pad, n_inst, stream
_ELL_MINPLUS_BATCHED_ARGS = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
)


def _launch_ell_minplus(v2f_t, pair_perm, tabs_t, real_row,
                        batched: bool) -> torch.Tensor:
    device = v2f_t.device
    lead = tuple(v2f_t.shape[:1]) if batched else ()
    d, n_pad = v2f_t.shape[-2:]
    _check(v2f_t, "v2f_t", _PLANE_DTYPES, lead + (d, n_pad), device)
    _check(pair_perm, "pair_perm", torch.int32, lead + (n_pad,), device)
    _check(tabs_t, "tabs_t", torch.float32, lead + (d, d, n_pad), device)
    _check(real_row, "real_row", torch.bool, lead + (1, n_pad), device)
    out = tabs_t.new_empty(lead + (d, n_pad))
    variant = _PLANE_VARIANT[v2f_t.dtype]
    args = [v2f_t.data_ptr(), pair_perm.data_ptr(), tabs_t.data_ptr(),
            real_row.data_ptr(), out.data_ptr(), d, n_pad]
    if batched:
        fn = _c_function("ell_minplus", _ELL_MINPLUS_BATCHED_ARGS,
                         variant + "_batched")
        args.append(lead[0])
    else:
        fn = _c_function("ell_minplus", _ELL_MINPLUS_ARGS, variant)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_minplus launch failed: CUDA error {rc}")
    _count_launch(ell_minplus, batched)
    return out


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


def damp_constants(damping: float) -> Tuple[float, float]:
    """``(d, e)``: ``damping`` and ``1 - damping`` as the float32
    constants of the JAX package's jitted damping (the subtraction in
    double precision, as JAX's weak-typed Python constant is)."""
    return float(np.float32(damping)), float(np.float32(1.0 - damping))


def damp_fma_plain(
    prev: torch.Tensor, new: torch.Tensor, d: float, e: float
) -> torch.Tensor:
    """``fma(d, prev, e * new)`` over float32 planes, rounded as a fused
    multiply-add: ``e * new`` rounded to float32, then ONE rounding of
    the exact ``d * prev`` plus it.  In float64 the product ``d * prev``
    is exact and the sum rounds once; its cast to float32 rounds a second
    time, which gives another float32 than one rounding of the exact
    value only where the float64 sum landed exactly on a float32
    midpoint.  There (rarely: the values are found with one look at the
    sums, so this version is for the CPU and checks, not for a captured
    graph) the sum is made round-to-odd: TwoSum's error term says on
    which side the exact value lies, and the sum steps one float64 ulp
    toward it before the cast."""
    c = new * e
    a = prev.double().mul_(d)
    s = a + c
    out = s.float()
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if bool(mid.any()):
        i = mid.nonzero(as_tuple=True)
        ai, ci, si = a[i], c[i].double(), s[i]
        b = si - ai
        err = (ai - (si - b)) + (ci - b)
        toward = torch.where(err > 0, torch.inf, -torch.inf).to(si.dtype)
        out[i] = torch.where(err != 0, torch.nextafter(si, toward),
                             si).float()
    return out


def damp_fma(damping: float, prev: torch.Tensor,
             new: torch.Tensor) -> torch.Tensor:
    """MaxSum's float32 damping ``damping * prev + (1 - damping) * new``
    in the form XLA's CPU compiler gives the JAX package: one fused
    multiply-add, ``fma(d, prev, e * new)`` (``damp_constants``).  On CPU
    tensors this is :func:`damp_fma_plain`; on CUDA tensors it launches
    ``csrc/damp_fma.cu`` on the current stream.  Mapped over an instance
    axis it is one launch for the whole batch."""
    _host_or_card((prev, new), "damp_fma")
    if prev.dtype != torch.float32 or new.dtype != torch.float32:
        raise TypeError(
            f"damp_fma takes float32 planes, got {prev.dtype}, {new.dtype}"
        )
    d, e = damp_constants(damping)
    return _damp_fma_op(prev, new, d, e)


damp_fma.launches = 0
damp_fma.batched = _Count()


@torch.library.custom_op(f"{_OPS}::damp_fma", mutates_args=())
def _damp_fma_op(prev: torch.Tensor, new: torch.Tensor, d: float,
                 e: float) -> torch.Tensor:
    if prev.device.type == "cpu":
        return damp_fma_plain(prev, new, d, e)
    return _launch_damp_fma(prev, new, d, e, False)


@_damp_fma_op.register_vmap
def _damp_fma_vmap(info, in_dims, prev, new, d, e):
    prev, new = _batch_first(info.batch_size, in_dims[:2], (prev, new))
    return damp_fma_batched(prev, new, d, e), 0


def damp_fma_batched(prev: torch.Tensor, new: torch.Tensor, d: float,
                     e: float) -> torch.Tensor:
    """``damp_fma`` of K planes stacked on a leading axis: elementwise, so
    on CUDA tensors one launch over the K planes as one (counted in
    ``damp_fma.launches`` and ``damp_fma.batched.launches``)."""
    if _host_or_card((prev, new), "damp_fma").type == "cpu":
        return damp_fma_plain(prev, new, d, e)
    return _launch_damp_fma(prev.contiguous(), new.contiguous(), d, e, True)


# prev, new, out, d, e, n, stream
_DAMP_FMA_ARGS = (ctypes.c_void_p,) * 3 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p,
)


def _launch_damp_fma(prev, new, d: float, e: float,
                     batched: bool) -> torch.Tensor:
    device = prev.device
    shape = tuple(prev.shape)
    _check(prev, "prev", torch.float32, shape, device)
    _check(new, "new", torch.float32, shape, device)
    out = torch.empty_like(prev)
    fn = _c_function("damp_fma", _DAMP_FMA_ARGS)
    with torch.cuda.device(device):
        rc = fn(prev.data_ptr(), new.data_ptr(), out.data_ptr(), d, e,
                prev.numel(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"damp_fma launch failed: CUDA error {rc}")
    _count_launch(damp_fma, batched)
    return out


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
# tickets at zero.  Launches on one stream run in order, so a stream's
# eager launches and the graphs that replay on it share one pool: the
# default stream's (key None) for a solve on it, a stream's own for a
# solve on ``own_stream`` (the agent runtime's repairs, beside the main
# solve on the default stream).  A graph takes the pool of the stream it
# will replay on, the thread's home stream; a warm-up on a side stream,
# which may run beside another thread's work, takes that stream's pool
# and sizes the home pool for the capture that follows.  A pool never
# goes: a captured graph keeps its address.
_ticket_pools: Dict[Tuple[torch.device, object], List[torch.Tensor]] = {}
# each device's stream of its own (the high-priority pool's, which no
# fresh ``torch.cuda.Stream()`` of the default priority hands out)
_own_streams: Dict[torch.device, torch.cuda.Stream] = {}


@contextlib.contextmanager
def own_stream(device):
    """The block's device work on ``device``'s stream of its own, which
    runs beside the default stream's instead of queueing behind it; its
    graphs replay on it.  A null context off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    stream = _own_streams.get(device)
    if stream is None:
        stream = _own_streams.setdefault(
            device, torch.cuda.Stream(device, priority=-1))
    prev = getattr(_local, "home", None)
    _local.home = stream
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        _local.home = prev


def _stream_key(stream, device: torch.device):
    if stream is None or stream == torch.cuda.default_stream(device):
        return None
    return stream.cuda_stream


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 pool of at least ``n`` tickets on ``device`` for
    the launches of the current stream (inside a capture: of the stream
    the graph will replay on), made (outside any graph capture) the
    first time one this large is asked for."""
    home = _stream_key(getattr(_local, "home", None), device)
    if torch.cuda.is_current_stream_capturing():
        return _ticket_pool(device, home, n, True)
    key = _stream_key(torch.cuda.current_stream(device), device)
    pool = _ticket_pool(device, key, n, False)
    if key != home:
        _ticket_pool(device, home, n, False)
    return pool


def _ticket_pool(device: torch.device, key, n: int,
                 capturing: bool) -> torch.Tensor:
    pools = _ticket_pools.setdefault((device, key), [])
    if pools and pools[-1].numel() >= n:
        return pools[-1]
    if capturing:
        raise RuntimeError(
            f"xla_tree_sum needs {n} tickets on {device}, more than any "
            "pool made so far, inside a graph capture: call it once "
            "outside the capture first"
        )
    pool = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    torch.cuda.current_stream(device).synchronize()
    pools.append(pool)
    return pool


def _tree_launch(name: str, argtypes: tuple, device, segments,
                 extra_scratch=0, extra_tickets=0, library=None):
    """(C launch function, scratch, tickets) of one tree-sum launch over
    ``segments`` of (n, rows): a fresh float32 scratch (plus
    ``extra_scratch`` floats) and the device's ticket pool (plus
    ``extra_tickets``).  A batch's rows are all its instances' rows.  The
    function is ``library``'s where one is given (another build of
    ``csrc/xla_tree_sum.cu``), else this package's."""
    scratch, tickets = _tree_needs(segments)
    return (
        _c_function("xla_tree_sum", argtypes, name) if library is None
        else _bind(library, f"xla_tree_sum{name}_launch", argtypes),
        torch.empty(max(scratch + extra_scratch, 1), dtype=torch.float32,
                    device=device),
        _tickets(device, tickets + extra_tickets),
    )


def _run(fn, device, what: str, *args, batched: bool = False,
         count: bool = True) -> None:
    """Call a launch function with the current stream; raise on a CUDA
    error or a refusal (-1: a buffer too small, a table too long).  The
    launch is counted unless ``count`` is false (another build's)."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: error {rc}")
    if count:
        _count_launch(xla_tree_sum, batched, xla_tree_sum.entries[what])


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
    on the current stream, every row to its full tree.  Mapped over an
    instance axis it is one launch for the K instances' rows
    (``xla_tree_sum_batched``)."""
    _host_or_card((x,), "xla_tree_sum")
    return _rows_op(x)


xla_tree_sum.launches = 0
xla_tree_sum.batched = _Count()
#: the launches of each entry point of ``csrc/xla_tree_sum.cu`` (the
#: rows sum, ``evaluate_kernel``, the ELL fan-in), batched ones included
xla_tree_sum.entries = {
    what: _Count(f"xla_tree_sum.{what}")
    for what in ("xla_tree_sum", "tree_evaluate", "ell_fan_in")
}


@torch.library.custom_op(f"{_OPS}::xla_tree_sum", mutates_args=())
def _rows_op(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return _fresh(xla_tree_sum_plain(x), x)
    return _launch_rows(x, x.device, False)


@_rows_op.register_vmap
def _rows_vmap(info, in_dims, x):
    return xla_tree_sum_batched(*_batch_first(info.batch_size, in_dims,
                                              (x,))), 0


def xla_tree_sum_batched(x: torch.Tensor) -> torch.Tensor:
    """``xla_tree_sum`` of K instances stacked on a leading axis of ``x``
    (of any strides): on a CPU tensor the plain version of each
    instance, on a CUDA tensor one launch over the K instances' rows,
    the instance axis the rows' outer stride (counted in
    ``xla_tree_sum.batched.launches`` too)."""
    device = _host_or_card((x,), "xla_tree_sum")
    if device.type == "cpu":
        return _per_instance(xla_tree_sum_plain, x)
    lead = tuple(x.shape[:-1])
    if x.dim() > 3:
        x = x.reshape(-1, *x.shape[-2:])
    return _launch_rows(x, device, True).reshape(lead)


def _launch_rows(x: torch.Tensor, device: torch.device, batched: bool,
                 library=None) -> torch.Tensor:
    """The rows' sums (see ``_tree_launch`` for ``library``)."""
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, expected torch.float32")
    rows, inner, s_outer, s_inner, s_elem = _row_layout(x)
    out = x.new_empty(tuple(x.shape[:-1]))
    if rows == 0:
        return out
    n = x.shape[-1]
    fn, scratch, tickets = _tree_launch(
        "_rows", _ROWS_ARGS, device, [(n, rows)], library=library
    )
    _run(fn, device, "xla_tree_sum", x.data_ptr(), out.data_ptr(), n, rows,
         inner, s_outer, s_inner, s_elem, *_scratch_args(scratch, tickets),
         batched=batched, count=library is None)
    return out


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
    tensors it is one launch of ``csrc/xla_tree_sum.cu``'s
    ``evaluate_kernel`` (counted in ``xla_tree_sum.launches``), whose
    blocks gather and sum 1,024 costs each and whose last block (one
    ticket an instance) finishes the sums and combines the totals.
    Mapped over an instance axis it is one launch for the K totals
    (``tree_evaluate_batched``)."""
    tables = [t for t, _ in buckets]
    var_slots = [vs for _, vs in buckets]
    _host_or_card([unary, values, constant] + tables + var_slots,
                  "tree_evaluate")
    return _evaluate_op(unary, values, tables, var_slots, constant)


@torch.library.custom_op(f"{_OPS}::tree_evaluate", mutates_args=())
def _evaluate_op(
    unary: torch.Tensor, values: torch.Tensor, tables: List[torch.Tensor],
    var_slots: List[torch.Tensor], constant: torch.Tensor,
) -> torch.Tensor:
    buckets = list(zip(tables, var_slots))
    if unary.device.type == "cpu":
        return tree_evaluate_plain(unary, values, buckets, constant)
    return _launch_evaluate(unary, values, buckets, constant, unary.device)


@_evaluate_op.register_vmap
def _evaluate_vmap(info, in_dims, unary, values, tables, var_slots,
                   constant):
    unary, values, tables, var_slots, constant = _batch_first(
        info.batch_size, in_dims, (unary, values, tables, var_slots,
                                   constant),
    )
    return tree_evaluate_batched(
        unary, values, list(zip(tables, var_slots)), constant
    ), 0


def tree_evaluate_batched(
    unary: torch.Tensor,  # [K, n_vars, D]
    values: torch.Tensor,  # [K, n_vars]
    buckets: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # [K, ...] each
    constant: torch.Tensor,  # [K]
) -> torch.Tensor:
    """[K] ``evaluate`` totals of K instances of one shape stacked on a
    leading axis (instance-local variable ids), each its solo call's: on
    CPU tensors the plain version of each instance, on CUDA
    tensors one launch for the batch."""
    tensors = [unary, values, constant] + [t for b in buckets for t in b]
    device = _host_or_card(tensors, "tree_evaluate")
    if device.type == "cpu":
        return _per_instance(
            lambda u, v, ts, vss, c: tree_evaluate_plain(
                u, v, list(zip(ts, vss)), c
            ),
            unary, values, [t for t, _ in buckets],
            [vs for _, vs in buckets], constant,
        )
    return _launch_evaluate_batched(
        unary.contiguous(), values.contiguous(),
        [(t.contiguous(), vs.contiguous()) for t, vs in buckets],
        constant.contiguous(), device,
    )


def _launch_evaluate(unary, values, buckets, constant, device,
                     library=None):
    """The total (see ``_tree_launch`` for ``library``)."""
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
    fn, scratch, tickets = _evaluate_tree_launch(
        "_evaluate", _EVALUATE_ARGS, device, segments, 1, library)
    out = unary.new_empty(())
    desc = (ctypes.c_longlong * max(len(desc), 1))(*desc)
    _run(fn, device, "tree_evaluate", values.data_ptr(),
         int(values.dtype == torch.int64), d, unary.data_ptr(),
         unary.stride(0), n_vars, len(buckets), desc, constant.data_ptr(),
         out.data_ptr(), *_scratch_args(scratch, tickets),
         count=library is None)
    return out


# values, values_i64, d, unary, unary_stride, unary_inst, n_vars, n_inst,
# n_buckets, buckets, constant, out, scratch, tickets, stream
_EVALUATE_BATCHED_ARGS = (_P, ctypes.c_int, ctypes.c_int, _P, _LL, _LL, _LL,
                          _LL, ctypes.c_int, _P, _P, _P) + _SCRATCH + (_P,)


def _evaluate_tree_launch(name, argtypes, device, segments, k, library):
    """``_tree_launch`` of an evaluate entry over K instances' segments.
    Its scratch is the rows' tree needs and one total a segment, and its
    tickets one a row over 1,024 values and one an instance: more than
    ``evaluate_kernel`` takes (a partial a block, one ticket an instance),
    as an earlier build of the source took it, so that ``--against`` can
    run either build through this one marshalling."""
    return _tree_launch(name, argtypes, device, segments,
                        extra_scratch=k * len(segments), extra_tickets=k,
                        library=library)


def _launch_evaluate_batched(unary, values, buckets, constant, device,
                             library=None):
    """The K totals (see ``_tree_launch`` for ``library``)."""
    k, n_vars, d = unary.shape
    _check(unary, "unary", torch.float32, (k, n_vars, d), device)
    _check(values, "values", _VALUE_DTYPES, (k, n_vars), device)
    _check(constant, "constant", torch.float32, (k,), device)
    desc = []
    for tables, var_slots in buckets:
        _, n_c, a = var_slots.shape
        _check(tables, "tables_flat", torch.float32, (k, n_c, d ** a),
               device)
        _check(var_slots, "var_slots", torch.int64, (k, n_c, a), device)
        desc += [tables.data_ptr(), var_slots.data_ptr(), n_c, a]
    segments = [(n_vars, k)] + [(vs.shape[1], k) for _, vs in buckets]
    fn, scratch, tickets = _evaluate_tree_launch(
        "_evaluate_batched", _EVALUATE_BATCHED_ARGS, device, segments, k,
        library)
    out = unary.new_empty((k,))
    desc = (ctypes.c_longlong * max(len(desc), 1))(*desc)
    _run(fn, device, "tree_evaluate", values.data_ptr(),
         int(values.dtype == torch.int64), d, unary.data_ptr(), d,
         n_vars * d, n_vars, k, len(buckets), desc, constant.data_ptr(),
         out.data_ptr(), *_scratch_args(scratch, tickets), batched=True,
         count=library is None)
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
    float32 planes whole (a float32 or bfloat16 ``f2v_t``).  Mapped over
    an instance axis (one span table for every instance) it is one launch
    for the batch (``ell_fan_in_batched``)."""
    _host_or_card((unary_t, f2v_t), "ell_fan_in")
    return _fan_in_op([v for span in spans for v in span], unary_t, f2v_t)


def _pairs(flat: List[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple(zip(flat[0::2], flat[1::2]))


@torch.library.custom_op(f"{_OPS}::ell_fan_in", mutates_args=())
def _fan_in_op(
    spans: List[int], unary_t: torch.Tensor, f2v_t: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    if unary_t.device.type == "cpu":
        tot, v2f = ell_fan_in_plain(_pairs(spans), unary_t, f2v_t)
        return _fresh(tot, unary_t, f2v_t), v2f
    return _launch_fan_in(_pairs(spans), unary_t, f2v_t, unary_t.device)


@_fan_in_op.register_vmap
def _fan_in_vmap(info, in_dims, spans, unary_t, f2v_t):
    _, unary_t, f2v_t = _batch_first(
        info.batch_size, in_dims, (spans, unary_t, f2v_t)
    )
    return ell_fan_in_batched(_pairs(spans), unary_t, f2v_t), (0, 0)


def ell_fan_in_batched(
    spans: Tuple[Tuple[int, int], ...],
    unary_t: torch.Tensor,  # [K, D, V]
    f2v_t: torch.Tensor,  # [K, D, n_pad]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ell_fan_in`` of K instances of one span table stacked on a
    leading axis, each its solo call's: on CPU tensors the plain version
    of each instance, on CUDA tensors one launch for the batch
    (a row of a class is (instance, d, slot))."""
    device = _host_or_card((unary_t, f2v_t), "ell_fan_in")
    if device.type == "cpu":
        return _per_instance(
            lambda u, f: ell_fan_in_plain(spans, u, f), unary_t, f2v_t
        )
    return _launch_fan_in(spans, unary_t.contiguous(), f2v_t.contiguous(),
                          device, batched=True)


# plane, d, n_pad, u, n_vars, n_inst, n_classes, spans, tot, v2f, scratch,
# tickets, stream
_FAN_IN_BATCHED_ARGS = (_P, ctypes.c_int, _LL, _P, _LL, _LL, ctypes.c_int,
                        _P, _P, _P) + _SCRATCH + (_P,)


def _launch_fan_in(spans, unary_t, f2v_t, device, batched=False,
                   library=None):
    """``(tot, v2f_raw)`` (see ``_tree_launch`` for ``library``)."""
    lead = tuple(f2v_t.shape[:1]) if batched else ()
    k = lead[0] if batched else 1
    d, n_pad = f2v_t.shape[-2:]
    n_vars = unary_t.shape[-1]
    _check(f2v_t, "f2v_t", _PLANE_DTYPES, lead + (d, n_pad), device)
    _check(unary_t, "unary_t", torch.float32, lead + (d, n_vars), device)
    segments = [(db, k * d * nb) for nb, db in spans]
    variant = _PLANE_VARIANT[f2v_t.dtype]
    fn, scratch, tickets = _tree_launch(
        "_ell_fan_in" + variant + ("_batched" if batched else ""),
        _FAN_IN_BATCHED_ARGS if batched else _FAN_IN_ARGS, device, segments,
        library=library,
    )
    tot = unary_t.new_empty(lead + (d, n_vars))
    v2f = unary_t.new_empty(lead + (d, n_pad))
    inst = (k,) if batched else ()
    _run(fn, device, "ell_fan_in", f2v_t.data_ptr(), d, n_pad,
         unary_t.data_ptr(), n_vars, *inst, len(spans),
         _span_table(tuple(spans)), tot.data_ptr(), v2f.data_ptr(),
         *_scratch_args(scratch, tickets), batched=batched,
         count=library is None)
    return tot, v2f


# ---------------------------------------------------------------------------
# branch_bound: the depth-first search of SyncBB and NCBB
# ---------------------------------------------------------------------------

#: DFS steps the plain version advances between looks at the depth (the JAX
#: loop's _WHILE_CHUNK)
BB_CHUNK = 256
# the shared memory one block of the card can have (227 KB)
_MAX_SHARED_BYTES = 232_448


def _bb_step_plain(ops, s, max_iters: int):
    """One masked DFS step of ``_bb_loop`` (a dead step, past the end or
    the step cap, keeps the state).  Only the candidate's attachment sum
    decides; it is summed over the slots in XLA's order
    (:func:`xla_tree_sum_plain`)."""
    unary, dsize, att_table, att_other, att_mask, lb_suffix = ops
    depth, ptr, assign, cost_prefix, ub, best, iters = s
    n, d = unary.shape
    k = att_table.shape[1]
    live = (depth >= 0) & (iters < max_iters)
    row = depth.clamp(min=0).view(1)
    v = ptr[row][0]
    exhausted = v >= dsize[row][0]
    other_vals = assign[att_other[row][0].long()].long()
    picked = att_table[row][0][torch.arange(k, device=v.device), other_vals]
    summed = xla_tree_sum_plain(
        torch.where(att_mask[row][0][:, None], picked, 0.0).T
    )
    delta = unary[row][0] + summed
    cost_new = cost_prefix[row][0] + delta[v.clamp(max=d - 1).view(1)][0]
    feasible = ~exhausted & (cost_new + lb_suffix[row + 1][0] < ub)
    is_last = row[0] == n - 1
    here = torch.arange(n, device=v.device) == row
    ptr = torch.where(here, torch.where(exhausted, 0, v + 1), ptr)
    assign = torch.where(here & feasible, v, assign)
    cost_prefix = torch.where(
        (torch.arange(n + 1, device=v.device) == row + 1) & feasible,
        cost_new, cost_prefix,
    )
    improved = feasible & is_last
    ub = torch.where(improved, cost_new, ub)
    best = torch.where(improved, assign, best)
    depth_new = torch.where(
        exhausted, depth - 1,
        torch.where(feasible & ~is_last, depth + 1, depth),
    )
    new = (depth_new, ptr, assign, cost_prefix, ub, best, iters + 1)
    return tuple(torch.where(live, b, a) for a, b in zip(s, new))


def branch_bound_plain(
    unary: torch.Tensor,  # [n, D] float32 unary costs by position
    dsize: torch.Tensor,  # [n] int32 domain sizes by position
    att_table: torch.Tensor,  # [n, K, D, D] float32 (slot, other, own)
    att_other: torch.Tensor,  # [n, K] int32 position of the earlier var
    att_mask: torch.Tensor,  # [n, K] bool
    lb_suffix: torch.Tensor,  # [n + 1] float32 bound on the tail's cost
    ub0: torch.Tensor,  # float32 scalar: the initial upper bound
    best0: torch.Tensor,  # [n] int32 assignment achieving ub0 (or zeros)
    max_iters: int,
    should_stop: Optional[Callable[[], bool]] = None,
) -> torch.Tensor:
    """The DFS of ``_bb_loop`` as PyTorch ops: steps in chunks of
    ``BB_CHUNK``, the depth read by the host between chunks, where a
    true ``should_stop()`` also ends the search, incomplete, as a step
    cap leaves it.  Returns the int32 vector ``[best by position | ub's
    float32 bits | steps | complete]``."""
    n = unary.shape[0]
    dev = unary.device
    ops = (unary, dsize, att_table, att_other, att_mask, lb_suffix)
    s = (
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros(n + 1, dtype=torch.float32, device=dev),
        ub0.to(torch.float32),
        best0.to(torch.int32),
        torch.zeros((), dtype=torch.int64, device=dev),
    )
    while True:
        for _ in range(BB_CHUNK):
            s = _bb_step_plain(ops, s, max_iters)
        if not (int(s[0]) >= 0 and int(s[6]) < max_iters):
            break
        if should_stop is not None and should_stop():
            break
    depth, _, _, _, ub, best, iters = s
    return torch.cat([
        best, ub.reshape(1).view(torch.int32),
        iters.to(torch.int32).reshape(1),
        (depth < 0).to(torch.int32).reshape(1),
    ])


# unary, dsize, att_table, att_other, att_mask, lb_suffix, ub0, best0, out,
# n, k, d, max_iters, tables_shared, stream
_BRANCH_BOUND_ARGS = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,
)


def _bb_shared_bytes(
    library: ctypes.CDLL, n: int, k: int, d: int, tables_shared: bool
) -> int:
    fn = library.branch_bound_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(n, k, d, int(tables_shared))


def launch_branch_bound(
    library: ctypes.CDLL, tensors: tuple, max_iters: int
) -> torch.Tensor:
    """One launch of ``branch_bound_launch`` of ``library`` (a build of
    ``csrc/branch_bound.cu``) on checked CUDA operands, on the current
    stream: the attachment tables in shared memory when they fit.
    Returns the output vector (``steps = -1``: misoriented attachments,
    see :func:`branch_bound`); counts nothing."""
    unary, att_table = tensors[0], tensors[2]
    n, d = unary.shape
    k = att_table.shape[1]
    shared = _bb_shared_bytes(library, n, k, d, True) <= _MAX_SHARED_BYTES
    if not shared and (
        _bb_shared_bytes(library, n, k, d, False) > _MAX_SHARED_BYTES
    ):
        raise ValueError(
            f"branch_bound: the search state of {n} variables does not fit "
            "in one block's shared memory"
        )
    fn = library.branch_bound_launch
    fn.argtypes = list(_BRANCH_BOUND_ARGS)
    fn.restype = ctypes.c_int
    out = torch.empty(n + 3, dtype=torch.int32, device=unary.device)
    with torch.cuda.device(unary.device):
        rc = fn(
            *(t.data_ptr() for t in tensors), out.data_ptr(), n, k, d,
            max_iters, int(shared),
            torch.cuda.current_stream(unary.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"branch_bound launch failed: error {rc}")
    return out


def branch_bound(
    unary: torch.Tensor,
    dsize: torch.Tensor,
    att_table: torch.Tensor,
    att_other: torch.Tensor,
    att_mask: torch.Tensor,
    lb_suffix: torch.Tensor,
    ub0: torch.Tensor,
    best0: torch.Tensor,
    max_iters: int,
    should_stop: Optional[Callable[[], bool]] = None,
) -> torch.Tensor:
    """The whole depth-first branch and bound over variables in a fixed
    order: the steps of ``_bb_loop`` until the search is complete or
    ``max_iters`` steps ran.  On CPU tensors this is
    :func:`branch_bound_plain` (``should_stop`` as its); on CUDA tensors
    one launch of
    ``csrc/branch_bound.cu`` (one warp searching, a position's candidate
    row computed once a visit; the attachment tables in shared memory
    when they fit) on the current stream.  Returns the int32 vector
    ``[best by position | ub's float32 bits | steps | complete]``.

    The kernel takes attachments oriented as ``_build_attachments``
    orients them: every slot of position ``p`` with ``att_mask`` set
    names an earlier position (``0 <= att_other[p, k] < p``).  It
    refuses other operands by returning the seed (``best0``, ``ub0``'s
    bits) with ``steps = -1``, which ``branch_and_bound`` raises on; the
    plain version has no such bound."""
    tensors = (unary, dsize, att_table, att_other, att_mask, lb_suffix,
               ub0, best0)
    if all(t.device.type == "cpu" for t in tensors):
        return branch_bound_plain(*tensors, max_iters, should_stop)
    device = _on_cuda(tensors, "branch_bound")
    n, d = unary.shape
    k = att_table.shape[1]
    _check(unary, "unary", torch.float32, (n, d), device)
    _check(dsize, "dsize", torch.int32, (n,), device)
    _check(att_table, "att_table", torch.float32, (n, k, d, d), device)
    _check(att_other, "att_other", torch.int32, (n, k), device)
    _check(att_mask, "att_mask", torch.bool, (n, k), device)
    _check(lb_suffix, "lb_suffix", torch.float32, (n + 1,), device)
    _check(ub0, "ub0", torch.float32, (), device)
    _check(best0, "best0", torch.int32, (n,), device)
    if not 0 <= max_iters < 2 ** 31:
        raise ValueError(f"max_iters {max_iters} does not fit in int32")
    if k > XLA_WINDOW * XLA_WINDOW:
        raise ValueError(
            f"branch_bound takes at most {XLA_WINDOW ** 2} attachments a "
            f"position, got {k}"
        )
    out = launch_branch_bound(_library("branch_bound"), tensors, max_iters)
    _count_launch(branch_bound)
    return out


branch_bound.launches = 0
