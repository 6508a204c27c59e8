"""The cycle engine shared by the solvers.

Counterpart of ``pydcop_tpu/algorithms/base.py``: ``run_cycles`` with
the semantics of ``_fused_core``/``_solve_fused`` (the whole solve, one
read-back) and of ``_while_chunk`` and its timeout chunks.  A solver is a
pair of functions ``init(dev, key, *consts) -> state`` and
``step(dev, state, key, *consts) -> state`` that the engine advances once
per synchronous cycle of the whole multi-agent system:

- tie-breaking noise is added to the unary plane first (one threefry draw
  of shape ``(n_vars, D)`` from the solve key ``PRNGKey(seed)``);
- ``init`` gets the solve key; cycle ``c`` (absolute, 0-based) gets
  ``fold_in(fold_in(key, 1), c)``, so a run in chunks follows the same
  trajectory as a whole one;
- the anytime best starts at the initial assignment and moves on a strict
  ``<`` improvement, with a 1-based ``best_cycle``;
- with a ``convergence`` test (and no curve), an iteration is live while
  ``(i < n_cycles) & (stable < same_count)``: the solve stops stepping
  once ``same_count`` consecutive cycles were stable;
- ``timeout`` runs chunks of ``TIMEOUT_CHUNK`` cycles growing to
  ``MAX_CHUNK``, with the clock read between chunks.

The loop is masked, as ``_while_chunk``'s: every iteration runs the step,
and a dead one keeps the old carry with ``torch.where`` (the masked form
of its ``lax.cond``).  One chunk of ``L`` iterations is one function of
the carry.  On the card, the solve's prologue (noise, init, first
evaluation) and the chunk are each captured once into a CUDA graph per
(problem, solver, params, ``L``), cached on the compiled problem; a solve
writes its key and cycle budget into the graphs' input buffers and
replays them, and a chunk's output carry is its next replay's input,
with no host round trip.  Between replays the host reads back the cycles
run and the stability counter only at growing intervals (after 16, 48,
112, ... cycles), so a solve pays O(log n_cycles) host syncs, then one
read-back of the packed result.  A warm solve captures nothing.  On the
CPU the same prologue and chunk run eagerly: both devices run the same
masked arithmetic, so they follow one trajectory.

``run_cycles`` counts, as the kernels count their launches, its graph
captures, chunk replays, the iterations those replays ran (live or
masked), its host syncs and the carries it copied to the host for a
checkpoint in attributes (``captures``, ``replays``, ``iterations``,
``host_syncs``, ``snapshots``).

Health telemetry (``telemetry/pulse.py``): while ``pulse.enabled``, a
solver's ``health`` hook runs inside the chunk, and every live iteration
writes one ``HEALTH_WIDTH`` row (``_health_vec``: cost, best cost,
flips, churn, flipback, the hook's residual and aux, violations) and
advances the flip counters of the carry (``PulseCarry``).  The rows ride
the reads the engine already makes: the looks between chunks and the
packed read-back, so a solve makes as many host syncs with pulse on as
off.  With pulse off the graphs are the ones captured without it.

Durable solves (``durability/manager.py``): while the ``durability``
singleton holds a manager, the host looks after every chunk; the
manager's cycle boundaries are written into the graph's cycle budget, so
the iterations past a boundary are masked, and at a boundary the carry
is copied to the host in one read and written as the JAX package's
checkpoint leaves (``CarryIO``).  A resume runs the prologue, copies the
stored carry into the carry the chunk reads (the graphs' own buffers on
the card) and sets its cycle: per-cycle keys are functions of the
absolute cycle, so it continues the uninterrupted run's trajectory bit
for bit, on either device and from either package's checkpoint.

``run_batch`` runs K solves of one shape (the serving layer's bucket)
as one: the same prologue and chunk mapped over a leading instance axis
with ``torch.func.vmap`` (``_map_instances``), each instance its own key,
noise level, cycle budget and real rows; the kernel wrappers' vmap rules
launch each kernel once for the batch.  The batch runs until every
instance has stopped, and each instance's result is the bits of the same
solve alone.

Window spans (``telemetry/tracing.py``, ``metrics.py``): while the
tracer or the metrics registry is on, every readback window records a
``solve.window`` span (``cat="device"``: ``kind``, ``phase``, ``offset``,
``cycles``) and the metrics ``solve.windows``, ``solve.device_cycles`` and
``device.chunk_ms``, and the packed read-back a ``solve.readback`` span
with ``solve.readback_bytes`` and ``solve.readback_seconds``: the JAX
package's names and fields.  A window ends at a host sync the engine
makes anyway, so the port's windows follow its own looks (after 16, 48,
112, ... cycles, then the read-back; ``kind="chunk"``), not the JAX
package's one fused window a solve; a batch is one window
(``kind="batch"``).  The windows' ``cycles`` sum to the cycles run.

Profiling (``telemetry/profiling.py``): each runner build is a compile
of the capture census (``cached_runner``, labels ``solve.run_cycles`` and
a batch's ``serve.run_batch``; on the CPU the first solve of a key) and
each reuse a hit.  While a profiler session is live, a solve without
timeout or durability replays under a ``solve.{algo}.fused`` annotation,
the others' runs of replays under ``solve.{algo}.chunk``, and the
read-back under ``solve.{algo}.readback``; with ``--dump-hlo`` on,
``_capture`` writes each fresh graph as DOT.

A resident session (``maxsum_dynamic.DynamicMaxSum``) runs the engine
again and again on the same problem: it resumes from its own state, which
it passes as a constant, and hands the same tensors in as ``state_into``,
into which ``run_cycles`` copies the final state.  The session keeps its
state, its tables and its unary plane in tensors it owns and refreshes
them in place (``assign_``), so its graphs are keyed by the same tensors
on every run and a warm run captures nothing.  A solve without
``state_into`` copies no state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..compile import hopper_kernels
from ..utils.solve_control import (
    is_auxiliary,
    second_solve_live,
    stop_requested,
)
from ..compile.core import CompiledDCOP
from ..compile.kernels import (
    DeviceDCOP,
    evaluate,
    local_costs,
    take_rows,
    to_device,
    violation_count,
    xla_sum,
)
from ..durability.manager import CheckpointManager, durability
from ..random import PRNGKey, fold_in, uniform
from ..telemetry.memplane import memguard, sample_device_memory
from ..telemetry.metrics import metrics_registry
from ..telemetry.profiling import (
    count_hit,
    device_annotation,
    dump_graph,
    profiled_build,
    profiling,
)
from ..telemetry.pulse import HEALTH_FIELDS, HEALTH_WIDTH, pulse
from ..telemetry.tracing import tracer
from . import SolveResult

__all__ = [
    "TIMEOUT_CHUNK", "MAX_CHUNK", "apply_noise", "assign_", "cached_const",
    "run_batch", "run_cycles", "finalize", "extract_values",
    "neighbor_pairs_dev", "pad_rows_np", "PulseCarry", "gain_health",
    "CarryIO", "field_io", "device_problem", "cached_runner",
]

# chunk schedule: start small for early clock granularity, grow
# geometrically so a long run pays O(log n) host syncs
TIMEOUT_CHUNK = 16
MAX_CHUNK = 1024
#: chunk replays a solve keeps queued on the card while a second solve
#: runs beside it (``solve_control.second_solve``: the agent runtime's
#: repairs).  A run of chunks between looks is up to MAX_CHUNK cycles;
#: queued whole, it keeps the solve's thread inside its graph launches
#: and the repair's thread stalled behind it for seconds.  Past this
#: many, a replay first waits for the oldest to finish, in
#: ``Event.synchronize``, which lets go of the interpreter's lock; the
#: replays still queued keep the card busy meanwhile.  A solve alone is
#: not paced.
REPLAYS_IN_FLIGHT = 4

# the telemetry handles, created once at import (the JAX package's names)
_m_windows = metrics_registry.counter(
    "solve.windows", "device readback windows"
)
_m_device_cycles = metrics_registry.counter(
    "solve.device_cycles", "solver cycles advanced on device"
)
_m_readback_bytes = metrics_registry.counter(
    "solve.readback_bytes", "device->host result bytes read back"
)
_m_readback_seconds = metrics_registry.histogram(
    "solve.readback_seconds", "device->host readback latency"
)
# the anytime best and the cycle it was first seen at: published at every
# look that improves it (the look reads them with the cycles run, no
# extra sync) and once with the final values
_m_best_cost = metrics_registry.gauge(
    "solve.best_cost", "anytime best (internal minimization) cost so far"
)
_m_cycles_to_best = metrics_registry.gauge(
    "solve.cycles_to_best",
    "1-based cycle at which the best cost was first attained, tracked on "
    "device on every path (0 = the initial assignment was never improved)",
)
_m_chunk_ms = metrics_registry.histogram(
    "device.chunk_ms",
    "device window latency (dispatch to host sync) per chunk, ms",
    buckets=(0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
             1000.0, 5000.0, 10000.0),
)


# shared reentrant no-op for the annotation-off path
_NO_ANN = contextlib.nullcontext()


def _telemetry_on() -> bool:
    return tracer.enabled or metrics_registry.enabled


def _record_window(
    kind: str, phase: str, offset: int, cycles: int, t0: float, t1: float,
    device=None,
) -> None:
    """One readback window: the device cycles between two host syncs,
    attributed to the solver's ``phase``, and a live memory sample of
    ``device`` riding that sync.  The caller checked that telemetry is
    on."""
    tracer.complete(
        "solve.window", t0, t1 - t0, cat="device",
        kind=kind, phase=phase, offset=offset, cycles=cycles,
    )
    _m_windows.inc()
    _m_device_cycles.inc(cycles)
    _m_chunk_ms.observe((t1 - t0) * 1e3, phase=phase, kind=kind)
    sample_device_memory("chunk" if kind == "chunk" else "solve_end", device)


def _record_readback(nbytes: int, t0: float, t1: float) -> None:
    """One device->host read-back: its latency and bytes."""
    tracer.complete(
        "solve.readback", t0, t1 - t0, cat="device", bytes=nbytes
    )
    _m_readback_bytes.inc(nbytes)
    _m_readback_seconds.observe(t1 - t0)


def extract_values(dev: DeviceDCOP, state) -> torch.Tensor:
    """Default ``extract``: the solver state's ``values`` field."""
    return state.values


def cached_const(compiled, key: Tuple, build: Callable[[], Any]):
    """Per-compiled-problem cache of solver constants (host layouts,
    device-resident operands and captured graphs): a warm solve rebuilds,
    uploads and captures nothing.  ``key`` must include every input the
    built value depends on beyond the compiled problem itself (params,
    the device)."""
    cache = compiled.__dict__.setdefault("_device_consts", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def cached_runner(home, key: Tuple, label: str, build: Callable[[], Any],
                  device=None,
                  argument_bytes: Optional[Callable[[Any], int]] = None):
    """``cached_const`` for an entry point's runner (captured graphs, or
    the marker of a key the CPU has run), counted in the capture census
    under ``label`` (``telemetry/profiling.py``): a build is a compile, a
    reuse a hit."""
    cache = home.__dict__.setdefault("_device_consts", {})
    if key in cache:
        count_hit(label)
        return cache[key]
    cache[key] = profiled_build(label, build, device, argument_bytes)
    return cache[key]


def _tensor_bytes(tensors) -> int:
    """The bytes of the distinct tensors among ``tensors``."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            seen[id(t)] = t.numel() * t.element_size()
    return sum(seen.values())


def device_problem(
    compiled, device, algo: str, params: Optional[Dict] = None,
    n_cycles: int = 64, collect_curve: bool = False,
) -> DeviceDCOP:
    """``compiled`` on ``device``, uploaded once and cached on the
    problem, after the memory guard's check (``telemetry/memplane.py``):
    a solve the guard refuses has put nothing on the device."""
    if memguard.enabled:
        memguard.check(
            compiled, algo, params, n_cycles=n_cycles,
            pulse_on=pulse.enabled, collect_curve=collect_curve,
            device=device,
        )
    return cached_const(
        compiled, ("dev", str(device)), lambda: to_device(compiled, device)
    )


def neighbor_pairs_dev(compiled, device) -> Tuple[torch.Tensor, ...]:
    """``(src, dst)``: the directed neighbour pairs on ``device`` (int64,
    sorted by ``src``), cached per problem under one key that MGM and
    MGM-2 share."""

    def build():
        return tuple(
            torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
            for a in compiled.neighbor_pairs()
        )

    return cached_const(compiled, ("neighbor_pairs_dev", str(device)), build)


def pad_rows_np(arr: np.ndarray, n: int, value) -> np.ndarray:
    """Pad a host array's leading axis to ``n`` rows with ``value``."""
    arr = np.asarray(arr)
    if arr.shape[0] >= n:
        return arr
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], value, dtype=arr.dtype)
    return np.concatenate([arr, pad])


# ---------------------------------------------------------------------------
# Carries as trees of tensors (dataclasses, named tuples and tuples)
# ---------------------------------------------------------------------------


def _flatten(tree, out: List) -> List:
    """The leaves of ``tree`` in order: tensors and plain values."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), out)
    elif isinstance(tree, tuple):
        for x in tree:
            _flatten(x, out)
    else:
        out.append(tree)
    return out


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in order, from the iterator
    ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, tuple):
        items = [_unflatten(x, leaves) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return next(leaves)


def _select(live: torch.Tensor, new, old):
    """``new`` where ``live``, else ``old``, leaf by leaf; a leaf the step
    passed through unchanged is kept as is."""
    out = []
    for n, o in zip(_flatten(new, []), _flatten(old, [])):
        if n is o:
            out.append(o)
        elif isinstance(n, torch.Tensor):
            out.append(torch.where(live, n, o))
        elif n == o:
            out.append(o)
        else:
            raise TypeError(
                "a solver state leaf that changes from cycle to cycle must "
                f"be a tensor, got {type(n).__name__}"
            )
    return _unflatten(old, iter(out))


# ---------------------------------------------------------------------------
# Health telemetry: the per-cycle health vector, computed on the device
# ---------------------------------------------------------------------------


class PulseCarry(NamedTuple):
    """The carry of the health telemetry: the two previous value planes
    feed the flip and flipback fields, the per-variable flip counters the
    frozen-vs-churning summary.  ``None`` stands for it with pulse off."""

    prev: torch.Tensor  # [n_vars] int32 values one cycle back
    prev2: torch.Tensor  # [n_vars] int32 values two cycles back
    flips: torch.Tensor  # [n_vars] int32 flips of each variable so far


def _pulse_carry0(vals: torch.Tensor) -> PulseCarry:
    """The pulse carry of the initial assignment (cycle 0)."""
    v0 = vals.to(torch.int32)
    return PulseCarry(prev=v0, prev2=v0, flips=torch.zeros_like(v0))


def _health_vec(
    dev: DeviceDCOP, pc: PulseCarry, new_vals: torch.Tensor,
    cost: torch.Tensor, best_cost: torch.Tensor,
    residual_aux: torch.Tensor,
) -> Tuple[torch.Tensor, PulseCarry]:
    """One cycle's health vector (float32 ``[HEALTH_WIDTH]``, in the order
    of ``HEALTH_FIELDS``) and the advanced pulse carry: reductions over
    planes the step already made.  ``residual_aux`` is the solver hook's
    two values.  Single-value rows can never flip: they are not live."""
    live = dev.domain_size > 1
    new_vals = new_vals.to(torch.int32)
    flipped = (new_vals != pc.prev) & live
    n_flips = flipped.sum().to(torch.float32)
    n_live = torch.clamp(live.sum(), min=1).to(torch.float32)
    flipback = (
        ((new_vals == pc.prev2) & flipped).sum().to(torch.float32)
        / torch.clamp(n_flips, min=1.0)
    )
    vec = torch.cat([
        torch.stack([
            cost.to(torch.float32), best_cost.to(torch.float32), n_flips,
            n_flips / n_live, flipback,
        ]),
        residual_aux.to(torch.float32).reshape(-1),
        violation_count(dev, new_vals).to(torch.float32).reshape(1),
    ])
    return vec, PulseCarry(
        prev=new_vals, prev2=pc.prev,
        flips=pc.flips + flipped.to(torch.int32),
    )


def gain_health(dev: DeviceDCOP, old_state, new_state) -> torch.Tensor:
    """The health hook of the local-search solvers (DSA, A-DSA, DSA-tuto,
    MGM, MGM-2, MixedDSA): residual = the largest local gain any variable
    still has (0 at a local optimum), aux = the mean gain over the live
    variables, summed in XLA's order (``xla_sum``)."""
    costs = local_costs(dev, new_state.values)
    cur = take_rows(costs, new_state.values[:, None])[:, 0]
    best = torch.where(dev.valid_mask, costs, torch.inf).amin(dim=-1)
    live = dev.domain_size > 1
    gain = torch.where(live, cur - best, 0.0)
    n_live = torch.clamp(live.sum(), min=1).to(torch.float32)
    return torch.stack([
        gain.max().to(torch.float32),
        xla_sum(gain).to(torch.float32) / n_live,
    ])


# ---------------------------------------------------------------------------
# Checkpoints: a solver's state as the JAX package's leaves
# ---------------------------------------------------------------------------


class CarryIO(NamedTuple):
    """How a solver's state is written as checkpoint leaves and read back,
    in the JAX package's on-disk form: ``save(state, consts)`` gives the
    leaves of JAX's state in its order, dtypes and orientation (its
    static companions included); ``load(state, leaves)`` gives ``state``,
    a freshly initialized one, with its dynamic fields taken from such
    leaves (on ``state``'s device) and its static companions kept, built
    from the problem and not from the file."""

    save: Callable[[Any, Tuple], List[torch.Tensor]]
    load: Callable[[Any, List[torch.Tensor]], Any]


def _jax_dtype(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the JAX package holds it: 64-bit integers as int32 (its
    x64 mode is off)."""
    return x.to(torch.int32) if x.dtype == torch.int64 else x


def field_io(*fields: str) -> CarryIO:
    """The ``CarryIO`` of a named-tuple state whose leaves are JAX's, but
    for 64-bit integers: the dynamic ``fields`` are restored, every other
    field is kept."""

    def save(state, consts) -> List[torch.Tensor]:
        return [_jax_dtype(x) for x in _flatten(state, [])]

    def load(state, leaves):
        it = iter(leaves)
        out = {}
        for name in state._fields:
            sub = _flatten(getattr(state, name), [])
            got = [next(it) for _ in sub]
            if name in fields:
                out[name] = _unflatten(getattr(state, name), iter([
                    g.to(device=t.device, dtype=t.dtype)
                    for g, t in zip(got, sub)
                ]))
        return state._replace(**out)

    return CarryIO(save, load)


def _phase_of(step: Callable) -> str:
    """A solver's label in checkpoint manifests and health metadata: the
    last component of its step function's module (``maxsum``, ``dsa``,
    ...), as the JAX package's."""
    mod = getattr(step, "__module__", None) or "solve"
    return mod.rsplit(".", 1)[-1]


def _host_copy(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """CPU copies of ``tensors``, read from their device in one transfer
    (their bytes laid end to end)."""
    if not tensors:
        return []
    flat = [
        t.detach().contiguous().reshape(-1).view(torch.uint8)
        if t.numel() else torch.empty(0, dtype=torch.uint8, device=t.device)
        for t in tensors
    ]
    buf = torch.cat(flat).cpu()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        out.append(buf[off:off + n].clone().view(t.dtype).reshape(t.shape))
        off += n
    return out


# ---------------------------------------------------------------------------
# The solve as two functions of device tensors: prologue and chunk
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Solver:
    """What a solve runs, fixed for its captured graphs."""

    init: Callable
    step: Callable
    extract: Callable
    convergence: Optional[Callable]
    same_count: int
    collect_curve: bool
    has_noise: bool
    length: int  # iterations per chunk
    # the noise draw's rows when they are not the device problem's own
    # (the serving layer's bucket rows); rows from the solve's n_real on
    # are then zeroed
    noise_draw: Optional[int] = None
    # the prologue and chunk run mapped over a leading instance axis of
    # every tensor (the serving layer's batches)
    batched: bool = False
    # the solver's health hook ``health(dev, old_state, new_state) ->
    # float32[2]`` while pulse is on, else None: the graphs of a solve
    # with pulse off are the ones captured without it
    health: Optional[Callable] = None

    @property
    def use_stability(self) -> bool:
        return self.convergence is not None and not self.collect_curve


@dataclasses.dataclass(frozen=True)
class _Carry:
    """The state one chunk hands the next."""

    unary: torch.Tensor  # the noised unary plane
    run_key: torch.Tensor  # [2] fold_in(key, 1)
    state: Any
    best_vals: torch.Tensor
    best_cost: torch.Tensor
    best_cycle: torch.Tensor  # int32, 1-based, 0 = never improved on
    stable: torch.Tensor  # int32 consecutive stable cycles
    ran: torch.Tensor  # int32 cycles run so far (absolute on a resume)
    cycle: torch.Tensor  # int64 absolute index of the next iteration
    pulse: Optional[PulseCarry] = None  # with a health hook


def _noised(
    dev: DeviceDCOP, key, level, n_real=None, n_draw: Optional[int] = None
) -> DeviceDCOP:
    """Add ``level * uniform`` tie-breaking noise to the valid slots of the
    unary plane (the reference's VariableNoisyCostFunc).

    ``n_draw`` is the draw's row count, which picks the stream: by default
    the device problem's own rows.  The serving layer passes its bucket's
    row count, one draw shape for every instance of a batch, and
    ``n_real`` (an int64 tensor, per instance in a batch) zeroes the
    rows from ``n_real`` on, so an instance draws the same bits batched
    and alone (``serve.solve_one``)."""
    rows = dev.n_vars if n_draw is None else int(n_draw)
    device = dev.unary.device
    draw = uniform(key, (rows, dev.max_domain), device=device)
    live = dev.valid_mask[:rows]
    if n_real is not None:
        live = live & (
            torch.arange(rows, device=device)[:, None] < n_real
        )
    noise = torch.where(live, draw * level, 0.0)
    if dev.n_vars > rows:
        noise = torch.cat([
            noise, noise.new_zeros((dev.n_vars - rows, dev.max_domain))
        ])
    return dataclasses.replace(dev, unary=dev.unary + noise)


def apply_noise(
    compiled: CompiledDCOP, dev: DeviceDCOP, seed: int, level: float,
    n_draw: Optional[int] = None,
) -> DeviceDCOP:
    """``dev`` with the tie-breaking noise of a ``seed`` added to its unary
    plane, eagerly: the same draw, and the same bits, as ``run_cycles``
    adds in its prologue for ``noise=level`` and ``noise_draw=n_draw`` (a
    resident session noises once, then runs the engine without noise).
    ``compiled`` is the problem ``dev`` was made from (``dev`` may be
    padded past it); the draw has its ``n_vars`` rows unless ``n_draw``
    says otherwise, and rows past its ``n_vars`` draw no noise."""
    if not level:
        return dev
    if dev.n_vars < compiled.n_vars:
        raise ValueError(
            f"dev has {dev.n_vars} variables, the problem {compiled.n_vars}"
        )
    device = dev.unary.device
    return _noised(
        dev, torch.tensor(PRNGKey(seed), dtype=torch.int64, device=device),
        torch.tensor(level, dtype=torch.float32, device=device),
        torch.tensor(compiled.n_vars, dtype=torch.int64, device=device),
        compiled.n_vars if n_draw is None else n_draw,
    )


def assign_(dst, src) -> None:
    """Copy every tensor of the tree ``src`` into the tensor at the same
    place of ``dst``, in place: a resident session's refresh, which keeps
    the tensors its captured graphs read.  The trees must have the same
    structure, shapes and dtypes; other leaves must be equal."""
    dst_leaves, src_leaves = _flatten(dst, []), _flatten(src, [])
    if len(dst_leaves) != len(src_leaves):
        raise ValueError(
            f"{len(src_leaves)} leaves do not fit {len(dst_leaves)}"
        )
    for d, s in zip(dst_leaves, src_leaves):
        if isinstance(d, torch.Tensor):
            if (
                not isinstance(s, torch.Tensor)
                or d.shape != s.shape or d.dtype != s.dtype
            ):
                raise ValueError(
                    f"{getattr(s, 'shape', s)} does not fit the tensor of "
                    f"shape {tuple(d.shape)} and dtype {d.dtype}"
                )
            if d is not s:
                d.copy_(s)
        elif d != s:
            raise ValueError(f"{s!r} does not fit {d!r}")


def _prologue(
    solver: _Solver, dev: DeviceDCOP, consts: Tuple, key: torch.Tensor,
    level: torch.Tensor, n_real: torch.Tensor,
) -> _Carry:
    """Noise, init and the initial assignment's cost: the carry of cycle
    0.  ``key`` is the solve key as a [2] int64 tensor; ``n_real`` the
    real rows of a ``noise_draw`` solve."""
    if solver.has_noise:
        dev = _noised(
            dev, key, level,
            None if solver.noise_draw is None else n_real, solver.noise_draw,
        )
    unary = dev.unary
    state = solver.init(dev, key, *consts)
    vals = solver.extract(dev, state)
    zero = torch.zeros((), dtype=torch.int32, device=unary.device)
    return _Carry(
        unary=unary, run_key=fold_in(key, 1), state=state, best_vals=vals,
        best_cost=evaluate(dev, vals), best_cycle=zero, stable=zero,
        ran=zero, cycle=torch.zeros((), dtype=torch.int64,
                                    device=unary.device),
        pulse=None if solver.health is None else _pulse_carry0(vals),
    )


def _chunk(
    solver: _Solver, dev: DeviceDCOP, consts: Tuple, carry: _Carry,
    n_limit: torch.Tensor, length: int,
) -> Tuple[_Carry, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``length`` masked iterations from ``carry``: the body of
    ``_while_chunk``.  Returns the next carry, with a curve each
    iteration's cost, and with a health hook each iteration's health
    row (``[length, HEALTH_WIDTH]``; a dead iteration's row is not
    read)."""
    dev = dataclasses.replace(dev, unary=carry.unary)
    state, bv, bc, bcyc = (
        carry.state, carry.best_vals, carry.best_cost, carry.best_cycle
    )
    stable, ran, pc = carry.stable, carry.ran, carry.pulse
    cycles = carry.cycle + torch.arange(length, device=carry.cycle.device)
    keys = fold_in(carry.run_key, cycles)  # [length, 2]
    costs, rows = [], []
    for i in range(length):
        live = cycles[i] < n_limit
        if solver.use_stability:
            live = live & (stable < solver.same_count)
        new_state = solver.step(dev, state, keys[i], *consts)
        vals = solver.extract(dev, new_state)
        cost = evaluate(dev, vals)
        better = live & (cost < bc)
        bv = torch.where(better, vals, bv)
        bc = torch.where(better, cost, bc)
        bcyc = torch.where(better, (cycles[i] + 1).to(torch.int32), bcyc)
        if solver.use_stability:
            same = solver.convergence(dev, state, new_state)
            stable = torch.where(
                live, torch.where(same, stable + 1, 0), stable
            )
        if solver.health is not None:
            vec, new_pc = _health_vec(
                dev, pc, vals, cost, bc, solver.health(dev, state, new_state)
            )
            pc = _select(live, new_pc, pc)
            rows.append(vec)
        state = _select(live, new_state, state)
        ran = ran + live.to(torch.int32)
        if solver.collect_curve:
            costs.append(torch.where(live, cost, bc))
    carry = dataclasses.replace(
        carry, state=state, best_vals=bv, best_cost=bc, best_cycle=bcyc,
        stable=stable, ran=ran, cycle=carry.cycle + length, pulse=pc,
    )
    return (
        carry, torch.stack(costs) if costs else None,
        torch.stack(rows) if rows else None,
    )


def _final_values(solver: _Solver, dev: DeviceDCOP, carry: _Carry):
    """The final cycle's values of a carry (mapped over a batch's
    instances like the chunk)."""
    return solver.extract(
        dataclasses.replace(dev, unary=carry.unary), carry.state
    )


# the columns of a look's status, the packed result's last four: the
# anytime best's cycle, the cycles run, the stability counter and the
# anytime best cost (float32 bits)
_BEST_CYCLE, _RAN, _STABLE, _BEST_COST = range(4)


def _status_parts(carry: _Carry) -> List[torch.Tensor]:
    """The columns a look reads (``_BEST_CYCLE``, ``_RAN``, ``_STABLE``,
    ``_BEST_COST``), each int32 ``[..., 1]``."""
    lead = tuple(carry.best_cost.shape)

    def col(x):
        return x.reshape(lead + (1,))

    return [
        col(carry.best_cycle), col(carry.ran), col(carry.stable),
        col(carry.best_cost.to(torch.float32)).view(torch.int32),
    ]


def _pack(final: torch.Tensor, carry: _Carry) -> torch.Tensor:
    """Everything the host reads, as one int32 vector, a row an instance
    of a batch: ``[final values | best values | best_cycle | ran | stable
    | best_cost (float32 bits)]``; a look between chunks reads its last
    four columns.  Not mapped: the bit view of the cost has no vmap
    rule."""
    return torch.cat([
        final.to(torch.int32), carry.best_vals.to(torch.int32),
        *_status_parts(carry),
    ], dim=-1)


def _unpack(packed: np.ndarray, n_vars: int) -> Dict[str, Any]:
    n = n_vars
    return {
        "final": packed[:n],
        "best": packed[n:2 * n],
        "best_cycle": int(packed[2 * n]),
        "ran": int(packed[2 * n + 1]),
        "best_cost": float(packed[2 * n + 3:].view(np.float32)[0]),
    }


# ---------------------------------------------------------------------------
# Runners: the eager chunk on the CPU, captured graphs on the card
# ---------------------------------------------------------------------------


def _same(fn: Callable) -> Callable:
    return fn


def _map_instances(fn: Callable) -> Callable:
    """``fn``, a function of trees of tensors, mapped over a leading
    instance axis of every tensor leaf of its arguments
    (``torch.func.vmap``; plain values pass through, and must be the
    same for every instance).  Each instance computes what it would
    alone: a masked ``torch.where`` select of the loop stands where a
    batched ``lax.cond`` would, and every kernel wrapper carries a vmap
    rule that runs the whole batch as one launch with each instance's
    bits (``hopper_kernels``)."""

    def mapped(*trees):
        leaves = _flatten(trees, [])
        is_tensor = [isinstance(x, torch.Tensor) for x in leaves]
        seen = {}

        def one(*tensors):
            it = iter(tensors)
            out = fn(*_unflatten(trees, iter([
                next(it) if t else x for x, t in zip(leaves, is_tensor)
            ])))
            out_leaves = _flatten(out, [])
            seen["tree"] = out
            seen["leaves"] = [
                None if isinstance(x, torch.Tensor) else (x,)
                for x in out_leaves
            ]
            return tuple(
                x for x in out_leaves if isinstance(x, torch.Tensor)
            )

        tensors = iter(torch.func.vmap(one)(
            *[x for x, t in zip(leaves, is_tensor) if t]
        ))
        return _unflatten(seen["tree"], iter([
            next(tensors) if x is None else x[0] for x in seen["leaves"]
        ]))

    return mapped


class _Runner:
    """What both runners share: the prologue, chunk and pack of one
    solver on one problem, mapped over the instance axis of a batch; the
    rows (curve, health) the replays wrote since the host last looked;
    and the host's writes into the carry (a checkpoint's boundary, a
    resume)."""

    def __init__(self, solver: _Solver, dev: DeviceDCOP, consts: Tuple):
        self.solver, self.dev, self.consts = solver, dev, consts
        self.map = _map_instances if solver.batched else _same

    def _prologue(self, solve_in: torch.Tensor, level: torch.Tensor):
        """The carry of cycle 0 from ``solve_in`` ([..., 4] int64: the
        key's two words, the cycle budget, the real rows) and ``level``."""
        return self.map(functools.partial(_prologue, self.solver))(
            self.dev, self.consts, solve_in[..., :2], level,
            solve_in[..., 3],
        )

    def _chunk(self, carry: _Carry, n_limit: torch.Tensor, length: int):
        solver = self.solver
        return self.map(
            lambda dev, consts, c, n: _chunk(solver, dev, consts, c, n,
                                             length)
        )(self.dev, self.consts, carry, n_limit)

    def _pack(self, carry: _Carry) -> torch.Tensor:
        final = self.map(functools.partial(_final_values, self.solver))(
            self.dev, carry
        )
        return _pack(final, carry)

    def _begin(self) -> None:
        self.pending_curve: List[torch.Tensor] = []
        self.pending_rows: List[torch.Tensor] = []
        self.curve_parts: List[torch.Tensor] = []

    def _took(self, curve, rows) -> None:
        """Keep the rows one replay wrote (device tensors of its own)."""
        if curve is not None:
            self.pending_curve.append(curve)
        if rows is not None:
            self.pending_rows.append(rows)

    def _read(self, head: torch.Tensor, tail: List[torch.Tensor]):
        """``head`` (int32) and, behind it, the pending health rows and the
        ``tail`` tensors (int32), in one read; the pending rows are
        consumed.  Returns host arrays: head, rows (or None), tail."""
        rows = self.pending_rows
        self.pending_rows = []
        if not rows and not tail:
            return head.cpu().numpy(), None, []
        parts = [head.reshape(-1)]
        # a batch's rows are [K, length, HEALTH_WIDTH] a replay: each
        # instance's rows in cycle order
        rows = torch.cat(rows, dim=-2) if rows else None
        if rows is not None:
            parts.append(rows.reshape(-1).view(torch.int32))
        parts += [t.reshape(-1) for t in tail]
        buf = torch.cat(parts).cpu().numpy()
        k = head.numel()
        out_head, off = buf[:k].reshape(tuple(head.shape)), k
        out_rows = None
        if rows is not None:
            n = rows.numel()
            out_rows = buf[off:off + n].view(np.float32).reshape(
                tuple(rows.shape[:-2]) + (-1, HEALTH_WIDTH)
            )
            off += n
        out_tail = []
        for t in tail:
            out_tail.append(buf[off:off + t.numel()])
            off += t.numel()
        return out_head, out_rows, out_tail

    def look(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Each instance's status, ``[..., 4]`` (the columns ``_BEST_CYCLE``,
        ``_RAN``, ``_STABLE`` and ``_BEST_COST``), and the health rows
        replayed since the last look, in one read."""
        status, rows, _ = self._read(self._status(), [])
        return status, rows

    def status(self) -> np.ndarray:
        return self.look()[0]

    def result(self):
        """The packed result, the health rows not yet read and (with a
        health hook) the flip counters, in one read; and its bytes."""
        flips = [] if self.carry.pulse is None else [self.carry.pulse.flips]
        packed, rows, tail = self._read(self.packed(), flips)
        nbytes = packed.nbytes + sum(t.nbytes for t in tail) + (
            0 if rows is None else rows.nbytes)
        return packed, rows, tail[0] if tail else None, nbytes

    def keep_curve(self, n_live: int) -> None:
        """Keep the first ``n_live`` entries of the curve the replays since
        the last look wrote: the live iterations, which come first."""
        if self.pending_curve:
            self.curve_parts.append(torch.cat(self.pending_curve)[:n_live])
            self.pending_curve = []

    def curve(self) -> np.ndarray:
        return torch.cat(self.curve_parts).cpu().numpy() if (
            self.curve_parts
        ) else np.zeros(0, dtype=np.float32)

    def set_limit(self, n_limit: int) -> None:
        """Write the cycle budget the next replays read."""
        self.solve_in[..., 2].fill_(int(n_limit))

    def set_cycle(self, cycle: int) -> None:
        """Write the absolute cycle of the carry's next iteration (a tensor
        the carry owns: in place, so no graph sees a new one)."""
        self.carry.cycle.fill_(int(cycle))

    def write_carry(self, **fields) -> None:
        """Write ``fields`` of the carry (trees of tensors, on its device)
        into the carry the next chunk reads."""
        self.carry = dataclasses.replace(self.carry, **fields)


class _Eager(_Runner):
    """The prologue and chunk run as eager ops (the CPU)."""

    def start(self, solve_in: np.ndarray, level: np.ndarray) -> None:
        device = self.dev.unary.device
        self.solve_in = torch.as_tensor(solve_in, dtype=torch.int64,
                                        device=device)
        self.carry = self._prologue(
            self.solve_in,
            torch.as_tensor(level, dtype=torch.float32, device=device),
        )
        self._begin()

    def replay(self) -> None:
        self.carry, curve, rows = self._chunk(
            self.carry, self.solve_in[..., 2], self.solver.length
        )
        self._took(curve, rows)

    def packed(self) -> torch.Tensor:
        return self._pack(self.carry)

    def _status(self) -> torch.Tensor:
        return torch.cat(_status_parts(self.carry), dim=-1)

    def state(self):
        """The final solver state: this solve's own tensors."""
        return self.carry.state


class _Graphs(_Runner):
    """The prologue and the chunk of one solver on one problem, each
    captured once into a CUDA graph; a solve replays them.

    The graphs read and write static buffers allocated before capture:
    ``solve_in`` (the key's two words, the cycle budget and the real rows,
    a row an instance in a batch) and ``level`` are written by the host
    per solve, the carry buffers hold every carry tensor that is not a
    constant of the problem, ``packed`` the result, ``curve_buf`` and
    ``health_buf`` a replay's curve and health rows.  Both graphs share
    one memory pool: they never run at once."""

    def __init__(self, solver: _Solver, dev: DeviceDCOP, consts: Tuple):
        super().__init__(solver, dev, consts)
        device = dev.unary.device
        lead = tuple(dev.unary.shape[:1]) if solver.batched else ()
        self.solve_in = torch.zeros(lead + (4,), dtype=torch.int64,
                                    device=device)
        self.level = torch.zeros(lead, dtype=torch.float32, device=device)
        # the pacing's events (made at its first use) and its replays
        self._in_flight: Optional[List[torch.cuda.Event]] = None
        self._n_paced = 0
        with capture_lock:
            self._build(solver, device, lead)

    def _build(self, solver: _Solver, device, lead: Tuple) -> None:
        dev, consts = self.dev, self.consts
        fixed = {id(t) for t in _flatten((dev, consts), [])
                 if isinstance(t, torch.Tensor)}
        # warm-up off the capturing stream: lazy kernel builds, library
        # handles and the allocator's first blocks happen here, and one
        # iteration shows which state leaves the step rewrites
        with _side_stream(device):
            first = self._prologue(self.solve_in, self.level)
            after, _, _ = self._chunk(first, self.n_limit(), 1)
            self._pack(after)
        leaves = _flatten(first, [])
        moved = [a is not b for a, b in zip(_flatten(after, []), leaves)]
        # a carry tensor gets a buffer unless it is a constant of the
        # problem that the step passes through
        self.buffers = [
            torch.empty(leaf.shape, dtype=leaf.dtype, device=leaf.device)
            if isinstance(leaf, torch.Tensor)
            and (id(leaf) not in fixed or m) else None
            for leaf, m in zip(leaves, moved)
        ]
        # the carry the chunk graph reads: buffers where there are
        # buffers, the problem's constants elsewhere
        self.carry_in = _unflatten(first, iter([
            leaf if buf is None else buf
            for buf, leaf in zip(self.buffers, leaves)
        ]))
        self.carry = self.carry_in
        packed = self._pack(first)
        self.packed_buf = torch.empty(packed.shape, dtype=packed.dtype,
                                      device=device)
        self.curve_buf = torch.empty(
            solver.length, dtype=torch.float32, device=device
        )
        self.health_buf = None if solver.health is None else torch.empty(
            lead + (solver.length, HEALTH_WIDTH), dtype=torch.float32,
            device=device,
        )
        del first, after, leaves, packed

        with hopper_kernels.capture_tally() as self.launches_per_start:
            self.prologue = _capture(lambda: self._store(
                self._prologue(self.solve_in, self.level)
            ))
        with hopper_kernels.capture_tally() as self.launches_per_replay:
            self.chunk = _capture(self._run_chunk, pool=self.prologue.pool())
        run_cycles.captures += 2

    def n_limit(self) -> torch.Tensor:
        return self.solve_in[..., 2]

    def static_bytes(self) -> int:
        """The bytes of the tensors the graphs read in place: the problem,
        the constants, the solve's inputs and the carry buffers."""
        return _tensor_bytes(
            _flatten((self.dev, self.consts), [])
            + [self.solve_in, self.level]
            + [b for b in self.buffers if b is not None]
        )

    def _run_chunk(self) -> None:
        carry, curve, rows = self._chunk(
            self.carry_in, self.n_limit(), self.solver.length
        )
        self._store(carry)
        if curve is not None:
            self.curve_buf.copy_(curve)
        if rows is not None:
            self.health_buf.copy_(rows)

    def _store(self, carry: _Carry) -> None:
        """Copy ``carry`` into the buffers (inside a capture), and the
        packed result beside it."""
        for buf, leaf in zip(self.buffers, _flatten(carry, [])):
            if buf is not None and leaf is not buf:
                buf.copy_(leaf)
        self.packed_buf.copy_(self._pack(carry))

    def start(self, solve_in: np.ndarray, level: np.ndarray) -> None:
        self.solve_in.copy_(torch.as_tensor(solve_in, dtype=torch.int64))
        self.level.copy_(torch.as_tensor(level, dtype=torch.float32))
        self.prologue.replay()
        hopper_kernels.count_replay(self.launches_per_start)
        self._begin()

    def replay(self) -> None:
        self._pace()
        self.chunk.replay()
        hopper_kernels.count_replay(self.launches_per_replay)
        self._took(
            self.curve_buf.clone() if self.solver.collect_curve else None,
            None if self.health_buf is None else self.health_buf.clone(),
        )

    def _pace(self) -> None:
        """While a second solve runs, wait (the interpreter's lock free,
        the thread asleep) until fewer than ``REPLAYS_IN_FLIGHT`` replays
        are queued, then mark this one."""
        if (self.solve_in.device.type != "cuda"
                or not second_solve_live()):
            self._n_paced = 0
            return
        if self._in_flight is None:
            self._in_flight = [torch.cuda.Event(blocking=True)
                               for _ in range(REPLAYS_IN_FLIGHT)]
        event = self._in_flight[self._n_paced % REPLAYS_IN_FLIGHT]
        if self._n_paced >= REPLAYS_IN_FLIGHT:
            event.synchronize()
        self._n_paced += 1
        # recorded before the replay it paces, after the ones before it
        event.record()

    def packed(self) -> torch.Tensor:
        return self.packed_buf

    def _status(self) -> torch.Tensor:
        return self.packed_buf[..., -4:]

    def write_carry(self, **fields) -> None:
        """Copy ``fields`` into the carry buffers the chunk graph reads
        (the graphs are keyed by these tensors: never new ones), and the
        packed result of the written carry beside them."""
        for name, value in fields.items():
            assign_(getattr(self.carry_in, name), value)
        self.packed_buf.copy_(self._pack(self.carry_in))

    def state(self):
        """The final solver state: the carry buffers, which the next solve
        overwrites, and the constants it passed through."""
        return self.carry_in.state


@contextlib.contextmanager
def _side_stream(device):
    """Run the block on a fresh stream and wait for it: work before a
    capture that must not land on the capturing stream."""
    side = torch.cuda.Stream(device)
    current = torch.cuda.current_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        yield
    current.wait_stream(side)
    # the current stream, not the device: another thread's solve may keep
    # the device busy on its own stream meanwhile
    current.synchronize()


#: held by a thread while it warms up and captures graphs: the agent
#: runtime solves on two threads at once (the main solve, a repair's), and
#: one capture at a time keeps the captures' shared side stream, their
#: launch tallies and their warm-ups to one thread.  Captures run in
#: ``thread_local`` mode, so the other thread's uploads, replays and syncs
#: go on meanwhile (in ``global`` mode they would fail, or break the
#: capture); its kernels run on its own streams, and the ticket pools of
#: ``xla_tree_sum`` are a stream's own (``hopper_kernels._tickets``).
capture_lock = threading.RLock()


def _capture(body: Callable[[], None], pool=None) -> torch.cuda.CUDAGraph:
    """``body``'s device work captured into a CUDA graph (in ``pool``);
    with ``--dump-hlo`` on, in debug mode, keeping its ``cudaGraph_t``
    for the DOT dump (a graph not kept is destroyed once instantiated).
    The caller holds ``capture_lock``."""
    dump = profiling.hlo_dir is not None
    graph = (torch.cuda.CUDAGraph(keep_graph=True) if dump
             else torch.cuda.CUDAGraph())
    if dump:
        graph.enable_debug_mode()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        body()
    if dump:
        dump_graph(graph)
    return graph


def _label(solver: _Solver) -> str:
    """The capture census's label of a solver's runner."""
    return "serve.run_batch" if solver.batched else "solve.run_cycles"


def _tensor_ids(tree) -> Tuple[int, ...]:
    return tuple(id(t) for t in _flatten(tree, [])
                 if isinstance(t, torch.Tensor))


def _runner(compiled, solver: _Solver, dev: DeviceDCOP, consts: Tuple):
    device = dev.unary.device
    if device.type == "cpu":
        # nothing to build: a compile on the CPU is the first solve of a
        # key, recorded by a marker that keeps the key's tensors alive
        cached_runner(
            compiled, ("eager_seen", solver, _tensor_ids((dev, consts))),
            _label(solver), lambda: (dev, consts), device,
            lambda _: _tensor_bytes(_flatten((dev, consts), [])),
        )
        return _Eager(solver, dev, consts)
    if device.type != "cuda":
        raise ValueError(f"run_cycles runs on cpu or cuda, not {device}")
    return _graphs(compiled, solver, dev, consts)


def _graphs(compiled, solver: _Solver, dev: DeviceDCOP, consts: Tuple):
    """The cached ``_Graphs`` of this solver on this problem.  The graphs
    bake in the addresses of ``dev`` and the constants: their identities
    key the cache, and the cached graphs keep them alive."""
    return cached_runner(
        compiled, ("cycle_graphs", solver, _tensor_ids((dev, consts))),
        _label(solver), lambda: _Graphs(solver, dev, consts),
        dev.unary.device, _Graphs.static_bytes,
    )


def _chunk_length(n_cycles: int) -> int:
    """Iterations a chunk: up to ``TIMEOUT_CHUNK``, at least 8 (the
    power-of-two class of the cycle budget, as JAX's scan length)."""
    n_pad = max(8, 1 << max(0, int(n_cycles) - 1).bit_length())
    return min(TIMEOUT_CHUNK, n_pad)


def _drive(runner, solver: _Solver, n_limits: np.ndarray,
           deadline: Optional[float], start: int = 0,
           look: Optional[Callable[[], np.ndarray]] = None,
           chunk_ann: Optional[str] = None) -> bool:
    """Replay chunks until every instance has stopped: its cycle budget
    ran out, or (with a stability test) ``same_count`` consecutive cycles
    were stable.  The host looks at the instances' (cycles run,
    stability) with ``look`` (default ``runner.status``) only between
    growing runs of chunks, after 16, 48, 112, ... cycles from ``start``
    (a resumed solve's first cycle).  Returns whether ``deadline`` (a
    solo solve's) ran out first.  ``chunk_ann``: the device annotation
    of each run of replays (a live profiler session's timeout chunks)."""
    look = look or runner.status
    limit = int(n_limits.max()) if n_limits.size else 0
    issued = start  # iterations replayed, live or not, from cycle 0
    chunk = TIMEOUT_CHUNK
    while issued < limit:
        reps = -(-min(chunk, limit - issued) // solver.length)
        with device_annotation(chunk_ann) if chunk_ann else _NO_ANN:
            for _ in range(reps):
                runner.replay()
        run_cycles.replays += reps
        run_cycles.iterations += reps * solver.length
        issued += reps * solver.length
        chunk = min(2 * chunk, MAX_CHUNK)
        if issued >= limit:
            break  # every cycle ran or the stop rule fired: nothing to ask
        status = look().reshape(-1, 4)
        run_cycles.host_syncs += 1
        ran, stable = status[:, _RAN], status[:, _STABLE]
        done = ran >= n_limits
        if solver.use_stability:
            done |= stable >= solver.same_count
        if done.all():
            break
        if (deadline is not None and time.perf_counter() >= deadline
                or stop_requested()):
            return bool((ran < n_limits).any())
    return False


def _drive_durable(runner, solver: _Solver, n_cycles: int, start: int,
                   ckpt: CheckpointManager, deadline: Optional[float],
                   look: Callable[[], np.ndarray],
                   save: Callable[[int], None]) -> bool:
    """A checkpointed solve's replays: a look after every chunk, as JAX's
    chunked engine looks, and a snapshot (``save(cycle)``) whenever the
    manager says one is due.  The next cycle boundary is written into the
    graph's budget, so the iterations past it are masked and the carry
    stops at it; then the real budget and the carry's next cycle are
    written back.  Returns whether ``deadline`` ran out first."""
    done, cycle = start, start  # cycles run; the carry's next iteration
    while done < n_cycles:
        limit = n_cycles
        to_boundary = ckpt.cycles_to_boundary(done)
        if to_boundary is not None:
            limit = min(limit, done + to_boundary)
        runner.set_limit(limit)
        if cycle != done:
            # the masked iterations past the last boundary moved the
            # carry's cycle on: the next live one is cycle ``done``
            runner.set_cycle(done)
        with (device_annotation(f"solve.{_phase_of(solver.step)}.chunk")
              if profiling.profiler_active else _NO_ANN):
            runner.replay()
        run_cycles.replays += 1
        run_cycles.iterations += solver.length
        status = look().reshape(-1)
        run_cycles.host_syncs += 1
        cycle = done + solver.length
        done, stable = int(status[_RAN]), int(status[_STABLE])
        if ckpt.due(done):
            save(done)
        if solver.use_stability and stable >= solver.same_count:
            break
        if (deadline is not None and time.perf_counter() >= deadline
                or stop_requested()):
            return done < n_cycles
    return False


class _Looks:
    """The host's looks at a solo solve: each reads the status and the
    health rows replayed since the last look together, publishes the live
    rows to the pulse monitor and keeps the live part of the curve.  The
    live iterations between two looks come first: the budget and the
    stability stop only ever end a run of them.  With a ``phase``
    (telemetry on), each look closes a readback window; with the metrics
    registry on, a look that finds a better anytime best publishes it
    (``solve.best_cost``, ``solve.cycles_to_best``)."""

    def __init__(self, runner, start: int, keep_rows: bool,
                 phase: Optional[str] = None):
        self.runner, self.done = runner, start
        self.rows: Optional[List[np.ndarray]] = [] if keep_rows else None
        self.phase = phase
        self.t_window = time.perf_counter()
        self.best_seen: Optional[float] = None

    def look(self) -> np.ndarray:
        status, rows = self.runner.look()
        status = status.reshape(-1)
        ran = int(status[_RAN])
        self.window(ran, time.perf_counter())
        self.took(ran, rows)
        if metrics_registry.enabled:
            best = float(status[_BEST_COST:].view(np.float32)[0])
            if self.best_seen is None or best < self.best_seen:
                self.best_seen = best
                _m_cycles_to_best.set(int(status[_BEST_CYCLE]))
                _m_best_cost.set(best)
        return status

    def window(self, ran: int, t1: float) -> None:
        """Close the readback window that ends at a host sync at ``t1``
        with ``ran`` cycles run."""
        if self.phase is not None:
            _record_window("chunk", self.phase, self.done,
                           max(0, ran - self.done), self.t_window, t1,
                           self.runner.dev.unary.device)
        self.t_window = t1

    def took(self, ran: int, rows: Optional[np.ndarray]) -> None:
        n = max(0, ran - self.done)
        if rows is not None:
            live = rows[:n]
            pulse.publish(live, self.done)
            if self.rows is not None:
                self.rows.append(live)
        self.runner.keep_curve(n)
        self.done = max(self.done, ran)


def _to_host(tree):
    """``tree`` (dicts, lists and tensors) with its tensors copied to the
    host in one read (``_host_copy``)."""
    leaves: List[torch.Tensor] = []

    def index(t):
        if isinstance(t, dict):
            return {k: index(v) for k, v in t.items()}
        if isinstance(t, list):
            return [index(v) for v in t]
        leaves.append(t)
        return len(leaves) - 1

    shape = index(tree)
    host = _host_copy(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return host[t]

    return fill(shape)


def _carry_dict(state_leaves, best_vals, best_cost, best_cycle, stable,
                pc: Optional[PulseCarry]) -> Dict[str, Any]:
    """The chunk-boundary carry a checkpoint holds, as the JAX package's
    dict (its leaves in sorted key order): the solver state's leaves in
    JAX's form, the anytime best, the stability counter and, with pulse
    on, the flip carry."""
    carry = {
        "state": list(state_leaves),
        "best_vals": best_vals,
        "best_cost": best_cost,
        "best_cycle": best_cycle,
        "stable": stable,
    }
    if pc is not None:
        carry["pulse"] = {"prev": pc.prev, "prev2": pc.prev2,
                          "flips": pc.flips}
    return carry


def _save_solve_checkpoint(ckpt: CheckpointManager, runner,
                           carry_io: CarryIO, done: int) -> None:
    """One snapshot at a chunk boundary: the carry read from the device in
    one transfer, right after the look that found the boundary."""
    carry = runner.carry
    pc = carry.pulse
    tree = _carry_dict(
        carry_io.save(carry.state, runner.consts), carry.best_vals,
        carry.best_cost, carry.best_cycle, carry.stable, pc,
    )
    host = _to_host(tree)
    run_cycles.snapshots += 1
    extra = {**durability.runtime_extra(), "has_pulse": pc is not None}
    if pc is not None:
        # the flight recorder's ring rides the manifest, so a resumed
        # run's postmortem still shows the health history before the kill
        ring_rows, ring_start = pulse.recorder.ring()
        if ring_rows:
            extra["pulse_ring"] = ring_rows
            extra["pulse_ring_start"] = ring_start
    ckpt.save_carry(
        host, done, best_cost=float(host["best_cost"]),
        cycles_to_best=int(host["best_cycle"]), extra=extra,
    )


def _restore_solve_checkpoint(runner, resume_path: str, compiled,
                              carry_io: CarryIO, health, seed: int,
                              algo: str):
    """Load a checkpoint, refusing one of another problem, algorithm or
    seed, and write its carry into the runner's carry, the prologue's
    output: the state's dynamic leaves, the anytime best, the stability
    counter, the flip carry, and the cycles run and next cycle set to the
    manifest's cycle.  Returns (that cycle, the manifest)."""
    carry = runner.carry
    device = carry.best_vals.device

    def template_fn(manifest):
        pc = None
        if (manifest.get("extra") or {}).get("has_pulse"):
            pt = torch.zeros(runner.dev.n_vars, dtype=torch.int32)
            pc = PulseCarry(pt, pt, pt)
        return _carry_dict(
            carry_io.save(carry.state, runner.consts), carry.best_vals,
            carry.best_cost, carry.best_cycle, carry.stable, pc,
        )

    stored, manifest = CheckpointManager.load_carry(
        resume_path, template_fn, compiled=compiled, algo=algo,
        seed=int(seed),
    )

    def on(x):
        return x.to(device)

    state = carry_io.load(carry.state, [on(x) for x in stored["state"]])
    start = int(manifest.get("cycle", 0))
    fields = dict(
        state=state, best_vals=on(stored["best_vals"]),
        best_cost=on(stored["best_cost"]),
        best_cycle=on(stored["best_cycle"]), stable=on(stored["stable"]),
        ran=torch.tensor(start, dtype=torch.int32, device=device),
        cycle=torch.tensor(start, dtype=torch.int64, device=device),
    )
    if health is not None:
        # a checkpoint without the flip carry restarts the counters at 0
        # from the restored values: health only, the trajectory never
        # reads it
        p = stored.get("pulse")
        fields["pulse"] = (
            PulseCarry(on(p["prev"]), on(p["prev2"]), on(p["flips"]))
            if p is not None else _pulse_carry0(runner.solver.extract(
                dataclasses.replace(runner.dev, unary=carry.unary), state
            ))
        )
    runner.write_carry(**fields)
    return start, manifest


def run_cycles(
    compiled: CompiledDCOP,
    dev: DeviceDCOP,
    init: Callable,
    step: Callable,
    extract: Callable,
    n_cycles: int,
    seed: int = 0,
    collect_curve: bool = False,
    return_final: bool = True,
    convergence: Optional[Callable] = None,
    same_count: int = 4,
    timeout: Optional[float] = None,
    consts: Tuple = (),
    noise: float = 0.0,
    state_into: Any = None,
    noise_draw: Optional[int] = None,
    with_best: bool = False,
    health: Optional[Callable] = None,
    carry_io: Optional[CarryIO] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray], Dict[str, Any]]:
    """Drive a solver on ``dev``, the device form of ``compiled``.

    ``init``, ``step``, ``extract`` and ``convergence`` must be stable
    function objects (module-level, or from a cached factory): with the
    chunk length and the flags they key the captured graphs, so a warm
    solve captures nothing.  Per-problem tensors go in ``consts``.

    Returns the value indices (the final cycle's with ``return_final``,
    else the best seen), the per-cycle cost curve (``collect_curve``,
    which turns the stability exit off) and extras: ``best_cost``
    (min-form, on the noised costs), ``cycles`` (cycles run),
    ``cycles_to_best``, ``timed_out`` and, with ``state_into`` (a state
    tree of the solver's structure, shapes and dtypes), ``state``: the
    final solver state copied into ``state_into``, which no later solve
    overwrites.  Without it no state is copied or returned.

    ``convergence(dev, old_state, new_state) -> bool tensor``: the solve
    stops stepping after ``same_count`` consecutive stable cycles.
    ``timeout`` (seconds of wall): the clock is read after each chunk, and
    a solve out of time reports the whole chunks it ran with
    ``timed_out``; the trajectory is the same with or without it.
    ``with_best`` adds ``best_values``, the best assignment seen, to the
    extras.  ``noise_draw``: the noise draw's row count when ``dev`` is padded
    past ``compiled`` (the serving layer's bucket rows, see ``_noised``);
    rows from ``compiled.n_vars`` on draw no noise.

    ``health(dev, old_state, new_state) -> float32[2]``: the solver's
    health hook (residual, aux), run while ``pulse.enabled``; the rows
    land on the pulse monitor and in ``extras["pulse"]`` (``fields``,
    ``health``: the rows, or None on a timed or durable solve, whose rows
    the monitor streamed, ``flip_count``, ``report``), and never change
    the trajectory.  ``carry_io``: how the solver's state is checkpointed
    (``CarryIO``); a solve with one checkpoints and resumes as the
    ``durability`` singleton says (``extras["resumed_from"]``, and
    ``curve_offset``: a resumed curve covers the resumed cycles only)."""
    n_cycles = int(n_cycles)
    algo = _phase_of(step)
    ckpt = resume_path = None
    if durability.active and carry_io is not None and not is_auxiliary():
        ckpt = durability.manager
        if ckpt is not None and not ckpt.bind(
            compiled, algo, int(seed), float(noise or 0.0), n_cycles,
        ):
            # the manager belongs to another problem's solve: neither
            # checkpoint this one nor let it claim the resume
            ckpt = None
        else:
            resume_path = durability.take_resume()
    if metrics_registry.enabled:
        sample_device_memory("solve_start", dev.unary.device)
    hook = health if (health is not None and pulse.enabled) else None
    if hook is not None:
        pulse.begin_run({
            "algo": algo,
            "n_vars": int(compiled.n_vars),
            "n_cycles": n_cycles,
            "seed": int(seed),
            "noise": float(noise or 0.0),
            "timeout": timeout,
            "fields": list(HEALTH_FIELDS),
        })
    solver = _Solver(
        init=init, step=step, extract=extract, convergence=convergence,
        same_count=int(same_count), collect_curve=bool(collect_curve),
        has_noise=bool(noise), length=_chunk_length(n_cycles),
        noise_draw=None if noise_draw is None else int(noise_draw),
        health=hook,
    )
    runner = _runner(compiled, solver, dev, tuple(consts))
    deadline = None if timeout is None else time.perf_counter() + timeout
    key = PRNGKey(seed)
    n_real = dev.n_vars if noise_draw is None else compiled.n_vars
    # a live profiler session names the device work (JAX's annotations):
    # a solve without timeout or durability is one fused run, the others
    # run in chunks; then the read-back
    prof = profiling.profiler_active
    fused = timeout is None and not durability.active
    fused_ann = (device_annotation(f"solve.{algo}.fused")
                 if prof and fused else _NO_ANN)
    with fused_ann:
        runner.start(
            np.array([key[0], key[1], n_cycles, n_real]),
            np.float32(noise or 0.0),
        )
        start = 0
        if resume_path is not None:
            start, manifest = _restore_solve_checkpoint(
                runner, resume_path, compiled, carry_io, hook, seed, algo,
            )
            ring = (manifest.get("extra") or {}).get("pulse_ring")
            if hook is not None and ring:
                # refill the flight recorder with the dead run's health
                # ring
                pulse.recorder.record(
                    ring, int(manifest["extra"].get("pulse_ring_start", 0))
                )
            durability.note_resumed(manifest, resume_path)
        # the rows are kept for extras where the JAX package's fused solve
        # returns them: no timeout, no durability
        looks = _Looks(
            runner, start,
            keep_rows=(hook is not None and timeout is None
                       and ckpt is None and resume_path is None),
            phase=algo if _telemetry_on() else None,
        )
        if ckpt is not None:
            timed_out = _drive_durable(
                runner, solver, n_cycles, start, ckpt, deadline,
                looks.look,
                lambda done: _save_solve_checkpoint(ckpt, runner, carry_io,
                                                    done),
            )
        else:
            timed_out = _drive(
                runner, solver, np.array([n_cycles]), deadline, start,
                looks.look,
                chunk_ann=(f"solve.{algo}.chunk" if prof and not fused
                           else None),
            )
    t_rb = time.perf_counter()
    with device_annotation(f"solve.{algo}.readback") if prof else _NO_ANN:
        packed, rows, flips, nbytes = runner.result()
    t_end = time.perf_counter()
    out = _unpack(packed, dev.n_vars)
    run_cycles.host_syncs += 1
    if looks.phase is not None:
        _record_readback(nbytes, t_rb, t_end)
        looks.window(out["ran"], t_end)
    looks.took(out["ran"], rows)
    extras = {
        "best_cost": out["best_cost"],
        "cycles": out["ran"],
        "cycles_to_best": out["best_cycle"],
        "timed_out": timed_out,
    }
    if with_best:
        extras["best_values"] = out["best"]
    if state_into is not None:
        assign_(state_into, runner.state())
        extras["state"] = state_into
    if resume_path is not None:
        extras["resumed_from"] = start
        if collect_curve:
            extras["curve_offset"] = start
    if hook is not None:
        flips_np = flips[:compiled.n_vars].copy()
        extras["pulse"] = {
            "fields": HEALTH_FIELDS,
            "health": (
                None if looks.rows is None else
                np.concatenate(looks.rows) if looks.rows
                else np.zeros((0, HEALTH_WIDTH), dtype=np.float32)
            ),
            "flip_count": flips_np,
            "report": pulse.finish_run(flips_np),
        }
        if timed_out:
            # a solve out of wall clock leaves its last health rows and
            # its configuration behind for the ``postmortem`` verb
            pulse.recorder.maybe_dump("solve-timeout")
    if metrics_registry.enabled:
        # the final values, also where no look ran
        _m_best_cost.set(extras["best_cost"])
        _m_cycles_to_best.set(extras["cycles_to_best"])
    values = out["final"] if return_final else out["best"]
    curve = runner.curve() if collect_curve else None
    return values, curve, extras


run_cycles.captures = 0
run_cycles.replays = 0
run_cycles.iterations = 0  # replays times their chunks' length
run_cycles.host_syncs = 0
run_cycles.snapshots = 0  # carries copied to the host for a checkpoint


def run_batch(
    home: Any,
    dev: DeviceDCOP,
    init: Callable,
    step: Callable,
    extract: Callable,
    n_limits: List[int],
    seeds: List[int],
    levels: List[float],
    n_reals: List[int],
    consts: Tuple = (),
    convergence: Optional[Callable] = None,
    same_count: int = 4,
    has_noise: bool = False,
    noise_draw: Optional[int] = None,
    health: Optional[Callable] = None,
    times: Optional[Dict[str, float]] = None,
) -> List[Dict[str, Any]]:
    """K solves of one solver as one: ``dev`` and ``consts`` hold K
    problems of one shape stacked on a leading instance axis (the
    serving layer's bucket), and instance ``i`` runs ``n_limits[i]``
    cycles from ``PRNGKey(seeds[i])`` with noise ``levels[i]`` over its
    ``n_reals[i]`` real rows.  The prologue and every chunk run mapped
    over the instances: on the card each is one captured graph, keyed on
    ``home`` (an object whose ``__dict__`` holds the cache) and on the
    tensors of ``dev`` and ``consts``, which a caller refills in place
    for its next batch; a chunk's launches are those of one solo chunk.
    The batch runs until every instance has stopped (``_drive``), then
    reads back one packed ``[K, ...]`` block.  Each instance's result
    (``_unpack``'s fields) is the one ``run_cycles`` gives the same solve
    alone with ``noise_draw``: a dead iteration keeps its carry.

    ``health``: the solver's health hook, run while ``pulse.enabled``
    (pulse on and off capture different graphs).  Each instance then
    also gets ``health``, its rows (``[cycles run, HEALTH_WIDTH]``, the
    solo solve's bits), and ``flips``, its flip counters over its
    ``n_reals[i]`` real rows.  The rows of each replay land in the
    runner's ``[K, length, HEALTH_WIDTH]`` buffer and are read with the
    looks the batch makes anyway and with its packed read-back: as many
    host syncs as with pulse off.  A dead iteration's row is cut, as the
    JAX package cuts it: an instance's live iterations come first.

    ``times`` (a dict, the serving layer's request phases): the batch
    then waits for the device before its read-back (one
    ``torch.cuda.synchronize`` on the card, counted as a host sync, that
    the read-back would have waited for anyway) and records
    ``t_dispatched`` (every replay issued) and ``t_solved`` (the device
    done), on ``time.perf_counter``'s clock."""
    n_limits = np.asarray(n_limits, dtype=np.int64)
    hook = health if (health is not None and pulse.enabled) else None
    solver = _Solver(
        init=init, step=step, extract=extract, convergence=convergence,
        same_count=int(same_count), collect_curve=False,
        has_noise=bool(has_noise),
        length=_chunk_length(int(n_limits.max()) if n_limits.size else 0),
        noise_draw=None if noise_draw is None else int(noise_draw),
        batched=True, health=hook,
    )
    t0 = time.perf_counter()
    runner = _runner(home, solver, dev, tuple(consts))
    keys = np.array([PRNGKey(s) for s in seeds], dtype=np.int64)
    runner.start(
        np.concatenate([
            keys, n_limits[:, None],
            np.asarray(n_reals, dtype=np.int64)[:, None],
        ], axis=1),
        np.asarray(levels, dtype=np.float32),
    )
    seen: List[np.ndarray] = []

    def look() -> np.ndarray:
        status, rows = runner.look()
        if rows is not None:
            seen.append(rows)
        return status

    _drive(runner, solver, n_limits, None, look=look)
    t_rb = time.perf_counter()
    if times is not None:
        times["t_dispatched"] = t_rb
        if dev.unary.device.type == "cuda":
            torch.cuda.synchronize(dev.unary.device)
            run_cycles.host_syncs += 1
        times["t_solved"] = time.perf_counter()
    packed, rows, flips, nbytes = runner.result()
    t_end = time.perf_counter()
    run_cycles.host_syncs += 1
    out = [_unpack(row, dev.n_vars) for row in packed]
    if _telemetry_on():
        # the batch is one window: every instance's cycles (a padded
        # instance runs none)
        _record_readback(nbytes, t_rb, t_end)
        _record_window("batch", _phase_of(step), 0,
                       sum(row["ran"] for row in out), t0, t_end,
                       dev.unary.device)
    if hook is not None:
        if rows is not None:
            seen.append(rows)
        health_rows = np.concatenate(seen, axis=1) if seen else np.zeros(
            (len(out), 0, HEALTH_WIDTH), dtype=np.float32)
        flips = flips.reshape(len(out), -1)
        for i, row in enumerate(out):
            row["health"] = health_rows[i, :row["ran"]].copy()
            row["flips"] = flips[i, :int(n_reals[i])].copy()
    return out


def finalize(
    compiled: CompiledDCOP,
    values_idx: np.ndarray,
    cycles: int,
    msg_count: int,
    msg_size: int,
    curve: Optional[np.ndarray] = None,
    infinity: float = 10000,
    status: str = "FINISHED",
) -> SolveResult:
    """Decode indices, compute the exact host-side cost (float64, with the
    reference's violation counting) and build the result; the curve is
    reported in the problem's own sense (un-negated for max problems).

    A problem with a ``DCOP`` object is costed by its relations
    (``DCOP.solution_cost``): expression constraints and hard costs at or
    above ``infinity`` as written, not their clamped tables.  An
    array-only problem is costed by its tables (``host_cost``)."""
    values_idx = np.asarray(values_idx)[: compiled.n_vars]
    assignment = compiled.assignment_from_indices(values_idx)
    sign = 1.0 if compiled.objective == "min" else -1.0
    if compiled.dcop is not None:
        cost, violations = compiled.dcop.solution_cost(assignment, infinity)
    else:
        cost, violations = compiled.host_cost(values_idx, infinity)
    return SolveResult(
        assignment=assignment,
        cost=cost,
        violations=violations,
        cycles=cycles,
        msg_count=msg_count,
        msg_size=msg_size,
        cost_curve=(
            [float(sign * c) for c in curve] if curve is not None else None
        ),
        status=status,
    )
