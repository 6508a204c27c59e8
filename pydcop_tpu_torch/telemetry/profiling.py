"""Compile and device observability below the Python line.

Counterpart of ``pydcop_tpu/telemetry/profiling.py``.  The metrics and the
tracer answer where the HOST wall went; this module answers what the
port built for the card, what it cost, and where the DEVICE time went:

- **The capture census.**  JAX's ``profiled_jit`` counts, per jit entry
  point, the XLA compiles and the executable-cache hits.  The port's
  counterpart of an executable is an entry point's cached runner: on the
  card the CUDA graphs captured for a (problem, solver, params, chunk
  length) key, cached on the problem.  A *compile* is the build of a
  runner for a new key (:func:`profiled_build`: on the card its graph
  capture, warm-up included); a *hit* is a call that reuses one
  (:func:`count_hit`).  The CPU captures no graph: there a compile is the
  first solve of a key, which the engine records as built, so a cold
  solve counts one compile and a warm one none, on either device.  While
  profiling, the metrics registry or the tracer is on, every compile
  publishes ``compile.jit_compiles{fn}``, ``compile.jit_seconds{fn}``
  (the build's wall), ``compile.memory_bytes{fn,kind}`` (``peak``: the
  rise of ``torch.cuda.max_memory_allocated`` across the build, on the
  card; ``argument``: the bytes of the graph's static inputs) and a
  ``compile.jit`` span, and every hit ``compile.jit_cache_hits{fn}``.
  XLA's ``cost_analysis`` (flops, bytes accessed) has no counterpart:
  each compile counts ``compile.analysis_unavailable{fn,api=
  "cost_analysis"}`` (and on the CPU, which has no allocator peak and
  no graph, ``api="memory_analysis"``, and ``api="as_text"`` with
  ``--dump-hlo``), as JAX does on a backend without the API.
  With all three off, a site costs one attribute check.
  ``profiling.builds`` counts every build, on or off (the serving
  layer's ``fresh_compiles`` is its rise across a dispatch).
- **``start_profiling`` / ``stop_profiling``**: the ``--profile-out DIR``
  session, a ``torch.profiler.profile`` recording CPU and (on the card)
  CUDA activities, exported as a Chrome trace into ``DIR``.  A profiler
  that cannot start is counted (``device.profiler_unavailable``) and
  named in ``profiling.profiler_error``; a failed export is reported with
  the ``"stop_trace failed"`` prefix.  The solve runs the same either way.
- **``device_annotation(name)``**: ``torch.profiler.record_function`` plus
  an NVTX range on the card, naming the engine's fused runs, chunks and
  read-backs (``solve.{phase}.fused`` / ``.chunk`` / ``.readback``); a
  shared no-op unless a session is live.
- **``--dump-hlo DIR``**: the counterpart of "what the compiler built" is
  what a captured CUDA graph holds.  While a dump directory is set, every
  fresh capture runs in ``CUDAGraph.enable_debug_mode()`` and writes
  ``<label>.<n>.graph.dot`` (``debug_dump``), counted in
  ``compile.hlo_dumps{fn}``.  Graphs captured without the flag are not in
  debug mode; a graph already cached dumps nothing, as a warm JAX jit.

JAX's ``opportunistic_memory`` switch is not kept: it chose whether a
compile paid an ahead-of-time XLA compile for ``memory_analysis``, and the
port's peak comes from the allocator at no extra cost.

Labels: the port's entry points and the JAX labels each stands for are
:data:`JAX_LABELS`.  Module-level imports are stdlib and sibling
telemetry modules only; torch is imported inside the functions that need
it (host-only verbs import this package).
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Any, Callable, Dict, Optional, Tuple

from .metrics import metrics_registry
from .tracing import tracer

__all__ = [
    "JAX_LABELS",
    "ProfilingState",
    "count_hit",
    "device_annotation",
    "dump_graph",
    "jit_census",
    "profiled_build",
    "profiling",
    "readback_census",
    "start_profiling",
    "stop_profiling",
]

#: the port's census labels and the JAX package's ``profiled_jit`` labels
#: each stands for.  One runner serves JAX's fused, chunked and scanned
#: solve programs (the port replays the same graphs in chunks either
#: way); the fused DPOP wave inlines JAX's row gathers and contractions;
#: the port's streaming DPOP path launches eagerly and builds nothing, and
#: the two Pallas kernels are launched inside these runners.
JAX_LABELS: Dict[str, Tuple[str, ...]] = {
    "solve.run_cycles": (
        "solve._solve_fused", "solve._while_chunk", "solve._scan_cycles",
    ),
    "serve.run_batch": ("serve._solve_batch",),
    "dpop.fused_wave": (
        "dpop.replay", "_rows", "_rows_flat", "_concat_pad", "_unary_util",
        "_group_contract", "_chunk_contract",
    ),
    "bb.search": ("_bb_loop",),
}


class ProfilingState:
    """Process-wide switchboard, as the ``tracer`` and ``metrics_registry``
    singletons: every hot-path site checks one plain attribute."""

    def __init__(self) -> None:
        #: full-analysis mode (--profile-out / --dump-hlo): graph dumps on
        #: a capture, device annotations live with a session
        self.enabled = False
        #: directory for the per-capture graph dumps (--dump-hlo DIR)
        self.hlo_dir: Optional[str] = None
        #: a torch.profiler session is recording (--profile-out DIR)
        self.profiler_active = False
        #: why the profiler could not start or export, for the summary
        self.profiler_error: Optional[str] = None
        #: runner builds in this process, counted with telemetry off too
        self.builds = 0
        # the live torch.profiler.profile and where it exports
        self._session: Any = None
        self._session_dir: Optional[str] = None
        # the label of the build in progress (names its graph dumps) and
        # the dump numbering per label: the registry's counters reset
        # and no-op when off, which would overwrite <label>.0.graph.dot
        self._building: Optional[str] = None
        self._n_dumps: Dict[str, int] = {}


#: Process-wide singleton.
profiling = ProfilingState()


# -- metric handles (module-level get-or-create, like algorithms/base.py) --
_m_jit_compiles = metrics_registry.counter(
    "compile.jit_compiles", "runner builds (graph captures) per entry point"
)
_m_jit_cache_hits = metrics_registry.counter(
    "compile.jit_cache_hits", "cached-runner reuses per entry point"
)
_m_jit_seconds = metrics_registry.histogram(
    "compile.jit_seconds",
    "wall per build (warm-up + graph capture on the card)",
)
_m_memory_bytes = metrics_registry.gauge(
    "compile.memory_bytes",
    "memory of the last build (kind=peak: the allocator's peak rise "
    "across it; kind=argument: the graph's static inputs)",
)
_m_analysis_unavailable = metrics_registry.counter(
    "compile.analysis_unavailable",
    "analyses of a build the port has no counterpart for",
)
_m_hlo_dumps = metrics_registry.counter(
    "compile.hlo_dumps", "CUDA-graph DOT files written by --dump-hlo"
)
_m_profiler_unavailable = metrics_registry.counter(
    "device.profiler_unavailable",
    "torch.profiler sessions that could not start",
)

_SAFE_NAME = re.compile(r"[^A-Za-z0-9_.-]+")


def _census_on() -> bool:
    return profiling.enabled or metrics_registry.enabled or tracer.enabled


def count_hit(label: str) -> None:
    """A call of ``label`` that reused its cached runner."""
    if _census_on():
        _m_jit_cache_hits.inc(fn=label)


def profiled_build(
    label: str,
    build: Callable[[], Any],
    device: Any = None,
    argument_bytes: Optional[Callable[[Any], int]] = None,
) -> Any:
    """``build()``: one compile of entry point ``label`` (its runner for a
    new key), counted, timed and sized while the census is on.
    ``device``: where the build allocates (a ``torch.device``; the peak is
    read on a CUDA one); ``argument_bytes(built)``: the bytes of the built
    graph's static inputs."""
    profiling.builds += 1
    if not _census_on():
        return build()
    cuda = device is not None and getattr(device, "type", None) == "cuda"
    peak0 = 0
    if cuda:
        import torch

        peak0 = torch.cuda.max_memory_allocated(device)
    outer = profiling._building
    profiling._building = label
    t0 = time.perf_counter()
    try:
        built = build()
    finally:
        profiling._building = outer
    wall = time.perf_counter() - t0
    _m_jit_compiles.inc(fn=label)
    _m_jit_seconds.observe(wall, fn=label)
    span_args: Dict[str, Any] = {"fn": label}
    _m_analysis_unavailable.inc(fn=label, api="cost_analysis")
    mem: Dict[str, int] = {}
    if cuda:
        import torch

        mem["peak"] = max(0, torch.cuda.max_memory_allocated(device) - peak0)
    else:
        _m_analysis_unavailable.inc(fn=label, api="memory_analysis")
        if profiling.hlo_dir is not None:
            # nothing captured: no graph to dump
            _m_analysis_unavailable.inc(fn=label, api="as_text")
    if argument_bytes is not None:
        mem["argument"] = int(argument_bytes(built))
    for kind, v in mem.items():
        _m_memory_bytes.set(float(v), fn=label, kind=kind)
        span_args[f"{kind}_bytes"] = int(v)
    tracer.complete("compile.jit", t0, wall, cat="compile", **span_args)
    return built


def dump_graph(graph: Any) -> None:
    """Write a just-captured debug-mode graph (``--dump-hlo``) as
    ``<label>.<n>.graph.dot``; ``n`` numbers the label's captures in this
    process."""
    label = profiling._building or "capture"
    n = profiling._n_dumps.get(label, 0) + 1
    profiling._n_dumps[label] = n
    safe = _SAFE_NAME.sub("_", label)
    path = os.path.join(profiling.hlo_dir, f"{safe}.{n}.graph.dot")
    try:
        os.makedirs(profiling.hlo_dir, exist_ok=True)
        graph.debug_dump(path)
        _m_hlo_dumps.inc(fn=label)
    except (OSError, RuntimeError):
        _m_analysis_unavailable.inc(fn=label, api="hlo_write")


# ---------------------------------------------------------------------------
# the --profile-out session
# ---------------------------------------------------------------------------


def _export_trace(session, profile_dir: str) -> None:
    """Export a finished session as ``DIR/<host>.<pid>.pt.trace.json``
    (the Chrome trace; Perfetto and TensorBoard read it)."""
    import socket

    name = f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"
    session.export_chrome_trace(os.path.join(profile_dir, name))


def start_profiling(
    profile_dir: Optional[str] = None, hlo_dir: Optional[str] = None
) -> None:
    """Switch profiling on: graph dumps into ``hlo_dir`` and, when
    ``profile_dir`` is given, a ``torch.profiler`` session (CPU activities,
    and CUDA's where a card is present) whose trace lands there.  A
    profiler that cannot start is counted and reported, never raised."""
    profiling.hlo_dir = hlo_dir
    profiling.enabled = True
    profiling.profiler_error = None
    if profile_dir is not None and not profiling.profiler_active:
        try:
            import torch

            os.makedirs(profile_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            session = torch.profiler.profile(activities=acts)
            session.__enter__()
            profiling._session = session
            profiling._session_dir = profile_dir
            profiling.profiler_active = True
        except Exception as e:  # an absent or unsupported profiler
            profiling.profiler_error = f"{type(e).__name__}: {e}"
            _m_profiler_unavailable.inc()


def stop_profiling() -> None:
    """End the session started by :func:`start_profiling` (idempotent) and
    export its trace; a failing stop or export is reported through
    ``profiler_error``, never raised."""
    if profiling.profiler_active:
        session, out_dir = profiling._session, profiling._session_dir
        profiling.profiler_active = False
        profiling._session = profiling._session_dir = None
        try:
            session.__exit__(None, None, None)
            _export_trace(session, out_dir)
        except Exception as e:
            # the profiler DID run: callers report a failed export, not
            # an absent profiler
            profiling.profiler_error = (
                f"stop_trace failed: {type(e).__name__}: {e}"
            )
    profiling.enabled = False
    profiling.hlo_dir = None


# shared reentrant no-op for the annotation-off path
_NULL_CTX = contextlib.nullcontext()


@contextlib.contextmanager
def _annotated(name: str, cuda: bool):
    import torch

    with torch.profiler.record_function(name):
        if cuda:
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def device_annotation(name: str):
    """``torch.profiler.record_function(name)`` plus an NVTX range on the
    card around the enclosed launches (an algorithm phase, a chunk, a
    read-back): a shared no-op unless a profiler session is live."""
    if not profiling.profiler_active:
        return _NULL_CTX
    try:
        import torch

        return _annotated(name, torch.cuda.is_available())
    except Exception:
        return _NULL_CTX


def jit_census() -> dict:
    """Per-entry-point census from the compile counters: ``{label:
    {"compiles", "hits", "dispatches"}}`` over the port's labels
    (:data:`JAX_LABELS`), ``dispatches = compiles + hits``: every call of
    an entry point either builds its runner or reuses it.  A warm solve
    shows one ``solve.run_cycles`` hit and no compile."""
    out: dict = {}
    for metric_name, field in (
        ("compile.jit_compiles", "compiles"),
        ("compile.jit_cache_hits", "hits"),
    ):
        m = metrics_registry.get(metric_name)
        if m is None:
            continue
        for entry in m.snapshot().get("values", []):
            label = dict(entry.get("labels") or {}).get("fn", "")
            rec = out.setdefault(
                label, {"compiles": 0, "hits": 0, "dispatches": 0}
            )
            rec[field] += int(entry.get("value") or 0)
    for rec in out.values():
        rec["dispatches"] = rec["compiles"] + rec["hits"]
    return out


def readback_census() -> dict:
    """Solve-path read-back counters: ``windows`` (readback windows
    closed: the port's looks and its packed read-back) and ``readbacks``
    (device-to-host read-backs the engine timed: one packed read-back a
    solve) with their bytes."""
    out = {"windows": 0, "readbacks": 0, "readback_bytes": 0}
    m = metrics_registry.get("solve.windows")
    if m is not None:
        out["windows"] = int(
            sum(e.get("value") or 0 for e in m.snapshot().get("values", []))
        )
    m = metrics_registry.get("solve.readback_seconds")
    if m is not None:
        out["readbacks"] = int(
            sum(
                (e.get("value") or {}).get("count", 0)
                for e in m.snapshot().get("values", [])
            )
        )
    m = metrics_registry.get("solve.readback_bytes")
    if m is not None:
        out["readback_bytes"] = int(
            sum(e.get("value") or 0 for e in m.snapshot().get("values", []))
        )
    return out
