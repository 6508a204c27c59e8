"""The capture verb's records: the JAX bench configs, run through the port.

Counterpart of the JAX package's ``bench_all.py`` records (``_bench``
and its configs), which the ``capture`` verb
(``commands/capture.py``) runs one config at a time with profiling on.
Not a benchmark: it writes no file; each config gives one record dict.

A record (``_bench``): a warm-up solve with the metrics registry on
(where the runners are built: the ``compile`` block, the capture census,
and the ``memory`` block of the memory guard's prediction), then the timed
solve with the registry on (``value``: its wall in seconds; the
``telemetry`` block; ``census``: the capture census and the read-back
census of the timed run, where a compile means a runner rebuilt
mid-measurement), one untimed curve pass with pulse on (the decimated
cost curve, cycles to best, the ``pulse`` verdict), the ``roofline``
block (JAX's analytic traffic a cycle over the timed wall, against the
card's HBM peak), and the ``kernel`` block (``telemetry/kernelprof.py``)
after the timed passes; a failure there degrades to ``{"error": ...}``
and counts ``kernelprof.degraded``.

Configs (``CONFIGS``; the problems of ``tools/profile_solve.py`` and the
port's generators): 1 the reference's 50-variable coloring, DSA (the file
lives in a reference pyDCOP checkout named by ``PYDCOP_REFERENCE_DIR``;
without it the record is JAX's ``skipped`` record), 2 MaxSum on a
1,000-variable random coloring, 3 MGM-2 on the 100x100 Ising grid, 4
MaxSum ``ell`` on the 100,000-variable scale-free coloring (with the
``ici`` sub-block and the cost of checkpoints every 8 cycles), 5 DPOP on
30 meetings, 6 config 4 at 1,000,000 variables, 7 MixedDSA on the mixed
problem, 8 serving (32 DSA tenants in two buckets: fused and vmap
batches against the sequential loops, the warm vmap pass's capture
census, queue latency through a live server with an SLO engine), 9 the
partition quality of config 4's graph for 8 shards (``partition``
block), 10 refuses: it needs 8 devices and the sharded ELL solve, which
is not ported.  ``DEFAULT_CONFIGS``, ``KERNEL_CONFIGS`` (records that
must carry a kernel block) and ``METRIC_NAMES`` are JAX's.

Every config runs on ``device``: the card unless the caller asks for
the CPU.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, Optional

__all__ = [
    "CONFIGS", "DEFAULT_CONFIGS", "KERNEL_CONFIGS", "METRIC_NAMES",
    "run_config",
]

# decimation bound of the anytime profile embedded in a record
CURVE_POINTS = 64

#: the reference pyDCOP checkout holding config 1's problem
REFERENCE_ENV = "PYDCOP_REFERENCE_DIR"
REFERENCE_COLORING_50 = os.path.join("docs", "tutorials",
                                     "graph_coloring_50.yaml")


def _maxsum_traffic_bytes(compiled) -> int:
    """Analytic minimum memory traffic of ONE MaxSum cycle (JAX's model):
    the two ``[n_edges, D]`` message planes each read ~3x and written ~1x,
    the joint tables read once, plus the int32 edge index arrays."""
    import numpy as np

    itemsize = np.dtype(compiled.float_dtype).itemsize
    table_elems = sum(int(b.tables.size) for b in compiled.buckets)
    plane = int(compiled.n_edges) * int(compiled.max_domain)
    return itemsize * (8 * plane + table_elems) + 4 * 3 * int(
        compiled.n_edges
    )


def _sum_metric(reg, name, field=None):
    """A metric's values summed across label sets (histograms: ``field``,
    default their sum)."""
    m = reg.get(name)
    if m is None:
        return 0.0
    total = 0.0
    for entry in m.snapshot().get("values", []):
        v = entry.get("value")
        if isinstance(v, dict):  # histogram
            v = v.get(field or "sum", 0.0)
        total += float(v or 0.0)
    return total


def _max_metric(reg, name, **labels) -> Optional[float]:
    """The largest value of a gauge among the label sets that carry
    ``labels``, or None."""
    m = reg.get(name)
    if m is None:
        return None
    best = None
    for entry in m.snapshot().get("values", []):
        have = dict(entry.get("labels") or {})
        if all(have.get(k) == v for k, v in labels.items()):
            v = float(entry.get("value") or 0.0)
            best = v if best is None else max(best, v)
    return best


def _compile_block(reg) -> Dict[str, Any]:
    """The warm-up's builds: runners built and reused, the build wall,
    the host lowering wall; ``flops``/``bytes_accessed`` stay 0 (XLA's
    cost analysis has no counterpart: ``analysis_unavailable``)."""
    return {
        "jit_compiles": int(_sum_metric(reg, "compile.jit_compiles")),
        "jit_cache_hits": int(_sum_metric(reg, "compile.jit_cache_hits")),
        "compile_s": round(
            _sum_metric(reg, "compile.jit_seconds", "sum"), 4
        ),
        "host_compile_s": round(
            _sum_metric(reg, "compile.host_seconds", "sum"), 4
        ),
        "flops": int(_sum_metric(reg, "compile.flops_total")),
        "bytes_accessed": int(
            _sum_metric(reg, "compile.bytes_accessed_total")
        ),
        "analysis_unavailable": int(
            _sum_metric(reg, "compile.analysis_unavailable")
        ),
    }


def _memory_block(reg, device) -> Dict[str, Any]:
    """The memory guard's prediction over the warm-up, the builds' peak
    rise (``compile.memory_bytes{kind="peak"}``, the largest over the
    entry points; none on the CPU), the device limit and the headroom."""
    from ..telemetry.memplane import device_limit_bytes

    predicted = reg.gauge("mem.predicted_bytes").value()
    peak = _max_metric(reg, "compile.memory_bytes", kind="peak")
    limit = device_limit_bytes(device)
    block = {
        "predicted_bytes": int(predicted) if predicted else None,
        "measured_peak_bytes": int(peak) if peak else None,
        "limit_bytes": int(limit) if limit else None,
        "headroom_pct": None,
    }
    basis = peak or predicted
    if limit and basis:
        block["headroom_pct"] = round(100.0 * (1.0 - basis / limit), 2)
    if predicted and peak:
        block["model_ratio"] = round(predicted / peak, 3)
    return block


def _telemetry_block(reg) -> Dict[str, Any]:
    windows = reg.counter("solve.windows").value()
    rb = reg.histogram("solve.readback_seconds")
    rb_count = rb.count()
    return {
        "windows": int(windows),
        "device_cycles": int(reg.counter("solve.device_cycles").value()),
        "readback_bytes": int(reg.counter("solve.readback_bytes").value()),
        "readback_ms_mean": (
            round(1000.0 * rb.sum() / rb_count, 3) if rb_count else None
        ),
        "upload_bytes": int(reg.counter("solve.upload_bytes").value()),
    }


def _decimate(curve, points=CURVE_POINTS):
    from ..telemetry import decimate_series

    return decimate_series([round(float(c), 6) for c in curve], points)


def _bench(name: str, solve_fn: Callable, n_cycles: int, device,
           traffic_bytes: Optional[int] = None,
           kernel_fn: Optional[Callable[[], Dict]] = None) -> Dict:
    """Warm-up + timed run of ``solve_fn`` (``**kw -> SolveResult``), the
    curve pass, the roofline and the kernel block: one record."""
    from ..telemetry import memguard, metrics_registry, pulse
    from ..telemetry.kernelprof import device_platform, hbm_peak_gbps
    from ..telemetry.profiling import jit_census, readback_census

    # warm-up with metrics on: the runners are built here (the compile
    # block), and the memory guard publishes its prediction (no limit on
    # the CPU: it never refuses)
    metrics_registry.reset()
    metrics_registry.enabled = True
    guard_was = memguard.enabled
    memguard.enabled = True
    try:
        solve_fn()
    finally:
        metrics_registry.enabled = False
        memguard.enabled = guard_was
    compile_block = _compile_block(metrics_registry)
    memory_block = _memory_block(metrics_registry, device)
    metrics_registry.reset()
    metrics_registry.enabled = True
    try:
        t0 = time.perf_counter()
        result = solve_fn()
        wall = time.perf_counter() - t0
    finally:
        metrics_registry.enabled = False
    telemetry = _telemetry_block(metrics_registry)
    census = {"jit": jit_census(), "readback": readback_census()}
    # the anytime profile (untimed), with pulse: its own runners
    pm_dir = tempfile.mkdtemp(prefix="capture_pulse_")
    prev_pm_path = pulse.postmortem_path
    try:
        metrics_registry.enabled = True
        pulse.reset()
        pulse.enabled = True
        pulse.postmortem_path = os.path.join(pm_dir, "postmortem.json")
        curve_result = solve_fn(collect_curve=True)
        curve = curve_result.cost_curve
    except TypeError as exc:
        if "collect_curve" not in str(exc):
            raise
        curve = None
    finally:
        pulse.enabled = False
        pulse.postmortem_path = prev_pm_path
        metrics_registry.enabled = False
        shutil.rmtree(pm_dir, ignore_errors=True)
    if curve:
        telemetry["cost_curve"] = _decimate(curve)
        c2b = metrics_registry.gauge("solve.cycles_to_best").value()
        telemetry["cycles_to_best"] = int(c2b)
    pulse_block = None
    if pulse.last_report is not None:
        a = pulse.last_report.get("analysis", {})
        pulse_block = {
            "diagnosis": pulse.last_report["diagnosis"],
            "cycles": pulse.last_report["cycles"],
            "churn": round(float(a.get("churn_now", 0.0)), 4),
            "residual": float(a.get("residual_now", 0.0)),
            "violations": int(a.get("violations", 0)),
        }
        fs = pulse.last_report.get("flip_summary")
        if fs:
            pulse_block["frozen_frac"] = round(float(fs["frozen_frac"]), 4)

    record = {
        "metric": name,
        "value": round(wall, 4),
        "unit": "s",
        "cycles_per_s": round(n_cycles / wall, 1) if wall > 0 else None,
        "cost": result.cost,
        "violations": result.violations,
        "cycles": n_cycles,
        "device": device_platform(device),
        "telemetry": telemetry,
        "compile": compile_block,
        "memory": memory_block,
        "census": census,
    }
    if pulse_block is not None:
        record["pulse"] = pulse_block
    roofline = {}
    peak = hbm_peak_gbps(device)
    if traffic_bytes and wall > 0:
        gbps = traffic_bytes * n_cycles / wall / 1e9
        record["achieved_gbps"] = round(gbps, 2)
        roofline["traffic_bytes_per_cycle"] = int(traffic_bytes)
        roofline["achieved_gbps"] = round(gbps, 2)
        roofline["peak_gbps"] = peak
        if peak:
            record["hbm_peak_pct"] = round(100.0 * gbps / peak, 2)
            roofline["hbm_peak_pct"] = record["hbm_peak_pct"]
    if compile_block.get("flops") and wall > 0:
        roofline["achieved_gflops"] = round(
            compile_block["flops"] / wall / 1e9, 3
        )
    if roofline:
        record["roofline"] = roofline
    if kernel_fn is not None:
        # metrics on: the MGM-2 phase histograms land, and a degraded
        # block is counted, not just embedded
        metrics_registry.enabled = True
        try:
            record["kernel"] = kernel_fn()
        except Exception as exc:  # noqa: BLE001
            record["kernel"] = {
                "error": f"{type(exc).__name__}: {exc}"[:200]
            }
            metrics_registry.counter("kernelprof.degraded").inc(
                reason=type(exc).__name__
            )
        finally:
            metrics_registry.enabled = False
    return record


def _problem(key: str):
    """A config's problem, as ``tools/profile_solve.py`` builds it."""
    from .profile_solve import CONFIGS as PROBLEMS

    return PROBLEMS[key][0]()


def config_1_dsa50(device, n_cycles=100):
    from ..algorithms import dsa
    from ..compile.core import compile_dcop
    from ..dcop.yamldcop import load_dcop_from_file

    root = os.environ.get(REFERENCE_ENV)
    path = os.path.join(root, REFERENCE_COLORING_50) if root else None
    if path is None or not os.path.exists(path):
        return {
            "metric": "dsa_coloring50_wall",
            "value": None,
            "skipped": (
                f"reference checkout not present (${REFERENCE_ENV}/"
                f"{REFERENCE_COLORING_50})"
            ),
        }
    compiled = compile_dcop(load_dcop_from_file([path]))
    return _bench(
        "dsa_coloring50_wall",
        lambda **kw: dsa.solve(compiled, {}, n_cycles=n_cycles, seed=0,
                               device=device, **kw),
        n_cycles, device,
    )


def config_2_maxsum1k(device, n_cycles=60):
    from ..algorithms import maxsum
    from ..telemetry.kernelprof import ell_kernel_block

    compiled = _problem("2")
    return _bench(
        "maxsum_1k_random_wall",
        lambda **kw: maxsum.solve(
            compiled, {"damping": 0.5, "stop_cycle": n_cycles},
            n_cycles=n_cycles, seed=0, device=device, **kw
        ),
        n_cycles, device,
        traffic_bytes=_maxsum_traffic_bytes(compiled),
        kernel_fn=lambda: ell_kernel_block(compiled, reps=10,
                                           device=device),
    )


def config_3_mgm2_ising10k(device, n_cycles=30):
    from ..algorithms import mgm2
    from ..telemetry.kernelprof import mgm2_phase_block

    compiled = _problem("3")
    return _bench(
        "mgm2_ising10k_wall",
        lambda **kw: mgm2.solve(compiled, {}, n_cycles=n_cycles, seed=0,
                                device=device, **kw),
        n_cycles, device,
        kernel_fn=lambda: mgm2_phase_block(compiled, reps=5,
                                           device=device),
    )


def config_4_maxsum100k(device, n_cycles=30):
    from ..algorithms import maxsum
    from ..telemetry.kernelprof import ell_kernel_block

    compiled = _problem("4")

    def solve(**kw):
        return maxsum.solve(
            compiled, {"damping": 0.7, "layout": "ell"},
            n_cycles=n_cycles, seed=7, device=device, **kw
        )

    record = _bench(
        "maxsum_100k_scalefree_wall", solve, n_cycles, device,
        traffic_bytes=_maxsum_traffic_bytes(compiled),
        # the per-op roofline of the ELL cycle, and the modelled
        # cross-shard bytes a cycle at 8 shards (BFS vs multilevel)
        kernel_fn=lambda: dict(
            ell_kernel_block(compiled, reps=10, device=device),
            ici=_ici_block_100k(compiled=compiled),
        ),
    )
    record["durability"] = _checkpoint_overhead(solve, record.get("value"))
    return record


def _checkpoint_overhead(solve_fn, fused_wall, every=8):
    """The cost of durability on the headline config: the same solve
    checkpointing every ``every`` cycles, as a percentage over the timed
    wall; one warm-up pass first (a durable solve looks after every
    chunk).  A failure degrades to an error block."""
    try:
        from ..durability import CheckpointManager, durability

        ck_dir = tempfile.mkdtemp(prefix="capture_ckpt_")
        try:
            for _timed in (False, True):
                durability.configure(
                    manager=CheckpointManager(
                        ck_dir, every_cycles=every, keep=2
                    )
                )
                try:
                    t0 = time.perf_counter()
                    solve_fn()
                    wall = time.perf_counter() - t0
                finally:
                    durability.reset()
            out = {
                "checkpoint_every": every,
                "checkpointed_wall_s": round(wall, 4),
            }
            if fused_wall:
                out["checkpoint_overhead_pct"] = round(
                    100.0 * (wall - fused_wall) / fused_wall, 2
                )
            return out
        finally:
            shutil.rmtree(ck_dir, ignore_errors=True)
    except Exception as exc:  # noqa: BLE001
        return {"error": f"{type(exc).__name__}: {exc}"[:200]}


def config_5_dpop_meetings(device):
    from ..algorithms import dpop
    from ..commands.generators.meetingscheduling import (
        generate_meeting_scheduling,
    )
    from ..compile.core import compile_dcop

    compiled = compile_dcop(generate_meeting_scheduling(
        slots_count=8, resources_count=30, events_count=30,
        max_resources_event=2, seed=5,
    ))
    return _bench(
        "dpop_meetings_wall",
        lambda **kw: dpop.solve(compiled, {}, n_cycles=1, seed=0,
                                device=device, **kw),
        1, device,
    )


def config_6_maxsum1m(device, n_cycles=30):
    """Config 4's problem and run at 1,000,000 variables (manual)."""
    from ..algorithms import maxsum

    compiled = _problem("6")
    return _bench(
        "maxsum_1m_scalefree_wall",
        lambda **kw: maxsum.solve(
            compiled, {"damping": 0.7, "layout": "ell"},
            n_cycles=n_cycles, seed=7, device=device, **kw
        ),
        n_cycles, device,
        traffic_bytes=_maxsum_traffic_bytes(compiled),
    )


def config_7_mixeddsa(device, n_cycles=50):
    """MixedDSA on the mixed hard/soft problem (manual)."""
    from ..algorithms import mixeddsa

    compiled = _problem("7")
    return _bench(
        "mixeddsa_2k_mixed_wall",
        lambda **kw: mixeddsa.solve(compiled, {}, n_cycles=n_cycles,
                                    seed=0, device=device, **kw),
        n_cycles, device,
    )


def config_8_serving(device, batch=32, n_cycles=16, reps=5):
    """Serving throughput: ``batch`` tutorial-size DSA tenants in two
    shape buckets, the fused batch (the headline wall) and the vmap batch
    against the sequential loops (``solve_one`` through the same padding;
    ``dsa.solve`` a tenant), the warm vmap pass's capture census (0 fresh
    builds), and queue latency through a live server with an SLO engine."""
    import numpy as np

    from ..algorithms import dsa
    from ..commands.generators.graphcoloring import (
        generate_coloring_arrays,
    )
    from ..serve import ServeServer, SolveRequest, solve_batched, solve_one
    from ..telemetry import metrics_registry
    from ..telemetry.kernelprof import device_platform
    from ..telemetry.slo import SloEngine, parse_objective

    n_small = batch // 4
    reqs = [
        SolveRequest(
            f"b{i}", generate_coloring_arrays(9, 3, graph="grid",
                                              seed=300 + i),
            "dsa", {}, n_cycles, i,
        )
        for i in range(batch - n_small)
    ] + [
        SolveRequest(
            f"s{i}", generate_coloring_arrays(16, 3, graph="grid",
                                              seed=400 + i),
            "dsa", {}, n_cycles, i,
        )
        for i in range(n_small)
    ]

    def med_interleaved(fns):
        walls = [[] for _ in fns]
        for _ in range(reps):
            for i, fn in enumerate(fns):
                t0 = time.perf_counter()
                fn()
                walls[i].append(time.perf_counter() - t0)
        return [statistics.median(w) for w in walls]

    # warm-up: the runners of every path
    solve_batched(reqs, mode="fused", device=device)
    solve_batched(reqs, mode="vmap", device=device)
    for r in reqs:
        solve_one(r, device=device)
        dsa.solve(r.compiled, {}, n_cycles=r.n_cycles, seed=r.seed,
                  device=device)
    results = solve_batched(reqs, mode="fused", device=device)
    seq_wall, api_wall, fused_wall = med_interleaved([
        lambda: [solve_one(r, device=device) for r in reqs],
        lambda: [
            dsa.solve(r.compiled, {}, n_cycles=r.n_cycles, seed=r.seed,
                      device=device)
            for r in reqs
        ],
        lambda: solve_batched(reqs, mode="fused", device=device),
    ])
    metrics_registry.reset()
    metrics_registry.enabled = True
    try:
        (vmap_wall,) = med_interleaved(
            [lambda: solve_batched(reqs, mode="vmap", device=device)]
        )
    finally:
        metrics_registry.enabled = False
    fresh = int(_sum_metric(metrics_registry, "compile.jit_compiles"))
    hits = int(_sum_metric(metrics_registry, "compile.jit_cache_hits"))
    costs = [
        tr.result.cost for tr in results.values() if tr.result is not None
    ]
    violations = sum(
        tr.result.violations for tr in results.values()
        if tr.result is not None
    )
    pm_dir = tempfile.mkdtemp(prefix="capture_slo_")
    engine = SloEngine(
        [parse_objective("p99<30s"), parse_objective("availability>=99%")],
        eval_interval_s=0.2,
        postmortem_path=os.path.join(pm_dir, "slo_postmortem.json"),
    )
    metrics_registry.reset()
    metrics_registry.enabled = True
    try:
        srv = ServeServer(
            port=None, window_ms=10.0, max_batch=batch, mode="fused",
            device=device, slo=engine,
        )
        for r in reqs:
            srv.submit(r._replace(tenant="q" + r.tenant))
        for r in reqs:
            srv.wait("q" + r.tenant, timeout=300)
        status = srv.status()
        srv.shutdown(drain=True)
    finally:
        metrics_registry.enabled = False
        shutil.rmtree(pm_dir, ignore_errors=True)
    slo_block = engine.bench_block()
    slo_block["alerts"] = len(engine.transitions)
    return {
        "metric": "serving_batch32_wall",
        "value": round(fused_wall, 4),
        "unit": "s",
        "cost": round(float(np.sum(costs)), 6),
        "violations": int(violations),
        "cycles": n_cycles,
        "device": device_platform(device),
        "serving": {
            "tenants": batch,
            "buckets": 2,
            "n_cycles": n_cycles,
            "fused_wall_s": round(fused_wall, 4),
            "vmap_wall_s": round(vmap_wall, 4),
            "sequential_wall_s": round(api_wall, 4),
            "sequential_strict_wall_s": round(seq_wall, 4),
            "speedup": round(api_wall / fused_wall, 2)
            if fused_wall > 0 else None,
            "speedup_vs_strict_loop": round(seq_wall / fused_wall, 2)
            if fused_wall > 0 else None,
            "vmap_speedup": round(api_wall / vmap_wall, 2)
            if vmap_wall > 0 else None,
            "solves_per_s": round(batch / fused_wall, 1)
            if fused_wall > 0 else None,
            "warm_fresh_compiles": fresh,
            "warm_cache_hits": hits,
            "queue_p50_ms": round(status["queue_ms"]["p50"], 2)
            if status["queue_ms"]["p50"] is not None else None,
            "queue_p99_ms": round(status["queue_ms"]["p99"], 2)
            if status["queue_ms"]["p99"] is not None else None,
            "dead_letters": status["dead_letters"],
        },
        "slo": slo_block,
    }


# one partition of config 4's graph a process: config 4's ``ici``
# sub-block and config 9 want the same block, keyed by the problem's
# content so two different graphs never share one
_ICI_100K_CACHE: Dict[Any, Dict] = {}


def _ici_block_100k(n_shards=8, compiled=None):
    from ..durability import problem_fingerprint
    from ..partition import ici_block

    if compiled is None:
        compiled = _problem("4")
    key = (n_shards, problem_fingerprint(compiled))
    if key not in _ICI_100K_CACHE:
        _ICI_100K_CACHE[key] = ici_block(compiled, n_shards, effort="fast")
    return _ICI_100K_CACHE[key]


def config_9_partition100k(device, n_shards=8):
    """Partition quality of config 4's graph for 8 row-block shards: the
    multilevel strategy's cross-shard incidence is the value; the
    ``partition`` block has both strategies' walls, incidences and
    modelled cross-shard bytes a cycle (host only)."""
    block = _ici_block_100k(n_shards)
    return {
        "metric": "partition_100k_incidence",
        "value": block["multilevel"]["incidence"],
        "unit": "frac",
        "n_vars": 100_000,
        "n_shards": n_shards,
        "order_wall_s": block["multilevel"]["order_wall_s"],
        "partition": block,
    }


def config_10_maxsum1m_sharded(device, n_shards=8):
    """Config 6 sharded over 8 devices: refused, by name."""
    raise RuntimeError(
        f"config 10 needs {n_shards} devices and the sharded ELL MaxSum "
        "solve, which the port does not have"
    )


CONFIGS: Dict[str, Callable] = {
    "1": config_1_dsa50,
    "2": config_2_maxsum1k,
    "3": config_3_mgm2_ising10k,
    "4": config_4_maxsum100k,
    "5": config_5_dpop_meetings,
    "6": config_6_maxsum1m,
    "7": config_7_mixeddsa,
    "8": config_8_serving,
    "9": config_9_partition100k,
    "10": config_10_maxsum1m_sharded,
}

# a bare capture: the five baseline configs, serving and partition
# quality; the 1,000,000-variable configs (6, 10) are asked for by name
DEFAULT_CONFIGS = ["1", "2", "3", "4", "5", "8", "9"]

# configs whose records MUST carry a per-op / per-phase kernel block
KERNEL_CONFIGS = {"2", "3", "4"}

METRIC_NAMES = {
    "1": "dsa_coloring50_wall",
    "2": "maxsum_1k_random_wall",
    "3": "mgm2_ising10k_wall",
    "4": "maxsum_100k_scalefree_wall",
    "5": "dpop_meetings_wall",
    "6": "maxsum_1m_scalefree_wall",
    "7": "mixeddsa_2k_mixed_wall",
    "8": "serving_batch32_wall",
    "9": "partition_100k_incidence",
    "10": "maxsum_1m_sharded_wall",
}


def run_config(key: str, device="cuda") -> dict:
    """One config -> one record; an error becomes a ``{value: None,
    error}`` record, so one bad config never silences the rest.  Config
    4's record carries JAX's ``vs_baseline`` unclaimed: the 10 s baseline
    is a TPU target."""
    from ..compile.kernels import resolve_device

    try:
        record = CONFIGS[key](resolve_device(device))
    except Exception as exc:  # noqa: BLE001
        record = {
            "metric": METRIC_NAMES[key],
            "value": None,
            "error": f"{type(exc).__name__}: {exc}"[:300],
        }
    record["config"] = key
    if key == "4" and record.get("value"):
        record["vs_baseline"] = None
        record["vs_baseline_note"] = (
            f"not claimed: ran on {record.get('device')}, the baseline "
            "target is TPU"
        )
        record.setdefault("n_vars", 100_000)
    return record
