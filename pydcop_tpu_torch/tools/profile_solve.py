"""Where a warm solve's time goes on the card.

    python -m pydcop_tpu_torch.tools.profile_solve [--algo ALGO]
        [--config 4|6|3|2|5|7|hard10k] [--reps N] [--layout LAYOUT]
        [--precision f32|bf16] [--trace FILE] [--resources N]

``--algo`` is ``maxsum`` (default), ``amaxsum``, ``dsa``, ``adsa``,
``dsatuto``, ``mgm``, ``mgm2``, ``mixeddsa``, ``dba``, ``gdba`` or
``dpop``.  ``--config`` picks the
problem and run of a bench config: 4 (100k-variable scale-free coloring,
30 cycles, seed 7; MaxSum with damping 0.7), 6 (the same at 1,000,000
variables), 3 (the 100x100 Ising grid of
seed 3, 30 cycles, seed 0), 2 (1k random coloring, 60 cycles, seed 0;
MaxSum with damping 0.5 and stop_cycle 60), 7 (bench config 7: the
mixed hard/soft problem of 2,000 variables and 5,050 constraints, 50
cycles, seed 0) or ``hard10k`` (a hard scale-free coloring of 10,000
variables, 100 cycles, seed 0); DPOP runs config 5, meeting scheduling
with 8 slots, 30 events of up to 2 resources, seed 5, and
``--resources`` resources (30, the default, is bench config 5; fewer
share more and widen the tree).  The local-search solvers run their
default params; A-MaxSum runs MaxSum's params of the config (it has no
layouts).  ``--layout`` and ``--precision`` are MaxSum's
``layout`` (default ``auto``) and ``precision`` (default ``f32``).

For DPOP, whose solve is one UTIL wave and not a cycle loop, the tool
times the cold and warm solves, the fused wave's graph alone by CUDA
events (when the problem takes the fused path), a ``torch.profiler``
trace and a ``cProfile`` of one warm solve.

The tool solves once cold, then:

- times ``--reps`` warm solves on the host clock (each ends in its
  result's read-back, so the device has finished); for MaxSum also with
  the stop-on-stable test off (``stop_cycle`` = the cycles run);
- counts what a warm solve does: graph captures (0 when warm), chunk
  replays, iterations replayed, host syncs, and each kernel's launches;
- times the solve's captured graphs alone by CUDA events (the prologue
  once, the chunk over back-to-back replays), so the device's busy time
  of a warm solve is ``prologue + replays x chunk`` without a tracer,
  and its idle share is the rest of the warm wall;
- traces one warm solve with ``torch.profiler``: kernel time by name and
  the device's busy share as the tracer sees it;
- profiles one warm solve's host side with ``cProfile``: the functions
  with the most cumulative time (waits on the device included).

Prints one JSON object.  Needs a CUDA device; it raises without one.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import time

import torch

from ..algorithms import base, load_algorithm_module
from ..commands.generators.graphcoloring import (
    generate_coloring_arrays,
    generate_graph_coloring,
)
from ..commands.generators.ising import generate_ising_arrays
from ..commands.generators.meetingscheduling import (
    generate_meeting_scheduling,
)
from ..commands.generators.mixedproblem import generate_mixed_problem
from ..compile import hopper_kernels
from ..compile.core import compile_dcop

# config: (problem, n_cycles, seed, MaxSum's params)
CONFIGS = {
    "4": (
        lambda: generate_coloring_arrays(
            100_000, 3, graph="scalefree", m_edge=2, seed=7
        ),
        30, 7, {"damping": 0.7},
    ),
    "6": (
        lambda: generate_coloring_arrays(
            1_000_000, 3, graph="scalefree", m_edge=2, seed=7
        ),
        30, 7, {"damping": 0.7},
    ),
    "3": (lambda: generate_ising_arrays(100, 100, seed=3), 30, 0, {}),
    "2": (
        lambda: generate_coloring_arrays(
            1000, 3, graph="random", p_edge=0.005, seed=11
        ),
        60, 0, {"damping": 0.5, "stop_cycle": 60},
    ),
    "7": (
        lambda: compile_dcop(generate_mixed_problem(
            2000, 2000, 0.4, arity=2, domain_range=5, density=0.0025,
            seed=13,
        )),
        50, 0, {},
    ),
    "hard10k": (
        lambda: compile_dcop(generate_graph_coloring(
            10_000, 3, graph="scalefree", m_edge=2, soft=False, seed=7,
        )),
        100, 0, {},
    ),
}
KERNELS = ("ell_minplus", "factor_arity2_minplus", "xla_tree_sum",
           "damp_fma")
COUNTERS = ("captures", "replays", "iterations", "host_syncs")


def _counted(solve):
    """(result, wall seconds, engine and kernel counts) of one solve."""
    before = {k: getattr(base.run_cycles, k) for k in COUNTERS}
    before.update(
        {k: getattr(hopper_kernels, k).launches for k in KERNELS}
    )
    t0 = time.perf_counter()
    res = solve()
    wall = time.perf_counter() - t0
    counts = {k: getattr(base.run_cycles, k) - before[k] for k in COUNTERS}
    counts.update({
        k: getattr(hopper_kernels, k).launches - before[k] for k in KERNELS
    })
    return res, wall, counts


def _graph_ms(graph, reps: int = 20) -> float:
    """Device time of one replay of ``graph``, by CUDA events around
    ``reps`` back-to-back replays."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _traced(solve, trace=None) -> dict:
    """One solve under ``torch.profiler``: its device busy share and the
    kernels with the most device time."""
    acts = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        traced = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "traced_wall_s": traced,
        "traced_device_events": len(kernels),
        "traced_device_busy_us": busy_us,
        "traced_device_busy_share": busy_us * 1e-6 / traced,
        "top_kernels": [
            {"name": name[:120], "us": t, "count": k}
            for name, (t, k) in top
        ],
    }


def _host_profile(solve) -> list:
    """The functions with the most cumulative host time in one solve
    (waits on the device included)."""
    host = cProfile.Profile()
    host.runcall(solve)
    text = io.StringIO()
    pstats.Stats(host, stream=text).sort_stats("cumulative").print_stats(14)
    return [
        line.strip() for line in text.getvalue().splitlines()
        if line.strip()[:1].isdigit()
    ]


def _profile_dpop(args) -> dict:
    from ..algorithms import dpop

    compiled = compile_dcop(generate_meeting_scheduling(
        slots_count=8, resources_count=args.resources, events_count=30,
        max_resources_event=2, seed=5,
    ))

    def solve():
        return dpop.solve(compiled, {}, device="cuda")

    t0 = time.perf_counter()
    res = solve()
    cold = time.perf_counter() - t0
    walls, chunks = [], dpop.solve.chunks
    for _ in range(args.reps):
        t0 = time.perf_counter()
        again = solve()
        walls.append(time.perf_counter() - t0)
    out = {
        "algo": "dpop", "config": 5, "resources": args.resources,
        "device": torch.cuda.get_device_name(0),
        "n_vars": compiled.n_vars, "max_domain": compiled.max_domain,
        "cost": res.cost, "violations": res.violations,
        "msg_count": res.msg_count, "msg_size": res.msg_size,
        "cold_s": cold, "warm_s_median": statistics.median(walls),
        "warm_s_all": walls, "warm_solves_equal": again == res,
        "chunks_per_solve": (dpop.solve.chunks - chunks) // args.reps,
        "fused": compiled._device_consts[("dpop_fused_plan",)] is not None,
    }
    if out["fused"]:
        wave = compiled._device_consts[("dpop_fused_wave", "cuda")]
        busy_ms = _graph_ms(wave.graph)
        out.update({
            "batches": len(wave.ops),
            "wave_graph_ms": busy_ms,
            "device_idle_share_untraced": (
                1.0 - busy_ms * 1e-3 / out["warm_s_median"]
            ),
        })
    out.update(_traced(solve, args.trace))
    out["host_profile"] = _host_profile(solve)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--algo", default="maxsum",
        choices=["maxsum", "amaxsum", "dsa", "adsa", "dsatuto", "mgm",
                 "mgm2", "mixeddsa", "dba", "gdba", "dpop"],
    )
    ap.add_argument(
        "--config", choices=sorted(CONFIGS) + ["5"], default="4"
    )
    ap.add_argument("--resources", type=int, default=30)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument(
        "--layout", default="auto",
        choices=["auto", "ell", "ell_pallas", "lanes", "pallas", "edges"],
    )
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--trace", help="write the chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_solve needs a CUDA device")
    if (args.algo == "dpop") != (args.config == "5"):
        ap.error("config 5 is DPOP's, and DPOP runs config 5 only")
    if args.algo == "dpop":
        out = _profile_dpop(args)
        print(json.dumps(out))
        return out
    make, n_cycles, seed, maxsum_params = CONFIGS[args.config]
    mod = load_algorithm_module(args.algo)
    params = {
        "maxsum": dict(
            maxsum_params, layout=args.layout, precision=args.precision
        ),
        "amaxsum": dict(maxsum_params),
    }.get(args.algo, {})
    compiled = make()

    def solve(p=params):
        return mod.solve(compiled, p, n_cycles=n_cycles, seed=seed)

    res, cold, cold_counts = _counted(solve)
    warm = [_counted(solve) for _ in range(args.reps)]
    walls = [w for _, w, _ in warm]
    warm_counts = warm[-1][2]
    out = {
        "algo": args.algo,
        "config": int(args.config) if args.config.isdigit() else args.config,
        "layout": args.layout if args.algo == "maxsum" else None,
        "precision": args.precision if args.algo == "maxsum" else None,
        "device": torch.cuda.get_device_name(0),
        "n_vars": compiled.n_vars,
        "cycles": res.cycles,
        "cost": res.cost,
        "violations": res.violations,
        "cold_s": cold,
        "cold_counts": cold_counts,
        "warm_s_median": statistics.median(walls),
        "warm_s_all": walls,
        "warm_counts": warm_counts,
        "warm_solves_equal": all(r == res for r, _, _ in warm),
    }
    if args.algo == "maxsum":
        no_stop = dict(params, stop_cycle=res.cycles)
        solve(no_stop)  # cold: its own graphs
        out["warm_no_stop_test_s_median"] = statistics.median(
            _counted(lambda: solve(no_stop))[1] for _ in range(args.reps)
        )

    # the device's busy time of a warm solve, untraced: its graphs alone
    # (the ones captured first; MaxSum's run without the stop test has
    # its own when the main solve has the test)
    graphs = next(
        v for k, v in compiled._device_consts.items()
        if k[0] == "cycle_graphs"
    )
    prologue_ms = _graph_ms(graphs.prologue)
    chunk_ms = _graph_ms(graphs.chunk)
    busy_ms = prologue_ms + warm_counts["replays"] * chunk_ms
    out.update({
        "chunk_length": graphs.solver.length,
        "prologue_ms": prologue_ms,
        "chunk_ms": chunk_ms,
        "iteration_ms": chunk_ms / graphs.solver.length,
        "device_busy_ms_untraced": busy_ms,
        "device_idle_share_untraced": (
            1.0 - busy_ms * 1e-3 / out["warm_s_median"]
        ),
    })

    traced = _traced(solve, args.trace)
    traced["traced_kernels_per_iteration"] = (
        traced["traced_device_events"] / max(warm_counts["iterations"], 1)
    )
    out.update(traced)
    out["host_profile"] = _host_profile(solve)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
