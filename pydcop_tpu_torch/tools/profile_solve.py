"""Where a warm MaxSum solve's time goes on the card.

    python -m pydcop_tpu_torch.tools.profile_solve [--config 4|2] [--reps N]
        [--layout auto|ell|lanes|pallas|edges] [--trace FILE]

Generates bench config 4 (100k-variable scale-free coloring, damping 0.7,
30 cycles, seed 7) or config 2 (1k random, damping 0.5, stop_cycle 60),
solves it once cold under ``--layout`` (MaxSum's ``layout`` parameter;
default ``auto``, which runs ELL on these binary problems), then:

- times ``--reps`` warm solves on the host clock (each ends in a
  read-back, so the device has finished), with the stop-on-stable test on
  (the main path) and off (``stop_cycle`` = the same cycle count), which
  prices the one scalar read-back per cycle;
- traces one warm solve with ``torch.profiler`` and reports the device's
  busy and idle share of the solve's wall, kernel launches per cycle, and
  device time by kernel name.

Prints one JSON object.  Needs a CUDA device; it raises without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..algorithms import maxsum
from ..commands.generators.graphcoloring import generate_coloring_arrays

CONFIGS = {
    4: (
        (100_000, 3, dict(graph="scalefree", m_edge=2, seed=7)),
        {"damping": 0.7}, 30, 7,
    ),
    2: (
        (1000, 3, dict(graph="random", p_edge=0.005, seed=11)),
        {"damping": 0.5, "stop_cycle": 60}, 60, 0,
    ),
}


def _wall(compiled, params, n_cycles, seed) -> float:
    t0 = time.perf_counter()
    maxsum.solve(compiled, params, n_cycles=n_cycles, seed=seed)
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=sorted(CONFIGS), default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument(
        "--layout", default="auto",
        choices=["auto", "ell", "ell_pallas", "lanes", "pallas", "edges"],
    )
    ap.add_argument("--trace", help="write the chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_solve needs a CUDA device")
    (n, d, kw), params, n_cycles, seed = CONFIGS[args.config]
    params = dict(params, layout=args.layout)
    compiled = generate_coloring_arrays(n, d, **kw)
    cold = _wall(compiled, params, n_cycles, seed)
    res = maxsum.solve(compiled, params, n_cycles=n_cycles, seed=seed)
    no_stop = dict(params, stop_cycle=res.cycles)
    _wall(compiled, no_stop, n_cycles, seed)  # warm its cached operands
    walls = [_wall(compiled, params, n_cycles, seed) for _ in range(args.reps)]
    walls_no_stop = [
        _wall(compiled, no_stop, n_cycles, seed) for _ in range(args.reps)
    ]

    acts = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=acts) as prof:
        traced = _wall(compiled, params, n_cycles, seed)
    if args.trace:
        prof.export_chrome_trace(args.trace)
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
    out = {
        "config": args.config,
        "layout": args.layout,
        "device": torch.cuda.get_device_name(0),
        "cycles": res.cycles,
        "cost": res.cost,
        "cold_s": cold,
        "warm_s_median": statistics.median(walls),
        "warm_s_all": walls,
        "warm_no_stop_test_s_median": statistics.median(walls_no_stop),
        "traced_wall_s": traced,
        "device_busy_us": busy_us,
        "device_busy_share": busy_us * 1e-6 / traced,
        "kernels_per_cycle": len(kernels) / res.cycles,
        "top_kernels": [
            {"name": name[:120], "us": t, "count": k}
            for name, (t, k) in top
        ],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
