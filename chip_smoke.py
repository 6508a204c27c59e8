#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pydcop_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  It
builds every Hopper kernel from ``pydcop_tpu_torch/csrc/``, holds each one
against its plain PyTorch version on the card, then drives the port's main
path (MaxSum on the ELL layout) at bench config 4's size and at config 2's,
and checks the results against the same solve on the CPU.  It prints one
JSON object per phase, then the kernel table, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits nonzero; it also exits nonzero, with no
result, when no CUDA device is present or the package is not beside it.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

CONFIG_4 = dict(
    gen=(100_000, 3, dict(graph="scalefree", m_edge=2, seed=7)),
    params={"damping": 0.7}, n_cycles=30, seed=7,
)
CONFIG_2 = dict(
    gen=(1000, 3, dict(graph="random", p_edge=0.005, seed=11)),
    params={"damping": 0.5, "stop_cycle": 60}, n_cycles=60, seed=0,
)
SMALL_CASES = {
    "scalefree150": (150, 3, dict(graph="scalefree", m_edge=2, seed=13)),
    "clique12": (12, 3, dict(graph="random", p_edge=1.0, seed=3)),
    "grid36": (36, 3, dict(graph="grid", seed=4)),
    "scalefree2000_d16": (2000, 16, dict(graph="scalefree", m_edge=2, seed=1)),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def generate(spec):
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_coloring_arrays,
    )

    n, d, kw = spec
    return generate_coloring_arrays(n, d, **kw)


def ell_inputs(compiled, device, seed=0):
    """The ELL operands of ``compiled`` on ``device`` plus a random
    variable->factor plane (zero on padding slots)."""
    import torch

    from pydcop_tpu_torch.compile.kernels import build_ell

    ell = build_ell(compiled)
    g = torch.Generator(device=device).manual_seed(seed)
    real = torch.as_tensor(ell.real_row, device=device)
    v2f = torch.randn(
        (compiled.max_domain, ell.n_pad), generator=g, device=device
    ) * real
    return ell, (
        v2f,
        torch.as_tensor(ell.pair_perm, device=device),
        torch.as_tensor(ell.tabs_t, device=device),
        real,
    )


def ell_minplus_bound(ell, d: int):
    """(bound_ms, bound_by, bytes, ops) of one ell_minplus call: each input
    byte this data needs read once, each output written once (tables,
    partner values and the index of real slots; mask and output of every
    slot), against the H100's HBM rate and float32 rate."""
    n_real = int(ell.real_row.sum())
    nbytes = n_real * (d * d * 4 + d * 4 + 4) + ell.n_pad * (1 + d * 4)
    ops = n_real * (2 * d * d - d)  # d*d adds, d*(d-1) mins per own value
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (
        1e3 * max(t_bytes, t_ops),
        "bytes" if t_bytes >= t_ops else "operations",
        nbytes, ops,
    )


def time_cuda_ms(fn, arg_sets, rounds: int = 8, reps: int = 5) -> float:
    """Median device time of one ``fn(*args)`` call.  Each of ``reps``
    batches launches ``fn`` on every operand set in turn, ``rounds`` times,
    between one pair of CUDA events.  The sets together exceed the 50 MB
    L2, so each call reads its operands from device memory, as in the
    solve, where the other passes of a cycle evict them."""
    import torch

    for args in arg_sets:  # warm-up
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(rounds):
            for args in arg_sets:
                fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (rounds * len(arg_sets)))
    return statistics.median(times)


def phase_device():
    import torch

    smi = nvidia_smi()
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return smi


def phase_build():
    from pydcop_tpu_torch.compile import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "libraries": {k: str(p.relative_to(ROOT)) for k, p in paths.items()},
    })


def phase_kernels(c4):
    """ell_minplus against ell_minplus_plain on the card, exactly, at the
    main path's shape (config 4), the small test cases and a D=16 layout;
    timed at the main path's shape."""
    import torch

    from pydcop_tpu_torch.compile.hopper_kernels import (
        ell_minplus,
        ell_minplus_plain,
    )

    shapes = {"config4": c4}
    shapes.update({k: generate(v) for k, v in SMALL_CASES.items()})
    checked = {}
    max_err = 0.0
    for name, compiled in shapes.items():
        ell, args = ell_inputs(compiled, "cuda")
        got = ell_minplus(*args)
        want = ell_minplus_plain(*args)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = float((got - want).abs().max())
        checked[name] = {
            "n_pad": ell.n_pad, "d": compiled.max_domain, "equal": equal,
            "max_abs_err": err,
        }
        check(equal, f"ell_minplus != ell_minplus_plain on {name}: {err}")
        max_err = max(max_err, err)
        if name == "config4":
            # 4 operand sets of ~33 MB each (inputs + output)
            sets = [args] + [[a.clone() for a in args] for _ in range(3)]
            kernel_ms = time_cuda_ms(ell_minplus, sets)
            plain_ms = time_cuda_ms(ell_minplus_plain, sets)
            bound_ms, bound_by, nbytes, ops = ell_minplus_bound(
                ell, compiled.max_domain
            )
    emit({"phase": "kernels", "shapes": checked})
    return {
        "name": "ell_minplus",
        "route": "cuda",
        "source": "pydcop_tpu_torch/csrc/ell_minplus.cu",
        "replaces": "pydcop_tpu/compile/pallas_kernels.py:167",
        "launches": None,  # filled from the main path's run
        "equal": True,
        "tolerance": "exact (torch.equal)",
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_bytes": nbytes,
        "bound_ops": ops,
        "library_ms": None,  # no one PyTorch call does gather+add+min+mask
    }


def phase_solve(name, compiled, spec):
    """One config through ``maxsum.solve`` on the card, cold then warm,
    counting ell_minplus launches, then the same solve on the CPU."""
    import numpy as np

    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.compile.hopper_kernels import ell_minplus

    def run(device):
        ell_minplus.launches = 0
        t0 = time.perf_counter()
        res = maxsum.solve(
            compiled, spec["params"], n_cycles=spec["n_cycles"],
            seed=spec["seed"], device=device,
        )
        return res, time.perf_counter() - t0, ell_minplus.launches

    cold, cold_s, launches = run("cuda")
    check(
        launches == cold.cycles > 0,
        f"{name}: ell_minplus launched {launches} times in "
        f"{cold.cycles} cycles",
    )
    warm, warm_s, warm_launches = run("cuda")
    check(warm_launches == warm.cycles, f"{name}: warm launch count")
    check(warm == cold, f"{name}: warm solve differs from cold solve")
    cpu, cpu_s, cpu_launches = run("cpu")
    check(cpu_launches == 0, f"{name}: the CPU solve launched the kernel")
    vals = np.array([cold.assignment[v] for v in compiled.var_names])
    check(
        len(vals) == compiled.n_vars
        and vals.min() >= 0 and vals.max() < compiled.max_domain,
        f"{name}: assignment out of domain",
    )
    check(np.isfinite(cold.cost), f"{name}: cost not finite")
    check(
        (cold.cost, cold.violations) == compiled.host_cost(vals),
        f"{name}: reported cost is not the assignment's cost",
    )
    check(
        cold.violations == cpu.violations
        and abs(cold.cost - cpu.cost) <= 1e-5 * abs(cpu.cost),
        f"{name}: cuda cost {cold.cost}/{cold.violations} vs cpu "
        f"{cpu.cost}/{cpu.violations}",
    )
    emit({
        "phase": name, "n_vars": compiled.n_vars,
        "n_edges": compiled.n_edges, "params": spec["params"],
        "cold_s": cold_s, "warm_s": warm_s,
        "warm_ms_per_cycle": 1e3 * warm_s / warm.cycles,
        "cost": cold.cost, "violations": cold.violations,
        "cycles": cold.cycles, "ell_minplus_launches": launches,
        "cpu_s": cpu_s, "cpu_cost": cpu.cost,
        "cpu_violations": cpu.violations, "cpu_cycles": cpu.cycles,
        "same_assignment_as_cpu": cold.assignment == cpu.assignment,
    })
    return launches


def main() -> int:
    if not (ROOT / "pydcop_tpu_torch" / "compile").is_dir():
        print(
            "chip_smoke.py: pydcop_tpu_torch/ is not beside this script; "
            "run it from a checkout of the repository", file=sys.stderr,
        )
        return 2
    import torch

    if not torch.cuda.is_available():
        print(
            "chip_smoke.py: torch.cuda.is_available() is False; this "
            "script needs an NVIDIA GPU", file=sys.stderr,
        )
        return 1
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    phase_build()
    c4 = generate(CONFIG_4["gen"])
    kernel = phase_kernels(c4)
    kernel["launches"] = phase_solve("maxsum_100k", c4, CONFIG_4)
    phase_solve("maxsum_1k", generate(CONFIG_2["gen"]), CONFIG_2)
    emit({"kernels": [kernel]})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
