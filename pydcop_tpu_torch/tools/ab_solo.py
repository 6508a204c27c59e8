"""Solves that run alone on the card, timed in two checkouts in turns.

    python -m pydcop_tpu_torch.tools.ab_solo OTHER [--reps N] [--rounds R]

``OTHER`` is the root of another checkout of the repository (a ``git
archive`` of another commit, say).  The tool runs the same timing
process four times a round (``--rounds``, 1 by default), in the order
OTHER, this checkout, this checkout, OTHER, each with its own checkout
first on ``sys.path`` (and its own kernel builds), so that both meet
the same card and host in turns.  A process times, after one cold
solve of each:

- ``maxsum_300``: ``solve_result`` of MaxSum (``layout="ell"``, damping
  0.7) for 40,000 cycles on the 300-variable soft scale-free coloring
  of seed 7 (the problem of ``chip_smoke.py``'s ``run_scenario``), seed
  7, with its cost curve;
- ``config4_resume``: bench config 4's MaxSum ``ell`` solve (100,000
  variables, damping 0.7, seed 7) of 3,000 cycles resumed from its
  snapshot at cycle 1,400 (a durable solve snapshots every 100 cycles
  first), the 1,600 cycles of ``chip_smoke.py``'s
  ``fault_kill_resume_config4``.

``--reps`` warm solves of each (3 by default), each wall on the host's
clock up to its result on the host.  Prints one JSON object: the card's
name and power limit, and for each run its checkout, the walls and
their median.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# the timing process, run with a checkout's root first on sys.path; it
# uses only entry points both sides have had since the durable solves
_CHILD = r"""
import json, os, shutil, sys, tempfile, time
reps = int(sys.argv[1])
from pydcop_tpu_torch.algorithms import AlgorithmDef, maxsum
from pydcop_tpu_torch.api import solve_result
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_coloring_arrays, generate_graph_coloring)
from pydcop_tpu_torch.compile.core import compile_dcop
from pydcop_tpu_torch.durability import CheckpointManager, durability

out = {}
dcop = generate_graph_coloring(300, 3, graph="scalefree", m_edge=2,
                               soft=True, seed=7)
compiled = compile_dcop(dcop)
algo = AlgorithmDef.build_with_default_param(
    "maxsum", {"damping": 0.7, "layout": "ell"}, mode=dcop.objective)

def small():
    return solve_result(dcop, algo, n_cycles=40000, seed=7,
                        collect_curve=True, compiled=compiled, device="cuda")

c4 = generate_coloring_arrays(100000, 3, graph="scalefree", m_edge=2, seed=7)
params = {"damping": 0.7, "layout": "ell"}
tmp = tempfile.mkdtemp(prefix="ab_solo_")
durability.configure(manager=CheckpointManager(
    os.path.join(tmp, "trail"), every_cycles=100, keep=1000))
try:
    maxsum.solve(c4, params, n_cycles=3000, seed=7, device="cuda")
finally:
    durability.reset()
snapshot = os.path.join(tmp, "trail", "ckpt-c%09d.npz" % 1400)

def resume():
    durability.configure(resume=snapshot)
    try:
        return maxsum.solve(c4, params, n_cycles=3000, seed=7,
                            device="cuda")
    finally:
        durability.reset()

for name, solve in (("maxsum_300", small), ("config4_resume", resume)):
    first = solve()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = solve()
        walls.append(time.perf_counter() - t0)
    cost = got["cost"] if isinstance(got, dict) else got.cost
    want = first["cost"] if isinstance(first, dict) else first.cost
    out[name] = {"walls_s": walls, "cost": cost, "same_as_cold": cost == want}
shutil.rmtree(tmp, ignore_errors=True)
print(json.dumps(out))
"""


def _run(tree: Path, reps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(reps)], cwd=tree, env=env,
        capture_output=True, text=True, timeout=1200,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"the timing process in {tree} exited {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    other = args.other.resolve()
    runs = []
    for tree in (other, ROOT, ROOT, other) * args.rounds:
        got = _run(tree, args.reps)
        for row in got.values():
            row["median_s"] = statistics.median(row["walls_s"])
        runs.append({"checkout": "this" if tree == ROOT else str(other),
                     **got})
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
