#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pydcop_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--against DIR [DIR ...]]

Run from the root of a checkout on a machine with an NVIDIA H100.  It
builds every Hopper kernel from ``pydcop_tpu_torch/csrc/`` (printing each
instantiation's registers and spills as ``ptxas`` reports them), holds
each one against its plain PyTorch version on the card, times both by
CUDA-graph replay at the main path's shape, then drives the port's
solvers through their entry points, each solve running as replays of its
captured CUDA graphs:

- ``maxsum.solve``: the ELL layout at bench config 4's size (the main
  path), at config 6's (1,000,000 variables, against the JAX package's
  pinned cost) and at config 2's, the lanes layout (``layout="pallas"``) at
  config 4's size, the lanes and edges layouts at config 2's, and
  ``layout="auto"`` on a mixed binary + ternary problem, which runs
  lanes; each must give the result recorded before the graphs;
- ``maxsum.solve`` with ``precision="bf16"`` (both message planes in
  bfloat16, both kernels given a bf16 plane): config 4 on ``ell`` and
  ``pallas``, config 2 on ``ell``, ``lanes`` and ``edges``, each giving
  the JAX package's pinned cost;
- ``dsa``, ``mgm`` and ``mgm2.solve`` at config 4's problem, MGM-2 at
  bench config 3 (the 100x100 Ising grid) and on the mixed problem;
- ``mixeddsa``, ``dba`` and ``gdba.solve`` at bench config 7 (2,000
  variables, 5,050 constraints, 40% hard), DBA and GDBA on a
  10,000-variable hard coloring, and DSA on the 80-variable hard coloring
  whose anytime best needs ``evaluate``'s sums in XLA's order: each
  identical to the CPU, assignment included, and to the JAX package's
  pinned result;
- the timeout: MaxSum at config 4 with a budget it does not reach, and
  DSA with one it does;
- the object-level front door (``front_door_yaml``): two YAML instances
  of ``tests/instances/`` and the README's 1,000-variable problem,
  written with ``dcop_yaml``, solved by ``python -m pydcop_tpu_torch
  solve`` on the card (a subprocess, whose JSON must equal the CPU's
  in-process ``solve_result``) and in process on the card, under
  ``auto`` (``ell_minplus``) and once under ``layout:pallas``
  (``factor_arity2_minplus``); skipped, with one line saying so, only
  when PyYAML cannot be imported;
- the object path at config-4 scale (``front_door_objects``):
  ``generate_graph_coloring`` -> ``compile_dcop`` -> ``solve_result``
  (MaxSum) on the card, cold and warm, against the CPU, with the host
  seconds of each stage;
- DPOP (``dpop_config5``): bench config 5 (meeting scheduling), whose
  UTIL wave is one captured graph (1 capture cold, 0 warm), against the
  CPU and the JAX package's result; and (``dpop_wide``) the wider
  instances of the same generator, its streaming path and its chunked
  path, against the JAX package's results pinned here;
- ``adsa`` (defaults, variants A and C), ``dsatuto`` and ``amaxsum.solve``
  at config 4's problem, each identical to the CPU and to the JAX
  package's pinned cost and message count;
- the resident ``DynamicMaxSum`` session (``dynamic_config4``) on config
  4 as 299,996 relation objects: run, run, ``change_factor_function``,
  run, on the card and on the CPU, every cycle through
  ``factor_arity2_minplus``; a warm run and the run after the change
  capture nothing, and the graph cache keeps its size;
- SyncBB and NCBB (``syncbb_24``, ``ncbb_24``) on a 24-variable soft
  coloring: one launch of the port's ``branch_bound`` kernel a solve
  (1,753,768 and 73,176 DFS steps), against the JAX package's pinned
  result and assignment;
- the serving path (``serve``): bench config 8 (``serve_config8``: 32
  DSA tenants in two shape buckets) through ``solve_batched`` in both
  modes, cold and warm: each vmap tenant the bits of its card
  ``solve_one`` and of the CPU's, the fused tenants the CPU's, their
  summed cost the JAX package's; a warm batch captures nothing and
  launches what one solo solve of its bucket launches; walls beside the
  strict (``solve_one``) and API (``dsa.solve``) loops.  MaxSum on 32
  grid colorings of 1,024 variables (``serve_maxsum_grid``, and 8 with
  bf16 planes): ``ell_minplus`` once an iteration for all 32 tenants.
  ``ServeServer`` in both modes and its HTTP front (``serve_server``).
  The batched kernels (one launch for K instances) are held to their
  plain versions instance by instance at K=32 and timed beside 32 solo
  launches (the kernel line's ``*_batched`` rows);
- health telemetry (``pulse_config4``): MaxSum on ``ell`` and DSA at
  config 4 with pulse on and off: the health rows the CPU's bit for bit
  and the JAX package's pinned rows, the result the pulse-off result,
  equal host syncs, no warm capture, kernels and µs an iteration either
  way;
- durable solves (``durable_config4``, ``durable_config6``): DSA, MGM-2
  and MaxSum with noise at config 4 and MaxSum at config 6, a snapshot
  every 10 of 30 cycles; every resume gives the uninterrupted result,
  across card and CPU both ways, and config 6 resumed from cycle 10 the
  JAX package's pinned cost; snapshot bytes and seconds, resume walls;
- a crash through the CLI (``kill_resume_cli``): a checkpointed ``solve``
  SIGKILLed after its first manifest, ``solve --resume`` printing the
  uninterrupted JSON, the ``checkpoints`` verb listing the directory and
  the ``postmortem`` verb rendering a timed-out pulse solve's dump;
- MaxSum's float32 damping as XLA's single-rounded FMA (``fma_config4``,
  ``fma_config6``): both damping sites one ``damp_fma`` launch each, the
  JAX package's pinned costs, kernels and µs an iteration beside the same
  solve damped in the plain torch form, and at config 4 the final message
  planes the CPU's bit for bit;
- serving with pulse on (``serve_pulse``): config 8's DSA tenants and 32
  MaxSum grid tenants at damping 0.7, each tenant's health rows the CPU
  batch's bit for bit, as many host syncs as with pulse off, no warm
  capture, launches and µs a bucket iteration on and off; the ``serve``
  verb in a subprocess drained by SIGTERM into its fleet checkpoint
  (``serve_fleet_checkpoint``);
- a scenario replay (``replay_session``): a ``ScenarioSession`` killed in
  a subprocess after its first checkpoint and resumed onto the
  uninterrupted run, which equals the CPU's;
- ``solve --trace-out/--metrics-out`` (``trace_cli``): the engine's
  window and read-back spans and metrics with the JAX package's names,
  the windows' cycles adding up to the solve's;
- a config-4 durable MaxSum solve in a child process killed by a
  ``kill_process`` fault schedule and resumed here bit for bit
  (``fault_kill_resume_config4``);
- the ``generate`` verb for all nine families, no card visible, each
  file's sha256 the JAX package's (``generate_verb``); MaxSum at damping
  0.7 and DSA on the generated IoT (1,000 variables), small-world
  (10,000) and SECP problems, against the CPU and the JAX package's
  pinned costs (``generated_*``); ``solve --fault-schedule`` killing the
  CLI after the solve returned and mid-solve, each exiting 137 and
  resumed to the uninterrupted JSON (``fault_kill_resume_cli``); and a
  ``ServeServer`` whose schedule kills ``dead*`` tenants and holds
  ``hold*`` ones, the others keeping their solo bits
  (``serve_fault_schedule``);
- the memory plane (``memory``): the model's device table held to the
  card's reported memory and bandwidth; MaxSum (``ell``, ``lanes``,
  ``pallas``), DSA and GDBA at config 4, MGM-2 at config 3 and DPOP at
  config 5, each solved cold and warm on a fresh copy of its problem,
  its rise in peak allocated memory printed beside
  ``predict_solve_bytes`` and the workspace factor it implies; config 6
  (MaxSum ``ell``), out of the fit, solved under the guard with the
  card's own limit and predicted within ``MEMORY_HELD_RATIO`` of its
  rise; a solve refused under ``limit_bytes`` that leaves
  ``memory_allocated`` as it was; and a serve admission refused over
  HTTP with a 503 that carries the breach (``mem``);
- serving's live surface (``serve_observability``): the serve grid's 32
  MaxSum tenants POSTed as YAML to a ``ServeServer`` with the registry,
  the tracer, pulse and an SLO engine on and a schedule killing
  ``dead*``, scraped (``/metrics`` classic and OpenMetrics,
  ``/metrics.json``, ``/status``, ``/healthz``, ``/slo``) while their
  batch runs; then the same problems as one warm batch and a killed
  tenant's trace id resubmitted.  The survivors equal a plain batch bit
  for bit, the warm batch captures nothing and launches what the plain
  one does, the counts add up, exemplars carry submitted trace ids, the
  availability alert fires with its postmortem, ``watch --once --json``
  reads the server without importing torch, and the ``telemetry`` verb
  validates the trace and reads the registry;
- the HA serve fleet (``serve_fleet_ha``): ``python -m pydcop_tpu_torch
  router --spawn 2 --placement affinity`` with two ``serve`` workers on
  the card, 8 of the serve grid's problems (MaxSum and DSA, two affinity
  buckets) POSTed as YAML: the placement is ``tpu_part``'s and each
  bucket ran on one worker; the same problems again with the MaxSum
  worker SIGKILLed while its tenants wait in its window, every tenant
  done with its first result bit for bit after one failover; the
  ``fleet`` verb's federated counters monotone through the kill and the
  victim's restart on its port, a counter reset counted, ``watch
  --fleet`` showing both workers; the router drained by SIGTERM.  It
  prints the seconds from the kill to ``fleet.worker_up == 0`` and to
  the last failed-over tenant done, the router's forward overhead, the
  batches that captured graphs on each worker and its own wall;
- profiling and capture (``profile_capture``): the README's
  1,000-variable YAML solved by ``python -m pydcop_tpu_torch solve
  --profile-out --dump-hlo`` (a subprocess), whose JSON must equal the
  front door's run without the flags, whose ``torch.profiler`` trace must
  show ``ell_minplus``, ``xla_tree_sum``'s and ``damp_fma``'s kernels
  inside the ``solve.maxsum.*`` ranges, with one DOT file a captured
  graph; then ``capture -o DIR --configs 2 3 4 --no-profiler`` on the
  card (a subprocess): every kernel config's per-op attribution present, the
  costs the pins held here (config 3's the CPU's), config 4's
  attribution within 90-110% of its real step, its kernel block printed;
  and ``capture diff DIR DIR`` exiting 0.

Each solve of the cycle engine runs cold (it captures its graphs) and warm (it must capture
nothing), is checked against the same solve on the CPU, and counts from
zero each kernel's launches (launches an iteration times the iterations
its graphs replayed), its replays and its host syncs (O(log n_cycles)).
Every solve also launches the port's own kernel ``xla_tree_sum``: the
anytime-best total of ``evaluate`` (and MaxSum's ELL fan-in and sum over
the domain) summed in XLA-CPU's order, one launch a sum site.  It prints
one JSON object per phase, then the kernel table (seven rows: both TPU
kernels with a float32 and with a bf16 plane, ``xla_tree_sum``, the DFS
kernel ``branch_bound``, held equal to its plain version at 16
variables, and ``damp_fma``; and the six batched variants' rows; each
row with its ``batched_launches``, ``memory_launches`` and
``observability_launches``), the card's
name and power limit, and as its last line ``{"ok": true, "device":
{...}}``.  Any failed check raises, so the script exits nonzero; it also
exits nonzero, with no result, when no CUDA device is present or the
package is not beside it.

``--against DIR ...`` adds one phase before the solves: the kernels of
each other checkout (another commit unpacked with ``git archive``, or a
variant of ``csrc/``; same ``*_launch`` signatures) are built, held
equal to this checkout's and timed against them on the same operand
sets, in turns: theirs, ours, ours, theirs.
"""

import argparse
import dataclasses
import functools
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
# bench config 6 (bench_all.py): config 4's generator and run at
# 1,000,000 variables
CONFIG_6 = dict(
    gen=(1_000_000, 3, dict(graph="scalefree", m_edge=2, seed=7)),
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
    # past the TPU kernels' domain limit of 16
    "scalefree2000_d20": (2000, 20, dict(graph="scalefree", m_edge=2, seed=2)),
    # the kernels' cut points: D=2 (several slots a thread), 5 (the last D
    # with two), 8 (the last with whole-table loads); D=17 is the first D
    # of the runtime-D kernels
    "scalefree2000_d2": (2000, 2, dict(graph="scalefree", m_edge=2, seed=3)),
    "scalefree2000_d5": (2000, 5, dict(graph="scalefree", m_edge=2, seed=4)),
    "scalefree2000_d8": (2000, 8, dict(graph="scalefree", m_edge=2, seed=5)),
    "scalefree2000_d17": (2000, 17, dict(graph="scalefree", m_edge=2, seed=6)),
}
# random operands (not a generated problem) whose element count is no
# multiple of the slots a thread takes times the block size, and above
# the threads the card holds at once, so the grid-stride loop makes
# several passes and the last one is ragged: (elements, D)
RAGGED = (2_500_001, 3)
# a mixed binary + ternary problem (mixed_problem_fields) under
# layout="auto", which runs lanes: ELL cannot represent it
MIXED = dict(params={"damping": 0.5}, n_cycles=30, seed=3)
# bench config 3: MGM-2 on the 100x100 periodic Ising grid of seed 3
CONFIG_3 = dict(gen=(100, 100, 1.6, 0.05, 3), n_cycles=30, seed=0)
# MaxSum's (cost, violations, cycles) on these problems before its cycle
# loop ran as captured graphs, on the card (configs 4 and 2, exact), and
# the JAX package's on the mixed problem (JAX_PLATFORMS=cpu; held within
# rel 1e-5 as the card is to the CPU): the graphs must not move them.  The
# mixed problem has forbidden tuples; its earlier record, (25877.82552429683,
# 22, 30), was another cycle's, kept while evaluate summed in torch's order
# (tests/test_torch_maxsum.py::test_chip_smoke_mixed_record_is_jaxs solves
# it with both packages)
MAXSUM_RECORDED = {
    "config4": (18768.492959813426, 0, 30),
    "config2": (176.00823494198994, 0, 60),
    "mixed": (25513.102097259267, 20, 30),
}
# MaxSum at bench config 6: (cost, violations, cycles) of the JAX package
# on a CPU (JAX_PLATFORMS=cpu, jax 0.9.0); the port's CPU solve gives the
# same cost and assignment, so the card is held to it exactly
MAXSUM_CONFIG6_JAX = (178376.01337974897, 0, 30)
# MaxSum with precision="bf16": (cost, violations, cycles) of the JAX
# package on a CPU (JAX_PLATFORMS=cpu, jax 0.9.0); config 2's is the same
# on every layout
MAXSUM_BF16_JAX = {
    "config4_ell": (18801.9568355224, 0, 30),
    "config4_pallas": (18799.51088023531, 0, 30),
    "config2": (176.9906821902914, 0, 60),
}
# bench config 7 (bench_all.py): generate_mixed_problem's arguments; it
# makes 5,050 constraints (the density's graph), 40% of them hard
CONFIG_7 = ((2000, 2000, 0.4), dict(arity=2, domain_range=5, density=0.0025,
                                     seed=13))
# a hard scale-free coloring of 10,000 variables, and the 80-variable hard
# coloring whose anytime best differed from JAX's while evaluate summed in
# torch's order: generate_graph_coloring's arguments
HARD_10K = (10_000, 3, dict(graph="scalefree", m_edge=2, soft=False, seed=7))
HARD_80 = (80, 3, dict(graph="random", p_edge=0.07, soft=False, seed=1))
# the breakout and mixed solves: (phase, algo, problem, params, n_cycles,
# seed, the JAX package's (cost, violations, cycles) on a CPU)
BREAKOUT = [
    ("mixeddsa_config7", "mixeddsa", "config7", {}, 50, 0,
     (1925.9599999999969, 0, 50)),
    ("dba_config7", "dba", "config7", {}, 50, 0,
     (3908.4600000000037, 0, 50)),
    ("gdba_config7", "gdba", "config7", {}, 50, 0,
     (2189.669999999992, 0, 50)),
    ("dba_hard10k", "dba", "hard10k", {}, 100, 0, (0.0, 101, 100)),
    ("gdba_hard10k", "gdba", "hard10k", {}, 100, 0, (0.0, 556, 100)),
    ("dsa_hard80", "dsa", "hard80", {}, 60, 0, (0.0, 12, 60)),
]
# the JAX package's assignment of dsa_hard80, as value indices in
# variable order
DSA_HARD80_JAX_VALUES = (
    "21110220021122102211122101022120200221000002100021112120101202012020"
    "001201100200"
)
# the local-search solves: (phase, algo, problem, params, n_cycles, seed);
# their default params (DSA variant B, MGM lexic, MGM-2 unilateral)
LOCAL_SEARCH = [
    ("dsa_100k", "dsa", "config4", {}, 30, 7),
    ("mgm_100k", "mgm", "config4", {}, 30, 7),
    ("mgm2_100k", "mgm2", "config4", {}, 30, 7),
    ("mgm2_ising", "mgm2", "config3", {}, CONFIG_3["n_cycles"],
     CONFIG_3["seed"]),
    ("mgm2_mixed", "mgm2", "mixed", {}, 30, 3),
]
# A-DSA, DSA-tuto and A-MaxSum at config 4's problem, 30 cycles, seed 7:
# (phase, algo, params, the JAX package's (cost, violations, cycles) on a
# CPU, JAX_PLATFORMS=cpu); each sends ASYNC_MSG_COUNT messages
ASYNC = [
    ("adsa_100k", "adsa", {}, (8676.428238737793, 0, 30)),
    ("adsa_100k_A", "adsa", {"variant": "A"}, (8676.428238737793, 0, 30)),
    ("adsa_100k_C", "adsa", {"variant": "C"}, (8676.428238737793, 0, 30)),
    ("dsatuto_100k", "dsatuto", {}, (8817.456954946329, 0, 30)),
    ("amaxsum_100k", "amaxsum", {"damping": 0.7},
     (20026.94531815924, 0, 30)),
]
ASYNC_MSG_COUNT = 11_999_760
# the resident session on config 4's objects (OBJECTS_100K),
# DynamicMaxSum(dcop, {"damping": 0.7}, seed=7): the JAX package's cost
# after each run(30), the last after DYNAMIC_CHANGE.  The session damps
# as XLA-CPU's contracted FMA (``damp``'s ``fma``), so the port gives all
# three exactly, on the CPU and on the card
DYNAMIC_JAX = (18768.49297691747, 18655.444915655473, 21268.952449623033)
DYNAMIC_CHANGE = ("cost_0", "10 if v00000 == v00002 else 0",
                  ("v00000", "v00002"))
# SyncBB and NCBB: generate_graph_coloring's arguments of the chip cell
# and of the kernel's complete check against its plain version (25,872
# SyncBB steps, which the plain step runs in seconds on the card)
BB_CELL = (24, 3, dict(graph="random", p_edge=0.25, soft=True, seed=3))
BB_SMALL = (16, 3, dict(graph="random", p_edge=0.25, soft=True, seed=3))
# the step caps of the kernel's checks against its plain version on the
# chip cell's own searches: the plain step (~1.2 ms a step on the card)
# cannot run SyncBB's whole 1,753,768-step search in the script's time;
# 5,000 steps, past many backtracks, keep the script under 900 s with the
# HA fleet's phase (25,000 until then: ~57 s of plain steps)
BB_CELL_CHECK_CAPS = (5, 5_000)
# the JAX package's (cost, violations, cycle, msg_count) on BB_CELL and
# its assignment (value indices in variable order), on a CPU
BB_JAX = {
    "syncbb": (2.187544019037877, 0, 0, 1_753_768),
    "ncbb": (2.187544019037877, 0, 73_176, 219_528),
}
BB_JAX_VALUES = "021112102211212000011200"
# a shared-memory load's latency on Hopper, in SM cycles: the unit of the
# DFS kernel's latency bound (one dependent load a step, which any search
# that takes JAX's steps pays; the first design's three a step is kept
# beside it)
SMEM_LOAD_CYCLES = 30
ENGINE_COUNTERS = ("captures", "replays", "iterations", "host_syncs")
# the rows of the kernel table: both TPU kernels with a float32 and with a
# bf16 message plane, and the port's own kernels
KERNEL_ROWS = ("ell_minplus", "ell_minplus_bf16", "factor_arity2_minplus",
               "factor_arity2_minplus_bf16", "xla_tree_sum", "branch_bound",
               "damp_fma")
# the kernel wrappers of compile/hopper_kernels.py, each with a launch count
KERNEL_WRAPPERS = ("ell_minplus", "factor_arity2_minplus", "xla_tree_sum",
                   "branch_bound", "damp_fma")
# damp_fma's sizes besides the config-4 plane: ragged element counts (a
# float4 tail of 1, 2 and 3 values, a grid-stride pass past the card's
# threads); an unaligned view runs its scalar path
DAMP_SIZES = (1, 2, 3, 5, 1027, 2_500_001)
# xla_tree_sum's sizes: one value, one window plus one, config 4's unary
# and constraint totals, a million
TREE_SIZES = (1, 33, 100_000, 199_996, 1_000_000)
# the front door: MaxSum as the README runs it on a YAML file, and the
# README's generated problem (the JAX ``generate graph_coloring -v 1000 -c
# 3 --soft`` defaults, at a fixed seed)
FRONT_DOOR_ARGS = ["-a", "maxsum", "-p", "damping:0.7", "-n", "50"]
FRONT_DOOR_YAML = ["tests/instances/graph_coloring.yaml",
                   "tests/instances/ising_4x4.yaml"]
README_PROBLEM = (1000, 3, dict(
    graph="random", p_edge=None, m_edge=None, soft=True, extensive=False,
    noise_level=0.02, seed=0, allow_subgraph=False,
))
# the object path at config 4's size: generate_graph_coloring's arguments
OBJECTS_100K = (100_000, 3, dict(graph="scalefree", m_edge=2, soft=True,
                                 seed=7))
# DPOP on generate_meeting_scheduling(slots_count=8, events_count=30,
# max_resources_event=2, seed=5) by resources_count: (cost, violations,
# msg_count, msg_size) of the JAX package on a CPU (JAX_PLATFORMS=cpu).
# 30 is bench config 5 (bench_all.py); 20 (induced width 7) runs the
# streaming path, 15 (width 8, a 9^9 joint) the chunked one.
DPOP_JAX = {
    30: (248.0, 0, 78, 67_261),
    20: (217.0, 0, 96, 13_170_020),
    15: (216.0, 0, 96, 59_581_009),
}

# the serving path.  Bench config 8 (bench_all.py, config_8_serving): 24
# tenants of a 3x3 grid coloring and 8 of a 4x4 one (two shape buckets),
# DSA with its defaults, 16 cycles; (tenant, variables, generator seed,
# solve seed) as the bench names and seeds them
SERVE_CONFIG8 = (
    [(f"b{i}", 9, 300 + i, i) for i in range(24)]
    + [(f"s{i}", 16, 400 + i, i) for i in range(8)]
)
SERVE_CONFIG8_RUN = ("dsa", {}, 16)
# the JAX package's fused mode on it (solve_batched(reqs, mode="fused"),
# JAX_PLATFORMS=cpu): the tenants' summed cost and violations
SERVE_CONFIG8_JAX_FUSED = (5.587981048141955, 0)
# the kernels under load: 32 tenants of a 32x32 grid coloring (1,024
# variables, 1,984 constraints, 3,968 edges each; one bucket), MaxSum with
# its defaults (damping 0.5, noise 0.01), 30 cycles; and 8 of them with
# bf16 planes, 10 cycles
SERVE_GRID = [(f"g{i}", 1024, 500 + i, i) for i in range(32)]
# health telemetry (pulse_config4): the JAX package's health rows at
# config 4 (30 cycles, seed 7, pulse on; JAX_PLATFORMS=cpu, jax 0.9.0).
# DSA's rows are pinned whole (sha256 of the float32 [30, 8] rows); of
# MaxSum's the fields that are exact whatever the planes' last bits (cost,
# best_cost, flips, churn, flipback, violations; sha256 of those columns),
# and the residual and aux columns as JAX's float32 bytes, held bit for
# bit: they are maxima of the change of a message plane, and the planes
# are JAX's bit for bit since both are damped in XLA's FMA form
PULSE_EXACT_FIELDS = (0, 1, 2, 3, 4, 7)
PULSE_JAX = {
    "dsa": dict(
        cost=8757.02712483978,
        rows_sha256="f0f97765952c0750c1bdc6d63f61126b"
        "383e3cfc1ba49a6b65da594f035a8ebd",
    ),
    "maxsum": dict(
        cost=18768.492959813426,
        exact_sha256="568bb9f01e30e19d2f8a59c087bb0d6b"
        "0ad363ec5a6510f7ff7c4c28dd40cae2",
        planes_hex=(
            "59d7af3b000000009ef1a53b8bc3cc3a5c5d413c3464113b5a93863c"
            "8667753b68a3973cfc94d43b4ad7af3c8d26253c9205b93c281c5d3c"
            "fc99ba3cc6c5843c5c5aba3c5adc923c24f2b83c0c4b9c3c6ec9e03c"
            "38e3a13c30c0f93c20b6a03c16b3063de61ba73c827c123d2c6ac23c"
            "cccb173d9892cd3c85af243da8a8c23c9cb74e3d709cc53ca04f6c3d"
            "6456f43c74277d3d12ec1b3db483853da885383d909c8a3d24294f3d"
            "3c32853db460623d0646653dd8616e3d16127b3d308a6a3de8d98e3d"
            "a85e503de40b963d0fe3423d00dd8e3daf96483dd01f7b3d08d1373d"
            "18b0703d0c70423dd02f6a3d640b433d"
        ),
    ),
}
# durable solves at config 4: a snapshot every 10 of 30 cycles
DURABLE_RUNS = (
    ("dsa", {}),
    ("mgm2", {}),
    ("maxsum", dict(CONFIG_4["params"], layout="ell", noise=0.01)),
)
# the CLI crash: DSA on a soft random coloring written as YAML, killed
# after its first checkpoint and resumed
KILL_PROBLEM = (1000, 3, dict(graph="random", p_edge=0.005, soft=True,
                              seed=5))
KILL_CYCLES = 2400
# the port's CLI, as a subprocess
PORT_CLI = [sys.executable, "-m", "pydcop_tpu_torch"]
SERVE_GRID_RUN = ("maxsum", {}, 30)
# serving with pulse on: config 8's DSA tenants and the grid tenants with
# MaxSum at damping 0.7 (both planes through damp_fma, batched); the CPU
# batch compared with the card's holds the first SERVE_PULSE_CPU tenants
SERVE_PULSE_GRID_RUN = ("maxsum", {"damping": 0.7}, 30)
SERVE_PULSE_CPU = 8
# the scenario replay (replay_session): a DynamicMaxSum session on a
# scale-free coloring's relation objects, three events (two delays around
# a factor swap), killed after its first checkpoint and resumed
REPLAY_PROBLEM = (20_000, 3, dict(graph="scalefree", m_edge=2, soft=True,
                                  seed=7))
REPLAY_PARAMS = {"damping": 0.7}
REPLAY_SEED = 7
REPLAY_SCENARIO = """
events:
  - id: warm
    delay: 20
  - id: swap
    actions:
      - {type: swap_factor, constraint: cost_0,
         function: "10 if v00000 == v00002 else 0"}
  - id: settle
    delay: 20
"""
# the engine's spans and metrics as the JAX package names them
TRACE_SPANS = {"solve.window": {"kind", "phase", "offset", "cycles"},
               "solve.readback": {"bytes"}}
TRACE_METRICS = ("solve.windows", "solve.device_cycles", "device.chunk_ms",
                 "solve.readback_bytes", "solve.readback_seconds")
SERVE_GRID_BF16_RUN = ("maxsum", {"precision": "bf16"}, 10)
# the batched kernel rows of the kernels line, at K=32 on SERVE_GRID's
# bucket
BATCHED_ROWS = ("ell_minplus_batched", "ell_minplus_bf16_batched",
                "xla_tree_sum_evaluate_batched",
                "xla_tree_sum_fan_in_batched", "xla_tree_sum_rows_batched",
                "damp_fma_batched")
# what damp_fma replaces: the JAX package's damping, which XLA's CPU
# compiler contracts into one FMA (a jnp expression, not a TPU kernel)
DAMP_REPLACES = (
    "none: the port's own kernel (MaxSum's damping as XLA's FMA: "
    "pydcop_tpu/algorithms/maxsum.py:213, :252; "
    "pydcop_tpu/compile/kernels.py:520, :645, :1011)"
)


# the generate verb (generate_verb): each family of ``python -m
# pydcop_tpu_torch generate`` ("{dir}": the output directory), and the
# sha256 of each file that ``python -m pydcop_tpu generate`` writes for
# the same arguments (JAX_PLATFORMS=cpu, jax 0.9.0).  The older families
# at their bench_all.py sizes (configs 2, 3, 5, 7); the small world's
# seed given, since its default draws from the OS
GENERATE_VERB = (
    ("iot", ["-n", "1000"], {
        "iot.yaml": "74587b9d190bba67f36ca818b8502cf6"
                    "591a5fa2d68196702142b1f6661b2a16",
        "dist_iot.yaml": "f1e8833aba9c0a956b9bce88630652aa"
                         "a2bb2eba212a81fd716e66b256242680"}),
    ("small_world", ["-n", "10000", "-k", "4", "-p", "0.1", "-d", "5",
                     "--seed", "1"], {
        "small_world.yaml": "bb7e3da37ef82b18025dab0446c47a4d"
                            "abf6569ee704fa400bc0067b7b8f6cad"}),
    ("secp", ["-l", "100", "-m", "20", "-r", "40"], {
        "secp.yaml": "fa4308a39de758d8cd7edefc2a5931f8"
                     "8b73db44d2303fe68aca896366f8f1ff"}),
    ("agents", ["--count", "1000"], {
        "agents.yaml": "bf8fc82e2801a659e846e1304a4a53e9"
                       "cee003d0806b348f8afeb99a9784643e"}),
    ("graph_coloring", ["-v", "1000", "-c", "3", "-g", "random",
                        "--p_edge", "0.005", "--soft", "--seed", "11"], {
        "graph_coloring.yaml": "9645fd29ac30d1e63be7c9c7f38db859"
                               "905ad9dc64c7864b26371600002cb14e"}),
    ("ising", ["--row_count", "100", "--seed", "3"], {
        "ising.yaml": "f9e0bdec00b7096306db76c4b5c4ed74"
                      "c6260954ca74104c7978cbaf16aaa997"}),
    ("meeting_scheduling", ["--slots_count", "8", "--resources_count",
                            "30", "--events_count", "30",
                            "--max_resources_event", "2", "--seed", "5"], {
        "meeting_scheduling.yaml": "ea1dc2bd8363914466a1456551f39645"
                                   "5be1e00cb9c1ca0c3b0eee70a7c1c68e"}),
    ("mixed_problem", ["-v", "2000", "-c", "2000", "-H", "0.4", "-A", "2",
                       "-r", "5", "-d", "0.0025", "--seed", "13"], {
        "mixed_problem.yaml": "7c2b17796b61ecd173ba237cf0b9b1af"
                              "66a18b89d73ee302e35b3b23094edaac"}),
    # over the iot file's agents, once that file is written
    ("scenario", ["--evts_count", "10", "--actions_count", "5",
                  "--dcop_files", "{dir}/iot.yaml", "--seed", "2"], {
        "scenario.yaml": "b18cb0b547d76cae5f0fd77d4189c4cb"
                         "decbd5d0f0ae792981864cefb9a5851f"}),
)
# the generated problems the verb writes, solved (generated_solves): the
# generator call, and the JAX package's (cost, violations, cycles) for
# MaxSum at damping 0.7 and DSA, 30 cycles, seed 0, solved from the
# verb's file (load_dcop_from_file, compile_dcop, solve; JAX_PLATFORMS=cpu)
GENERATED_SOLVES = {
    "iot": (("iot", "generate_iot", dict(num=1000)),
            {"maxsum": (45425.0, 0, 30), "dsa": (38123.0, 0, 30)}),
    "small_world": (("smallworld", "generate_small_world",
                     dict(n=10000, k=4, p=0.1, domain_size=5, seed=1)),
                    {"maxsum": (37138.0, 0, 30), "dsa": (37065.0, 0, 30)}),
    "secp": (("secp", "generate_secp", dict(lights=100, models=20,
                                            rules=40)),
             {"maxsum": (229.85, 0, 30), "dsa": (413.86, 0, 30)}),
}
GENERATED_RUNS = (("maxsum", {"damping": 0.7}), ("dsa", {}))
# a process kill through the CLI (fault_kill_resume): MaxSum at damping
# 0.7 on KILL_PROBLEM, a snapshot every FAULT_EVERY cycles; the first
# schedule's kill falls after the solve has returned, the second's
# halfway between the first's first and last snapshots.  The CLI's cold
# start (lazy imports compiled from source, the CUDA context, the
# kernels' libraries, graph capture) counts in a kill's ``at``: 6.4–10.6
# s to the first snapshot, then ~4.5 s to the last (H100 80GB HBM3,
# 700 W), so the first kill waits 25 s and the second falls in a ~4.5 s
# window
FAULT_CYCLES = 30_000
FAULT_EVERY = 1000
FAULT_AFTER_S = 25.0
# the same at config 4 in a child process (``--fault-child``): MaxSum
# ``ell`` at damping 0.7, a snapshot every FAULT4_EVERY cycles
FAULT4_CYCLES = 3000
FAULT4_EVERY = 100
# serving under a fault schedule (serve_fault_schedule): grid tenants of
# SERVE_GRID's bucket, MaxSum at damping 0.7; "hold*" held 0.2 s by a
# delay rule (p = 1), "dead*" killed at t = 0, the others untouched
SERVE_FAULT_HOLD_S = 0.2
SERVE_FAULT_TENANTS = [
    (f"{kind}{i}", 1024, 900 + 4 * i + j, i)
    for i in range(4) for j, kind in enumerate(("ok", "dead", "hold"))
]
# serving's live surface (serve_observability): the serve grid's tenants,
# the first SERVE_OBS_KILLED killed by the schedule (8 of 32: a bad share
# of 25% burns a 1% budget at 25, past the fast threshold of 14.4), under
# a latency objective a killed request also fails (so p50: its budget of
# 50% burns at 0.5) and availability
SERVE_OBS_KILLED = 8
SERVE_OBS_SLO = ("lat=p50<30s", "availability>=99%")
# the HA fleet (serve_fleet_ha): the serve grid's first 8 problems (16
# until profile_capture joined the script: each body is parsed by the
# router and again by its worker, most of the phase's wall), the even
# ones as MaxSum at damping 0.7 and the odd ones as DSA, 30 cycles:
# two affinity buckets, one a worker.  The workers hold a tenant up to
# SERVE_FLEET_WINDOW_MS for company before they dispatch, so the MaxSum
# tenants are still in flight when their worker is killed; the window is
# not widened (--window-max-factor 1).  Scraped every 0.25 s, a worker
# that missed 4 s of scrapes drops its series.  SERVE_FLEET_PROBES
# rounds of direct and routed POSTs time the router's forward.
SERVE_FLEET_TENANTS = 8
SERVE_FLEET_RUNS = {"maxsum": {"damping": 0.7}, "dsa": {}}
SERVE_FLEET_CYCLES = 30
SERVE_FLEET_WINDOW_MS = 1000
SERVE_FLEET_ROUTER = ["--spawn", "2", "--port", "0", "--placement",
                      "affinity", "--interval", "0.25", "--stale-after",
                      "4", "--window-ms", str(SERVE_FLEET_WINDOW_MS),
                      "--window-max-factor", "1"]
SERVE_FLEET_PROBES = 1


# the memory phase: the solves whose rise in peak memory fits the model's
# workspace factors (label, problem, algo, params, n_cycles), and the solve
# held to the fit, bench config 6, about 10x config 4
MEMORY_FIT = (
    ("maxsum_ell_config4", "config4", "maxsum",
     {"damping": 0.7, "layout": "ell"}, 30),
    ("maxsum_lanes_config4", "config4", "maxsum",
     {"damping": 0.7, "layout": "lanes"}, 30),
    ("maxsum_pallas_config4", "config4", "maxsum",
     {"damping": 0.7, "layout": "pallas"}, 30),
    ("dsa_config4", "config4", "dsa", {}, 30),
    ("gdba_config4", "config4", "gdba", {}, 30),
    ("mgm2_config3", "config3", "mgm2", {}, 30),
    ("dpop_config5", "config5", "dpop", {}, 1),
)
MEMORY_HELD = ("maxsum_ell_config6", "config6", "maxsum",
               {"damping": 0.7, "layout": "ell"}, 30)
# predicted over measured peak at config 6, left out of the fit
MEMORY_HELD_RATIO = (0.9, 1.5)
# the profiled solve's trace: the kernels a MaxSum ELL solve launches,
# by wrapper, and the substrings of their CUDA symbols
PROFILE_KERNELS = {
    "ell_minplus": ("ell_minplus",),
    "xla_tree_sum": ("tree_sum_kernel", "evaluate_kernel",
                     "short_rows_kernel"),
    "damp_fma": ("damp_fma",),
}
# the capture verb's configs in the smoke run, and config 4's bar on the
# share of its real step its per-op composition attributes
CAPTURE_CONFIGS = ("2", "3", "4")
ATTRIBUTION_BAR = (90.0, 110.0)


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


def mixed_problem_fields(
    n_vars=3000, n_binary=6000, n_ternary=1500, d=3, seed=5
):
    """The fields of ``interop.compiled_from_numpy`` for a random problem
    with binary and ternary constraints over distinct variables: soft
    costs in [0, 10) with ~5% of the binary tuples forbidden (cost 1e9, a
    hard constraint), unary costs in [0, 1), and edges sorted by variable
    with the port's ``sort_edges_by_var``.  Made with numpy from ``seed``."""
    import dataclasses

    import numpy as np

    from pydcop_tpu_torch.compile.core import ArityBucket, sort_edges_by_var
    from pydcop_tpu_torch.dcop.objects import Domain

    rng = np.random.default_rng(seed)
    buckets, edge_var, edge_con = [], [], []
    n_edges = n_cons = 0
    for arity, n_c in ((2, n_binary), (3, n_ternary)):
        draw = np.sort(rng.integers(0, n_vars, (2 * n_c + 16, arity)), axis=1)
        distinct = np.all(draw[:, 1:] != draw[:, :-1], axis=1)
        var_slots = rng.permuted(draw[distinct][:n_c], axis=1).astype(np.int32)
        check(len(var_slots) == n_c, "mixed_problem_fields: too few scopes")
        tables = (rng.random((n_c,) + (d,) * arity) * 10).astype(np.float32)
        if arity == 2:
            tables[rng.random(tables.shape) < 0.05] = 1e9
        con_ids = np.arange(n_cons, n_cons + n_c, dtype=np.int32)
        buckets.append(ArityBucket(
            arity=arity, tables=tables, var_slots=var_slots,
            edge_ids=(n_edges + np.arange(n_c * arity, dtype=np.int32))
            .reshape(n_c, arity),
            con_ids=con_ids, names=[f"c{i}" for i in con_ids],
        ))
        edge_var.append(var_slots.reshape(-1))
        edge_con.append(np.repeat(con_ids, arity))
        n_edges += n_c * arity
        n_cons += n_c
    edge_var, edge_con = sort_edges_by_var(
        np.concatenate(edge_var), np.concatenate(edge_con), buckets
    )
    names = [f"v{i}" for i in range(n_vars)]
    return dict(
        objective="min",
        var_names=names,
        var_index={n: i for i, n in enumerate(names)},
        domains=[Domain("levels", "level", range(d))] * n_vars,
        n_vars=n_vars,
        max_domain=d,
        domain_size=np.full(n_vars, d, dtype=np.int32),
        valid_mask=np.ones((n_vars, d), dtype=bool),
        unary=rng.random((n_vars, d)).astype(np.float32),
        constant_cost=0.0,
        buckets=[dataclasses.asdict(b) for b in buckets],
        n_edges=n_edges,
        edge_var=edge_var,
        edge_con=edge_con,
        var_degree=np.bincount(edge_var, minlength=n_vars).astype(np.int32),
        con_names=[f"c{i}" for i in range(n_cons)],
        float_dtype=np.float32,
    )


def ell_inputs(compiled, device, seed=0):
    """(v2f_t, pair_perm, tabs_t, real_row): the ELL operands of
    ``compiled`` on ``device`` and a random variable->factor plane (zero on
    padding slots)."""
    import torch

    from pydcop_tpu_torch.compile.kernels import build_ell

    ell = build_ell(compiled)
    g = torch.Generator(device=device).manual_seed(seed)
    real = torch.as_tensor(ell.real_row, device=device)
    v2f = torch.randn(
        (compiled.max_domain, ell.n_pad), generator=g, device=device
    ) * real
    return [
        v2f,
        torch.as_tensor(ell.pair_perm, device=device),
        torch.as_tensor(ell.tabs_t, device=device),
        real,
    ]


def lanes_inputs(compiled, device, seed=0):
    """(v2f_t, e0, e1, tables_t): the lanes operands of ``compiled``'s
    arity-2 bucket on ``device`` and a random [D, n_edges] plane."""
    import torch

    from pydcop_tpu_torch.compile.kernels import lanes_aux, to_device

    dev = to_device(compiled, device)
    aux = lanes_aux(dev)
    bi = [b.arity for b in dev.buckets].index(2)
    g = torch.Generator(device=device).manual_seed(seed)
    v2f = torch.randn(
        (dev.max_domain, dev.n_edges), generator=g, device=device
    )
    return [v2f, *aux.edge_cols[bi], aux.tables_t[bi]]


def ell_ragged_inputs(n, d, device, seed=0):
    """Random ELL operands of ``n`` slots: a v2f plane zero on the ~20%
    padding slots, partners drawn at random, tables in [0, 10)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    real = torch.rand((1, n), generator=g, device=device) < 0.8
    return [
        torch.randn((d, n), generator=g, device=device) * real,
        torch.randint(
            0, n, (n,), generator=g, device=device, dtype=torch.int32
        ),
        torch.rand((d, d, n), generator=g, device=device) * 10,
        real,
    ]


def lanes_ragged_inputs(n, d, device, seed=0):
    """Random arity-2 operands of ``n`` constraints over ``2 n`` edges."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return [
        torch.randn((d, 2 * n), generator=g, device=device),
        *(
            torch.randint(
                0, 2 * n, (n,), generator=g, device=device, dtype=torch.int32
            )
            for _ in range(2)
        ),
        torch.rand((d * d, n), generator=g, device=device) * 10,
    ]


def _bound(nbytes: int, ops: int):
    """(bound_ms, bound_by) against the H100's HBM rate and float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations"
    )


def ell_minplus_bytes_ops(args):
    """(bytes, ops) one ell_minplus call needs: each input byte this data
    needs read once, each output written once (tables, partner values in
    the plane's type and the index of real slots; mask and output of every
    slot)."""
    v2f, _, _, real_row = args
    d, n_pad = v2f.shape
    n_real = int(real_row.sum())
    isz = v2f.element_size()
    nbytes = n_real * (d * d * 4 + d * isz + 4) + n_pad * (1 + d * 4)
    ops = n_real * (2 * d * d - d)  # d*d adds, d*(d-1) mins per own value
    return nbytes, ops


def factor_arity2_minplus_bytes_ops(args):
    """(bytes, ops) one factor_arity2_minplus call needs: per constraint
    its D*D table floats, two int32 edge ids and 2*D gathered message
    values (in the plane's type) read once, and 2*D output floats written
    once; 2*D*D adds for the joint total, 2*D*D subtracts and 2*D*(D-1)
    mins."""
    v2f, e0, _, _ = args
    d, n_c = v2f.shape[0], e0.shape[0]
    isz = v2f.element_size()
    nbytes = n_c * (d * d * 4 + 2 * 4 + 2 * d * isz + 2 * d * 4)
    ops = n_c * (4 * d * d + 2 * d * (d - 1))
    return nbytes, ops


def xla_tree_sum_bytes_ops(args):
    """(bytes, ops) of one sum: its n floats read once, one written; n - 1
    adds."""
    (x,) = args
    return x.numel() * 4 + 4, max(x.numel() - 1, 0)


def bf16_plane(make):
    """An operand maker whose message plane (the first operand) is
    rounded to bfloat16, as MaxSum's precision="bf16" stores it."""

    def made(*args, **kwargs):
        import torch

        ops = make(*args, **kwargs)
        return [ops[0].to(torch.bfloat16)] + list(ops[1:])

    return made


def tree_inputs(n, device, seed=0):
    """[x]: n float32 costs as evaluate sums them, ~30% at 1e9."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.where(
        torch.rand(n, generator=g, device=device) < 0.3, 1e9,
        torch.rand(n, generator=g, device=device) * 10,
    )]


def evaluate_inputs(compiled, device, seed=0):
    """[unary, values, buckets, constant]: ``evaluate``'s operands of
    ``compiled`` on ``device`` and a random int32 assignment."""
    import torch

    from pydcop_tpu_torch.compile.kernels import to_device

    dev = to_device(compiled, device)
    g = torch.Generator(device=device).manual_seed(seed)
    values = (
        torch.rand(dev.n_vars, generator=g, device=device) * dev.domain_size
    ).to(torch.int32)
    return [dev.unary, values,
            [(b.tables_flat, b.var_slots) for b in dev.buckets],
            dev.constant_cost]


def evaluate_bytes_ops(args):
    """(bytes, ops) of one evaluate: the assignment, one unary entry a
    variable, each constraint's var_slots and one table entry read once,
    the total written; an add a value."""
    unary, values, buckets, _ = args
    n_vars = values.numel()
    nbytes = n_vars * (values.element_size() + 4) + 4 + sum(
        vs.numel() * vs.element_size() + vs.shape[0] * 4 for _, vs in buckets
    )
    return nbytes, n_vars + sum(vs.shape[0] for _, vs in buckets)


def evaluate_parts(args):
    """``evaluate``'s operands cut to its two parts: the unary entries
    alone (no bucket), and the buckets alone behind a one-variable unary
    segment: the first row of the unary and a one-element view of the
    assignment, whose storage the kernel reads whole through the buckets'
    slots (neither build bounds a slot by the view).  Each with its
    (bytes, ops): the buckets' bytes count the whole assignment."""
    unary, values, buckets, constant = args
    n_vars = values.numel()
    unary_only = [unary, values, [], constant]
    buckets_only = [unary[:1], values[:1], buckets, constant]
    whole_bytes, whole_ops = evaluate_bytes_ops(args)
    unary_bytes, unary_ops = evaluate_bytes_ops(unary_only)
    bucket_bytes = whole_bytes - unary_bytes + n_vars * values.element_size()
    return {
        "unary_only": (unary_only, (unary_bytes, unary_ops)),
        "buckets_only": (buckets_only, (bucket_bytes + 4,
                                        whole_ops - unary_ops)),
    }


def fan_in_inputs(spans, n_pad, d, device, seed=0, dtype="float32"):
    """[f2v_t, unary_t, spans]: a random [D, n_pad] factor->variable plane
    and [D, V] unary plane of an ELL layout's degree classes."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    n_vars = sum(nb for nb, _ in spans)
    f2v = torch.randn((d, n_pad), generator=g, device=device)
    u = torch.rand((d, n_vars), generator=g, device=device) * 10
    return [f2v.to(getattr(torch, dtype)), u, spans]


def fan_in_bytes_ops(args):
    """(bytes, ops) of one ELL fan-in: the plane and the unary plane read
    once, both output planes written once; an add a slot (the sums) and a
    subtract a slot (v2f_raw), an add a variable (u)."""
    f2v, u, _ = args
    nbytes = f2v.numel() * (f2v.element_size() + 4) + u.numel() * 8
    return nbytes, 2 * f2v.numel() + u.numel()


def fan_in_check(c4):
    """The lanes fan-in (a segmented sum over the variable-sorted edges)
    at config 4's shape: run twice on the card it must give the same bits
    (no atomics); beside it, how far it is from the CPU's sum."""
    import torch

    from pydcop_tpu_torch.compile.kernels import (
        lanes_aux,
        segment_sum,
        to_device,
    )

    out = {}
    for device in ("cuda", "cpu"):
        aux = lanes_aux(to_device(c4, device))
        f2v = torch.randn(
            (c4.max_domain, c4.n_edges),
            generator=torch.Generator().manual_seed(1),
        ).to(device)
        out[device] = [
            segment_sum(f2v, aux.fan_in_offsets_t, 1) for _ in range(2)
        ]
    torch.cuda.synchronize()
    deterministic = torch.equal(*out["cuda"])
    check(deterministic, "lanes fan-in differs between two runs on the card")
    gpu = out["cuda"][0].cpu()
    return {
        "deterministic": deterministic,
        "equal_to_cpu": torch.equal(gpu, out["cpu"][0]),
        "max_abs_err_vs_cpu": float((gpu - out["cpu"][0]).abs().max()),
    }


def time_cuda_ms(fn, arg_sets, rounds: int = 8, reps: int = 5) -> float:
    """Median device time of one ``fn(*args)`` call.  One CUDA graph holds
    ``rounds`` passes of ``fn`` over every operand set in turn; each of
    ``reps`` replays runs between one pair of CUDA events.  A replay is
    one launch from the host, so the host's work for each call (a
    wrapper's checks, allocation and ctypes call) cannot set the pace;
    what is left besides the kernels is the graph's own gap between
    nodes (see ``timer_floor_ms``).  The sets together exceed the 50 MB
    L2, so each call reads its operands from device memory, as in the
    solve, where the other passes of a cycle evict them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for args in arg_sets:
                fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (rounds * len(arg_sets)))
    graph.reset()
    return statistics.median(times)


def timer_floor_ms() -> float:
    """What :func:`time_cuda_ms` reads for a call that launches one
    one-element kernel: the graph's gap between nodes plus the smallest
    kernel, the least any timed call can read."""
    import torch

    x = torch.zeros(1, device="cuda")
    return time_cuda_ms(lambda t: t.add_(1), [[x]] * 4)


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
    for name, path in paths.items():
        emit({
            "phase": "ptxas", "library": name,
            "kernels": _build.resource_usage(path),
        })


def phase_kernels(c4, c6, c7):
    """Each kernel against its plain version on the card, exactly, at the
    main path's shapes (config 4), the small cases (D = 2..20) and the
    ragged shape, the min-plus kernels with a float32 and with a bf16
    plane; ``xla_tree_sum``'s sum sites (``_tree_sum_row``) on configs 4,
    6 and 7; ``branch_bound`` (``_branch_bound_row``).  Each timed at the
    main path's shape.  Returns the kernel rows by name and, by kernel
    (or ``xla_tree_sum`` entry), the operand sets the float32 min-plus
    kernels, the fan-in and the domain sum were timed on (config 4) and
    the chip cell's SyncBB search."""
    import torch

    from pydcop_tpu_torch.compile import hopper_kernels as hk

    problems = {"config4": c4}
    problems.update({k: generate(v) for k, v in SMALL_CASES.items()})
    pallas = "pydcop_tpu/compile/pallas_kernels.py"
    kernels = [
        # row name, wrapper, operands of a problem, random ragged
        # operands, bytes and operations, the TPU kernel it replaces
        ("ell_minplus", "ell_minplus", ell_inputs, ell_ragged_inputs,
         ell_minplus_bytes_ops, f"{pallas}:167"),
        ("ell_minplus_bf16", "ell_minplus", bf16_plane(ell_inputs),
         bf16_plane(ell_ragged_inputs), ell_minplus_bytes_ops,
         f"{pallas}:167"),
        ("factor_arity2_minplus", "factor_arity2_minplus", lanes_inputs,
         lanes_ragged_inputs, factor_arity2_minplus_bytes_ops,
         f"{pallas}:83"),
        ("factor_arity2_minplus_bf16", "factor_arity2_minplus",
         bf16_plane(lanes_inputs), bf16_plane(lanes_ragged_inputs),
         factor_arity2_minplus_bytes_ops, f"{pallas}:83"),
    ]
    emit({"phase": "timer", "floor_ms": timer_floor_ms()})
    rows, timed_sets = {}, {}
    for name, wrapper, inputs, ragged, bytes_ops, replaces in kernels:
        kernel, plain = getattr(hk, wrapper), getattr(hk, f"{wrapper}_plain")
        operands = {
            k: functools.partial(inputs, c, "cuda")
            for k, c in problems.items()
        }
        operands["ragged"] = functools.partial(ragged, *RAGGED, "cuda")
        checked, max_err = _check_equal(name, kernel, plain, operands)
        args = operands["config4"]()
        # 4 operand sets of ~16-33 MB each (inputs + output), so L2
        # holds none of them
        sets = [args] + [[a.clone() for a in args] for _ in range(3)]
        if not name.endswith("_bf16"):
            timed_sets[name] = sets
        kernel_ms = time_cuda_ms(kernel, sets)
        plain_ms = time_cuda_ms(plain, sets)
        # yardsticks: the kernel on one set, which L2 mostly holds, and a
        # copy of the largest operand (the tables), which streams like the
        # kernel's table reads
        l2_warm_ms = time_cuda_ms(kernel, sets[:1])
        copy_ms = time_cuda_ms(
            lambda *a: max(a, key=torch.Tensor.numel).clone(), sets
        )
        nbytes, ops = bytes_ops(args)
        emit({"phase": "kernels", "kernel": name, "shapes": checked})
        rows[name] = _kernel_row(
            name, wrapper, replaces, max_err, kernel_ms, plain_ms, nbytes,
            ops,
            # no one PyTorch call does the gathers, adds, mins (and mask)
            library_ms=None, l2_warm_ms=l2_warm_ms, copy_ms=copy_ms,
        )
    rows["xla_tree_sum"], tree_sets = _tree_sum_row(c4, c6, c7)
    timed_sets.update(tree_sets)
    emit({"phase": "kernel_row", **rows["xla_tree_sum"]})
    rows["damp_fma"] = _damp_fma_row(c4)
    emit({"phase": "kernel_row", **rows["damp_fma"]})
    small, cell = (compile_bb(spec) for spec in (BB_SMALL, BB_CELL))
    rows["branch_bound"] = _branch_bound_row(small, cell)
    emit({"phase": "kernel_row", **rows["branch_bound"]})
    from pydcop_tpu_torch.algorithms._branch_bound import DEFAULT_MAX_ITERS

    timed_sets["branch_bound"] = [
        [*ops, DEFAULT_MAX_ITERS] for _, ops in _bb_searches(cell)
    ]
    emit({"phase": "fan_in", **fan_in_check(c4)})
    return rows, timed_sets


def compile_bb(spec):
    """The compiled soft coloring of ``generate_graph_coloring(*spec)``."""
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.compile.core import compile_dcop

    n, d, kw = spec
    return compile_dcop(generate_graph_coloring(n, d, **kw))


def _check_equal(name, kernel, plain, operands):
    """The kernel against its plain version on each operand set, exactly
    (``torch.equal``); raises on any difference."""
    import torch

    checked, max_err = {}, 0.0
    for shape, make in operands.items():
        args = make()
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(
            float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
            for g, w in zip(got, want)
        )
        checked[shape] = {
            "shape": list(args[0].shape),
            "dtype": str(args[0].dtype).replace("torch.", ""),
            "equal": equal, "max_abs_err": err,
        }
        check(equal, f"{name} != its plain version on {shape}: {err}")
        max_err = max(max_err, err)
    return checked, max_err


def _kernel_row(name, wrapper, replaces, max_err, kernel_ms, plain_ms,
                nbytes, ops, library_ms, **extra):
    bound_ms, bound_by = _bound(nbytes, ops)
    return {
        "name": name,
        "route": "cuda",
        "source": f"pydcop_tpu_torch/csrc/{wrapper}.cu",
        "replaces": replaces,
        "launches": None,  # filled from its path's run
        "equal": True,
        "tolerance": "exact (torch.equal)",
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_share": bound_ms / kernel_ms,
        "bound_bytes": nbytes,
        "bound_ops": ops,
        "library_ms": library_ms,
        **extra,
    }


def damp_inputs(shape, device, seed=0):
    """[prev, new]: two random float32 message planes of ``shape``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device) * 10
            for _ in range(2)]


def _damp_calls(damping):
    """(the kernel's call, its plain version, the plain torch form, the
    float64 chain the port damped with before) of ``damping``."""
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    d, e = hk.damp_constants(damping)

    def kernel(prev, new):
        return hk.damp_fma(damping, prev, new)

    def plain(prev, new):
        return hk.damp_fma_plain(prev, new, d, e)

    def plain_form(prev, new):
        return damping * prev + (1.0 - damping) * new

    def float64_chain(prev, new):
        return (prev.double() * d + ((1.0 - damping) * new).double()
                ).float()

    return kernel, plain, plain_form, float64_chain


def damp_bytes_ops(args):
    """(bytes, ops) of one damping: both planes read once, the output
    written once; a multiply and a fused multiply-add (3 operations) a
    value."""
    prev, _ = args
    return 12 * prev.numel(), 3 * prev.numel()


def _damp_fma_row(c4):
    """``damp_fma`` against its plain version, exactly: config 4's
    [D, n_pad] ELL plane (the main path's), DAMP_SIZES and an unaligned
    view; timed by CUDA-graph replay on four config-4 operand sets beside
    the plain torch form and the float64 chain (the library yardsticks:
    neither rounds as one FMA), and between CUDA events its plain
    version."""
    from pydcop_tpu_torch.algorithms.base import cached_const
    from pydcop_tpu_torch.compile.kernels import build_ell

    damping = CONFIG_4["params"]["damping"]
    kernel, plain, plain_form, float64_chain = _damp_calls(damping)
    ell = cached_const(c4, ("ell_host",), lambda: build_ell(c4))
    shape = (c4.max_domain, ell.n_pad)
    operands = {"config4": functools.partial(damp_inputs, shape, "cuda")}
    for n in DAMP_SIZES:
        operands[f"n{n}"] = functools.partial(damp_inputs, (n,), "cuda", n)
    operands["unaligned"] = lambda: [
        x[1:] for x in damp_inputs((1_000_001,), "cuda", 11)
    ]
    checked, max_err = _check_equal("damp_fma", kernel, plain, operands)
    emit({"phase": "kernels", "kernel": "damp_fma", "shapes": checked})
    args = operands["config4"]()
    # 4 operand sets of 18 MB each, so L2 holds none of them
    sets = [args] + [[a.clone() for a in args] for _ in range(3)]
    nbytes, ops = damp_bytes_ops(args)
    # the plain version looks at its sums (a host sync): it is timed
    # between CUDA events, not in a graph
    plain_ms = _events_ms(lambda: [plain(*a) for a in sets], 5) / len(sets)
    return _kernel_row(
        "damp_fma", "damp_fma", DAMP_REPLACES, max_err,
        time_cuda_ms(kernel, sets), plain_ms, nbytes,
        ops, library_ms=time_cuda_ms(plain_form, sets),
        library_call=(
            "damping * prev + (1 - damping) * new in torch: three "
            "kernels, rounded twice (not one FMA)"
        ),
        float64_chain_ms=time_cuda_ms(float64_chain, sets),
        shape=list(shape),
    )


def _fan_in_call(f2v, u, spans):
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    return hk.ell_fan_in(spans, u, f2v)


def _fan_in_plain(f2v, u, spans):
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    return hk.ell_fan_in_plain(spans, u, f2v)


def _domain_sum_call(x):
    from pydcop_tpu_torch.compile.kernels import domain_sum

    return domain_sum(x, 0)


def _domain_sum_plain(x):
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    return hk.xla_tree_sum_plain(x.movedim(0, -1)).unsqueeze(0)


def _one_launch(name, call, args):
    """Check that one call of a sum site is one xla_tree_sum launch."""
    import torch

    from pydcop_tpu_torch.compile import hopper_kernels as hk

    hk.xla_tree_sum.launches = 0
    call(*args)
    torch.cuda.synchronize()
    n = hk.xla_tree_sum.launches
    check(n == 1, f"{name}: {n} xla_tree_sum launches a call, not 1")
    return n


def _tree_sum_row(c4, c6, c7):
    """``xla_tree_sum``'s sum sites against their plain versions, exactly:
    1-D sums of TREE_SIZES values; each degree class of config 4's and
    config 6's ELL fan-in as strided [D, nb, db] rows, and the whole
    fan-in of both (float32 and bf16 planes); MaxSum's domain sum of the
    config-4 [D, n_pad] plane, read in place; ``evaluate`` on configs 4,
    6 and 7.  Each site must be one launch a call.  Timed: config 4's
    constraint total (199,996 values, evaluate's largest sum) beside
    ``torch.sum``, the one PyTorch call that sums the same values (in
    another order), and config 4's evaluate (whole, and its unary and
    bucket parts alone), fan-in (float32 and bf16 planes) and domain sum,
    each beside its plain version, its bound and its kernel's registers
    and spills; evaluate at config 6 too.  Returns the row and, by launch
    entry, the operand sets evaluate, the fan-in and the domain sum were
    timed on (``phase_against``)."""
    import torch

    from pydcop_tpu_torch.compile import _build
    from pydcop_tpu_torch.compile import hopper_kernels as hk
    from pydcop_tpu_torch.compile.kernels import build_ell

    operands = {
        f"n{n}": functools.partial(tree_inputs, n, "cuda", n)
        for n in TREE_SIZES
    }
    g = torch.Generator(device="cuda").manual_seed(5)
    ells = {"config4": build_ell(c4), "config6": build_ell(c6)}
    for name, ell in ells.items():
        plane = torch.randn((3, ell.n_pad), generator=g, device="cuda")
        off = 0
        for nb, db in ell.spans:
            if db:
                seg = plane[:, off:off + nb * db].reshape(-1, nb, db)
                operands[f"{name}_class_{db}"] = lambda seg=seg: [seg]
            off += nb * db
    checked, max_err = _check_equal(
        "xla_tree_sum", hk.xla_tree_sum, hk.xla_tree_sum_plain, operands
    )
    evaluate_ops = {
        name: functools.partial(evaluate_inputs, c, "cuda", 7)
        for name, c in (("config4", c4), ("config6", c6), ("config7", c7))
    }
    # the kernel's other instantiation: an int64 assignment
    evaluate_ops["config4_int64"] = lambda: [
        a.long() if i == 1 else a
        for i, a in enumerate(evaluate_inputs(c4, "cuda", 8))
    ]
    sites = {
        "evaluate": (hk.tree_evaluate, hk.tree_evaluate_plain, evaluate_ops),
        "ell_fan_in": (_fan_in_call, _fan_in_plain, {
            f"{name}_{dtype}": functools.partial(
                fan_in_inputs, ell.spans, ell.n_pad, 3, "cuda", 3, dtype
            )
            for name, ell in ells.items()
            for dtype in ("float32", "bfloat16")
        }),
        "domain_sum": (_domain_sum_call, _domain_sum_plain, {
            "config4": lambda: [
                fan_in_inputs(ells["config4"].spans, ells["config4"].n_pad,
                              3, "cuda", 4)[0]
            ],
        }),
    }
    for site, (call, plain, ops) in sites.items():
        got, err = _check_equal(f"xla_tree_sum {site}", call, plain, ops)
        checked.update({f"{site}_{k}": v for k, v in got.items()})
        max_err = max(max_err, err)
    emit({"phase": "kernels", "kernel": "xla_tree_sum", "shapes": checked})
    n_total = sum(b.tables.shape[0] for b in c4.buckets)
    sets = [tree_inputs(n_total, "cuda", seed) for seed in range(4)]
    nbytes, ops = xla_tree_sum_bytes_ops(sets[0])
    kernel_ms = time_cuda_ms(hk.xla_tree_sum, sets)
    plain_ms = time_cuda_ms(hk.xla_tree_sum_plain, sets)
    library_ms = time_cuda_ms(torch.sum, sets)
    launches_per_call = _one_launch("xla_tree_sum", hk.xla_tree_sum, sets[0])
    # config 4's sites, four operand sets each (together past the L2)
    ell4 = ells["config4"]
    fan_sets = {
        dtype: [fan_in_inputs(ell4.spans, ell4.n_pad, 3, "cuda", s, dtype)
                for s in range(4)]
        for dtype in ("float32", "bfloat16")
    }
    timed = {
        "evaluate": (hk.tree_evaluate, hk.tree_evaluate_plain, None,
                     [evaluate_inputs(c4, "cuda", s) for s in range(4)],
                     evaluate_bytes_ops),
        "fan_in": (_fan_in_call, _fan_in_plain, None, fan_sets["float32"],
                   fan_in_bytes_ops),
        "fan_in_bf16": (_fan_in_call, _fan_in_plain, None,
                        fan_sets["bfloat16"], fan_in_bytes_ops),
        "domain_sum": (
            _domain_sum_call, _domain_sum_plain,
            lambda x: torch.sum(x, 0, keepdim=True),
            [fan_in_inputs(ell4.spans, ell4.n_pad, 3, "cuda", s)[:1]
             for s in range(4)],
            lambda a: (a[0].numel() * 4 + a[0].shape[1] * 4, a[0].numel()),
        ),
    }
    # each site's kernel instantiation, as ptxas reported it
    usage = _build.resource_usage(_build.library_path("xla_tree_sum"))
    site_kernels = {
        "evaluate": "evaluate_kernel<int>",
        "fan_in": "tree_sum_kernel<FanSite<float>>",
        "fan_in_bf16": "tree_sum_kernel<FanSite<__nv_bfloat16>>",
        "domain_sum": "short_rows_kernel<3>",
    }
    extra = {}
    for site, (call, plain, library, site_sets, bytes_ops) in timed.items():
        _one_launch(site, call, site_sets[0])
        site_bytes, site_ops = bytes_ops(site_sets[0])
        bound_ms, bound_by = _bound(site_bytes, site_ops)
        ms = time_cuda_ms(call, site_sets)
        ptxas = [u for u in usage if u["kernel"] == site_kernels[site]]
        check(len(ptxas) == 1,
              f"ptxas reports {site_kernels[site]} {len(ptxas)} times")
        extra[f"{site}_config4"] = {
            "ms": ms,
            "plain_ms": time_cuda_ms(plain, site_sets),
            "library_ms": (
                time_cuda_ms(library, site_sets) if library else None
            ),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "bound_bytes": site_bytes, "launches_per_call": 1,
            "ptxas": ptxas,
        }
    # where the fan-in's time goes: its classes of up to 32 slots (the
    # warp tiles) alone and its longer classes (the row paths) alone, each
    # one launch of its own (the long classes' sets fit in L2 together)
    for part, short in (("short_classes", True), ("long_classes", False)):
        spans = tuple(s for s in ell4.spans if (s[1] <= 32) == short)
        part_sets = [
            fan_in_inputs(spans, sum(nb * db for nb, db in spans), 3,
                          "cuda", s)
            for s in range(4)
        ]
        extra["fan_in_config4"][part] = {
            "spans": [list(s) for s in spans],
            "ms": time_cuda_ms(_fan_in_call, part_sets),
            "bound_ms": _bound(*fan_in_bytes_ops(part_sets[0]))[0],
        }
    # where evaluate's time goes: its unary entries alone and its buckets
    # alone (evaluate_parts), each one launch
    evaluate_sets = {}
    for part in ("unary_only", "buckets_only"):
        cut = [evaluate_parts(a)[part] for a in timed["evaluate"][3]]
        evaluate_sets[part] = [ops for ops, _ in cut]
        extra["evaluate_config4"][part] = {
            "ms": time_cuda_ms(hk.tree_evaluate, evaluate_sets[part]),
            "bound_ms": _bound(*cut[0][1])[0],
        }
    # evaluate at config 6 (1,000,000 variables), four operand sets
    evaluate_sets["config6"] = [evaluate_inputs(c6, "cuda", s)
                                for s in range(4)]
    c6_bytes, c6_ops = evaluate_bytes_ops(evaluate_sets["config6"][0])
    c6_ms = time_cuda_ms(hk.tree_evaluate, evaluate_sets["config6"])
    extra["evaluate_config6"] = {
        "ms": c6_ms, "bound_ms": _bound(c6_bytes, c6_ops)[0],
        "bound_share": _bound(c6_bytes, c6_ops)[0] / c6_ms,
        "bound_bytes": c6_bytes,
    }
    row = _kernel_row(
        "xla_tree_sum", "xla_tree_sum",
        "none: the port's own kernel (evaluate's totals in XLA-CPU's order)",
        max_err, kernel_ms, plain_ms, nbytes, ops, library_ms=library_ms,
        n=n_total, launches_per_call=launches_per_call, **extra,
    )
    return row, {
        "xla_tree_sum_evaluate": timed["evaluate"][3],
        "xla_tree_sum_evaluate_unary": evaluate_sets["unary_only"],
        "xla_tree_sum_evaluate_buckets": evaluate_sets["buckets_only"],
        "xla_tree_sum_evaluate_config6": evaluate_sets["config6"],
        "xla_tree_sum_ell_fan_in": fan_sets["float32"],
        "xla_tree_sum_ell_fan_in_bf16": fan_sets["bfloat16"],
        "xla_tree_sum_rows": timed["domain_sum"][3],
    }


def _launcher(library, name):
    """A wrapper of another build's ``<name>_launch`` with this
    checkout's calling convention: outputs allocated like the port's
    wrappers allocate them, launched on the current stream."""
    import ctypes

    import torch

    from pydcop_tpu_torch.compile import hopper_kernels as hk

    lib = ctypes.CDLL(str(library))
    if name.startswith("xla_tree_sum"):
        return _tree_sum_launcher(lib, name)
    if name == "branch_bound":
        def call(*args):
            *ops, max_iters = args
            return hk.launch_branch_bound(lib, tuple(ops), max_iters)
        return call
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    if name == "ell_minplus":
        fn.argtypes = list(hk._ELL_MINPLUS_ARGS)

        def call(v2f, pair_perm, tabs, real_row):
            out = torch.empty_like(v2f)
            rc = fn(
                v2f.data_ptr(), pair_perm.data_ptr(), tabs.data_ptr(),
                real_row.data_ptr(), out.data_ptr(), *v2f.shape,
                torch.cuda.current_stream().cuda_stream,
            )
            check(rc == 0, f"{library}: {name} launch failed: {rc}")
            return out
    else:
        fn.argtypes = list(hk._FACTOR_ARITY2_ARGS)

        def call(v2f, e0, e1, tables):
            d, n_c = v2f.shape[0], e0.shape[0]
            out0, out1 = v2f.new_empty((d, n_c)), v2f.new_empty((d, n_c))
            rc = fn(
                v2f.data_ptr(), e0.data_ptr(), e1.data_ptr(),
                tables.data_ptr(), out0.data_ptr(), out1.data_ptr(), d,
                v2f.shape[1], n_c, torch.cuda.current_stream().cuda_stream,
            )
            check(rc == 0, f"{library}: {name} launch failed: {rc}")
            return out0, out1
    return call


def _tree_sum_launcher(lib, name):
    """Another build's ``xla_tree_sum_evaluate[_batched]_launch`` (called
    as ``tree_evaluate[_batched]``; the ``_unary`` and ``_buckets``
    entries are the solo one on ``evaluate_parts``' operands),
    ``xla_tree_sum_ell_fan_in[_bf16]_launch`` (called as
    ``_fan_in_call``) or ``xla_tree_sum_rows_launch`` (called as
    ``_domain_sum_call``: the [D, n] plane summed over D in place),
    marshalled by the port's own wrappers; its launches are not
    counted."""
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    if name.startswith("xla_tree_sum_evaluate"):
        launch = (hk._launch_evaluate_batched if name.endswith("_batched")
                  else hk._launch_evaluate)

        def call(unary, values, buckets, constant):
            return launch(unary, values, buckets, constant, unary.device,
                          library=lib)
        return call
    if name == "xla_tree_sum_rows":
        def call(x):
            return hk._launch_rows(x.movedim(0, -1), x.device, False,
                                   library=lib).unsqueeze(0)
        return call

    def call(f2v, u, spans):
        return hk._launch_fan_in(tuple(spans), u, f2v, f2v.device,
                                 library=lib)
    return call


def _source(name):
    """The ``csrc`` source of a kernel or of an ``xla_tree_sum`` entry."""
    return "xla_tree_sum" if name.startswith("xla_tree_sum") else name


def phase_against(other: Path, timed_sets):
    """Another checkout's kernels (built from ``other``: the float32
    min-plus kernels, the ``xla_tree_sum`` evaluate (solo, its parts and
    batched), fan-in and domain-sum entries and, where its source has
    one, ``branch_bound``) against this one's
    on the same operand sets: equal outputs, then times in turns,
    theirs, ours, ours, theirs."""
    from pydcop_tpu_torch.compile import _build
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    pkg = other / "pydcop_tpu_torch"
    names = [n for n in timed_sets
             if (pkg / "csrc" / f"{_source(n)}.cu").is_file()]
    t0 = time.perf_counter()
    libs = _build.build_all(
        sorted({_source(n) for n in names}), csrc=pkg / "csrc",
        build_dir=pkg / "_build",
    )
    build_s = time.perf_counter() - t0
    for name in names:
        theirs = _launcher(libs[_source(name)], name)
        # an xla_tree_sum entry: this build's library through the same
        # marshalling; every other kernel: its wrapper
        ours = (_launcher(_build.library_path("xla_tree_sum"), name)
                if _source(name) != name else getattr(hk, name))
        turns = _AGAINST_TURNS.get(name, _set_turns)
        for row in turns(name, theirs, ours, timed_sets[name]):
            emit({
                "phase": "against", "kernel": name, "other": str(other),
                "build_s": build_s, "equal": True,
                "order": [w for w, _ in _turns(theirs, ours)], **row,
            })


def _turns(theirs, ours):
    """The order of the timed calls: theirs, ours, ours, theirs."""
    return [("theirs", theirs), ("ours", ours), ("ours", ours),
            ("theirs", theirs)]


def _same_outputs(name, theirs, ours, args):
    import torch

    got, want = theirs(*args), ours(*args)
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    check(
        all(torch.equal(g, w) for g, w in zip(got, want)),
        f"{name}: the other checkout's kernel differs from this one's",
    )


def _set_turns(name, theirs, ours, sets):
    """A kernel's calls on its operand sets: equal outputs on the first,
    then the sets' mean time in turns."""
    _same_outputs(name, theirs, ours, sets[0])
    times = {"theirs": [], "ours": []}
    for who, fn in _turns(theirs, ours):
        times[who].append(time_cuda_ms(fn, sets))
    yield {
        "theirs_ms": times["theirs"], "ours_ms": times["ours"],
        "speedup": statistics.mean(times["theirs"])
        / statistics.mean(times["ours"]),
    }


def _search_turns(name, theirs, ours, searches):
    """The DFS kernel on the chip cell's SyncBB and NCBB searches: equal
    outputs on each, then a whole search a call in turns, timed between
    CUDA events; ms and ns a step."""
    for algo, args in zip(("syncbb", "ncbb"), searches):
        _same_outputs(name, theirs, ours, args)
        steps = int(ours(*args)[-2])
        times = {"theirs": [], "ours": []}
        for who, fn in _turns(theirs, ours):
            times[who].append(_events_ms(functools.partial(fn, *args), 3))
        yield {
            "search": algo, "steps": steps,
            "theirs_ms": times["theirs"], "ours_ms": times["ours"],
            "theirs_ns_per_step": [1e6 * t / steps for t in times["theirs"]],
            "ours_ns_per_step": [1e6 * t / steps for t in times["ours"]],
            "speedup": statistics.mean(times["theirs"])
            / statistics.mean(times["ours"]),
        }


# how phase_against compares a kernel with another checkout's: the DFS
# search by search, every other kernel on its operand sets
_AGAINST_TURNS = {"branch_bound": _search_turns}


def breakout_problems():
    """The problems of BREAKOUT, compiled from the object generators."""
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.commands.generators.mixedproblem import (
        generate_mixed_problem,
    )
    from pydcop_tpu_torch.compile.core import compile_dcop

    t0 = time.perf_counter()
    args, kw = CONFIG_7
    config7 = compile_dcop(generate_mixed_problem(*args, **kw))
    check(config7.n_constraints == 5050,
          f"config 7 has {config7.n_constraints} constraints, not 5050")
    out = {"config7": config7}
    for name, (n, d, kw) in (("hard10k", HARD_10K), ("hard80", HARD_80)):
        out[name] = compile_dcop(generate_graph_coloring(n, d, **kw))
    emit({"phase": "breakout_problems", "seconds": time.perf_counter() - t0,
          **{k: {"n_vars": c.n_vars, "n_constraints": c.n_constraints}
             for k, c in out.items()}})
    return out


def _engine_counts():
    from pydcop_tpu_torch.algorithms import base

    return {k: getattr(base.run_cycles, k) for k in ENGINE_COUNTERS}


def _profiled_launches(solve, names):
    """Each kernel's launches in one solve as the profiler sees them on
    the device (kernel events whose name holds the kernel's), beside the
    device events it saw in all: a cross-check of the counts."""
    import torch

    acts = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=acts) as prof:
        solve()
    events = [
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    out = {n: sum(n in e for e in events) for n in names}
    out["device_events"] = len(events)
    return out


def phase_solve(name, compiled, run, per_cycle, *, per_start=None,
                cpu_bar="exact", recorded=None, recorded_rel=0.0,
                recorded_values=None, against=None, profile=False):
    """One problem through a solver's entry point on the card, cold then
    warm, then the same solve on the CPU.  ``run`` = (algo, params,
    n_cycles, seed).  Around each solve every kernel's launches and the
    engine's counters are counted from zero: the cold solve captures the
    solve's two graphs (and its warm-up launches each kernel once an
    iteration), the warm one captures nothing, launches ``per_cycle``
    (launches an iteration, by kernel) times the iterations it replayed
    plus ``per_start`` (launches of the prologue, which evaluates the
    initial assignment; the cold solve runs it twice, in its warm-up and
    as a graph), and looks at the device O(log n_cycles) times.
    ``cpu_bar`` is "exact" (the same assignment, cycles and cost as the
    CPU) or "cost" (MaxSum's: equal violations, cost within rel 1e-5);
    ``recorded`` is (cost, violations, cycles) the solve must give, the
    cost within ``recorded_rel``, and ``recorded_values`` its value
    indices in variable order (a string of digits); ``against`` another
    solve of the problem on the card that must agree likewise."""
    import math

    import numpy as np

    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    algo, params, n_cycles, seed = run
    mod = load_algorithm_module(algo)
    counted = {k: getattr(hk, k) for k in per_cycle}
    per_start = {n: (per_start or {}).get(n, 0) for n in per_cycle}

    def solve(device):
        return mod.solve(
            compiled, params, n_cycles=n_cycles, seed=seed, device=device
        )

    def counted_solve(device):
        for k in counted.values():
            k.launches = 0
        engine = _engine_counts()
        t0 = time.perf_counter()
        res = solve(device)
        wall = time.perf_counter() - t0
        counts = {
            k: v - engine[k] for k, v in _engine_counts().items()
        }
        counts.update({n: k.launches for n, k in counted.items()})
        return res, wall, counts

    def same(a, b):
        if cpu_bar == "exact":
            return (a.assignment, a.cycles, a.cost, a.violations) == (
                b.assignment, b.cycles, b.cost, b.violations
            )
        return (
            a.violations == b.violations
            and abs(a.cost - b.cost) <= 1e-5 * abs(b.cost)
        )

    cold, cold_s, cold_counts = counted_solve("cuda")
    check(cold.cycles > 0, f"{name}: no cycle ran")
    warm_up = 1 if cold_counts["captures"] else 0
    want = {
        n: k * (cold_counts["iterations"] + warm_up)
        + per_start[n] * (1 + warm_up)
        for n, k in per_cycle.items()
    }
    got = {n: cold_counts[n] for n in per_cycle}
    check(got == want, f"{name}: cold launches {got}, want {want}")
    warm, warm_s, warm_counts = counted_solve("cuda")
    check(warm == cold, f"{name}: warm solve differs from cold solve")
    check(warm_counts["captures"] == 0, f"{name}: the warm solve captured")
    want = {
        n: k * warm_counts["iterations"] + per_start[n]
        for n, k in per_cycle.items()
    }
    got = {n: warm_counts[n] for n in per_cycle}
    check(got == want, f"{name}: warm launches {got}, want {want}")
    chunks = max(1, math.ceil(math.log2(n_cycles / 16 + 1)))
    check(
        warm_counts["host_syncs"] <= chunks,
        f"{name}: {warm_counts['host_syncs']} host syncs, over {chunks}",
    )
    cpu, cpu_s, cpu_counts = counted_solve("cpu")
    check(
        not any(cpu_counts[n] for n in per_cycle),
        f"{name}: the CPU solve launched a kernel",
    )
    vals = np.array([cold.assignment[v] for v in compiled.var_names])
    check(
        len(vals) == compiled.n_vars
        and vals.min() >= 0 and vals.max() < compiled.max_domain,
        f"{name}: assignment out of domain",
    )
    check(np.isfinite(cold.cost), f"{name}: cost not finite")
    # finalize's costing: the relations of a problem built from a DCOP,
    # the tables of an array-only one
    cost = (
        compiled.dcop.solution_cost(cold.assignment, 10000)
        if compiled.dcop is not None else compiled.host_cost(vals)
    )
    check(
        (cold.cost, cold.violations) == cost,
        f"{name}: reported cost is not the assignment's cost",
    )
    check(
        same(cold, cpu),
        f"{name}: cuda {cold.cost}/{cold.violations}/{cold.cycles} vs cpu "
        f"{cpu.cost}/{cpu.violations}/{cpu.cycles}",
    )
    out = {
        "phase": name, "algo": algo, "params": params,
        "n_vars": compiled.n_vars, "n_edges": compiled.n_edges,
        "n_cycles": n_cycles, "seed": seed,
        "cold_s": cold_s, "warm_s": warm_s,
        "warm_ms_per_cycle": 1e3 * warm_s / warm.cycles,
        "cost": cold.cost, "violations": cold.violations,
        "cycles": cold.cycles, "status": cold.status,
        "cold_counts": cold_counts, "warm_counts": warm_counts,
        "launches_per_iteration": per_cycle,
        "cpu_s": cpu_s, "cpu_cost": cpu.cost,
        "cpu_violations": cpu.violations, "cpu_cycles": cpu.cycles,
        "same_assignment_as_cpu": cold.assignment == cpu.assignment,
    }
    if recorded is not None:
        cost, violations, cycles = recorded
        check(
            (cold.violations, cold.cycles) == (violations, cycles)
            and abs(cold.cost - cost) <= recorded_rel * abs(cost),
            f"{name}: {(cold.cost, cold.violations, cold.cycles)} is not "
            f"the recorded {recorded}",
        )
        out["recorded"] = list(recorded)
    if recorded_values is not None:
        got = "".join(
            str(int(i))
            for i in compiled.indices_from_assignment(cold.assignment)
        )
        check(got == recorded_values,
              f"{name}: the assignment is not the recorded one")
        out["recorded_assignment"] = True
    if against is not None:
        check(
            same(cold, against),
            f"{name}: cost {cold.cost}/{cold.violations} vs the other "
            f"solve's {against.cost}/{against.violations}",
        )
        out.update(
            other_cost=against.cost,
            same_assignment_as_other=cold.assignment == against.assignment,
        )
    if profile:
        out["profiler_launches"] = _profiled_launches(
            lambda: solve("cuda"), list(per_cycle)
        )
    emit(out)
    return cold, warm_counts


def _final_planes(mod, solve):
    """The final (v2f, f2v) planes of ``solve()`` (a solve of ``mod``),
    on the host: its ``run_cycles`` call gets a ``state_into`` of its
    own tensors (``init_ell`` hands one zero tensor to both planes)."""
    import torch

    from pydcop_tpu_torch.algorithms import base

    seen = {}
    orig = mod.run_cycles

    def spy(*args, **kwargs):
        _, dev, init = args[:3]
        tree = init(dev, None, *kwargs.get("consts", ()))
        kwargs["state_into"] = base._unflatten(tree, iter([
            x.clone() if isinstance(x, torch.Tensor) else x
            for x in base._flatten(tree, [])
        ]))
        out = orig(*args, **kwargs)
        seen["state"] = out[2]["state"]
        return out

    mod.run_cycles = spy
    try:
        solve()
    finally:
        mod.run_cycles = orig
    return seen["state"].v2f.cpu(), seen["state"].f2v.cpu()


def phase_fma(name, compiled, spec, pinned, planes_vs_cpu):
    """MaxSum on ``ell`` at bench config 4's or 6's size and damping
    (``fma_config4``, ``fma_config6``), warm: both float32 damping sites
    are one ``damp_fma`` launch each, and the solve gives the JAX
    package's pinned (cost, violations, cycles).  Beside it, on this card,
    the same solve damped in the plain torch form (three elementwise
    kernels a site, the parent's form): kernels and µs an iteration of
    each chunk graph, walls.  With ``planes_vs_cpu`` the final message
    planes are the CPU's bit for bit."""
    import torch

    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.tools.profile_solve import _graph_ms

    params = dict(spec["params"], layout="ell")

    def solve(device="cuda"):
        return maxsum.solve(compiled, dict(params), n_cycles=spec["n_cycles"],
                            seed=spec["seed"], device=device)

    def ell_graphs():
        return {k: g for k, g in _cycle_graphs(compiled).items()
                if k[1].health is None and k[1].step.__name__ == "step_ell"}

    fma_graphs = ell_graphs()
    check(len(fma_graphs) == 1,
          f"{name}: {len(fma_graphs)} ELL graphs before the phase")
    (fma_key, fma_graph), = fma_graphs.items()
    res, wall, counts = _counted(solve)
    its = counts["iterations"]
    check(counts["captures"] == 0, f"{name}: the warm solve captured")
    check(counts["damp_fma"] == 2 * its > 0,
          f"{name}: {counts['damp_fma']} damp_fma launches, {its} "
          "iterations")
    got = (res.cost, res.violations, res.cycles)
    check(got == tuple(pinned), f"{name}: {got}, the JAX package {pinned}")
    out = {
        "phase": name, "n_vars": compiled.n_vars, "params": params,
        "cost": res.cost, "jax_cost": pinned[0], "cost_equal_jax": True,
        "cycles": res.cycles, "warm_s": wall, "counts": counts,
        "damp_fma_per_iteration": counts["damp_fma"] / its,
        "kernels_per_iteration": _device_events(solve) / its,
        "us_per_iteration": 1e3 * _graph_ms(fma_graph.chunk)
        / fma_key[1].length,
    }
    # the plain form, on this card: the step built with fma_damping off
    orig = maxsum._make_step
    maxsum._make_step = lambda *a, **k: orig(*a, **dict(k, fma_damping=False))
    try:
        plain_res = solve()  # cold: its own graphs
        _, plain_wall, plain_counts = _counted(solve)
        plain_events = _device_events(solve)
    finally:
        maxsum._make_step = orig
    plain_keys = set(ell_graphs()) - {fma_key}
    check(len(plain_keys) == 1, f"{name}: {len(plain_keys)} plain graphs")
    plain_key = plain_keys.pop()
    check(plain_counts["damp_fma"] == 0,
          f"{name}: the plain form launched damp_fma")
    out.update(
        plain_form_warm_s=plain_wall,
        plain_form_kernels_per_iteration=(
            plain_events / plain_counts["iterations"]),
        plain_form_us_per_iteration=(
            1e3 * _graph_ms(ell_graphs()[plain_key].chunk)
            / plain_key[1].length),
        plain_form_cost=plain_res.cost,
        plain_form_same_assignment=plain_res.assignment == res.assignment,
    )
    # the plain form's graphs go: this phase alone uses them
    compiled.__dict__["_device_consts"].pop(plain_key)
    if planes_vs_cpu:
        card = _final_planes(maxsum, solve)
        cpu = _final_planes(maxsum, lambda: solve("cpu"))
        for plane, a, b in zip(("v2f", "f2v"), card, cpu):
            check(torch.equal(a, b),
                  f"{name}: the card's final {plane} is not the CPU's")
        out["planes_equal_cpu"] = True
    emit(out)


def phase_timeouts(c4, ell4):
    """The timeout path on the card: MaxSum at config 4 with a budget it
    does not reach gives the same result as without one, FINISHED; DSA
    with a budget that ends before its first look reports TIMEOUT after
    its first whole chunk, as the same solve does on the CPU."""
    from pydcop_tpu_torch.algorithms import base, dsa, maxsum

    spec = CONFIG_4
    t0 = time.perf_counter()
    res = maxsum.solve(
        c4, dict(spec["params"], layout="ell"), n_cycles=spec["n_cycles"],
        seed=spec["seed"], timeout=600.0,
    )
    finished_s = time.perf_counter() - t0
    check(res.status == "FINISHED", f"maxsum timeout: {res.status}")
    check(res == ell4, "maxsum with a timeout differs from without one")
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[device] = dsa.solve(
            c4, {}, n_cycles=100_000, seed=7, timeout=1e-3, device=device
        )
        runs[device + "_s"] = time.perf_counter() - t0
    out = runs["cuda"]
    boundaries = {base.TIMEOUT_CHUNK * (2 ** k - 1) for k in range(1, 8)}
    check(
        out.status == "TIMEOUT" and out.cycles in boundaries,
        f"dsa timeout: {out.status} after {out.cycles} cycles",
    )
    check(
        (out.assignment, out.cycles, out.cost)
        == (runs["cpu"].assignment, runs["cpu"].cycles, runs["cpu"].cost),
        "dsa timeout: the card and the CPU differ",
    )
    emit({
        "phase": "timeouts",
        "maxsum_100k": {
            "timeout_s": 600.0, "status": res.status, "cycles": res.cycles,
            "cost": res.cost, "same_as_without": True, "wall_s": finished_s,
        },
        "dsa_100k": {
            "timeout_s": 1e-3, "n_cycles": 100_000, "status": out.status,
            "cycles": out.cycles, "cost": out.cost,
            "same_as_cpu": True, "wall_s": runs["cuda_s"],
            "cpu_wall_s": runs["cpu_s"],
        },
    })


def _zero_launches():
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    for name in KERNEL_WRAPPERS:
        getattr(hk, name).launches = 0


def _launch_counts():
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    return {name: getattr(hk, name).launches for name in KERNEL_WRAPPERS}


def _same_result(got, want, name):
    """MaxSum's bar between the card and the CPU on result dicts: the
    same assignment, violations, cycles, messages and status, the cost
    within rel 1e-5.  Returns whether the costs are also bit-equal."""
    for key in ("assignment", "violation", "cycle", "msg_count",
                "msg_size", "status"):
        check(got[key] == want[key], f"{name}: {key} {got[key]!r} != "
              f"{want[key]!r}")
    check(
        abs(got["cost"] - want["cost"]) <= 1e-5 * abs(want["cost"]),
        f"{name}: cost {got['cost']} vs {want['cost']}",
    )
    return got["cost"] == want["cost"]


def phase_front_door_yaml():
    """YAML on the card, through the CLI and the library: each file is
    solved by ``python -m pydcop_tpu_torch solve`` on the card (a
    subprocess) and must print the CPU's in-process result; the library's
    card solve launches ``ell_minplus`` (``auto`` resolves to ELL on these
    binary problems), and one ``layout:pallas`` solve launches
    ``factor_arity2_minplus``.  The three CLI subprocesses run at once
    (each one's wall is mostly its own cold start), beside
    the in-process solves; each ``cli_s`` is its own subprocess's wall.
    Returns the README problem's YAML and the CLI's printed JSON."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    def run_cli(path):
        t0 = time.perf_counter()
        cli = subprocess.run(
            PORT_CLI + ["solve", *FRONT_DOOR_ARGS, str(path)],
            cwd=ROOT, capture_output=True, text=True, timeout=900,
        )
        return cli, time.perf_counter() - t0

    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.api import solve_result
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop_from_file

    readme_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        n, d, kw = README_PROBLEM
        readme = Path(tmp) / "gc1000.yaml"
        readme_out["yaml"] = dcop_yaml(generate_graph_coloring(n, d, **kw))
        readme.write_text(readme_out["yaml"])
        write_s = time.perf_counter() - t0
        files = [ROOT / f for f in FRONT_DOOR_YAML] + [readme]
        pool = ThreadPoolExecutor(len(files))
        runs = [pool.submit(run_cli, path) for path in files]
        pool.shutdown(wait=False)
        for path, run in zip(files, runs):
            cli, cli_s = run.result()
            check(cli.returncode == 0,
                  f"{path.name}: the CLI exited {cli.returncode}: "
                  f"{cli.stderr[-2000:]}")
            printed = json.loads(cli.stdout)
            t0 = time.perf_counter()
            dcop = load_dcop_from_file(str(path))
            load_s = time.perf_counter() - t0
            algo = AlgorithmDef.build_with_default_param(
                "maxsum", {"damping": 0.7}, mode=dcop.objective
            )
            run = dict(distribution="oneagent", n_cycles=50, seed=0)
            cpu = json.loads(json.dumps(
                solve_result(dcop, algo, device="cpu", **run), default=str
            ))
            cost_equal = _same_result(printed, cpu, f"{path.name} CLI")
            _zero_launches()
            card = solve_result(dcop, algo, device="cuda", **run)
            launches = _launch_counts()
            check(launches["ell_minplus"] > 0,
                  f"{path.name}: the card solve launched no ell_minplus")
            _same_result(json.loads(json.dumps(card, default=str)), cpu,
                         f"{path.name} library")
            out = {
                "phase": "front_door_yaml", "file": path.name,
                "n_vars": len(dcop.variables),
                "n_constraints": len(dcop.constraints),
                "cli_s": cli_s, "load_s": load_s, "card_s": card["time"],
                "cost": printed["cost"], "violation": printed["violation"],
                "cycle": printed["cycle"], "msg_count": printed["msg_count"],
                "cli_equals_cpu": True, "cost_bit_equal": cost_equal,
                "launches": launches,
            }
            if path == readme:
                readme_out["printed"] = printed
                out["dcop_yaml_s"] = write_s
                algo = AlgorithmDef.build_with_default_param(
                    "maxsum", {"damping": 0.7, "layout": "pallas"},
                    mode=dcop.objective,
                )
                _zero_launches()
                pallas = solve_result(dcop, algo, device="cuda", **run)
                out["pallas_launches"] = _launch_counts()
                check(out["pallas_launches"]["factor_arity2_minplus"] > 0,
                      "layout:pallas launched no factor_arity2_minplus")
                _same_result(
                    json.loads(json.dumps(pallas, default=str)),
                    json.loads(json.dumps(solve_result(
                        dcop, algo, device="cpu", **run), default=str)),
                    "layout:pallas",
                )
            emit(out)
    return readme_out


def _trace_kernels(trace_path):
    """The kernels of a ``torch.profiler`` Chrome trace by
    ``PROFILE_KERNELS`` wrapper: ``(inside, outside, ranges)``, the
    counts inside a ``solve.*`` device range (the GPU track of the
    engine's ``record_function`` annotations) and outside one, and the
    ranges' names."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted(
        (e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
        if e.get("cat") == "gpu_user_annotation"
        and str(e.get("name", "")).startswith("solve.")
    )
    inside = {name: 0 for name in PROFILE_KERNELS}
    outside = dict(inside)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for name, parts in PROFILE_KERNELS.items():
            if any(p in e["name"] for p in parts):
                hit = any(a <= e["ts"] <= b for a, b, _ in ranges)
                (inside if hit else outside)[name] += 1
    return inside, outside, sorted({r[2] for r in ranges})


def phase_profile_capture(readme):
    """Profiling on the card: the README's problem (``readme``: its YAML
    and the front door's printed JSON without the flags) through ``solve
    --profile-out --dump-hlo``, while ``capture --configs 2 3 4`` runs
    beside it (the solve's wall is its YAML and cold start on the host;
    its device work, under a second, overlaps no timing of the capture's
    that a check reads: the attribution bar is on CUDA-event times), then
    the capture's self-diff, each a CLI subprocess.  Returns the profiled
    solve's kernels in the trace by wrapper (its launches: the profiler's
    count, inside the ``solve.maxsum.*`` ranges)."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        try:
            return _profile_capture(readme, tmp, t_phase)
        finally:
            for proc in _PROFILE_PROCS:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            _PROFILE_PROCS.clear()


# the capture subprocess of profile_capture, reaped whatever happens
_PROFILE_PROCS = []


def _profile_capture(readme, tmp, t_phase):
    import torch

    from pydcop_tpu_torch.algorithms import mgm2
    from pydcop_tpu_torch.commands.generators.ising import (
        generate_ising_arrays,
    )

    yaml_path = tmp / "gc1000.yaml"
    yaml_path.write_text(readme["yaml"])
    prof_dir, hlo_dir = tmp / "profile", tmp / "hlo"
    bundle = tmp / "bundle"
    t_cap = time.perf_counter()
    with open(tmp / "capture.out", "w") as out, \
            open(tmp / "capture.err", "w") as err:
        # no profiler session here: the profiled solve covers it, and
        # the three configs' traces are ~270 MB
        _PROFILE_PROCS.append(subprocess.Popen(
            PORT_CLI + ["--output", str(tmp / "capture.json"),
                        "capture", "-o", str(bundle), "--configs",
                        *CAPTURE_CONFIGS, "--no-profiler"],
            cwd=ROOT, stdout=out, stderr=err, text=True,
        ))
    t0 = time.perf_counter()
    cli = subprocess.run(
        PORT_CLI + ["solve", *FRONT_DOOR_ARGS, "--profile-out",
                    str(prof_dir), "--dump-hlo", str(hlo_dir),
                    "--metrics-out", str(tmp / "metrics.json"),
                    str(yaml_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    solve_s = time.perf_counter() - t0
    check(cli.returncode == 0,
          f"profile_capture: the profiled solve exited "
          f"{cli.returncode}: {cli.stderr[-2000:]}")
    printed = json.loads(cli.stdout)
    want = dict(readme["printed"])
    for doc in (printed, want):
        doc.pop("time", None)
    check(printed == want,
          "profile_capture: the profiled solve's JSON differs from "
          "the front door's")
    traces = sorted(prof_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"profile_capture: traces {traces}")
    trace_bytes = traces[0].stat().st_size
    inside, outside, ranges = _trace_kernels(traces[0])
    for name, n in inside.items():
        check(n > 0, f"profile_capture: no {name} kernel inside a "
              f"solve.* range of the trace ({ranges})")
    check({"solve.maxsum.fused", "solve.maxsum.readback"} <= set(ranges),
          f"profile_capture: ranges {ranges}")
    dots = sorted(p.name for p in hlo_dir.glob("*.graph.dot"))
    with open(tmp / "metrics.json") as f:
        metrics = json.load(f)["metrics"]

    def metric(name, **labels):
        return sum(
            e["value"] for e in metrics.get(name, {}).get("values", [])
            if all(dict(e.get("labels") or {}).get(k) == v
                   for k, v in labels.items())
        )

    compiles = metric("compile.jit_compiles", fn="solve.run_cycles")
    check(compiles >= 1, "profile_capture: no capture counted")
    # a build captures the prologue's and the chunk's graphs
    check(len(dots) == metric("compile.hlo_dumps") == 2 * compiles,
          f"profile_capture: DOT files {dots} for {compiles} builds")
    emit({
        "phase": "profile_capture_solve", "seconds": solve_s,
        "json_equal": True, "trace_bytes": trace_bytes,
        "kernels_in_solve_ranges": inside,
        "kernels_outside_ranges": outside, "ranges": ranges,
        "dot_files": dots, "captures_counted": compiles,
        "capture_peak_bytes": metric("compile.memory_bytes",
                                     fn="solve.run_cycles",
                                     kind="peak"),
    })

    rc = _PROFILE_PROCS[0].wait(timeout=900)
    capture_s = time.perf_counter() - t_cap
    check(rc == 0,
          f"profile_capture: capture exited {rc}: "
          f"{(tmp / 'capture.err').read_text()[-3000:]}")
    with open(bundle / "manifest.json") as f:
        manifest = json.load(f)
    records = {}
    for key in CAPTURE_CONFIGS:
        with open(bundle / "records" / f"config_{key}.json") as f:
            records[key] = json.load(f)
        check(manifest["configs"][key]["attribution"] == "ok",
              f"profile_capture: config {key} attribution "
              f"{manifest['configs'][key]['attribution']}")
        jit = records[key]["census"]["jit"]
        check(all(r["compiles"] == 0 for r in jit.values()),
              f"profile_capture: config {key} rebuilt a runner in its "
              f"timed run: {jit}")
    for key, pin in (("2", MAXSUM_RECORDED["config2"]),
                     ("4", MAXSUM_RECORDED["config4"])):
        got = (records[key]["cost"], records[key]["violations"])
        check(got == pin[:2],
              f"profile_capture: config {key} gave {got}, pinned "
              f"{pin[:2]}")
    cpu3 = mgm2.solve(generate_ising_arrays(*CONFIG_3["gen"]),
                      {}, n_cycles=CONFIG_3["n_cycles"],
                      seed=CONFIG_3["seed"], device="cpu")
    got = (records["3"]["cost"], records["3"]["violations"])
    check(got == (cpu3.cost, cpu3.violations),
          f"profile_capture: config 3 gave {got}, the CPU "
          f"{(cpu3.cost, cpu3.violations)}")
    kernel4 = records["4"]["kernel"]
    lo, hi = ATTRIBUTION_BAR
    check(lo <= kernel4["attributed_pct"] <= hi,
          f"profile_capture: config 4 attributes "
          f"{kernel4['attributed_pct']}% of its real step")
    env = manifest["environment"]
    check(env.get("backend") == torch.cuda.get_device_name(0)
          and "power_limit" in env,
          f"profile_capture: the manifest's environment {env}")
    emit({"phase": "profile_capture_config4_kernel", **kernel4})
    emit({"phase": "profile_capture_config3_phases",
          **records["3"]["kernel"]})
    emit({
        "phase": "profile_capture", "seconds": capture_s,
        "configs": {
            key: {"value": r["value"], "cost": r["cost"],
                  "census": r["census"],
                  "compile": r["compile"],
                  "roofline": r.get("roofline"),
                  "memory": r["memory"]}
            for key, r in records.items()
        },
        "environment": env,
        "bundle_bytes": sum(p.stat().st_size
                            for p in bundle.rglob("*") if p.is_file()),
        "dot_files": sum(1 for _ in (bundle / "hlo").rglob("*.dot")),
    })
    t0 = time.perf_counter()
    diff = subprocess.run(
        PORT_CLI + ["capture", "diff", str(bundle), str(bundle)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    check(diff.returncode == 0,
          f"profile_capture: the self-diff exited {diff.returncode}: "
          f"{diff.stdout[-1000:]} {diff.stderr[-1000:]}")
    emit({"phase": "profile_capture_diff",
          "seconds": time.perf_counter() - t0,
          "phase_seconds": time.perf_counter() - t_phase})
    return inside


def phase_front_door_objects():
    """The object path at config 4's size: generate the DCOP objects,
    ``compile_dcop``, then MaxSum through ``solve_result`` on the card,
    cold and warm, against the CPU; the host seconds of each stage,
    ``solution_cost`` (which evaluates every relation in Python) among
    them."""
    from pydcop_tpu_torch.algorithms import AlgorithmDef, base
    from pydcop_tpu_torch.api import solve_result
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.compile.core import compile_dcop

    n, d, kw = OBJECTS_100K
    t0 = time.perf_counter()
    dcop = generate_graph_coloring(n, d, **kw)
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = compile_dcop(dcop)
    compile_s = time.perf_counter() - t0
    algo = AlgorithmDef.build_with_default_param(
        "maxsum", {"damping": 0.7}, mode=dcop.objective
    )
    run = dict(n_cycles=30, seed=7, compiled=compiled)
    walls, counts, results = {}, {}, {}
    for which, device in (("cold", "cuda"), ("warm", "cuda"),
                          ("cpu", "cpu")):
        _zero_launches()
        engine = _engine_counts()
        t0 = time.perf_counter()
        results[which] = solve_result(dcop, algo, device=device, **run)
        walls[which] = time.perf_counter() - t0
        counts[which] = {
            k: v - engine[k] for k, v in _engine_counts().items()
        }
        counts[which].update(_launch_counts())
    check(counts["warm"]["captures"] == 0, "objects: the warm solve captured")
    check(counts["warm"]["ell_minplus"] > 0,
          "objects: the warm solve launched no ell_minplus")
    warm = dict(results["warm"], time=None)
    check(warm == dict(results["cold"], time=None),
          "objects: warm differs from cold")
    cost_equal = _same_result(results["cold"], results["cpu"], "objects")
    t0 = time.perf_counter()
    cost = dcop.solution_cost(results["warm"]["assignment"])
    solution_cost_s = time.perf_counter() - t0
    check(cost == (results["warm"]["cost"], results["warm"]["violation"]),
          "objects: the reported cost is not solution_cost's")
    emit({
        "phase": "front_door_objects", "n_vars": compiled.n_vars,
        "n_constraints": compiled.n_constraints,
        "n_edges": compiled.n_edges,
        "generate_s": generate_s, "compile_dcop_s": compile_s,
        "solution_cost_s": solution_cost_s,
        "cold_s": walls["cold"], "warm_s": walls["warm"],
        "cpu_s": walls["cpu"],
        "solve_time_warm_s": results["warm"]["time"],
        "cost": results["cold"]["cost"],
        "violation": results["cold"]["violation"],
        "cycle": results["cold"]["cycle"], "cost_bit_equal": cost_equal,
        "host_syncs_warm": counts["warm"]["host_syncs"],
        "cold_counts": counts["cold"], "warm_counts": counts["warm"],
    })


def _meetings(resources_count):
    from pydcop_tpu_torch.commands.generators.meetingscheduling import (
        generate_meeting_scheduling,
    )
    from pydcop_tpu_torch.compile.core import compile_dcop

    return compile_dcop(generate_meeting_scheduling(
        slots_count=8, resources_count=resources_count, events_count=30,
        max_resources_event=2, seed=5,
    ))


def _dpop_checked(res, resources_count, name):
    want = DPOP_JAX[resources_count]
    got = (res.cost, res.violations, res.msg_count, res.msg_size)
    check(got == want, f"{name}: {got}, the JAX package gives {want}")


def phase_dpop_config5():
    """Bench config 5 as ``bench_all.py`` builds it: DPOP on the card,
    cold (its fused UTIL wave captured into one graph) and warm (a
    replay, no capture), against the CPU and the JAX package's result."""
    import torch

    from pydcop_tpu_torch.algorithms import dpop

    compiled = _meetings(30)
    walls, counts, results = {}, {}, {}
    for which, device in (("cold", "cuda"), ("warm", "cuda"),
                          ("cpu", "cpu")):
        before = (dpop.solve.captures, dpop.solve.replays)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[which] = dpop.solve(compiled, {}, n_cycles=1, seed=0,
                                    device=device)
        walls[which] = time.perf_counter() - t0
        counts[which] = {
            "captures": dpop.solve.captures - before[0],
            "replays": dpop.solve.replays - before[1],
        }
        _dpop_checked(results[which], 30, f"dpop config 5 {which}")
    check(counts["cold"] == {"captures": 1, "replays": 1},
          f"dpop cold: {counts['cold']}")
    check(counts["warm"] == {"captures": 0, "replays": 1},
          f"dpop warm: {counts['warm']}")
    check(results["cold"] == results["cpu"] == results["warm"],
          "dpop config 5: the card and the CPU differ")
    res = results["cold"]
    emit({
        "phase": "dpop_config5", "n_vars": compiled.n_vars,
        "max_domain": compiled.max_domain,
        "n_constraints": compiled.n_constraints,
        "cold_s": walls["cold"], "warm_s": walls["warm"],
        "cpu_s": walls["cpu"], "cost": res.cost,
        "violations": res.violations, "msg_count": res.msg_count,
        "msg_size": res.msg_size, "same_assignment_as_cpu": True,
        "counts": counts,
    })


def phase_dpop_wide():
    """The wider meeting instances on the card, against the JAX package's
    results pinned in ``DPOP_JAX``: 20 resources (induced width 7, over
    the fused budget: the streaming path) and 15 (width 8, a 9^9 joint:
    the chunked path).  Prints each wall, the chunks contracted and the
    peak device memory."""
    import torch

    from pydcop_tpu_torch.algorithms import dpop

    for resources_count in (20, 15):
        t0 = time.perf_counter()
        compiled = _meetings(resources_count)
        compile_s = time.perf_counter() - t0
        before = (dpop.solve.chunks, dpop.solve.captures)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = dpop.solve(compiled, {}, n_cycles=1, seed=0, device="cuda")
        wall = time.perf_counter() - t0
        chunks = dpop.solve.chunks - before[0]
        _dpop_checked(res, resources_count, f"dpop {resources_count}")
        check(dpop.solve.captures == before[1],
              f"dpop {resources_count}: the wave was captured, not streamed")
        check((chunks > 0) == (resources_count == 15),
              f"dpop {resources_count}: {chunks} chunks")
        emit({
            "phase": "dpop_wide", "resources_count": resources_count,
            "n_vars": compiled.n_vars,
            "n_constraints": compiled.n_constraints,
            "compile_s": compile_s, "wall_s": wall, "chunks": chunks,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "cost": res.cost, "violations": res.violations,
            "msg_count": res.msg_count, "msg_size": res.msg_size,
        })
        del compiled, res


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0]
    return float(out) * 1e6


def _events_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` between CUDA events, after one
    warm-up call: for calls long enough (a whole search) that the launch
    does not count."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bb_searches(compiled):
    """(name, operands on the card) of the two searches of ``compiled``:
    SyncBB's (lexical order) and NCBB's (the pseudo-tree's DFS order,
    seeded with its greedy assignment)."""
    import numpy as np
    import torch

    from pydcop_tpu_torch.algorithms import _branch_bound, ncbb
    from pydcop_tpu_torch.algorithms.dpop import _Tree

    tree = _Tree(compiled)
    cuda = torch.device("cuda")
    return [
        ("syncbb", _branch_bound._operands(
            compiled, np.arange(compiled.n_vars), None, cuda)),
        ("ncbb", _branch_bound._operands(
            compiled, np.asarray(tree.topo), ncbb._greedy_init(compiled, tree),
            cuda)),
    ]


def branch_bound_bytes_ops(ops, steps: int):
    """(bytes, ops) of one search: each operand read once, the result
    written once; per step the candidate's K attachment adds and three
    more (unary, prefix, bound)."""
    unary = ops[0]
    k = ops[2].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in ops)
    nbytes += (unary.shape[0] + 3) * 4
    return nbytes, steps * (k + 3)


def _events_call(fn):
    """``fn()``'s result and its device time in ms between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _branch_bound_row(small, cell):
    """``branch_bound`` against its plain version on the card, exactly
    (best, ub's bits, steps, completion), on SyncBB's and NCBB's
    searches: of the 16-variable coloring, capped at 5 steps and
    complete, and of the chip cell (24 variables: the operands the main
    path gives the kernel), capped at BB_CELL_CHECK_CAPS.  Timed: the
    kernel on SyncBB's complete 16-variable search beside the plain
    step's checked call on it (the same inputs), and the kernel on the
    chip cell's two searches, each beside its bounds: bytes and
    operations, and the latency of one dependent shared-memory load a
    step (any search that takes JAX's steps pays it), with the first
    design's three a step beside it.  With the registers and spills of every
    instantiation of the kernel."""
    import torch

    from pydcop_tpu_torch.algorithms._branch_bound import DEFAULT_MAX_ITERS
    from pydcop_tpu_torch.compile import _build
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    checked = {}
    plain_ms = None
    for problem, caps in ((small, (5, DEFAULT_MAX_ITERS)),
                          (cell, BB_CELL_CHECK_CAPS)):
        for algo, ops in _bb_searches(problem):
            n_vars = ops[0].shape[0]
            for max_iters in caps:
                got = hk.branch_bound(*ops, max_iters)
                want, ms = _events_call(
                    lambda: hk.branch_bound_plain(*ops, max_iters)
                )
                equal = torch.equal(got, want)
                checked[f"{algo}_{n_vars}_{max_iters}"] = {
                    "n_vars": n_vars, "slots": ops[2].shape[1],
                    "steps": int(got[-2]), "complete": bool(got[-1]),
                    "equal": equal, "plain_ms": ms,
                }
                check(equal, f"branch_bound != its plain version: {algo}, "
                      f"{n_vars} variables, max_iters {max_iters}")
                if problem is small and algo == "syncbb" and (
                    max_iters == DEFAULT_MAX_ITERS
                ):
                    plain_ms = ms
    emit({"phase": "kernels", "kernel": "branch_bound", "shapes": checked})
    clock = sm_clock_hz()

    def timed(ops, reps):
        out = hk.branch_bound(*ops, DEFAULT_MAX_ITERS)
        steps = int(out[-2])
        ms = _events_ms(lambda: hk.branch_bound(*ops, DEFAULT_MAX_ITERS),
                        reps)
        nbytes, n_ops = branch_bound_bytes_ops(ops, steps)
        return steps, ms, nbytes, n_ops

    def latency_ms(steps, loads):
        return 1e3 * steps * loads * SMEM_LOAD_CYCLES / clock

    small_ops = dict(_bb_searches(small))["syncbb"]
    steps, kernel_ms, nbytes, n_ops = timed(small_ops, 5)
    cells = {}
    for algo, ops in _bb_searches(cell):
        c_steps, ms, c_bytes, c_ops = timed(ops, 3)
        bound_ms, bound_by = _bound(c_bytes, c_ops)
        cells[algo] = {
            "n_vars": ops[0].shape[0], "slots": ops[2].shape[1],
            "steps": c_steps, "ms": ms, "ns_per_step": 1e6 * ms / c_steps,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "latency_bound_ms": latency_ms(c_steps, 1),
            "latency_share": latency_ms(c_steps, 1) / ms,
            "latency_bound_3load_ms": latency_ms(c_steps, 3),
            "latency_3load_share": latency_ms(c_steps, 3) / ms,
        }
    return _kernel_row(
        "branch_bound", "branch_bound",
        "none: the port's own kernel (the DFS that the JAX package runs as "
        "the lax.while_loop _bb_loop, pydcop_tpu/algorithms/"
        "_branch_bound.py:95)",
        0.0, kernel_ms, plain_ms, nbytes, n_ops, library_ms=None,
        steps=steps, ns_per_step=1e6 * kernel_ms / steps,
        plain_ns_per_step=1e6 * plain_ms / steps,
        latency_bound_ms=latency_ms(steps, 1),
        latency_bound=(
            f"{steps} steps x 1 dependent shared-memory load x "
            f"{SMEM_LOAD_CYCLES} cycles at {clock / 1e6:.0f} MHz"
        ),
        latency_bound_3load_ms=latency_ms(steps, 3),
        sm_clock_mhz=clock / 1e6, cell=cells,
        ptxas=_build.resource_usage(_build.library_path("branch_bound")),
    )


def phase_branch_bound():
    """SyncBB and NCBB on the chip cell through their entry points, cold
    and warm: one ``branch_bound`` launch a solve (counted from zero
    around each), the JAX package's cost, steps, messages and assignment,
    FINISHED.  Returns the warm SyncBB solve's launches."""
    import torch

    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.compile import hopper_kernels as hk
    from pydcop_tpu_torch.compile.core import compile_dcop

    n, d, kw = BB_CELL
    compiled = compile_dcop(generate_graph_coloring(n, d, **kw))
    launches = {}
    for algo in ("syncbb", "ncbb"):
        mod = load_algorithm_module(algo)
        out = {"phase": f"{algo}_24", "n_vars": compiled.n_vars,
               "n_constraints": compiled.n_constraints}
        results = []
        for which in ("cold", "warm"):
            _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mod.solve(compiled, {}, device="cuda")
            out[f"{which}_s"] = time.perf_counter() - t0
            launches[algo] = _launch_counts()
            check(launches[algo] == {**{k: 0 for k in KERNEL_WRAPPERS},
                                     "branch_bound": 1},
                  f"{algo}: launches {launches[algo]}, want one DFS")
            results.append(res)
        res = results[0]
        check(results[1] == res, f"{algo}: the warm solve differs")
        got = (res.cost, res.violations, res.cycles, res.msg_count)
        check(got == BB_JAX[algo] and res.status == "FINISHED",
              f"{algo}: {got} {res.status}, the JAX package gives "
              f"{BB_JAX[algo]}")
        values = "".join(
            str(int(i)) for i in compiled.indices_from_assignment(
                res.assignment)
        )
        check(values == BB_JAX_VALUES, f"{algo}: not JAX's assignment")
        out.update(
            cost=res.cost, violations=res.violations, cycle=res.cycles,
            msg_count=res.msg_count, msg_size=res.msg_size,
            status=res.status, recorded_assignment=True,
            launches=launches[algo],
        )
        emit(out)
    return launches["syncbb"]["branch_bound"]


def phase_dynamic_config4():
    """The resident DynamicMaxSum session on config 4's relation objects,
    on the card and on the CPU: run(30), run(30), the change of
    DYNAMIC_CHANGE, run(30).  Each run on the card equals the CPU's; the
    costs are the JAX package's exactly (DYNAMIC_JAX).  On the card,
    launches are counted from zero around each run
    (``factor_arity2_minplus`` once an iteration replayed, one more in
    the cold run's warm-up), the first run captures the session's two
    graphs, the others nothing, and the graph cache keeps its size."""
    from pydcop_tpu_torch.algorithms.maxsum_dynamic import DynamicMaxSum
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.dcop.relations import constraint_from_str

    n, d, kw = OBJECTS_100K
    runs, setup = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        dcop = generate_graph_coloring(n, d, **kw)
        setup[f"{device}_generate_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        session = DynamicMaxSum(dcop, {"damping": 0.7}, seed=7,
                                device=device)
        setup[f"{device}_session_s"] = time.perf_counter() - t0
        steps = []
        for i in range(3):
            step = {}
            if i == 2:
                name, expr, scope = DYNAMIC_CHANGE
                t0 = time.perf_counter()
                session.change_factor_function(name, constraint_from_str(
                    name, expr, [dcop.variables[v] for v in scope]
                ))
                step["change_s"] = time.perf_counter() - t0
            _zero_launches()
            engine = _engine_counts()
            t0 = time.perf_counter()
            step["result"] = session.run(30)
            step["run_s"] = time.perf_counter() - t0
            step["counts"] = {
                k: v - engine[k] for k, v in _engine_counts().items()
            }
            step["counts"].update(_launch_counts())
            step["graph_cache"] = len(
                session._graph_home.__dict__.get("_device_consts", {})
            )
            steps.append(step)
        session.close()
        runs[device] = steps
    out = {"phase": "dynamic_config4", "runs": []}
    for i, (card, cpu, pin) in enumerate(
        zip(runs["cuda"], runs["cpu"], DYNAMIC_JAX)
    ):
        res, counts = card["result"], card["counts"]
        check(res == cpu["result"],
              f"dynamic run {i}: card {res.cost} vs cpu "
              f"{cpu['result'].cost}")
        check(res.cycles == 30 * (i + 1) and res.violations == 0,
              f"dynamic run {i}: {res.cycles} cycles, {res.violations} "
              "violations")
        check(res.cost == pin,
              f"dynamic run {i}: cost {res.cost}, the JAX package {pin}")
        captured = counts["captures"]
        check(captured == (2 if i == 0 else 0),
              f"dynamic run {i}: {captured} captures")
        warm_up = 1 if captured else 0
        want = {
            "factor_arity2_minplus": counts["iterations"] + warm_up,
            "xla_tree_sum": 2 * (counts["iterations"] + warm_up)
            + 1 + warm_up,
            # both planes damped in the FMA form
            "damp_fma": 2 * (counts["iterations"] + warm_up),
        }
        got = {k: counts[k] for k in want}
        check(got == want, f"dynamic run {i}: launches {got}, want {want}")
        check(card["graph_cache"] == runs["cuda"][0]["graph_cache"],
              f"dynamic run {i}: the graph cache grew")
        out["runs"].append({
            "cost": res.cost, "jax_cost": pin, "cost_equal_jax": res.cost == pin,
            "cycle": res.cycles, "msg_count": res.msg_count,
            "card_run_s": card["run_s"], "cpu_run_s": cpu["run_s"],
            "change_s": card.get("change_s"), "counts": counts,
            "graph_cache": card["graph_cache"],
        })
    out.update(setup, same_as_cpu=True)
    emit(out)
    return out["runs"][1]["counts"]


def serve_requests(spec, run):
    """The SolveRequests of a serving cell: (tenant, variables, generator
    seed, solve seed) grid colorings, all under ``run`` (algo, params,
    n_cycles)."""
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_coloring_arrays,
    )
    from pydcop_tpu_torch.serve import SolveRequest

    algo, params, n_cycles = run
    return [
        SolveRequest(tenant, generate_coloring_arrays(
            n, 3, graph="grid", seed=gen_seed), algo, dict(params),
            n_cycles, seed)
        for tenant, n, gen_seed, seed in spec
    ]


def _zero_all_launches():
    """Every wrapper's launches and batched launches to 0."""
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    _zero_launches()
    for name in KERNEL_WRAPPERS:
        batched = getattr(getattr(hk, name), "batched", None)
        if batched is not None:
            batched.launches = 0


def _all_launch_counts():
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    out = _launch_counts()
    for name in KERNEL_WRAPPERS:
        batched = getattr(getattr(hk, name), "batched", None)
        if batched is not None:
            out[f"{name}_batched"] = batched.launches
    return out


def _counted(call):
    """``call()``'s result, its wall and its counts (engine counters and
    launches, from zero)."""
    import torch

    _zero_all_launches()
    engine = _engine_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v - engine[k] for k, v in _engine_counts().items()}
    counts.update(_all_launch_counts())
    return out, wall, counts


def _same_tenant(got, want, name, cost_rel=0.0):
    """Two TenantResults of one tenant: the same assignment, violations,
    cycles and messages, the cost equal (or within ``cost_rel``), and,
    when both have them, the same best cost and cycle of the best."""
    g, w = got.result, want.result
    check(g is not None and w is not None, f"{name}: no result")
    for key in ("assignment", "violations", "cycles", "msg_count",
                "status"):
        check(getattr(g, key) == getattr(w, key),
              f"{name}: {key} {getattr(g, key)!r} != {getattr(w, key)!r}")
    if cost_rel:
        check(abs(g.cost - w.cost) <= cost_rel * abs(w.cost),
              f"{name}: cost {g.cost} vs {w.cost}")
    else:
        check(g.cost == w.cost, f"{name}: cost {g.cost} != {w.cost}")
    for key in ("best_cost", "cycles_to_best"):
        if key in got.extras and key in want.extras and not cost_rel:
            check(got.extras[key] == want.extras[key],
                  f"{name}: {key} {got.extras[key]} != {want.extras[key]}")
    return g.cost == w.cost


def _median_walls(calls, reps=3):
    """Median wall of each call, the reps interleaved."""
    import torch

    walls = [[] for _ in calls]
    for _ in range(reps):
        for i, call in enumerate(calls):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls[i].append(time.perf_counter() - t0)
    return [statistics.median(w) for w in walls]


def _batch_device_ms(replays_per_group):
    """Device time of one warm batch of every vmap slot made so far: each
    slot's captured prologue graph and ``replays_per_group`` replays of
    its chunk graph, replayed between CUDA events (the graphs' own device
    time, no host work), median of five."""
    import torch

    from pydcop_tpu_torch.algorithms import base
    from pydcop_tpu_torch.serve import batch as sb

    graphs = [
        g for slot in sb._slots.values()
        for g in slot.home.__dict__.get("_device_consts", {}).values()
        if isinstance(g, base._Graphs)
    ]

    def replay():
        for g in graphs:
            g.prologue.replay()
            for _ in range(replays_per_group):
                g.chunk.replay()

    return _events_ms(replay, 5), len(graphs)


def serve_grid_operands(k=32, seed=0):
    """The batched kernels' operands at K instances of SERVE_GRID's bucket
    on the card: each tenant's bucket-padded problem and class-padded ELL
    layout (``serve.batch.build_instance``), random planes (zero on
    padding slots) and a random assignment.  Returns (ell_minplus args,
    tree_evaluate args, ell_fan_in args (spans, unary_t, f2v_t), the
    domain sum's [K, n_pad, D] view)."""
    import torch

    from pydcop_tpu_torch.serve import bucket_key
    from pydcop_tpu_torch.serve.batch import build_instance

    reqs = serve_requests(SERVE_GRID[:k], SERVE_GRID_RUN)
    key = bucket_key(reqs[0])
    insts = [build_instance(r, key.dims, "cpu") for r in reqs]

    def stack(xs):
        return torch.stack(list(xs)).to("cuda")

    g = torch.Generator(device="cuda").manual_seed(seed)
    consts = [i.host_plan.consts for i in insts]
    pair_perm, tabs_t, real_row = (stack(c[j] for c in consts)
                                   for j in (2, 3, 8))
    d, n_pad = tabs_t.shape[1], tabs_t.shape[-1]
    v2f = torch.randn((k, d, n_pad), generator=g, device="cuda") * real_row
    ell = [v2f, pair_perm, tabs_t, real_row]
    devs = [i.host_dev for i in insts]
    values = (torch.rand((k, key.dims.n_vars), generator=g, device="cuda")
              * stack(dv.domain_size for dv in devs)).to(torch.int32)
    evaluate = [stack(dv.unary for dv in devs), values,
                [(stack(dv.buckets[0].tables_flat for dv in devs),
                  stack(dv.buckets[0].var_slots for dv in devs))],
                stack(dv.constant_cost for dv in devs)]
    spans = key.extra[0]
    n_ell_vars = sum(nb for nb, _ in spans)
    fan_in = [spans,
              torch.rand((k, d, n_ell_vars), generator=g,
                         device="cuda") * 10,
              torch.randn((k, d, n_pad), generator=g, device="cuda")]
    rows = torch.randn((k, d, n_pad), generator=g,
                       device="cuda").movedim(1, -1)
    return ell, evaluate, fan_in, rows


def _instance(args, i):
    """Instance i of batch-first operands (lists element by element)."""
    import torch

    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a[i])
        elif isinstance(a, list) and a and isinstance(a[0], tuple):
            out.append([tuple(x[i] for x in b) for b in a])
        else:
            out.append(a)
    return out


def _batched_row(name, wrapper, replaces, batched, solo, plain, sets,
                 bytes_ops, library=None, plain_in_graph=True):
    """A batched kernel against its plain version instance by instance,
    exactly, on the first operand set; timed by CUDA-graph replay over
    the sets beside its plain version (instance by instance; between
    CUDA events when it cannot be captured), 32 solo launches and, where
    there is one, a library call; its bound is the K instances' bytes and
    operations."""
    import torch

    args = sets[0]
    k = args[1].shape[0] if isinstance(args[0], tuple) else (
        args[0].shape[0])
    got = batched(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    max_err = 0.0
    for i in range(k):
        want = plain(*_instance(args, i))
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            equal = torch.equal(g[i], w)
            err = float((g[i].float() - w.float()).abs().max())
            check(equal, f"{name}: instance {i} != its plain version: {err}")
            max_err = max(max_err, err)
    nbytes = ops = 0
    for i in range(k):
        b, o = bytes_ops(_instance(args, i))
        nbytes, ops = nbytes + b, ops + o

    def solo_all(*a):
        for i in range(k):
            solo(*_instance(a, i))

    def plain_all(*a):
        for i in range(k):
            plain(*_instance(a, i))

    kernel_ms = time_cuda_ms(batched, sets)
    plain_ms = time_cuda_ms(plain_all, sets, rounds=2) if plain_in_graph \
        else _events_ms(lambda: [plain_all(*a) for a in sets], 3) / len(sets)
    row = _kernel_row(
        name, wrapper, replaces, max_err, kernel_ms, plain_ms, nbytes, ops,
        library_ms=time_cuda_ms(library, sets) if library else None,
        k=k, solo_launches_ms=time_cuda_ms(solo_all, sets, rounds=2),
        launches_per_call=1,
    )
    emit({"phase": "kernel_row", **row})
    return row


def batched_kernel_rows():
    """The batched variants at K=32 on SERVE_GRID's bucket: each equal to
    its plain version instance by instance and timed (``_batched_row``);
    four operand sets of other random values.  Returns the rows and, by
    launch entry, the operand sets ``evaluate``'s batch was timed on
    (``phase_against``)."""
    import torch

    from pydcop_tpu_torch.compile import hopper_kernels as hk

    pallas = "pydcop_tpu/compile/pallas_kernels.py:167"
    own = "none: the port's own kernel (evaluate's totals in XLA-CPU's order)"
    sets = [serve_grid_operands(seed=s) for s in range(4)]
    ell_sets = [ops[0] for ops in sets]
    bf16_sets = [[a[0].to(torch.bfloat16)] + a[1:] for a in ell_sets]

    def fan_in_bytes(args):
        spans, u, f2v = args
        return fan_in_bytes_ops([f2v, u, spans])

    def rows_bytes(args):
        (x,) = args
        return x.numel() * 4 + x.shape[0] * 4, x.numel()

    rows = {}
    for name, s in (("ell_minplus_batched", ell_sets),
                    ("ell_minplus_bf16_batched", bf16_sets)):
        rows[name] = _batched_row(
            name, "ell_minplus", pallas, hk.ell_minplus_batched,
            hk.ell_minplus, hk.ell_minplus_plain, s, ell_minplus_bytes_ops)
    rows["xla_tree_sum_evaluate_batched"] = _batched_row(
        "xla_tree_sum_evaluate_batched", "xla_tree_sum", own,
        hk.tree_evaluate_batched, hk.tree_evaluate, hk.tree_evaluate_plain,
        [ops[1] for ops in sets], evaluate_bytes_ops)
    rows["xla_tree_sum_fan_in_batched"] = _batched_row(
        "xla_tree_sum_fan_in_batched", "xla_tree_sum", own,
        lambda spans, u, f: hk.ell_fan_in_batched(spans, u, f),
        hk.ell_fan_in, hk.ell_fan_in_plain,
        [ops[2] for ops in sets], fan_in_bytes)
    rows["xla_tree_sum_rows_batched"] = _batched_row(
        "xla_tree_sum_rows_batched", "xla_tree_sum", own,
        hk.xla_tree_sum_batched, hk.xla_tree_sum, hk.xla_tree_sum_plain,
        [[ops[3]] for ops in sets], rows_bytes,
        library=lambda x: torch.sum(x, -1))
    # damp_fma at K=32 of the bucket's [D, n_pad] planes: one launch
    kernel, plain, plain_form, _ = _damp_calls(
        CONFIG_4["params"]["damping"])
    rows["damp_fma_batched"] = _batched_row(
        "damp_fma_batched", "damp_fma", DAMP_REPLACES,
        torch.func.vmap(kernel), kernel, plain,
        [[ops[0][0], torch.randn_like(ops[0][0])] for ops in sets],
        damp_bytes_ops, library=plain_form, plain_in_graph=False)
    return rows, {"xla_tree_sum_evaluate_batched": [ops[1] for ops in sets]}


def phase_serve_config8():
    """Bench config 8 on the card: 32 tenants, two buckets, DSA, in both
    modes, cold then warm.  vmap: every tenant equals its card
    ``solve_one`` and the CPU's, a warm batch captures nothing, and each
    bucket's warm batch launches what one warm solo solve of the bucket
    launches (not 24 or 8 times it).  fused: every tenant equals the
    CPU's fused result, and the summed cost and violations are the JAX
    package's.  Warm walls of both modes beside the strict loop
    (``solve_one`` a tenant) and the API loop (``dsa.solve`` a tenant),
    host syncs a batch and the device's busy share of the vmap batch."""
    from pydcop_tpu_torch.algorithms import dsa
    from pydcop_tpu_torch.serve import bucket_key, solve_batched, solve_one

    reqs = serve_requests(SERVE_CONFIG8, SERVE_CONFIG8_RUN)
    groups = {}
    for r in reqs:
        groups.setdefault(bucket_key(r), []).append(r)
    check(len(groups) == 2, f"config 8: {len(groups)} buckets, not 2")
    degraded = solve_batched.degraded
    runs, walls, counts = {}, {}, {}
    for mode in ("fused", "vmap"):
        for temp in ("cold", "warm"):
            runs[mode, temp], walls[f"{mode}_{temp}_s"], counts[
                f"{mode}_{temp}"] = _counted(
                lambda: solve_batched(reqs, mode=mode, device="cuda"))
    for mode in ("fused", "vmap"):
        check(counts[f"{mode}_warm"]["captures"] == 0,
              f"config 8 {mode}: a warm batch captured "
              f"{counts[f'{mode}_warm']['captures']} graphs")
    check(solve_batched.degraded == degraded,
          "config 8: a batch degraded to solo solves")
    cpu = {mode: solve_batched(reqs, mode=mode, device="cpu")
           for mode in ("vmap", "fused")}
    for r in reqs:
        one = solve_one(r, device="cuda")
        for temp in ("cold", "warm"):
            _same_tenant(runs["vmap", temp][r.tenant], one,
                         f"config 8 vmap {temp} {r.tenant} vs solve_one")
        _same_tenant(cpu["vmap"][r.tenant], one,
                     f"config 8 {r.tenant}: card solve_one vs the CPU batch")
        _same_tenant(runs["fused", "warm"][r.tenant], cpu["fused"][r.tenant],
                     f"config 8 fused {r.tenant} vs the CPU")
    fused = runs["fused", "warm"]
    total = (sum(fused[r.tenant].result.cost for r in reqs),
             sum(fused[r.tenant].result.violations for r in reqs))
    check(total == SERVE_CONFIG8_JAX_FUSED,
          f"config 8 fused: {total}, the JAX package "
          f"{SERVE_CONFIG8_JAX_FUSED}")
    # a warm batch launches what one warm solo solve launches, bucket by
    # bucket
    per_bucket = {}
    for key, group in groups.items():
        solve_batched(group, device="cuda")
        _, _, batch = _counted(lambda: solve_batched(group, device="cuda"))
        solve_one(group[0], device="cuda")
        _, _, solo = _counted(lambda: solve_one(group[0], device="cuda"))
        name = f"v{key.dims.n_vars}"
        per_bucket[name] = {"tenants": len(group), "batch": batch,
                            "solo": solo}
        check(batch["xla_tree_sum"] == solo["xla_tree_sum"]
              == batch["xla_tree_sum_batched"] > 0
              and batch["iterations"] == solo["iterations"],
              f"config 8 bucket {name}: batch launches {batch}, solo "
              f"{solo}")
    strict, api, fused_wall, vmap_wall = _median_walls([
        lambda: [solve_one(r, device="cuda") for r in reqs],
        lambda: [dsa.solve(r.compiled, r.params, n_cycles=r.n_cycles,
                           seed=r.seed, device="cuda") for r in reqs],
        lambda: solve_batched(reqs, mode="fused", device="cuda"),
        lambda: solve_batched(reqs, mode="vmap", device="cuda"),
    ])
    warm = counts["vmap_warm"]
    stages = {
        f"v{key.dims.n_vars}": {
            k: runs["vmap", "warm"][group[0].tenant].extras[k]
            for k in ("assemble_s", "solve_s")
        }
        for key, group in groups.items()
    }
    busy_ms, n_graphs = _batch_device_ms(warm["replays"] // len(groups))
    emit({
        "phase": "serve_config8", "tenants": len(reqs),
        "buckets": len(groups), **walls, "counts": counts,
        "per_bucket": per_bucket, "vmap_warm_stages_s": stages,
        "fused_cost": total[0], "fused_violations": total[1],
        "jax_fused": list(SERVE_CONFIG8_JAX_FUSED),
        "warm_wall_s": {"fused": fused_wall, "vmap": vmap_wall,
                        "strict_loop": strict, "api_loop": api},
        "solves_per_s": {"fused": len(reqs) / fused_wall,
                         "vmap": len(reqs) / vmap_wall,
                         "strict_loop": len(reqs) / strict},
        "host_syncs_per_batch": warm["host_syncs"] / len(groups),
        "vmap_device_busy_ms": busy_ms, "vmap_graphs": n_graphs,
        "vmap_device_busy_share": busy_ms / 1e3 / vmap_wall,
        "vmap_device_idle_share": 1 - busy_ms / 1e3 / vmap_wall,
        "same_as_solve_one": True, "fused_same_as_cpu": True,
    })
    return counts["vmap_warm"]


def phase_serve_maxsum_grid():
    """32 MaxSum tenants of a 32x32 grid coloring as one batch on the card,
    cold then warm: every tenant equals its card ``solve_one`` exactly
    and meets MaxSum's CPU bar against the CPU batch; a warm batch
    captures nothing and launches ``ell_minplus`` once an iteration
    replayed for all 32 tenants (and ``xla_tree_sum`` three times an
    iteration and once in the prologue).  Then 8 tenants with bf16
    planes, likewise.  The warm batch's wall beside the strict loop."""
    from pydcop_tpu_torch.serve import solve_batched, solve_one

    out = {"phase": "serve_maxsum_grid"}
    launches = {}
    for name, spec, run in (("f32", SERVE_GRID, SERVE_GRID_RUN),
                            ("bf16", SERVE_GRID[:8], SERVE_GRID_BF16_RUN)):
        reqs = serve_requests(spec, run)
        cold, cold_s, cold_counts = _counted(
            lambda: solve_batched(reqs, device="cuda"))
        warm, warm_s, counts = _counted(
            lambda: solve_batched(reqs, device="cuda"))
        check(counts["captures"] == 0,
              f"serve grid {name}: a warm batch captured "
              f"{counts['captures']}")
        its = counts["iterations"]
        check(counts["ell_minplus"] == counts["ell_minplus_batched"] == its
              > 0, f"serve grid {name}: {counts['ell_minplus']} ell_minplus "
              f"launches for {its} iterations")
        check(counts["xla_tree_sum"] == counts["xla_tree_sum_batched"]
              == 3 * its + 1,
              f"serve grid {name}: {counts['xla_tree_sum']} xla_tree_sum "
              f"launches for {its} iterations")
        # float32 planes: both damped by one batched damp_fma launch
        damps = 2 * its if name == "f32" else 0
        check(counts["damp_fma"] == counts["damp_fma_batched"] == damps,
              f"serve grid {name}: {counts['damp_fma']} damp_fma launches "
              f"for {its} iterations")
        cpu = solve_batched(reqs, device="cpu")
        bit_equal = 0
        for r in reqs:
            one = solve_one(r, device="cuda")
            _same_tenant(cold[r.tenant], one, f"grid {name} cold {r.tenant}")
            _same_tenant(warm[r.tenant], one, f"grid {name} warm {r.tenant}")
            bit_equal += _same_tenant(warm[r.tenant], cpu[r.tenant],
                                      f"grid {name} {r.tenant} vs the CPU",
                                      cost_rel=1e-5)
        batch_s, strict_s = _median_walls([
            lambda: solve_batched(reqs, device="cuda"),
            lambda: [solve_one(r, device="cuda") for r in reqs],
        ])
        first = warm[reqs[0].tenant].extras
        out[name] = {
            "tenants": len(reqs), "cold_s": cold_s, "warm_s": warm_s,
            # the warm batch's host stages: stacking and upload, the
            # solve (replays and read-back); the rest is the decode
            "assemble_s": first["assemble_s"], "solve_s": first["solve_s"],
            "cold_counts": cold_counts, "counts": counts,
            "warm_batch_s": batch_s, "strict_loop_s": strict_s,
            "speedup": strict_s / batch_s,
            "cost_bit_equal_to_cpu": bit_equal,
            "costs": [warm[r.tenant].result.cost for r in reqs[:4]],
        }
        launches[name] = counts
    emit(out)
    return launches


def phase_serve_server():
    """``ServeServer`` on config 8's requests, in both modes: all 32
    tenants done, none failed, no batch degraded, a clean drain; its queue
    latency p50 and p99.  Then its HTTP front on a free port: a POSTed
    YAML problem of ``tests/instances/`` gives the card's
    ``solve_result``."""
    import urllib.request

    from pydcop_tpu_torch.api import solve_result
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file
    from pydcop_tpu_torch.serve import ServeServer

    out = {"phase": "serve_server"}
    for mode in ("vmap", "fused"):
        reqs = serve_requests(SERVE_CONFIG8, SERVE_CONFIG8_RUN)
        srv = ServeServer(port=None, window_ms=10, max_batch=32, mode=mode)
        t0 = time.perf_counter()
        ids = [srv.submit(r) for r in reqs]
        rows = [srv.wait(t, timeout=300) for t in ids]
        wall = time.perf_counter() - t0
        drained = srv.drain(timeout=120)
        st = srv.status()
        states = [r["status"] for r in rows]
        check(states == ["done"] * len(reqs) and drained
              and st["dead_letters"] == 0 and st["degraded"] == 0,
              f"serve_server {mode}: {st}")
        out[mode] = {"wall_s": wall, "batches": st["batches"],
                     "queue_ms": st["queue_ms"],
                     "tenant_counts": st["tenant_counts"],
                     "drained": drained}
    path = ROOT / FRONT_DOOR_YAML[0]
    srv = ServeServer(port=0, window_ms=5)
    try:
        base = f"http://127.0.0.1:{srv.http.port}"
        body = json.dumps({"dcop_yaml": path.read_text(), "algo": "dsa",
                           "n_cycles": 30, "seed": 3,
                           "tenant": "http"}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                base + "/solve", data=body, method="POST")) as resp:
            doc = json.loads(resp.read())
            check(doc["tenant"] == "http" and len(doc["trace"]) == 16,
                  f"POST /solve: {doc}")
        srv.wait("http", timeout=120)
        with urllib.request.urlopen(base + "/result/http") as resp:
            row = json.loads(resp.read())
    finally:
        srv.shutdown()
    want = solve_result(load_dcop_from_file([str(path)]), "dsa",
                        n_cycles=30, seed=3, device="cuda")
    got = (row["status"], row["cost"], row["violations"], row["cycles"],
           row["assignment"])
    check(got == ("done", want["cost"], want["violation"], want["cycle"],
                  want["assignment"]),
          f"POST /solve: {got} vs solve_result {want}")
    out["http"] = {"port": "ephemeral", "cost": row["cost"],
                   "equal_to_solve_result": True}
    emit(out)


def _with_extras(mod, call):
    """``call()`` (a solve of ``mod``) and the extras of the
    ``run_cycles`` call inside it."""
    seen = {}
    orig = mod.run_cycles

    def spy(*a, **k):
        out = orig(*a, **k)
        seen["extras"] = out[2]
        return out

    mod.run_cycles = spy
    try:
        return call(), seen["extras"]
    finally:
        mod.run_cycles = orig


def _cycle_graphs(compiled):
    """The cached ``_Graphs`` of a problem by cache key."""
    return {
        k: v for k, v in compiled.__dict__.get("_device_consts", {}).items()
        if k[0] == "cycle_graphs"
    }


def _device_events(solve) -> int:
    """The device events (kernels and copies) of one solve, as
    ``torch.profiler`` sees them."""
    import torch

    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        solve()
    return sum(
        e.device_type == torch.autograd.DeviceType.CUDA
        for e in prof.events()
    )


def _timed_manager(directory, **kw):
    """A checkpoint manager that keeps each write's seconds in
    ``save_s``."""
    from pydcop_tpu_torch.durability import CheckpointManager

    class Timed(CheckpointManager):
        def save_carry(self, *a, **k):
            t0 = time.perf_counter()
            path = super().save_carry(*a, **k)
            self.save_s.append(time.perf_counter() - t0)
            return path

    mgr = Timed(directory, **kw)
    mgr.save_s = []
    return mgr


def phase_pulse_config4(c4):
    """Health telemetry at config 4 (``pulse_config4``): MaxSum on ``ell``
    and DSA, 30 cycles, with pulse on and off, warm.  The health rows are
    the CPU port's bit for bit and the JAX package's pinned rows; the
    result is the pulse-off result; the host syncs are equal and the warm
    pulse-on solve captures nothing.  Reports kernels and µs an iteration
    with pulse on and off (the price of health) and the diagnosis."""
    import hashlib

    import numpy as np

    from pydcop_tpu_torch.algorithms import dsa, maxsum
    from pydcop_tpu_torch.compile import hopper_kernels as hk
    from pydcop_tpu_torch.telemetry.pulse import HEALTH_WIDTH, pulse
    from pydcop_tpu_torch.tools.profile_solve import _graph_ms

    runs = {
        "maxsum": (maxsum, dict(CONFIG_4["params"], layout="ell")),
        "dsa": (dsa, {}),
    }
    for name, (mod, params) in runs.items():
        def solve(device, on, mod=mod, params=params):
            pulse.reset()
            pulse.enabled = on
            try:
                return _with_extras(mod, lambda: mod.solve(
                    c4, dict(params), n_cycles=CONFIG_4["n_cycles"],
                    seed=CONFIG_4["seed"], device=device,
                ))
            finally:
                pulse.enabled = False

        out = {"phase": "pulse_config4", "algo": name, "params": params}
        before = set(_cycle_graphs(c4))
        for on in (False, True):
            tag = "on" if on else "off"
            solve("cuda", on)  # cold (off: warm already from its phase)
            walls, counts = [], None
            for _ in range(3):
                hk.xla_tree_sum.launches = 0
                engine = _engine_counts()
                t0 = time.perf_counter()
                (res, extras) = solve("cuda", on)
                walls.append(time.perf_counter() - t0)
                counts = {k: v - engine[k]
                          for k, v in _engine_counts().items()}
                counts["xla_tree_sum"] = hk.xla_tree_sum.launches
            out[f"warm_s_{tag}"] = statistics.median(walls)
            out[f"warm_counts_{tag}"] = counts
            out[f"kernels_per_iteration_{tag}"] = _device_events(
                lambda: solve("cuda", on)
            ) / counts["iterations"]
            if on:
                card, card_extras = res, extras
            else:
                off = res
        check(out["warm_counts_on"]["captures"] == 0,
              f"pulse_config4 {name}: the warm pulse-on solve captured")
        check(out["warm_counts_on"]["host_syncs"]
              == out["warm_counts_off"]["host_syncs"],
              f"pulse_config4 {name}: host syncs on "
              f"{out['warm_counts_on']['host_syncs']}, off "
              f"{out['warm_counts_off']['host_syncs']}")
        check((card.assignment, card.cost, card.cycles)
              == (off.assignment, off.cost, off.cycles),
              f"pulse_config4 {name}: pulse changed the result")
        # xla_tree_sum: DSA's mean gain is one more sum an iteration
        extra = 1 if name == "dsa" else 0
        iters = out["warm_counts_on"]["iterations"]
        check(out["warm_counts_on"]["xla_tree_sum"]
              == out["warm_counts_off"]["xla_tree_sum"] + extra * iters,
              f"pulse_config4 {name}: xla_tree_sum launches "
              f"{out['warm_counts_on']['xla_tree_sum']}")
        rows = card_extras["pulse"]["health"]
        check(rows.shape == (card.cycles, HEALTH_WIDTH),
              f"pulse_config4 {name}: rows {rows.shape}")
        cpu, cpu_extras = solve("cpu", True)
        check(np.array_equal(rows.view(np.uint32),
                             cpu_extras["pulse"]["health"].view(np.uint32)),
              f"pulse_config4 {name}: card rows differ from the CPU's")
        check(np.array_equal(card_extras["pulse"]["flip_count"],
                             cpu_extras["pulse"]["flip_count"]),
              f"pulse_config4 {name}: flip counters differ from the CPU's")
        pin = PULSE_JAX[name]
        check(card.cost == pin["cost"],
              f"pulse_config4 {name}: cost {card.cost}")
        if "rows_sha256" in pin:
            check(hashlib.sha256(rows.tobytes()).hexdigest()
                  == pin["rows_sha256"],
                  f"pulse_config4 {name}: rows are not JAX's")
        else:
            exact = np.ascontiguousarray(rows[:, PULSE_EXACT_FIELDS])
            check(hashlib.sha256(exact.tobytes()).hexdigest()
                  == pin["exact_sha256"],
                  f"pulse_config4 {name}: exact fields are not JAX's")
            planes = np.frombuffer(bytes.fromhex(pin["planes_hex"]),
                                   dtype=np.float32).reshape(-1, 2)
            got = np.ascontiguousarray(rows[:, 5:7])
            err = float(np.abs(got - planes).max())
            check(np.array_equal(got.view(np.uint32),
                                 planes.view(np.uint32)),
                  f"pulse_config4 {name}: residual/aux off JAX's by {err}")
            out["plane_fields_max_abs_err_vs_jax"] = err
        # the chunk graph, with and without the hook: µs an iteration
        after = _cycle_graphs(c4)
        on_keys = [k for k in set(after) - before
                   if k[1].health is not None]
        check(len(on_keys) == 1,
              f"pulse_config4 {name}: {len(on_keys)} pulse graphs")
        on_key = on_keys[0]
        off_key = ("cycle_graphs", dataclasses.replace(on_key[1],
                                                       health=None),
                   on_key[2])
        length = on_key[1].length
        for tag, key in (("on", on_key), ("off", off_key)):
            out[f"us_per_iteration_{tag}"] = (
                1e3 * _graph_ms(after[key].chunk) / length
            )
        out.update(
            diagnosis=card_extras["pulse"]["report"]["diagnosis"],
            cost=card.cost, cycles=card.cycles, rows_equal_cpu=True,
            rows_match_jax=True,
        )
        emit(out)


def phase_durable_config4(c4):
    """Durable solves at config 4 (``durable_config4``): DSA, MGM-2 and
    MaxSum ``ell`` with noise, a snapshot every 10 of 30 cycles.  Every
    resume from a snapshot gives the uninterrupted result (assignment,
    cost, cycles, ``cycles_to_best``) bit for bit; a snapshot written on
    the card resumes on the CPU and one written on the CPU on the card,
    with the same result; warm, nothing is captured.  Reports the save
    seconds, the bytes a snapshot and the host syncs of a checkpointed
    solve."""
    import os
    import tempfile

    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.durability import CheckpointManager, durability

    for algo, params in DURABLE_RUNS:
        mod = load_algorithm_module(algo)

        def solve(device, manager=None, resume=None):
            durability.configure(manager=manager, resume=resume)
            try:
                return _with_extras(mod, lambda: mod.solve(
                    c4, dict(params), n_cycles=30, seed=CONFIG_4["seed"],
                    device=device,
                ))
            finally:
                durability.reset()

        def key(pair):
            res, extras = pair
            return (res.assignment, res.cost, res.cycles,
                    extras["cycles_to_best"])

        with tempfile.TemporaryDirectory() as tmp:
            solve("cuda")
            t0 = time.perf_counter()
            want = solve("cuda")
            warm_s = time.perf_counter() - t0
            mgr = _timed_manager(os.path.join(tmp, "card"),
                                 every_cycles=10, keep=3)
            engine = _engine_counts()
            t0 = time.perf_counter()
            got = solve("cuda", manager=mgr)
            ck_s = time.perf_counter() - t0
            counts = {k: v - engine[k] for k, v in _engine_counts().items()}
            check(key(got) == key(want),
                  f"durable_config4 {algo}: the checkpointed solve differs")
            check(counts["captures"] == 0,
                  f"durable_config4 {algo}: the checkpointed solve captured")
            check(len(mgr.saved_paths) == 3,
                  f"durable_config4 {algo}: {len(mgr.saved_paths)} snapshots")
            resumed = {}
            for path in mgr.saved_paths[:2]:
                engine = _engine_counts()
                t0 = time.perf_counter()
                r = solve("cuda", resume=path)
                resumed[os.path.basename(path)] = time.perf_counter() - t0
                check(_engine_counts()["captures"] == engine["captures"],
                      f"durable_config4 {algo}: the resume captured")
                check(key(r) == key(want),
                      f"durable_config4 {algo}: resume from {path} differs")
            # across devices: the card's snapshot on the CPU, and the
            # CPU's on the card
            check(key(solve("cpu", resume=mgr.saved_paths[1])) == key(want),
                  f"durable_config4 {algo}: card snapshot on the CPU")
            cpu_mgr = CheckpointManager(os.path.join(tmp, "cpu"),
                                        every_cycles=10, keep=3)
            cpu = solve("cpu", manager=cpu_mgr)
            check(key(cpu) == key(want),
                  f"durable_config4 {algo}: the CPU's checkpointed solve")
            check(key(solve("cuda", resume=cpu_mgr.saved_paths[0]))
                  == key(want),
                  f"durable_config4 {algo}: CPU snapshot on the card")
            emit({
                "phase": "durable_config4", "algo": algo, "params": params,
                "cost": want[0].cost, "cycles": want[0].cycles,
                "warm_s": warm_s, "checkpointed_s": ck_s,
                "save_s": mgr.save_s,
                "snapshot_bytes": [os.path.getsize(p)
                                   for p in mgr.saved_paths],
                "checkpointed_counts": counts,
                "resume_s": resumed, "resumes_equal": True,
                "card_to_cpu": True, "cpu_to_card": True,
            })


def phase_durable_config6(c6, ref):
    """A durable solve at config 6 (``durable_config6``): MaxSum ``ell``
    at 1,000,000 variables, 30 cycles, a snapshot every 10.  The
    checkpointed solve gives the uninterrupted ``ref``, and the run
    resumed from cycle 10 gives the JAX package's pinned cost, cold (its
    graphs captured anew, as a new process would) and warm.  Reports the
    snapshot bytes (and the bytes the carry's leaves predict from the ELL
    layout's ``n_pad``), the save seconds and the resume walls."""
    import os
    import tempfile

    from pydcop_tpu_torch.algorithms import base, maxsum
    from pydcop_tpu_torch.durability import durability

    params = dict(CONFIG_6["params"], layout="ell")
    ell = c6.__dict__["_device_consts"][("ell_host",)]
    n, d, n_pad = c6.n_vars, c6.max_domain, ell.n_pad
    # the leaves: two [D, n_pad] planes, act_v and act_f [n_pad] int32,
    # the permuted unary [D, n_vars], values, best values and the
    # scalars
    predicted = 4 * (2 * d * n_pad + 2 * n_pad + d * n + 2 * n + 5)

    def solve(manager=None, resume=None):
        durability.configure(manager=manager, resume=resume)
        t0 = time.perf_counter()
        try:
            res = maxsum.solve(c6, dict(params), n_cycles=30,
                               seed=CONFIG_6["seed"], device="cuda")
        finally:
            durability.reset()
        return res, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        mgr = _timed_manager(tmp, every_cycles=10, keep=3)
        engine = _engine_counts()
        got, ck_s = solve(manager=mgr)
        counts = {k: v - engine[k] for k, v in _engine_counts().items()}
        check((got.assignment, got.cost, got.cycles)
              == (ref.assignment, ref.cost, ref.cycles),
              "durable_config6: the checkpointed solve differs")
        _, warm_s = solve()
        first = mgr.saved_paths[0]
        # a cold resume: the graphs captured anew, as in a new process
        for k in list(_cycle_graphs(c6)):
            del c6.__dict__["_device_consts"][k]
        walls = {}
        for tag in ("cold", "warm"):
            captures = base.run_cycles.captures
            res, walls[tag] = solve(resume=first)
            check(base.run_cycles.captures - captures
                  == (2 if tag == "cold" else 0),
                  f"durable_config6: {tag} resume captured "
                  f"{base.run_cycles.captures - captures}")
            check((res.cost, res.violations, res.cycles)
                  == MAXSUM_CONFIG6_JAX,
                  f"durable_config6: {tag} resume gave "
                  f"{(res.cost, res.violations, res.cycles)}")
            check(res.assignment == ref.assignment,
                  f"durable_config6: {tag} resume's assignment")
        sizes = [os.path.getsize(p) for p in mgr.saved_paths]
        emit({
            "phase": "durable_config6", "n_vars": n, "n_pad": n_pad,
            "cost": got.cost, "warm_s": warm_s, "checkpointed_s": ck_s,
            "checkpointed_counts": counts, "save_s": mgr.save_s,
            "snapshot_bytes": sizes, "predicted_leaf_bytes": predicted,
            "snapshot_share_of_checkpointed_wall": sum(mgr.save_s) / ck_s,
            "resume_cold_s": walls["cold"], "resume_warm_s": walls["warm"],
            "resumed_cost_is_jax": True,
        })


def phase_kill_resume_cli():
    """A crash through the CLI (``kill_resume_cli``): ``python -m
    pydcop_tpu_torch solve -a dsa --checkpoint DIR --checkpoint-every 8``
    on a generated coloring, SIGKILLed once its first manifest appears,
    then ``solve --resume DIR``, whose JSON must be the uninterrupted
    run's (``time`` aside); the ``checkpoints`` verb lists DIR; a pulse
    solve whose ``--timeout`` runs out dumps the flight recorder, which
    the ``postmortem`` verb renders as the library does."""
    import signal
    import tempfile

    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.api import solve_result
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop_from_file
    from pydcop_tpu_torch.telemetry.pulse import (
        load_postmortem,
        pulse,
        render_postmortem,
    )

    cli = PORT_CLI
    args = ["solve", "-a", "dsa", "-n", str(KILL_CYCLES), "--seed", "3"]
    out = {"phase": "kill_resume_cli", "n_cycles": KILL_CYCLES}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        n, d, kw = KILL_PROBLEM
        path = tmp / "coloring.yaml"
        path.write_text(dcop_yaml(generate_graph_coloring(n, d, **kw)))
        dcop = load_dcop_from_file(str(path))
        algo = AlgorithmDef.build_with_default_param(
            "dsa", {}, mode=dcop.objective
        )
        want = json.loads(json.dumps(solve_result(
            dcop, algo, distribution="oneagent", n_cycles=KILL_CYCLES,
            seed=3, device="cuda",
        ), default=str))
        want.pop("time")
        ck = tmp / "ck"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [*cli, *args, "--checkpoint", str(ck), "--checkpoint-every",
             "8", str(path)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        try:
            while not list(ck.glob("ckpt-c*.json")):
                if proc.poll() is not None:
                    check(False, "kill_resume_cli: the solve ended before "
                          f"its first checkpoint: "
                          f"{proc.stderr.read()[-2000:]}")
                check(time.perf_counter() - t0 < 300,
                      "kill_resume_cli: no checkpoint in 300 s")
                time.sleep(0.02)
            out["first_manifest_s"] = time.perf_counter() - t0
            proc.send_signal(signal.SIGKILL)
            stdout, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=60)
        check(proc.returncode == -signal.SIGKILL and not stdout,
              f"kill_resume_cli: the killed solve exited {proc.returncode}")
        listed = subprocess.run(
            [*cli, "checkpoints", "list", str(ck)], cwd=ROOT,
            capture_output=True, text=True, timeout=300,
        )
        check(listed.returncode == 0 and "checkpoint(s)" in listed.stdout,
              f"kill_resume_cli: checkpoints list: {listed.stderr[-2000:]}")
        out["listed"] = listed.stdout.strip().splitlines()[-1]
        t0 = time.perf_counter()
        resumed = subprocess.run(
            [*cli, *args, "--resume", str(ck), str(path)], cwd=ROOT,
            capture_output=True, text=True, timeout=600,
        )
        out["resume_s"] = time.perf_counter() - t0
        check(resumed.returncode == 0,
              f"kill_resume_cli: the resume exited {resumed.returncode}: "
              f"{resumed.stderr[-2000:]}")
        got = json.loads(resumed.stdout)
        got.pop("time")
        check(got == want, "kill_resume_cli: the resumed JSON differs from "
              "the uninterrupted run's")
        # the flight recorder: a pulse solve that runs out of time
        pulse.reset()
        pulse.enabled = True
        pulse.postmortem_path = str(tmp / "postmortem.json")
        try:
            timed = solve_result(dcop, algo, n_cycles=10 ** 7, seed=3,
                                 timeout=0.5, device="cuda")
        finally:
            pulse.enabled = False
            pulse.postmortem_path = "postmortem.json"
        check(timed["status"] == "TIMEOUT",
              f"kill_resume_cli: the timed solve {timed['status']}")
        doc = load_postmortem(str(tmp / "postmortem.json"))
        rendered = subprocess.run(
            [*cli, "postmortem", str(tmp / "postmortem.json")], cwd=ROOT,
            capture_output=True, text=True, timeout=300,
        )
        check(rendered.returncode == 0
              and rendered.stdout == render_postmortem(doc) + "\n",
              f"kill_resume_cli: postmortem: {rendered.stderr[-2000:]}")
        out.update(
            resumed_equals_uninterrupted=True, cost=got["cost"],
            postmortem_reason=doc["reason"],
            postmortem_rows=len(doc["rows"]),
            postmortem_diagnosis=doc["diagnosis"]["diagnosis_full"],
        )
    emit(out)


def _slot_graph_us(reqs, health: bool):
    """µs an iteration of each bucket's warm chunk graph of ``reqs``'s
    vmap slots, with or without the health hook, by bucket label."""
    from pydcop_tpu_torch.algorithms import base
    from pydcop_tpu_torch.serve import batch as sb
    from pydcop_tpu_torch.serve import bucket_key
    from pydcop_tpu_torch.tools.profile_solve import _graph_ms

    keys = {bucket_key(r) for r in reqs}
    out = {}
    for (key, k_pad, device), slot in sb._slots.items():
        if key not in keys or device != "cuda":
            continue
        for g in slot.home.__dict__.get("_device_consts", {}).values():
            if isinstance(g, base._Graphs) and (
                    g.solver.health is not None) == health:
                out[f"v{key.dims.n_vars}_k{k_pad}"] = (
                    1e3 * _graph_ms(g.chunk) / g.solver.length)
    return out


def phase_serve_pulse():
    """Serving with pulse on (``serve_pulse``): bench config 8's 32 DSA
    tenants and 32 MaxSum grid tenants at damping 0.7, warm batches with
    pulse off and on.  With pulse on each vmap tenant carries its health
    rows and flip counters, the CPU batch's bit for bit; a warm batch
    captures nothing and makes as many host syncs as with pulse off; the
    results are the pulse-off ones.  Launches, µs a bucket iteration (its
    chunk graph) and walls, on and off.  Returns the pulse-on launches."""
    import numpy as np

    from pydcop_tpu_torch.serve import solve_batched
    from pydcop_tpu_torch.telemetry.pulse import HEALTH_WIDTH, pulse

    out = {"phase": "serve_pulse"}
    launches = {}
    cells = {"config8": (SERVE_CONFIG8, SERVE_CONFIG8_RUN),
             "maxsum_grid": (SERVE_GRID, SERVE_PULSE_GRID_RUN)}
    for name, (spec, run) in cells.items():
        reqs = serve_requests(spec, run)
        runs = {}
        try:
            for tag in ("off", "on"):
                pulse.reset()
                pulse.enabled = tag == "on"
                solve_batched(reqs, device="cuda")  # cold where new
                runs[tag] = _counted(
                    lambda: solve_batched(reqs, device="cuda"))
            # pulse is on here
            cpu = solve_batched(reqs[:SERVE_PULSE_CPU], device="cpu")
            walls = {"on": _median_walls([
                lambda: solve_batched(reqs, device="cuda")])[0]}
            pulse.enabled = False
            walls["off"] = _median_walls([
                lambda: solve_batched(reqs, device="cuda")])[0]
        finally:
            pulse.enabled = False
        (off, _, c_off), (on, _, c_on) = runs["off"], runs["on"]
        check(c_on["captures"] == 0,
              f"serve_pulse {name}: a warm pulse-on batch captured")
        check(c_on["host_syncs"] == c_off["host_syncs"],
              f"serve_pulse {name}: host syncs on {c_on['host_syncs']}, "
              f"off {c_off['host_syncs']}")
        for r in reqs:
            got, was = on[r.tenant], off[r.tenant]
            check((got.result.assignment, got.result.cost)
                  == (was.result.assignment, was.result.cost),
                  f"serve_pulse {name} {r.tenant}: pulse changed the result")
            rows = got.extras["pulse"]["health"]
            check(rows.shape == (got.result.cycles, HEALTH_WIDTH)
                  and "pulse" not in was.extras,
                  f"serve_pulse {name} {r.tenant}: rows {rows.shape}")
        for r in reqs[:SERVE_PULSE_CPU]:
            got, want = on[r.tenant].extras["pulse"], cpu[
                r.tenant].extras["pulse"]
            check(np.array_equal(got["health"].view(np.uint32),
                                 want["health"].view(np.uint32))
                  and np.array_equal(got["flip_count"], want["flip_count"]),
                  f"serve_pulse {name} {r.tenant}: rows are not the CPU's")
        launches[name] = c_on
        out[name] = {
            "tenants": len(reqs), "counts_off": c_off, "counts_on": c_on,
            "host_syncs_per_batch": c_on["host_syncs"],
            "us_per_bucket_iteration_off": _slot_graph_us(reqs, False),
            "us_per_bucket_iteration_on": _slot_graph_us(reqs, True),
            "warm_batch_s_off": walls["off"],
            "warm_batch_s_on": walls["on"],
            "rows_equal_cpu": SERVE_PULSE_CPU,
            "diagnosis": analyze_first(on[reqs[0].tenant]),
        }
    its = launches["maxsum_grid"]["iterations"]
    check(launches["maxsum_grid"]["damp_fma"]
          == launches["maxsum_grid"]["damp_fma_batched"] == 2 * its > 0,
          f"serve_pulse: {launches['maxsum_grid']['damp_fma']} damp_fma "
          f"launches for {its} batch iterations")
    emit(out)
    return launches


def _fresh(compiled):
    """A copy of ``compiled`` without its device caches: a solve of it
    uploads, builds and captures anew, as the first solve of a problem
    does."""
    import copy

    out = copy.copy(compiled)
    out.__dict__.pop("_device_consts", None)
    return out


def _peak_rise(solve):
    """``solve()``'s result, its rise in allocated device memory (the
    peak over the solve, ``max_memory_allocated`` after
    ``reset_peak_memory_stats``, less what was allocated before it) and
    the same of the caching allocator's reserved memory."""
    import torch

    from pydcop_tpu_torch.telemetry.memplane import measured_peak_bytes

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    out = solve()
    torch.cuda.synchronize()
    return (out, measured_peak_bytes() - before,
            torch.cuda.max_memory_reserved() - reserved)


def _device_table_row():
    """The model's device table held to what the card reports: its total
    memory against the row's capacity, and, where torch reports the
    memory clock and bus width, the bandwidth they give against the
    row's."""
    import torch

    from pydcop_tpu_torch.telemetry import memplane

    name = torch.cuda.get_device_name(0)
    row = memplane.device_generation(name)
    check(row is not None, f"memory: no device table row for {name!r}")
    _free, total = torch.cuda.mem_get_info(0)
    check(0.9 <= total / row[2] <= 1.0,
          f"memory: {name} reports {total} B, the table {row[2]} B")
    props = torch.cuda.get_device_properties(0)
    clock_khz = getattr(props, "memory_clock_rate", None)
    bus_bits = getattr(props, "memory_bus_width", None)
    out = {"name": name, "row": list(row), "total_bytes": total,
           "capacity_share": total / row[2]}
    if clock_khz and bus_bits:
        gbps = 2 * clock_khz * 1e3 * bus_bits / 8 / 1e9
        check(abs(gbps / row[1] - 1) <= 0.05,
              f"memory: {name} reports {gbps:.0f} GB/s, the table {row[1]}")
        out["reported_gbps"] = gbps
    else:
        out["reported_gbps"] = "not reported by torch"
    return out


def phase_memory(c4, c6):
    """The memory plane on the card.  Each solve of ``MEMORY_FIT`` runs
    cold on a fresh copy of its problem and then warm; its rise in peak
    allocated memory stands beside ``predict_solve_bytes``'s total, and
    the workspace factor it implies (the rise less the exact components,
    over the family's dominant plane) beside ``memplane._WORKSPACE``.
    Config 6, out of the fit, must be predicted within
    ``MEMORY_HELD_RATIO`` of its cold rise, by a guarded solve (no
    override: the card's own limit) that the guard lets pass.  A refused
    solve must leave ``memory_allocated`` as it was, and a serve
    admission refused over HTTP must answer 503 with the breach."""
    import urllib.error
    import urllib.request

    import torch

    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.commands.generators.ising import (
        generate_ising_arrays,
    )
    from pydcop_tpu_torch.serve import ServeServer
    from pydcop_tpu_torch.telemetry import memplane

    out = {"phase": "memory", "device": _device_table_row()}
    problems = {
        "config4": c4, "config6": c6, "config5": _meetings(30),
        "config3": generate_ising_arrays(*CONFIG_3["gen"]),
    }

    def measured(label, problem, algo, params, n_cycles):
        mod = load_algorithm_module(algo)
        compiled = _fresh(problems[problem])

        def solve():
            return mod.solve(compiled, dict(params), n_cycles=n_cycles,
                             seed=7, device="cuda")

        cold, cold_rise, cold_reserved = _peak_rise(solve)
        warm, warm_rise, _ = _peak_rise(solve)
        check((cold.cost, cold.violations) == (warm.cost, warm.violations),
              f"memory {label}: cold and warm solves differ")
        pred = memplane.predict_solve_bytes(
            compiled, algo, params, n_cycles=n_cycles)
        family = memplane._FAMILY[algo]
        _consts, _state, plane, key = memplane._family_bytes(
            family, algo, memplane.shape_of(compiled), params, compiled,
            pred["layout"])
        fixed = pred["total_bytes"] - pred["components"]["workspace"]
        tree_sum = (pred["components"]["workspace"]
                    - int(memplane._WORKSPACE[key] * plane))
        return {
            "predicted_bytes": pred["total_bytes"],
            "cold_rise_bytes": cold_rise, "warm_rise_bytes": warm_rise,
            "cold_reserved_rise_bytes": cold_reserved,
            "ratio": pred["total_bytes"] / cold_rise,
            "workspace_key": key,
            "factor": memplane._WORKSPACE[key],
            "implied_factor": (cold_rise - fixed - tree_sum) / plane,
            "components": pred["components"],
        }

    _zero_all_launches()
    rows = {}
    for label, *run in MEMORY_FIT:
        rows[label] = measured(label, *run)
        emit({"phase": "memory_solve", "solve": label, **rows[label]})
    launches = _all_launch_counts()
    out["fit"] = {k: {f: v[f] for f in ("predicted_bytes",
                                         "cold_rise_bytes", "ratio",
                                         "implied_factor")}
                  for k, v in rows.items()}
    # config 6 through the guard, with the card's own limit
    memplane.memguard.reset()
    memplane.memguard.configure(enabled=True)
    try:
        held = measured(*MEMORY_HELD)
    finally:
        memplane.memguard.reset()
    emit({"phase": "memory_solve", "solve": MEMORY_HELD[0], **held})
    limit = memplane.device_limit_bytes("cuda")
    lo, hi = MEMORY_HELD_RATIO
    check(held["predicted_bytes"] <= limit * 0.9,
          f"memory: config 6 predicted over the card's budget ({limit} B)")
    check(lo <= held["ratio"] <= hi,
          f"memory: config 6 predicted/measured {held['ratio']:.3f} "
          f"outside [{lo}, {hi}]")
    out["held"] = {"solve": MEMORY_HELD[0], "limit_bytes": limit,
                   **{f: held[f] for f in ("predicted_bytes",
                                           "cold_rise_bytes", "ratio")}}

    # a refusal uploads nothing
    label, problem, algo, params, n_cycles = MEMORY_FIT[0]
    compiled = _fresh(problems[problem])
    pred = memplane.predict_solve_bytes(compiled, algo, params,
                                        n_cycles=n_cycles)
    memplane.memguard.configure(enabled=True,
                                limit_bytes=pred["total_bytes"] // 2)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        load_algorithm_module(algo).solve(
            compiled, dict(params), n_cycles=n_cycles, seed=7,
            device="cuda")
        refused = None
    except memplane.MemoryBudgetExceeded as e:
        refused = e.breach
    finally:
        memplane.memguard.reset()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    check(refused is not None, "memory: the guard let a refusal through")
    check(after == before,
          f"memory: a refused solve moved memory_allocated {before} -> "
          f"{after}")
    check(refused["predicted_bytes"] == pred["total_bytes"],
          f"memory: refusal {refused}")
    out["refusal"] = {"solve": label, "allocated_before": before,
                      "allocated_after": after,
                      "breach_keys": sorted(refused)}

    # a serve admission refused over HTTP
    srv = ServeServer(port=0, window_ms=5, device="cuda")
    memplane.memguard.configure(enabled=True, limit_bytes=1000)
    try:
        base = f"http://127.0.0.1:{srv.http.port}"
        body = json.dumps({
            "dcop_yaml": (ROOT / FRONT_DOOR_YAML[0]).read_text(),
            "algo": "dsa", "n_cycles": 30, "seed": 3, "tenant": "big",
        }).encode()
        try:
            urllib.request.urlopen(urllib.request.Request(
                base + "/solve", data=body, method="POST"))
            code, doc = 200, {}
        except urllib.error.HTTPError as e:
            code, doc = e.code, json.loads(e.read())
        with urllib.request.urlopen(base + "/status") as resp:
            status = json.loads(resp.read())
    finally:
        memplane.memguard.reset()
        srv.shutdown()
    check(code == 503 and doc.get("mem", {}).get("context") == "serve",
          f"memory: POST /solve over the budget answered {code} {doc}")
    check(status["memory"]["guard"]["enabled"]
          and status["memory"]["refusals_total"] >= 0,
          f"memory: /status memory block {status.get('memory')}")
    out["serve_refusal"] = {"code": code, "mem": doc["mem"],
                            "status_memory": status["memory"]}
    out["launches"] = launches
    emit(out)
    return launches


def analyze_first(tenant_result):
    """The diagnosis of a tenant's health rows."""
    from pydcop_tpu_torch.telemetry.pulse import analyze

    return analyze(tenant_result.extras["pulse"]["health"]).get("diagnosis")


def phase_serve_fleet_checkpoint():
    """The ``serve`` verb on the card, in a subprocess (pulse on by
    default, ``--checkpoint DIR``): a POSTed YAML problem is solved, its
    result carrying a pulse block; SIGTERM drains the server, which exits
    0 and writes the fleet manifest (``kind: fleet``) with the tenant
    done, its cost the card's ``solve_result``."""
    import signal
    import tempfile
    import urllib.request

    from pydcop_tpu_torch.api import solve_result
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

    path = ROOT / FRONT_DOOR_YAML[0]
    out = {"phase": "serve_fleet_checkpoint"}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Path(tmp) / "fleet"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [*PORT_CLI, "--output", str(Path(tmp) / "serve.json"), "serve",
             "--port", "0", "--window-ms", "5", "--checkpoint", str(ck)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        try:
            line = proc.stdout.readline()
            check(line.startswith("SERVE_PORT="),
                  f"serve_fleet_checkpoint: no port line: {line!r}")
            out["ready_s"] = time.perf_counter() - t0
            base_url = f"http://127.0.0.1:{int(line.split('=')[1])}"
            body = json.dumps({"dcop_yaml": path.read_text(), "algo": "dsa",
                               "n_cycles": 30, "seed": 3,
                               "tenant": "fleet"}).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    base_url + "/solve", data=body, method="POST"),
                    timeout=120) as resp:
                doc = json.loads(resp.read())
                check(doc["tenant"] == "fleet" and len(doc["trace"]) == 16,
                      f"serve_fleet_checkpoint: POST /solve {doc}")
            deadline = time.perf_counter() + 300
            while True:
                with urllib.request.urlopen(base_url + "/result/fleet",
                                            timeout=60) as resp:
                    row = json.loads(resp.read())
                if row["status"] in ("done", "failed", "killed"):
                    break
                check(time.perf_counter() < deadline,
                      "serve_fleet_checkpoint: no result in 300 s")
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=60)
        check(proc.returncode == 0,
              f"serve_fleet_checkpoint: the drained server exited "
              f"{proc.returncode}")
        check(row["status"] == "done" and row["pulse"]["cycles"] == 30,
              f"serve_fleet_checkpoint: {row.get('status')}, "
              f"{row.get('pulse')}")
        manifest = json.loads((ck / "fleet-manifest.json").read_text())
        summary = json.loads((Path(tmp) / "serve.json").read_text())
    want = solve_result(load_dcop_from_file([str(path)]), "dsa",
                        n_cycles=30, seed=3, device="cuda")
    tenant = manifest["tenants"]["fleet"]
    check(manifest["kind"] == "fleet" and manifest["state"] == "drained"
          and tenant["status"] == "done" and tenant["cost"] == want["cost"]
          and tenant["assignment"] == want["assignment"],
          f"serve_fleet_checkpoint: manifest {manifest}")
    check(summary["fleet_checkpoint"] == str(ck / "fleet-manifest.json"),
          f"serve_fleet_checkpoint: summary {summary}")
    out.update(pulse=row["pulse"], manifest_keys=sorted(manifest),
               cost=tenant["cost"], equal_to_solve_result=True,
               wall_s=time.perf_counter() - t0)
    emit(out)


def _replay_child(directory: str) -> None:
    """The replay phase's process to kill: plays REPLAY_SCENARIO on the
    card with a checkpoint an event, and SIGKILLs itself once the first
    event's checkpoint is written."""
    import os
    import signal

    from pydcop_tpu_torch.durability import CheckpointManager

    class KillAfterFirst(CheckpointManager):
        def save_carry(self, *a, **k):
            path = super().save_carry(*a, **k)
            os.kill(os.getpid(), signal.SIGKILL)
            return path

    sess = _replay_session(KillAfterFirst(directory, keep=10))
    sess.play()


def _replay_session(manager, device="cuda", resume=None):
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.dcop.yamldcop import load_scenario
    from pydcop_tpu_torch.durability import ScenarioSession

    n, d, kw = REPLAY_PROBLEM
    dcop = generate_graph_coloring(n, d, **kw)
    scenario = load_scenario(REPLAY_SCENARIO)
    if resume is not None:
        return ScenarioSession.resume(dcop, scenario, resume,
                                      params=dict(REPLAY_PARAMS),
                                      manager=manager, device=device)
    return ScenarioSession(dcop, scenario, params=dict(REPLAY_PARAMS),
                           seed=REPLAY_SEED, manager=manager, device=device)


def phase_replay_session():
    """A scenario replay killed and resumed on the card
    (``replay_session``): a subprocess plays REPLAY_SCENARIO with a
    checkpoint an event and is SIGKILLed after the first; the session
    resumed from that checkpoint plays the rest and gives the
    uninterrupted run's costs and result, on the card and on the CPU."""
    import signal
    import tempfile

    from pydcop_tpu_torch.durability import CheckpointManager, list_manifests

    out = {"phase": "replay_session", "n_vars": REPLAY_PROBLEM[0]}
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sess = _replay_session(None, device)
        runs[device] = (sess.play(), list(sess.cost_trace))
        sess.close()
        out[f"{device}_play_s"] = time.perf_counter() - t0
    check(runs["cuda"] == runs["cpu"],
          f"replay_session: the card {runs['cuda'][1]} vs the CPU "
          f"{runs['cpu'][1]}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--replay-child",
             tmp], cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        out["killed_child_s"] = time.perf_counter() - t0
        check(child.returncode == -signal.SIGKILL,
              f"replay_session: the child exited {child.returncode}: "
              f"{child.stderr[-2000:]}")
        manifests = list_manifests(tmp)
        check(len(manifests) == 1
              and manifests[0]["extra"]["scenario_cursor"] == 1,
              f"replay_session: {len(manifests)} checkpoint(s) left")
        t0 = time.perf_counter()
        sess = _replay_session(CheckpointManager(tmp, keep=10),
                               resume=tmp)
        check(sess.cursor == 1, f"replay_session: cursor {sess.cursor}")
        resumed = (sess.play(), list(sess.cost_trace))
        sess.close()
        out["resume_s"] = time.perf_counter() - t0
        out["checkpoints_after"] = len(list_manifests(tmp))
    full, trace = runs["cuda"]
    check(resumed[0] == full and resumed[1] == trace[-len(resumed[1]):],
          f"replay_session: resumed {resumed[1]} vs uninterrupted {trace}")
    out.update(cost_trace=trace, cost=full.cost, cycles=full.cycles,
               resumed_equals_uninterrupted=True, same_as_cpu=True)
    emit(out)


def phase_trace_cli():
    """``solve --trace-out/--metrics-out`` on the card (``trace_cli``):
    the CLI writes the engine's readback windows and read-back as the JAX
    package names them (``solve.window``, ``solve.readback``, category
    ``device``, JAX's fields), the windows' cycles adding up to the
    solve's, and JAX's metric names, ``solve.device_cycles`` the cycles
    run."""
    import tempfile

    from pydcop_tpu_torch import dcop_cli

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        # the CLI's entry point in this process (``python -m
        # pydcop_tpu_torch`` calls it) with PORT_CLI's global options,
        # on the card
        rc = dcop_cli.main([
            *PORT_CLI[3:], "--output", str(tmp / "r.json"), "solve",
            *FRONT_DOOR_ARGS[:4], "-n", "300", "--trace-out",
            str(tmp / "t.json"), "--metrics-out", str(tmp / "m.json"),
            str(ROOT / FRONT_DOOR_YAML[0]),
        ])
        wall = time.perf_counter() - t0
        check(rc == 0, f"trace_cli: exit {rc}")
        result = json.loads((tmp / "r.json").read_text())
        trace = json.loads((tmp / "t.json").read_text())
        metrics = json.loads((tmp / "m.json").read_text())["metrics"]
    spans = {name: [e for e in trace["traceEvents"]
                    if e.get("name") == name] for name in TRACE_SPANS}
    for name, fields in TRACE_SPANS.items():
        check(spans[name] and all(
            e["cat"] == "device" and e["ph"] == "X"
            and set(e["args"]) == fields for e in spans[name]),
            f"trace_cli: {name} spans {spans[name][:2]}")
    cycles = sum(e["args"]["cycles"] for e in spans["solve.window"])
    check(cycles == result["cycle"] > 0,
          f"trace_cli: windows of {cycles} cycles, the solve "
          f"{result['cycle']}")
    check(all(m in metrics for m in TRACE_METRICS)
          and metrics["solve.device_cycles"]["values"][0]["value"]
          == result["cycle"],
          f"trace_cli: metrics {sorted(metrics)}")
    emit({
        "phase": "trace_cli", "wall_s": wall, "cycles": result["cycle"],
        "windows": len(spans["solve.window"]),
        "window_cycles": [e["args"]["cycles"]
                          for e in spans["solve.window"]],
        "readback_bytes": spans["solve.readback"][0]["args"]["bytes"],
        "metrics": sorted(metrics),
    })


def _wait_timed(proc, t0):
    """Wait for ``proc`` (started at ``t0``): (exit code, wall seconds,
    CPU seconds of the process)."""
    import os

    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    return (proc.returncode, time.perf_counter() - t0,
            usage.ru_utime + usage.ru_stime)


def phase_generate_verb():
    """``python -m pydcop_tpu_torch generate`` for all nine families
    (``generate_verb``) at GENERATE_VERB's sizes, with no card visible:
    each file's sha256 must be the JAX package's for the same arguments.
    The eight independent families run at once, then the scenario over
    the iot file's agents; each one's wall and CPU seconds (the host's:
    the verb never touches the card)."""
    import hashlib
    import os
    import tempfile
    import threading

    import yaml

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = {"phase": "generate_verb",
           "libyaml": bool(getattr(yaml, "__with_libyaml__", False)),
           "families": {}}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def run(family, args, pinned):
            args = [a.replace("{dir}", tmp) for a in args]
            with open(os.path.join(tmp, f"{family}.log"), "w+") as log:
                t0 = time.perf_counter()
                proc = subprocess.Popen(
                    [*PORT_CLI, "generate", family, *args, "-o",
                     os.path.join(tmp, f"{family}.yaml")],
                    cwd=ROOT, stdout=subprocess.DEVNULL, stderr=log,
                    env=env,
                )
                rc, wall, cpu = _wait_timed(proc, t0)
                log.seek(0)
                row = {"rc": rc, "wall_s": wall, "cpu_s": cpu,
                       "stderr": log.read()[-2000:], "files": {}}
            for name, sha in pinned.items():
                path = Path(tmp, name)
                data = path.read_bytes() if path.exists() else b""
                row["files"][name] = {
                    "bytes": len(data),
                    "jax_sha256": hashlib.sha256(data).hexdigest() == sha,
                }
            out["families"][family] = row

        first = [
            threading.Thread(target=run, args=case)
            for case in GENERATE_VERB if case[0] != "scenario"
        ]
        for th in first:
            th.start()
        for th in first:
            th.join()
        run(*[case for case in GENERATE_VERB if case[0] == "scenario"][0])
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for family, row in out["families"].items():
        check(row["rc"] == 0,
              f"generate_verb {family}: exit {row['rc']}: {row['stderr']}")
        for name, got in row["files"].items():
            check(got["jax_sha256"],
                  f"generate_verb {family}: {name} is not the JAX "
                  f"package's file")
    check(len(out["families"]) == 9, "generate_verb: not all nine families")


def generated_problem(family):
    """The compiled problem of GENERATED_SOLVES' ``family``: the
    generator's DCOP (the verb's file's problem) through compile_dcop,
    and the host seconds of each stage."""
    import importlib

    from pydcop_tpu_torch.compile.core import compile_dcop

    (module, fn, kw), _pins = GENERATED_SOLVES[family]
    gen = getattr(importlib.import_module(
        f"pydcop_tpu_torch.commands.generators.{module}"), fn)
    t0 = time.perf_counter()
    dcop = gen(**kw)
    if isinstance(dcop, tuple):  # generate_iot: (dcop, distribution)
        dcop = dcop[0]
    t1 = time.perf_counter()
    compiled = compile_dcop(dcop)
    emit({"phase": f"generated_{family}_problem",
          "generate_s": t1 - t0, "compile_s": time.perf_counter() - t1,
          "n_vars": compiled.n_vars, "n_edges": compiled.n_edges,
          "max_domain": compiled.max_domain})
    return compiled


def phase_generated_solves(counts):
    """MaxSum (damping 0.7) and DSA through ``solve`` on the card on the
    generated IoT, small-world and SECP problems (``generated_*``), each
    cold, warm and on the CPU (``phase_solve``: the CPU's result exactly,
    the JAX package's pinned cost, launches an iteration by kernel).
    MaxSum runs ``auto``: ELL on the binary IoT and small-world problems,
    lanes on SECP's n-ary one.  ``counts`` gives a solve's launches an
    iteration and in its prologue (``main``'s).  Returns the warm solves'
    launches by kernel."""
    from pydcop_tpu_torch.algorithms.maxsum import resolve_layout

    generated = {}
    for family in GENERATED_SOLVES:
        compiled = generated_problem(family)
        for algo, params in GENERATED_RUNS:
            if algo == "maxsum":
                layout = resolve_layout(compiled, "auto")
                per_cycle, per_start = counts(
                    "ell_minplus" if layout == "ell"
                    else "factor_arity2_minplus",
                    ell=layout == "ell", maxsum=True, damp=True,
                )
            else:
                per_cycle, per_start = counts()
            _, warm = phase_solve(
                f"generated_{family}_{algo}", compiled,
                (algo, dict(params), 30, 0), per_cycle,
                per_start=per_start,
                recorded=GENERATED_SOLVES[family][1][algo],
            )
            for name in per_cycle:
                generated[name] = generated.get(name, 0) + warm[name]
    return generated


def _fault_schedule_file(path, at):
    path.write_text(f"seed: 0\nevents:\n  - kill_process: true\n"
                    f"    at: {at!r}\n")
    return path


def _manifests(directory):
    """(cycle, unix seconds written) of each snapshot in ``directory``,
    by cycle."""
    return sorted(
        (m["cycle"], m["wrote_unix_s"])
        for m in (json.loads(p.read_text())
                  for p in Path(directory).glob("ckpt-c*.json"))
    )


def phase_fault_kill_resume_cli():
    """``solve --fault-schedule`` killing the process (``fault_kill_resume``
    through the CLI): MaxSum on a generated coloring with a snapshot
    every FAULT_EVERY cycles, under a ``kill_process`` schedule due after
    the solve has returned (FAULT_AFTER_S), then under one due halfway
    between the first run's first and last snapshots (its arming read off
    its exit time less the kill's ``at``).  Each run must exit 137 with no
    result and leave snapshots, the first all of them, the second not the
    last; ``solve --resume`` from each prints the uninterrupted JSON
    (``time`` aside)."""
    args = ["solve", "-a", "maxsum", "-p", "damping:0.7", "-n",
            str(FAULT_CYCLES), "--seed", "3"]
    out = {"phase": "fault_kill_resume_cli", "n_cycles": FAULT_CYCLES,
           "every": FAULT_EVERY}
    try:
        _fault_kill_resume_cli(args, out)
    finally:
        emit(out)  # what was measured, also when a check failed


def _fault_kill_resume_cli(args, out):
    import tempfile

    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.api import solve_result
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop_from_file

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        n, d, kw = KILL_PROBLEM
        path = tmp / "coloring.yaml"
        path.write_text(dcop_yaml(generate_graph_coloring(n, d, **kw)))
        dcop = load_dcop_from_file(str(path))
        algo = AlgorithmDef.build_with_default_param(
            "maxsum", {"damping": "0.7"}, mode=dcop.objective
        )
        t0 = time.perf_counter()
        want = json.loads(json.dumps(solve_result(
            dcop, algo, distribution="oneagent", n_cycles=FAULT_CYCLES,
            seed=3, device="cuda",
        ), default=str))
        out["uninterrupted_s"] = time.perf_counter() - t0
        want.pop("time")
        last = want["cycle"] // FAULT_EVERY * FAULT_EVERY

        def killed(tag, at, want_snapshot=True):
            ck = tmp / tag
            sched = _fault_schedule_file(tmp / f"{tag}.yaml", at)
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [*PORT_CLI, *args, "--checkpoint", str(ck),
                 "--checkpoint-every", str(FAULT_EVERY),
                 "--checkpoint-keep", "1000", "--fault-schedule",
                 str(sched), str(path)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate(timeout=60)
            exited = time.time()
            check(proc.returncode == 137 and not stdout,
                  f"fault_kill_resume_cli {tag}: exit {proc.returncode}, "
                  f"{len(stdout)} bytes out: {stderr[-2000:]}")
            snaps = _manifests(ck)
            row = {"at_s": at, "wall_s": time.perf_counter() - t0,
                   "snapshots": len(snaps)}
            out[tag] = row
            check(snaps or not want_snapshot,
                  f"fault_kill_resume_cli {tag}: no snapshot")
            if snaps:
                armed = exited - at
                row.update(last_cycle=snaps[-1][0],
                           first_snapshot_s=snaps[0][1] - armed,
                           last_snapshot_s=snaps[-1][1] - armed)
            return ck, row

        after_ck, after = killed("after_return", FAULT_AFTER_S)
        check(after["last_cycle"] == last,
              f"fault_kill_resume_cli: the first run's last snapshot is "
              f"cycle {after['last_cycle']}, not {last}: the kill came "
              f"before the solve returned")
        check(after["last_snapshot_s"] < FAULT_AFTER_S,
              "fault_kill_resume_cli: the last snapshot after the kill")
        # halfway through the first run's snapshots; a CLI process's cold
        # start varies by seconds between processes, so a kill that falls
        # before this one's first snapshot, or after its last, is tried
        # again a quarter of the window later, or earlier
        window = after["last_snapshot_s"] - after["first_snapshot_s"]
        mid_at = after["first_snapshot_s"] + window / 2
        for attempt in range(3):
            mid_ck, mid = killed(f"mid_solve_{attempt}", round(mid_at, 3),
                                 want_snapshot=False)
            if not mid["snapshots"]:
                mid_at += window / 4
            elif mid["last_cycle"] >= last:
                mid_at -= window / 4
            else:
                break
        out["mid_solve"] = mid
        check(mid["snapshots"] and mid["last_cycle"] < last,
              f"fault_kill_resume_cli: the mid-solve kill at {mid_at} s "
              f"found no snapshot or came after the last one: {mid}")
        t0 = time.perf_counter()
        procs = {
            tag: subprocess.Popen(
                [*PORT_CLI, *args, "--resume", str(ck), str(path)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
            for tag, ck in (("after_return", after_ck),
                            ("mid_solve", mid_ck))
        }
        for tag, proc in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate(timeout=60)
            check(proc.returncode == 0,
                  f"fault_kill_resume_cli: the resume of {tag} exited "
                  f"{proc.returncode}: {stderr[-2000:]}")
            got = json.loads(stdout)
            got.pop("time")
            check(got == want, f"fault_kill_resume_cli: the resume of {tag} "
                  f"differs from the uninterrupted run")
        out.update(resumes_s=time.perf_counter() - t0,
                   resumed_equal_uninterrupted=True, cost=want["cost"],
                   cycles=want["cycle"])


def _fault_child(directory: str) -> None:
    """The config-4 process to kill (``--fault-child DIR``): a durable
    MaxSum ``ell`` solve of FAULT4_CYCLES cycles (a snapshot every
    FAULT4_EVERY) run twice, the second timed from its snapshots, then a
    third with a ``kill_process`` schedule armed just before it, due
    halfway between the timed run's first and last snapshots.  Writes
    the timed run's result and window to DIR/window.json first."""
    import os

    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.chaos import (
        ChaosController,
        FaultSchedule,
        KillProcessEvent,
    )
    from pydcop_tpu_torch.durability import CheckpointManager, durability

    c4 = generate(CONFIG_4["gen"])

    def durable(sub):
        durability.configure(manager=CheckpointManager(
            os.path.join(directory, sub), every_cycles=FAULT4_EVERY,
            keep=1000))
        try:
            return maxsum.solve(
                c4, dict(CONFIG_4["params"], layout="ell"),
                n_cycles=FAULT4_CYCLES, seed=CONFIG_4["seed"],
                device="cuda",
            )
        finally:
            durability.reset()

    durable("cold")
    t0 = time.time()
    res = durable("timed")
    snaps = _manifests(os.path.join(directory, "timed"))
    first, last = snaps[0][1] - t0, snaps[-1][1] - t0
    at = round((first + last) / 2, 3)
    Path(directory, "window.json").write_text(json.dumps({
        "first_snapshot_s": first, "last_snapshot_s": last, "at_s": at,
        "solve_s": time.time() - t0, "cost": res.cost,
        "cycles": res.cycles, "last_cycle": snaps[-1][0],
    }))
    chaos = ChaosController(FaultSchedule(
        events=[KillProcessEvent(at=at)]))
    chaos.start(None)
    durable("killed")
    chaos.wait_timeline(timeout=at + 60.0)


def phase_fault_kill_resume_config4(c4):
    """A config-4 durable solve killed by a fault schedule
    (``fault_kill_resume_config4``): ``chip_smoke.py --fault-child DIR``
    dies by its ``kill_process`` (exit 137) partway through its third
    solve; resumed here on the card from its newest snapshot, the solve
    gives the uninterrupted result (assignment, cost, cycles) bit for
    bit, and the child's own uninterrupted run's cost and cycles."""
    import tempfile

    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.durability import durability

    def solve(resume=None):
        durability.configure(resume=resume)
        try:
            return maxsum.solve(
                c4, dict(CONFIG_4["params"], layout="ell"),
                n_cycles=FAULT4_CYCLES, seed=CONFIG_4["seed"],
                device="cuda",
            )
        finally:
            durability.reset()

    out = {"phase": "fault_kill_resume_config4", "n_vars": c4.n_vars,
           "n_cycles": FAULT4_CYCLES, "every": FAULT4_EVERY}
    t0 = time.perf_counter()
    want = solve()
    out["uninterrupted_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--fault-child",
             tmp], cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        out["child_s"] = time.perf_counter() - t0
        check(child.returncode == 137,
              f"fault_kill_resume_config4: the child exited "
              f"{child.returncode}: {child.stderr[-2000:]}")
        window = json.loads(Path(tmp, "window.json").read_text())
        snaps = _manifests(Path(tmp, "killed"))
        check(snaps and snaps[-1][0] < window["last_cycle"],
              f"fault_kill_resume_config4: snapshots {snaps[-1:]} of the "
              f"killed run, the timed run's last {window['last_cycle']}")
        newest = Path(tmp, "killed", f"ckpt-c{snaps[-1][0]:09d}.npz")
        _zero_launches()
        t0 = time.perf_counter()
        got = solve(resume=str(newest))
        out["resume_s"] = time.perf_counter() - t0
        out["resume_launches"] = _launch_counts()
    key = (got.assignment, got.cost, got.cycles, got.violations)
    check(key == (want.assignment, want.cost, want.cycles, want.violations),
          f"fault_kill_resume_config4: resumed {got.cost}/{got.cycles} vs "
          f"uninterrupted {want.cost}/{want.cycles}")
    check((window["cost"], window["cycles"]) == (want.cost, want.cycles),
          "fault_kill_resume_config4: the child's uninterrupted run differs")
    check(out["resume_launches"]["ell_minplus"] > 0,
          "fault_kill_resume_config4: the resume launched no ell_minplus")
    out.update(window=window, killed_snapshots=len(snaps),
               resumed_from_cycle=snaps[-1][0], cost=want.cost,
               cycles=want.cycles, resumed_equals_uninterrupted=True)
    emit(out)


def phase_serve_fault_schedule():
    """``ServeServer(fault_schedule=)`` on the card
    (``serve_fault_schedule``): SERVE_FAULT_TENANTS under a schedule
    holding "hold*" SERVE_FAULT_HOLD_S by a delay rule and killing
    "dead*" at t = 0.  The killed tenants end ``killed`` (each a dead
    letter), each held tenant's queue latency is at least the hold, and
    every tenant not killed, held or not, gets its solo ``solve_one``
    bits, though the untouched ones rode a batch with the victims."""
    from pydcop_tpu_torch.chaos import FaultSchedule, KillEvent, MessageRule
    from pydcop_tpu_torch.serve import ServeServer, solve_one

    schedule = FaultSchedule(seed=0, events=[
        MessageRule(action="delay", pattern="solve", dest="hold*", p=1.0,
                    seconds=SERVE_FAULT_HOLD_S),
        KillEvent(agent="dead*", at=0.0),
    ])
    reqs = serve_requests(SERVE_FAULT_TENANTS, SERVE_PULSE_GRID_RUN)
    solo = {r.tenant: solve_one(r, device="cuda") for r in reqs
            if not r.tenant.startswith("dead")}
    srv = ServeServer(port=None, window_ms=50, max_batch=32,
                      fault_schedule=schedule)
    _zero_all_launches()
    t0 = time.perf_counter()
    try:
        for r in reqs:
            srv.submit(r)
        rows = {r.tenant: srv.wait(r.tenant, timeout=300) for r in reqs}
        wall = time.perf_counter() - t0
        launches = _all_launch_counts()
    finally:
        drained = srv.shutdown(drain=True)
    st = srv.status()
    for tenant, row in rows.items():
        if tenant.startswith("dead"):
            check(row["status"] == "killed"
                  and row["error"] == "killed by chaos schedule",
                  f"serve_fault_schedule {tenant}: {row}")
            continue
        want = solo[tenant]
        got = (row["status"], row["assignment"], row["cost"],
               row["cycles"], row["best_cost"], row["cycles_to_best"])
        check(got == ("done", want.result.assignment, want.result.cost,
                      want.result.cycles, want.extras["best_cost"],
                      want.extras["cycles_to_best"]),
              f"serve_fault_schedule {tenant}: not its solo bits")
        if tenant.startswith("hold"):
            check(row["queue_ms"] >= 1e3 * SERVE_FAULT_HOLD_S,
                  f"serve_fault_schedule {tenant}: queued "
                  f"{row['queue_ms']} ms")
    n_dead = sum(t.startswith("dead") for t in rows)
    check(drained and st["dead_letters"] == n_dead
          and st["tenant_counts"] == {"done": len(rows) - n_dead,
                                      "killed": n_dead},
          f"serve_fault_schedule: {st['tenant_counts']}, "
          f"{st['dead_letters']} dead letters")
    check(launches["ell_minplus_batched"] and launches["damp_fma_batched"],
          f"serve_fault_schedule: batched launches {launches}")
    ok_batch = [rows[t]["batch_size"] for t in rows if t.startswith("ok")]
    check(min(ok_batch) > sum(t.startswith("ok") for t in rows),
          f"serve_fault_schedule: the untouched tenants rode batches of "
          f"{ok_batch}, without the victims")
    emit({"phase": "serve_fault_schedule", "tenants": len(rows),
          "killed": n_dead, "wall_s": wall, "batches": st["batches"],
          "queue_ms": {t: rows[t]["queue_ms"] for t in rows
                       if not t.startswith("dead")},
          "ok_batch_sizes": ok_batch, "launches": launches,
          "solo_bits": True})


def _http_json(url, body=None, timeout=120):
    """(status, JSON document) of a GET (``body`` None) or a POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode(),
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _http_text(url, timeout=120):
    """(status, body text, seconds) of a GET."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        text = resp.read().decode("utf-8")
    return resp.status, text, time.perf_counter() - t0


class _Scraper:
    """Scrapes the live surface in a loop on a thread of its own: each
    round reads ``/status``, then every surface route, then ``/status``
    again; a route's read lies inside a batch when both ``/status`` reads
    around it show running tenants."""

    ROUTES = ("/metrics", "/metrics?format=openmetrics", "/metrics.json",
              "/healthz", "/slo")

    def __init__(self, base):
        import threading

        self.base, self.rounds, self.errors = base, [], []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _running(self):
        code, text, _ = _http_text(self.base + "/status")
        return code == 200 and json.loads(text)["tenant_counts"].get(
            "running", 0) > 0

    def _run(self):
        while not self.stop.wait(0.02):
            try:
                before = self._running()
                reads = {path: _http_text(self.base + path)
                         for path in self.ROUTES}
                self.rounds.append((before and self._running(), {
                    path: (code, secs) for path, (code, _, secs)
                    in reads.items()}))
            except Exception as e:  # noqa: BLE001 (checked after the run)
                self.errors.append(f"{type(e).__name__}: {e}")
                return

    def finish(self):
        self.stop.set()
        self.thread.join(timeout=120)
        check(not self.thread.is_alive() and not self.errors,
              f"serve_observability: scrapes failed: {self.errors[:3]}")
        check(all(code == 200 for _, reads in self.rounds
                  for code, _ in reads.values()),
              "serve_observability: a scrape answered other than 200")
        inside = [reads["/metrics"][1] for busy, reads in self.rounds
                  if busy]
        check(inside, "serve_observability: no scrape inside a batch "
              f"({len(self.rounds)} rounds)")
        return inside


def _imports_torch(importtime_stderr: str) -> bool:
    """Whether a ``python -X importtime`` run imported torch."""
    return any(line.rsplit("|", 1)[-1].strip().split(".")[0] == "torch"
               for line in importtime_stderr.splitlines()
               if line.startswith("import time:"))


def _generated_yaml(n, gen_seed):
    """The ``generate graph_coloring`` verb's YAML text of a soft grid
    coloring (a host-only subprocess: ``generate_graph_coloring(n, 3,
    graph="grid", seed=gen_seed)`` written by ``dcop_yaml``)."""
    run = subprocess.run(
        [*PORT_CLI, "generate", "graph_coloring", "-v", str(n), "-c", "3",
         "-g", "grid", "--soft", "--seed", str(gen_seed)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(run.returncode == 0,
          f"serve_observability: generate rc {run.returncode}: "
          f"{run.stderr[-500:]}")
    return run.stdout


def phase_serve_observability():
    """Serving's live surface on the card (``serve_observability``): a
    ``ServeServer`` on a free port with pulse on, the metrics registry and
    the tracer on, an SLO engine (``SERVE_OBS_SLO``: a latency objective
    that holds, and availability) and a schedule killing ``dead*``, on
    the serve grid's tenants at damping 0.7.  All 32 go in over ``POST
    /solve``, their problems as the ``generate`` verb's YAML (made in
    subprocesses while the plain batches run), the even ones with a trace
    id, while a scraper reads ``/metrics`` (classic and OpenMetrics),
    ``/metrics.json``, ``/status``, ``/healthz`` and ``/slo``.  Then the
    same 32 problems as warm batches, in turns with a plain server
    (registry, tracer and SLO off): plain, instrumented, instrumented,
    plain; then a killed tenant's trace id resubmitted under a new
    tenant.  Checks: the surviving tenants equal a plain
    ``solve_batched`` of the same requests bit for bit; a warm
    instrumented batch captures nothing and launches ``ell_minplus``,
    ``xla_tree_sum`` and ``damp_fma`` as often as the plain warm batch,
    with at most one host sync more (the ``t_solved`` synchronize);
    ``serve.solves``, ``serve.dead_letters`` and ``slo.events`` add up;
    OpenMetrics exemplars carry submitted trace ids and every ``/result``
    its own; the availability alert fires and writes its postmortem, the
    latency objective stays quiet; ``/healthz`` answers 200 while serving
    and 503 once the drain began; ``watch --once --json`` reads the
    server without importing torch; ``telemetry --validate`` passes the
    trace and ``telemetry --metrics`` reads the registry.  Returns the
    warm instrumented batch's launches."""
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from pydcop_tpu_torch.chaos import FaultSchedule, KillEvent
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.compile.core import compile_dcop
    from pydcop_tpu_torch.serve import ServeServer, SolveRequest, solve_batched
    from pydcop_tpu_torch.telemetry import (
        SloEngine,
        metrics_registry,
        parse_objective,
        tracer,
    )
    from pydcop_tpu_torch.telemetry.prom import parse_prometheus_text
    from pydcop_tpu_torch.telemetry.pulse import pulse
    from pydcop_tpu_torch.telemetry.slo import DEFAULT_FAST_BURN

    algo, params, n_cycles = SERVE_PULSE_GRID_RUN
    n_dead = SERVE_OBS_KILLED
    # the killed share of the batch burns the availability budget past the
    # fast threshold: the alert must fire
    check(n_dead / len(SERVE_GRID) / 0.01 > DEFAULT_FAST_BURN,
          "serve_observability: too few kills to burn the budget")
    out = {"phase": "serve_observability", "slo": list(SERVE_OBS_SLO)}
    t_phase = time.perf_counter()
    gen_pool = ThreadPoolExecutor(8)
    texts, seeds, reqs = {}, {}, []
    for i, (tenant, n, gen_seed, seed) in enumerate(SERVE_GRID):
        tenant = f"dead{i}" if i < n_dead else tenant
        texts[tenant] = gen_pool.submit(_generated_yaml, n, gen_seed)
        seeds[tenant] = seed
        # the same problem as the verb's file compiles to (the arrays of
        # compile_dcop(load_dcop(text)), tests/test_torch_generate.py)
        reqs.append(SolveRequest(tenant, compile_dcop(generate_graph_coloring(
            n, 3, graph="grid", seed=gen_seed)), algo, dict(params),
            n_cycles, seed))

    def warm_batch(tenants):
        return solve_batched(tenants, device="cuda")

    # the plain batch: pulse on as the server has it, everything else off
    metrics_registry.enabled = tracer.enabled = False
    pulse.reset()
    pulse.enabled = True
    _, plain_cold_s, plain_cold = _counted(lambda: warm_batch(reqs))
    plain, _, plain_counts = _counted(lambda: warm_batch(reqs))
    check(plain_counts["captures"] == 0,
          "serve_observability: the plain warm batch captured")

    metrics_registry.reset()
    tracer.reset()
    metrics_registry.enabled = tracer.enabled = True
    tmp = tempfile.TemporaryDirectory()
    engine = SloEngine([parse_objective(s) for s in SERVE_OBS_SLO],
                       eval_interval_s=0.25,
                       postmortem_path=str(Path(tmp.name) / "slo.json"))
    schedule = FaultSchedule(seed=0, events=[KillEvent(agent="dead*",
                                                       at=0.0)])
    srv = ServeServer(port=0, window_ms=60_000, max_batch=len(reqs),
                      fault_schedule=schedule, slo=engine)
    plain_srv = ServeServer(port=None, window_ms=60_000,
                            max_batch=len(reqs))
    base = f"http://127.0.0.1:{srv.http.port}"
    try:
        # 1. every tenant over HTTP, the even ones with a trace id
        scraper = _Scraper(base)
        given = {t: f"{i:016x}" for i, t in enumerate(texts) if i % 2 == 0}

        def post(tenant):
            body = {"dcop_yaml": texts[tenant].result(), "algo": algo,
                    "params": params, "n_cycles": n_cycles,
                    "seed": seeds[tenant], "tenant": tenant}
            if tenant in given:
                body["trace"] = given[tenant]
            return _http_json(base + "/solve", body)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            answers = dict(zip(texts, pool.map(post, texts)))
        post_s = time.perf_counter() - t0
        gen_pool.shutdown()
        for tenant, (code, doc) in answers.items():
            check(code == 200 and doc["tenant"] == tenant
                  and doc["trace"] == given.get(tenant, doc["trace"])
                  and len(doc["trace"]) == 16,
                  f"serve_observability: POST /solve {tenant}: {code} {doc}")
        traces = {t: doc["trace"] for t, (_, doc) in answers.items()}
        rows = {t: srv.wait(t, timeout=600) for t in texts}
        http_s = time.perf_counter() - t0
        inside = scraper.finish()
        for i, r in enumerate(reqs):
            row = rows[r.tenant]
            check(row["trace"] == traces[r.tenant],
                  f"serve_observability: {r.tenant}'s /result trace")
            if i < n_dead:
                check(row["status"] == "killed",
                      f"serve_observability: {r.tenant} {row['status']}")
                continue
            want = plain[r.tenant]
            got = (row["status"], row["assignment"], row["cost"],
                   row["violations"], row["cycles"], row["best_cost"],
                   row["cycles_to_best"])
            check(got == ("done", want.result.assignment, want.result.cost,
                          want.result.violations, want.result.cycles,
                          want.extras["best_cost"],
                          want.extras["cycles_to_best"]),
                  f"serve_observability: {r.tenant} is not the plain "
                  "batch's")
        check(len({row["batch_seq"] for row in rows.values()}) == 1,
              "serve_observability: the HTTP tenants rode more than one "
              "batch")
        # the alert: an evaluator tick past the kills fires it
        deadline = time.perf_counter() + 30
        while not engine.transitions and time.perf_counter() < deadline:
            time.sleep(0.05)
        _, status = _http_json(base + "/status")
        check(status["slo"]["objectives"]["availability"]["alert"]
              == "fast" and status["slo"]["objectives"]["availability"][
                  "bad"] == n_dead,
              f"serve_observability: /status slo {status['slo']}")

        # 2. the same problems as warm batches, submitted in process, in
        # turns: the plain server (telemetry off), the instrumented one
        # twice, the plain one
        recorded = [len(rows)]  # tenants the instrumented server finished

        def turn(server, tag, on):
            # the instrumented server records a batch's tenants (metrics,
            # spans, the SLO engine) just after their results are out: let
            # it finish before the flags go off, or its last counts drop
            deadline = time.perf_counter() + 30
            while (engine.report()["requests"] < recorded[0]
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
            metrics_registry.enabled = tracer.enabled = on
            _zero_all_launches()
            before = _engine_counts()
            t0 = time.perf_counter()
            ids = [server.submit(r._replace(tenant=f"{tag}{i}"),
                                 trace=f"{0xbeef0000 + i:016x}")
                   for i, r in enumerate(reqs)]
            got = {t: server.wait(t, timeout=600) for t in ids}
            wall = time.perf_counter() - t0
            counts = {k: v - before[k] for k, v in _engine_counts().items()}
            counts.update(_all_launch_counts())
            if on:
                recorded[0] += len(ids)
            for tid, r in zip(ids, reqs):
                want = plain[r.tenant]
                check((got[tid]["status"], got[tid]["assignment"],
                       got[tid]["cost"], got[tid]["best_cost"])
                      == ("done", want.result.assignment, want.result.cost,
                          want.extras["best_cost"]),
                      f"serve_observability: warm {tid} is not the plain "
                      "batch's")
            return got, wall, counts

        turns = [turn(plain_srv, "p", False), turn(srv, "w", True),
                 turn(srv, "x", True), turn(plain_srv, "q", False)]
        metrics_registry.enabled = tracer.enabled = True
        warm_rows, _, counts = turns[1]
        check(not any(r.get("cold_compile") for r in warm_rows.values()),
              "serve_observability: a warm tenant paid a capture")
        for (_, _, c), name in zip(turns, ("plain", "instrumented",
                                           "instrumented", "plain")):
            check(c["captures"] == 0,
                  f"serve_observability: a warm {name} batch captured")
        for name in ("ell_minplus", "xla_tree_sum", "damp_fma"):
            for key in (name, f"{name}_batched"):
                check(counts[key] == plain_counts[key] > 0,
                      f"serve_observability: {key} {counts[key]} "
                      f"launches, the plain batch {plain_counts[key]}")
        check(plain_counts["host_syncs"] <= counts["host_syncs"]
              <= plain_counts["host_syncs"] + 1
              and turns[0][2]["host_syncs"] == plain_counts["host_syncs"],
              f"serve_observability: host syncs {counts['host_syncs']}, "
              f"plain {plain_counts['host_syncs']}")
        seqs = [{row["batch_seq"] for row in t[0].values()}
                for t in turns[1:3]]
        check(all(len(s) == 1 for s in seqs),
              f"serve_observability: warm batch sequence numbers {seqs}")
        spans = {e["args"]["batch"]: e["dur"] / 1e6 for e in tracer.events()
                 if e.get("name") == "serve.batch"}

        # 3. a killed tenant's trace id resubmitted under a new tenant,
        # in a window narrowed live
        code, doc = _http_json(base + "/window", {"window_ms": 5})
        check((code, doc) == (200, {"window_ms": 5.0}),
              f"serve_observability: POST /window {code} {doc}")
        code, doc = _http_json(base + "/solve", {
            "dcop_yaml": texts["dead0"].result(), "algo": algo,
            "params": params, "n_cycles": n_cycles,
            "seed": seeds["dead0"], "tenant": "retry-dead0",
            "trace": traces["dead0"]})
        check(code == 200 and doc["trace"] == traces["dead0"],
              f"serve_observability: resubmit {code} {doc}")
        retry = srv.wait("retry-dead0", timeout=600)
        check(retry["status"] == "done"
              and retry["trace"] == traces["dead0"]
              and retry["assignment"] == plain["dead0"].result.assignment,
              f"serve_observability: the resubmitted tenant {retry}")

        code, om, om_s = _http_text(base + "/metrics?format=openmetrics")
        parsed = parse_prometheus_text(om)
        ex_ids = {s["exemplar"]["labels"]["trace_id"]
                  for s in parsed["samples"] if s["exemplar"]}
        submitted = set(traces.values()) | {f"{0xbeef0000 + i:016x}"
                                            for i in range(len(reqs))}
        check(parsed["eof"] and ex_ids and ex_ids <= submitted,
              f"serve_observability: exemplars {sorted(ex_ids)[:4]}")
        code, classic, _ = _http_text(base + "/metrics")
        check(not parse_prometheus_text(classic)["eof"],
              "serve_observability: classic text")
        _, slo_report = _http_json(base + "/slo")
        _, health = _http_json(base + "/healthz")
        check(health == {"state": "serving", "queue_depth": 0},
              f"serve_observability: /healthz before the drain {health}")

        # watch, from a second process, against the live server
        t0 = time.perf_counter()
        watch = subprocess.run(
            [sys.executable, "-X", "importtime", *PORT_CLI[1:], "watch",
             base, "--once", "--json"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        watch_s = time.perf_counter() - t0
        check(watch.returncode == 0 and not _imports_torch(watch.stderr),
              f"serve_observability: watch rc {watch.returncode}, "
              f"imports torch: {_imports_torch(watch.stderr)}")
        seen = json.loads(watch.stdout)
        check(seen["status"]["solves"] == 3 * len(reqs) + 1 - n_dead
              and "serve.solves" in seen["metrics"],
              "serve_observability: watch's document")

        # the drain: /healthz answers 503 from its start
        drainer = threading.Thread(target=srv.drain, daemon=True)
        drainer.start()
        drainer.join(timeout=300)
        code, drained_health = _http_json(base + "/healthz")
        check(code == 503 and drained_health["state"] == "drained",
              f"serve_observability: /healthz after the drain {code} "
              f"{drained_health}")
        _, final_snap = _http_json(base + "/metrics.json")
    finally:
        gen_pool.shutdown()
        srv.shutdown()
        plain_srv.shutdown()
        metrics_registry.enabled = tracer.enabled = pulse.enabled = False

    # the counts add up: the HTTP batch, two warm ones and the resubmit
    metrics = final_snap["metrics"]

    def total(name):
        return sum(v["value"] for v in metrics[name]["values"])

    n_terminal = 3 * len(reqs) + 1
    check(total("serve.solves") == n_terminal,
          f"serve_observability: serve.solves {total('serve.solves')} of "
          f"{n_terminal}")
    check(total("serve.dead_letters") == n_dead,
          f"serve_observability: {total('serve.dead_letters')} dead "
          f"letters, {n_dead} kills")
    events = {}
    for v in metrics["slo.events"]["values"]:
        key = v["labels"]["objective"]
        events[key] = events.get(key, 0) + v["value"]
    check(set(events.values()) == {n_terminal},
          f"serve_observability: slo.events {events}, {n_terminal} "
          "terminal tenants")
    fired = {(t["objective"], t["severity"]) for t in engine.transitions
             if t["state"] == "firing"}
    check(("availability", "fast") in fired
          and not any(o == "lat" for o, _ in fired),
          f"serve_observability: alerts {sorted(fired)}")
    pm = json.loads((Path(tmp.name) / "slo.json").read_text())
    check(pm["reason"] == "slo-alert:availability"
          and {r["trace"] for r in pm["slo"]["bad_requests"]}
          <= set(traces.values()),
          f"serve_observability: postmortem {pm['reason']}")

    # the trace and the registry through the telemetry verb
    trace_path = Path(tmp.name) / "trace.json"
    metrics_path = Path(tmp.name) / "metrics.json"
    tracer.export_chrome(str(trace_path))
    metrics_registry.dump(str(metrics_path))
    names = {e.get("name") for e in tracer.events()}
    for span in ("serve.batch", "serve.assemble", "serve.dispatch",
                 "serve.solve", "serve.readback", "serve.queued",
                 "serve.request", "serve.result_ready"):
        check(span in names, f"serve_observability: no {span} span")
    # a capture inside a dispatch (the resubmit's batch of one, a new K
    # class, captures unless an earlier run of this process did) is its
    # own span, and marks the tenants that paid it
    check(("serve.cold_compile" in names) == bool(retry.get("cold_compile")),
          "serve_observability: serve.cold_compile span against the "
          f"resubmit's record {retry.get('cold_compile')}")
    verbs = {}
    for key, argv in (("validate", ["--validate", str(trace_path)]),
                      ("metrics", ["--metrics", str(metrics_path)])):
        t0 = time.perf_counter()
        run = subprocess.run([*PORT_CLI, "telemetry", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        verbs[key] = time.perf_counter() - t0
        check(run.returncode == 0 and "serve." in run.stdout,
              f"serve_observability: telemetry {key} rc {run.returncode}: "
              f"{run.stderr[-500:]}")
    tmp.cleanup()

    warm_seqs = [next(iter(s)) for s in seqs]
    out.update({
        "tenants": len(reqs), "killed": n_dead,
        "post_s": post_s, "http_batch_s": http_s,
        "plain_cold_s": plain_cold_s,
        "plain_cold_captures": plain_cold["captures"],
        # submit to the last tenant done: plain, instrumented,
        # instrumented, plain
        "warm_turns_s": [t[1] for t in turns],
        "warm_batch_span_s": [spans[s] for s in warm_seqs],
        "host_syncs": {"plain": plain_counts["host_syncs"],
                       "plain_server": turns[0][2]["host_syncs"],
                       "instrumented": counts["host_syncs"]},
        "launches": {"plain": plain_counts, "instrumented": counts},
        "phase_percentiles": slo_report["phase_percentiles"],
        "metrics_scrape_s": {"inside_batches": len(inside),
                             "median": statistics.median(inside),
                             "max": max(inside), "openmetrics": om_s,
                             "rounds": len(scraper.rounds)},
        "watch_s": watch_s, "telemetry_verb_s": verbs,
        "exemplar_trace_ids": len(ex_ids),
        "alerts": sorted(fired), "slo_events": events,
        "retry_cold_compile": bool(retry.get("cold_compile")),
        "phase_s": time.perf_counter() - t_phase,
    })
    emit(out)
    return counts



def _lines_until(proc, prefix, seen, timeout=300):
    """Read ``proc``'s stdout lines into ``seen`` on a thread of its own
    (the wait stays bounded) until one starts with ``prefix``; the rest
    of its output is drained there too, so the process never blocks on a
    full pipe."""
    import threading

    found = threading.Event()

    def read():
        for line in proc.stdout:
            if not found.is_set():
                seen.append(line.strip())
                if line.startswith(prefix):
                    found.set()

    threading.Thread(target=read, daemon=True).start()
    found.wait(timeout)
    return found.is_set()


def _fleet_series(snapshot, name):
    """{worker: value} of one ``worker``-labeled series of a federated
    snapshot."""
    return {v["labels"]["worker"]: v["value"]
            for v in snapshot["metrics"].get(name, {}).get("values", [])
            if "worker" in v["labels"]}


class _FleetWatch:
    """Scrapes a federated ``/metrics.json`` every 0.1 s on a thread of
    its own: ``fleet.worker_solves_total``, ``fleet.counter_resets_total``
    and ``fleet.worker_up`` by worker, with the host clock of each read."""

    def __init__(self, base):
        import threading

        self.base, self.rows, self.errors = base, [], []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop.wait(0.1):
            try:
                _, snap = _http_json(self.base + "/metrics.json", timeout=30)
            except Exception as e:  # noqa: BLE001 (checked after the run)
                self.errors.append(f"{type(e).__name__}: {e}")
                continue
            self.rows.append((time.perf_counter(), {
                name: _fleet_series(snap, name) for name in (
                    "fleet.worker_solves_total",
                    "fleet.counter_resets_total", "fleet.worker_up")}))

    def finish(self):
        self.stop.set()
        self.thread.join(timeout=60)
        check(not self.thread.is_alive() and not self.errors
              and len(self.rows) >= 10,
              f"serve_fleet_ha: the fleet verb's scrapes {len(self.rows)} "
              f"rows, errors {self.errors[:3]}")
        return self.rows


def _tenant_result(doc):
    """The fields of a ``/result`` document that a solve decides."""
    return tuple(doc.get(k) for k in ("status", "assignment", "cost",
                                      "violations", "cycles", "best_cost",
                                      "cycles_to_best"))


def phase_serve_fleet_ha():
    """The HA serve fleet on the card (``serve_fleet_ha``): ``python -m
    pydcop_tpu_torch router --spawn 2 --placement affinity`` with its two
    ``serve`` workers on the card, the serve grid's first
    ``SERVE_FLEET_TENANTS`` problems POSTed as the ``generate`` verb's
    YAML (``SERVE_FLEET_RUNS``: two affinity buckets).  Warm batch: the
    placement map is the port's ``tpu_part.distribute`` over the two
    buckets and each worker solved one serve bucket only;
    ``SERVE_FLEET_PROBES`` DSA problems POSTed to their worker and
    through the router, in turns, give the router's forward overhead.
    Failover: the same problems as new tenants, the MaxSum bucket's
    worker SIGKILLed as soon as its last tenant was forwarded (its
    tenants wait in the worker's window); every tenant
    ends ``done`` with its warm result bit for bit, the router failed
    over once and solved each tenant once in its history.  Federation:
    the ``fleet`` verb over both workers, scraped all along, keeps
    ``fleet.worker_solves_total`` monotone through the kill and the
    restart of the victim on its port (two more MaxSum tenants then land
    on it, warm results again) and counts a counter reset; ``watch
    --fleet --once --json`` shows both workers up.  SIGTERM drains the
    router (rc 0, its report) and its workers.  Every process the phase
    started is reaped, whether it passes or fails."""
    import os
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from pydcop_tpu_torch.computations_graph.objects import (
        ComputationGraph,
        ComputationNode,
    )
    from pydcop_tpu_torch.dcop.objects import AgentDef
    from pydcop_tpu_torch.distribution import tpu_part
    from pydcop_tpu_torch.serve.router import affinity_key

    t_phase = time.perf_counter()
    out = {"phase": "serve_fleet_ha"}
    tmp = tempfile.TemporaryDirectory()
    state = Path(tmp.name) / "state"
    procs, pids = [], []
    gen_pool = ThreadPoolExecutor(8)
    problems = SERVE_GRID[:SERVE_FLEET_TENANTS]
    texts = {g: gen_pool.submit(_generated_yaml, n, gen_seed)
             for g, n, gen_seed, _ in problems}
    algos = list(SERVE_FLEET_RUNS)

    def spec(i, tenant):
        g, _, _, seed = problems[i]
        algo = algos[i % 2]
        return {"dcop_yaml": texts[g].result(), "algo": algo,
                "params": SERVE_FLEET_RUNS[algo],
                "n_cycles": SERVE_FLEET_CYCLES, "seed": seed,
                "tenant": tenant}

    def timed_post(url, body):
        t0 = time.perf_counter()
        code, doc = _http_json(url, body)
        return code, doc, time.perf_counter() - t0

    def results(base, tenants, timeout=600):
        """Wait until the router holds every tenant's terminal result
        (its own cache: the record carries the tenant's history); the
        host clock at which each one was first seen done."""
        seen, deadline = {}, time.perf_counter() + timeout
        while len(seen) < len(tenants) and time.perf_counter() < deadline:
            _, st = _http_json(base + "/status")
            now = time.perf_counter()
            for t in tenants:
                if st["tenants"].get(t, {}).get("status") == "done":
                    seen.setdefault(t, now)
            time.sleep(0.02)
        check(len(seen) == len(tenants),
              f"serve_fleet_ha: tenants not done: "
              f"{sorted(set(tenants) - set(seen))[:4]}")
        return {t: _http_json(f"{base}/result/{t}")[1] for t in tenants}, seen

    router_err = open(Path(tmp.name) / "router.err", "w")
    try:
        router = subprocess.Popen(
            [*PORT_CLI, "--output", str(Path(tmp.name) / "router.json"),
             "router", *SERVE_FLEET_ROUTER, "--state-dir", str(state)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=router_err, text=True)
        procs.append(router)
        lines = []
        t0 = time.perf_counter()
        announced = _lines_until(router, "ROUTER_PORT=", lines)
        workers = {}
        for line in lines:
            if line.startswith("ROUTER_WORKER "):
                f = dict(kv.split("=", 1) for kv in line.split()[1:])
                workers[f["name"]] = (int(f["pid"]), int(f["port"]))
                pids.append(int(f["pid"]))
        check(announced and sorted(workers) == ["w0", "w1"],
              f"serve_fleet_ha: the router announced {lines}")
        base = f"http://127.0.0.1:{lines[-1].split('=', 1)[1]}"
        wurl = {w: f"http://127.0.0.1:{port}"
                for w, (_, port) in workers.items()}
        deadline = time.perf_counter() + 120
        while (_http_json(base + "/status")[1]["workers_up"] != 2
               and time.perf_counter() < deadline):
            time.sleep(0.05)
        out["router_up_s"] = time.perf_counter() - t0
        for w, url in wurl.items():
            _, st = _http_json(url + "/status")
            check(st["device"].startswith("cuda"),
                  f"serve_fleet_ha: {w} solves on {st['device']}")

        # 1. the warm batch: the first DSA tenant alone (the placement of
        # the first bucket), then the rest, four at a time
        order = [1] + [i for i in range(len(problems)) if i != 1]
        t0 = time.perf_counter()
        warm_posts = {}
        code, doc, _ = timed_post(base + "/solve", spec(1, "warm1"))
        warm_posts["warm1"] = (code, doc)
        with ThreadPoolExecutor(4) as pool:
            for i, answer in zip(order[1:], pool.map(
                    lambda i: timed_post(base + "/solve",
                                         spec(i, f"warm{i}")), order[1:])):
                warm_posts[f"warm{i}"] = answer[:2]
        for t, (code, doc) in warm_posts.items():
            check(code == 200 and doc["tenant"] == t,
                  f"serve_fleet_ha: POST {t}: {code} {doc}")
        warm_ids = [f"warm{i}" for i in range(len(problems))]
        warm, _ = results(base, warm_ids)
        out["warm_batch_s"] = time.perf_counter() - t0
        _, st = _http_json(base + "/status")
        buckets = st["placement"]["buckets"]
        keys = sorted({affinity_key(spec(i, "k")) for i in range(2)})
        graph = ComputationGraph(nodes=[ComputationNode(k, "bucket")
                                        for k in keys])
        dist = tpu_part.distribute(
            graph, [AgentDef(w, capacity=100.0) for w in sorted(workers)],
            communication_load=lambda _n, _m: 1.0)
        check(buckets == {k: dist.agent_for(k) for k in keys},
              f"serve_fleet_ha: placement {buckets}, tpu_part "
              f"{dist.mapping}")
        owner = {a: buckets[next(k for k in keys if k.startswith(a + "/"))]
                 for a in algos}
        served, cold = {}, {}
        for i, t in enumerate(warm_ids):
            check(warm_posts[t][1]["worker"] == owner[algos[i % 2]]
                  and warm[t]["status"] == "done",
                  f"serve_fleet_ha: {t} on {warm_posts[t][1]['worker']}, "
                  f"{warm[t]['status']}")
            _, row = _http_json(f"{wurl[owner[algos[i % 2]]]}/result/{t}")
            served.setdefault(owner[algos[i % 2]], set()).add(row["bucket"])
            if row.get("cold_compile"):
                cold.setdefault(owner[algos[i % 2]], set()).add(
                    row["batch_seq"])
        for w, url in wurl.items():
            _, st = _http_json(url + "/status")
            check(st["buckets"] == 1 and len(served.get(w, ())) == 1,
                  f"serve_fleet_ha: {w} solved buckets {served.get(w)}")
        check(not set.intersection(*served.values()),
              f"serve_fleet_ha: a bucket on both workers: {served}")
        out["placement"] = buckets
        out["graph_capturing_batches"] = {w: len(cold.get(w, ()))
                                          for w in sorted(workers)}
        out["batches"] = {w: _http_json(url + "/status")[1]["batches"]
                          for w, url in wurl.items()}

        # the router's forward: one DSA problem POSTed to its worker and
        # through the router, in turns
        walls = {"direct": [], "routed": []}
        for k in range(SERVE_FLEET_PROBES):
            for how, url in (("direct", wurl[owner["dsa"]]),
                             ("routed", base), ("routed", base),
                             ("direct", wurl[owner["dsa"]])):
                tid = f"probe-{how}{k}-{len(walls[how])}"
                code, _, wall = timed_post(url + "/solve", spec(1, tid))
                check(code == 200, f"serve_fleet_ha: probe {tid}: {code}")
                walls[how].append(wall)
        out["forward_walls_s"] = walls
        out["router_overhead_s"] = (statistics.median(walls["routed"])
                                    - statistics.median(walls["direct"]))

        # 2. the failover: the fleet verb and a scraper on it first
        fleet = subprocess.Popen(
            [*PORT_CLI, "fleet", "--port", "0", "--interval", "0.25",
             "--stale-after", "60", *[f"{w}={u}" for w, u in wurl.items()]],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        procs.append(fleet)
        lines = []
        check(_lines_until(fleet, "FLEET_PORT=", lines, timeout=120),
              f"serve_fleet_ha: the fleet verb announced {lines}")
        fleet_base = f"http://127.0.0.1:{lines[-1].split('=', 1)[1]}"
        watch = _FleetWatch(fleet_base)
        victim = owner["maxsum"]
        again = [f"again{i}" for i in range(len(problems))]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            posts = list(pool.map(
                lambda i: timed_post(base + "/solve", spec(i, again[i])),
                range(1, len(problems), 2)))
            posts += list(pool.map(
                lambda i: timed_post(base + "/solve", spec(i, again[i])),
                range(0, len(problems), 2)))
        os.kill(workers[victim][0], signal.SIGKILL)
        t_kill = time.perf_counter()
        for code, doc, _ in posts:
            check(code == 200, f"serve_fleet_ha: POST {code} {doc}")
        # the kill seen by the router's federated scrape
        down_s = None
        while time.perf_counter() - t_kill < 60:
            _, snap = _http_json(base + "/metrics.json")
            if _fleet_series(snap, "fleet.worker_up").get(victim) == 0.0:
                down_s = time.perf_counter() - t_kill
                break
            time.sleep(0.02)
        check(down_s is not None, "serve_fleet_ha: the victim never went "
              "down in the router's scrape")
        again_res, seen = results(base, again)
        histories = {t: [h["event"] for h in again_res[t]["history"]]
                     for t in again}
        victims = [t for t in again if "resolve-from-scratch" in
                   histories[t]]
        for i, t in enumerate(again):
            check(_tenant_result(again_res[t])
                  == _tenant_result(warm[f"warm{i}"]),
                  f"serve_fleet_ha: {t} is not warm{i}'s result")
            check(histories[t] in (["forward", "complete"],
                                   ["forward", "resolve-from-scratch",
                                    "forward", "complete"]),
                  f"serve_fleet_ha: {t}'s history {histories[t]}")
        _, st = _http_json(base + "/status")
        adm = st["admission"]
        check(victims and adm["failovers"] == 1 and adm["adopted"] == 0
              and adm["from_scratch"] == len(victims)
              and all(algos[int(t[5:]) % 2] == "maxsum" for t in victims),
              f"serve_fleet_ha: failover {adm}, victims {victims}")
        out.update({
            "again_batch_s": time.perf_counter() - t0,
            "victims": len(victims),
            "kill_to_worker_down_s": down_s,
            "kill_to_last_victim_done_s": max(seen[t] for t in victims)
            - t_kill,
            "admission": adm,
        })

        # 3. the victim restarted on its port; two more MaxSum tenants
        # land on it
        t0 = time.perf_counter()
        revived = subprocess.Popen(
            [*PORT_CLI, "serve", "--port", str(workers[victim][1]),
             "--window-ms", str(SERVE_FLEET_WINDOW_MS), "--checkpoint",
             str(state / victim)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        procs.append(revived)
        pids.append(revived.pid)
        lines = []
        check(_lines_until(revived, "SERVE_PORT=", lines, timeout=180),
              f"serve_fleet_ha: the restarted worker announced {lines}")
        while (_http_json(base + "/status")[1]["workers_up"] != 2
               and time.perf_counter() - t0 < 120):
            time.sleep(0.05)
        out["restart_to_up_s"] = time.perf_counter() - t0
        late = ["late0", "late2"]
        for t in late:
            code, doc, _ = timed_post(base + "/solve", spec(int(t[4:]), t))
            check(code == 200 and doc["worker"] == victim,
                  f"serve_fleet_ha: {t} {code} {doc}")
        late_res, _ = results(base, late)
        for t in late:
            check(_tenant_result(late_res[t])
                  == _tenant_result(warm[f"warm{t[4:]}"]),
                  f"serve_fleet_ha: {t} is not warm{t[4:]}'s result")
        # the fleet verb's counters stayed monotone and saw the reset
        deadline = time.perf_counter() + 30
        while (sum(watch.rows[-1][1]["fleet.counter_resets_total"].values())
               < 1 and time.perf_counter() < deadline):
            time.sleep(0.1)
        rows = watch.finish()
        for w in workers:
            series = [r["fleet.worker_solves_total"][w] for _, r in rows
                      if w in r["fleet.worker_solves_total"]]
            check(series and all(a <= b for a, b in zip(series,
                                                       series[1:])),
                  f"serve_fleet_ha: {w}'s worker_solves_total not "
                  f"monotone: {series[:3]}..{series[-3:]}")
            out.setdefault("worker_solves_total", {})[w] = series[-1]
        resets = rows[-1][1]["fleet.counter_resets_total"]
        check(resets.get(victim, 0) >= 1,
              f"serve_fleet_ha: counter resets {resets}")
        out["counter_resets"] = resets
        watch_run = subprocess.run(
            [*PORT_CLI, "watch", "--fleet", fleet_base, "--once", "--json"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        check(watch_run.returncode == 0,
              f"serve_fleet_ha: watch --fleet rc {watch_run.returncode}")
        seen_fleet = json.loads(watch_run.stdout)["status"]
        check(seen_fleet["workers_up"] == 2
              and sorted(seen_fleet["workers"]) == sorted(workers),
              f"serve_fleet_ha: watch --fleet {seen_fleet['workers_up']}")
        fleet.send_signal(signal.SIGTERM)
        check(fleet.wait(timeout=60) == 0, "serve_fleet_ha: fleet rc")

        # 4. the drain: the router first, then its workers
        t0 = time.perf_counter()
        router.send_signal(signal.SIGTERM)
        rc = router.wait(timeout=300)
        report = json.loads((Path(tmp.name) / "router.json").read_text())
        check(rc == 0 and report["drained"] and report["tenant_counts"]
              == {"done": 2 * len(problems) + len(late)
                  + SERVE_FLEET_PROBES * 2},
              f"serve_fleet_ha: router rc {rc}, {report['tenant_counts']}")
        check(revived.wait(timeout=120) == 0,
              "serve_fleet_ha: the restarted worker's drain")
        out["drain_s"] = time.perf_counter() - t0
    except BaseException:
        router_err.flush()
        print("serve_fleet_ha: the router's stderr ends with:\n"
              + (Path(tmp.name) / "router.err").read_text()[-3000:],
              file=sys.stderr)
        raise
    finally:
        gen_pool.shutdown()
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        router_err.close()
        tmp.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--against", type=Path, nargs="+", default=[],
        help="checkouts of other commits whose kernels to time against",
    )
    # the replay phase's process to kill (not for direct use)
    ap.add_argument("--replay-child", default=None, help=argparse.SUPPRESS)
    # the config-4 fault schedule's process to kill (not for direct use)
    ap.add_argument("--fault-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_script = time.perf_counter()
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
    if args.replay_child:
        _replay_child(args.replay_child)
        return 1  # not reached: the child kills itself
    if args.fault_child:
        _fault_child(args.fault_child)
        return 1  # not reached: the schedule kills the child
    from pydcop_tpu_torch.commands.generators.ising import (
        generate_ising_arrays,
    )
    from pydcop_tpu_torch.interop import compiled_from_numpy

    smi = phase_device()
    phase_build()
    c4 = generate(CONFIG_4["gen"])
    t0 = time.perf_counter()
    c6 = generate(CONFIG_6["gen"])
    emit({"phase": "config6_problem", "seconds": time.perf_counter() - t0,
          "n_vars": c6.n_vars, "n_edges": c6.n_edges})
    breakout = breakout_problems()
    rows, timed_sets = phase_kernels(c4, c6, breakout["config7"])
    batched_rows, batched_sets = batched_kernel_rows()
    rows.update(batched_rows)
    timed_sets.update(batched_sets)
    for other in args.against:
        phase_against(other.resolve(), timed_sets)
    del timed_sets

    def counts(minplus=None, ell=False, maxsum=False, damp=False):
        """(launches an iteration, launches in the prologue) by kernel of
        a solve: ``minplus`` once an iteration (MaxSum's factor step),
        xla_tree_sum once a sum site: every evaluate (the prologue
        evaluates the initial assignment), MaxSum's sum over the domain
        in its variable step and, on the ELL layout, its fan-in; and
        damp_fma twice (``damp``: MaxSum's float32 planes, both damped
        in the FMA form)."""
        per_cycle = {
            "ell_minplus": 0, "factor_arity2_minplus": 0,
            "xla_tree_sum": 1 + maxsum + ell, "damp_fma": 2 * damp,
        }
        if minplus:
            per_cycle[minplus] = 1
        return per_cycle, {"xla_tree_sum": 1}

    def maxsum_run(spec, layout, precision="f32"):
        params = dict(spec["params"], layout=layout)
        if precision != "f32":
            params["precision"] = precision
        return ("maxsum", params, spec["n_cycles"], spec["seed"])

    def maxsum_phase(name, compiled, run, minplus, cpu_bar="cost", **kw):
        per_cycle, per_start = counts(
            minplus, ell=run[1]["layout"] == "ell", maxsum=True,
            damp=run[1].get("precision", "f32") == "f32",
        )
        return phase_solve(name, compiled, run, per_cycle,
                           per_start=per_start, cpu_bar=cpu_bar, **kw)

    # the main path: MaxSum at config 4 on the ELL layout
    ell4, warm = maxsum_phase(
        "maxsum_100k", c4, maxsum_run(CONFIG_4, "ell"), "ell_minplus",
        recorded=MAXSUM_RECORDED["config4"], profile=True,
    )
    rows["ell_minplus"]["launches"] = warm["ell_minplus"]
    rows["xla_tree_sum"]["launches"] = warm["xla_tree_sum"]
    rows["damp_fma"]["launches"] = warm["damp_fma"]
    phase_fma("fma_config4", c4, CONFIG_4, MAXSUM_RECORDED["config4"],
              planes_vs_cpu=True)
    _, warm = maxsum_phase(
        "maxsum_100k_pallas", c4, maxsum_run(CONFIG_4, "pallas"),
        "factor_arity2_minplus", recorded=MAXSUM_RECORDED["config4"],
        against=ell4,
    )
    rows["factor_arity2_minplus"]["launches"] = warm["factor_arity2_minplus"]
    # bench config 6: the main path at 1,000,000 variables, gated on the
    # JAX package's result
    c6_ref, _ = maxsum_phase(
        "maxsum_1m", c6, maxsum_run(CONFIG_6, "ell"), "ell_minplus",
        cpu_bar="exact", recorded=MAXSUM_CONFIG6_JAX,
    )
    phase_fma("fma_config6", c6, CONFIG_6, MAXSUM_CONFIG6_JAX,
              planes_vs_cpu=False)
    t_memory = time.perf_counter()
    memory = phase_memory(c4, c6)
    emit({"phase": "memory_seconds",
          "seconds": time.perf_counter() - t_memory})
    t_durable = time.perf_counter()
    phase_durable_config6(c6, c6_ref)
    new_phases_s = time.perf_counter() - t_durable
    del c6, c6_ref
    c2 = generate(CONFIG_2["gen"])
    ell2, _ = maxsum_phase(
        "maxsum_1k", c2, maxsum_run(CONFIG_2, "ell"), "ell_minplus",
        recorded=MAXSUM_RECORDED["config2"],
    )
    for layout, kernel in (("lanes", "factor_arity2_minplus"),
                           ("edges", None)):
        maxsum_phase(
            f"maxsum_1k_{layout}", c2, maxsum_run(CONFIG_2, layout), kernel,
            recorded=MAXSUM_RECORDED["config2"], against=ell2,
        )
    # "auto" must resolve to lanes here: the kernel counts show it
    mixed = compiled_from_numpy(mixed_problem_fields())
    per_cycle, per_start = counts("factor_arity2_minplus", maxsum=True,
                                  damp=True)
    phase_solve(
        "maxsum_mixed", mixed, maxsum_run(MIXED, "auto"), per_cycle,
        per_start=per_start, cpu_bar="cost",
        recorded=MAXSUM_RECORDED["mixed"], recorded_rel=1e-5,
    )
    # MaxSum's bf16 planes through both kernels: the JAX package's costs,
    # and the CPU's assignment
    _, warm = maxsum_phase(
        "maxsum_100k_bf16", c4, maxsum_run(CONFIG_4, "ell", "bf16"),
        "ell_minplus", cpu_bar="exact",
        recorded=MAXSUM_BF16_JAX["config4_ell"],
    )
    rows["ell_minplus_bf16"]["launches"] = warm["ell_minplus"]
    _, warm = maxsum_phase(
        "maxsum_100k_pallas_bf16", c4,
        maxsum_run(CONFIG_4, "pallas", "bf16"), "factor_arity2_minplus",
        cpu_bar="exact", recorded=MAXSUM_BF16_JAX["config4_pallas"],
    )
    rows["factor_arity2_minplus_bf16"]["launches"] = warm[
        "factor_arity2_minplus"
    ]
    for layout, kernel in (("ell", "ell_minplus"),
                           ("lanes", "factor_arity2_minplus"),
                           ("edges", None)):
        maxsum_phase(
            f"maxsum_1k_bf16_{layout}", c2,
            maxsum_run(CONFIG_2, layout, "bf16"), kernel, cpu_bar="exact",
            recorded=MAXSUM_BF16_JAX["config2"],
        )
    # the local-search solvers: xla_tree_sum (evaluate) on their path
    problems = {
        "config4": c4, "mixed": mixed,
        "config3": generate_ising_arrays(*CONFIG_3["gen"]),
    }
    per_cycle, per_start = counts()
    for name, algo, problem, params, n_cycles, seed in LOCAL_SEARCH:
        phase_solve(
            name, problems[problem], (algo, params, n_cycles, seed),
            per_cycle, per_start=per_start,
        )
    # the mixed and breakout solvers and the hard colorings: identical to
    # the CPU and to the JAX package's pinned results
    problems.update(breakout)
    for name, algo, problem, params, n_cycles, seed, pinned in BREAKOUT:
        phase_solve(
            name, problems[problem], (algo, params, n_cycles, seed),
            per_cycle, per_start=per_start, recorded=pinned,
            recorded_values=(
                DSA_HARD80_JAX_VALUES if name == "dsa_hard80" else None
            ),
        )
    # A-DSA, DSA-tuto and A-MaxSum (edges layout: its domain sum is a
    # second xla_tree_sum an iteration)
    for name, algo, params, pinned in ASYNC:
        per_cycle, per_start = counts(maxsum=algo == "amaxsum",
                                      damp=algo == "amaxsum")
        cold, _ = phase_solve(
            name, c4, (algo, params, 30, 7), per_cycle, per_start=per_start,
            recorded=pinned,
        )
        check(cold.msg_count == ASYNC_MSG_COUNT,
              f"{name}: {cold.msg_count} messages")
    phase_timeouts(c4, ell4)
    t_new = time.perf_counter()
    phase_pulse_config4(c4)
    phase_durable_config4(c4)
    new_phases_s += time.perf_counter() - t_new
    t_fault = time.perf_counter()
    phase_fault_kill_resume_config4(c4)
    fault_s = time.perf_counter() - t_fault
    del c4, c2, mixed, problems, breakout
    dynamic = phase_dynamic_config4()
    rows["factor_arity2_minplus"]["dynamic_launches"] = dynamic[
        "factor_arity2_minplus"]
    rows["damp_fma"]["dynamic_launches"] = dynamic["damp_fma"]
    rows["branch_bound"]["launches"] = phase_branch_bound()
    try:
        import yaml  # noqa: F401  (the YAML loader's one dependency)
    except ImportError as e:
        emit({"phase": "front_door_yaml", "skipped": f"no PyYAML: {e}"})
    else:
        readme = phase_front_door_yaml()
        t_new = time.perf_counter()
        phase_kill_resume_cli()
        new_phases_s += time.perf_counter() - t_new
        profiled = phase_profile_capture(readme)
        for name, n in profiled.items():
            rows[name]["profile_launches"] = n
    emit({"phase": "pulse_durability_seconds", "seconds": new_phases_s})
    phase_front_door_objects()
    phase_dpop_config5()
    phase_dpop_wide()
    # the serving path: bench config 8, the kernels batched under load,
    # the server and its HTTP front
    t_serve = time.perf_counter()
    serve8 = phase_serve_config8()
    grid = phase_serve_maxsum_grid()
    phase_serve_server()
    emit({"phase": "serve_seconds", "seconds": time.perf_counter() - t_serve})
    # serving with pulse and fleet checkpoints, the scenario replay, the
    # CLI's spans
    t_new = time.perf_counter()
    serve_pulse = phase_serve_pulse()
    phase_serve_fleet_checkpoint()
    phase_replay_session()
    phase_trace_cli()
    emit({"phase": "serve_replay_trace_seconds",
          "seconds": time.perf_counter() - t_new})
    # the generate verb, its problems solved, process kills through the
    # CLI and the server's fault schedule
    t_new = time.perf_counter()
    phase_generate_verb()
    generated = phase_generated_solves(counts)
    phase_fault_kill_resume_cli()
    phase_serve_fault_schedule()
    emit({"phase": "generate_fault_seconds",
          "seconds": time.perf_counter() - t_new + fault_s})
    # serving's live surface: metrics, traces, SLOs, watch and telemetry
    observability = phase_serve_observability()
    # the HA fleet: the router verb, its two card workers, a failover
    phase_serve_fleet_ha()
    rows["ell_minplus_batched"]["launches"] = grid["f32"][
        "ell_minplus_batched"]
    rows["ell_minplus_bf16_batched"]["launches"] = grid["bf16"][
        "ell_minplus_batched"]
    for name in BATCHED_ROWS[2:5]:
        rows[name]["launches"] = grid["f32"]["xla_tree_sum_batched"]
    rows["damp_fma_batched"]["launches"] = grid["f32"]["damp_fma_batched"]
    batched = {
        "ell_minplus": grid["f32"]["ell_minplus_batched"],
        "ell_minplus_bf16": grid["bf16"]["ell_minplus_batched"],
        "xla_tree_sum": grid["f32"]["xla_tree_sum_batched"]
        + serve8["xla_tree_sum_batched"],
        "damp_fma": grid["f32"]["damp_fma_batched"]
        + serve_pulse["maxsum_grid"]["damp_fma_batched"],
    }
    for name, row in rows.items():
        # the serve_observability batch is float32: its batched launches,
        # xla_tree_sum's three sum sites on one count as in grid's rows
        row["observability_launches"] = observability.get(
            "xla_tree_sum_batched" if name in BATCHED_ROWS[2:5]
            else name if name in BATCHED_ROWS else f"{name}_batched", 0)
        row["generated_launches"] = generated.get(name, 0)
        row["memory_launches"] = memory.get(name, 0)
        row["batched_launches"] = (
            row["launches"] if name in BATCHED_ROWS
            else batched.get(name, 0)
        )
        check(row["launches"], f"{name}: no launch on its path")
    emit({"phase": "script", "seconds": time.perf_counter() - t_script})
    emit({"kernels": [rows[name] for name in KERNEL_ROWS + BATCHED_ROWS]})
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
