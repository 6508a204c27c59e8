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
  path, against the JAX package's results pinned here.

Each solve of the cycle engine runs cold (it captures its graphs) and warm (it must capture
nothing), is checked against the same solve on the CPU, and counts from
zero each kernel's launches (launches an iteration times the iterations
its graphs replayed), its replays and its host syncs (O(log n_cycles)).
Every solve also launches the port's own kernel ``xla_tree_sum``: the
anytime-best total of ``evaluate`` (and MaxSum's ELL fan-in and sum over
the domain) summed in XLA-CPU's order, one launch a sum site.  It prints
one JSON object per phase, then the kernel table (five rows: both TPU kernels
with a float32 and with a bf16 plane, and ``xla_tree_sum``), the card's
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
ENGINE_COUNTERS = ("captures", "replays", "iterations", "host_syncs")
# the rows of the kernel table: both TPU kernels with a float32 and with a
# bf16 message plane, and the port's own tree sum
KERNEL_ROWS = ("ell_minplus", "ell_minplus_bf16", "factor_arity2_minplus",
               "factor_arity2_minplus_bf16", "xla_tree_sum")
# the kernel wrappers of compile/hopper_kernels.py, each with a launch count
KERNEL_WRAPPERS = ("ell_minplus", "factor_arity2_minplus", "xla_tree_sum")
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
    6 and 7.  Each timed at the main path's shape.  Returns the
    kernel rows by name and, by kernel, the config-4 operand sets the
    float32 min-plus kernels were timed on."""
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
    rows["xla_tree_sum"] = _tree_sum_row(c4, c6, c7)
    emit({"phase": "kernel_row", **rows["xla_tree_sum"]})
    emit({"phase": "fan_in", **fan_in_check(c4)})
    return rows, timed_sets


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
    another order), and config 4's evaluate, fan-in and domain sum, each
    beside its plain version and its bound."""
    import torch

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
    sites = {
        "evaluate": (hk.tree_evaluate, hk.tree_evaluate_plain, {
            name: functools.partial(evaluate_inputs, c, "cuda", 7)
            for name, c in (("config4", c4), ("config6", c6),
                            ("config7", c7))
        }),
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
    timed = {
        "evaluate": (hk.tree_evaluate, hk.tree_evaluate_plain, None,
                     [evaluate_inputs(c4, "cuda", s) for s in range(4)],
                     evaluate_bytes_ops),
        "fan_in": (_fan_in_call, _fan_in_plain, None,
                   [fan_in_inputs(ell4.spans, ell4.n_pad, 3, "cuda", s)
                    for s in range(4)], fan_in_bytes_ops),
        "domain_sum": (
            _domain_sum_call, _domain_sum_plain,
            lambda x: torch.sum(x, 0, keepdim=True),
            [fan_in_inputs(ell4.spans, ell4.n_pad, 3, "cuda", s)[:1]
             for s in range(4)],
            lambda a: (a[0].numel() * 4 + a[0].shape[1] * 4, a[0].numel()),
        ),
    }
    extra = {}
    for site, (call, plain, library, site_sets, bytes_ops) in timed.items():
        _one_launch(site, call, site_sets[0])
        site_bytes, site_ops = bytes_ops(site_sets[0])
        bound_ms, bound_by = _bound(site_bytes, site_ops)
        extra[f"{site}_config4"] = {
            "ms": time_cuda_ms(call, site_sets),
            "plain_ms": time_cuda_ms(plain, site_sets),
            "library_ms": (
                time_cuda_ms(library, site_sets) if library else None
            ),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": site_bytes, "launches_per_call": 1,
        }
    return _kernel_row(
        "xla_tree_sum", "xla_tree_sum",
        "none: the port's own kernel (evaluate's totals in XLA-CPU's order)",
        max_err, kernel_ms, plain_ms, nbytes, ops, library_ms=library_ms,
        n=n_total, launches_per_call=launches_per_call, **extra,
    )


def _launcher(library, name):
    """A wrapper of another build's ``<name>_launch`` with this
    checkout's calling convention: outputs allocated like the port's
    wrappers allocate them, launched on the current stream."""
    import ctypes

    import torch

    from pydcop_tpu_torch.compile import hopper_kernels as hk

    fn = getattr(ctypes.CDLL(str(library)), f"{name}_launch")
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


def phase_against(other: Path, timed_sets):
    """Another checkout's float32 min-plus kernels (built from ``other``)
    against this one's on the same config-4 operand sets: equal outputs,
    then times in turns, theirs, ours, ours, theirs."""
    import torch

    from pydcop_tpu_torch.compile import _build
    from pydcop_tpu_torch.compile import hopper_kernels as hk

    pkg = other / "pydcop_tpu_torch"
    t0 = time.perf_counter()
    libs = _build.build_all(
        list(timed_sets), csrc=pkg / "csrc", build_dir=pkg / "_build"
    )
    build_s = time.perf_counter() - t0
    for name, sets in timed_sets.items():
        theirs, ours = _launcher(libs[name], name), getattr(hk, name)
        got, want = theirs(*sets[0]), ours(*sets[0])
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        check(
            all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{name}: {other}'s kernel differs from this one's",
        )
        order = [("theirs", theirs), ("ours", ours), ("ours", ours),
                 ("theirs", theirs)]
        times = {"theirs": [], "ours": []}
        for who, fn in order:
            times[who].append(time_cuda_ms(fn, sets))
        emit({
            "phase": "against", "kernel": name, "other": str(other),
            "build_s": build_s, "equal": True, "order": [w for w, _ in order],
            "theirs_ms": times["theirs"], "ours_ms": times["ours"],
            "speedup": statistics.mean(times["theirs"])
            / statistics.mean(times["ours"]),
        })


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
    ``factor_arity2_minplus``."""
    import tempfile

    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.api import solve_result
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop_from_file

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        n, d, kw = README_PROBLEM
        readme = Path(tmp) / "gc1000.yaml"
        readme.write_text(dcop_yaml(generate_graph_coloring(n, d, **kw)))
        write_s = time.perf_counter() - t0
        files = [ROOT / f for f in FRONT_DOOR_YAML] + [readme]
        for path in files:
            t0 = time.perf_counter()
            cli = subprocess.run(
                [sys.executable, "-m", "pydcop_tpu_torch", "solve",
                 *FRONT_DOOR_ARGS, str(path)],
                cwd=ROOT, capture_output=True, text=True, timeout=900,
            )
            cli_s = time.perf_counter() - t0
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--against", type=Path, nargs="+", default=[],
        help="checkouts of other commits whose kernels to time against",
    )
    args = ap.parse_args()
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
    for other in args.against:
        phase_against(other.resolve(), timed_sets)
    del timed_sets

    def counts(minplus=None, ell=False, maxsum=False):
        """(launches an iteration, launches in the prologue) by kernel of
        a solve: ``minplus`` once an iteration (MaxSum's factor step), and
        xla_tree_sum once a sum site: every evaluate (the prologue
        evaluates the initial assignment), MaxSum's sum over the domain
        in its variable step and, on the ELL layout, its fan-in."""
        per_cycle = {
            "ell_minplus": 0, "factor_arity2_minplus": 0,
            "xla_tree_sum": 1 + maxsum + ell,
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
            minplus, ell=run[1]["layout"] == "ell", maxsum=True
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
    _, warm = maxsum_phase(
        "maxsum_100k_pallas", c4, maxsum_run(CONFIG_4, "pallas"),
        "factor_arity2_minplus", recorded=MAXSUM_RECORDED["config4"],
        against=ell4,
    )
    rows["factor_arity2_minplus"]["launches"] = warm["factor_arity2_minplus"]
    # bench config 6: the main path at 1,000,000 variables, gated on the
    # JAX package's result
    maxsum_phase(
        "maxsum_1m", c6, maxsum_run(CONFIG_6, "ell"), "ell_minplus",
        cpu_bar="exact", recorded=MAXSUM_CONFIG6_JAX,
    )
    del c6
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
    per_cycle, per_start = counts("factor_arity2_minplus", maxsum=True)
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
    phase_timeouts(c4, ell4)
    del c4, c2, mixed, problems, breakout
    try:
        import yaml  # noqa: F401  (the YAML loader's one dependency)
    except ImportError as e:
        emit({"phase": "front_door_yaml", "skipped": f"no PyYAML: {e}"})
    else:
        phase_front_door_yaml()
    phase_front_door_objects()
    phase_dpop_config5()
    phase_dpop_wide()
    for name, row in rows.items():
        check(row["launches"], f"{name}: no launch on its path")
    emit({"kernels": [rows[name] for name in KERNEL_ROWS]})
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
