"""Per-op attribution of the solver's hot cycles.

Counterpart of ``pydcop_tpu/telemetry/kernelprof.py``: the ``kernel``
block of a capture record (``tools/capture_configs.py``) decomposes a
cycle per op, so a record carries not just "the ELL cycle took X ms" but
where inside the cycle the time goes and how far each op sits from the
memory roofline:

- :func:`ell_kernel_block`: the MaxSum ELL cycle as growing prefix
  programs of the calls the port's real step makes (the factor step, then
  the variable step), each op charged the wall its addition costs, with
  JAX's analytic minimum bytes per op.  The port's ``ell_minplus`` kernel
  does JAX's first two ops, the pair-permutation gather and the min-plus
  marginalization, in one launch: the ``minplus`` row carries both
  (``fused``), and the ``pair_gather`` row is charged no time
  (``fused_into``), with a plain torch gather's time beside it for
  reference.  ``attributed_pct`` compares the prefix composition with
  the real step (``factor_step_ell`` + ``variable_step_with_select_ell``,
  the hand-written kernels).  The ``ell_minplus`` sub-block times the
  kernel against the plain torch factor on the same inputs.
- :func:`mgm2_phase_block`: the five MGM-2 phases (value, offer,
  response, gain, go; ``algorithms/mgm2.py``) run one at a time, each
  under ``device_annotation("solve.mgm2.<phase>")`` and each observed in
  ``device.chunk_ms{phase="mgm2.<phase>", kind="phase"}``.

Timing: on the card each program is captured into a CUDA graph (after a
warm-up on a side stream) and timed by CUDA events over back-to-back
replays, the median of five rounds; on the CPU by the host clock, the
median of ``reps`` calls.  A block that cannot be built degrades to
``{"skipped": ...}`` and counts ``kernelprof.degraded{reason}``.

Module-level imports are stdlib and sibling telemetry only; torch is
imported inside the functions (host-only verbs import this package).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from .memplane import DEVICE_GENERATIONS
from .metrics import metrics_registry
from .profiling import device_annotation

__all__ = [
    "device_platform", "hbm_peak_gbps", "ell_kernel_block",
    "mgm2_phase_block",
]

#: advertised HBM bandwidth by card (GB/s), matched by substring of
#: ``torch.cuda.get_device_name`` in lower case: the memory plane's table
#: (``memplane.DEVICE_GENERATIONS``), so a card is added in one place
HBM_PEAK_GBPS = tuple(
    (kind, gbps) for kind, gbps, _capacity in DEVICE_GENERATIONS
)

#: rounds of back-to-back replays a program is timed over on the card
_ROUNDS = 5


def _count_degraded(reason: str) -> None:
    """A kernel block degraded to ``{"skipped"/"error"}``: count it, so
    the capture verb can warn instead of shipping an under-instrumented
    bundle."""
    metrics_registry.counter("kernelprof.degraded").inc(reason=reason)


def hbm_peak_gbps(device: Any = None) -> Optional[float]:
    """The card's advertised HBM peak, or None on the CPU (a CPU "peak"
    would turn the roofline columns into fiction) and for a card the
    table does not know.  ``device``: where the record ran (default: the
    card when there is one)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(0).lower()
    for key, peak in HBM_PEAK_GBPS:
        if key in kind:
            return peak
    return None


def device_platform(device) -> str:
    """A record's device name, as JAX names its platforms: "gpu" for a
    card, "cpu"."""
    return "gpu" if device.type == "cuda" else device.type


def _median_ms(fn: Callable[[], Any], reps: int, device) -> float:
    """Median wall of one call of the nullary device closure ``fn``: on
    the card its CUDA graph's replays between CUDA events (``_ROUNDS``
    rounds of ``reps`` replays), on the CPU ``reps`` host-clock calls
    after one untimed warm-up."""
    import torch

    reps = max(1, int(reps))
    if device.type == "cuda":
        from ..algorithms.base import _side_stream

        with _side_stream(device):
            fn()
        # a capture of its own: not the engine's (no census, no dump)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize(device)
        rounds = []
        for _ in range(_ROUNDS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                graph.replay()
            end.record()
            torch.cuda.synchronize(device)
            rounds.append(start.elapsed_time(end) / reps)
        del graph
        rounds.sort()
        return rounds[len(rounds) // 2]
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return 1e3 * times[len(times) // 2]


def _op_entry(ms: float, nbytes: int, step_ms: float) -> Dict[str, Any]:
    return {
        "ms": round(ms, 4),
        "bytes": int(nbytes),
        "gbps": round(nbytes / ms / 1e6, 2) if ms > 0 else None,
        "share_pct": round(100.0 * ms / step_ms, 1) if step_ms > 0 else None,
    }


def ell_kernel_block(
    compiled, reps: int = 20, device="cuda",
) -> Dict[str, Any]:
    """Per-op decomposition of one MaxSum ELL cycle on ``device``.

    Times the growing prefix programs of the real step (the factor step,
    then the variable step) and the real step itself, and charges each op
    its marginal wall; returns ``{"layout": "ell", "skipped": reason}``
    for problems the ELL layout cannot represent.  The acceptance bar is
    that the composition attributes 90-110% of the real step."""
    if compiled.n_edges == 0:
        _count_degraded("no edges")
        return {"layout": "ell", "skipped": "no edges"}
    if any(b.arity != 2 for b in compiled.buckets):
        _count_degraded("non-binary constraints")
        return {"layout": "ell", "skipped": "non-binary constraints"}
    import numpy as np
    import torch

    from ..algorithms.base import cached_const
    from ..algorithms.maxsum import _ell_dev_arrays
    from ..compile.hopper_kernels import ell_minplus_plain
    from ..compile.kernels import (
        build_ell,
        factor_step_ell,
        resolve_device,
        variable_step_with_select_ell,
    )

    device = resolve_device(device)
    ell = cached_const(compiled, ("ell_host",), lambda: build_ell(compiled))
    d = int(compiled.max_domain)
    s = int(np.dtype(compiled.float_dtype).itemsize)
    n_pad = int(ell.n_pad)
    v_ell = int(ell.valid_ell_t.shape[1])
    (pair_perm, tabs_t, pos_of_var, edge_valid_t, valid_ell_t,
     dsize_edges, real_row, var_perm) = _ell_dev_arrays(compiled, ell, device)
    unary_ell_t = torch.as_tensor(
        np.ascontiguousarray(
            np.asarray(compiled.unary, dtype=compiled.float_dtype)[
                ell.var_perm
            ].T
        ),
        device=device,
    )
    rng = np.random.default_rng(7)
    v2f = torch.as_tensor(
        np.where(ell.real_row, rng.normal(size=(d, n_pad)), 0.0).astype(
            compiled.float_dtype
        ),
        device=device,
    )
    gather_idx = pair_perm.long()

    def _factor(v):
        return factor_step_ell(tabs_t, pair_perm, real_row, v)

    def _var(f2v):
        return variable_step_with_select_ell(
            ell.spans, unary_ell_t, valid_ell_t, edge_valid_t,
            dsize_edges, pos_of_var, real_row, f2v,
        )

    # the prefixes: the factor step (gather + min-plus in one launch),
    # then factor + variable step; the real step is timed on its own
    plane = d * n_pad * s
    gather_b = 2 * plane + 4 * n_pad
    minplus_b = d * d * n_pad * s + 2 * plane + n_pad
    var_b = 2 * plane + d * v_ell * (s + 1) + d * n_pad + n_pad * s

    def real_step():
        return _var(factor_step_ell(tabs_t, pair_perm, real_row, v2f))

    step_ms = _median_ms(real_step, reps, device)
    if device.type == "cpu" and step_ms < 5.0:
        # host-clock jitter swamps a short step's median: more reps
        reps = max(reps, 100)
        step_ms = _median_ms(real_step, reps, device)
    t_gather = _median_ms(lambda: v2f.index_select(1, gather_idx), reps,
                          device)
    t_factor = _median_ms(lambda: _factor(v2f), reps, device)
    t_full = _median_ms(lambda: _var(_factor(v2f)), reps, device)
    minplus_ms = t_factor
    var_ms = max(0.0, t_full - t_factor)

    # the per-solve packed read-back: the port's [final | best | 4
    # status words] int32 vector, one device-to-host copy of its size
    rb_bytes = 4 * (2 * compiled.n_vars + 4)
    packed = torch.ones(rb_bytes // 4, dtype=torch.int32, device=device)
    rb_times = []
    for _ in range(max(3, reps // 4)):
        t0 = time.perf_counter()
        packed.cpu()
        rb_times.append(time.perf_counter() - t0)
    rb_times.sort()
    rb_ms = 1e3 * rb_times[len(rb_times) // 2]

    attributed = minplus_ms + var_ms
    traffic = gather_b + minplus_b + var_b
    gather_row = _op_entry(0.0, gather_b, step_ms)
    gather_row.update(
        fused_into="minplus", plain_gather_ms=round(t_gather, 4)
    )
    minplus_row = _op_entry(minplus_ms, minplus_b, step_ms)
    minplus_row["fused"] = ["pair_gather"]
    block: Dict[str, Any] = {
        "layout": "ell",
        "device": device_platform(device),
        "d": d,
        "n_pad": n_pad,
        "step_ms": round(step_ms, 4),
        "ops": {
            "pair_gather": gather_row,
            "minplus": minplus_row,
            "variable_step": _op_entry(var_ms, var_b, step_ms),
            "readback": {
                "ms": round(rb_ms, 4),
                "bytes": int(rb_bytes),
                "per_solve": True,  # not part of the per-cycle share
            },
        },
        "attributed_pct": (
            round(100.0 * attributed / step_ms, 1) if step_ms > 0 else None
        ),
        "traffic_bytes_per_cycle": int(traffic),
        "achieved_gbps": (
            round(traffic / step_ms / 1e6, 2) if step_ms > 0 else None
        ),
        "peak_gbps": hbm_peak_gbps(device),
    }
    if block["peak_gbps"] and block["achieved_gbps"]:
        block["hbm_peak_pct"] = round(
            100.0 * block["achieved_gbps"] / block["peak_gbps"], 2
        )
    # the hand-written kernel against the plain torch factor on the same
    # inputs (on the CPU the wrapper runs the plain version)
    plain_ms = _median_ms(
        lambda: ell_minplus_plain(v2f, pair_perm, tabs_t, real_row),
        reps, device,
    )
    cuda = device.type == "cuda"
    block["ell_minplus"] = {
        "kernel": cuda,
        "kernel_ms": round(t_factor, 4) if cuda else None,
        "plain_ms": round(plain_ms, 4),
        "speedup": (
            round(plain_ms / t_factor, 2) if cuda and t_factor > 0 else None
        ),
    }
    return block


def mgm2_phase_block(
    compiled, reps: int = 10, seed: int = 0, device="cuda",
) -> Dict[str, Any]:
    """Wall decomposition of one MGM-2 cycle over its five protocol
    phases, run one at a time at a mid-run state (one cycle in: cycle 0
    has degenerate gains), each under a device annotation and observed in
    ``device.chunk_ms{phase="mgm2.<phase>", kind="phase"}`` while the
    metrics registry is on."""
    import torch

    from ..algorithms import mgm2
    from ..algorithms.base import device_problem, neighbor_pairs_dev
    from ..compile.kernels import resolve_device
    from ..random import PRNGKey, fold_in, split

    device = resolve_device(device)
    dev = device_problem(compiled, device, "mgm2")
    consts = neighbor_pairs_dev(compiled, device) + mgm2._offers_dev(
        compiled, dev
    )
    has_pairs = bool(consts[2].shape[0])
    has_dyn = bool(consts[9].shape[0])
    threshold, favor = 0.5, "unilateral"  # the default params
    key = torch.tensor(PRNGKey(seed), dtype=torch.int64, device=device)
    step = mgm2._make_step(threshold, favor, has_pairs, has_dyn)
    state = mgm2._init(dev, key, *consts)
    state = step(dev, state, fold_in(key, 1), *consts)
    k_role, k_offer, k_accept, k_tb = split(fold_in(key, 2), 4)

    values = state.values
    costs, current, solo_gain, solo_cand = mgm2._phase_value(dev, values)
    partner = torch.full(
        (dev.n_vars,), -1, dtype=torch.int32, device=values.device
    )
    pair_val = values
    pair_gain_v = torch.zeros_like(solo_gain)
    thunks = {"value": lambda: mgm2._phase_value(dev, values)}
    if has_pairs:
        def offer():
            return mgm2._phase_offer(
                dev, state, k_role, k_offer, costs, current,
                threshold, has_dyn,
            )

        chosen, offer_gain, off_x, off_y = offer()

        def response():
            return mgm2._phase_response(
                dev, state, k_accept, chosen, offer_gain, off_x, off_y,
                solo_gain,
            )

        partner, pair_val, pair_gain_v = response()
        thunks["offer"] = offer
        thunks["response"] = response

    def gain():
        return mgm2._phase_gain(
            dev, state, k_tb, solo_gain, pair_gain_v, partner, favor
        )

    committed, win = gain()
    thunks["gain"] = gain
    thunks["go"] = lambda: mgm2._phase_go(
        values, committed, win, partner, pair_val, solo_gain, solo_cand
    )
    step_key = fold_in(key, 3)
    step_ms = _median_ms(
        lambda: step(dev, state, step_key, *consts), reps, device
    )
    hist = metrics_registry.histogram(
        "device.chunk_ms",
        "device window latency (dispatch to host sync) per chunk, ms",
    )
    phases: Dict[str, Any] = {}
    total = 0.0
    for name in mgm2.MGM2_PHASES:
        fn = thunks.get(name)
        if fn is None:
            continue
        # a shared no-op unless a profiler session is live, in which case
        # the phase's launches land as named ranges in the trace
        with device_annotation(f"solve.mgm2.{name}"):
            ms = _median_ms(fn, reps, device)
        total += ms
        if metrics_registry.enabled:
            hist.observe(ms, phase=f"mgm2.{name}", kind="phase")
        phases[name] = {
            "ms": round(ms, 4),
            "share_pct": (
                round(100.0 * ms / step_ms, 1) if step_ms > 0 else None
            ),
        }
    return {
        "algo": "mgm2",
        "device": device_platform(device),
        "step_ms": round(step_ms, 4),
        "phases": phases,
        "attributed_pct": (
            round(100.0 * total / step_ms, 1) if step_ms > 0 else None
        ),
    }
