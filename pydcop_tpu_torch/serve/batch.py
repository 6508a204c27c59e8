"""The batch engine: K tenant solves of one shape bucket as one solve.

Counterpart of ``pydcop_tpu/serve/batch.py``.  A request's problem is
padded to its shape bucket (``serve.bucket``); requests with equal
:func:`bucket_key` run together through ``algorithms.base.run_batch``:
the engine's prologue and chunk mapped over a leading instance axis
(``torch.func.vmap``), on the card one captured prologue graph and one
chunk graph per (bucket key, power-of-two class of K), whatever K is.
Every kernel wrapper's vmap rule makes a mapped call one launch for the
whole batch, so a batch iteration launches what one solo iteration does.

Graph identity: the graphs read a bucket's stacked input tensors, which
each (bucket key, K class, device) owns (``_Slot``).  A dispatch copies
its instances' cached host leaves (``build_instance``) into one pinned
host buffer laid out like the slot's one device buffer, and uploads it in
one copy: a warm batch captures nothing.

Bit-identity contract: a batch of K gives each tenant the assignment,
cost, cycles, best cost and cycle of the best of :func:`solve_one` of
that tenant (the same bucket padding, plan and noise draw shape through
``run_cycles``), on the CPU and on the card.  Per-instance key, noise
level, cycle budget and real row count are operands; pad instances
(K rounded up to a power of two) replicate the last tenant with a budget
of 0 and are discarded.

With pulse on (``telemetry.pulse``), each vmap tenant gets
``extras["pulse"]``: its health rows (``[cycles, HEALTH_WIDTH]``, its
``solve_one``'s bits) and flip counters, computed inside the batch's
graphs (the plan's ``health`` hook) and read with the batch's looks and
read-back; pulse on and off capture different graphs.  Fused mode gives
no rows, as in the JAX package: the union's rows are not a tenant's.

``mode="fused"`` solves a group as ONE block-diagonal union problem
(``serve.union``) through the ordinary solve; its trajectories follow one
fleet seed, not the tenants' own.

A batch that fails degrades to sequential ``solve_one`` calls, tenant by
tenant: each degraded group counts in ``solve_batched.degraded`` and puts
its error into its tenants' extras (``"degraded"``).
"""

from __future__ import annotations

import logging
import time
import types
from collections import OrderedDict
from functools import lru_cache
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..algorithms import SolveResult, load_algorithm_module
from .bucket import BucketDims, bucket_dims_of, pad_dev_to_bucket, pow2

logger = logging.getLogger(__name__)

__all__ = [
    "BatchPlan",
    "BucketKey",
    "ServeUnsupported",
    "SolveRequest",
    "TenantResult",
    "bucket_key",
    "build_instance",
    "solve_batched",
    "solve_one",
]


class ServeUnsupported(ValueError):
    """The algorithm and problem have no batch plan (e.g. MaxSum over
    non-binary constraints).  It fails its own tenant, never a
    co-batched one."""


class BatchPlan(NamedTuple):
    """What the engine needs to run one instance: the callables must be
    stable objects (module-level or from cached factories) shared by
    every instance of a bucket; per-instance tensors ride in ``consts``,
    padded to the bucket's shapes."""

    init: Callable
    step: Callable
    extract: Callable
    consts: Tuple
    convergence: Optional[Callable]
    same_count: int
    noise: float  # tie-breaking noise level (a per-instance operand)
    return_final: bool
    #: per-cycle message model: (count, bytes)
    msg_per_cycle: Tuple[int, int]
    #: stop_cycle's override of the requested cycle budget (0 = none)
    n_cycles_override: int = 0
    #: the solver's health hook, run while pulse is on (None: no rows)
    health: Optional[Callable] = None


class SolveRequest(NamedTuple):
    """One tenant's solve."""

    tenant: str
    compiled: Any  # CompiledDCOP
    algo: str
    params: Dict[str, Any]
    n_cycles: int = 100
    seed: int = 0


class TenantResult(NamedTuple):
    tenant: str
    result: Optional[SolveResult]
    extras: Dict[str, Any]


class BucketKey(NamedTuple):
    """The key that decides which requests share a batch and its graphs:
    the shape bucket, the algorithm and its params (they select the step
    and init), the algorithm's shape statics (``extra``, e.g. MaxSum's
    padded span signature) and the cycle budget's power-of-two class."""

    algo: str
    params: Tuple[Tuple[str, Any], ...]
    dims: BucketDims
    extra: Tuple
    n_pad: int
    has_noise: bool


@lru_cache(maxsize=None)
def _algo_module(algo: str):
    mod = load_algorithm_module(algo)
    if not hasattr(mod, "batch_plan"):
        raise ServeUnsupported(
            f"algorithm {algo!r} has no batch_plan: serve it sequentially"
        )
    return mod


@lru_cache(maxsize=1024)
def _prepared_cached(algo: str, items: Tuple) -> Dict[str, Any]:
    from ..algorithms import prepare_algo_params

    return prepare_algo_params(dict(items), _algo_module(algo).algo_params)


def _prepared(mod, params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    # cached by the raw items: a batch validates its params once
    return dict(_prepared_cached(
        mod.__name__.rsplit(".", 1)[-1],
        tuple(sorted((params or {}).items())),
    ))


def _scan_pad(n_cycles: int) -> int:
    # the power-of-two class of a cycle budget, as JAX's scan length
    return max(8, 1 << max(0, int(n_cycles) - 1).bit_length())


def _effective_cycles(plan: BatchPlan, n_cycles: int) -> int:
    return plan.n_cycles_override or int(n_cycles)


def bucket_key(req: SolveRequest) -> BucketKey:
    """The key of one request.  Requests with equal keys are batched
    together and share graphs; requests with different keys land in
    different batches, so correctness never depends on a collision."""
    mod = _algo_module(req.algo)
    params = _prepared(mod, req.params)
    n_cycles = int(params.get("stop_cycle") or req.n_cycles)
    return BucketKey(
        algo=req.algo,
        params=tuple(sorted(params.items())),
        dims=bucket_dims_of(req.compiled),
        extra=tuple(mod.bucket_extra(req.compiled, params)),
        n_pad=_scan_pad(n_cycles),
        has_noise=bool(float(params.get("noise", 0.0) or 0.0)),
    )


class _Instance(NamedTuple):
    """One request padded to its bucket: the padded problem and plan on
    the CPU (the host leaves a batch stacks), and the same on the solve's
    device (what ``solve_one`` runs)."""

    host_dev: Any  # DeviceDCOP on the CPU
    host_plan: BatchPlan
    dev: Any  # DeviceDCOP on the device
    plan: BatchPlan


def _to(tree, device):
    from ..algorithms.base import _flatten, _unflatten

    return _unflatten(tree, iter([
        x.to(device) if isinstance(x, torch.Tensor) else x
        for x in _flatten(tree, [])
    ]))


def build_instance(req: SolveRequest, dims: BucketDims,
                   device="cuda") -> _Instance:
    """The request padded to ``dims``, with its plan, on the CPU and on
    ``device``; cached on the compiled problem, so a warm tenant pads,
    plans and uploads nothing."""
    from ..algorithms.base import cached_const
    from ..compile.kernels import resolve_device, to_device

    device = resolve_device(device)
    mod = _algo_module(req.algo)
    params = _prepared(mod, req.params)

    def build():
        host_dev = pad_dev_to_bucket(to_device(req.compiled, "cpu"), dims)
        host_plan = mod.batch_plan(req.compiled, host_dev, params)
        if device.type == "cpu":
            return _Instance(host_dev, host_plan, host_dev, host_plan)
        dev = _to(host_dev, device)
        plan = host_plan._replace(consts=_to(host_plan.consts, device))
        return _Instance(host_dev, host_plan, dev, plan)

    return cached_const(
        req.compiled,
        ("serve_instance", req.algo, dims, tuple(sorted(params.items())),
         str(device)),
        build,
    )


def _tenant_result(req, plan, values, cycles, status, extras):
    from ..algorithms.base import finalize

    mc, ms = plan.msg_per_cycle
    result = finalize(req.compiled, values, cycles, mc * cycles, ms * cycles,
                      None, status=status)
    return TenantResult(req.tenant, result, extras)


def solve_one(req: SolveRequest, device="cuda") -> TenantResult:
    """The sequential reference solve, through the bucket padding, plan
    and noise draw shape the batch uses (``noise_draw`` = the bucket's
    rows): the baseline of the bit-identity contract, and the fallback of
    a degraded batch."""
    from ..algorithms.base import run_cycles

    dims = bucket_dims_of(req.compiled)
    inst = build_instance(req, dims, device)
    plan = inst.plan
    values, _curve, extras = run_cycles(
        req.compiled, inst.dev, plan.init, plan.step, plan.extract,
        n_cycles=_effective_cycles(plan, req.n_cycles),
        seed=req.seed,
        consts=plan.consts,
        noise=plan.noise,
        convergence=plan.convergence,
        same_count=plan.same_count,
        return_final=plan.return_final,
        noise_draw=dims.n_vars,
        with_best=True,
        health=plan.health,
    )
    return _tenant_result(
        req, plan, values, extras["cycles"],
        "TIMEOUT" if extras["timed_out"] else "FINISHED", extras,
    )


# -- the vmap mode: a bucket's batch, its stacked inputs ------------------


class _Slot:
    """The stacked inputs of one (bucket key, K class, device): K padded
    problems and their constants as views into ONE device buffer, filled
    from one host buffer of the same layout (pinned on the card) in one
    copy.  The batch's captured graphs read these tensors, and are cached
    on the slot (``home``), so a warm batch captures nothing."""

    ALIGN = 64

    def __init__(self, template: Tuple, k: int, device: torch.device):
        from ..algorithms.base import _flatten

        self.template = template
        self.k = k
        leaves = [x for x in _flatten(template, [])
                  if isinstance(x, torch.Tensor)]
        self.shapes = [(k,) + tuple(x.shape) for x in leaves]
        self.dtypes = [x.dtype for x in leaves]
        self.offsets, total = [], 0
        for shape, dtype in zip(self.shapes, self.dtypes):
            self.offsets.append(total)
            nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype
                                                       ).element_size()
            total += -(-nbytes // self.ALIGN) * self.ALIGN
        self.nbytes = total
        self.device_buf = torch.empty(max(total, 1), dtype=torch.uint8,
                                      device=device)
        self.host_buf = torch.empty(
            max(total, 1), dtype=torch.uint8,
            pin_memory=device.type == "cuda",
        )
        self.device_leaves = self._views(self.device_buf)
        self.host_leaves = self._views(self.host_buf)
        self.stacked = self._tree(self.device_leaves)
        self.home = types.SimpleNamespace()  # the graph cache

    def _views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for off, shape, dtype in zip(self.offsets, self.shapes, self.dtypes):
            size = torch.empty((), dtype=dtype).element_size()
            n = int(np.prod(shape))
            out.append(buf[off:off + n * size].view(dtype).view(shape))
        return out

    def _tree(self, leaves: List[torch.Tensor]):
        from ..algorithms.base import _flatten, _unflatten

        it = iter(leaves)
        return _unflatten(self.template, iter([
            next(it) if isinstance(x, torch.Tensor) else x
            for x in _flatten(self.template, [])
        ]))

    def fill(self, trees: List[Tuple]) -> Tuple:
        """Stack the K host trees (each of the template's structure) into
        the host buffer, upload it, and return the stacked device tree."""
        from ..algorithms.base import _flatten

        flats = [_flatten(t, []) for t in trees]
        template = _flatten(self.template, [])
        for flat in flats:
            for x, t in zip(flat, template):
                if not isinstance(t, torch.Tensor) and x != t:
                    raise AssertionError(
                        f"a bucket's instances differ in a static: {x!r} "
                        f"vs {t!r}"
                    )
        columns = zip(*[[x for x in flat if isinstance(x, torch.Tensor)]
                        for flat in flats])
        for dst, col in zip(self.host_leaves, columns):
            torch.stack(col, out=dst)
        self.device_buf.copy_(self.host_buf, non_blocking=True)
        return self.stacked


#: the slots of the buckets seen last, least recently used first
_slots: "OrderedDict[Tuple, _Slot]" = OrderedDict()
_SLOTS_CAP = 64


def _slot(key: BucketKey, k_pad: int, device: torch.device,
          template: Tuple) -> _Slot:
    cache_key = (key, k_pad, str(device))
    slot = _slots.pop(cache_key, None)
    if slot is None:
        slot = _Slot(template, k_pad, device)
    _slots[cache_key] = slot
    while len(_slots) > _SLOTS_CAP:
        _slots.popitem(last=False)
    return slot


def _dispatch_group(key: BucketKey, reqs: List[SolveRequest],
                    device) -> List[TenantResult]:
    """One bucket's requests as one batch (``base.run_batch``)."""
    from ..algorithms.base import run_batch
    from ..compile.kernels import resolve_device

    device = resolve_device(device)
    t0 = time.perf_counter()
    instances = [build_instance(r, key.dims, "cpu") for r in reqs]
    plan0 = instances[0].host_plan
    for inst in instances[1:]:
        if (inst.host_plan.step is not plan0.step
                or inst.host_plan.init is not plan0.init):
            raise AssertionError(
                "bucket key collision with mismatched plan statics"
            )
    k_real = len(reqs)
    k_pad = pow2(k_real)
    pad_n = k_pad - k_real
    trees = [(i.host_dev, i.host_plan.consts) for i in instances]
    trees += [trees[-1]] * pad_n
    slot = _slot(key, k_pad, device, trees[0])
    dev, consts = slot.fill(trees)
    budgets = [
        _effective_cycles(i.host_plan, r.n_cycles)
        for r, i in zip(reqs, instances)
    ] + [0] * pad_n
    t_filled = time.perf_counter()
    rows = run_batch(
        slot.home, dev, plan0.init, plan0.step, plan0.extract,
        n_limits=budgets,
        seeds=[r.seed for r in reqs] + [reqs[-1].seed] * pad_n,
        levels=[float(i.host_plan.noise or 0.0) for i in instances]
        + [0.0] * pad_n,
        n_reals=[r.compiled.n_vars for r in reqs]
        + [reqs[-1].compiled.n_vars] * pad_n,
        consts=consts,
        convergence=plan0.convergence,
        same_count=plan0.same_count,
        has_noise=key.has_noise,
        noise_draw=key.dims.n_vars,
        health=plan0.health,
    )
    t_solved = time.perf_counter()
    out = []
    for req, inst, row in zip(reqs, instances, rows):
        plan = inst.host_plan
        values = row["final"] if plan.return_final else row["best"]
        extras = {
            "best_values": row["best"],
            "best_cost": row["best_cost"],
            "cycles": row["ran"],
            "cycles_to_best": row["best_cycle"],
            "timed_out": False,
            "bucket": key,
            "batch_size": k_real,
            "k_pad": k_pad,
            "assemble_s": t_filled - t0,
            "solve_s": t_solved - t_filled,
        }
        if "health" in row:
            # pulse on: the tenant's rows and flip counters, cut to its
            # cycles and real variables as the JAX package cuts them
            extras["pulse"] = {"health": row["health"],
                               "flip_count": row["flips"]}
        out.append(_tenant_result(req, plan, values, row["ran"], "FINISHED",
                                  extras))
    return out


# -- the fused mode: K problems as ONE union solve --------------------------

#: (parts, union, blocks, dev, plan) per batch composition, keyed by the
#: tenants' compiled-object identities; the entry holds the parts, which
#: keeps the identities valid while it lives
_union_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()
_UNION_CACHE_CAP = 32


def _fused_key(req: SolveRequest):
    mod = _algo_module(req.algo)
    params = _prepared(mod, req.params)
    n_cycles = int(params.get("stop_cycle") or req.n_cycles)
    return (
        req.algo,
        tuple(sorted(params.items())),
        req.compiled.max_domain,
        np.dtype(req.compiled.float_dtype).name,
        req.compiled.objective,
        # a fused group runs to its largest budget: grouping by the
        # budget's power-of-two class bounds that to < 2x
        _scan_pad(n_cycles),
    )


def _dispatch_fused(reqs: List[SolveRequest], device) -> List[TenantResult]:
    """One union solve for a fused group: the K problems block-diagonally
    concatenated (``serve.union``) and solved by the ordinary engine at K
    times the size, with one fleet seed.  Each tenant's result is its
    block of the union's values, costed on the host by its own problem;
    the anytime best is the better of its final and union-best blocks."""
    from ..algorithms.base import cached_const, finalize, run_cycles
    from ..compile.kernels import resolve_device, to_device
    from .union import fleet_seed, union_compiled

    device = resolve_device(device)
    mod = _algo_module(reqs[0].algo)
    params = _prepared(mod, reqs[0].params)
    parts = [r.compiled for r in reqs]
    cache_key = (_fused_key(reqs[0]), str(device),
                 tuple(id(c) for c in parts))
    hit = _union_cache.pop(cache_key, None)
    if hit is None:
        union, blocks = union_compiled(parts)
        dev = cached_const(union, ("dev", str(device)),
                           lambda: to_device(union, device))
        hit = (parts, union, blocks, dev, mod.batch_plan(union, dev, params))
    _union_cache[cache_key] = hit
    while len(_union_cache) > _UNION_CACHE_CAP:
        _union_cache.popitem(last=False)
    _parts, union, blocks, dev, plan = hit
    n_cycles = max(_effective_cycles(plan, r.n_cycles) for r in reqs)
    final, _curve, extras = run_cycles(
        union, dev, plan.init, plan.step, plan.extract,
        n_cycles=n_cycles,
        seed=fleet_seed([r.seed for r in reqs]),
        consts=plan.consts,
        noise=plan.noise,
        convergence=plan.convergence,
        same_count=plan.same_count,
        return_final=True,
        with_best=True,
        health=None,  # union-global health rows are not per-tenant
    )
    best = extras["best_values"]
    cycles = extras["cycles"]
    out = []
    for req, (lo, hi) in zip(reqs, blocks):
        # each tenant's own message model
        mc, ms = mod.msg_per_cycle(req.compiled)
        result = finalize(req.compiled, final[lo:hi], cycles, mc * cycles,
                          ms * cycles, None, status="FINISHED")
        if not plan.return_final and not np.array_equal(final[lo:hi],
                                                        best[lo:hi]):
            at_best = finalize(req.compiled, best[lo:hi], cycles,
                               mc * cycles, ms * cycles, None,
                               status="FINISHED")
            if at_best.cost < result.cost:
                result = at_best
        out.append(TenantResult(req.tenant, result, {
            "best_cost": result.cost,
            "cycles": cycles,
            "cycles_to_best": extras["cycles_to_best"],
            "timed_out": extras["timed_out"],
            "batch_size": len(reqs),
            "mode": "fused",
        }))
    return out


def solve_batched(
    requests: List[SolveRequest],
    max_batch: Optional[int] = None,
    mode: str = "vmap",
    device="cuda",
) -> Dict[str, TenantResult]:
    """Solve many tenants, one batch a group, on ``device`` (the card
    unless the caller asks for the CPU).

    ``mode="vmap"`` (the default): requests group by :func:`bucket_key`,
    each group (up to ``max_batch`` at once) one batch whose tenants each
    get the bits of :func:`solve_one`.  ``mode="fused"``: requests group
    by algorithm, params, domain, dtype, objective and budget class, each
    group one union solve (``_dispatch_fused``).

    A request that cannot be keyed (unsupported, invalid, unhashable
    params) fails alone, its result None and its error in its extras.  A
    group whose batch raises degrades to ``solve_one`` tenant by tenant:
    counted in ``solve_batched.degraded``, logged, and its error in each
    of its tenants' extras as ``"degraded"``."""
    from ..compile.kernels import resolve_device

    if mode not in ("vmap", "fused"):
        raise ValueError(f"unknown serve batch mode {mode!r}")
    device = resolve_device(device)
    groups: Dict[Any, List[SolveRequest]] = {}
    out: Dict[str, TenantResult] = {}
    for req in requests:
        try:
            key = bucket_key(req) if mode == "vmap" else _fused_key(req)
        except (ServeUnsupported, ValueError, TypeError) as exc:
            # TypeError: an unhashable param value hit a key cache
            out[req.tenant] = _failed(req, exc)
            continue
        groups.setdefault(key, []).append(req)
    for key, reqs in groups.items():
        cap = max_batch or len(reqs)
        for lo in range(0, len(reqs), cap):
            chunk = reqs[lo:lo + cap]
            try:
                if mode == "vmap":
                    results = _dispatch_group(key, chunk, device)
                else:
                    results = _dispatch_fused(chunk, device)
            except ServeUnsupported as exc:
                for req in chunk:
                    out[req.tenant] = _failed(req, exc)
                continue
            except Exception as exc:  # noqa: BLE001 (isolate the tenants)
                solve_batched.degraded += 1
                logger.exception(
                    "batch of %d tenant(s) failed in mode=%s; degrading to "
                    "sequential solves", len(chunk), mode,
                )
                error = f"{type(exc).__name__}: {exc}"
                for req in chunk:
                    try:
                        tr = solve_one(req, device)
                        tr.extras["degraded"] = error
                        out[req.tenant] = tr
                    except Exception as exc2:  # noqa: BLE001
                        out[req.tenant] = _failed(req, exc2)
                        out[req.tenant].extras["degraded"] = error
                continue
            for tr in results:
                out[tr.tenant] = tr
    return out


solve_batched.degraded = 0  # groups whose batch failed


def _failed(req: SolveRequest, exc: Exception) -> TenantResult:
    return TenantResult(
        req.tenant, None,
        {"error": f"{type(exc).__name__}: {exc}", "timed_out": False},
    )
