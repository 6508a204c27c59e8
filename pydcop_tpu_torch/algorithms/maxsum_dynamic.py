"""Dynamic MaxSum: factors whose cost function changes at run time, and
factors reading external (sensor) variables.

Counterpart of ``pydcop_tpu/algorithms/maxsum_dynamic.py``.  ``solve`` is
MaxSum's.  A :class:`DynamicMaxSum` session owns the compiled problem and
the warm MaxSum message state.  A change (``change_factor_function``, or
``ext.value = v`` on an external variable of its DCOP, to which the
session subscribes) re-lowers the cost tables and keeps the messages: the
constraint topology is fixed, so the edge ids are stable and belief
propagation goes on against the new tables.  ``run(n)`` advances ``n``
more cycles from the current state.

The session runs the lanes layout for ``auto``, ``ell``, ``lanes`` and
``pallas`` (every binary factor through ``factor_arity2_minplus`` on the
card) and the edges layout otherwise, with float32 or bf16 planes.  It is
resident on its device: its state, its noised unary plane, its tables and
the lanes layout's transposed tables live in tensors that the session
owns and refreshes in place (``base.assign_``), so the engine's graphs,
cached under the session's first compiled problem, are keyed by the same
tensors on every run.  A warm ``run()`` captures nothing, a change
captures nothing either, and the cache does not grow with the runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..compile.core import CompiledDCOP, compile_dcop
from ..compile.kernels import (
    lanes_aux,
    resolve_device,
    select_values,
    to_device,
)
from ..dcop.dcop import DCOP
from ..dcop.relations import Constraint
from . import AlgoParameterDef, SolveResult, prepare_algo_params
from . import maxsum as _maxsum
from .base import (
    _flatten,
    _unflatten,
    apply_noise,
    assign_,
    extract_values,
    finalize,
    run_cycles,
)
from .maxsum import PLANE_DTYPES, MaxSumState, _make_init, _make_step

GRAPH_TYPE = "factor_graph"

# the agent runtime's footprint models: MaxSum's
from .maxsum import communication_load, computation_memory  # noqa: E402,F401

algo_params: List[AlgoParameterDef] = list(_maxsum.algo_params)


def solve(
    compiled: CompiledDCOP,
    params: Optional[Dict[str, Any]] = None,
    n_cycles: int = 100,
    seed: int = 0,
    collect_curve: bool = False,
    device="cuda",
) -> SolveResult:
    """Static problems: MaxSum (a dynamic factor that never changes is a
    MaxSum factor)."""
    return _maxsum.solve(
        compiled, params=params, n_cycles=n_cycles, seed=seed,
        collect_curve=collect_curve, device=device,
    )


def _resume_init(dev, key, act_v, act_f, state):
    """The engine's init for a resident session: the session's state,
    given as a constant."""
    return state


class _Saved(NamedTuple):
    """The leaves of a checkpoint, in the JAX package's order (its
    ``MaxSumState`` without the layout's companion tables)."""

    v2f: Any
    f2v: Any
    values: Any
    cycle: Any
    act_v: Any  # int32[1] zeros: the wavefront is off in a session
    act_f: Any


def _owned(tree):
    """``tree`` with a tensor of its own for every tensor leaf (an init
    may hand one zero plane to both message planes)."""
    return _unflatten(tree, iter([
        leaf.clone() if isinstance(leaf, torch.Tensor) else leaf
        for leaf in _flatten(tree, [])
    ]))


class DynamicMaxSum:
    """A resident MaxSum solve whose factors can change between runs.

    Usage::

        session = DynamicMaxSum(dcop, params={"damping": 0.5})
        r1 = session.run(50)
        session.change_factor_function("c1", new_constraint)
        ext.value = 12          # external variable updates re-lower too
        r2 = session.run(50)    # goes on from the warm message state
    """

    def __init__(
        self,
        dcop: DCOP,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        device="cuda",
    ) -> None:
        self.dcop = dcop
        self.params = prepare_algo_params(params or {}, algo_params)
        self.seed = seed
        self.device = resolve_device(device)
        self.compiled = compile_dcop(dcop)
        # the engine caches the session's graphs here for its whole life;
        # a change re-lowers into the same tensors, not a new cache
        self._graph_home = self.compiled
        # tie-breaking noise from the session seed, so re-lowered tables
        # see the same noise
        self.dev = self._lowered(self.compiled)
        self._cycles_done = 0
        self._msg_count = 0
        # "auto" and "ell" run lanes: the session's per-edge state needs
        # the edge order, which ELL's degree buckets do not keep
        self._lanes = self.params["layout"] in ("lanes", "pallas", "ell",
                                                "auto")
        layout = "lanes" if self._lanes else "edges"
        precision = self.params["precision"]
        self._plane_dtype = PLANE_DTYPES[precision]
        self._inert = torch.zeros(1, dtype=torch.int32, device=self.device)
        # every cycle emits (the wavefront is off): the activation arrays
        # are inert
        init = _make_init(layout, precision)
        extra = (lanes_aux(self.dev),) if self._lanes else ()
        self.state: MaxSumState = _owned(
            init(self.dev, None, self._inert, self._inert, *extra)
        )
        damping_nodes = self.params["damping_nodes"]
        self._step = _make_step(
            self.params["damping"], damping_nodes in ("vars", "both"),
            damping_nodes in ("factors", "both"), False, layout, (),
            precision, fma_damping=True,
        )
        self._subscriptions = []
        for ext in self.dcop.external_variables.values():
            cb = lambda _v, _n=ext.name: self._on_external_change(_n)  # noqa: E731
            ext.subscribe(cb)
            self._subscriptions.append((ext, cb))

    def _lowered(self, compiled: CompiledDCOP):
        return apply_noise(
            compiled, to_device(compiled, self.device), self.seed,
            self.params["noise"],
        )

    def close(self) -> None:
        """Detach from the DCOP's external variables.  A session that is
        not closed stays on their subscriber lists and re-lowers on every
        sensor update."""
        for ext, cb in self._subscriptions:
            try:
                ext.unsubscribe(cb)
            except ValueError:
                pass
        self._subscriptions = []

    # ------------------------------------------------------------------
    # dynamic updates
    # ------------------------------------------------------------------

    def change_factor_function(
        self, name: str, new_constraint: Constraint
    ) -> None:
        """Swap the cost function of factor ``name``; the scope must stay
        the same."""
        old = self.dcop.constraints.get(name)
        if old is None:
            raise ValueError(f"no constraint named {name!r}")
        if {v.name for v in old.dimensions} != {
            v.name for v in new_constraint.dimensions
        }:
            raise ValueError(
                f"change_factor_function({name!r}): the new function must "
                f"have the same scope as the old one"
            )
        self.dcop.constraints[name] = new_constraint
        self._relower()

    def _on_external_change(self, _name: str) -> None:
        self._relower()

    def _relower(self) -> None:
        """Re-lower the cost tables after a change, keeping the message
        state: the new tables, noised unary plane and (lanes) transposed
        companions are copied into the session's tensors."""
        new_compiled = compile_dcop(self.dcop)
        topology_error = ValueError(
            "dynamic update changed the factor-graph topology; "
            "DynamicMaxSum only supports cost changes over a fixed graph"
        )
        if (
            new_compiled.n_edges != self.compiled.n_edges
            or new_compiled.var_names != self.compiled.var_names
            or not np.array_equal(new_compiled.edge_var, self.compiled.edge_var)
        ):
            raise topology_error
        try:
            assign_(self.dev, self._lowered(new_compiled))
        except ValueError as e:
            raise topology_error from e
        self.compiled = new_compiled
        if self._lanes:
            # the lanes layout marginalizes against transposed copies of
            # the tables and the noised unary plane: refresh them too
            assign_(self.state.aux, lanes_aux(self.dev))

    # ------------------------------------------------------------------
    # solving
    # ------------------------------------------------------------------

    def run(
        self, n_cycles: int = 100, collect_curve: bool = False
    ) -> SolveResult:
        """Advance ``n_cycles`` more cycles from the current state; reports
        the best assignment of this run and the session's totals."""
        values, curve, _ = run_cycles(
            self._graph_home, self.dev, _resume_init, self._step,
            extract_values,
            n_cycles=n_cycles,
            seed=self.seed + self._cycles_done,
            collect_curve=collect_curve,
            return_final=False,
            consts=(self._inert, self._inert, self.state),
            state_into=self.state,
            # each run publishes its own health stream while pulse is on
            # (the residuals restart from the warm planes, so a change's
            # spike shows)
            health=_maxsum.health,
        )
        self._cycles_done += n_cycles
        self._msg_count += 2 * self.compiled.n_edges * n_cycles
        return finalize(
            self.compiled, values, self._cycles_done, self._msg_count,
            self._msg_count * 2 * self.compiled.max_domain, curve,
        )

    @property
    def current_assignment(self) -> Dict[str, Any]:
        vals = self.state.values.cpu().numpy()
        return self.compiled.assignment_from_indices(
            vals[: self.compiled.n_vars]
        )

    # ------------------------------------------------------------------
    # checkpoint / resume, in the JAX package's format
    # ------------------------------------------------------------------

    def _saved(self) -> _Saved:
        inert = torch.zeros(1, dtype=torch.int32)
        s = self.state
        return _Saved(s.v2f, s.f2v, s.values, s.cycle, inert, inert)

    def save(self, path: str) -> None:
        """Checkpoint the warm message state and the progress counters."""
        from ..utils.checkpoint import save_checkpoint

        save_checkpoint(
            path,
            self._saved(),
            metadata={
                "cycles_done": self._cycles_done,
                "msg_count": self._msg_count,
                "seed": self.seed,
                # the orientation of the stored planes: "edges" = [n_edges,
                # D] rows, "lanes" = transposed (a square plane is
                # ambiguous by its shape alone)
                "plane_layout": "lanes" if self._lanes else "edges",
            },
        )

    def restore(self, path: str) -> None:
        """Resume from a checkpoint of the same problem, written by
        ``save`` of either package."""
        from ..utils.checkpoint import CheckpointError, load_checkpoint

        try:
            saved, meta = load_checkpoint(path, like=self._saved())
            saved_layout = meta.get("plane_layout")
            v2f, f2v = saved.v2f, saved.f2v
            if saved_layout is not None and saved_layout != (
                "lanes" if self._lanes else "edges"
            ):
                # square planes pass the shape check in either
                # orientation; the recorded layout decides
                v2f, f2v = v2f.T, f2v.T
            restored = dataclasses.replace(
                self.state, v2f=v2f, f2v=f2v, values=saved.values,
                cycle=saved.cycle,
            )
        except CheckpointError:
            # older state layouts, by leaf count: 3 = (v2f, f2v, active),
            # 5 = (v2f, f2v, cycle, act_v, act_f), 6 = the older default
            # state (edges-layout planes).  The planes lead; the selection
            # is recomputed, the cycle counter taken from the metadata,
            # and the planes turned into this session's layout
            leaves, meta = load_checkpoint(path)
            plane = (self.dev.n_edges, self.dev.max_domain)
            plane_t = plane[::-1]
            if len(leaves) not in (3, 5, 6):
                raise
            v2f, f2v = leaves[0], leaves[1]
            saved_layout = meta.get("plane_layout")
            if saved_layout == "lanes" or (
                saved_layout is None
                and tuple(v2f.shape) == plane_t
                and plane != plane_t
            ):
                # stored transposed; without metadata a square plane is
                # read as edges, as every older writer stored it
                v2f, f2v = v2f.T, f2v.T
            if tuple(v2f.shape) != plane or tuple(f2v.shape) != plane:
                raise
            dtype = self._plane_dtype
            row_f2v = f2v.to(dtype).to(self.device)
            if self._lanes:
                v2f, f2v = v2f.T, f2v.T
            restored = dataclasses.replace(
                self.state, v2f=v2f.to(dtype), f2v=f2v.to(dtype),
                values=select_values(self.dev, row_f2v),
                cycle=torch.tensor(
                    int(meta.get("cycles_done", 0)), dtype=torch.int32
                ),
            )
        assign_(self.state, restored)
        self._cycles_done = int(meta.get("cycles_done", 0))
        self._msg_count = int(meta.get("msg_count", 0))
