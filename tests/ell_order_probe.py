"""Where MaxSum's ``ell`` solve leaves the JAX package's bits, cycle by
cycle, and which summation order of the ELL fan-in's 32-slot class the
JAX package's fused solve uses on this host.

    JAX_PLATFORMS=cpu python tests/ell_order_probe.py [PARAMS] [CYCLES]

(default ``'{"layout": "ell", "damping": 0.3, "damping_nodes": "vars"}'``
and 30).  The problem is ``tests/test_torch_ell_curve.py``'s.  Both
packages start from the same file and seed; the JAX package's state after
``n`` cycles comes from its own compiled solve (``_solve_fused``, called
again with the cycle budget ``n``: the program is the same), the port's
from ``maxsum.solve`` with ``n_cycles=n``.  For each cycle it prints how
many entries of each plane differ in their bits and, at the first cycle
whose ``v2f`` differs, in which degree classes they lie.  Then it solves
again with the port's sum over every 32-slot row replaced by each order
in ``ORDERS`` (the vectorized loops of XLA-CPU's LLVM backend) and
prints, for each, the differing entries of ``v2f`` at a few cycles and
the cycles where the two ``solve_result`` cost curves differ.

Not a test: the orders it finds depend on the host's vectorizer.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import pydcop_tpu.algorithms.base as jax_base  # noqa: E402
import pydcop_tpu.api as jax_api  # noqa: E402
from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef  # noqa: E402
from pydcop_tpu.algorithms import maxsum as jax_maxsum  # noqa: E402
from pydcop_tpu.compile.core import compile_dcop as jax_compile  # noqa: E402
from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load  # noqa: E402
from pydcop_tpu_torch import api  # noqa: E402
from pydcop_tpu_torch.algorithms import AlgorithmDef, maxsum  # noqa: E402
from pydcop_tpu_torch.compile import hopper_kernels  # noqa: E402
from pydcop_tpu_torch.compile.core import compile_dcop  # noqa: E402
from pydcop_tpu_torch.compile.kernels import build_ell  # noqa: E402
from pydcop_tpu_torch.dcop.yamldcop import load_dcop  # noqa: E402
from test_torch_damping import _fresh_state  # noqa: E402
from test_torch_ell_curve import scalefree_yaml  # noqa: E402


def _vectorized(lanes: int, accumulators: int):
    """The sum over the last axis as a loop vectorized ``lanes`` wide with
    ``accumulators`` partial vectors (vector k takes values k*lanes.. of
    each step of lanes*accumulators values), the partial vectors added in
    order, then halved to one lane (lanes 0..h-1 plus h..2h-1)."""

    def total(x):
        step = lanes * accumulators
        acc = [x[..., k * lanes:(k + 1) * lanes] for k in range(accumulators)]
        for t in range(step, x.shape[-1], step):
            acc = [a + x[..., t + k * lanes:t + (k + 1) * lanes]
                   for k, a in enumerate(acc)]
        r = acc[0]
        for a in acc[1:]:
            r = r + a
        while r.shape[-1] > 1:
            h = r.shape[-1] // 2
            r = r[..., :h] + r[..., h:]
        return r[..., 0]

    return total


ORDERS = {
    "in order (the port's)": None,
    "8 lanes, 1 accumulator": _vectorized(8, 1),
    "8 lanes, 2 accumulators": _vectorized(8, 2),
    "8 lanes, 4 accumulators": _vectorized(8, 4),
    "4 lanes, 4 accumulators": _vectorized(4, 4),
}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


class _Solves:
    def __init__(self, text, params, n_cycles):
        self.params = params
        self.jax_compiled = jax_compile(jax_load(text))
        self.compiled = compile_dcop(load_dcop(text))
        jax_params = JaxAlgorithmDef.build_with_default_param(
            "maxsum", params=params).params
        caught = {}
        fused = jax_base._solve_fused

        def spy(*args, **kwargs):
            caught.update(args=args, kwargs=kwargs)
            return fused(*args, **kwargs)

        jax_base._solve_fused = spy
        try:
            jax_maxsum.solve(self.jax_compiled, dict(jax_params),
                             n_cycles=n_cycles, seed=0, collect_curve=True)
        finally:
            jax_base._solve_fused = fused
        self._fused, self._caught = fused, caught

    def jax(self, n):
        args = list(self._caught["args"])
        args[3] = np.int32(n)  # the traced cycle budget
        return self._fused(*args, **self._caught["kwargs"])[0]

    def port(self, n):
        seen = {}
        run_cycles = maxsum.run_cycles

        def spy(*args, **kwargs):
            compiled, dev, init = args[:3]
            kwargs["state_into"] = _fresh_state(
                init, dev, kwargs.get("consts", ()))
            out = run_cycles(*args, **kwargs)
            seen["state"] = out[2]["state"]
            return out

        maxsum.run_cycles = spy
        try:
            params = AlgorithmDef.build_with_default_param(
                "maxsum", params=self.params).params
            maxsum.solve(self.compiled, dict(params), n_cycles=n, seed=0,
                         device="cpu")
        finally:
            maxsum.run_cycles = run_cycles
        return seen["state"]

    def curve_cycles(self, n_cycles):
        """The cycles (1-based) where the two packages' ``solve_result``
        cost curves differ."""
        text = scalefree_yaml()
        jax_curve = jax_api.solve_result(
            jax_load(text),
            JaxAlgorithmDef.build_with_default_param(
                "maxsum", params=self.params),
            n_cycles=n_cycles, seed=0, collect_curve=True)["cost_curve"]
        curve = api.solve_result(
            load_dcop(text),
            AlgorithmDef.build_with_default_param(
                "maxsum", params=self.params),
            n_cycles=n_cycles, seed=0, collect_curve=True,
            device="cpu")["cost_curve"]
        return [i + 1 for i, (a, b) in enumerate(zip(jax_curve, curve))
                if a != b]

    def differing(self, n, names=("f2v", "v2f", "values")):
        js, ps = self.jax(n), self.port(n)
        return {k: np.asarray(_bits(getattr(js, k)) != _bits(
            getattr(ps, k).numpy())) for k in names}


def main():
    params = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {
        "layout": "ell", "damping": 0.3, "damping_nodes": "vars"}
    n_cycles = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    solves = _Solves(scalefree_yaml(), params, n_cycles)
    spans = build_ell(solves.compiled).spans
    print("params", params, "ELL classes (vars, slots)", spans)
    first = None
    for n in range(1, n_cycles + 1):
        diff = solves.differing(n)
        print(n, {k: int(v.sum()) for k, v in diff.items()}, flush=True)
        if first is None and diff["v2f"].any():
            first = n
            cols = np.flatnonzero(diff["v2f"].any(axis=0))
            off = 0
            for nb, db in spans:
                inside = int(((cols >= off) & (cols < off + nb * db)).sum())
                if inside:
                    print(f"  cycle {n}: {inside} slots of the {db}-slot "
                          "class differ")
                off += nb * db
    plain = hopper_kernels._xla_sum_plain
    checked = sorted({n for n in (2, 3, 5, 10, n_cycles) if n <= n_cycles})
    for name, order in ORDERS.items():
        if order is not None:
            hopper_kernels._xla_sum_plain = (
                lambda x, order=order: order(x)
                if x.dtype == torch.float32 and x.shape[-1] == 32
                else plain(x))
        try:
            counts = [int(solves.differing(n, ("v2f",))["v2f"].sum())
                      for n in checked]
            curve = solves.curve_cycles(n_cycles)
        finally:
            hopper_kernels._xla_sum_plain = plain
        print(f"{name}: v2f entries differing at cycles {checked}: "
              f"{counts}; cost curves differing at cycles {curve}",
              flush=True)


if __name__ == "__main__":
    main()
