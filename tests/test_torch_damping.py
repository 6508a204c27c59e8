"""MaxSum's float32 damping against the JAX package, on the CPU.

XLA's CPU compiler contracts the JAX package's damping
``d * prev + (1 - d) * new`` into one fused multiply-add,
``fma(d, prev, (1 - d) * new)``, in every MaxSum program: the solve on
each layout (fused, checkpointed, pulse on) and A-MaxSum.  The port damps
float32 planes the same way (``damp``'s ``fma``: the ``damp_fma`` kernel on
the card, ``damp_fma_plain`` on the CPU), so its final message planes are
JAX's bit for bit at damping 0.7, not only its results.

``damp_fma_plain`` is held against XLA's own contraction: on a million
seeded values, on values built so that the exact sum lies within a
float64 rounding of a float32 midpoint (where rounding to float64 and then
to float32 gives another float32 than one rounding: the float64 chain the
port had before fails there), and on hypothesis's values.  On the card the
kernel equals the plain version (``tests/test_torch_kernels.py -m
cuda``).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_kernels import near_midpoints
from test_torch_lanes import port_of

from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_coloring,
)
from pydcop_tpu.durability import CheckpointManager as JaxManager
from pydcop_tpu.durability import durability as jax_durability
from pydcop_tpu.telemetry.pulse import pulse as jax_pulse
from pydcop_tpu_torch.algorithms import base
from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile.kernels import damp
from pydcop_tpu_torch.durability import CheckpointManager, durability
from pydcop_tpu_torch.telemetry.pulse import pulse

DAMPING = 0.7


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(
        np.uint32)


def _xla_damp(damping, prev: np.ndarray, new: np.ndarray) -> np.ndarray:
    """The JAX package's damping as XLA's CPU compiler runs it."""
    f = jax.jit(lambda p, n: damping * p + (1 - damping) * n)
    return np.asarray(f(jnp.asarray(prev), jnp.asarray(new)))


def _plain(damping, prev: np.ndarray, new: np.ndarray) -> np.ndarray:
    d, e = hk.damp_constants(damping)
    return hk.damp_fma_plain(
        torch.from_numpy(prev), torch.from_numpy(new), d, e).numpy()


def _float64_chain(damping, prev: np.ndarray, new: np.ndarray):
    """The form the port had: rounded to float64, then to float32."""
    p, n = torch.from_numpy(prev), torch.from_numpy(new)
    return (p.double() * float(np.float32(damping))
            + ((1.0 - damping) * n).double()).float().numpy()


# ---------------------------------------------------------------------------
# the plain version against XLA's contraction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("damping", [0.7, 0.3, 0.9, 0.55])
def test_plain_is_xla_s_fma_on_a_million_values(damping):
    rng = np.random.default_rng(int(damping * 100))
    n = 1_000_000
    scale = rng.choice([1e-3, 1.0, 1e2, 1e4], n)
    prev = (rng.standard_normal(n) * scale).astype(np.float32)
    new = (rng.standard_normal(n) * scale[::-1]).astype(np.float32)
    assert np.array_equal(_bits(_plain(damping, prev, new)),
                          _bits(_xla_damp(damping, prev, new)))
    # and the plain (unfused) form is not it: the test can tell them apart
    plain_form = (damping * torch.from_numpy(prev)
                  + (1.0 - damping) * torch.from_numpy(new)).numpy()
    assert not np.array_equal(_bits(plain_form),
                              _bits(_xla_damp(damping, prev, new)))


@pytest.mark.parametrize("damping", [0.7, 0.3])
def test_plain_rounds_once_near_float32_midpoints(damping):
    prev, new = near_midpoints(damping, 2000, seed=7)
    want = _bits(_xla_damp(damping, prev, new))
    assert np.array_equal(_bits(_plain(damping, prev, new)), want)
    # rounding twice gets some of them wrong
    assert (_bits(_float64_chain(damping, prev, new)) != want).sum() > 0


# XLA's CPU runtime flushes subnormal floats to zero, inputs, products and
# results, and the port keeps them; message planes hold none, so the
# draws are 0 or of magnitude 2**-100 to 2**100 (no subnormal product),
# and a subnormal result is only checked to be one in both
_F32 = st.one_of(
    st.just(0.0),
    st.floats(width=32, min_value=2.0 ** -100, max_value=2.0 ** 100),
    st.floats(width=32, min_value=-(2.0 ** 100), max_value=-(2.0 ** -100)),
)
_TINY = np.finfo(np.float32).tiny


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_F32, _F32), min_size=1, max_size=64),
       st.sampled_from([0.7, 0.3, 0.9, 0.25, 0.6]))
def test_plain_is_xla_s_fma_on_hypothesis_values(pairs, damping):
    prev = np.array([p for p, _ in pairs], np.float32)
    new = np.array([n for _, n in pairs], np.float32)
    got, want = _plain(damping, prev, new), _xla_damp(damping, prev, new)
    normal = np.abs(got) >= _TINY
    assert np.array_equal(_bits(got[normal]), _bits(want[normal]))
    assert (np.abs(want[~normal]) < _TINY).all()


def _midpoint_case(damping, p: float, tiny: int, sign: int):
    """One ``(prev, new)`` of ``near_midpoints``'s kind from hypothesis's
    draws, or None where the draw builds none."""
    d, e = hk.damp_constants(damping)
    p = np.float32(p)
    a = float(p) * d
    exp = np.frexp(a)[1] - 1
    ulp32 = 2.0 ** (exp - 23)
    mid = (np.floor(a / ulp32) + 0.5) * ulp32
    c = (mid - a) + sign * 2.0 ** (exp - tiny)
    if c == 0 or np.float32(c) != c:
        return None
    cand = np.float32(c / e)
    for x in (cand, np.nextafter(cand, np.float32(np.inf)),
              np.nextafter(cand, np.float32(-np.inf))):
        if np.float32(np.float32(e) * x) == np.float32(c):
            return p, x
    return None


@settings(max_examples=300, deadline=None)
@given(st.floats(min_value=2.0 ** -10, max_value=2.0 ** 20, width=32),
       st.integers(min_value=50, max_value=60), st.sampled_from([1, -1]),
       st.sampled_from([0.7, 0.3, 0.9]))
def test_plain_is_xla_s_fma_near_midpoints_hypothesis(p, tiny, sign,
                                                      damping):
    case = _midpoint_case(damping, p, tiny, sign)
    if case is None:
        return
    prev, new = (np.array([x], np.float32) for x in case)
    assert np.array_equal(_bits(_plain(damping, prev, new)),
                          _bits(_xla_damp(damping, prev, new)))


def test_damp_dispatches_by_dtype_and_flag():
    rng = np.random.default_rng(0)
    prev = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    want = _xla_damp(DAMPING, prev.numpy(), new.numpy())
    assert np.array_equal(_bits(damp(DAMPING, prev, new, fma=True)),
                          _bits(want))
    plain_form = DAMPING * prev + (1.0 - DAMPING) * new
    assert torch.equal(damp(DAMPING, prev, new), plain_form)
    # bf16 planes keep JAX's uncontracted bf16 form, flag or not
    pb = prev.to(torch.bfloat16)
    assert torch.equal(damp(DAMPING, pb, new, fma=True),
                       damp(DAMPING, pb, new))
    # at 0.5 the products are exact: both forms give the same bits
    assert torch.equal(damp(0.5, prev, new, fma=True), damp(0.5, prev, new))


def test_damp_fma_under_vmap_is_each_instance_s():
    rng = np.random.default_rng(1)
    prev = torch.from_numpy(rng.standard_normal((4, 3, 50)).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal((4, 3, 50)).astype(np.float32))
    got = torch.func.vmap(lambda p, n: hk.damp_fma(DAMPING, p, n))(prev, new)
    for i in range(4):
        assert torch.equal(got[i], hk.damp_fma(DAMPING, prev[i], new[i]))
    with pytest.raises(TypeError):
        hk.damp_fma(DAMPING, prev.double(), new.double())


# ---------------------------------------------------------------------------
# the solves' final planes against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def coloring():
    ref = jax_coloring(120, 3, graph="scalefree", m_edge=2, seed=11)
    return ref, port_of(ref)


@pytest.fixture(autouse=True)
def _singletons_off():
    for d in (durability, jax_durability):
        d.reset()
    yield
    for d in (durability, jax_durability):
        d.reset()
    for p in (pulse, jax_pulse):
        p.enabled = False
        p.reset()


def _fresh_state(init, dev, consts):
    """A state tree of ``init``'s structure with a tensor of its own at
    every leaf (``init_ell`` hands one zero tensor to both planes)."""
    tree = init(dev, None, *consts)
    return base._unflatten(tree, iter([
        x.clone() if isinstance(x, torch.Tensor) else x
        for x in base._flatten(tree, [])
    ]))


@contextlib.contextmanager
def _keep_state(module, port: bool, seen: dict):
    """``module.run_cycles`` with its final state kept in ``seen``."""
    orig = module.run_cycles

    def spy(*args, **kwargs):
        if port:
            compiled, dev, init = args[:3]
            kwargs["state_into"] = _fresh_state(
                init, dev, kwargs.get("consts", ()))
        out = orig(*args, **kwargs)
        seen["state"] = out[2]["state"]
        return out

    module.run_cycles = spy
    try:
        yield
    finally:
        module.run_cycles = orig


def _solve_planes(name, problem, params, mode, tmp_path, port: bool,
                  n_cycles=20, seed=3):
    pkg = "pydcop_tpu_torch" if port else "pydcop_tpu"
    mod = importlib.import_module(f"{pkg}.algorithms.{name}")
    seen = {}
    kwargs = {"device": "cpu"} if port else {}
    single = durability if port else jax_durability
    monitor = pulse if port else jax_pulse
    if mode == "checkpointed":
        manager = CheckpointManager if port else JaxManager
        single.configure(manager=manager(
            str(tmp_path / pkg), every_cycles=5, keep=50))
    if mode == "pulse":
        monitor.reset()
        monitor.enabled = True
    try:
        with _keep_state(mod, port, seen):
            result = mod.solve(problem, dict(params), n_cycles=n_cycles,
                               seed=seed, **kwargs)
    finally:
        single.reset()
        monitor.enabled = False
        monitor.reset()
    state = seen["state"]
    return result, state.v2f, state.f2v


PLANE_CASES = [
    (name, layout, mode)
    for name, layouts in (("maxsum", ("ell", "lanes", "edges", "pallas")),
                          ("amaxsum", (None,)))
    for layout in layouts
    for mode in ("fused", "checkpointed", "pulse")
]


@pytest.mark.parametrize("name,layout,mode", PLANE_CASES)
def test_final_planes_are_jax_s_at_damping_07(name, layout, mode, coloring,
                                              tmp_path):
    ref, port = coloring
    params = {"damping": DAMPING, "stop_cycle": 20}
    if layout is not None:
        params["layout"] = layout
    jres, jv2f, jf2v = _solve_planes(name, ref, params, mode, tmp_path,
                                     port=False)
    pres, pv2f, pf2v = _solve_planes(name, port, params, mode, tmp_path,
                                     port=True)
    assert (pres.cost, pres.assignment, pres.cycles) == (
        jres.cost, jres.assignment, jres.cycles)
    assert pres.cycles == 20
    for got, want in ((pv2f, jv2f), (pf2v, jf2v)):
        got = got.numpy()
        assert got.dtype == np.float32 and got.shape == np.shape(want)
        assert np.array_equal(_bits(got), _bits(want))
