"""The resident DynamicMaxSum session and the checkpoints against the JAX
package, both on the CPU.

A session of each package runs the same DCOP (carried across as YAML
text) through the same sequence: run, run, ``change_factor_function``,
run, and on a problem with a sensor, ``ext.value = ...`` and run.  Every
result (assignment, cost, cycles, messages) and the warm message planes
must be the JAX package's, bit for bit, on the lanes and the edges
layouts with float32 and bf16 planes (damping 0.5: no FMA question,
ROADMAP "Known divergences").  Checkpoints cross between the packages
both ways and the session goes on as the uninterrupted one does; the
square-plane case whose orientation only the metadata tells, and a
legacy leaf layout, restore as in the JAX package.  On the card's runner,
rehearsed on the CPU, a warm run and a run after a change capture
nothing and the graph cache does not grow.
"""

import contextlib
import json
import sys

import numpy as np
import pytest
import torch
from test_torch_api import _path, assert_same_result
from test_torch_cli import _run
from test_torch_engine import _ReplayedBody

import jax.numpy as jnp
from pydcop_tpu.algorithms import base as jax_base
from pydcop_tpu.algorithms.maxsum_dynamic import DynamicMaxSum as JaxSession
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_graph_coloring as jax_graph_coloring,
)
from pydcop_tpu.compile import kernels as jk
from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
from pydcop_tpu.dcop import DCOP as JaxDCOP
from pydcop_tpu.dcop import Domain as JaxDomain
from pydcop_tpu.dcop import ExternalVariable as JaxExternal
from pydcop_tpu.dcop import Variable as JaxVariable
from pydcop_tpu.dcop.relations import constraint_from_str as jax_cfs
from pydcop_tpu.dcop.yamldcop import dcop_yaml
from pydcop_tpu.utils import checkpoint as jax_ckpt
from pydcop_tpu_torch.algorithms import base, maxsum, maxsum_dynamic
from pydcop_tpu_torch.algorithms.maxsum_dynamic import DynamicMaxSum
from pydcop_tpu_torch.compile import kernels as tk
from pydcop_tpu_torch.compile.core import compile_dcop
from pydcop_tpu_torch.dcop import DCOP, Domain, ExternalVariable, Variable
from pydcop_tpu_torch.dcop.relations import constraint_from_str
from pydcop_tpu_torch.dcop.yamldcop import load_dcop
from pydcop_tpu_torch.utils import checkpoint as ckpt

LAYOUTS = [("lanes", "f32"), ("edges", "f32"), ("lanes", "bf16"),
           ("edges", "bf16")]


def _coloring(n=40, seed=4):
    """A JAX soft scale-free coloring and the port's copy of it."""
    ref = jax_graph_coloring(n, 3, "scalefree", m_edge=2, seed=seed)
    return ref, load_dcop(dcop_yaml(ref))


def _sessions(jdcop, pdcop, layout, precision, seed=5, **params):
    params = dict(params, layout=layout, precision=precision)
    return (JaxSession(jdcop, dict(params), seed=seed),
            DynamicMaxSum(pdcop, dict(params), seed=seed, device="cpu"))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_same_session(ps, js):
    """The same warm state: planes bit for bit, selection and cycle."""
    for name in ("v2f", "f2v"):
        got = getattr(ps.state, name).float().numpy()
        want = _f32(getattr(js.state, name))
        assert got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(ps.state.values.numpy(), np.asarray(js.state.values))
    assert int(ps.state.cycle) == int(js.state.cycle)
    assert ps.current_assignment == js.current_assignment


def assert_same(got, want):
    assert got.assignment == want.assignment
    assert (got.cost, got.violations, got.cycles, got.msg_count,
            got.msg_size, got.status) == (
        want.cost, want.violations, want.cycles, want.msg_count,
        want.msg_size, want.status)


def _change(dcop, cfs, name, expr):
    scope = list(dcop.constraints[name].dimensions)
    return cfs(name, expr.format(*(v.name for v in scope)), scope)


@pytest.mark.parametrize("layout, precision", LAYOUTS)
def test_session_matches_jax(layout, precision):
    jdcop, pdcop = _coloring()
    js, ps = _sessions(jdcop, pdcop, layout, precision)
    try:
        for n in (20, 20):
            assert_same(ps.run(n), js.run(n))
            assert_same_session(ps, js)
        name = sorted(jdcop.constraints)[0]
        expr = "10 if {} == {} else 0"
        js.change_factor_function(name, _change(jdcop, jax_cfs, name, expr))
        ps.change_factor_function(
            name, _change(pdcop, constraint_from_str, name, expr)
        )
        got, want = ps.run(20), js.run(20)
        assert_same(got, want)
        assert_same_session(ps, js)
        assert got.cycles == 60
    finally:
        js.close()
        ps.close()


@pytest.mark.parametrize("layout", ["lanes", "edges"])
def test_session_damping_drift_is_the_damping_fma(layout):
    # at damping 0.7 XLA-CPU contracts the session's damping into an FMA
    # at both damping sites; the session's step damps the same way
    # (``damp``'s ``fma``), so its planes are JAX's bit for bit through
    # runs and a change
    jdcop, pdcop = _coloring()
    name = sorted(jdcop.constraints)[0]
    expr = "10 if {} == {} else 0"
    js, ps = _sessions(jdcop, pdcop, layout, "f32", damping=0.7)
    try:
        for i in range(3):
            if i == 2:
                js.change_factor_function(
                    name, _change(jdcop, jax_cfs, name, expr))
                ps.change_factor_function(
                    name, _change(pdcop, constraint_from_str, name, expr))
            assert_same(ps.run(20), js.run(20))
            assert_same_session(ps, js)
    finally:
        js.close()
        ps.close()


@pytest.mark.parametrize("layout", ["lanes", "edges", "ell"])
def test_solve_damping_matches_jax_without_the_fma(layout, tmp_path):
    # the name is the old premise, which was wrong: XLA-CPU contracts the
    # JAX package's fused solve's damping too, and the port's
    # maxsum.solve damps float32 planes in the FMA form (fma_damping on);
    # at damping 0.7 on the session's problem its result AND its final
    # message planes are JAX's bit for bit
    from test_torch_damping import _bits, _solve_planes

    jdcop, pdcop = _coloring()
    params = {"damping": 0.7, "layout": layout}
    want, jv2f, jf2v = _solve_planes(
        "maxsum", jax_compile_dcop(jdcop), params, "fused", tmp_path,
        port=False, n_cycles=60, seed=5)
    got, pv2f, pf2v = _solve_planes(
        "maxsum", compile_dcop(pdcop), params, "fused", tmp_path,
        port=True, n_cycles=60, seed=5)
    assert_same(got, want)
    for p, j in ((pv2f, jv2f), (pf2v, jf2v)):
        assert np.array_equal(_bits(p.numpy()), _bits(j))


def test_session_defaults_run_lanes_like_jax():
    jdcop, pdcop = _coloring(seed=6)
    js = JaxSession(jdcop, {"damping": 0.7}, seed=7)
    ps = DynamicMaxSum(pdcop, {"damping": 0.7}, seed=7, device="cpu")
    # "auto" runs lanes: [D, n_edges] planes
    assert tuple(ps.state.v2f.shape) == (3, ps.compiled.n_edges)
    for n in (30, 30):
        assert_same(ps.run(n), js.run(n))


def _sensor_dcops():
    """x must track a sensor (cost 5 when it differs), y follows x: the
    same problem in both packages."""
    out = []
    for mod in ((JaxDomain, JaxVariable, JaxExternal, JaxDCOP, jax_cfs),
                (Domain, Variable, ExternalVariable, DCOP,
                 constraint_from_str)):
        dom_cls, var_cls, ext_cls, dcop_cls, cfs = mod
        d = dom_cls("c", "", [0, 1, 2])
        x, y = var_cls("x", d), var_cls("y", d)
        sensor = ext_cls("sensor", d, value=0)
        dcop = dcop_cls("ext")
        dcop.add_variable(sensor)
        dcop += cfs("c1", "0 if x == sensor else 5", [x, sensor])
        dcop += cfs("c2", "0 if x == y else 2", [x, y])
        dcop.add_agents([])
        out.append((dcop, sensor))
    return out


@pytest.mark.parametrize("layout", ["lanes", "edges"])
def test_external_variable_update_matches_jax(layout):
    (jdcop, jsensor), (pdcop, psensor) = _sensor_dcops()
    js, ps = _sessions(jdcop, pdcop, layout, "f32")
    try:
        assert_same(ps.run(10), js.run(10))
        jsensor.value = 2
        psensor.value = 2  # the subscription re-lowers the tables
        got, want = ps.run(10), js.run(10)
        assert_same(got, want)
        assert got.assignment["x"] == 2
        assert_same_session(ps, js)
    finally:
        js.close()
        ps.close()
    # closed: a sensor update no longer re-lowers the session
    before = ps.compiled
    psensor.value = 1
    assert ps.compiled is before


def test_change_factor_function_rejects_another_scope():
    _, pdcop = _coloring()
    ps = DynamicMaxSum(pdcop, {}, device="cpu")
    names = sorted(pdcop.constraints)
    a = list(pdcop.constraints[names[0]].dimensions)
    b = list(pdcop.constraints[names[1]].dimensions)
    other = [a[0], b[0] if b[0].name != a[0].name else b[1]]
    with pytest.raises(ValueError, match="scope"):
        ps.change_factor_function(
            names[0], constraint_from_str(names[0], "0", other)
        )
    with pytest.raises(ValueError, match="no constraint"):
        ps.change_factor_function("nope", constraint_from_str("nope", "0", a))


def test_static_solve_is_maxsum():
    _, pdcop = _coloring()
    c = compile_dcop(pdcop)
    assert maxsum_dynamic.solve(c, {}, n_cycles=20, device="cpu") == (
        maxsum.solve(c, {}, n_cycles=20, device="cpu")
    )


def test_apply_noise_is_the_engine_noise_and_jax():
    ref, pdcop = _coloring()
    jc, pc = jax_compile_dcop(ref), compile_dcop(pdcop)
    pdev = tk.to_device(pc, "cpu")
    got = base.apply_noise(pc, pdev, 9, 0.01).unary.numpy()
    want = np.asarray(
        jax_base.apply_noise(jc, jk.to_device(jc), 9, 0.01).unary
    )
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    engine = base._noised(
        pdev, torch.tensor([0, 9]), torch.tensor(0.01)
    ).unary.numpy()
    assert np.array_equal(got, engine)
    assert base.apply_noise(pc, pdev, 9, 0.0) is pdev


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout, precision", LAYOUTS)
def test_checkpoint_from_jax_resumes_in_the_port(layout, precision,
                                                 tmp_path):
    jdcop, pdcop = _coloring()
    js, ps = _sessions(jdcop, pdcop, layout, precision)
    path = str(tmp_path / "jax.npz")
    js.run(15)
    js.save(path)
    ps.restore(path)
    assert_same_session(ps, js)
    assert_same(ps.run(15), js.run(15))
    assert_same_session(ps, js)


@pytest.mark.parametrize("layout, precision", LAYOUTS)
def test_checkpoint_from_the_port_resumes_in_jax(layout, precision,
                                                 tmp_path):
    jdcop, pdcop = _coloring()
    js, ps = _sessions(jdcop, pdcop, layout, precision)
    path = str(tmp_path / "port.npz")
    ps.run(15)
    ps.save(path)
    js.restore(path)
    assert_same_session(ps, js)
    assert_same(js.run(15), ps.run(15))
    assert_same_session(ps, js)


def _square_dcops():
    """n_edges == max_domain == 4: the planes' two orientations have one
    shape (the JAX package's test_square_plane_* problem)."""
    out = []
    for dom_cls, var_cls, dcop_cls, cfs in (
        (JaxDomain, JaxVariable, JaxDCOP, jax_cfs),
        (Domain, Variable, DCOP, constraint_from_str),
    ):
        d = dom_cls("c", "", [0, 1, 2, 3])
        x, y, z = var_cls("x", d), var_cls("y", d), var_cls("z", d)
        dcop = dcop_cls("square")
        dcop += cfs("c1", "10 if x == y else 0", [x, y])
        dcop += cfs("c2", "10 if y == z else 0", [y, z])
        dcop.add_agents([])
        out.append(dcop)
    return out


@pytest.mark.parametrize("src_layout, dst_layout", [
    ("lanes", "edges"), ("edges", "lanes"), ("edges", "edges"),
])
def test_square_plane_checkpoint_crosses_layouts_like_jax(
    src_layout, dst_layout, tmp_path
):
    jdcop, pdcop = _square_dcops()
    src = DynamicMaxSum(pdcop, {"layout": src_layout}, device="cpu")
    src.run(4)
    assert tuple(src.state.v2f.shape) == (4, 4)
    path = str(tmp_path / "sq.npz")
    src.save(path)
    dst = DynamicMaxSum(pdcop, {"layout": dst_layout}, device="cpu")
    dst.restore(path)
    flip = src_layout != dst_layout
    for name in ("v2f", "f2v"):
        plane = getattr(src.state, name)
        assert torch.equal(getattr(dst.state, name), plane.T if flip else
                           plane)
    assert dst.current_assignment == src.current_assignment
    # the JAX package reads the same file into the same planes
    jdst = JaxSession(jdcop, {"layout": dst_layout}, seed=0)
    jdst.restore(path)
    assert_same_session(dst, jdst)
    assert_same(dst.run(4), jdst.run(4))


def test_legacy_square_checkpoint_restores_untransposed_like_jax(tmp_path):
    jdcop, pdcop = _square_dcops()
    ses = DynamicMaxSum(pdcop, {"layout": "edges"}, device="cpu")
    ses.run(4)
    v2f, f2v = ses.state.v2f.clone(), ses.state.f2v.clone()
    path = str(tmp_path / "legacy.npz")
    # 5-leaf legacy layout: (v2f, f2v, cycle, act_v, act_f), no layout
    # metadata
    ckpt.save_checkpoint(
        path,
        (v2f, f2v, torch.tensor(4, dtype=torch.int32),
         torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)),
        metadata={"cycles_done": 4, "msg_count": 32},
    )
    for layout in ("edges", "lanes"):
        dst = DynamicMaxSum(pdcop, {"layout": layout}, device="cpu")
        dst.restore(path)
        flip = layout == "lanes"
        assert torch.equal(dst.state.v2f, v2f.T if flip else v2f)
        assert torch.equal(dst.state.f2v, f2v.T if flip else f2v)
        assert int(dst.state.cycle) == 4
        jdst = JaxSession(jdcop, {"layout": layout}, seed=0)
        jdst.restore(path)
        assert_same_session(dst, jdst)
        assert_same(dst.run(3), jdst.run(3))


def test_checkpoint_format_crosses_between_packages(tmp_path):
    bf = torch.tensor([[1.5, -2.25], [3.0, 0.0078125]], dtype=torch.bfloat16)
    tree = (bf, torch.arange(5, dtype=torch.int32), torch.tensor(7.5))
    path = str(tmp_path / "p.npz")
    ckpt.save_checkpoint(path, tree, metadata={"k": 1})
    leaves, meta = jax_ckpt.load_checkpoint(path)
    assert meta == {"k": 1}
    assert str(leaves[0].dtype) == "bfloat16"
    assert np.array_equal(
        np.asarray(leaves[0], np.float32), bf.float().numpy()
    )
    assert np.array_equal(leaves[1], np.arange(5, dtype=np.int32))
    jpath = str(tmp_path / "j.npz")
    jax_ckpt.save_checkpoint(
        jpath, (jnp.asarray(bf.float().numpy(), jnp.bfloat16),
                jnp.arange(5, dtype=jnp.int32), jnp.float32(7.5)),
        metadata={"k": 2},
    )
    got, meta = ckpt.load_checkpoint(jpath, like=tree)
    assert meta == {"k": 2}
    assert all(torch.equal(g, w) for g, w in zip(got, tree))


def test_checkpoint_refuses_what_does_not_fit(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, (torch.zeros(3), torch.zeros(2)),
                         use_orbax=True)  # no orbax: npz
    ckpt.load_checkpoint(path, like=(torch.ones(3), torch.ones(2)))
    with pytest.raises(ckpt.CheckpointError, match="leaf 1 mismatch"):
        ckpt.load_checkpoint(path, like=(torch.ones(3), torch.ones(4)))
    with pytest.raises(ckpt.CheckpointError, match="has 2 leaves, template has 3"):
        ckpt.load_checkpoint(path, like=(torch.ones(3),) * 3)
    with pytest.raises(ckpt.CheckpointError, match="no checkpoint"):
        ckpt.load_checkpoint(str(tmp_path / "missing.npz"))
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ckpt.CheckpointError, match="orbax"):
        ckpt.load_checkpoint(str(tmp_path / "orbax"))


# ---------------------------------------------------------------------------
# the card's runner, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def graph_runner(monkeypatch):
    monkeypatch.setattr(base, "_capture", _ReplayedBody)
    monkeypatch.setattr(base, "_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        base, "_runner",
        lambda compiled, solver, dev, consts: base._graphs(
            compiled, solver, dev, consts
        ),
    )


@pytest.mark.parametrize("layout", ["lanes", "edges"])
def test_warm_runs_capture_nothing(layout, graph_runner):
    jdcop, pdcop = _coloring()
    js, ps = _sessions(jdcop, pdcop, layout, "f32")

    def run_counted():
        before = base.run_cycles.captures
        got, want = ps.run(30), js.run(30)
        assert_same(got, want)
        assert_same_session(ps, js)
        cache = ps._graph_home.__dict__["_device_consts"]
        return base.run_cycles.captures - before, len(cache)

    captured, size = run_counted()
    assert captured == 2  # cold: the prologue and the chunk
    assert run_counted() == (0, size)
    name = sorted(jdcop.constraints)[1]
    expr = "3 if {} == {} else 1"
    js.change_factor_function(name, _change(jdcop, jax_cfs, name, expr))
    ps.change_factor_function(
        name, _change(pdcop, constraint_from_str, name, expr)
    )
    assert run_counted() == (0, size)
    assert run_counted() == (0, size)


def test_run_cycles_state_is_a_copy_of_the_buffers(graph_runner):
    jdcop, pdcop = _coloring()
    ps = DynamicMaxSum(pdcop, {}, device="cpu")
    ps.run(16)
    graphs = [v for k, v in ps._graph_home._device_consts.items()
              if k[0] == "cycle_graphs"]
    assert len(graphs) == 1
    buffers = {id(b) for b in graphs[0].buffers if b is not None}
    final = base._flatten(graphs[0].state(), [])
    mine = base._flatten(ps.state, [])
    # the session holds a copy of the final buffers in its own tensors
    assert not any(id(t) in buffers for t in mine)
    for a, b in zip(final, mine):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    # the constants the solve passed through are the session's own tensors
    assert all(
        a is b for a, b in zip(base._flatten(graphs[0].state().aux, []),
                               base._flatten(ps.state.aux, []))
    )
    # a solve that asks for no state gets none
    _, _, extras = base.run_cycles(
        ps._graph_home, ps.dev, maxsum_dynamic._resume_init, ps._step,
        base.extract_values, n_cycles=4,
        consts=(ps._inert, ps._inert, ps.state),
    )
    assert "state" not in extras


def test_cli_prints_the_jax_cli_json(tmp_path):
    args = ["solve", "-a", "maxsum_dynamic", "-n", "30",
            _path("graph_coloring")]
    port = _run([sys.executable, "-m", "pydcop_tpu_torch", "--device", "cpu",
                 "--output", str(tmp_path / "port.json"), *args])
    ref = _run([sys.executable, "-m", "pydcop_tpu", *args],
               env={"JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    assert_same_result(json.loads((tmp_path / "port.json").read_text()),
                       json.loads(ref.stdout), "maxsum")
