"""The serving path of the port (``pydcop_tpu_torch.serve``) against the
JAX package's (``pydcop_tpu.serve``), both on the CPU.

Bars:

- the shape buckets (``bucket_dims_of``, ``pad_dev_to_bucket``,
  ``pad_ell_classes``) give the JAX package's arrays bit for bit;
- the port's ``solve_one`` gives the JAX package's ``solve_one`` result
  (assignment, cost, violations, cycles and the cycle of the best); its
  float32 ``best_cost`` within rel 1e-6, since XLA-CPU sums a fused
  gather of 22 to 32 unary entries in another order (ROADMAP, "Known
  divergences");
- ``solve_batched(mode="vmap")`` gives each tenant the bits of the port's
  own ``solve_one``: assignment, cost, cycles, best cost and its cycle,
  with two buckets, mixed budgets, K padded to a power of two, and rows
  over 32 and over 1,024 values;
- ``mode="fused"`` gives the JAX package's fused results tenant by
  tenant;
- a request that cannot be batched fails alone; the server queues,
  batches, drains and answers over HTTP.
"""

import contextlib
import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_engine import _ReplayedBody

from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_generate,
)
from pydcop_tpu.compile import kernels as jk
from pydcop_tpu.serve import SolveRequest as JaxRequest
from pydcop_tpu.serve import bucket as jax_bucket
from pydcop_tpu.serve import solve_batched as jax_solve_batched
from pydcop_tpu.serve import solve_one as jax_solve_one
from pydcop_tpu_torch.algorithms import base, maxsum
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_coloring_arrays,
)
from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile import kernels as tk
from pydcop_tpu_torch.compile.kernels import build_ell
from pydcop_tpu_torch.serve import (
    ServeServer,
    ServeUnsupported,
    SolveRequest,
    bucket,
    bucket_key,
    solve_batched,
    solve_one,
)
from pydcop_tpu_torch.serve import batch as serve_batch


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _reqs(algo, params, sizes, cycles, seed0=700, jax=False):
    """One request a size: a grid coloring of that many variables."""
    gen, req = (jax_generate, JaxRequest) if jax else (
        generate_coloring_arrays, SolveRequest)
    return [
        req(f"{algo}{i}", gen(n, 3, graph="grid", seed=seed0 + i), algo,
            dict(params), cycles, seed0 + 3 * i)
        for i, n in enumerate(sizes)
    ]


def assert_same_tenant(got, want, best_cost_rel=0.0):
    assert got.result.assignment == want.result.assignment
    assert got.result.cost == want.result.cost
    assert got.result.violations == want.result.violations
    assert got.result.cycles == want.result.cycles
    assert got.result.msg_count == want.result.msg_count
    assert got.extras["cycles"] == want.extras["cycles"]
    assert got.extras["cycles_to_best"] == want.extras["cycles_to_best"]
    if best_cost_rel:
        assert got.extras["best_cost"] == pytest.approx(
            want.extras["best_cost"], rel=best_cost_rel)
    else:
        assert got.extras["best_cost"] == want.extras["best_cost"]


# -- the shape buckets -----------------------------------------------------


@pytest.mark.parametrize("n, graph", [(25, "grid"), (49, "grid"),
                                      (60, "scalefree")])
def test_bucket_dims_and_padding_are_jaxs(n, graph):
    kw = dict(m_edge=2) if graph == "scalefree" else {}
    port = generate_coloring_arrays(n, 3, graph=graph, seed=3, **kw)
    ref = jax_generate(n, 3, graph=graph, seed=3, **kw)
    dims = bucket.bucket_dims_of(port)
    assert tuple(dims) == tuple(jax_bucket.bucket_dims_of(ref))
    got = bucket.pad_dev_to_bucket(tk.to_device(port, "cpu"), dims)
    want = jax_bucket.pad_dev_to_bucket(jk.to_device(ref), dims)
    assert (got.n_vars, got.n_edges, got.n_constraints) == (
        want.n_vars, want.n_edges, want.n_constraints)
    for f in ("domain_size", "valid_mask", "unary", "constant_cost",
              "edge_var", "edge_con", "var_degree", "f2v_perm"):
        assert np.array_equal(_np(getattr(got, f)), _np(getattr(want, f))), f
    for gb, wb in zip(got.buckets, want.buckets):
        for f in ("tables_flat", "var_slots", "edge_ids", "con_ids"):
            assert np.array_equal(_np(getattr(gb, f)), _np(getattr(wb, f)))
    # the fan-in segments of the padded problem: every padded edge on the
    # first dead variable
    want_off = np.concatenate([[0], np.cumsum(np.bincount(
        _np(want.edge_var), minlength=dims.n_vars))])
    assert np.array_equal(_np(got.fan_in_offsets), want_off)


def test_padding_refuses_too_small_targets():
    dev = tk.to_device(generate_coloring_arrays(9, 3, graph="grid", seed=1),
                       "cpu")
    from pydcop_tpu_torch.parallel.mesh import pad_device_dcop_to

    with pytest.raises(ValueError):
        pad_device_dcop_to(dev, dev.n_vars, 64, 64, (16,))
    with pytest.raises(ValueError):
        pad_device_dcop_to(dev, 16, 64, 64, (8,))
    with pytest.raises(ValueError):
        pad_device_dcop_to(dev, 16, dev.n_edges, 64, (16,))


@pytest.mark.parametrize("n, graph", [(49, "grid"), (80, "scalefree")])
def test_pad_ell_classes_is_jaxs(n, graph):
    kw = dict(m_edge=2) if graph == "scalefree" else {}
    port = generate_coloring_arrays(n, 3, graph=graph, seed=5, **kw)
    ref = jax_generate(n, 3, graph=graph, seed=5, **kw)
    got = bucket.pad_ell_classes(build_ell(port))
    want = jax_bucket.pad_ell_classes(jk.build_ell(ref, 1, None))
    assert got.spans == want.spans
    assert all(nb & (nb - 1) == 0 for nb, _ in got.spans)
    for f in ("var_perm", "pos_of_var", "edge_orig", "pair_perm", "tabs_t",
              "edge_valid_t", "valid_ell_t", "dsize_edges", "real_row"):
        assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f)))


# -- solve_one: the port against the JAX package ---------------------------

SOLO = {
    "dsa-B": ("dsa", {}),
    "dsa-A": ("dsa", {"variant": "A"}),
    "dsa-C": ("dsa", {"variant": "C"}),
    "mgm": ("mgm", {}),
    "mgm2": ("mgm2", {}),
    "maxsum": ("maxsum", {"damping": 0.5}),
    "maxsum-noise0": ("maxsum", {"damping": 0.5, "noise": 0.0}),
}


@pytest.mark.parametrize("case", sorted(SOLO))
def test_solve_one_is_jaxs(case):
    algo, params = SOLO[case]
    sizes = (25, 49)
    for got_req, ref_req in zip(_reqs(algo, params, sizes, 20),
                                _reqs(algo, params, sizes, 20, jax=True)):
        got = solve_one(got_req, device="cpu")
        want = jax_solve_one(ref_req)
        assert_same_tenant(got, want, best_cost_rel=1e-6)
        assert np.array_equal(got.extras["best_values"],
                              np.asarray(want.extras["best_values"]))


def test_solve_one_is_the_plain_solve_for_dsa():
    # DSA draws by position: the bucket's rows add draws past the real
    # ones, so the padded solve follows the unpadded one
    from pydcop_tpu_torch.algorithms import dsa

    (req,) = _reqs("dsa", {}, (49,), 30)
    one = solve_one(req, device="cpu").result
    plain = dsa.solve(req.compiled, {}, n_cycles=30, seed=req.seed,
                      device="cpu")
    assert (one.assignment, one.cost, one.cycles) == (
        plain.assignment, plain.cost, plain.cycles)


# -- the batch: each tenant's solve_one bits ------------------------------

BATCHES = {
    "dsa": ("dsa", {}, (49, 49, 49, 25, 25), 20),
    "dsa-A": ("dsa", {"variant": "A"}, (25, 25, 49), 15),
    "dsa-C": ("dsa", {"variant": "C"}, (25, 49), 15),
    "mgm": ("mgm", {}, (49, 49, 49, 25, 25), 20),
    "mgm2": ("mgm2", {}, (25, 25, 49), 15),
    "maxsum": ("maxsum", {"damping": 0.5}, (49, 49, 49, 25, 25), 20),
    "maxsum-noise0": ("maxsum", {"damping": 0.5, "noise": 0.0}, (49, 25),
                      15),
}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_batch_is_solve_one_bit_for_bit(case):
    algo, params, sizes, cycles = BATCHES[case]
    reqs = _reqs(algo, params, sizes, cycles)
    assert len({bucket_key(r) for r in reqs}) == 2  # two buckets
    degraded = solve_batched.degraded
    out = solve_batched(reqs, device="cpu")
    assert solve_batched.degraded == degraded
    for r in reqs:
        tr = out[r.tenant]
        assert tr.extras["batch_size"] in (sizes.count(25), sizes.count(49))
        assert_same_tenant(tr, solve_one(r, device="cpu"))
        assert "degraded" not in tr.extras


def test_mixed_budgets_and_padded_k_stay_bit_for_bit():
    # per-instance budgets are operands: tenants of one budget class
    # share one batch; 5 tenants run as 8, the pads with a budget of 0
    reqs = [
        SolveRequest(f"t{i}", generate_coloring_arrays(
            25, 3, graph="grid", seed=800 + i), "dsa", {}, n, 800 + i)
        for i, n in enumerate((9, 12, 16, 14, 11))
    ]
    assert len({bucket_key(r) for r in reqs}) == 1
    out = solve_batched(reqs, device="cpu")
    for r in reqs:
        tr = out[r.tenant]
        assert (tr.extras["batch_size"], tr.extras["k_pad"]) == (5, 8)
        assert tr.extras["cycles"] == r.n_cycles
        assert_same_tenant(tr, solve_one(r, device="cpu"))


def test_batch_rows_over_32_and_1024_values():
    # 33x33 grids: 1,089 variables (unary rows of 2,048 in the bucket,
    # over 1,024: the long rows of the card's tree sums) and MaxSum's
    # ELL fan-in; a scale-free hub's degree class over 32 slots
    reqs = [
        SolveRequest(f"g{i}", generate_coloring_arrays(
            1089, 3, graph="grid", seed=60 + i), "maxsum", {"damping": 0.5},
            6, i)
        for i in range(2)
    ] + [
        SolveRequest(f"s{i}", generate_coloring_arrays(
            300, 3, graph="scalefree", m_edge=2, seed=70), "maxsum",
            {"damping": 0.5}, 8, i)
        for i in range(2)
    ]
    spans = bucket_key(reqs[-1]).extra[0]
    assert max(db for _, db in spans) > 32
    out = solve_batched(reqs, device="cpu")
    for r in reqs:
        assert_same_tenant(out[r.tenant], solve_one(r, device="cpu"))


def test_fused_mode_is_jaxs_fused_mode():
    # bench config 8's mix at a third of its tenants: two sizes, one
    # union, one fleet seed
    spec = [(9, 300 + i) for i in range(6)] + [(16, 400 + i)
                                              for i in range(3)]
    reqs = [SolveRequest(f"t{i}", generate_coloring_arrays(
        n, 3, graph="grid", seed=s), "dsa", {}, 16, i)
        for i, (n, s) in enumerate(spec)]
    jreqs = [JaxRequest(f"t{i}", jax_generate(n, 3, graph="grid", seed=s),
                        "dsa", {}, 16, i) for i, (n, s) in enumerate(spec)]
    got = solve_batched(reqs, mode="fused", device="cpu")
    want = jax_solve_batched(jreqs, mode="fused")
    for r in reqs:
        g, w = got[r.tenant], want[r.tenant]
        assert g.extras["mode"] == "fused" and g.extras["batch_size"] == 9
        assert (g.result.assignment, g.result.cost, g.result.violations,
                g.result.cycles) == (w.result.assignment, w.result.cost,
                                     w.result.violations, w.result.cycles)
    # a repeated composition reuses its union
    assert solve_batched(reqs, mode="fused", device="cpu") == got


@pytest.mark.parametrize("algo, params", [("mgm", {}), ("maxsum", {})])
def test_fused_mode_of_mgm_and_maxsum_is_jaxs(algo, params):
    sizes = (9, 16, 9)
    reqs, jreqs = (_reqs(algo, params, sizes, 12, jax=j)
                   for j in (False, True))
    got = solve_batched(reqs, mode="fused", device="cpu")
    want = jax_solve_batched(jreqs, mode="fused")
    for r in reqs:
        assert got[r.tenant].result == want[r.tenant].result


def test_unbatchable_requests_fail_alone():
    from pydcop_tpu_torch.commands.generators.mixedproblem import (
        generate_mixed_problem,
    )
    from pydcop_tpu_torch.compile.core import compile_dcop

    good = _reqs("dsa", {}, (25, 25), 10)
    ternary = compile_dcop(generate_mixed_problem(
        12, 8, 0.5, arity=3, seed=2))
    bad = [
        SolveRequest("unsupported", good[0].compiled, "dpop", {}, 10, 0),
        SolveRequest("unhashable", good[0].compiled, "dsa",
                     {"probability": [0.5]}, 10, 0),
        SolveRequest("nonbinary", ternary, "maxsum", {}, 10, 0),
        SolveRequest("nonbinary2", ternary, "mgm2", {}, 10, 0),
    ]
    out = solve_batched(good + bad, device="cpu")
    for r in good:
        assert_same_tenant(out[r.tenant], solve_one(r, device="cpu"))
    for r in bad:
        assert out[r.tenant].result is None
        assert out[r.tenant].extras["error"]
    with pytest.raises(ServeUnsupported):
        bucket_key(bad[2])


def test_a_failed_batch_degrades_loudly(monkeypatch):
    reqs = _reqs("dsa", {}, (25, 25), 10)
    want = {r.tenant: solve_one(r, device="cpu") for r in reqs}

    def broken(*args, **kwargs):
        raise RuntimeError("batched kernel broke")

    monkeypatch.setattr(serve_batch, "_dispatch_group", broken)
    degraded = solve_batched.degraded
    out = solve_batched(reqs, device="cpu")
    assert solve_batched.degraded == degraded + 1
    for r in reqs:
        assert out[r.tenant].extras["degraded"] == (
            "RuntimeError: batched kernel broke")
        assert_same_tenant(out[r.tenant], want[r.tenant])


def test_warm_batch_captures_nothing(monkeypatch):
    # the card's runner rehearsed on the CPU (graphs that rerun their
    # bodies): the first batch of a bucket and K class captures its two
    # graphs on the slot's stacked tensors, the next batch of that bucket
    # (other tenants) none, with each tenant's solve_one bits
    monkeypatch.setattr(base, "_capture", _ReplayedBody)
    monkeypatch.setattr(base, "_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        base, "_runner",
        lambda compiled, solver, dev, consts: base._graphs(
            compiled, solver, dev, consts),
    )
    monkeypatch.setattr(serve_batch, "_slots", type(serve_batch._slots)())
    first = _reqs("maxsum", {"damping": 0.5}, (25, 25, 25), 12, seed0=900)
    second = [r._replace(tenant=f"second{i}") for i, r in enumerate(
        _reqs("maxsum", {"damping": 0.5}, (25, 25, 25), 12, seed0=950))]
    captures = base.run_cycles.captures
    out = solve_batched(first, device="cpu")
    assert base.run_cycles.captures == captures + 2
    out.update(solve_batched(second, device="cpu"))
    assert base.run_cycles.captures == captures + 2
    for r in first + second:
        assert_same_tenant(out[r.tenant], solve_one(r, device="cpu"))


# -- the batched kernel calls: one call for K instances --------------------


def _ell_batch(k, seed=0):
    reqs = _reqs("maxsum", {}, (49,) * k, 10, seed0=40 + seed)
    ells = [maxsum._serve_ell(r.compiled) for r in reqs]
    assert len({e.spans for e in ells}) == 1
    rng = np.random.default_rng(seed)
    planes = [torch.as_tensor(rng.normal(size=e.tabs_t.shape[1:]),
                              dtype=torch.float32) for e in ells]
    for p, e in zip(planes, ells):
        p[:, ~e.real_row[0]] = 0.0
    return ells, planes


def _stack(xs):
    return torch.stack([torch.as_tensor(x) for x in xs])


@pytest.mark.parametrize("k", [1, 3])
def test_vmapped_kernel_calls_are_each_instance_alone(k):
    # the wrappers' vmap rules on the CPU: one mapped call gives, instance
    # by instance, the solo call's bits
    ells, planes = _ell_batch(k)
    args = [
        _stack(planes),
        _stack([e.pair_perm for e in ells]),
        _stack([e.tabs_t for e in ells]),
        _stack([e.real_row for e in ells]),
    ]
    got = torch.func.vmap(hk.ell_minplus)(*args)
    assert torch.equal(got, hk.ell_minplus_batched(*args))
    for i in range(k):
        want = hk.ell_minplus(*(a[i] for a in args))
        assert torch.equal(got[i], want)
    spans = ells[0].spans
    unary = torch.randn(k, 3, ells[0].valid_ell_t.shape[1])
    tot, v2f = torch.func.vmap(
        lambda u, f: hk.ell_fan_in(spans, u, f))(unary, got)
    for i in range(k):
        t1, v1 = hk.ell_fan_in(spans, unary[i], got[i])
        assert torch.equal(tot[i], t1) and torch.equal(v2f[i], v1)
    x = torch.randn(k, 2100)
    sums = torch.func.vmap(hk.xla_tree_sum)(x)
    for i in range(k):
        assert torch.equal(sums[i], hk.xla_tree_sum(x[i]))


def test_vmapped_evaluate_is_each_instance_alone():
    reqs = _reqs("dsa", {}, (1089, 1089), 5, seed0=30)
    dims = bucket.bucket_dims_of(reqs[0].compiled)
    devs = [bucket.pad_dev_to_bucket(tk.to_device(r.compiled, "cpu"), dims)
            for r in reqs]
    values = torch.randint(0, 3, (2, dims.n_vars), dtype=torch.int32)
    unary = _stack([d.unary for d in devs])
    tables = [_stack([d.buckets[0].tables_flat for d in devs])]
    slots = [_stack([d.buckets[0].var_slots for d in devs])]
    const = _stack([d.constant_cost for d in devs])
    got = torch.func.vmap(
        lambda u, v, t, s, c: hk.tree_evaluate(u, v, [(t, s)], c)
    )(unary, values, tables[0], slots[0], const)
    for i, d in enumerate(devs):
        assert torch.equal(got[i], tk.evaluate(d, values[i]))


def test_vmapped_segment_sum_is_each_instance_alone():
    x = torch.randn(3, 40, 4)
    offsets = torch.stack([torch.tensor([0, 5, 5, 40]),
                           torch.tensor([0, 1, 39, 40]),
                           torch.tensor([0, 20, 30, 40])])
    got = torch.func.vmap(lambda a, o: tk.segment_sum(a, o, 0))(x, offsets)
    for i in range(3):
        assert torch.equal(got[i], tk.segment_sum(x[i], offsets[i], 0))
    lanes = torch.func.vmap(lambda a, o: tk.segment_sum(a, o, 1))(
        x.transpose(1, 2).contiguous(),
        offsets[:, None, :].expand(-1, 4, -1).contiguous(),
    )
    assert torch.equal(lanes, got.transpose(1, 2))


# -- the server -------------------------------------------------------------


def test_server_submit_wait_status_drain():
    srv = ServeServer(window_ms=20, max_batch=8, device="cpu")
    reqs = _reqs("dsa", {}, (25, 25, 25, 49), 12, seed0=10)
    try:
        ids = [srv.submit(r) for r in reqs]
        rows = [srv.wait(t, timeout=120) for t in ids]
        assert [r["status"] for r in rows] == ["done"] * 4
        for r, row in zip(reqs, rows):
            want = solve_one(r, device="cpu").result
            assert (row["cost"], row["assignment"]) == (want.cost,
                                                       want.assignment)
        st = srv.status()
        assert st["tenant_counts"] == {"done": 4}
        assert st["solves"] == 4 and st["dead_letters"] == 0
        assert st["degraded"] == 0 and st["buckets"] == 2
        assert st["queue_ms"]["p50"] is not None
        assert srv.result("nobody")["status"] == "unknown"
    finally:
        assert srv.drain(timeout=60)
    assert srv.status()["state"] == "drained"
    with pytest.raises(RuntimeError):
        srv.submit(reqs[0]._replace(tenant="late"))


def test_server_fails_and_kills_only_their_tenants():
    srv = ServeServer(window_ms=50, max_batch=8, device="cpu")
    good = _reqs("dsa", {}, (25, 25), 10, seed0=20)
    try:
        bad = srv.submit(good[0]._replace(tenant="bad", algo="dpop"))
        ok = [srv.submit(r) for r in good]
        victim = srv.submit(good[1]._replace(tenant="victim"))
        srv.kill(victim)
        assert srv.wait("bad")["status"] == "failed"
        assert srv.wait(victim)["status"] == "killed"
        assert [srv.wait(t)["status"] for t in ok] == ["done", "done"]
        assert srv.status()["dead_letters"] == 2
        assert not srv.kill(ok[0])  # terminal already
        with pytest.raises(ValueError):
            srv.submit(good[0])  # a known tenant id
    finally:
        srv.shutdown()


def test_server_evicts_old_terminal_records(monkeypatch):
    from pydcop_tpu_torch.serve import server as srv_mod

    monkeypatch.setattr(srv_mod, "TENANT_RETAIN", 2)
    srv = ServeServer(window_ms=0, max_batch=1, device="cpu")
    try:
        reqs = _reqs("dsa", {}, (9, 9, 9), 4, seed0=30)
        for r in reqs:
            srv.wait(srv.submit(r))
        assert srv.result(reqs[0].tenant)["status"] == "unknown"
        assert srv.result(reqs[2].tenant)["status"] == "done"
    finally:
        srv.shutdown()


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_solve_result_status_shutdown():
    from test_torch_api import _path

    from pydcop_tpu_torch.api import solve_result
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

    srv = ServeServer(port=0, window_ms=5, device="cpu")
    port = srv.http.port
    try:
        path = _path("graph_coloring")
        with open(path) as f:
            yaml_text = f.read()
        code, doc = _http(port, "/solve", {
            "dcop_yaml": yaml_text, "algo": "dsa", "n_cycles": 30,
            "seed": 3, "tenant": "http-1",
        })
        assert (code, doc) == (200, {"tenant": "http-1"})
        assert srv.wait("http-1")["status"] == "done"
        code, row = _http(port, "/result/http-1")
        want = solve_result(load_dcop_from_file([path]), "dsa",
                            n_cycles=30, seed=3, device="cpu")
        assert code == 200
        assert (row["cost"], row["violations"], row["cycles"],
                row["assignment"]) == (want["cost"], want["violation"],
                                       want["cycle"], want["assignment"])
        assert _http(port, "/result/nobody")[0] == 404
        code, st = _http(port, "/status")
        assert code == 200 and st["tenant_counts"] == {"done": 1}
        assert _http(port, "/solve", {"algo": "dsa"})[0] == 400
        assert _http(port, "/nowhere")[0] == 404
        # a drained server refuses new tenants, its front still up
        assert srv.drain(timeout=60)
        code, doc = _http(port, "/solve", {"dcop_yaml": yaml_text})
        assert code == 503 and doc["state"] == "drained"
        assert _http(port, "/shutdown", {}) == (200, {"state": "draining"})
        assert srv.wait_drained(60)
    finally:
        srv.shutdown()


def test_serving_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (req,) = _reqs("dsa", {}, (9,), 4)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_one(req)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_batched([req])
    with pytest.raises(RuntimeError, match="cuda"):
        ServeServer()


def test_union_is_the_disjoint_union():
    from pydcop_tpu_torch.serve.union import fleet_seed, union_compiled

    parts = [generate_coloring_arrays(n, 3, graph="grid", seed=n)
             for n in (9, 16)]
    union, blocks = union_compiled(parts)
    assert blocks == [(0, 9), (9, 25)]
    assert union.n_vars == 25 and union.n_edges == sum(
        p.n_edges for p in parts)
    assert np.all(np.diff(union.edge_var) >= 0)
    assert fleet_seed([1, 2]) == fleet_seed([1, 2]) != fleet_seed([2, 1])
    with pytest.raises(ValueError):
        union_compiled([])
    other = dataclasses.replace(parts[1], objective="max")
    with pytest.raises(ValueError):
        union_compiled([parts[0], other])
