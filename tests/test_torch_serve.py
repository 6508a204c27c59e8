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
import os
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
        # the answer echoes the tenant and its fresh trace id
        assert code == 200 and set(doc) == {"tenant", "trace"}
        assert doc["tenant"] == "http-1" and len(doc["trace"]) == 16
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


# ---------------------------------------------------------------------------
# fault schedules on the server: tenant kills and holds
# ---------------------------------------------------------------------------


def _kill_schedule(pkg, pattern="victim*", at=0.0):
    return pkg.FaultSchedule(seed=0, events=[pkg.KillEvent(agent=pattern,
                                                            at=at)])


@pytest.mark.parametrize("algo, params", [
    ("dsa", {}), ("maxsum", {"damping": 0.7}),
])
def test_chaos_kill_degrades_only_the_victims(algo, params):
    # a kill of "victim*" at t=0: the victims ride the batch, their
    # results are dropped (killed, dead letters), and every tenant beside
    # them keeps its solo bits; the JAX server kills the same tenants
    from pydcop_tpu import chaos as jax_chaos
    from pydcop_tpu.serve import ServeServer as JaxServer
    from pydcop_tpu_torch import chaos

    def tenants(jax=False):
        return _reqs(algo, params, (25, 25, 25), 12, seed0=40, jax=jax), [
            r._replace(tenant=f"victim-{i}") for i, r in enumerate(
                _reqs(algo, params, (25, 25), 12, seed0=90, jax=jax))
        ]

    statuses = {}
    for name, make in (
        ("port", lambda: ServeServer(
            window_ms=200, max_batch=8, device="cpu",
            fault_schedule=_kill_schedule(chaos))),
        ("jax", lambda: JaxServer(
            port=None, window_ms=200, max_batch=8,
            fault_schedule=_kill_schedule(jax_chaos))),
    ):
        reqs, victims = tenants(jax=name == "jax")
        srv = make()
        try:
            for r in reqs + victims:
                srv.submit(r)
            rows = {r.tenant: srv.wait(r.tenant, timeout=120)
                    for r in reqs + victims}
            st = srv.status()
        finally:
            srv.shutdown(drain=True)
        statuses[name] = {t: row["status"] for t, row in rows.items()}
        assert st["dead_letters"] == 2
        assert st["tenant_counts"] == {"done": 3, "killed": 2}
        if name == "port":
            for r in reqs:
                want = solve_one(r, device="cpu")
                assert rows[r.tenant]["cost"] == want.result.cost
                assert rows[r.tenant]["assignment"] == \
                    want.result.assignment
            for v in victims:
                assert rows[v.tenant]["error"] == "killed by chaos schedule"
                assert "cost" not in rows[v.tenant]
    assert statuses["port"] == statuses["jax"]


def test_chaos_kill_due_later_spares_earlier_batches():
    # a kill due at t=60 s has not fired when these batches run
    from pydcop_tpu_torch import chaos

    srv = ServeServer(window_ms=20, max_batch=8, device="cpu",
                      fault_schedule=_kill_schedule(chaos, "v*", at=60.0))
    try:
        reqs = [r._replace(tenant=f"v{i}") for i, r in
                enumerate(_reqs("dsa", {}, (9, 9), 6, seed0=5))]
        for r in reqs:
            srv.submit(r)
        assert [srv.wait(r.tenant)["status"] for r in reqs] == ["done"] * 2
        assert srv.status()["dead_letters"] == 0
    finally:
        srv.shutdown()


def test_chaos_delay_holds_only_the_victims_deterministically():
    from pydcop_tpu_torch.chaos import FaultSchedule, MessageRule

    schedule = FaultSchedule(seed=3, events=[
        MessageRule(action="delay", pattern="solve", dest="lag*",
                    seconds=0.6),
    ])
    held = []
    for _run in range(2):
        srv = ServeServer(window_ms=10, max_batch=8, device="cpu",
                          fault_schedule=schedule)
        try:
            ok = _reqs("dsa", {}, (9, 9), 8, seed0=60)
            lag = [r._replace(tenant=f"lag-{i}") for i, r in
                   enumerate(_reqs("dsa", {}, (9, 9), 8, seed0=60))]
            for r in ok + lag:
                srv.submit(r)
            out = {}
            for r in ok + lag:
                rec = srv.wait(r.tenant, timeout=120)
                assert rec["status"] == "done"
                out[r.tenant] = rec["queue_ms"]
                # a held tenant still gets its solo bits
                want = solve_one(r, device="cpu").result
                assert (rec["cost"], rec["assignment"]) == (
                    want.cost, want.assignment)
        finally:
            srv.shutdown(drain=True)
        for t, q_ms in out.items():
            if t.startswith("lag-"):
                assert q_ms >= 600.0, (t, q_ms)
            else:
                assert q_ms < 600.0, (t, q_ms)
        held.append({t: q >= 600.0 for t, q in out.items()})
    assert held[0] == held[1]


@pytest.mark.parametrize("p, seed", [(0.5, 1), (0.2, 7), (1.0, 2)])
def test_chaos_hold_decisions_are_jaxs(p, seed):
    # which tenants a probabilistic delay rule holds, and for how long:
    # the JAX server's keyed-hash decisions, tenant by tenant
    from pydcop_tpu import chaos as jax_chaos
    from pydcop_tpu.serve import ServeServer as JaxServer
    from pydcop_tpu_torch import chaos

    def schedule(pkg):
        return pkg.FaultSchedule(seed=seed, events=[
            pkg.MessageRule(action="delay", pattern="solve", dest="t*",
                            p=p, seconds=0.25),
            pkg.MessageRule(action="drop", pattern="*"),
            pkg.MessageRule(action="delay", pattern="solve", dest="t1*",
                            seconds=0.5),
        ])

    port = ServeServer(window_ms=0, device="cpu",
                       fault_schedule=schedule(chaos))
    ref = JaxServer(port=None, window_ms=0,
                    fault_schedule=schedule(jax_chaos))
    try:
        tenants = [f"t{i}" for i in range(60)] + ["other", "x1"]
        got = [port._chaos_hold_s(t) for t in tenants]
        assert got == [ref._chaos_hold_s(t) for t in tenants]
        assert 0.0 in got and 0.25 in got
    finally:
        port.shutdown()
        ref.shutdown()


# -- the live surface: metrics, health, window, trace ids, SLOs -------------


def _serve_surface(pkg, make_server, reqs):
    """``reqs`` through a server with a kill schedule for "dead*", an SLO
    engine and the registry on, all in one batch window; then the
    /healthz and /window sequence, a drain, /healthz again and
    /metrics.json.  Returns
    the serve.* and slo.* part of /metrics.json, the HTTP answers and the
    tenants' records."""
    reg, engine_mod = pkg
    reg.reset()
    reg.enabled = True
    engine = engine_mod.SloEngine(
        [engine_mod.parse_objective("availability>=99%")],
        eval_interval_s=0.05, postmortem_path=os.devnull)
    srv = make_server(engine)
    try:
        port = srv.http.port
        for i, r in enumerate(reqs):
            srv.submit(r, trace=f"{i:016x}")
        rows = {r.tenant: srv.wait(r.tenant, timeout=300) for r in reqs}
        answers = [_http(port, "/healthz")]
        for body in ({"window_ms": 5}, {"window_ms": 99999},
                     {"window_ms": -3}, {}, {"window_ms": "x"},
                     {"window_ms": None}):
            answers.append(_http(port, "/window", body))
        assert srv.drain(timeout=120)
        answers.append(_http(port, "/healthz"))
        # after the drain's last SLO tick: no evaluator runs any more
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics.json", timeout=60) as resp:
            snap = json.loads(resp.read())["metrics"]
        slo = _http(port, "/slo")
    finally:
        srv.shutdown()
        reg.enabled = False
    live = {k: v for k, v in snap.items() if k.startswith(("serve.",
                                                           "slo."))}
    return live, answers, rows, slo


def _values(live, name):
    return {tuple(sorted(v["labels"].items())): v["value"]
            for v in live[name]["values"]}


def test_live_surface_counts_what_jaxs_counts():
    # bench config 8's DSA tenants of two buckets and two killed ones, one
    # batch a bucket: the same serve.* and slo.* series, label sets and
    # counts as the JAX server's, the same /healthz and /window answers
    from pydcop_tpu import chaos as jax_chaos
    from pydcop_tpu.serve import ServeServer as JaxServer
    from pydcop_tpu.telemetry import metrics_registry as jax_registry
    from pydcop_tpu.telemetry import slo as jax_slo
    from pydcop_tpu_torch import chaos
    from pydcop_tpu_torch.telemetry import metrics_registry
    from pydcop_tpu_torch.telemetry import slo

    def tenants(jax=False):
        reqs = (_reqs("dsa", {}, (9, 9, 9, 9, 9), 16, seed0=300, jax=jax)
                + [r._replace(tenant=f"s{i}") for i, r in enumerate(
                    _reqs("dsa", {}, (16, 16), 16, seed0=400, jax=jax))]
                + [r._replace(tenant=f"dead{i}") for i, r in enumerate(
                    _reqs("dsa", {}, (9, 16), 16, seed0=500, jax=jax))])
        return reqs

    reqs = tenants()
    port = _serve_surface((metrics_registry, slo), lambda eng: ServeServer(
        port=0, window_ms=1500, max_batch=len(reqs), device="cpu",
        fault_schedule=_kill_schedule(chaos, "dead*"), slo=eng), reqs)
    jreqs = tenants(jax=True)
    jax = _serve_surface((jax_registry, jax_slo), lambda eng: JaxServer(
        port=0, window_ms=1500, max_batch=len(jreqs),
        fault_schedule=_kill_schedule(jax_chaos, "dead*"), slo=eng), jreqs)
    (live, answers, rows, slo_doc), (jlive, janswers, jrows, jslo) = port, jax
    assert sorted(live) == sorted(jlive)
    for name in live:
        assert sorted(_values(live, name)) == sorted(_values(jlive, name)), \
            name
    for name in ("serve.batches", "serve.solves", "serve.pad_instances",
                 "serve.dead_letters", "serve.tenants", "slo.events"):
        assert _values(live, name) == _values(jlive, name), name
    (size,) = _values(live, "serve.batch_size").values()
    (jsize,) = _values(jlive, "serve.batch_size").values()
    assert (size["count"], size["sum"]) == (jsize["count"], jsize["sum"])
    assert (size["count"], size["sum"]) == (2, 9)
    assert _values(live, "serve.dead_letters") == {(): 2.0}
    assert _values(live, "slo.events") == {
        (("objective", "availability"), ("outcome", "bad")): 2.0,
        (("objective", "availability"), ("outcome", "good")): 7.0}
    assert answers == janswers
    assert answers[0] == (200, {"state": "serving", "queue_depth": 0})
    assert [a[1].get("window_ms") for a in answers[1:4]] == [5, 10000, 0]
    assert [a[0] for a in answers[4:7]] == [400] * 3
    assert answers[-1] == (503, {"state": "drained", "queue_depth": 0})
    assert slo_doc[0] == jslo[0] == 200
    assert slo_doc[1]["objectives"][0]["bad"] == 2
    for t, row in rows.items():
        assert row["status"] == jrows[t]["status"]
        assert row["trace"] == jrows[t]["trace"]
        assert set(row["phases"]) == set(jrows[t]["phases"]) == {
            "queue", "assemble", "dispatch", "solve", "readback"}
        assert row["batch_seq"] in (1, 2)


def test_trace_ids_are_echoed_and_accepted_on_resubmit():
    from test_torch_api import _path

    from pydcop_tpu_torch import chaos

    srv = ServeServer(port=0, window_ms=5, device="cpu",
                      fault_schedule=_kill_schedule(chaos, "dead*"))
    port = srv.http.port
    try:
        with open(_path("graph_coloring")) as f:
            yaml_text = f.read()
        body = {"dcop_yaml": yaml_text, "algo": "dsa", "n_cycles": 8}
        code, doc = _http(port, "/solve", dict(body, tenant="dead-1",
                                               trace="feedbeef00000001"))
        assert (code, doc) == (200, {"tenant": "dead-1",
                                     "trace": "feedbeef00000001"})
        assert srv.wait("dead-1")["status"] == "killed"
        # the retry passes the first attempt's trace id
        code, doc = _http(port, "/solve", dict(body, tenant="retry-1",
                                               trace="feedbeef00000001"))
        assert (code, doc) == (200, {"tenant": "retry-1",
                                     "trace": "feedbeef00000001"})
        row = srv.wait("retry-1")
        assert row["status"] == "done" and row["trace"] == "feedbeef00000001"
        assert _http(port, "/result/retry-1")[1]["trace"] == row["trace"]
        code, st = _http(port, "/status")
        assert st["tenants"]["dead-1"]["trace"] == "feedbeef00000001"
        # a fresh id when none is given, and a known tenant is refused
        fresh = srv.result(srv.submit(_reqs("dsa", {}, (9,), 4)[0]))
        assert len(fresh["trace"]) == 16
        int(fresh["trace"], 16)
        assert _http(port, "/solve", dict(body, tenant="retry-1"))[0] == 400
    finally:
        srv.shutdown()


def test_batch_observer_reports_each_group():
    # one event a dispatched group, its phase boundaries in order; with
    # no observer the results are the same
    reqs = _reqs("dsa", {}, (9, 9, 16), 8, seed0=60)
    plain = solve_batched(reqs, device="cpu")
    events = []
    got = solve_batched(reqs, device="cpu", observer=events.append)
    assert len(events) == 2
    for ev in events:
        assert ev["kind"] == "vmap" and ev["k_pad"] >= ev["k_real"]
        times = [ev[k] for k in ("t_start", "t_assembled", "t_dispatched",
                                 "t_solved", "t_done")]
        assert times == sorted(times)
        assert ev["fresh_compiles"] == 0  # warm buckets build nothing
    assert sorted(t for ev in events for t in ev["tenants"]) == sorted(
        r.tenant for r in reqs)
    for r in reqs:
        assert_same_tenant(got[r.tenant], plain[r.tenant])
    fused = []
    solve_batched(reqs, device="cpu", mode="fused", observer=fused.append)
    assert [ev["kind"] for ev in fused] == ["fused"]
    assert fused[0]["t_dispatched"] == fused[0]["t_assembled"]


# -- the HA fleet's peers ------------------------------------------------


def _sibling_manifests(parent, own_endpoint=None):
    """A state directory of worker checkpoints, as the router's spawned
    workers leave it: manifests with endpoints, one unreadable, one
    without an endpoint, a directory without a manifest."""
    docs = {
        "w1": {"kind": "fleet", "endpoint": "http://127.0.0.1:9011"},
        "w2": {"kind": "fleet", "endpoint": "http://127.0.0.1:9012/"},
        "w3": None,
        "w4": {"kind": "fleet", "endpoint": None},
        "w5": {"kind": "fleet", "endpoint": "http://p:1"},
        "w6": {"kind": "fleet", "endpoint": own_endpoint},
    }
    for name, doc in docs.items():
        (parent / name).mkdir(parents=True)
        (parent / name / "fleet-manifest.json").write_text(
            "{torn" if doc is None else json.dumps(doc))
    (parent / "w7").mkdir()


def test_peers_are_jaxs(tmp_path):
    from pydcop_tpu.serve import ServeServer as JaxServer

    _sibling_manifests(tmp_path)
    peers = ["http://p:1/", "", "http://q:2", "http://p:1"]
    servers = [
        ServeServer(device="cpu", checkpoint_dir=str(tmp_path / "w0"),
                    peers=peers),
        JaxServer(checkpoint_dir=str(tmp_path / "w0"), peers=peers),
    ]
    try:
        got, want = (s.peers() for s in servers)
        assert got == want == ["http://p:1", "http://q:2",
                               "http://127.0.0.1:9011",
                               "http://127.0.0.1:9012"]
        # no checkpoint directory: the configured peers alone
        assert ServeServer(device="cpu", peers=peers).peers() == \
            JaxServer(peers=peers).peers()
    finally:
        for s in servers:
            s.shutdown()


def test_drained_servers_503_names_the_peers(tmp_path):
    from test_torch_api import _path

    srv = ServeServer(port=0, window_ms=5, device="cpu",
                      checkpoint_dir=str(tmp_path / "w0"),
                      peers=["http://q:2"])
    own = f"http://127.0.0.1:{srv.http.port}"
    _sibling_manifests(tmp_path, own_endpoint=own)
    try:
        assert srv.drain(timeout=60)
        with open(_path("graph_coloring")) as f:
            code, doc = _http(srv.http.port, "/solve",
                              {"dcop_yaml": f.read()})
        assert code == 503 and doc["state"] == "drained"
        # its own endpoint is not a peer
        assert doc["peers"] == srv.peers() == [
            "http://q:2", "http://127.0.0.1:9011", "http://127.0.0.1:9012",
            "http://p:1"]
        assert doc["retry_after_s"] == 2
    finally:
        srv.shutdown()
