"""The cycle engine (``algorithms/base.py:run_cycles``) against the JAX
package's engine, both on the CPU: per-cycle keys, the anytime best and
its 1-based cycle, the stop-on-stable rule, ``return_final``,
``collect_curve`` and the timeout's chunks.

A run is a trajectory of whole cycles, and chunk boundaries only decide
when the host looks: so a solve in chunks of another length, or with a
timeout that does not expire, must give the same assignment, cost,
cycles and best cycle as the JAX package's single fused run, bit for
bit.  A curve is the per-cycle cost on the device (float32 sums), held
to rel=1e-6 against JAX's.
"""

import math

import numpy as np
import pytest
import torch
from test_torch_local_search import _pair, assert_same_solve

from pydcop_tpu.algorithms import base as jax_base
from pydcop_tpu.algorithms import dsa as jax_dsa
from pydcop_tpu.algorithms import maxsum as jax_maxsum
from pydcop_tpu.algorithms import mgm as jax_mgm
from pydcop_tpu.compile import kernels as jk
from pydcop_tpu_torch.algorithms import base, dsa, maxsum, mgm
from pydcop_tpu_torch.compile import kernels as tk

SOLVERS = {
    "dsa": (dsa, jax_dsa, {}),
    "mgm": (mgm, jax_mgm, {"break_mode": "random"}),
    "maxsum": (maxsum, jax_maxsum, {"damping": 0.5}),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_timeout_that_does_not_expire_changes_nothing(name):
    mod, jax_mod, params = SOLVERS[name]
    port, ref = _pair("scalefree")
    want = jax_mod.solve(ref, params, n_cycles=40, seed=2)
    whole = mod.solve(port, params, n_cycles=40, seed=2, device="cpu")
    chunked = mod.solve(
        port, params, n_cycles=40, seed=2, timeout=1e6, device="cpu"
    )
    assert whole == chunked and chunked.status == "FINISHED"
    if name == "maxsum":  # float sums over hubs: the maxsum tests' bar
        assert whole.cost == pytest.approx(want.cost, rel=1e-5)
    else:
        assert_same_solve(whole, want)


@pytest.mark.parametrize("length", [1, 4, 8])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_chunk_length_does_not_change_the_trajectory(name, length,
                                                     monkeypatch):
    mod, _, params = SOLVERS[name]
    port, _ = _pair("grid")
    want = mod.solve(port, params, n_cycles=37, seed=4, device="cpu")
    monkeypatch.setattr(base, "TIMEOUT_CHUNK", length)
    got = mod.solve(port, params, n_cycles=37, seed=4, device="cpu")
    assert got == want


@pytest.mark.parametrize("curve", [False, True])
@pytest.mark.parametrize("name", ["dsa", "mgm"])
def test_expired_timeout_reports_whole_chunks(name, curve):
    # a timeout of 0 expires before the first look: the solve stops after
    # its first chunk of TIMEOUT_CHUNK cycles, as the JAX engine's does
    mod, jax_mod, params = SOLVERS[name]
    port, ref = _pair("scalefree")
    want = jax_mod.solve(
        ref, params, n_cycles=100, seed=3, timeout=0.0, collect_curve=curve
    )
    got = mod.solve(
        port, params, n_cycles=100, seed=3, timeout=0.0,
        collect_curve=curve, device="cpu",
    )
    assert got.status == "TIMEOUT" and got.cycles == base.TIMEOUT_CHUNK
    assert (got.assignment, got.cycles, got.msg_count, got.status) == (
        want.assignment, want.cycles, want.msg_count, want.status
    )
    if curve:
        assert len(got.cost_curve) == base.TIMEOUT_CHUNK
        assert got.cost_curve == pytest.approx(want.cost_curve, rel=1e-6)


def test_curve_has_one_cost_per_cycle_and_turns_the_stop_rule_off():
    # the quiet grid converges in a few cycles; a curve runs them all
    port, ref = _pair("grid")
    params = {"damping": 0.0, "noise": 0.0}
    stopped = maxsum.solve(port, params, n_cycles=60, device="cpu")
    assert stopped.cycles < 60 and stopped.cost_curve is None
    got = maxsum.solve(
        port, params, n_cycles=60, collect_curve=True, device="cpu"
    )
    want = jax_maxsum.solve(ref, params, n_cycles=60, collect_curve=True)
    assert got.cycles == want.cycles == 60
    assert len(got.cost_curve) == 60
    assert got.cost_curve == pytest.approx(want.cost_curve, rel=1e-6)


def _jax_and_port_engines(case, n_cycles, seed, return_final):
    """DSA's init and step through both engines' ``run_cycles``."""
    port, ref = _pair(case)
    params = {"probability": 0.7, "p_mode": "fixed"}
    jdev, pdev = jk.to_device(ref), tk.to_device(port, "cpu")
    want = jax_base.run_cycles(
        ref, jax_dsa._init, jax_dsa._make_step("B"),
        jax_base.extract_values, n_cycles=n_cycles, seed=seed, dev=jdev,
        consts=jax_dsa._consts(ref, params, jdev),
        return_final=return_final,
    )
    got = base.run_cycles(
        port, pdev, dsa._init, dsa._make_step("B"), base.extract_values,
        n_cycles=n_cycles, seed=seed,
        consts=dsa._consts(port, params, pdev), return_final=return_final,
    )
    return got, want


@pytest.mark.parametrize("return_final", [True, False])
@pytest.mark.parametrize("case", ["scalefree", "ising", "isolated"])
def test_engine_extras_equal_jax(case, return_final):
    (vals, curve, extras), (jvals, jcurve, jextras) = _jax_and_port_engines(
        case, 30, 8, return_final
    )
    assert curve is None and jcurve is None
    assert np.array_equal(vals, np.asarray(jvals))
    for k in ("cycles", "cycles_to_best", "timed_out"):
        assert extras[k] == jextras[k], k
    assert extras["best_cost"] == pytest.approx(jextras["best_cost"],
                                                rel=1e-6)


def test_return_final_reports_the_final_and_best_the_best():
    (final, _, extras), _ = _jax_and_port_engines("scalefree", 30, 8, True)
    (best, _, _), _ = _jax_and_port_engines("scalefree", 30, 8, False)
    port, _ = _pair("scalefree")
    pdev = tk.to_device(port, "cpu")
    cost_of = lambda v: float(tk.evaluate(pdev, torch.as_tensor(v)))  # noqa
    assert cost_of(best) == pytest.approx(extras["best_cost"], rel=1e-6)
    assert cost_of(best) <= cost_of(final)


@pytest.mark.parametrize("n_cycles", [5, 16, 17, 100, 1000])
def test_a_solve_pays_logarithmic_host_syncs(n_cycles):
    port, _ = _pair("grid")
    length = min(base.TIMEOUT_CHUNK, max(8, 1 << (n_cycles - 1).bit_length()))
    syncs, replays = base.run_cycles.host_syncs, base.run_cycles.replays
    res = mgm.solve(port, {}, n_cycles=n_cycles, device="cpu")
    syncs = base.run_cycles.host_syncs - syncs
    replays = base.run_cycles.replays - replays
    assert res.cycles == n_cycles
    # chunks of 16, 32, ... cycles: one look after each but the last,
    # then the result's read-back
    chunks = max(1, math.ceil(math.log2(n_cycles / 16 + 1)))
    assert syncs == chunks
    assert replays == math.ceil(n_cycles / length)


def test_stop_rule_ends_the_replays_at_the_next_look():
    port, _ = _pair("grid")
    params = {"damping": 0.0, "noise": 0.0}
    replays = base.run_cycles.replays
    res = maxsum.solve(port, params, n_cycles=1000, device="cpu")
    assert res.cycles < base.TIMEOUT_CHUNK
    # the first look (after one chunk) sees the stop rule fired
    assert base.run_cycles.replays - replays == 1


def test_jax_per_cycle_keys_reach_the_steps():
    # DSA's random choices at cycle c come from fold_in(fold_in(key, 1), c)
    # for the same (key, c) on both sides: a solve that spans three
    # chunks and two seeds stays bit-identical
    for seed in (0, 11):
        (vals, _, extras), (jvals, _, jextras) = _jax_and_port_engines(
            "ising", 70, seed, True
        )
        assert np.array_equal(vals, np.asarray(jvals))
        assert extras["cycles"] == jextras["cycles"] == 70


def test_cycle_index_is_absolute_in_keys():
    # the per-cycle keys depend on the absolute cycle: the first 20
    # cycles of a 40-cycle solve are the whole of a 20-cycle solve
    port, _ = _pair("scalefree")
    params = {"break_mode": "random"}
    a = mgm.solve(port, params, n_cycles=20, seed=9, collect_curve=True,
                  device="cpu")
    b = mgm.solve(port, params, n_cycles=40, seed=9, collect_curve=True,
                  device="cpu")
    assert b.cost_curve[:20] == a.cost_curve


class _ReplayedBody:
    """A stand-in for a captured CUDA graph on the CPU: ``replay`` runs
    the captured body again, on the same static buffers."""

    def __init__(self, body, pool=None):
        self.body = body

    def replay(self):
        self.body()

    def pool(self):
        return None


class _Event:
    """A stand-in for ``torch.cuda.Event``: a log of records and waits."""

    log = []

    def __init__(self, blocking=False):
        self.id = len([e for e in self.log if e[0] == "new"])
        self.log.append(("new", self.id))

    def record(self):
        self.log.append(("record", self.id))

    def synchronize(self):
        self.log.append(("wait", self.id))


def test_replays_are_paced_only_beside_a_second_solve(monkeypatch):
    # on the card a solve alone queues its replays freely; while a second
    # solve runs (a repair), each replay past REPLAYS_IN_FLIGHT first
    # waits for the event recorded REPLAYS_IN_FLIGHT replays earlier
    from pydcop_tpu_torch.utils.solve_control import second_solve

    class _Card:
        type = "cuda"

    graphs = object.__new__(base._Graphs)
    graphs.solve_in = type("SolveIn", (), {"device": _Card()})()
    graphs._in_flight, graphs._n_paced = None, 0
    _Event.log = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    n = base.REPLAYS_IN_FLIGHT
    for _ in range(3):
        graphs._pace()
    assert _Event.log == []
    with second_solve():
        for _ in range(n + 2):
            graphs._pace()
    assert [e for e in _Event.log if e[0] != "new"] == (
        [("record", i) for i in range(n)]
        + [("wait", 0), ("record", 0), ("wait", 1), ("record", 1)]
    )
    _Event.log = []
    graphs._pace()
    assert _Event.log == [] and graphs._n_paced == 0
    with second_solve():
        # a second solve again: the first replays queue without waiting
        graphs._pace()
    assert _Event.log == [("record", 0)]


@pytest.mark.parametrize(
    "name, case",
    [("maxsum", "scalefree"), ("dsa", "isolated"), ("mgm", "ising")],
)
def test_graph_runner_buffers_carry_the_solve(name, case, monkeypatch):
    # the card's runner (static buffers, carry written back after each
    # chunk, packed result, looks at its tail), rehearsed on the CPU with
    # graphs that rerun their bodies: the same results as the eager
    # runner, and a warm solve builds nothing
    import contextlib

    mod, _, params = SOLVERS[name]
    port, _ = _pair(case)
    want = [
        mod.solve(port, params, n_cycles=n, seed=1, device="cpu",
                  collect_curve=curve)
        for n, curve in ((40, False), (9, True))
    ]
    monkeypatch.setattr(base, "_capture", _ReplayedBody)
    monkeypatch.setattr(base, "_side_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        base, "_runner",
        lambda compiled, solver, dev, consts: base._graphs(
            compiled, solver, dev, consts
        ),
    )
    for n, curve in ((40, False), (9, True)):
        captures = base.run_cycles.captures
        cold = mod.solve(port, params, n_cycles=n, seed=1, device="cpu",
                         collect_curve=curve)
        warm = mod.solve(port, params, n_cycles=n, seed=1, device="cpu",
                         collect_curve=curve)
        assert base.run_cycles.captures == captures + 2
        assert cold == warm == want[curve]
