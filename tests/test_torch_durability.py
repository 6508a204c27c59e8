"""Durable solves (``durability/manager.py`` and the engine's checkpoint
and resume) against the JAX package, both on the CPU.

The pin is bit identity: a solve resumed from any of its checkpoints
gives the uninterrupted run's assignment, cost, cycles and
``cycles_to_best``, bit for bit, and so does a resume across packages: a
checkpoint the JAX package wrote, resumed by the port, and one the port
wrote, resumed by the JAX package.  Both write the same files: the
problem fingerprint is the same 16 hex digits, the ``algo`` label is the
same word, and the leaves are JAX's, in its order, dtypes and
orientation.  Per-cycle keys are functions of the absolute cycle, so
nothing of the noise is stored.  A checkpoint of another problem,
algorithm or seed is refused loudly.
"""

import contextlib
import dataclasses
import glob
import importlib
import os

import numpy as np
import pytest
from test_torch_engine import _ReplayedBody
from test_torch_lanes import port_of

from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_coloring,
)
from pydcop_tpu.commands.generators.mixedproblem import (
    generate_mixed_problem as jax_mixed_problem,
)
from pydcop_tpu.compile.core import compile_dcop as jax_compile_dcop
from pydcop_tpu.durability import CheckpointManager as JaxManager
from pydcop_tpu.durability import durability as jax_durability
from pydcop_tpu.durability import problem_fingerprint as jax_fingerprint
from pydcop_tpu_torch.algorithms import base, dsa, maxsum, mgm2
from pydcop_tpu_torch.durability import (
    CheckpointManager,
    default_checkpoint_dir,
    durability,
    latest_checkpoint,
    list_manifests,
    problem_fingerprint,
    read_manifest,
    resolve_checkpoint_path,
)
from pydcop_tpu_torch.telemetry.pulse import pulse
from pydcop_tpu_torch.utils.checkpoint import (
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
)


@pytest.fixture(autouse=True)
def _clean_singletons():
    """Every test starts and ends with durability (both packages') and
    pulse off: a leaked manager would checkpoint other tests' solves."""
    for d in (durability, jax_durability):
        d.reset()
    yield
    for d in (durability, jax_durability):
        d.reset()
    pulse.enabled = False
    pulse.reset()


@pytest.fixture(scope="module")
def problems():
    coloring = jax_coloring(200, 3, graph="scalefree", m_edge=2, seed=11)
    mixed = dataclasses.replace(
        jax_compile_dcop(jax_mixed_problem(30, 20, 0.3, arity=3, seed=1)),
        dcop=None,
    )
    return {
        "coloring": (coloring, port_of(coloring)),
        "mixed": (mixed, port_of(mixed)),
    }


@pytest.fixture(scope="module")
def problem(problems):
    return problems["coloring"][1]


def _checkpointed(mod, compiled, tmp, *, params=None, n_cycles=48, seed=3,
                  every=12, keep=50, manager=CheckpointManager,
                  singleton=durability, **kw):
    mgr = manager(str(tmp), every_cycles=every, keep=keep)
    singleton.configure(manager=mgr)
    try:
        r = mod.solve(compiled, dict(params or {}), n_cycles=n_cycles,
                      seed=seed, **kw)
    finally:
        singleton.reset()
    return r, mgr


def _resumed(mod, compiled, path, *, params=None, n_cycles=48, seed=3,
             singleton=durability, **kw):
    singleton.configure(resume=str(path))
    try:
        return mod.solve(compiled, dict(params or {}), n_cycles=n_cycles,
                         seed=seed, **kw)
    finally:
        singleton.reset()


CPU = {"device": "cpu"}


# ---------------------------------------------------------------------------
# resume == uninterrupted, bit for bit
# ---------------------------------------------------------------------------


class TestKillResumeBitIdentity:
    def test_dsa_resume_from_every_checkpoint(self, problem, tmp_path):
        ref = dsa.solve(problem, {}, n_cycles=48, seed=3, **CPU)
        r_ck, mgr = _checkpointed(dsa, problem, tmp_path, **CPU)
        assert r_ck == ref
        assert [os.path.basename(p) for p in mgr.saved_paths] == [
            f"ckpt-c{c:09d}.npz" for c in (12, 24, 36, 48)
        ]
        for path in mgr.saved_paths[:-1]:
            r = _resumed(dsa, problem, path, **CPU)
            assert (r.cost, r.assignment, r.cycles) == (
                ref.cost, ref.assignment, ref.cycles
            )

    def test_dsa_resume_matches_the_timed_run(self, problem, tmp_path):
        ref = dsa.solve(problem, {}, n_cycles=48, seed=3, timeout=600,
                        **CPU)
        _, mgr = _checkpointed(dsa, problem, tmp_path, **CPU)
        r = _resumed(dsa, problem, mgr.saved_paths[1], **CPU)
        assert (r.cost, r.assignment) == (ref.cost, ref.assignment)

    @pytest.mark.parametrize("layout", ["ell", "lanes", "edges"])
    def test_maxsum_with_noise_resume(self, problem, tmp_path, layout):
        # the resumed run draws the same noise from (seed, draw shape):
        # nothing of it is stored
        params = {"damping": 0.5, "noise": 0.01, "stop_cycle": 40,
                  "layout": layout}
        ref = maxsum.solve(problem, dict(params), n_cycles=40, seed=7,
                           **CPU)
        _, mgr = _checkpointed(maxsum, problem, tmp_path, params=params,
                               n_cycles=40, seed=7, every=10, **CPU)
        for cycle in (10, 20, 30):
            r = _resumed(
                maxsum, problem, tmp_path / f"ckpt-c{cycle:09d}.npz",
                params=params, n_cycles=40, seed=7, **CPU,
            )
            assert (r.cost, r.assignment, r.cycles) == (
                ref.cost, ref.assignment, ref.cycles
            )

    def test_cycles_to_best_exact_across_resume(self, problem, tmp_path):
        from pydcop_tpu_torch.algorithms.dsa import _consts, _init, _make_step
        from pydcop_tpu_torch.compile.kernels import to_device

        dev = to_device(problem, "cpu")
        consts = _consts(problem, {"probability": 0.7, "p_mode": "fixed"},
                         dev)
        args = (problem, dev, _init, _make_step("B"), base.extract_values)
        kw = dict(n_cycles=48, seed=3, consts=consts, return_final=False,
                  with_best=True, carry_io=dsa.carry_io)
        _, _, ex_ref = base.run_cycles(*args, **kw)
        _, mgr = _checkpointed(dsa, problem, tmp_path, **CPU)
        durability.configure(resume=mgr.saved_paths[0])
        try:
            _, _, ex_res = base.run_cycles(*args, **kw)
        finally:
            durability.reset()
        for key in ("cycles_to_best", "best_cost", "cycles"):
            assert ex_res[key] == ex_ref[key]
        assert np.array_equal(ex_res["best_values"], ex_ref["best_values"])
        assert ex_res["resumed_from"] == 12

    def test_resume_at_or_past_the_target_returns_the_checkpoint(
        self, problem, tmp_path
    ):
        ref = dsa.solve(problem, {}, n_cycles=24, seed=3, **CPU)
        _, mgr = _checkpointed(dsa, problem, tmp_path, n_cycles=24,
                               every=12, **CPU)
        for n in (24, 12):
            r = _resumed(dsa, problem, mgr.saved_paths[-1], n_cycles=n,
                         **CPU)
            assert (r.cost, r.assignment, r.cycles) == (
                ref.cost, ref.assignment, 24
            )

    def test_resumed_curve_covers_the_resumed_cycles(self, problem,
                                                     tmp_path):
        ref = dsa.solve(problem, {}, n_cycles=48, seed=3,
                        collect_curve=True, **CPU)
        _, mgr = _checkpointed(dsa, problem, tmp_path, collect_curve=True,
                               **CPU)
        r = _resumed(dsa, problem, mgr.saved_paths[0], collect_curve=True,
                     **CPU)
        assert r.cost_curve == ref.cost_curve[12:]

    def test_checkpointed_graph_runner_captures_nothing_warm(
        self, problem, tmp_path, monkeypatch
    ):
        # the card's runner rehearsed on the CPU: a checkpointed solve
        # writes its boundaries into the graph's budget and snapshots its
        # buffers; a resume writes into the same buffers.  Warm, nothing
        # is captured, and the results are the eager runner's
        params = {"damping": 0.7, "noise": 0.01, "stop_cycle": 30}
        ref = maxsum.solve(problem, dict(params), n_cycles=30, seed=7,
                           **CPU)
        monkeypatch.setattr(base, "_capture", _ReplayedBody)
        monkeypatch.setattr(base, "_side_stream",
                            lambda device: contextlib.nullcontext())
        monkeypatch.setattr(
            base, "_runner",
            lambda compiled, solver, dev, consts: base._graphs(
                compiled, solver, dev, consts
            ),
        )
        for i, sub in enumerate(("a", "b")):
            captures = base.run_cycles.captures
            syncs = base.run_cycles.host_syncs
            r, mgr = _checkpointed(maxsum, problem, tmp_path / sub,
                                   params=params, n_cycles=30, seed=7,
                                   every=10, **CPU)
            assert base.run_cycles.captures - captures == (2 if i == 0
                                                           else 0)
            # a look after each of three chunks, then the result
            assert base.run_cycles.host_syncs - syncs == 4
            assert (r.cost, r.assignment) == (ref.cost, ref.assignment)
            assert len(mgr.saved_paths) == 3
        for path in mgr.saved_paths[:2]:
            captures = base.run_cycles.captures
            r = _resumed(maxsum, problem, path, params=params, n_cycles=30,
                         seed=7, **CPU)
            assert base.run_cycles.captures == captures
            assert (r.cost, r.assignment) == (ref.cost, ref.assignment)


# ---------------------------------------------------------------------------
# across packages: the same files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11, 12345])
def test_fingerprint_is_jax_s(seed):
    ref = jax_coloring(80, 3, graph="random", p_edge=0.05, seed=seed)
    fp = problem_fingerprint(port_of(ref))
    assert len(fp) == 16 and fp == jax_fingerprint(ref)


def test_fingerprint_of_a_mixed_problem_is_jax_s(problems):
    ref, port = problems["mixed"]
    assert problem_fingerprint(port) == jax_fingerprint(ref)


CROSS = {
    "dsa": ("dsa", {}, "coloring"),
    "mgm2_arity3": ("mgm2", {}, "mixed"),
    "dba": ("dba", {}, "coloring"),
    "maxsum_ell": ("maxsum", {"layout": "ell", "noise": 0.01,
                              "stop_cycle": 30}, "coloring"),
    "maxsum_lanes": ("maxsum", {"layout": "lanes", "noise": 0.01,
                                "stop_cycle": 30}, "mixed"),
}


@pytest.mark.parametrize("case", sorted(CROSS))
def test_checkpoints_cross_between_the_packages(case, problems, tmp_path):
    name, params, problem = CROSS[case]
    ref, port = problems[problem]
    jmod = importlib.import_module(f"pydcop_tpu.algorithms.{name}")
    pmod = importlib.import_module(f"pydcop_tpu_torch.algorithms.{name}")
    want = pmod.solve(port, dict(params), n_cycles=30, seed=3, **CPU)
    jwant = jmod.solve(ref, dict(params), n_cycles=30, seed=3)
    assert (want.cost, want.assignment, want.cycles) == (
        jwant.cost, jwant.assignment, jwant.cycles
    )
    _, jmgr = _checkpointed(jmod, ref, tmp_path / "jax", params=params,
                            n_cycles=30, every=10, manager=JaxManager,
                            singleton=jax_durability)
    _, pmgr = _checkpointed(pmod, port, tmp_path / "port", params=params,
                            n_cycles=30, every=10, **CPU)
    # the middle checkpoint (cycle 20) of each; every checkpoint of the
    # port resumes in the port in TestKillResumeBitIdentity
    for jpath, ppath in zip(jmgr.saved_paths[1:2], pmgr.saved_paths[1:2]):
        jman, pman = read_manifest(jpath), read_manifest(ppath)
        for key in ("format", "algo", "fingerprint", "seed", "cycle",
                    "n_vars", "best_cost", "cycles_to_best"):
            assert pman[key] == jman[key], key
        got = [
            _resumed(pmod, port, jpath, params=params, n_cycles=30, **CPU),
            _resumed(jmod, ref, ppath, params=params, n_cycles=30,
                     singleton=jax_durability),
        ]
        for r in got:
            assert (r.cost, r.assignment, r.cycles) == (
                want.cost, want.assignment, want.cycles
            )


ENGINE_SOLVERS = {
    "dsa": {}, "adsa": {}, "dsatuto": {}, "mgm": {}, "mgm2": {},
    "mixeddsa": {}, "dba": {}, "gdba": {}, "maxsum": {"stop_cycle": 10},
    "amaxsum": {},
}


@pytest.mark.parametrize("name", sorted(ENGINE_SOLVERS))
def test_algo_label_is_jax_s(name, problems, tmp_path):
    ref, port = problems["coloring"]
    params = ENGINE_SOLVERS[name]
    jmod = importlib.import_module(f"pydcop_tpu.algorithms.{name}")
    pmod = importlib.import_module(f"pydcop_tpu_torch.algorithms.{name}")
    _, jmgr = _checkpointed(jmod, ref, tmp_path / "jax", params=params,
                            n_cycles=10, every=5, manager=JaxManager,
                            singleton=jax_durability)
    _, pmgr = _checkpointed(pmod, port, tmp_path / "port", params=params,
                            n_cycles=10, every=5, **CPU)
    jman, pman = (read_manifest(m.saved_paths[0]) for m in (jmgr, pmgr))
    assert pman["algo"] == jman["algo"] == name
    # the leaves: JAX's count, shapes and dtypes
    jleaves, _ = load_checkpoint(jmgr.saved_paths[0])
    pleaves, _ = load_checkpoint(pmgr.saved_paths[0])
    assert [(tuple(x.shape), x.dtype) for x in pleaves] == [
        (tuple(x.shape), x.dtype) for x in jleaves
    ]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


class TestRefusals:
    def test_different_problem_refused(self, problem, tmp_path):
        _, mgr = _checkpointed(dsa, problem, tmp_path, **CPU)
        other = port_of(jax_coloring(200, 3, graph="scalefree", m_edge=2,
                                     seed=99))
        durability.configure(resume=mgr.saved_paths[0])
        try:
            with pytest.raises(CheckpointError) as ei:
                dsa.solve(other, {}, n_cycles=48, seed=3, **CPU)
        finally:
            durability.reset()
        msg = str(ei.value)
        assert "DIFFERENT problem" in msg and "dsa" in msg
        assert problem_fingerprint(problem) in msg
        assert problem_fingerprint(other) in msg

    def test_different_algo_refused(self, problem, tmp_path):
        _, mgr = _checkpointed(dsa, problem, tmp_path, **CPU)
        with pytest.raises(CheckpointError, match="algorithm 'dsa'"):
            _resumed(maxsum, problem, mgr.saved_paths[0],
                     params={"stop_cycle": 48}, **CPU)

    def test_different_seed_refused(self, problem, tmp_path):
        _, mgr = _checkpointed(dsa, problem, tmp_path, seed=3, **CPU)
        with pytest.raises(CheckpointError, match="seed"):
            _resumed(dsa, problem, mgr.saved_paths[0], seed=4, **CPU)

    def test_leaf_mismatch_error_names_checkpoint_identity(self, tmp_path):
        p = str(tmp_path / "c.npz")
        save_checkpoint(
            p, {"a": np.zeros((4, 3))},
            metadata={"algo": "maxsum", "fingerprint": "deadbeef01020304",
                      "n_vars": 4},
        )
        with pytest.raises(CheckpointError) as ei:
            load_checkpoint(p, like={"a": np.zeros((5, 3))})
        assert "deadbeef01020304" in str(ei.value)
        assert "maxsum" in str(ei.value)

    def test_resolve_missing_path(self, tmp_path):
        with pytest.raises(CheckpointError, match="no such checkpoint"):
            resolve_checkpoint_path(str(tmp_path / "nope.npz"))
        with pytest.raises(CheckpointError, match="no checkpoint"):
            resolve_checkpoint_path(str(tmp_path))

    def test_a_failed_write_raises(self, problem, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        with pytest.raises(OSError):
            _checkpointed(dsa, problem, blocker / "ck", **CPU)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


class TestManagerMechanics:
    def test_cadence_every_cycles(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), every_cycles=16)
        assert mgr.cycles_to_boundary(0) == 16
        assert mgr.cycles_to_boundary(5) == 11
        assert mgr.cycles_to_boundary(16) == 16
        assert not mgr.due(0) and mgr.due(16) and not mgr.due(17)

    def test_cadence_every_seconds(self, problem, tmp_path):
        mgr = CheckpointManager(str(tmp_path), every_seconds=0.0)
        assert mgr.cycles_to_boundary(7) is None
        assert mgr.due(3)
        # a look after every chunk: every chunk is a snapshot
        durability.configure(manager=mgr)
        try:
            r = dsa.solve(problem, {}, n_cycles=40, seed=3, **CPU)
        finally:
            durability.reset()
        assert r == dsa.solve(problem, {}, n_cycles=40, seed=3, **CPU)
        assert [read_manifest(p)["cycle"] for p in mgr.saved_paths] == [
            16, 32, 40,
        ]

    def test_rotation_keeps_the_last_n(self, problem, tmp_path):
        _checkpointed(dsa, problem, tmp_path, every=12, keep=2, **CPU)
        files = sorted(glob.glob(str(tmp_path / "*.npz")))
        assert [os.path.basename(f) for f in files] == [
            "ckpt-c000000036.npz", "ckpt-c000000048.npz",
        ]
        assert len(glob.glob(str(tmp_path / "*.json"))) == 2

    def test_manifest_contents(self, problem, tmp_path):
        _, mgr = _checkpointed(dsa, problem, tmp_path, n_cycles=24,
                               every=12, seed=5, **CPU)
        man = read_manifest(mgr.saved_paths[0])
        assert man["format"] == "graftdur-v1"
        assert (man["algo"], man["seed"], man["cycle"], man["n_cycles"]) == (
            "dsa", 5, 12, 24
        )
        assert man["fingerprint"] == problem_fingerprint(problem)
        assert "best_cost" in man and "cycles_to_best" in man
        assert man["extra"]["has_pulse"] is False

    def test_list_latest_prune(self, problem, tmp_path):
        _checkpointed(dsa, problem, tmp_path, every=12, **CPU)
        mans = list_manifests(str(tmp_path))
        assert [m["cycle"] for m in mans] == [12, 24, 36, 48]
        assert all(m["bytes"] > 0 for m in mans)
        latest = latest_checkpoint(str(tmp_path))
        assert latest.endswith("ckpt-c000000048.npz")
        assert resolve_checkpoint_path(str(tmp_path)) == latest
        assert CheckpointManager(str(tmp_path)).prune(keep=1) == 3
        assert len(list_manifests(str(tmp_path))) == 1

    def test_default_dir_under_state_dir(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PYDCOP_TPU_STATE_DIR", str(tmp_path))
        assert default_checkpoint_dir() == str(tmp_path / "checkpoints")
        assert CheckpointManager(None).directory == str(
            tmp_path / "checkpoints"
        )

    def test_status_block_and_take_resume(self, tmp_path):
        assert durability.status_block() is None
        durability.configure(
            manager=CheckpointManager(str(tmp_path), every_cycles=8)
        )
        durability.note_extra(cursor=2)
        blk = durability.status_block()
        assert blk["every_cycles"] == 8 and blk["extra"]["cursor"] == 2
        durability.configure(resume="x")
        assert durability.take_resume() == "x"
        assert durability.take_resume() is None

    def test_manager_claimed_by_first_problem(self, problem, tmp_path):
        other = port_of(jax_coloring(60, 3, graph="random", p_edge=0.05,
                                     seed=42))
        mgr = CheckpointManager(str(tmp_path), every_cycles=12, keep=50)
        durability.configure(manager=mgr)
        try:
            dsa.solve(problem, {}, n_cycles=48, seed=3, **CPU)
            mgm2.solve(other, {}, n_cycles=48, seed=0, **CPU)
        finally:
            durability.reset()
        for man in list_manifests(str(tmp_path)):
            assert man["algo"] == "dsa"
            assert man["fingerprint"] == problem_fingerprint(problem)


# ---------------------------------------------------------------------------
# the pulse carry across a resume
# ---------------------------------------------------------------------------


class TestPulseCarryAcrossResume:
    def test_flip_counters_survive_resume(self, problem, tmp_path):
        pulse.reset()
        pulse.enabled = True
        ref = dsa.solve(problem, {}, n_cycles=48, seed=3, **CPU)
        ref_flips = pulse.last_report["flip_summary"]
        _, mgr = _checkpointed(dsa, problem, tmp_path, **CPU)
        assert read_manifest(mgr.saved_paths[1])["extra"]["has_pulse"]
        r = _resumed(dsa, problem, mgr.saved_paths[1], **CPU)
        assert r.cost == ref.cost
        assert pulse.last_report["flip_summary"] == ref_flips

    def test_flight_recorder_ring_survives_resume(self, problem, tmp_path):
        pulse.reset()
        pulse.enabled = True
        _, mgr = _checkpointed(dsa, problem, tmp_path, **CPU)
        man = read_manifest(mgr.saved_paths[1])
        assert (man["extra"]["pulse_ring_start"]
                + len(man["extra"]["pulse_ring"]) == 24)
        pulse.reset()
        pulse.enabled = True
        _resumed(dsa, problem, mgr.saved_paths[1], **CPU)
        rows, start = pulse.recorder.ring()
        assert start == 0 and len(rows) == 48

    def test_pulse_on_resume_of_a_pulseless_checkpoint(self, problem,
                                                       tmp_path):
        _, mgr = _checkpointed(dsa, problem, tmp_path, **CPU)
        pulse.reset()
        pulse.enabled = True
        ref = dsa.solve(problem, {}, n_cycles=48, seed=3, **CPU)
        ref_rows = np.asarray(pulse.recorder.ring()[0])
        r = _resumed(dsa, problem, mgr.saved_paths[1], **CPU)
        assert (r.cost, r.assignment) == (ref.cost, ref.assignment)
        # the flip carry restarts from the restored values: the resumed
        # cycles' flip counts are the uninterrupted run's
        rows, start = pulse.recorder.ring()
        assert start == 24 and len(rows) == 24
        assert np.array_equal(np.asarray(rows)[:, 2], ref_rows[24:, 2])
        assert pulse.last_report["cycles"] == 48

    def test_pulse_off_resume_of_a_pulse_checkpoint(self, problem,
                                                    tmp_path):
        pulse.reset()
        pulse.enabled = True
        _, mgr = _checkpointed(dsa, problem, tmp_path, **CPU)
        pulse.enabled = False
        ref = dsa.solve(problem, {}, n_cycles=48, seed=3, **CPU)
        r = _resumed(dsa, problem, mgr.saved_paths[0], **CPU)
        assert (r.cost, r.assignment) == (ref.cost, ref.assignment)

    def test_pulse_checkpoint_crosses_to_jax(self, problems, tmp_path):
        ref, port = problems["coloring"]
        pulse.reset()
        pulse.enabled = True
        _, mgr = _checkpointed(dsa, port, tmp_path, **CPU)
        pulse.enabled = False
        want = dsa.solve(port, {}, n_cycles=48, seed=3, **CPU)
        from pydcop_tpu.algorithms import dsa as jax_dsa

        r = _resumed(jax_dsa, ref, mgr.saved_paths[1],
                     singleton=jax_durability)
        assert (r.cost, r.assignment) == (want.cost, want.assignment)
