"""The Hopper kernel wrappers of ``compile/hopper_kernels.py``.

On CPU tensors a wrapper is its plain PyTorch version and counts no
launch; on other non-CUDA devices it raises.  The tests marked ``cuda``
hold each kernel against its plain version on the card, exactly, and the
solvers' captured graphs (the cycle engine's, DPOP's UTIL wave) against
the same solves run eagerly or on the CPU; they skip where there is no
card: a CUDA kernel or graph has no CPU mode.  This file imports
nothing of jax, so on the card it runs without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_coloring_arrays,
)
from pydcop_tpu_torch.compile import hopper_kernels as hk
from pydcop_tpu_torch.compile.kernels import build_ell, lanes_aux, to_device

# the small ELL cases of the JAX package's TestEllPallas, a D=16 one, and
# the kernels' cut points in D: 2 (several slots a thread), 5 (the last D
# with two), 8 (the last with whole-table loads); 17 is the first D of
# their runtime-D kernels
CASES = {
    "scalefree": (150, 3, dict(graph="scalefree", m_edge=2, seed=13)),
    "clique": (12, 3, dict(graph="random", p_edge=1.0, seed=3)),
    "grid": (36, 3, dict(graph="grid", seed=4)),
    "scalefree_d16": (300, 16, dict(graph="scalefree", m_edge=2, seed=1)),
    "scalefree_d2": (200, 2, dict(graph="scalefree", m_edge=2, seed=2)),
    "scalefree_d5": (200, 5, dict(graph="scalefree", m_edge=2, seed=5)),
    "scalefree_d8": (200, 8, dict(graph="scalefree", m_edge=2, seed=8)),
    "scalefree_d17": (200, 17, dict(graph="scalefree", m_edge=2, seed=17)),
}
# element counts no multiple of the slots a thread takes times the block
# size (256), and above the threads an H100 holds at once (132 SMs x 2048),
# so the kernels' grid-stride loops make several passes and the last one
# is ragged; a thread takes two to four slots a pass at these D
RAGGED = {"d3": (2_500_001, 3), "d5": (1_300_001, 5)}
# the lanes kernel's cases: the same, plus D=20, past the TPU kernel's
# domain limit of 16
LANES_CASES = dict(
    CASES, scalefree_d20=(300, 20, dict(graph="scalefree", m_edge=2, seed=2))
)


def _args(case, device="cpu"):
    """(v2f_t, pair_perm, tabs_t, real_row) of the case's ELL layout, with
    a random plane that is zero on padding slots."""
    n, d, kw = CASES[case]
    ell = build_ell(generate_coloring_arrays(n, d, **kw))
    rng = np.random.default_rng(11)
    v2f = np.where(ell.real_row, rng.normal(size=(d, ell.n_pad)), 0.0)
    return [
        torch.as_tensor(a, device=device)
        for a in (
            v2f.astype(np.float32), ell.pair_perm, ell.tabs_t, ell.real_row,
        )
    ]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ell_minplus_on_cpu_is_the_plain_version_and_uncounted(case):
    args = _args(case)
    before = hk.ell_minplus.launches
    assert torch.equal(hk.ell_minplus(*args), hk.ell_minplus_plain(*args))
    assert hk.ell_minplus.launches == before


def test_ell_minplus_plain_masks_padding_slots_to_zero():
    v2f, pair_perm, tabs_t, real_row = _args("scalefree")
    out = hk.ell_minplus_plain(v2f, pair_perm, tabs_t, real_row)
    assert out.shape == v2f.shape and out.dtype == torch.float32
    assert not real_row.all()  # the case has padding slots
    assert torch.all(out[:, ~real_row[0]] == 0)


def test_ell_minplus_refuses_other_devices():
    with pytest.raises(ValueError):
        hk.ell_minplus(*[a.to("meta") for a in _args("grid")])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_ell_minplus_kernel_equals_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _args(case, "cuda")
    before = hk.ell_minplus.launches
    got = hk.ell_minplus(*args)
    torch.cuda.synchronize()
    assert hk.ell_minplus.launches == before + 1
    # adds and mins only: exactly equal
    assert torch.equal(got, hk.ell_minplus_plain(*args))


@pytest.mark.cuda
def test_ell_minplus_checks_its_operands_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    v2f, pair_perm, tabs_t, real_row = _args("grid", "cuda")
    with pytest.raises(TypeError):
        hk.ell_minplus(v2f, pair_perm.long(), tabs_t, real_row)
    with pytest.raises(ValueError):
        hk.ell_minplus(v2f.t().contiguous().t(), pair_perm, tabs_t, real_row)
    with pytest.raises(ValueError):
        hk.ell_minplus(v2f, pair_perm.cpu(), tabs_t, real_row)


def _ragged_ell_args(case):
    """Random ELL operands on the card: ~20% padding slots, partners drawn
    at random, a v2f plane zero on padding slots."""
    n, d = RAGGED[case]
    g = torch.Generator(device="cuda").manual_seed(n)
    real = torch.rand((1, n), generator=g, device="cuda") < 0.8
    return [
        torch.randn((d, n), generator=g, device="cuda") * real,
        torch.randint(
            0, n, (n,), generator=g, device="cuda", dtype=torch.int32
        ),
        torch.rand((d, d, n), generator=g, device="cuda") * 10,
        real,
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_ell_minplus_kernel_equals_plain_on_ragged_tail(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ragged_ell_args(case)
    got = hk.ell_minplus(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, hk.ell_minplus_plain(*args))


def _lanes_args(case, device="cpu"):
    """(v2f_t, e0, e1, tables_t) of the case's one arity-2 bucket on the
    lanes layout, with a random [D, n_edges] plane."""
    n, d, kw = LANES_CASES[case]
    dev = to_device(generate_coloring_arrays(n, d, **kw), device)
    aux = lanes_aux(dev)
    rng = np.random.default_rng(12)
    v2f = torch.as_tensor(
        rng.normal(size=(d, dev.n_edges)).astype(np.float32), device=device
    )
    return [v2f, *aux.edge_cols[0], aux.tables_t[0]]


@pytest.mark.parametrize("case", sorted(LANES_CASES))
def test_factor_arity2_minplus_on_cpu_is_the_plain_version_and_uncounted(
    case,
):
    args = _lanes_args(case)
    before = hk.factor_arity2_minplus.launches
    got = hk.factor_arity2_minplus(*args)
    want = hk.factor_arity2_minplus_plain(*args)
    assert hk.factor_arity2_minplus.launches == before
    d, n_c = args[0].shape[0], args[1].shape[0]
    for g, w in zip(got, want):
        assert g.shape == (d, n_c) and g.dtype == torch.float32
        assert torch.equal(g, w)


def test_factor_arity2_minplus_plain_is_the_min_marginal():
    # the definition, one constraint at a time: min over the partner of
    # table + partner message (the own message cancels exactly here,
    # since these small integers add and subtract without rounding)
    v2f, e0, e1, tables_t = _lanes_args("grid")
    v2f = v2f.round()
    out0, out1 = hk.factor_arity2_minplus_plain(v2f, e0, e1, tables_t)
    d = v2f.shape[0]
    for c in range(0, e0.shape[0], 7):
        t = tables_t[:, c].reshape(d, d)
        a, b = v2f[:, e0[c]], v2f[:, e1[c]]
        assert torch.equal(out0[:, c], torch.amin(t + b[None, :], dim=1))
        assert torch.equal(out1[:, c], torch.amin(t + a[:, None], dim=0))


def test_factor_arity2_minplus_refuses_other_devices():
    with pytest.raises(ValueError):
        hk.factor_arity2_minplus(*[a.to("meta") for a in _lanes_args("grid")])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LANES_CASES))
def test_factor_arity2_minplus_kernel_equals_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _lanes_args(case, "cuda")
    before = hk.factor_arity2_minplus.launches
    got = hk.factor_arity2_minplus(*args)
    torch.cuda.synchronize()
    assert hk.factor_arity2_minplus.launches == before + 1
    # adds, one subtract and mins in one association: exactly equal
    for g, w in zip(got, hk.factor_arity2_minplus_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_factor_arity2_minplus_checks_its_operands_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    v2f, e0, e1, tables_t = _lanes_args("grid", "cuda")
    with pytest.raises(TypeError):
        hk.factor_arity2_minplus(v2f, e0.long(), e1, tables_t)
    with pytest.raises(ValueError):
        hk.factor_arity2_minplus(v2f, e0, e1, tables_t[:, :-1])
    with pytest.raises(ValueError):
        hk.factor_arity2_minplus(v2f, e0, e1.cpu(), tables_t)


def _ragged_lanes_args(case):
    """Random arity-2 operands on the card: ``n`` constraints over ``2 n``
    edges drawn at random."""
    n, d = RAGGED[case]
    g = torch.Generator(device="cuda").manual_seed(n)
    return [
        torch.randn((d, 2 * n), generator=g, device="cuda"),
        *(
            torch.randint(
                0, 2 * n, (n,), generator=g, device="cuda", dtype=torch.int32
            )
            for _ in range(2)
        ),
        torch.rand((d * d, n), generator=g, device="cuda") * 10,
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_factor_arity2_minplus_kernel_equals_plain_on_ragged_tail(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ragged_lanes_args(case)
    got = hk.factor_arity2_minplus(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, hk.factor_arity2_minplus_plain(*args)):
        assert torch.equal(g, w)


def _eager_runner(compiled, solver, dev, consts):
    from pydcop_tpu_torch.algorithms import base

    return base._Eager(solver, dev, consts)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "algo, params",
    [
        ("maxsum", {"layout": "ell"}),
        ("maxsum", {"layout": "pallas"}),
        ("dsa", {}),
        ("mgm", {"break_mode": "random"}),
        ("mgm2", {}),
        ("maxsum", {"layout": "ell", "precision": "bf16"}),
        ("maxsum", {"layout": "pallas", "precision": "bf16"}),
        ("mixeddsa", {}),
        ("dba", {}),
        ("gdba", {"increase_mode": "R"}),
    ],
)
def test_captured_chunks_equal_eager_chunks_on_card(algo, params,
                                                    monkeypatch):
    # the same solve as replays of its captured graphs and as the same
    # chunk function run eagerly on the card: one trajectory, the same
    # bits; the kernels launch inside the graphs
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    import importlib

    from pydcop_tpu_torch.algorithms import base

    mod = importlib.import_module(f"pydcop_tpu_torch.algorithms.{algo}")
    compiled = generate_coloring_arrays(300, 3, graph="scalefree", m_edge=2,
                                        seed=21)
    captures = base.run_cycles.captures
    graphs = mod.solve(compiled, params, n_cycles=37, seed=3,
                       collect_curve=True, device="cuda")
    assert base.run_cycles.captures == captures + 2
    again = mod.solve(compiled, params, n_cycles=37, seed=3,
                      collect_curve=True, device="cuda")
    assert base.run_cycles.captures == captures + 2  # warm: no capture
    monkeypatch.setattr(base, "_runner", _eager_runner)
    eager = mod.solve(compiled, params, n_cycles=37, seed=3,
                      collect_curve=True, device="cuda")
    assert graphs == again == eager
    assert graphs.cycles == 37 and len(graphs.cost_curve) == 37


# DPOP on the card: its fused UTIL wave as one captured graph, and its
# streaming and chunked paths, each against the CPU
DPOP_CONFIG_5 = dict(slots_count=8, resources_count=30, events_count=30,
                     max_resources_event=2, seed=5)
DPOP_SMALL = dict(slots_count=4, resources_count=10, events_count=10,
                  max_resources_event=2, seed=5)


def _meetings(kw):
    from pydcop_tpu_torch.commands.generators.meetingscheduling import (
        generate_meeting_scheduling,
    )
    from pydcop_tpu_torch.compile.core import compile_dcop

    return compile_dcop(generate_meeting_scheduling(**kw))


@pytest.mark.cuda
def test_config5_on_the_card_like_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from pydcop_tpu_torch.algorithms import dpop

    c = _meetings(DPOP_CONFIG_5)
    cpu = dpop.solve(c, {}, device="cpu")
    captures, replays = dpop.solve.captures, dpop.solve.replays
    cold = dpop.solve(c, {}, device="cuda")
    assert (dpop.solve.captures, dpop.solve.replays) == (
        captures + 1, replays + 1
    )
    warm = dpop.solve(c, {}, device="cuda")
    assert (dpop.solve.captures, dpop.solve.replays) == (
        captures + 1, replays + 2
    )
    assert cold == warm == cpu
    assert cold.cost == 248.0


@pytest.mark.cuda
def test_streaming_and_chunked_on_the_card_like_the_cpu(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from pydcop_tpu_torch.algorithms import dpop

    c = _meetings(DPOP_SMALL)
    want = dpop.solve(c, {}, device="cpu")
    monkeypatch.setattr(dpop, "_plan_fused_wave", lambda *a: None)
    assert dpop.solve(_meetings(DPOP_SMALL), {}, device="cuda") == want
    monkeypatch.setattr(dpop, "MAX_JOINT_ELEMS", 9 ** 2)
    monkeypatch.setattr(dpop, "CHUNK_ELEMS", 9)
    chunks = dpop.solve.chunks
    assert dpop.solve(_meetings(DPOP_SMALL), {}, device="cuda") == want
    assert dpop.solve.chunks > chunks


# --- the bf16 plane (MaxSum's precision="bf16") and the tree sum ---------


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_planes_on_cpu_are_the_plain_versions_and_uncounted(case):
    ell = _args(case)
    ell[0] = ell[0].to(torch.bfloat16)
    lanes = _lanes_args(case)
    lanes[0] = lanes[0].to(torch.bfloat16)
    before = (hk.ell_minplus.launches, hk.factor_arity2_minplus.launches)
    got = hk.ell_minplus(*ell)
    assert got.dtype == torch.float32
    assert torch.equal(got, hk.ell_minplus_plain(*ell))
    # the add promotes the bf16 value exactly: the float32 plane's result
    widened = [ell[0].float()] + ell[1:]
    assert torch.equal(got, hk.ell_minplus_plain(*widened))
    for g, w in zip(hk.factor_arity2_minplus(*lanes),
                    hk.factor_arity2_minplus_plain(lanes[0].float(),
                                                   *lanes[1:])):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert before == (hk.ell_minplus.launches,
                      hk.factor_arity2_minplus.launches)


# element counts of the tree sum: one value, one window plus one, the
# config-4 unary and constraint totals, a million
TREE_SIZES = (1, 33, 100_000, 199_996, 1_000_000)


def test_xla_tree_sum_refuses_other_devices():
    with pytest.raises(ValueError):
        hk.xla_tree_sum(torch.zeros(40, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_kernels_equal_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ell = _args(case, "cuda")
    ell[0] = ell[0].to(torch.bfloat16)
    lanes = _lanes_args(case, "cuda")
    lanes[0] = lanes[0].to(torch.bfloat16)
    before = (hk.ell_minplus.launches, hk.factor_arity2_minplus.launches)
    got_ell = hk.ell_minplus(*ell)
    got_lanes = hk.factor_arity2_minplus(*lanes)
    torch.cuda.synchronize()
    assert (hk.ell_minplus.launches, hk.factor_arity2_minplus.launches) == (
        before[0] + 1, before[1] + 1
    )
    assert torch.equal(got_ell, hk.ell_minplus_plain(*ell))
    for g, w in zip(got_lanes, hk.factor_arity2_minplus_plain(*lanes)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_bf16_kernels_equal_plain_on_ragged_tail(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ell = _ragged_ell_args(case)
    ell[0] = ell[0].to(torch.bfloat16)
    lanes = _ragged_lanes_args(case)
    lanes[0] = lanes[0].to(torch.bfloat16)
    got_ell = hk.ell_minplus(*ell)
    got_lanes = hk.factor_arity2_minplus(*lanes)
    torch.cuda.synchronize()
    assert torch.equal(got_ell, hk.ell_minplus_plain(*ell))
    for g, w in zip(got_lanes, hk.factor_arity2_minplus_plain(*lanes)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernels_refuse_other_plane_dtypes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ell = _args("grid", "cuda")
    lanes = _lanes_args("grid", "cuda")
    with pytest.raises(TypeError):
        hk.ell_minplus(ell[0].half(), *ell[1:])
    with pytest.raises(TypeError):
        hk.factor_arity2_minplus(lanes[0].half(), *lanes[1:])
    with pytest.raises(TypeError):  # only the plane may be bf16
        hk.ell_minplus(ell[0], ell[1], ell[2].to(torch.bfloat16), ell[3])


@pytest.mark.cuda
@pytest.mark.parametrize("n", TREE_SIZES)
def test_xla_tree_sum_equals_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n)
    x = torch.where(torch.rand(n, generator=g, device="cuda") < 0.3, 1e9,
                    torch.rand(n, generator=g, device="cuda"))
    before = hk.xla_tree_sum.launches
    got = hk.xla_tree_sum(x)
    torch.cuda.synchronize()
    assert hk.xla_tree_sum.launches == before + 1  # one launch a sum
    assert torch.equal(got, hk.xla_tree_sum_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("db", [2, 16, 32, 64, 1024])
def test_xla_tree_sum_of_strided_rows_equals_plain_on_card(db):
    # one degree class of the ELL fan-in: a [D, nb, db] view of the plane
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(db)
    plane = torch.randn((3, 20_000), generator=g, device="cuda")
    seg = plane[:, 100:100 + 7 * db].reshape(3, 7, db)
    got = hk.xla_tree_sum(seg)
    torch.cuda.synchronize()
    assert got.shape == (3, 7)
    assert torch.equal(got, hk.xla_tree_sum_plain(seg))


@pytest.mark.cuda
def test_fan_ins_on_the_card_like_the_cpu():
    # the ordered fan-ins the bf16 planes and the jitted JAX order need:
    # a bf16 segmented sum (each partial sum rounded) and the float32 sum
    # onto the unary costs
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pydcop_tpu_torch.compile.kernels import segment_sum, segment_sum_onto

    compiled = generate_coloring_arrays(5000, 3, graph="scalefree",
                                        m_edge=2, seed=4)
    out = {}
    for device in ("cuda", "cpu"):
        dev = to_device(compiled, device)
        aux = lanes_aux(dev)
        f2v = torch.randn(
            (3, dev.n_edges), generator=torch.Generator().manual_seed(2)
        ).to(device)
        out[device] = [
            segment_sum(f2v.to(torch.bfloat16), aux.fan_in_offsets_t, 1),
            segment_sum_onto(aux.unary_t, f2v, dev.fan_in_onto_perm,
                             aux.fan_in_onto_offsets_t, 1),
        ]
    for card, cpu in zip(out["cuda"], out["cpu"]):
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ell", "lanes", "edges"])
def test_bf16_maxsum_on_the_card_like_the_cpu(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pydcop_tpu_torch.algorithms import maxsum

    compiled = generate_coloring_arrays(2000, 3, graph="scalefree", m_edge=2,
                                        seed=7)
    params = {"damping": 0.7, "precision": "bf16", "layout": layout}
    card = maxsum.solve(compiled, params, n_cycles=30, seed=7, device="cuda")
    cpu = maxsum.solve(compiled, params, n_cycles=30, seed=7, device="cpu")
    assert card == cpu
