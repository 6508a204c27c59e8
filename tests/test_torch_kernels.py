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
        ("adsa", {"variant": "C"}),
        ("dsatuto", {}),
        ("amaxsum", {"damping": 0.7}),
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


# the DFS of SyncBB and NCBB: the 16-variable soft coloring of
# chip_smoke.py's kernel check (25,872 SyncBB steps)
BB_SMALL = (16, 3, dict(graph="random", p_edge=0.25, soft=True, seed=3))


def _bb_compiled(spec=BB_SMALL):
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.compile.core import compile_dcop

    n, d, kw = spec
    return compile_dcop(generate_graph_coloring(n, d, **kw))


def _bb_searches(compiled, device="cpu"):
    """SyncBB's and NCBB's operands of ``compiled`` on ``device``."""
    from pydcop_tpu_torch.algorithms import _branch_bound, ncbb
    from pydcop_tpu_torch.algorithms.dpop import _Tree

    tree = _Tree(compiled)
    device = torch.device(device)
    return {
        "syncbb": _branch_bound._operands(
            compiled, np.arange(compiled.n_vars), None, device),
        "ncbb": _branch_bound._operands(
            compiled, np.asarray(tree.topo),
            ncbb._greedy_init(compiled, tree), device),
    }


def _dense_bb(n):
    """A complete graph of ``n`` variables: n - 1 attachment slots at the
    last position (20: the kernel's runtime slot count under 32; 40: the
    sum's windows of 32), tables of mixed magnitudes."""
    from pydcop_tpu_torch.compile.direct import compile_from_edges

    rng = np.random.default_rng(n)
    edges = np.array([(i, j) for i in range(n) for j in range(i + 1, n)],
                     dtype=np.int32)
    table = (rng.random((len(edges), 3, 3)) * 10.0 ** rng.integers(
        -3, 4, (len(edges), 1, 1))).astype(np.float32)
    return compile_from_edges(n, 3, edges, table)


def _chain_bb(n):
    """A chain of ``n`` variables: one attachment slot a position (K =
    1, the sum's one term), tables of mixed magnitudes."""
    from pydcop_tpu_torch.compile.direct import compile_from_edges

    rng = np.random.default_rng(n)
    edges = np.array([(i, i + 1) for i in range(n - 1)], dtype=np.int32)
    table = (rng.random((len(edges), 3, 3)) * 10.0 ** rng.integers(
        -3, 4, (len(edges), 1, 1))).astype(np.float32)
    return compile_from_edges(n, 3, edges, table)


# a tree: a scale-free soft coloring with one edge a new variable, so
# SyncBB's and NCBB's searches attach every position through one slot
BB_TREE = (14, 3, dict(graph="scalefree", m_edge=1, soft=True, seed=2))


def _k1_searches(device="cpu"):
    """The searches of real problems with K = 1: SyncBB on the chain,
    SyncBB and NCBB on the tree."""
    tree = _bb_searches(_bb_compiled(BB_TREE), device)
    return {
        "chain12": _bb_searches(_chain_bb(12), device)["syncbb"],
        "tree_syncbb": tree["syncbb"],
        "tree_ncbb": tree["ncbb"],
    }


def test_k1_searches_have_one_slot_and_complete():
    # each search of _k1_searches attaches through one slot and completes
    # within 5,000 steps, so the card test checks whole searches
    for name, ops in _k1_searches().items():
        assert ops[2].shape[1] == 1, name
        n = ops[0].shape[0]
        out = hk.branch_bound_plain(*ops, 5_000)
        assert int(out[n + 2]) == 1, name


def bb_operands(n, k, d, seed, ties=False, ub0=np.inf, device="cpu"):
    """Raw operands of ``branch_bound``, made from ``seed``: n positions
    of mixed domain sizes (1..d), K attachment slots a position, each
    later position attached to random earlier ones (the last through all
    K slots, about a fifth of the others through none), masked-off slots
    left holding garbage (a random position, nonzero tables) that the
    search must ignore, tables of mixed magnitudes (``ties``: small
    integers, so many partial costs tie), the tail bound admissible as
    ``_operands`` makes it, a random ``best0`` and the given ``ub0``."""
    rng = np.random.default_rng(seed)
    dsize = rng.integers(1, d + 1, n)
    if ties:
        unary = rng.integers(0, 3, (n, d)).astype(np.float32)
        table = rng.integers(0, 3, (n, k, d, d)).astype(np.float32)
    else:
        unary = rng.random((n, d)).astype(np.float32)
        table = (rng.random((n, k, d, d)) * 10.0 ** rng.integers(
            -3, 3, (n, k, 1, 1))).astype(np.float32)
    other = rng.integers(0, n, (n, k)).astype(np.int32)
    mask = np.zeros((n, k), dtype=bool)
    for p in range(1, n):
        m = k if p == n - 1 else int(rng.integers(0, k + 1))
        if p != n - 1 and rng.random() < 0.2:
            m = 0
        mask[p, :m] = True
        other[p, :m] = rng.integers(0, p, m)
    per_pos = [
        unary[p, :dsize[p]].min() + sum(
            table[p, s][:dsize[other[p, s]], :dsize[p]].min()
            for s in range(k) if mask[p, s])
        for p in range(n)
    ]
    lb_suffix = np.zeros(n + 1)
    lb_suffix[:n] = np.cumsum(per_pos[::-1])[::-1]
    best0 = rng.integers(0, d, n).astype(np.int32)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

    return (put(unary, np.float32), put(dsize, np.int32),
            put(table, np.float32), put(other, np.int32), put(mask, bool),
            put(lb_suffix, np.float32), put(ub0, np.float32),
            put(best0, np.int32))


# name: bb_operands' (n, K, D, seed) and options: K across the sum's cut
# points (1: the one term; 31, 32: slot order; 33, 64: windows), D across
# the row's (1, 2, 5, 16; 17 and 33: columns past a warp's 32 lanes with
# 40 slots), one position, ties, and a seed bound that prunes every value
# at depth 0
BB_SYNTH = {
    "k1": ((6, 1, 3, 1), {}),
    "k31": ((6, 31, 2, 2), {}),
    "k32": ((5, 32, 3, 3), {}),
    "k33": ((5, 33, 2, 4), {}),
    "k64": ((4, 64, 2, 5), {}),
    "d1": ((7, 3, 1, 6), {}),
    "d2": ((8, 4, 2, 7), {}),
    "d5": ((6, 4, 5, 8), {}),
    "d16": ((3, 5, 16, 9), {}),
    "d17": ((3, 2, 17, 10), {}),
    "k40_d33": ((4, 40, 33, 11), {}),
    "n1": ((1, 1, 3, 12), {}),
    "ties": ((8, 3, 3, 13), {"ties": True}),
    "pruned_at_0": ((6, 3, 3, 14), {"ub0": -1.0}),
}


def test_bb_operands_are_oriented_with_garbage_in_masked_slots():
    for (n, k, d, seed), kw in BB_SYNTH.values():
        ops = bb_operands(n, k, d, seed, **kw)
        other, mask = ops[3], ops[4]
        pos = torch.arange(n)[:, None].expand(n, k)
        assert bool(((other < pos) | ~mask).all())
        assert not bool(mask[0].any())
        assert int(mask[-1].sum()) == (k if n > 1 else 0)
        assert bool((ops[1] >= 1).all() and (ops[1] <= d).all())


def test_branch_bound_on_cpu_is_the_plain_version_and_uncounted():
    ops = _bb_searches(_bb_compiled())["ncbb"]
    before = hk.branch_bound.launches
    got = hk.branch_bound(*ops, 10 ** 6)
    assert torch.equal(got, hk.branch_bound_plain(*ops, 10 ** 6))
    assert hk.branch_bound.launches == before
    n = ops[0].shape[0]
    assert got.dtype == torch.int32 and got.shape == (n + 3,)
    assert (int(got[n + 1]), int(got[n + 2])) == (2296, 1)  # steps, done


def test_branch_bound_refuses_other_devices():
    ops = _bb_searches(_bb_compiled())["syncbb"]
    with pytest.raises(ValueError):
        hk.branch_bound(*[a.to("meta") for a in ops], 100)


@pytest.mark.cuda
@pytest.mark.parametrize("tables_shared", [True, False])
def test_branch_bound_kernel_equals_plain_on_card(tables_shared,
                                                  monkeypatch):
    # the tables in shared memory, and (a budget too small for them) read
    # from device memory: the same search, step for step
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if not tables_shared:
        sizes = hk._bb_shared_bytes
        monkeypatch.setattr(
            hk, "_bb_shared_bytes",
            lambda lib, n, k, d, shared: (
                10 ** 9 if shared else sizes(lib, n, k, d, 0)
            ),
        )
    searches = _bb_searches(_bb_compiled(), "cuda")
    for n in (20, 40):
        searches[f"dense{n}"] = _bb_searches(_dense_bb(n), "cuda")["syncbb"]
    for name, (args, kw) in BB_SYNTH.items():
        searches[name] = bb_operands(*args, **kw, device="cuda")
    searches.update(_k1_searches("cuda"))
    for name, ops in searches.items():
        # the real problems' searches whole; the others capped
        full = 3_000 if name in BB_SYNTH or name.startswith("dense") \
            else 10 ** 6
        for max_iters in (1, 5, full):
            before = hk.branch_bound.launches
            got = hk.branch_bound(*ops, max_iters)
            torch.cuda.synchronize()
            assert hk.branch_bound.launches == before + 1
            # best, ub's bits, steps, completion: exactly the plain DFS's
            want = hk.branch_bound_plain(*ops, max_iters)
            assert torch.equal(got, want), (name, max_iters)
    # the seed bound prunes depth 0's values: dsize + 1 steps, complete
    n = BB_SYNTH["pruned_at_0"][0][0]
    ops = searches["pruned_at_0"]
    got = hk.branch_bound(*ops, 10 ** 6)
    assert int(got[n + 1]) == int(ops[1][0]) + 1 and int(got[n + 2]) == 1


@pytest.mark.cuda
def test_branch_bound_refuses_misoriented_attachments_on_card():
    # the kernel computes a position's row once a visit, which needs every
    # attachment to point to an earlier position: others get the seed
    # back (best0, ub0's bits) with steps = -1, every word defined
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ops = list(_bb_searches(_bb_compiled(), "cuda")["syncbb"])
    n = ops[0].shape[0]
    assert int(hk.branch_bound(*ops, 10)[n + 1]) == 10
    p = int(ops[4].any(dim=1).nonzero()[-1])
    slot = int(ops[4][p].nonzero()[0])
    for bad in (p, n, -1):
        other = ops[3].clone()
        other[p, slot] = bad
        got = hk.branch_bound(*ops[:3], other, *ops[4:], 10)
        seed = torch.cat([ops[7], ops[6].reshape(1).view(torch.int32),
                          torch.tensor([-1, 0], device="cuda",
                                       dtype=torch.int32)])
        assert torch.equal(got, seed)


@pytest.mark.cuda
def test_branch_bound_checks_its_operands_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ops = list(_bb_searches(_bb_compiled(), "cuda")["syncbb"])
    bad = list(ops)
    bad[1] = ops[1].long()
    with pytest.raises(TypeError):
        hk.branch_bound(*bad, 10)
    with pytest.raises(ValueError):
        hk.branch_bound(*ops, 2 ** 31)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["syncbb", "ncbb"])
def test_branch_and_bound_on_the_card_like_the_cpu(algo):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import importlib

    mod = importlib.import_module(f"pydcop_tpu_torch.algorithms.{algo}")
    compiled = _bb_compiled()
    before = hk.branch_bound.launches
    card = mod.solve(compiled, {}, device="cuda")
    assert hk.branch_bound.launches == before + 1  # one launch a solve
    assert card == mod.solve(compiled, {}, device="cpu")
    capped = mod.solve(compiled, {"max_iters": 7}, device="cuda")
    assert capped.status == "TIMEOUT"
    assert capped == mod.solve(compiled, {"max_iters": 7}, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("layout, precision", [
    ("lanes", "f32"), ("edges", "f32"), ("lanes", "bf16"),
])
def test_dynamic_session_on_the_card_like_the_cpu(layout, precision):
    # the resident session: runs, a change, runs; the card equals the
    # CPU, a warm run captures nothing, the lanes layout launches
    # factor_arity2_minplus once an iteration
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from pydcop_tpu_torch.algorithms import base
    from pydcop_tpu_torch.algorithms.maxsum_dynamic import DynamicMaxSum
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_graph_coloring,
    )
    from pydcop_tpu_torch.dcop.relations import constraint_from_str

    results = {}
    for device in ("cuda", "cpu"):
        dcop = generate_graph_coloring(300, 3, "scalefree", m_edge=2, seed=9)
        session = DynamicMaxSum(
            dcop, {"layout": layout, "precision": precision, "damping": 0.7},
            seed=2, device=device,
        )
        runs = []
        for i in range(4):
            if i == 2:
                scope = list(dcop.constraints["cost_1"].dimensions)
                session.change_factor_function("cost_1", constraint_from_str(
                    "cost_1", f"4 if {scope[0].name} == {scope[1].name} "
                    "else 0", scope,
                ))
            captures = base.run_cycles.captures
            launches = hk.factor_arity2_minplus.launches
            iterations = base.run_cycles.iterations
            runs.append(session.run(20))
            if device == "cuda":
                assert base.run_cycles.captures - captures == (
                    2 if i == 0 else 0
                )
                if layout == "lanes":
                    assert hk.factor_arity2_minplus.launches - launches == (
                        base.run_cycles.iterations - iterations
                        + (1 if i == 0 else 0)
                    )
        results[device] = runs
    assert results["cuda"] == results["cpu"]


def _ell_batch(k, d, dtype, device="cpu"):
    """K instances of one ELL shape: a scale-free coloring's layout with
    its own random tables, plane and partner of every real slot."""
    n, _, kw = CASES["scalefree"]
    ell = build_ell(generate_coloring_arrays(n, d, **dict(kw, seed=d)))
    out = []
    for i in range(k):
        rng = np.random.default_rng(100 + i)
        v2f = np.where(ell.real_row, rng.normal(size=(d, ell.n_pad)), 0.0)
        tabs = (rng.random(ell.tabs_t.shape) * 10).astype(np.float32)
        out.append((v2f.astype(np.float32), rng.permutation(
            ell.pair_perm).astype(np.int32), tabs, ell.real_row))
    args = [torch.as_tensor(np.stack(col), device=device)
            for col in zip(*out)]
    args[0] = args[0].to(dtype)
    return args


@pytest.mark.parametrize("k", [1, 3])
def test_ell_minplus_batched_on_cpu_is_each_instance(k):
    args = _ell_batch(k, 3, torch.float32)
    got = hk.ell_minplus_batched(*args)
    for i in range(k):
        assert torch.equal(got[i], hk.ell_minplus_plain(*(a[i] for a in args)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [3, 17])
@pytest.mark.parametrize("k", [1, 3, 32])
def test_ell_minplus_batched_kernel_equals_plain_on_card(k, d, dtype):
    # one launch for K instances (instance-local partners), each the
    # plain version's of its operands, at a fixed-D and the runtime-D
    # kernel, float32 and bf16 planes
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _ell_batch(k, d, dtype, "cuda")
    before = (hk.ell_minplus.launches, hk.ell_minplus.batched.launches)
    got = hk.ell_minplus_batched(*args)
    torch.cuda.synchronize()
    assert (hk.ell_minplus.launches - before[0],
            hk.ell_minplus.batched.launches - before[1]) == (1, 1)
    for i in range(k):
        assert torch.equal(got[i], hk.ell_minplus_plain(*(a[i] for a in args)))
    # mapped over the instances, the wrapper is the same one launch
    mapped = torch.func.vmap(hk.ell_minplus)(*args)
    assert torch.equal(mapped, got)


@pytest.mark.cuda
def test_serve_batch_on_card_is_solve_one_on_card():
    # the vmap mode on the card: the engine mapped over the instances and
    # captured once per bucket; each tenant the bits of its card solve_one
    # and of the CPU's; a warm batch captures nothing
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pydcop_tpu_torch.algorithms import base
    from pydcop_tpu_torch.serve import SolveRequest, solve_batched, solve_one

    degraded = solve_batched.degraded
    for algo, params in (
        ("maxsum", {}), ("maxsum", {"precision": "bf16", "noise": 0.0}),
        ("dsa", {}), ("dsa", {"variant": "A"}), ("dsa", {"variant": "C"}),
        ("mgm", {"break_mode": "random"}), ("mgm2", {}),
    ):
        reqs = [
            SolveRequest(f"{algo}{i}", generate_coloring_arrays(
                n, 3, graph="grid", seed=70 + i), algo, params, 20, i)
            for i, n in enumerate((25, 25, 49, 25, 49))
        ]
        out = solve_batched(reqs, device="cuda")
        # a batch that raised would degrade to solo solves, with the same
        # results: the count shows it
        assert solve_batched.degraded == degraded, (algo, params)
        captures = base.run_cycles.captures
        again = solve_batched(reqs, device="cuda")
        assert base.run_cycles.captures == captures
        for r in reqs:
            one = solve_one(r, device="cuda")
            cpu = solve_one(r, device="cpu")
            for got in (out[r.tenant], again[r.tenant], cpu):
                assert got.result == one.result
                assert got.extras["best_cost"] == one.extras["best_cost"]


# -- damp_fma: MaxSum's float32 damping as one fused multiply-add ---------


def near_midpoints(damping, n, seed):
    """``(prev, new)`` whose exact ``d * prev + e * new`` is a float32
    midpoint plus or minus a quarter of a float64 ulp: the float64 sum
    lands on the midpoint, so only a single rounding (or round-to-odd)
    rounds it the right way."""
    d, e = hk.damp_constants(damping)
    rng = np.random.default_rng(seed)
    prevs, news = [], []
    while len(prevs) < n:
        p = np.float32(rng.uniform(1, 2) * 2.0 ** rng.integers(-4, 8))
        a = float(p) * d  # exact: 48 significant bits
        exp = np.frexp(a)[1] - 1  # a in [2**exp, 2**(exp + 1))
        ulp32 = 2.0 ** (exp - 23)
        mid = (np.floor(a / ulp32) + 0.5) * ulp32  # a float32 midpoint
        sign = 1.0 if rng.integers(2) else -1.0
        # c = mid - a + sign * 2**(exp - 54): float32 if it fits 24 bits
        c = (mid - a) + sign * 2.0 ** (exp - 54)
        if c == 0 or np.float32(c) != c:
            continue
        # new with float32(e * new) == c
        for cand in (np.float32(c / e), np.nextafter(np.float32(c / e),
                                                      np.float32(np.inf)),
                     np.nextafter(np.float32(c / e), np.float32(-np.inf))):
            if np.float32(np.float32(e) * cand) == np.float32(c):
                prevs.append(p)
                news.append(cand)
                break
    return np.array(prevs, np.float32), np.array(news, np.float32)


def test_damp_fma_on_cpu_is_its_plain_version_and_launches_nothing():
    rng = np.random.default_rng(5)
    prev, new = (torch.as_tensor(rng.normal(size=(3, 40)).astype(np.float32))
                 for _ in range(2))
    before = hk.damp_fma.launches
    d, e = hk.damp_constants(0.7)
    assert torch.equal(hk.damp_fma(0.7, prev, new),
                       hk.damp_fma_plain(prev, new, d, e))
    assert hk.damp_fma.launches == before
    with pytest.raises(TypeError):
        hk.damp_fma(0.7, prev.to(torch.bfloat16), new)
    with pytest.raises(ValueError):
        hk.damp_fma(0.7, prev.to("meta"), new.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1027, 3 * 500_598, 2_500_001])
def test_damp_fma_kernel_equals_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(n)
    prev, new = (torch.as_tensor(rng.normal(size=n).astype(np.float32),
                                 device="cuda") * 10 for _ in range(2))
    d, e = hk.damp_constants(0.7)
    before = hk.damp_fma.launches
    assert torch.equal(hk.damp_fma(0.7, prev, new),
                       hk.damp_fma_plain(prev, new, d, e))
    assert hk.damp_fma.launches == before + 1
    # an unaligned view takes the scalar path
    assert torch.equal(hk.damp_fma(0.7, prev[1:], new[1:]),
                       hk.damp_fma_plain(prev[1:], new[1:], d, e))


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.7, 0.3])
def test_damp_fma_kernel_rounds_once_near_midpoints_on_card(damping):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    prev, new = (torch.as_tensor(x) for x in near_midpoints(damping, 2048, 3))
    d, e = hk.damp_constants(damping)
    want = hk.damp_fma_plain(prev, new, d, e)
    got = hk.damp_fma(damping, prev.cuda(), new.cuda()).cpu()
    assert torch.equal(got, want)
    # the float64 chain rounds twice and misses some of them
    chain = (prev.double() * d + ((1.0 - damping) * new).double()).float()
    assert not torch.equal(chain, want)
    # batched: K=32 planes, one launch
    p, q = prev.reshape(32, 64).cuda(), new.reshape(32, 64).cuda()
    before = hk.damp_fma.batched.launches
    got = torch.func.vmap(lambda a, b: hk.damp_fma(damping, a, b))(p, q)
    assert hk.damp_fma.batched.launches == before + 1
    assert torch.equal(got.cpu(), want.reshape(32, 64))
