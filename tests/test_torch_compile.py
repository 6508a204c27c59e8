"""The port's host-side layers give the JAX package's arrays exactly: the
array generator (same numpy RNG calls in the same order), the compile to
``CompiledDCOP``, and the ELL layout.  ``compiled_from_numpy`` carries a
JAX ``CompiledDCOP`` across unchanged."""

import dataclasses

import numpy as np
import pytest

from pydcop_tpu.commands.generators.graphcoloring import (
    generate_coloring_arrays as jax_generate,
)
from pydcop_tpu.compile.kernels import build_ell as jax_build_ell
from pydcop_tpu.compile.kernels import build_f2v_perm as jax_build_f2v_perm
from pydcop_tpu.compile.kernels import to_device as jax_to_device
from pydcop_tpu_torch.commands.generators.graphcoloring import (
    generate_coloring_arrays,
)
from pydcop_tpu_torch.compile.kernels import (
    build_ell,
    build_f2v_perm,
    to_device,
)
from pydcop_tpu_torch.interop import compiled_from_numpy

# the JAX package's TestEllPallas.CASES (scalefree 150, clique 12, grid
# 36), plus bench config 2's generator call (1k random, p=0.005)
CASES = {
    "scalefree": (150, dict(graph="scalefree", m_edge=2, seed=13)),
    "clique": (12, dict(graph="random", p_edge=1.0, seed=3)),
    "grid": (36, dict(graph="grid", seed=4)),
    "random1k": (1000, dict(graph="random", p_edge=0.005, seed=11)),
}

COMPILED_FIELDS = [
    "objective", "var_names", "var_index", "n_vars", "max_domain",
    "domain_size", "valid_mask", "unary", "constant_cost", "n_edges",
    "edge_var", "edge_con", "var_degree", "con_names",
]
BUCKET_FIELDS = ["arity", "tables", "var_slots", "edge_ids", "con_ids", "names"]
ELL_FIELDS = [
    "spans", "n_pad", "var_perm", "pos_of_var", "edge_orig", "pair_perm",
    "tabs_t", "edge_valid_t", "valid_ell_t", "dsize_edges", "real_row",
]


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _assert_compiled_equal(port, ref):
    for f in COMPILED_FIELDS:
        assert _equal(getattr(port, f), getattr(ref, f)), f
    assert [(d.name, d.type, d.values) for d in port.domains] == [
        (d.name, d.type, d.values) for d in ref.domains
    ]
    assert len(port.buckets) == len(ref.buckets)
    for pb, rb in zip(port.buckets, ref.buckets):
        for f in BUCKET_FIELDS:
            assert _equal(getattr(pb, f), getattr(rb, f)), f"bucket.{f}"


def _make(name):
    n, kw = CASES[name]
    return generate_coloring_arrays(n, 3, **kw), jax_generate(n, 3, **kw)


def _fields(ref):
    """The JAX CompiledDCOP exported as plain fields (asdict-style)."""
    out = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    out["buckets"] = [dataclasses.asdict(b) for b in ref.buckets]
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_and_compile_match(case):
    port, ref = _make(case)
    _assert_compiled_equal(port, ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_ell_matches(case):
    port, ref = _make(case)
    pe, re_ = build_ell(port), jax_build_ell(ref)
    for f in ELL_FIELDS:
        assert _equal(getattr(pe, f), getattr(re_, f)), f


@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_from_numpy_round_trip(case):
    _, ref = _make(case)
    port = compiled_from_numpy(_fields(ref))
    _assert_compiled_equal(port, ref)
    assert port.host_cost(np.zeros(ref.n_vars, np.int32)) == ref.host_cost(
        np.zeros(ref.n_vars, np.int32)
    )


def test_host_cost_and_neighbor_pairs_match():
    port, ref = _make("scalefree")
    vals = np.random.default_rng(0).integers(0, 3, ref.n_vars)
    assert port.host_cost(vals) == ref.host_cost(vals)
    for a, b in zip(port.neighbor_pairs(), ref.neighbor_pairs()):
        assert _equal(a, b)
    assert port.assignment_from_indices(vals) == ref.assignment_from_indices(
        vals
    )


def test_build_ell_rejects_what_it_cannot_lay_out():
    port, _ = _make("grid")
    with pytest.raises(NotImplementedError, match="n_shards"):
        build_ell(port, n_shards=2)


def test_compiled_from_numpy_rejects_object_level_dcops():
    _, ref = _make("grid")
    fields = _fields(ref)
    fields["dcop"] = object()
    with pytest.raises(NotImplementedError):
        compiled_from_numpy(fields)


def _mixed_and_edgeless():
    """A binary + ternary problem and one with no edges, compiled by the
    JAX package and carried across (only their arrays)."""
    from pydcop_tpu.commands.generators.mixedproblem import (
        generate_mixed_problem,
    )
    from pydcop_tpu.compile.core import compile_dcop

    out = {}
    for name, arity, seed in (("mixed", 3, 1), ("edgeless", 1, 2)):
        n = 30 if arity == 3 else 10
        ref = compile_dcop(
            generate_mixed_problem(n, 20 if arity == 3 else n, 0.3,
                                   arity=arity, seed=seed)
        )
        fields = _fields(ref)
        fields["dcop"] = None
        out[name] = (compiled_from_numpy(fields), ref)
    return out


DEVICE_FIELDS = [
    "n_vars", "max_domain", "n_edges", "n_constraints", "domain_size",
    "valid_mask", "unary", "constant_cost", "edge_var", "edge_con",
    "var_degree", "f2v_perm",
]
DEVICE_BUCKET_FIELDS = [
    "arity", "tables_flat", "var_slots", "edge_ids", "con_ids",
]


@pytest.mark.parametrize("case", sorted(CASES) + ["edgeless", "mixed"])
def test_to_device_fields_match(case):
    if case in ("edgeless", "mixed"):
        port, ref = _mixed_and_edgeless()[case]
    else:
        port, ref = _make(case)
    pdev, rdev = to_device(port, "cpu"), jax_to_device(ref)
    for f in DEVICE_FIELDS:
        assert np.array_equal(
            np.asarray(getattr(pdev, f)), np.asarray(getattr(rdev, f))
        ), f
    assert len(pdev.buckets) == len(rdev.buckets)
    for pb, rb in zip(pdev.buckets, rdev.buckets):
        for f in DEVICE_BUCKET_FIELDS:
            assert np.array_equal(
                np.asarray(getattr(pb, f)), np.asarray(getattr(rb, f))
            ), f"bucket.{f}"
    # every variable's fan-in segment: its edges, and the dummy edge of an
    # edgeless problem on variable 0
    offsets = pdev.fan_in_offsets.numpy()
    assert offsets[0] == 0 and offsets[-1] == pdev.n_edges
    assert np.array_equal(
        np.repeat(np.arange(pdev.n_vars), np.diff(offsets)),
        pdev.edge_var.numpy(),
    )


@pytest.mark.parametrize("case", ["mixed", "random1k"])
def test_build_f2v_perm_matches(case):
    if case == "mixed":
        port, ref = _mixed_and_edgeless()[case]
    else:
        port, ref = _make(case)
    for n_edges in (port.n_edges, port.n_edges + 3):  # + edges on no bucket
        got = build_f2v_perm([b.edge_ids for b in port.buckets], n_edges)
        want = jax_build_f2v_perm([b.edge_ids for b in ref.buckets], n_edges)
        assert _equal(got, want)
    # the sentinel row sits past every block
    assert got[-1] == sum(b.edge_ids.size for b in port.buckets)


def test_to_device_rejects_unsorted_edges():
    port, _ = _make("grid")
    port.edge_var = port.edge_var[::-1].copy()
    with pytest.raises(ValueError, match="sorted"):
        to_device(port, "cpu")
