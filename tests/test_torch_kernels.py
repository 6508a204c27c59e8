"""The Hopper kernel wrappers of ``compile/hopper_kernels.py``.

On CPU tensors a wrapper is its plain PyTorch version and counts no
launch; on other non-CUDA devices it raises.  The tests marked ``cuda``
hold each kernel against its plain version on the card, exactly, and skip
where there is no card: a CUDA kernel has no CPU mode.  This file imports
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
from pydcop_tpu_torch.compile.kernels import build_ell

# the small ELL cases of the JAX package's TestEllPallas, plus a D=16 one
CASES = {
    "scalefree": (150, 3, dict(graph="scalefree", m_edge=2, seed=13)),
    "clique": (12, 3, dict(graph="random", p_edge=1.0, seed=3)),
    "grid": (36, 3, dict(graph="grid", seed=4)),
    "scalefree_d16": (300, 16, dict(graph="scalefree", m_edge=2, seed=1)),
}


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
