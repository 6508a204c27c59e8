"""The cost curve of a 4x4 Ising against the JAX package's, bit for bit.

The problem is the JAX package's ``generate ising --row_count 4
--col_count 4 --seed 1`` (16 variables, one bucket of 32 binary
constraints), solved from the same YAML text by both packages'
``solve_result`` with seed 0 for 15 cycles, DSA, MGM and MaxSum.

The curves differ in their last bits (DSA's at all 15 indices, MGM's at
14, MaxSum's at 13, by 1-2 float32 ulps), while the final cost and
assignment agree.  The operation is ``evaluate``'s sum of the bucket's
32 gathered costs: XLA-CPU fuses the sum with its gather and LLVM
vectorizes it, where the port sums those values in XLA's unfused order
(``hk.tree_evaluate_plain``).  On an AVX-512 x86 CPU an 8-lane loop with
one accumulator, a halving horizontal sum and a scalar tail gives JAX's
bits on every sum of 22 to 32 gathered values tried and on all three
curves; the port does not use it yet (the card's ``evaluate_kernel``
would have to sum such segments in that order too), so the cases are
expected to fail.
"""

import pytest

import pydcop_tpu.api as jax_api
from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.commands.generators.ising import generate_ising
from pydcop_tpu.dcop.yamldcop import dcop_yaml as jax_dcop_yaml
from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load_dcop
from pydcop_tpu_torch import api
from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.dcop.yamldcop import load_dcop

FIRST_DIFFERING_OPERATION = (
    "evaluate's sum of the bucket's 32 gathered costs: XLA-CPU fuses it "
    "with the gather and LLVM vectorizes it (8 lanes, a halving "
    "horizontal sum); the port sums them in XLA's unfused order"
)


@pytest.fixture(scope="module")
def ising_text():
    return jax_dcop_yaml(generate_ising(4, 4, seed=1))


@pytest.mark.xfail(strict=True, reason=FIRST_DIFFERING_OPERATION)
@pytest.mark.parametrize("algo", ["dsa", "mgm", "maxsum"])
def test_ising_cost_curve_is_jax_bit_for_bit(ising_text, algo):
    jax = jax_api.solve_result(
        jax_load_dcop(ising_text),
        JaxAlgorithmDef.build_with_default_param(algo),
        n_cycles=15, seed=0, collect_curve=True,
    )
    port = api.solve_result(
        load_dcop(ising_text), AlgorithmDef.build_with_default_param(algo),
        n_cycles=15, seed=0, collect_curve=True, device="cpu",
    )
    # the results the curve does not decide agree either way
    assert port["cost"] == jax["cost"]
    assert port["assignment"] == jax["assignment"]
    assert len(port["cost_curve"]) == len(jax["cost_curve"]) == 15
    assert port["cost_curve"] == jax["cost_curve"]
