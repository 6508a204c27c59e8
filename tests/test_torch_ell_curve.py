"""MaxSum's ``ell`` cost curve against the JAX package's, bit for bit.

The problem is ``generate graph_coloring -v 200 -c 5 -g scalefree
--m_edge 3 --noise_level 0.2 --seed 4`` (max degree 63: ELL classes of
4, 8, 16, 32 and 64 slots), solved from the same YAML text by both
packages' ``solve_result`` with seed 0.

The curves differ, and the first operation whose bits differ is the
reduce over the 32-slot class in the ELL fan-in (``seg.sum(axis=2)`` of
``variable_step_with_select_ell``).  XLA-CPU fuses that reduce with the
wavefront's two selects (``start_messages="leafs"``, the default) and
LLVM vectorizes the fused loop: eight lanes, two accumulators, a halving
horizontal sum, and, where the factor damping's multiply is fused in
too, multiply-adds that the backend reassociates.  The same reduce
without the wavefront's selects is summed in order, as the port sums it.
The order follows the host's vectorizer and the fusion's producer, so
the port does not copy it: the cases are expected to fail.
``tests/ell_order_probe.py`` shows the first differing plane and the
orders, cycle by cycle.
"""

import pytest

import pydcop_tpu.api as jax_api
from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.commands.generators.graphcoloring import (
    generate_graph_coloring,
)
from pydcop_tpu.dcop.yamldcop import dcop_yaml as jax_dcop_yaml
from pydcop_tpu.dcop.yamldcop import load_dcop as jax_load_dcop
from pydcop_tpu_torch import api
from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.dcop.yamldcop import load_dcop

FIRST_DIFFERING_OPERATION = (
    "the ELL fan-in's reduce over the 32-slot class: XLA-CPU fuses it "
    "with the wavefront's selects and LLVM vectorizes it (8 lanes, 2 "
    "accumulators, halving horizontal sum); the port sums in order"
)


def scalefree_yaml() -> str:
    return jax_dcop_yaml(generate_graph_coloring(
        200, 5, graph="scalefree", m_edge=3, soft=False, noise_level=0.2,
        seed=4,
    ))


@pytest.fixture(scope="module")
def scalefree_text():
    return scalefree_yaml()


@pytest.mark.xfail(strict=True, reason=FIRST_DIFFERING_OPERATION)
@pytest.mark.parametrize("params, n_cycles", [
    ({"layout": "ell", "damping": 0.3, "damping_nodes": "vars"}, 40),
    ({"layout": "ell", "damping": 0.0}, 60),
])
def test_ell_cost_curve_is_jax_bit_for_bit(scalefree_text, params, n_cycles):
    jax = jax_api.solve_result(
        jax_load_dcop(scalefree_text),
        JaxAlgorithmDef.build_with_default_param("maxsum", params=params),
        n_cycles=n_cycles, seed=0, collect_curve=True,
    )
    port = api.solve_result(
        load_dcop(scalefree_text),
        AlgorithmDef.build_with_default_param("maxsum", params=params),
        n_cycles=n_cycles, seed=0, collect_curve=True, device="cpu",
    )
    # the results the curve does not decide agree either way
    assert port["cost"] == jax["cost"]
    assert port["assignment"] == jax["assignment"]
    assert port["cost_curve"] == jax["cost_curve"]
