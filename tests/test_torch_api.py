"""The port's front door against the JAX package's, on the CPU.

``api.solve_result`` of both packages on the YAML instances of
``tests/instances/``: every field but ``time`` must match, identically
for the local-search solvers and DPOP; for MaxSum the violations, cycles,
messages and assignment must match and the cost within rel 1e-5 (the
port's stated MaxSum bar, since float sums may be ordered differently).
A ``cost_curve`` is the per-cycle cost on the device, a float32 sum: held
to rel 1e-6, as ``test_torch_engine.py`` holds it.  The CLI is held to
the same bar in ``test_torch_cli.py``.
"""

from pathlib import Path

import pytest
import torch

import pydcop_tpu as J
import pydcop_tpu_torch as P
from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu_torch.algorithms import AlgorithmDef

ROOT = Path(__file__).resolve().parent.parent
INSTANCES = ["graph_coloring", "ising_4x4", "secp_small"]
ALGOS = ["maxsum", "dsa", "mgm", "mgm2", "dpop"]


def _path(name):
    return str(ROOT / "tests" / "instances" / f"{name}.yaml")


def assert_same_result(port, ref, algo):
    port = {k: v for k, v in port.items() if k != "time"}
    ref = {k: v for k, v in ref.items() if k != "time"}
    if algo == "maxsum":
        assert port.pop("cost") == pytest.approx(ref.pop("cost"), rel=1e-5)
    if "cost_curve" in ref:
        assert port.pop("cost_curve") == pytest.approx(
            ref.pop("cost_curve"), rel=1e-6
        )
    assert port == ref


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("instance", INSTANCES)
def test_solve_result_like_jax(instance, algo):
    ref = J.load_dcop_from_file(_path(instance))
    port = P.load_dcop_from_file(_path(instance))
    kw = dict(n_cycles=40, seed=3)
    assert_same_result(
        P.solve_result(port, algo, device="cpu", **kw),
        J.solve_result(ref, algo, **kw),
        algo,
    )


@pytest.mark.parametrize("algo, params", [
    ("maxsum", {"damping": 0.7, "layout": "lanes"}),
    ("dsa", {"variant": "C", "probability": 0.5}),
    ("mgm2", {"threshold": 0.3}),
])
def test_algorithm_defs_like_jax(algo, params):
    ref = J.load_dcop_from_file(_path("graph_coloring"))
    port = P.load_dcop_from_file(_path("graph_coloring"))
    port_def = AlgorithmDef.build_with_default_param(
        algo, params, mode=port.objective
    )
    ref_def = JaxAlgorithmDef.build_with_default_param(
        algo, params, mode=ref.objective
    )
    assert port_def.params == ref_def.params
    got = P.solve_result(port, port_def, distribution="oneagent",
                         collect_curve=True, device="cpu")
    assert_same_result(
        got, J.solve_result(ref, ref_def, distribution="oneagent",
                            collect_curve=True),
        algo,
    )
    assert got["distribution"] == "oneagent"
    # a name string is the definition with every default
    by_name = P.solve_result(port, algo, device="cpu")
    by_def = P.solve_result(
        port, AlgorithmDef.build_with_default_param(algo, mode="min"),
        device="cpu",
    )
    assert_same_result(by_name, by_def, "exact")


def test_timeout_like_jax():
    port = P.load_dcop_from_file(_path("ising_4x4"))
    # a budget the solve cannot reach changes nothing
    assert_same_result(
        P.solve_result(port, "dsa", n_cycles=50, timeout=600, device="cpu"),
        P.solve_result(port, "dsa", n_cycles=50, device="cpu"),
        "dsa",
    )
    # one it does reach stops after whole chunks and reports TIMEOUT
    r = P.solve_result(port, "dsa", n_cycles=10 ** 7, timeout=0.5,
                       device="cpu")
    assert r["status"] == "TIMEOUT" and r["cycle"] < 10 ** 7
    # a one-shot solver takes no timeout; a finished solve is FINISHED
    assert P.solve_result(
        port, "dpop", timeout=600, device="cpu"
    )["status"] == "FINISHED"


@pytest.mark.parametrize("algo", ["dpop", "mgm"])
@pytest.mark.parametrize("infinity", [0.5, 3.0])
def test_infinity_like_jax(algo, infinity):
    ref = J.load_dcop_from_file(_path("secp_small"))
    port = P.load_dcop_from_file(_path("secp_small"))
    got = P.solve_result(port, algo, infinity=infinity, device="cpu")
    assert_same_result(got, J.solve_result(ref, algo, infinity=infinity),
                       algo)
    default = P.solve_result(port, algo, device="cpu")
    assert (got["cost"], got["violation"]) != (
        default["cost"], default["violation"]
    )


def test_solve_result_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = P.load_dcop_from_file(_path("graph_coloring"))
    for algo in ALGOS:
        with pytest.raises(RuntimeError, match="cuda"):
            P.solve_result(port, algo)
    assert P.solve(port, "dpop", device="cpu") == P.solve_result(
        port, "dpop", device="cpu"
    )["assignment"]
