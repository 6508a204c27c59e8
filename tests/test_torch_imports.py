"""The port stands alone: no module of ``pydcop_tpu_torch`` and not
``chip_smoke.py`` imports jax or the JAX package, and its entry points run
on the card unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "pydcop_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "pydcop_tpu"


def test_port_files_found():
    assert "pydcop_tpu_torch/algorithms/maxsum.py" in PORT_FILES
    assert "pydcop_tpu_torch/compile/hopper_kernels.py" in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_reference_package_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_kernel_sources_ship_with_the_package():
    from pydcop_tpu_torch.compile import _build

    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
        # the library name is keyed by the source: stable across calls
        assert _build.library_path(name) == _build.library_path(name)
        assert _build.library_path(name).parent == _build.BUILD_DIR


def _tiny_problem():
    from pydcop_tpu_torch.commands.generators.graphcoloring import (
        generate_coloring_arrays,
    )

    return generate_coloring_arrays(16, 3, graph="grid", seed=1)


def test_solve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from pydcop_tpu_torch.algorithms import maxsum

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        maxsum.solve(_tiny_problem(), {}, n_cycles=3)


def test_to_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from pydcop_tpu_torch.compile.kernels import to_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        to_device(_tiny_problem())
