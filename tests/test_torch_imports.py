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


@pytest.mark.parametrize("path", [
    "pydcop_tpu_torch/chaos/schedule.py",
    "pydcop_tpu_torch/chaos/controller.py",
    "pydcop_tpu_torch/computations_graph/objects.py",
    "pydcop_tpu_torch/computations_graph/factor_graph.py",
    "pydcop_tpu_torch/commands/generate.py",
    "pydcop_tpu_torch/telemetry/memplane.py",
    "pydcop_tpu_torch/commands/memplan.py",
])
def test_subpackages_are_scanned(path):
    assert path in PORT_FILES


@pytest.mark.parametrize("module", [
    "pydcop_tpu_torch.telemetry.memplane",
    "pydcop_tpu_torch.commands.memplan",
])
def test_host_only_modules_import_no_torch(module):
    # the memplan verb plans without a card: importing it pulls in
    # neither torch nor numpy
    import subprocess
    import sys

    code = (f"import sys, {module}; "
            "print(sorted({'torch', 'numpy', 'jax'} & set(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_reference_package_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES)
def test_each_top_level_name_defined_once(path):
    # a second def of a name silently replaces the first for every caller
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))]
    twice = sorted({n for n in names if names.count(n) > 1})
    assert not twice, f"{path} defines {twice} more than once"


def test_kernel_sources_ship_with_the_package():
    from pydcop_tpu_torch.compile import _build

    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
        # the library name is keyed by the source: stable across calls
        assert _build.library_path(name) == _build.library_path(name)
        assert _build.library_path(name).parent == _build.BUILD_DIR


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_117ell_minplus_fixedILi3ELi4EEEvPKfS2_",
     "ell_minplus_fixed<3,4>"),
    # int and bool template arguments, as branch_bound_kernel<K, shared>
    ("_ZN48_GLOBAL__N__7c2c6a17_15_branch_bound_cu_9972bb3219branch_bound"
     "_kernelILi7ELb1EEEvNS_8OperandsE", "branch_bound_kernel<7,1>"),
    ("damp_fma_kernel", "damp_fma_kernel"),
    # class template arguments, as tree_sum_kernel<Site>
    ("_ZN12_GLOBAL__N_115tree_sum_kernelINS_7FanSiteIfEEEEvT_",
     "tree_sum_kernel<FanSite<float>>"),
    ("_ZN12_GLOBAL__N_115tree_sum_kernelINS_7FanSiteI13__nv_bfloat16EEEE"
     "vT_", "tree_sum_kernel<FanSite<__nv_bfloat16>>"),
    ("_ZN12_GLOBAL__N_115tree_sum_kernelINS_8RowsSiteEEEvT_",
     "tree_sum_kernel<RowsSite>"),
    ("_ZN12_GLOBAL__N_117short_rows_kernelILi3EEEvPKfPfillll",
     "short_rows_kernel<3>"),
])
def test_ptxas_report_names_each_instantiation(mangled, name):
    from pydcop_tpu_torch.compile import _build

    assert _build._kernel_name(mangled) == name


@pytest.mark.parametrize("demangled, name", [
    # binutils' c++filt
    ("void (anonymous namespace)::tree_sum_kernel<(anonymous namespace)::"
     "FanSite<__nv_bfloat16> >((anonymous namespace)::FanSite<"
     "__nv_bfloat16>)", "tree_sum_kernel<FanSite<__nv_bfloat16>>"),
    ("void (anonymous namespace)::branch_bound_kernel<7, true>((anonymous "
     "namespace)::Operands)", "branch_bound_kernel<7,1>"),
    # the CUDA toolkit's cu++filt: <unnamed> namespaces, cast literals
    ("void <unnamed>::short_rows_kernel<(int)3>(const float *, float *, "
     "int, long, long, long, long)", "short_rows_kernel<3>"),
    ("void <unnamed>::branch_bound_kernel<(int)7, (bool)1>(<unnamed>::"
     "Operands)", "branch_bound_kernel<7,1>"),
    ("<unnamed>::tree_sum_kernel<<unnamed>::FanSite<float>>(<unnamed>::"
     "FanSite<float>)", "tree_sum_kernel<FanSite<float>>"),
])
def test_either_demangler_gives_the_same_kernel_name(demangled, name):
    from pydcop_tpu_torch.compile import _build

    assert _build._short_name(demangled) == name


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


@pytest.mark.parametrize(
    "algo", ["adsa", "dsatuto", "amaxsum", "maxsum_dynamic", "syncbb", "ncbb"]
)
def test_every_solver_defaults_to_cuda_and_raises_without_it(
    algo, monkeypatch
):
    from pydcop_tpu_torch.algorithms import load_algorithm_module

    mod = load_algorithm_module(algo)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.solve(_tiny_problem(), {}, n_cycles=3)


def test_dynamic_session_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from pydcop_tpu_torch.algorithms.maxsum_dynamic import DynamicMaxSum
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

    dcop = load_dcop_from_file(
        str(ROOT / "tests" / "instances" / "graph_coloring.yaml")
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DynamicMaxSum(dcop)
