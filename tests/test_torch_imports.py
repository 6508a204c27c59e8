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
    return top in ("jax", "jaxlib", "pydcop_tpu", "bench_all")


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
    "pydcop_tpu_torch/infrastructure/ui.py",
    "pydcop_tpu_torch/telemetry/prom.py",
    "pydcop_tpu_torch/telemetry/slo.py",
    "pydcop_tpu_torch/telemetry/summary.py",
    "pydcop_tpu_torch/telemetry/stitch.py",
    "pydcop_tpu_torch/commands/watch.py",
    "pydcop_tpu_torch/commands/telemetry.py",
    "pydcop_tpu_torch/infrastructure/retry.py",
    "pydcop_tpu_torch/telemetry/federate.py",
    "pydcop_tpu_torch/serve/router.py",
    "pydcop_tpu_torch/partition/multilevel.py",
    "pydcop_tpu_torch/distribution/_costs.py",
    "pydcop_tpu_torch/distribution/tpu_part.py",
    "pydcop_tpu_torch/commands/fleet.py",
    "pydcop_tpu_torch/commands/router.py",
    "pydcop_tpu_torch/telemetry/profiling.py",
    "pydcop_tpu_torch/telemetry/kernelprof.py",
    "pydcop_tpu_torch/telemetry/perfdiff.py",
    "pydcop_tpu_torch/commands/capture.py",
    "pydcop_tpu_torch/tools/capture_configs.py",
    "pydcop_tpu_torch/parallel/placement.py",
    "pydcop_tpu_torch/partition/icimodel.py",
    "pydcop_tpu_torch/infrastructure/orchestrator.py",
    "pydcop_tpu_torch/infrastructure/agents.py",
    "pydcop_tpu_torch/infrastructure/run.py",
    "pydcop_tpu_torch/computations_graph/pseudotree.py",
    "pydcop_tpu_torch/distribution/adhoc.py",
    "pydcop_tpu_torch/telemetry/bridge.py",
    "pydcop_tpu_torch/commands/agent.py",
    "pydcop_tpu_torch/commands/orchestrator.py",
    "pydcop_tpu_torch/commands/run.py",
    "pydcop_tpu_torch/replication/__init__.py",
    "pydcop_tpu_torch/replication/path_utils.py",
    "pydcop_tpu_torch/replication/objects.py",
    "pydcop_tpu_torch/replication/yamlformat.py",
    "pydcop_tpu_torch/resilience/__init__.py",
    "pydcop_tpu_torch/resilience/messages.py",
    "pydcop_tpu_torch/resilience/negotiation.py",
    "pydcop_tpu_torch/reparation/__init__.py",
    "pydcop_tpu_torch/reparation/removal.py",
    "pydcop_tpu_torch/utils/solve_control.py",
    "pydcop_tpu_torch/tools/ab_solo.py",
])
def test_subpackages_are_scanned(path):
    assert path in PORT_FILES


@pytest.mark.parametrize("module", [
    "pydcop_tpu_torch.telemetry.memplane",
    "pydcop_tpu_torch.commands.memplan",
    "pydcop_tpu_torch.telemetry.prom",
    "pydcop_tpu_torch.telemetry.slo",
    "pydcop_tpu_torch.telemetry.summary",
    "pydcop_tpu_torch.telemetry.stitch",
    "pydcop_tpu_torch.infrastructure.ui",
    "pydcop_tpu_torch.infrastructure",
    "pydcop_tpu_torch.commands.watch",
    "pydcop_tpu_torch.commands.telemetry",
    "pydcop_tpu_torch.infrastructure.retry",
    "pydcop_tpu_torch.telemetry.federate",
    "pydcop_tpu_torch.serve.router",
    "pydcop_tpu_torch.serve",
    "pydcop_tpu_torch.commands.fleet",
    "pydcop_tpu_torch.commands.router",
    "pydcop_tpu_torch.telemetry",
    "pydcop_tpu_torch.telemetry.profiling",
    "pydcop_tpu_torch.telemetry.kernelprof",
    "pydcop_tpu_torch.telemetry.perfdiff",
    "pydcop_tpu_torch.commands.capture",
    "pydcop_tpu_torch.tools.capture_configs",
    "pydcop_tpu_torch.infrastructure.events",
    "pydcop_tpu_torch.infrastructure.stats",
    "pydcop_tpu_torch.infrastructure.computations",
    "pydcop_tpu_torch.infrastructure.communication",
    "pydcop_tpu_torch.infrastructure.discovery",
    "pydcop_tpu_torch.infrastructure.agents",
    "pydcop_tpu_torch.telemetry.bridge",
    "pydcop_tpu_torch.commands.agent",
    "pydcop_tpu_torch.replication",
    "pydcop_tpu_torch.replication.path_utils",
    "pydcop_tpu_torch.replication.objects",
    "pydcop_tpu_torch.replication.yamlformat",
    "pydcop_tpu_torch.utils.solve_control",
    "pydcop_tpu_torch.tools.ab_solo",
])
def test_host_only_modules_import_no_torch(module):
    # the host-only verbs (memplan, telemetry, watch, fleet, router) and
    # the live surface run without a card, beside a solve: importing them
    # pulls in neither torch nor numpy
    assert _imported(module) == []


def _imported(module):
    import json
    import subprocess
    import sys

    code = (f"import json, sys, {module}; print(json.dumps(sorted("
            "{'torch', 'numpy', 'jax'} & set(sys.modules))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout)


@pytest.mark.parametrize("module", [
    "pydcop_tpu_torch.partition",
    "pydcop_tpu_torch.partition.icimodel",
    "pydcop_tpu_torch.parallel.placement",
    "pydcop_tpu_torch.distribution.tpu_part",
    "pydcop_tpu_torch.distribution._costs",
])
def test_placement_modules_import_numpy_but_no_torch(module):
    # the router places its buckets through tpu_part: numpy, no torch
    assert _imported(module) == ["numpy"]


@pytest.mark.parametrize("module", [
    "pydcop_tpu_torch.infrastructure.orchestratedagents",
    "pydcop_tpu_torch.infrastructure.orchestrator",
    "pydcop_tpu_torch.infrastructure.run",
    "pydcop_tpu_torch.commands.orchestrator",
    "pydcop_tpu_torch.computations_graph.constraints_hypergraph",
    "pydcop_tpu_torch.computations_graph.ordered_graph",
    "pydcop_tpu_torch.computations_graph.pseudotree",
    "pydcop_tpu_torch.distribution.adhoc",
    "pydcop_tpu_torch.resilience",
    "pydcop_tpu_torch.resilience.messages",
    "pydcop_tpu_torch.resilience.negotiation",
    "pydcop_tpu_torch.reparation",
    "pydcop_tpu_torch.reparation.removal",
    "pydcop_tpu_torch.commands.run",
])
def test_runtime_modules_import_no_torch(module):
    # an agent process imports the runtime (run, orchestratedagents and
    # through it the orchestrator's message taxonomy) and the graph
    # modules its deploys name, and the replica negotiation and repair
    # model it hosts: numpy for the DCOP model, never torch
    assert "torch" not in _imported(module)


def test_agent_verb_imports_no_torch():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "pydcop_tpu_torch",
         "agent", "--help"],
        cwd=ROOT, capture_output=True, text=True, check=True,
    )
    assert "usage:" in out.stdout
    assert _imported_names(out.stderr) >= {
        "pydcop_tpu_torch.commands.agent"}
    assert not {"torch", "jax"} & _imported_names(out.stderr)


def _imported_names(importtime_stderr):
    return {line.rsplit("|", 1)[-1].strip()
            for line in importtime_stderr.splitlines()
            if line.startswith("import time:")}


def test_agent_process_import_tree_has_no_torch(tmp_path):
    # an agent process as process mode spawns it (run._run_process_agent
    # in a fresh interpreter) joins an orchestrator over HTTP, takes its
    # deploys (ComputationDefs of maxsum's factor graph), the
    # run, the value read-backs and the stop: its import tree, the whole
    # run long, holds no torch (the orchestrator, in this process, solves
    # on the CPU)
    import subprocess
    import sys

    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file
    from pydcop_tpu_torch.infrastructure.communication import (
        HttpCommunicationLayer,
    )
    from pydcop_tpu_torch.infrastructure.orchestrator import Orchestrator
    from pydcop_tpu_torch.infrastructure.run import _build
    from pydcop_tpu_torch.utils.simple_repr import simple_repr

    dcop = load_dcop_from_file(
        str(ROOT / "tests" / "instances" / "graph_coloring.yaml"))
    algo, cg, dist = _build(dcop, "maxsum", "adhoc")
    orchestrator = Orchestrator(
        algo, cg, list(dcop.agents.values()), dcop, distribution=dist,
        comm=HttpCommunicationLayer(("127.0.0.1", 0)), n_cycles=10,
        device="cpu",
    )
    orchestrator.start()
    names = list(dcop.agents)
    code = (
        "import json, sys; "
        "from pydcop_tpu_torch.infrastructure.run import "
        "_run_process_agent; "
        f"_run_process_agent({names!r}, {[0] * len(names)!r}, "
        f"'127.0.0.1', {orchestrator.address[1]}, "
        f"json.loads(sys.argv[1]))"
    )
    with open(tmp_path / "agent.err", "w") as err:
        agent = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-c", code,
             json_dumps([simple_repr(dcop.agents[n]) for n in names])],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err,
        )
    try:
        orchestrator.deploy_computations(timeout=120)
        orchestrator.run(timeout=120)
        assert orchestrator.status == "FINISHED"
        orchestrator.stop_agents(timeout=30)
        assert agent.wait(60) == 0
    finally:
        orchestrator.stop()
        if agent.poll() is None:
            agent.kill()
            agent.wait()
    imported = _imported_names((tmp_path / "agent.err").read_text())
    assert {"pydcop_tpu_torch.computations_graph.objects",
            "pydcop_tpu_torch.infrastructure.orchestratedagents"} <= imported
    assert not {"torch", "jax"} & imported


def json_dumps(obj):
    import json

    return json.dumps(obj)


def test_the_new_modules_name_no_jax_module():
    # the profiling layer, the capture verb and its configs' records, the
    # placement and ICI model: none imports jax, the JAX package or the
    # JAX package's bench_all.py
    for path in ("pydcop_tpu_torch/telemetry/profiling.py",
                 "pydcop_tpu_torch/telemetry/kernelprof.py",
                 "pydcop_tpu_torch/telemetry/perfdiff.py",
                 "pydcop_tpu_torch/commands/capture.py",
                 "pydcop_tpu_torch/tools/capture_configs.py",
                 "pydcop_tpu_torch/parallel/placement.py",
                 "pydcop_tpu_torch/partition/icimodel.py",
                 "pydcop_tpu_torch/partition/multilevel.py"):
        tree = ast.parse((ROOT / path).read_text(), filename=path)
        assert not [m for m in _imported_modules(tree) if _forbidden(m)]
    assert _forbidden("bench_all") and _forbidden("pydcop_tpu.telemetry")


def test_capture_diff_runs_without_torch(tmp_path):
    # `capture diff` is host only: the CLI imports no torch for it
    import json
    import subprocess
    import sys

    bundle = tmp_path / "b"
    (bundle / "records").mkdir(parents=True)
    (bundle / "manifest.json").write_text(json.dumps(
        {"format": "pydcop_tpu.capture/1", "configs": {}, "warnings": []}))
    code = ("import json, sys; from pydcop_tpu_torch.dcop_cli import main; "
            f"rc = main(['capture', 'diff', {str(bundle)!r}, "
            f"{str(bundle)!r}]); "
            "print(json.dumps([rc, 'torch' in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, False]


def test_router_spawns_workers_with_its_own_device(monkeypatch):
    # router --spawn starts `python -m pydcop_tpu_torch --device D serve`
    # with D the router's own --device; without a card and without
    # --device cpu the worker exits before it announces
    import io
    import subprocess
    import types

    from pydcop_tpu_torch.commands import router

    started = []

    class Proc:
        # a worker that exits at once, silent
        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.stdout = io.StringIO("")

        def poll(self):
            return 2

        def kill(self):
            pass

    monkeypatch.setattr(subprocess, "Popen", Proc)
    for device in ("cuda", "cpu"):
        args = types.SimpleNamespace(
            spawn=1, host="127.0.0.1", window_ms=25.0, worker_slo=[],
            device=device)
        with pytest.raises(RuntimeError, match="never announced"):
            router._spawn_workers(args, "/nonexistent-state")
        cmd = started[-1]
        assert cmd[1:5] == ["-m", "pydcop_tpu_torch", "--device", device]
        assert cmd[5] == "serve"


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
