"""Build the package's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which
``compile/hopper_kernels.py`` loads with ctypes.  Libraries land in
``pydcop_tpu_torch/_build/`` under a name keyed by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one is reused.  There is no prebuilt binary: a
fresh checkout builds everything on its first call.  ``build_all`` starts
one ``nvcc`` per source at once.  ``ptxas`` reports each kernel's
registers and spills (``-Xptxas -v``); the report is kept beside the
library (``.ptxas.txt``) and read back by :func:`resource_usage`.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = [
    "CSRC", "BUILD_DIR", "KERNELS", "build_all", "library_path",
    "resource_usage",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: every kernel source of the package, by name (``csrc/<name>.cu``)
KERNELS = (
    "ell_minplus", "factor_arity2_minplus", "xla_tree_sum", "branch_bound",
    "damp_fma",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH): the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    return found


def library_path(
    name: str, csrc: Path = CSRC, build_dir: Path = BUILD_DIR
) -> Path:
    """Where the library of ``<csrc>/<name>.cu`` lands for its current
    source, the headers beside it and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(
    names: Sequence[str] = KERNELS,
    csrc: Path = CSRC,
    build_dir: Path = BUILD_DIR,
) -> Dict[str, Path]:
    """Build every named kernel of ``csrc`` whose library is missing from
    ``build_dir``, one ``nvcc`` process per source, all started together;
    raise if any fails.  Returns the library path of each name."""
    paths = {name: library_path(name, csrc, build_dir) for name in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = _nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            _ptxas_log(todo[name]).write_text(log)
            os.replace(tmp, todo[name])  # atomic: never a half-written .so
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def _ptxas_log(library: Path) -> Path:
    return library.with_name(library.name + ".ptxas.txt")


def _demangler() -> str:
    """binutils' ``c++filt`` (there wherever nvcc's host compiler is),
    else the CUDA toolkit's ``cu++filt`` beside ``nvcc``."""
    found = shutil.which("c++filt")
    if found is not None:
        return found
    tool = Path(_nvcc()).with_name("cu++filt")
    if not tool.is_file():
        raise RuntimeError(f"neither c++filt on PATH nor {tool} found")
    return str(tool)


def _kernel_names(mangled: Sequence[str]) -> List[str]:
    """``ell_minplus_fixed<3,4>`` or ``tree_sum_kernel<FanSite<float>>``
    for each kernel name as ptxas reports it: demangled, without its
    namespaces, return type or parameters, bools as 0 or 1."""
    if not mangled:
        return []
    out = subprocess.run(
        [_demangler(), *mangled], capture_output=True, text=True, check=True,
    ).stdout.splitlines()
    if len(out) != len(mangled):
        raise RuntimeError(f"demangled {len(out)} of {len(mangled)} names")
    return [_short_name(name) for name in out]


def _short_name(name: str) -> str:
    # anonymous namespaces as either demangler prints them, and
    # cu++filt's casts of literals ((int)3, (bool)1)
    name = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", name)
    name = re.sub(r"\(\w[\w ]*\)(?=-?\d)", "", name)
    depth = 0
    for i, ch in enumerate(name):  # the parameters: "(" outside the <>
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    name = name[len("void "):] if name.startswith("void ") else name
    name = re.sub(r"\b\w+::", "", name).replace(", ", ",")
    name = re.sub(r"\btrue\b", "1", re.sub(r"\bfalse\b", "0", name))
    return name.replace(" >", ">").strip()


def _kernel_name(mangled: str) -> str:
    return _kernel_names([mangled])[0]


def resource_usage(library: Path) -> List[dict]:
    """Each kernel of a library built here, as ``ptxas -v`` reported it:
    ``{"kernel", "registers", "spill_stores", "spill_loads"}`` (bytes)."""
    rows, row = [], None
    for line in _ptxas_log(library).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            row = {"kernel": m.group(1)}
            rows.append(row)
            continue
        if row is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            row["spill_stores"], row["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    for row, name in zip(rows, _kernel_names([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows
