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


def _kernel_name(mangled: str) -> str:
    """``ell_minplus_fixed<3,4>`` for the mangled name of a kernel in a
    namespace (template arguments are ints or bools, a bool as 0 or 1),
    else the input."""
    if not mangled.startswith("_ZN"):
        return mangled
    pos, parts = 3, []
    while (m := re.match(r"\d+", mangled[pos:])) is not None:
        start = pos + m.end()
        pos = start + int(m.group())
        parts.append(mangled[start:pos])
    if not parts:
        return mangled
    args = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[pos:])
    if args is None:
        return parts[-1]
    ints = re.findall(r"L[ib](-?\d+)E", args.group(1))
    return f"{parts[-1]}<{','.join(ints)}>"


def resource_usage(library: Path) -> List[dict]:
    """Each kernel of a library built here, as ``ptxas -v`` reported it:
    ``{"kernel", "registers", "spill_stores", "spill_loads"}`` (bytes)."""
    rows, row = [], None
    for line in _ptxas_log(library).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            row = {"kernel": _kernel_name(m.group(1))}
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
    return rows
