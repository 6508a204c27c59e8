"""Build the package's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which
``compile/hopper_kernels.py`` loads with ctypes.  Libraries land in
``pydcop_tpu_torch/_build/`` under a name keyed by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one is
reused.  There is no prebuilt binary: a fresh checkout builds everything
on its first call.  ``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["CSRC", "BUILD_DIR", "KERNELS", "build_all", "library_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: every kernel source of the package, by name (``csrc/<name>.cu``)
KERNELS = ("ell_minplus", "factor_arity2_minplus")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lands for its current
    source and flags."""
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Build every named kernel whose library is missing, one ``nvcc``
    process per source, all started together; raise if any fails.
    Returns the library path of each name."""
    paths = {name: library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
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
            os.replace(tmp, todo[name])  # atomic: never a half-written .so
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths
