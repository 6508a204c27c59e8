"""Hand-written Hopper kernels, their plain PyTorch versions and launch counts.

Each kernel here replaces one Pallas TPU kernel of the JAX package
(``pydcop_tpu/compile/pallas_kernels.py``).  Its wrapper runs the plain
PyTorch version for tensors on the CPU, launches the CUDA kernel for
tensors on a card, and raises for anything else; there is no fallback from
a failed build or launch to the plain version.  Each wrapper counts its
launches in a ``launches`` attribute, so a run can show that its path went
through the kernel.

``ell_minplus`` (``csrc/ell_minplus.cu``) replaces ``ell_minplus`` at
``pallas_kernels.py:167`` (body ``_ell_kernel``, ``:148``): MaxSum's ELL
factor half-cycle.  It is bound by bytes (65 B per slot at D=3 for 15
adds and mins).  It folds the pair gather, which the TPU path left to XLA
outside its kernel, into the kernel, so the partner plane is never
written and read back.  See the source for the rest of its design.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["ell_minplus", "ell_minplus_plain"]


@functools.lru_cache(maxsize=None)
def _c_function(name: str, argtypes: tuple):
    """``<name>_launch`` of ``csrc/<name>.cu``, built at first use and
    loaded with ctypes; every launch function returns cudaGetLastError()."""
    lib = ctypes.CDLL(str(_build.build_all((name,))[name]))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


# v2f_t, pair_perm, tabs_t, real_row, out, d, n_pad, stream
_ELL_MINPLUS_ARGS = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
)


def ell_minplus_plain(
    v2f_t: torch.Tensor,  # [D, n_pad] f32 variable->factor plane
    pair_perm: torch.Tensor,  # [n_pad] int32 ELL slot of the partner edge
    tabs_t: torch.Tensor,  # [D, D, n_pad] f32 tab[own, partner, slot]
    real_row: torch.Tensor,  # [1, n_pad] bool, False on padding slots
) -> torch.Tensor:
    """``f2v[i, e] = min_j(tabs_t[i, j, e] + v2f_t[j, pair_perm[e]])``,
    exact 0 on padding slots: the same ops as the JAX package's jnp ELL
    factor step."""
    f2v = torch.amin(tabs_t + v2f_t[:, pair_perm][None], dim=1)
    return torch.where(real_row, f2v, f2v.new_zeros(()))


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def ell_minplus(
    v2f_t: torch.Tensor,
    pair_perm: torch.Tensor,
    tabs_t: torch.Tensor,
    real_row: torch.Tensor,
) -> torch.Tensor:
    """The ELL factor half-cycle: pair gather + table add + min over the
    partner's value + pad mask.  On CPU tensors this is
    :func:`ell_minplus_plain`; on CUDA tensors it launches
    ``csrc/ell_minplus.cu`` (float32 only) on the current stream."""
    tensors = (v2f_t, pair_perm, tabs_t, real_row)
    if all(t.device.type == "cpu" for t in tensors):
        return ell_minplus_plain(v2f_t, pair_perm, tabs_t, real_row)
    device = v2f_t.device
    if device.type != "cuda":
        raise ValueError(f"ell_minplus runs on cpu or cuda, not {device}")
    d, n_pad = v2f_t.shape
    _check(v2f_t, "v2f_t", torch.float32, (d, n_pad), device)
    _check(pair_perm, "pair_perm", torch.int32, (n_pad,), device)
    _check(tabs_t, "tabs_t", torch.float32, (d, d, n_pad), device)
    _check(real_row, "real_row", torch.bool, (1, n_pad), device)
    out = torch.empty_like(v2f_t)
    fn = _c_function("ell_minplus", _ELL_MINPLUS_ARGS)
    with torch.cuda.device(device):
        rc = fn(
            v2f_t.data_ptr(), pair_perm.data_ptr(), tabs_t.data_ptr(),
            real_row.data_ptr(), out.data_ptr(), d, n_pad,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"ell_minplus launch failed: CUDA error {rc}")
    ell_minplus.launches += 1
    return out


ell_minplus.launches = 0
