"""Counter-based threefry2x32 random numbers, bit-exact with ``jax.random``.

The JAX package draws MaxSum's tie-breaking noise with
``jax.random.uniform(jax.random.PRNGKey(seed), (n_vars, D))``
(``pydcop_tpu/algorithms/base.py``, ``_noised``).  This module computes
the same bits with torch ops, so both packages noise the unary plane
identically from one seed.  It follows jax's defaults with
``jax_threefry_partitionable=True`` and 64-bit mode off:

- ``PRNGKey(seed)`` is the pair ``(seed >> 32, seed & 0xFFFFFFFF)`` of a
  32-bit seed, i.e. ``(0, seed mod 2**32)``;
- element ``k`` of a draw of any shape hashes the 64-bit counter ``k``
  (row-major position) split into (high, low) 32-bit words, and its 32
  random bits are the XOR of the two threefry output words;
- a float32 uniform keeps the top 23 bits as the mantissa of a number in
  [1, 2) and subtracts 1.

torch has no full set of uint32 ops, so words live in int64 tensors masked
to 32 bits.  A key is a plain ``(int, int)`` pair passed in explicitly;
there is no global generator state.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

__all__ = ["PRNGKey", "uniform"]

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> Key:
    """The raw threefry key of an integer seed (32-bit, as jax without
    64-bit mode takes it)."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return (0, seed & _MASK)


def _threefry2x32(
    key: Key, x0: torch.Tensor, x1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on int64 tensors holding uint32 words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << rot) | (x1 >> (32 - rot))) & _MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(r + 1) % 3]) & _MASK
        x1 = (x1 + ks[(r + 2) % 3] + r + 1) & _MASK
    return x0, x1


def _random_bits(key: Key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """32 random bits per element (int64 tensor of ``shape``)."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device)
    bits0, bits1 = _threefry2x32(key, counts >> 32, counts & _MASK)
    return (bits0 ^ bits1).reshape(tuple(shape))


def uniform(
    key: Key,
    shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> torch.Tensor:
    """Uniform floats in [0, 1) of ``shape``, equal bit for bit to
    ``jax.random.uniform(key, shape, dtype=float32)``."""
    if dtype != torch.float32:
        raise NotImplementedError("uniform draws float32 only")
    bits = _random_bits(key, shape, device)
    # 23 mantissa bits under the exponent of 1.0 -> a float in [1, 2)
    float_bits = (bits >> 9) | 0x3F800000
    return float_bits.to(torch.int32).view(torch.float32) - 1.0
