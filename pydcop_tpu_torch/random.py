"""Counter-based threefry2x32 random numbers, bit-exact with ``jax.random``.

The JAX package draws MaxSum's tie-breaking noise with
``jax.random.uniform(jax.random.PRNGKey(seed), (n_vars, D))``
(``pydcop_tpu/algorithms/base.py``, ``_noised``), derives one key per
cycle with ``fold_in`` and splits it inside the local-search steps.  This
module computes the same bits with torch ops, so both packages draw
identically from one seed.  It follows jax's defaults with
``jax_threefry_partitionable=True`` and 64-bit mode off:

- ``PRNGKey(seed)`` is the pair ``(seed >> 32, seed & 0xFFFFFFFF)`` of a
  32-bit seed, i.e. ``(0, seed mod 2**32)``;
- element ``k`` of a draw of any shape hashes the 64-bit counter ``k``
  (row-major position) split into (high, low) 32-bit words, and its 32
  random bits are the XOR of the two threefry output words;
- ``fold_in(key, i)`` is the hash of the counter ``(0, i)``, both output
  words kept; ``split(key, n)[i]`` is the same key as ``fold_in(key, i)``;
- a float32 uniform keeps the top 23 bits as the mantissa of a number in
  [1, 2) and subtracts 1.

torch has no full set of uint32 ops, so words live in int64 tensors masked
to 32 bits.  A key is either a plain ``(int, int)`` pair (host callers) or
an int64 tensor of shape ``[2]`` on the device the draw runs on, so a key
derived inside a captured CUDA graph never needs a host value.  There is
no global generator state.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

__all__ = ["PRNGKey", "fold_in", "split", "uniform"]

Key = Union[Tuple[int, int], torch.Tensor]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> Tuple[int, int]:
    """The raw threefry key of an integer seed (32-bit, as jax without
    64-bit mode takes it)."""
    seed = int(seed)
    if not -(2 ** 31) <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return (0, seed & _MASK)


def _words(key: Key):
    """The two 32-bit words of a key: ints, or 0-d int64 tensors."""
    if isinstance(key, torch.Tensor):
        return key[0], key[1]
    return key


def _threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 words held in int64 tensors
    or Python ints (any mix; tensors broadcast).

    The low 32 bits of a sum or an XOR depend only on the low 32 bits of
    its operands, so ``x0`` is masked once at the end (it stays below
    2**38 in int64); ``x1`` is masked before each rotation, which reads
    its high bits.  Each elementwise op is a kernel on the card: this
    keeps them to 28 a round."""
    k0, k1 = _words(key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _MASK
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x0 = x0 + x1
            x1 = (x0 ^ ((x1 << rot) | (x1 >> (32 - rot)))) & _MASK
        x0 = x0 + ks[(r + 1) % 3]
        x1 = (x1 + ks[(r + 2) % 3] + r + 1) & _MASK
    return x0 & _MASK, x1


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``.  A host key and an int give a
    host key; otherwise ``data`` may be an int64 tensor of counters (the
    engine folds a chunk's cycle indices in at once) and the result is a
    ``data.shape + [2]`` int64 tensor."""
    if not isinstance(key, torch.Tensor) and not isinstance(
        data, torch.Tensor
    ):
        return _threefry2x32(key, 0, int(data) & _MASK)
    if isinstance(data, torch.Tensor):
        data = data & _MASK
    else:
        data = int(data) & _MASK
    out0, out1 = _threefry2x32(key, 0, data)
    return torch.stack(torch.broadcast_tensors(out0, out1), dim=-1)


def split(key: Key, num: int = 2):
    """``jax.random.split(key, num)``: a tuple of ``num`` host keys for a
    host key, an ``[num, 2]`` int64 tensor for a tensor key."""
    if not isinstance(key, torch.Tensor):
        return tuple(fold_in(key, i) for i in range(num))
    return fold_in(key, torch.arange(num, device=key.device))


def _random_bits(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """32 random bits per element (int64 tensor of ``shape``)."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device)
    high = counts >> 32 if n > _MASK else 0
    bits0, bits1 = _threefry2x32(key, high, counts & _MASK)
    return (bits0 ^ bits1).reshape(tuple(shape))


def uniform(
    key: Key,
    shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Uniform floats in [0, 1) of ``shape``, equal bit for bit to
    ``jax.random.uniform(key, shape, dtype=float32)``.  The draw runs on
    ``device``, by default the key's device (the CPU for a host key)."""
    if dtype != torch.float32:
        raise NotImplementedError("uniform draws float32 only")
    if device is None:
        device = key.device if isinstance(key, torch.Tensor) else "cpu"
    bits = _random_bits(key, shape, device)
    # jax puts the top 23 bits under the exponent of 1.0 (a float in
    # [1, 2)) and subtracts 1: exactly m * 2**-23 for the 23-bit m, which
    # a float32 holds exactly (and which needs no bit view, which
    # torch.func.vmap cannot map)
    return (bits >> 9).to(torch.float32) * 2.0 ** -23
