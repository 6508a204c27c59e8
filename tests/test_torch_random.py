"""The port's threefry draws equal ``jax.random`` bit for bit (jax with its
default ``jax_threefry_partitionable=True`` and 64-bit mode off), so both
packages noise MaxSum's unary plane identically from one seed."""

import jax
import numpy as np
import pytest

from pydcop_tpu_torch.random import PRNGKey, uniform

SEEDS = [0, 7, 2**31 - 1]
# (100_000, 3) is the config-4 noise draw (n_vars, D)
SHAPES = [(100_000, 3), (150, 3), (7, 5)]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert PRNGKey(seed) == tuple(
        np.asarray(jax.random.PRNGKey(seed)).tolist()
    )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_match_jax(seed, shape):
    ref = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype=np.float32)
    )
    got = uniform(PRNGKey(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    # bitwise: compare the raw words, not the float values
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_uniform_range():
    u = uniform(PRNGKey(3), (1000, 4))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_seed_outside_32_bits_raises():
    with pytest.raises(OverflowError):
        PRNGKey(2**31)
