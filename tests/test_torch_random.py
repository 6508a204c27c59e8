"""The port's threefry draws equal ``jax.random`` bit for bit (jax with its
default ``jax_threefry_partitionable=True`` and 64-bit mode off), so both
packages noise MaxSum's unary plane identically from one seed, and derive
the same per-cycle keys and local-search draws (``fold_in``, ``split``)."""

import jax
import numpy as np
import pytest
import torch

from pydcop_tpu_torch.random import PRNGKey, fold_in, split, uniform

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


# keys of several seeds and counters: small, large and the engine's own
KEY_SEEDS = [0, 7, 12345, -3, 2**31 - 1]
DATA = [0, 1, 2, 17, 2**31 - 1, 2**32 - 1]


def _jax_key(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_fold_in_matches_jax_bit_for_bit(seed):
    for data in DATA:
        want = tuple(np.asarray(jax.random.fold_in(_jax_key(seed), data))
                     .tolist())
        # host key and int: a host key
        assert fold_in(PRNGKey(seed), data) == want
        # device key: a [2] int64 tensor
        got = fold_in(torch.tensor(PRNGKey(seed)), data)
        assert got.dtype == torch.int64 and tuple(got.tolist()) == want
    # a tensor of counters folds each in at once
    counters = torch.tensor(DATA, dtype=torch.int64)
    got = fold_in(torch.tensor(PRNGKey(seed)), counters)
    want = [
        np.asarray(jax.random.fold_in(_jax_key(seed), d)).tolist()
        for d in DATA
    ]
    assert got.tolist() == want


@pytest.mark.parametrize("num", [1, 2, 4, 5])
@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_split_matches_jax_bit_for_bit(seed, num):
    want = np.asarray(jax.random.split(_jax_key(seed), num)).tolist()
    assert [list(k) for k in split(PRNGKey(seed), num)] == want
    assert split(torch.tensor(PRNGKey(seed)), num).tolist() == want


@pytest.mark.parametrize("seed", [0, 7, 9])
def test_engine_cycle_keys_and_draws_match_jax(seed):
    # cycle c of a solve draws from fold_in(fold_in(PRNGKey(seed), 1), c)
    run_key = jax.random.fold_in(_jax_key(seed), 1)
    cycles = torch.arange(40, dtype=torch.int64)
    got = fold_in(fold_in(torch.tensor(PRNGKey(seed)), 1), cycles)
    for c in (0, 1, 15, 16, 39):
        want = jax.random.fold_in(run_key, c)
        assert got[c].tolist() == np.asarray(want).tolist()
        # and a draw from that device key, as DSA's steps make one
        k_choice = jax.random.split(want)[0]
        ref = np.asarray(jax.random.uniform(k_choice, (33, 3)))
        mine = uniform(split(got[c])[0], (33, 3)).numpy()
        assert np.array_equal(mine.view(np.uint32), ref.view(np.uint32))
