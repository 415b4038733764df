"""The port's threefry key stream against ``jax.random``, bit for bit.

The round's minibatch orders come from ``split``/``permutation`` chains;
a port round started from the JAX package's state must draw exactly the
same indices, so every check here is bit-equality.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.fedback import _epoch_indices as jax_epoch_indices
from repro_torch import prng
from repro_torch.core.fedback import _epoch_indices

SEEDS = [0, 7, 2024, 2 ** 31 - 1]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_words(seed):
    np.testing.assert_array_equal(np.asarray(_jkey(seed), np.int64),
                                  prng.PRNGKey(seed, device="cpu").numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 100])
def test_split_bit_equal(seed, num):
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(_jkey(seed), num), np.int64),
        prng.split(prng.PRNGKey(seed, device="cpu"), num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [8, 114, 1000, 2000])
def test_permutation_bit_equal(seed, n):
    # n = 2000 takes two shuffle rounds (⌈3·ln n / ln(2³²−1)⌉ = 2).
    np.testing.assert_array_equal(
        np.asarray(jax.random.permutation(_jkey(seed), n)),
        prng.permutation(prng.PRNGKey(seed, device="cpu"), n).numpy())


def test_batched_keys_match_one_by_one():
    jkeys = jax.random.split(_jkey(3), 5)
    got = prng.permutation(torch.from_numpy(np.asarray(jkeys, np.int64)), 50)
    for i in range(5):
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(jkeys[i], 50)), got[i].numpy())


@pytest.mark.parametrize("n_points,batch,epochs", [
    (114, 42, 2),   # the paper-MNIST shard: 2 steps per epoch
    (24, 8, 2),
    (8, 4, 2),
    (5, 8, 1),      # batch clamped to the shard size
])
def test_epoch_indices_equal_jax(n_points, batch, epochs):
    jkeys = jax.random.split(_jkey(11), 6)
    want = np.stack([np.asarray(jax_epoch_indices(k, n_points, batch, epochs))
                     for k in jkeys])
    got = _epoch_indices(torch.from_numpy(np.asarray(jkeys, np.int64)),
                         n_points, batch, epochs)
    np.testing.assert_array_equal(want, got.numpy())
