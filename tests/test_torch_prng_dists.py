"""The port's fp32 draws against ``jax.random``: uniform and bernoulli
bit for bit, erf⁻¹ and normal within the twin's stated ulp bound.

``prng.erf_inv`` reproduces XLA's lowering of ``erf_inv`` (Giles'
polynomials, branch at w = 5, each Horner step one fused multiply-add)
but takes torch's ``log1p``, which XLA's CPU backend does not round the
same way, so the two stay within 2 ulp of each other, and ``normal``
(√2 times it) within 3 (ROADMAP D5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = [0, 7, 2024, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (1000,), (3, 5), (33, 17)]
ERFINV_ULPS = 2
NORMAL_ULPS = 3


def ulps(a, b):
    """|a − b| in units in the last place of fp32 (finite values)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (2.5, 7.1)])
def test_uniform_bit_equal(seed, shape, lo, hi):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
    got = prng.uniform(tk, shape, lo, hi).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [0.1, 0.25, 0.5, 0.9])
def test_bernoulli_bit_equal(seed, shape, p):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(
        prng.bernoulli(tk, p, shape).numpy(),
        np.asarray(jax.random.bernoulli(jk, p, shape)))


def test_batched_keys_draw_as_one_by_one():
    jkeys = jax.random.split(jax.random.PRNGKey(5), 4)
    tkeys = torch.from_numpy(np.asarray(jkeys, np.int64))
    got = prng.uniform(tkeys, (3, 2)).numpy()
    for i in range(4):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.uniform(jkeys[i], (3, 2))))


def test_erf_inv_within_its_bound():
    """1e5+ draws over (−1, 1), the ends ±(1 − ulp), 0, ±1 and the
    points where w = −log1p(−x²) crosses the branch at 5."""
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (200_000,),
                                      minval=-1.0, maxval=1.0))
    edge = np.nextafter(np.float32(1), np.float32(0))
    branch = np.float32(np.sqrt(-np.expm1(-5.0)))  # w(x) = 5
    special = np.float32([0.0, 1.0, -1.0, edge, -edge, branch, -branch,
                          np.nextafter(branch, np.float32(0)),
                          np.nextafter(branch, np.float32(1)),
                          1e-30, -1e-30])
    x = np.concatenate([x, special]).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite])  # ±1 → ±inf
    assert (~finite).sum() == 2
    d = ulps(got[finite], want[finite])
    assert d.max() <= ERFINV_ULPS, d.max()
    assert np.mean(d == 0) > 0.98  # bit-equal but for XLA's log1p


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shape", [(1,), (7,), (100_000,), (300, 41)])
def test_normal_within_its_bound(seed, shape):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.normal(jk, shape))
    got = prng.normal(tk, shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert ulps(got, want).max() <= NORMAL_ULPS
