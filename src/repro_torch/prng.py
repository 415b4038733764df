"""A twin of ``jax.random``'s threefry2x32 key stream, in torch.

The round draws each client's minibatch order from a key chain
(``split(state.rng, 3)`` per round, ``split(data_rng, N)`` per client,
then ``split(key, epochs)`` and ``permutation(k, n_points)`` per epoch).
A round held against the JAX reference needs the very same indices, so
this module reproduces jax 0.9's default key implementation bit for
bit, with ``jax_threefry_partitionable=True`` (the default there):

* a key is two uint32 words; ``PRNGKey(seed)`` is ``[seed >> 32,
  seed & 0xFFFFFFFF]``;
* ``split(key, n)`` hashes the counters ``(0, i)`` for i < n: key i is
  the pair of threefry outputs;
* ``random_bits(key, n)`` hashes the same counters and returns
  ``out1 ^ out2``;
* ``permutation(key, n)`` is ``_shuffle``: ⌈3·ln n / ln(2³²−1)⌉ rounds
  of (``key, sub = split(key)``; stable sort of the values by
  ``random_bits(sub, n)``);
* ``fold_in(key, d)`` hashes the one counter ``(0, d)``, and
  ``randint`` combines two bit streams of ``split(key)`` modulo the
  span, both bit-equal (the stale-tolerant round's ``uniform`` delay
  schedule draws them);
* ``uniform``, ``bernoulli`` and ``normal`` are ``jax.random``'s fp32
  draws from those bits (a shape's bits are those of its flattened
  length).  ``uniform`` and ``bernoulli`` are bit-equal; ``normal`` goes
  through an fp32 twin of XLA's ``erf_inv`` (within 2 ulp of
  ``jax.lax.erf_inv``, bit-equal on most draws) and lands within 3 ulp
  of ``jax.random.normal`` (ROADMAP D5: XLA's CPU ``log1p`` is not
  correctly rounded, and the twin uses torch's).

Words are held in int64 tensors masked to 32 bits, so every operation
is a plain torch integer op and the stream runs on whatever device the
key lives on.  Every function is batched over leading key dimensions:
a key tensor has shape (..., 2).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on broadcastable int64 word tensors.

    Mirrors ``jax._src.prng._threefry2x32_lowering``; returns the two
    output words, each masked to 32 bits.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802
    """(2,) int64 key words of ``jax.random.PRNGKey(seed)`` on
    ``device`` (CUDA unless another is passed)."""
    device = resolve_device(device)
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must be a non-negative int64, got {seed}")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _hash_counters(key: torch.Tensor, n: int):
    """Threefry of the counters (0, i), i < n, under each key (..., 2)."""
    if n >= 2 ** 32:
        raise ValueError(f"at most 2**32 - 1 draws per key, got {n}")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) keys → (..., num, 2) keys."""
    b1, b2 = _hash_counters(key, num)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as (..., n) int64."""
    b1, b2 = _hash_counters(key, n)
    return b1 ^ b2


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: (..., 2) keys → (..., 2) keys.

    jax hashes the seed words of the uint32 ``data``, (0, data), as one
    counter pair, so the new key is the pair of threefry outputs at
    counter ``data``.
    """
    data = int(data) & _MASK
    counter = torch.tensor(data, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(counter), counter)
    return torch.stack([b1, b2], dim=-1)


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``:
    (..., 2) keys → (..., *shape) int32, bit-equal.

    As jax 0.9 does: two uint32 streams from ``split(key)``, high and
    low, combined modulo the span with the multiplier 2³² mod span, so
    the draw spans 64 bits (a span of 1 where maxval ≤ minval).
    Bounds are Python ints within int32.
    """
    lo, hi = int(minval), int(maxval)
    for v in (lo, hi):
        if not -2 ** 31 <= v < 2 ** 31:
            raise ValueError(f"randint bounds must be int32, got {v}")
    shape = tuple(shape)
    n = math.prod(shape)
    keys = split(key)
    higher = random_bits(keys[..., 0, :], n)
    lower = random_bits(keys[..., 1, :], n)
    span = (hi - lo) & _MASK if hi > lo else 1
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    # uint32 arithmetic of jax's: each product and sum wraps mod 2³².
    offset = ((higher % span) * multiplier & _MASK) + lower % span
    offset = (offset & _MASK) % span
    out = (lo + offset).to(torch.int32)
    return out.reshape(*key.shape[:-1], *shape)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: (..., 2) keys → (..., n) int64."""
    num_rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(*key.shape[:-1], n)
    for _ in range(num_rounds):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``:
    (..., 2) keys → (..., *shape) fp32, bit-equal.

    The top 23 bits of each draw fill the mantissa of a float in [1, 2),
    less 1; then scaled to the range by one fused multiply-add (XLA's
    CPU backend contracts ``u·(hi − lo) + lo``: the product is exact in
    float64 and the sum rounds once) and clamped below at ``minval``.
    """
    shape = tuple(shape)
    bits = random_bits(key, math.prod(shape))
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo, hi = float(np.float32(minval)), float(np.float32(maxval))
    width = float(np.float32(hi) - np.float32(lo))
    out = (floats.double() * width + lo).to(torch.float32)
    return torch.clamp(out, min=lo).reshape(*key.shape[:-1], *shape)


def bernoulli(key: torch.Tensor, p: float, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low"): a uniform
    draw below p in fp32 → (..., *shape) bool, bit-equal."""
    return uniform(key, shape) < float(np.float32(p))


# Giles' single-precision erf⁻¹ polynomials, in the order XLA's chlo
# decomposition evaluates them: one for w < 5, one for w ≥ 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """fp32 twin of ``jax.lax.erf_inv`` as XLA lowers it.

    w = −log1p(−x²); p(w − 2.5) on the w < 5 branch, else p(√w − 3);
    erf⁻¹(x) = p·x, and ±1 → ±inf.  Each Horner step is one fused
    multiply-add, as XLA's CPU backend contracts it: the fp32 product is
    exact in float64, and the sum is rounded to fp32 once.
    """
    x = x.to(torch.float32)
    w = -torch.log1p(x * -x)
    small = w < 5.0
    t = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):  # fp32 constants, as XLA's
        return torch.where(small, float(np.float32(_ERFINV_SMALL[i])),
                           float(np.float32(_ERFINV_LARGE[i]))).double()

    p = coef(0).to(torch.float32)
    for i in range(1, len(_ERFINV_SMALL)):
        p = (p.double() * t + coef(i)).to(torch.float32)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: √2·erf⁻¹ of a uniform
    draw over (−1, 1) → (..., *shape) fp32, within 3 ulp of JAX's."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return float(np.float32(math.sqrt(2.0))) * erf_inv(u)
