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
  ``random_bits(sub, n)``).

Words are held in int64 tensors masked to 32 bits, so every operation
is a plain torch integer op and the stream runs on whatever device the
key lives on.  Every function is batched over leading key dimensions:
a key tensor has shape (..., 2).
"""
from __future__ import annotations

import math

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
