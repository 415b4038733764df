"""Ragged client shards: a CSR codec over one pooled data buffer.

Port of ``repro/utils/ragged.py`` (the reference's module imports
``jax.numpy``, so the port keeps its own copy).  A client-stacked
``(N, n_i, ...)`` data layout forces equal-size shards, and trimming
every shard to the smallest throws away the per-client imbalance
FedBack's controller responds to.  Here:

* all clients' examples live in **one pooled** ``(Σnᵢ, ...)`` buffer
  (client-contiguous rows), and
* :class:`RaggedSpec` is the static CSR index — per-client ``offsets``
  and ``sizes`` — saying which rows belong to whom.

The spec is a frozen, hashable dataclass of python ints, as
``FlatSpec`` is.  The round never cuts the pool into per-client shards:
the solver gathers each minibatch by row index, so reading the pool at
``offsets[i] + local_idx`` gives the same fp32 values as the
rectangular layout — which is why uniform sizes reproduce the
rectangular rounds bit for bit.

**Size buckets.**  A batched solve needs one step count, and ragged
clients have ragged epoch lengths.  The spec groups clients into at
most ``max_buckets`` size buckets; each bucket runs one batched solve
at the bucket's capacity (padded to it with a masked loss, see
``repro_torch.core.fedback``).  A bucket whose members all match its
capacity needs no mask, so the uniform case runs the plain solve.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RaggedBucket:
    """One batched solve of a ragged round (static)."""

    capacity: int  # padded shard size the bucket's solve runs at
    members: tuple[int, ...]  # client indices, ascending
    padded: bool  # any member smaller than the capacity (needs the mask)


@dataclasses.dataclass(frozen=True)
class RaggedSpec:
    """Static CSR layout of N client shards pooled into (Σnᵢ, ...) rows."""

    sizes: tuple[int, ...]  # n_i per client
    offsets: tuple[int, ...]  # CSR row offsets: offsets[i] = Σ_{j<i} n_j
    buckets: tuple[RaggedBucket, ...]  # size-bucketed solve plan

    @property
    def n_clients(self) -> int:
        return len(self.sizes)

    @property
    def total(self) -> int:
        """Σ nᵢ — the pooled buffer's data rows."""
        return self.offsets[-1] + self.sizes[-1] if self.sizes else 0

    @property
    def max_size(self) -> int:
        return max(self.sizes) if self.sizes else 0

    @property
    def min_size(self) -> int:
        return min(self.sizes) if self.sizes else 0

    @property
    def uniform(self) -> bool:
        """True iff every client holds the same number of rows."""
        return len(set(self.sizes)) <= 1

    @property
    def padding(self) -> int:
        """Zero rows after the last client's slice, so that a block of
        ``max(nᵢ)`` rows starting at any client's offset stays inside
        the buffer.  0 for uniform specs."""
        return self.max_size - self.sizes[-1] if self.sizes else 0

    @property
    def buffer_rows(self) -> int:
        """Leading dim of the pooled buffer: Σnᵢ + padding (no client's
        CSR slice addresses a padding row)."""
        return self.total + self.padding

    def client_slice(self, i: int) -> slice:
        """Client i's rows in the pooled buffer."""
        return slice(self.offsets[i], self.offsets[i] + self.sizes[i])

    def offsets_array(self, device=None) -> torch.Tensor:
        """(N,) int32 row offsets on ``device`` (CUDA by default)."""
        return torch.tensor(self.offsets, dtype=torch.int32,
                            device=resolve_device(device))

    def sizes_array(self, device=None) -> torch.Tensor:
        """(N,) int32 per-client sizes on ``device`` (CUDA by default)."""
        return torch.tensor(self.sizes, dtype=torch.int32,
                            device=resolve_device(device))

    def split(self, pooled) -> list:
        """Pooled (Σnᵢ, ...) array → list of per-client (nᵢ, ...) views."""
        return [np.asarray(pooled)[self.client_slice(i)]
                for i in range(self.n_clients)]

    def permute(self, perm: Sequence[int]) -> "RaggedSpec":
        """Spec for the client order ``perm`` (new client j is old
        ``perm[j]``); re-pool the shards in the same order."""
        return make_ragged_spec([self.sizes[int(p)] for p in perm],
                                max_buckets=max(len(self.buckets), 1))


def _bucket_plan(sizes: Sequence[int],
                 max_buckets: int) -> tuple[RaggedBucket, ...]:
    """Deterministic size-bucket assignment.

    Capacities are the unique shard sizes when few, else the maxima of
    ``max_buckets`` contiguous groups of the sorted unique sizes; each
    client joins the smallest bucket that fits its shard.  Members stay
    in ascending client order, so a uniform spec yields one bucket whose
    members are ``range(N)``.
    """
    uniq = sorted({int(s) for s in sizes})
    if len(uniq) <= max_buckets:
        caps = uniq
    else:
        caps = [int(group[-1])
                for group in np.array_split(np.asarray(uniq), max_buckets)
                if len(group)]
    buckets = []
    for cap in caps:
        members = tuple(i for i, s in enumerate(sizes)
                        if s <= cap and not any(s <= c for c in caps
                                                if c < cap))
        if members:
            buckets.append(RaggedBucket(
                capacity=cap, members=members,
                padded=any(sizes[i] < cap for i in members)))
    return tuple(buckets)


def make_ragged_spec(sizes: Iterable[int], *,
                     max_buckets: int = 4) -> RaggedSpec:
    """Build the static CSR spec for per-client shard sizes ``sizes``."""
    sizes = tuple(int(s) for s in sizes)
    if not sizes:
        raise ValueError("ragged spec needs at least one client")
    if any(s <= 0 for s in sizes):
        raise ValueError(f"client shard sizes must be positive: {sizes}")
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    offsets = tuple(int(o) for o in np.cumsum((0,) + sizes[:-1]))
    return RaggedSpec(sizes=sizes, offsets=offsets,
                      buckets=_bucket_plan(sizes, max_buckets))


def pool_rows(shards: Sequence, *, max_buckets: int = 4):
    """Concatenate per-client (nᵢ, ...) shards into the pooled buffer.

    Returns ``(pooled, spec)`` (a numpy array and its spec) with
    ``pooled.shape[0] == spec.buffer_rows``: every example of every
    shard in client order, none dropped, then ``spec.padding`` zero
    rows.
    """
    shards = [np.asarray(s) for s in shards]
    spec = make_ragged_spec([len(s) for s in shards],
                            max_buckets=max_buckets)
    parts = list(shards)
    if spec.padding:
        parts.append(np.zeros((spec.padding,) + shards[0].shape[1:],
                              shards[0].dtype))
    pooled = np.concatenate(parts, axis=0)
    if pooled.shape[0] != spec.buffer_rows:
        raise AssertionError((pooled.shape, spec.buffer_rows))
    return pooled, spec


def pool_data(xs: Sequence, ys: Sequence, *, max_buckets: int = 4,
              device=None):
    """Pool parallel x/y shard lists into a round's data dict.

    Returns ``(data, spec)``: ``data = {"x": (Σnᵢ + pad, ...), "y":
    (Σnᵢ + pad,)}`` tensors on ``device`` (CUDA by default) sharing one
    spec (x/y shard lengths must agree per client).
    """
    if [len(s) for s in xs] != [len(s) for s in ys]:
        raise ValueError("x and y shard sizes disagree")
    device = resolve_device(device)
    pooled_x, spec = pool_rows(xs, max_buckets=max_buckets)
    pooled_y, _ = pool_rows(ys, max_buckets=max_buckets)
    return {"x": torch.from_numpy(pooled_x).to(device),
            "y": torch.from_numpy(pooled_y).to(device)}, spec
