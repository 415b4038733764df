"""The paper's non-i.i.d. client partitions (numpy, the JAX package's
draws from the same seed).

Port of ``repro/data/partition.py``:

* ``partition_label_shard`` — MNIST: each client holds exactly two
  labels; the examples of every class are split into shards, and the
  shards are dealt class-major to a shuffled client order;
* ``partition_dirichlet`` — CIFAR-10: each class is split over the
  clients in Dirichlet(β) proportions, redrawn until every client holds
  at least ``min_points`` examples.

Both return ragged per-client shards and a :class:`PartitionStats`;
every example lands on exactly one client.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PartitionStats(NamedTuple):
    sizes: np.ndarray  # (N,) int64 — per-client shard sizes nᵢ
    label_histogram: np.ndarray  # (N, C) int64 — per-client label counts
    dropped: int  # examples lost by the partition itself (always 0)

    @property
    def total(self) -> int:
        return int(self.sizes.sum())


def label_histogram(y_shards, num_classes: int) -> np.ndarray:
    """(N, C) label counts of ragged shards or a stacked (N, nᵢ) array."""
    return np.stack([
        np.bincount(np.asarray(ys).ravel(), minlength=num_classes)
        for ys in y_shards
    ])


def _finalize(x, y, client_idx, num_classes: int):
    """Ragged shards and their stats; raises if an example was lost."""
    shards_x = [x[np.asarray(ci, dtype=np.intp)] for ci in client_idx]
    shards_y = [y[np.asarray(ci, dtype=np.intp)] for ci in client_idx]
    sizes = np.asarray([len(ci) for ci in client_idx], np.int64)
    stats = PartitionStats(
        sizes=sizes,
        label_histogram=label_histogram(shards_y, num_classes),
        dropped=len(y) - int(sizes.sum()))
    if stats.dropped != 0:
        raise AssertionError(f"partition dropped {stats.dropped} of "
                             f"{len(y)} examples")
    return shards_x, shards_y, stats


def partition_label_shard(x, y, *, n_clients: int,
                          classes_per_client: int = 2, seed: int = 0):
    """Ragged per-client shards restricted to ``classes_per_client`` labels.

    Returns ``(x_shards, y_shards, stats)``.
    """
    rng = np.random.default_rng(seed)
    num_classes = int(y.max()) + 1
    if classes_per_client > num_classes:
        raise ValueError(f"classes_per_client={classes_per_client} exceeds "
                         f"the {num_classes} classes present")
    total_shards = n_clients * classes_per_client
    if total_shards < num_classes:
        raise ValueError(
            f"{total_shards} shards cannot cover {num_classes} classes "
            "without dropping data; raise n_clients or classes_per_client")
    base, extra = divmod(total_shards, num_classes)
    shard_pool = []
    for c in range(num_classes):
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        shard_pool.extend(np.array_split(idx, base + (1 if c < extra else 0)))
    order = rng.permutation(n_clients)
    client_idx = [
        np.concatenate([shard_pool[i + k * n_clients]
                        for k in range(classes_per_client)])
        for i in order
    ]
    return _finalize(x, y, client_idx, num_classes)


def partition_dirichlet(x, y, *, n_clients: int, beta: float = 0.5,
                        seed: int = 0, min_points: int = 8):
    """Dirichlet(β) label-proportion split (Li et al. 2021).

    Returns ``(x_shards, y_shards, stats)``; redraws until every client
    holds at least ``min_points`` examples.
    """
    rng = np.random.default_rng(seed)
    num_classes = int(y.max()) + 1
    while True:
        client_idx = [[] for _ in range(n_clients)]
        for c in range(num_classes):
            idx = np.flatnonzero(y == c)
            rng.shuffle(idx)
            p = rng.dirichlet(np.full(n_clients, beta))
            cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx, cuts)):
                client_idx[i].extend(part.tolist())
        if min(len(ci) for ci in client_idx) >= min_points:
            break
    return _finalize(x, y, client_idx, num_classes)
