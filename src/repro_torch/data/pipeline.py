"""Federated data glue: ragged shards → rectangular device tensors.

Port of ``repro/data/pipeline.py`` (``stack_trimmed`` and
``federated_arrays`` with the label-shard, Dirichlet and iid schemes).
``stack_trimmed`` keeps a random ``n_min``-subset of every client's
shard with the same numpy draws as the JAX package, so both packages
see identical ``(N, n_min, ...)`` client arrays.  The lossless pooled
(ragged) layout is a later slice of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .partition import _finalize, partition_dirichlet, partition_label_shard
from .synthetic import Dataset


def stack_trimmed(shards_x, shards_y, *, seed: int = 0):
    """Ragged shards → (xs, ys, dropped) trimmed to the smallest shard."""
    rng = np.random.default_rng(seed)
    n_min = min(len(s) for s in shards_y)
    xs, ys, total = [], [], 0
    for sx, sy in zip(shards_x, shards_y, strict=True):
        idx = rng.permutation(len(sy))[:n_min]
        xs.append(np.asarray(sx)[idx])
        ys.append(np.asarray(sy)[idx])
        total += len(sy)
    return np.stack(xs), np.stack(ys), total - n_min * len(shards_y)


def _partition(ds: Dataset, *, n_clients: int, scheme: str,
               classes_per_client: int, beta: float, seed: int):
    """Ragged shards and their stats for any scheme."""
    if scheme == "label_shard":
        return partition_label_shard(
            ds.x_train, ds.y_train, n_clients=n_clients,
            classes_per_client=classes_per_client, seed=seed)
    if scheme == "dirichlet":
        return partition_dirichlet(ds.x_train, ds.y_train,
                                   n_clients=n_clients, beta=beta, seed=seed)
    if scheme == "iid":
        rng = np.random.default_rng(seed)
        client_idx = np.array_split(rng.permutation(len(ds.y_train)),
                                    n_clients)
        return _finalize(ds.x_train, ds.y_train, client_idx,
                         int(ds.y_train.max()) + 1)
    raise ValueError(f"unknown scheme {scheme}")


def federated_arrays(ds: Dataset, *, n_clients: int,
                     scheme: str = "label_shard", classes_per_client: int = 2,
                     beta: float = 0.5, seed: int = 0, device=None):
    """(data, test) tensors on ``device``: data = {"x": (N, n_i, ...),
    "y": (N, n_i)}, test = {"x", "y"} — the JAX package's rectangular
    layout (shards trimmed to the smallest client).  ``scheme``:
    ``label_shard`` (``classes_per_client``), ``dirichlet`` (``beta``)
    or ``iid``."""
    device = resolve_device(device)
    shards_x, shards_y, _ = _partition(
        ds, n_clients=n_clients, scheme=scheme,
        classes_per_client=classes_per_client, beta=beta, seed=seed)
    xs, ys, _ = stack_trimmed(shards_x, shards_y, seed=seed)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ({"x": put(xs), "y": put(ys)},
            {"x": put(ds.x_test), "y": put(ds.y_test)})
