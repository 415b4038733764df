"""Federated data glue: ragged shards → rectangular device tensors.

Port of ``repro/data/pipeline.py`` (``stack_trimmed`` and
``federated_arrays`` with the label-shard scheme).  ``stack_trimmed``
keeps a random ``n_min``-subset of every client's shard with the same
numpy draws as the JAX package, so both packages see identical
``(N, n_min, ...)`` client arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .partition import partition_label_shard
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


def federated_arrays(ds: Dataset, *, n_clients: int,
                     scheme: str = "label_shard", classes_per_client: int = 2,
                     seed: int = 0, device=None):
    """(data, test) tensors on ``device``: data = {"x": (N, n_i, ...),
    "y": (N, n_i)}, test = {"x", "y"} — the JAX package's rectangular
    layout (shards trimmed to the smallest client)."""
    device = resolve_device(device)
    if scheme != "label_shard":
        raise NotImplementedError(
            f"scheme={scheme!r}: only 'label_shard' is ported so far")
    shards_x, shards_y, _ = partition_label_shard(
        ds.x_train, ds.y_train, n_clients=n_clients,
        classes_per_client=classes_per_client, seed=seed)
    xs, ys, _ = stack_trimmed(shards_x, shards_y, seed=seed)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ({"x": put(xs), "y": put(ys)},
            {"x": put(ds.x_test), "y": put(ds.y_test)})
