"""Federated data glue: partitioned shards → device tensors.

Port of ``repro/data/pipeline.py``, with the label-shard, Dirichlet and
iid schemes, in its two layouts:

* **pooled (lossless)** — :func:`federated_pooled` keeps every shard
  whole in one pooled ``(Σnᵢ, ...)`` buffer described by a
  :class:`~repro_torch.utils.ragged.RaggedSpec` (pass it to
  ``make_round_fn`` as ``ragged=``); Σnᵢ is the dataset's size;
* **rectangular (trimmed)** — :func:`federated_arrays` stacks equal-size
  ``(N, n_min, ...)`` shards: ``stack_trimmed`` keeps a random
  ``n_min``-subset of every client's shard and drops the rest.

Both make the JAX package's numpy draws, so both packages see identical
client data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.ragged import pool_data

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


def federated_pooled(ds: Dataset, *, n_clients: int,
                     scheme: str = "dirichlet", classes_per_client: int = 2,
                     beta: float = 0.5, seed: int = 0, max_buckets: int = 4,
                     device=None):
    """The lossless pooled layout on ``device`` (CUDA by default).

    Returns ``(data, test, spec, stats)``: data = {"x": (Σnᵢ + pad,
    ...), "y": (Σnᵢ + pad,)}, every training example present once (Σnᵢ =
    len(y_train)); test = {"x", "y"}; spec the
    :class:`~repro_torch.utils.ragged.RaggedSpec` (``make_round_fn(...,
    ragged=spec)``); stats the partition's ``PartitionStats`` (dropped
    0).
    """
    device = resolve_device(device)
    shards_x, shards_y, stats = _partition(
        ds, n_clients=n_clients, scheme=scheme,
        classes_per_client=classes_per_client, beta=beta, seed=seed)
    data, spec = pool_data(shards_x, shards_y, max_buckets=max_buckets,
                           device=device)
    if spec.total != len(ds.y_train) or stats.dropped != 0:
        raise AssertionError(f"pooled {spec.total} of {len(ds.y_train)} "
                             f"examples, {stats.dropped} dropped")
    test = {"x": torch.from_numpy(np.ascontiguousarray(ds.x_test)).to(device),
            "y": torch.from_numpy(np.ascontiguousarray(ds.y_test)).to(device)}
    return data, test, spec, stats
