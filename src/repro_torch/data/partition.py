"""The paper's MNIST partition: each client holds exactly two labels.

Port of ``repro/data/partition.py::partition_label_shard`` (numpy, the
same draws from the same seed): the examples of every class are split
into shards, shards are dealt class-major to a shuffled client order,
and every example lands on exactly one client.
"""
from __future__ import annotations

import numpy as np


def partition_label_shard(x, y, *, n_clients: int,
                          classes_per_client: int = 2, seed: int = 0):
    """Ragged per-client shards restricted to ``classes_per_client`` labels.

    Returns ``(x_shards, y_shards, sizes)``.
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
    shards_x = [x[ci] for ci in client_idx]
    shards_y = [y[ci] for ci in client_idx]
    sizes = np.asarray([len(ci) for ci in client_idx], np.int64)
    if int(sizes.sum()) != len(y):
        raise AssertionError(f"partition dropped {len(y) - sizes.sum()} "
                             f"of {len(y)} examples")
    return shards_x, shards_y, sizes
