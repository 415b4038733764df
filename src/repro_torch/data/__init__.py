"""Data makers of the port (numpy draws identical to the JAX package)."""
from .partition import (  # noqa: F401
    PartitionStats,
    label_histogram,
    partition_dirichlet,
    partition_label_shard,
)
from .pipeline import federated_arrays, federated_pooled, \
    stack_trimmed  # noqa: F401
from .synthetic import (  # noqa: F401
    Dataset,
    make_least_squares,
    make_synthetic_cifar,
    make_synthetic_mnist,
)
