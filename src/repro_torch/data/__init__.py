"""Data makers of the port (numpy draws identical to the JAX package)."""
from .partition import partition_label_shard  # noqa: F401
from .pipeline import federated_arrays, stack_trimmed  # noqa: F401
from .synthetic import (  # noqa: F401
    Dataset,
    make_least_squares,
    make_synthetic_mnist,
)
