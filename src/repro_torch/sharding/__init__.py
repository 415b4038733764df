"""The client mesh of the port (``repro/sharding``)."""
from .clients import (  # noqa: F401
    CLIENT_AXIS,
    ClientMesh,
    balanced_permutation,
    check_divisible,
    make_client_mesh,
    replicate_data,
    shard_client_data,
    shard_rows,
    unshard_rows,
)
