"""The port's meshes (``repro/sharding``): the client mesh
(``clients.py``), the sharding rules of the model mesh (``specs.py``)
and their placement (``params.py``)."""
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
