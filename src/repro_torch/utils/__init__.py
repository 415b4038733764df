"""Layout helpers of the port: the flat client-state codec
(``flatstate``), the tree helpers (``pytree``) and the ragged clients'
CSR codec (``ragged``)."""
from .flatstate import FlatSpec, flat_loss_fn, flatten_problem, \
    make_flat_spec  # noqa: F401
from .ragged import RaggedBucket, RaggedSpec, make_ragged_spec, pool_data, \
    pool_rows  # noqa: F401
