"""Layout helpers of the port: the flat client-state codec
(``flatstate``) and the tree helpers (``pytree``)."""
from .flatstate import FlatSpec, flat_loss_fn, flatten_problem, \
    make_flat_spec  # noqa: F401
