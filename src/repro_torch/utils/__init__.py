"""Layout helpers of the port (the flat client-state codec)."""
from .flatstate import FlatSpec, make_flat_spec  # noqa: F401
