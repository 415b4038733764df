"""Local solver optimizers of the port."""
from .sgd import sgd_step  # noqa: F401
