"""Checkpoints of the port in the JAX package's npz format."""
from .store import latest_checkpoint, load_checkpoint, \
    save_checkpoint  # noqa: F401
