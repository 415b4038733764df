"""Models of the port (the paper's MNIST MLP)."""
from .mlp import (  # noqa: F401
    MLP,
    cross_entropy,
    init_mlp,
    make_loss_and_acc_fn,
    make_loss_fn,
    mlp_logits,
)
