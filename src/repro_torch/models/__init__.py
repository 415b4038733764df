"""Models of the port: the paper's MNIST MLP and CIFAR-10 CNN, and the
model zoo's hybrid family (Zamba2) for serving."""
from .api import Model, build_model, param_count  # noqa: F401
from .mlp import (  # noqa: F401
    MLP,
    cnn_logits,
    cross_entropy,
    init_cnn,
    init_mlp,
    make_loss_and_acc_fn,
    make_loss_fn,
    mlp_logits,
)
