"""Models of the port: the paper's MNIST MLP and CIFAR-10 CNN, and the
model zoo's dense (granite, phi3, deepseek), ssm (Mamba-2) and hybrid
(Zamba2) families, each served and trained."""
from .api import Model, abstract_cache, abstract_params, build_model, \
    input_specs, param_count  # noqa: F401
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
