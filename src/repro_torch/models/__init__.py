"""Models of the port: the paper's MNIST MLP and CIFAR-10 CNN, and the
model zoo's six families — dense (granite, phi3, deepseek), moe
(mixtral, qwen3, moonshot), ssm (Mamba-2), hybrid (Zamba2), vlm
(PaliGemma) and audio (HuBERT) — each trained, and each but the audio
encoder served."""
from .api import Model, abstract_cache, abstract_params, \
    active_param_count, build_model, input_specs, param_count  # noqa: F401
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
