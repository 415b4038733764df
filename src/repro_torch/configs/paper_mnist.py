"""The paper's MNIST experiment configuration (§5), for the port.

100 clients, 2 unique digits each, single-hidden-layer MLP (200 ReLU),
SGD lr 0.01 momentum 0.9, batch 42, 2 local epochs, K=2, α=0.9.
"""
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.fedback import FLConfig

N_CLIENTS = 100
TARGET_ACCURACY = 0.90  # paper Tab. 1 threshold (central model ≈ 93%)


def fl_config(algorithm="fedback", participation=0.1, **kw) -> FLConfig:
    return FLConfig(
        algorithm=algorithm,
        n_clients=kw.pop("n_clients", N_CLIENTS),
        participation=participation,
        rho=kw.pop("rho", 0.01),
        mu=kw.pop("mu", 0.01),
        lr=0.01,
        momentum=0.9,
        epochs=2,
        batch_size=42,
        controller=ControllerConfig(K=2.0, alpha=0.9),
        **kw,
    )
