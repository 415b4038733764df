"""The paper's CIFAR-10 experiment configuration (§5), for the port.

100 clients, Dirichlet(β=0.5) split, the 3-conv/3-fc CNN
(``models.init_cnn``, D = 196,426), SGD lr 0.01 momentum 0.9, batch 20,
4 local epochs, K=5 (the larger parameter space), α=0.9; ρ = μ = 0.01.
``fl_config(algorithm)`` builds FedBack or any of the paper's baselines;
``workload()`` the data and starting weights the paper grid runs them
on, trimmed to the smallest client; ``pooled_workload()`` the same
split kept whole for the ragged forms of ``RAGGED_FORMS``.
"""
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.fedback import FLConfig

from .paper_mnist import Form, pooled

N_CLIENTS = 100
TARGET_ACCURACY = 0.78  # paper Tab. 1 threshold (central model ≈ 80%)
DIRICHLET_BETA = 0.5


def fl_config(algorithm="fedback", participation=0.1, **kw) -> FLConfig:
    return FLConfig(
        algorithm=algorithm,
        n_clients=kw.pop("n_clients", N_CLIENTS),
        participation=participation,
        rho=kw.pop("rho", 0.01),
        mu=kw.pop("mu", 0.01),
        lr=0.01,
        momentum=0.9,
        epochs=4,
        batch_size=20,
        controller=ControllerConfig(K=5.0, alpha=0.9),
        **kw,
    )


# The round forms driven at this width and L̄ = 0.1 (``chip_smoke.py``,
# ``launch/profile_round.py``): the paper grid's flat layout with the
# fused commit, and the tree layout.
FORMS = {
    "CF-A": Form("FedBack, CIFAR CNN, compact + fused",
                 dict(algorithm="fedback", compact=True, fused_gss=True)),
    "CF-T": Form("FedBack, CIFAR CNN, tree layout, compact",
                 dict(algorithm="fedback", compact=True), "tree"),
}


# CF-A on ragged clients: the Dirichlet split kept whole, 33–255
# examples a client (12,000 in all, where the trimmed split keeps
# 3,300), each compact slot solving 255 // 20 · 4 = 48 steps.
RAGGED_FORMS = {
    "RC": Form("FedBack, CIFAR CNN, compact + fused, ragged clients",
               dict(algorithm="fedback", compact=True, fused_gss=True)),
}


def form_config(form: str) -> FLConfig:
    """The ``FLConfig`` of one of :data:`FORMS` or :data:`RAGGED_FORMS`,
    at L̄ = 0.1."""
    return fl_config(**{**FORMS, **RAGGED_FORMS}[form].kw)


def workload(seed: int = 0, device=None):
    """(data, test, params0, logits_fn) of the paper grid at this width
    (``benchmarks/common.py``'s ``paper`` preset: 12,000 / 2,000
    synthetic examples, Dirichlet(β) over the clients, trimmed to the
    smallest client) on ``device``."""
    from repro_torch.data import federated_arrays, make_synthetic_cifar
    from repro_torch.models import cnn_logits, init_cnn
    from repro_torch.prng import PRNGKey

    data, test = federated_arrays(make_synthetic_cifar(12000, 2000),
                                  n_clients=N_CLIENTS, scheme="dirichlet",
                                  beta=DIRICHLET_BETA, seed=seed,
                                  device=device)
    params0 = init_cnn(PRNGKey(seed, device=device), device=device)
    return data, test, params0, cnn_logits


def pooled_workload(seed: int = 0, device=None, shards: int = 1):
    """(data, test, params0, logits_fn, ragged) of :func:`workload` with
    every client's shard kept whole: the 12,000 examples pooled over
    the 100 clients (33–255 each); ``shards`` as in
    ``paper_mnist.pooled``."""
    from repro_torch.data import make_synthetic_cifar
    from repro_torch.models import cnn_logits, init_cnn
    from repro_torch.prng import PRNGKey

    data, test, ragged = pooled(make_synthetic_cifar(12000, 2000),
                                seed=seed, device=device, shards=shards,
                                scheme="dirichlet", beta=DIRICHLET_BETA)
    params0 = init_cnn(PRNGKey(seed, device=device), device=device)
    return data, test, params0, cnn_logits, ragged
