"""The paper's MNIST experiment configuration (§5), for the port.

100 clients, 2 unique digits each, single-hidden-layer MLP (200 ReLU),
SGD lr 0.01 momentum 0.9, batch 42, 2 local epochs, K=2, α=0.9;
ρ = μ = 0.01.  ``fl_config(algorithm)`` builds FedBack or any of the
paper's baselines (``fedadmm``, ``fedavg``, ``fedprox``, ``admm``);
``workload()`` the data and starting weights the paper grid runs them
on.  ``FORMS`` are the round forms driven at this width (QA–QS with the
compressed consensus);
``SERVE_FORMS`` the serve forms, each a stale-tolerant round with the
arrival trace it serves; ``RAGGED_FORMS`` the forms on ragged clients,
whose data ``pooled_workload()`` builds: every client's shard whole in
one pooled buffer (pass its spec as ``make_round_fn(..., ragged=)``);
``SWEEP_FORMS`` the sweep forms, each a round form stepped over a grid
of seeds, gains and target rates (``launch/sweep.py``); ``HOST_FORMS``
round forms with the client matrices in host memory
(``state_backend="host"``).  ``ci_fl_config()`` and ``CI_*`` are the
experiment at CI scale, the configuration of the paper's claims in
``tests/test_system.py``.
"""
from typing import Callable, NamedTuple

from repro_torch.core.baselines import init_scaffold, make_scaffold_round
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.fedback import FLConfig, init_state, make_round_fn
from repro_torch.core.schedule import TraceConfig
from repro_torch.sharding import make_client_mesh

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


# The experiment at CI scale: 16 clients over 3360 / 800 synthetic
# examples in label shards, L̄ = 0.25, seed 1, 90 rounds evaluated every
# 10 (``core.run_evaluated``), and the accuracy the claims read events to.
CI_CLIENTS, CI_SAMPLES, CI_ROUNDS, CI_TARGET = 16, (3360, 800), 90, 0.93


def ci_fl_config(algorithm="fedback") -> FLConfig:
    return fl_config(algorithm, 0.25, n_clients=CI_CLIENTS, seed=1)


class Form(NamedTuple):
    """One round form: what it is, its ``fl_config`` keywords, its
    client-state layout (``"flat"``: pass ``spec=make_flat_spec(params0)``
    to its builders; ``"tree"``: ``spec=None``), the builders of its
    state and its round, its client shards (more than one: a client
    mesh), for a serve form the arrival trace it serves (build its round
    with ``arrivals_arg=True``), for a sweep form its grid (the
    ``launch.sweep.SweepGrid`` keywords) and whether its data is the
    pooled workload's (``pooled``; a form of :data:`RAGGED_FORMS` always
    is)."""
    what: str
    kw: dict
    layout: str = "flat"
    init: Callable = init_state
    make_round: Callable = make_round_fn
    shards: int = 1
    trace: TraceConfig | None = None
    sweep: dict | None = None
    pooled: bool = False

    def spec(self, flat_spec):
        """The ``spec=`` its builders take, given the params' FlatSpec."""
        return flat_spec if self.layout == "flat" else None

    def placement(self, device) -> dict:
        """The ``device=`` or, with shards, ``mesh=`` its builders take:
        every shard on ``device`` (CUDA by default)."""
        if self.shards == 1:
            return {"device": device}
        return {"mesh": make_client_mesh(
            self.shards, None if device is None else [device])}


# The round forms driven at this width and L̄ = 0.1 (``chip_smoke.py``,
# ``launch/profile_round.py``).  SCAFFOLD keeps control variates, so it
# has a state and a round of its own.
FORMS = {
    "A": Form("FedBack, compact + fused",
              dict(algorithm="fedback", compact=True, fused_gss=True)),
    "B": Form("FedBack, dense", dict(algorithm="fedback")),
    "C1": Form("FedADMM, compact + fused",
               dict(algorithm="fedadmm", compact=True, fused_gss=True)),
    "C2": Form("FedADMM, dense", dict(algorithm="fedadmm")),
    "C3": Form("FedAvg, dense", dict(algorithm="fedavg")),
    "C4": Form("FedProx, compact, mu 0.01",
               dict(algorithm="fedprox", compact=True)),
    "C5": Form("FedBack, bernoulli selection, dense",
               dict(algorithm="fedback", selection="bernoulli")),
    "C6": Form("FedADMM, round-robin selection, compact, unfused",
               dict(algorithm="fedadmm", selection="round_robin",
                    compact=True)),
    "C7": Form("SCAFFOLD", dict(algorithm="scaffold"), "flat",
               init_scaffold, make_scaffold_round),
    "TA": Form("FedBack, tree layout, compact",
               dict(algorithm="fedback", compact=True), "tree"),
    "TB": Form("FedBack, tree layout, dense", dict(algorithm="fedback"),
               "tree"),
    # The client-sharded round: P shards of one card (of P cards on a
    # node with them), ⌈16/P⌉ slots a shard in the compact forms.
    "SA": Form("FedBack, compact + fused, 2 client shards",
               dict(algorithm="fedback", compact=True, fused_gss=True),
               shards=2),
    "SB": Form("FedBack, dense, 2 client shards", dict(algorithm="fedback"),
               shards=2),
    "ST": Form("FedBack, tree layout, dense, 2 client shards",
               dict(algorithm="fedback"), "tree", shards=2),
    "SR": Form("FedADMM, compact + fused, 4 client shards",
               dict(algorithm="fedadmm", compact=True, fused_gss=True),
               shards=4),
    # Compressed consensus (error feedback, ``FLState.comm``): forms A,
    # B, C3 and SA with the consensus sent as int8 or bf16.
    "QA": Form("FedBack, compact + fused, int8 consensus",
               dict(algorithm="fedback", compact=True, fused_gss=True,
                    consensus_compress="int8")),
    "QB": Form("FedBack, dense, bf16 consensus",
               dict(algorithm="fedback", consensus_compress="bf16")),
    "QC": Form("FedAvg, dense, int8 consensus",
               dict(algorithm="fedavg", consensus_compress="int8")),
    "QS": Form("FedBack, compact + fused, int8 consensus, 2 client shards",
               dict(algorithm="fedback", compact=True, fused_gss=True,
                    consensus_compress="int8"), shards=2),
}


# The serve forms: FedBack under bounded staleness (S = 2, the
# round-robin delays 0, 1, 2) over a client-arrival trace of 24 ticks
# at L̄ = 0.1.  A bursty trace's burst brings ~90 arrivals against 16
# slots, so the deferral queue and the delay line both run.
BURSTY = TraceConfig(kind="bursty", n_clients=N_CLIENTS, ticks=24, rate=0.1,
                     seed=0, burst_every=8, burst_len=2, burst_rate=0.9)
SERVE_FORMS = {
    "SVA": Form("FedBack serving, compact + fused, max_staleness 2, bursty",
                dict(algorithm="fedback", compact=True, fused_gss=True,
                     max_staleness=2), trace=BURSTY),
    "SVB": Form("FedBack serving, dense, max_staleness 2, poisson",
                dict(algorithm="fedback", max_staleness=2),
                trace=TraceConfig(kind="poisson", n_clients=N_CLIENTS,
                                  ticks=24, rate=0.1, seed=0)),
    "SVS": Form("FedBack serving, compact + fused, max_staleness 2, "
                "bursty, 2 client shards",
                dict(algorithm="fedback", compact=True, fused_gss=True,
                     max_staleness=2), shards=2, trace=BURSTY),
}


# The forms on ragged clients (``pooled_workload()``: the label-shard
# split kept whole, 114–123 examples a client in 4 padded size
# buckets): form A, form B, and form A on 2 client shards, the clients
# reordered by ``sharding.balanced_permutation`` so that each shard
# holds about half the rows.
RAGGED_FORMS = {
    "RA": Form("FedBack, compact + fused, ragged clients",
               dict(algorithm="fedback", compact=True, fused_gss=True)),
    "RB": Form("FedBack, dense, ragged clients", dict(algorithm="fedback")),
    "RS": Form("FedBack, compact + fused, ragged clients, 2 client shards",
               dict(algorithm="fedback", compact=True, fused_gss=True),
               shards=2),
}


# The sweep forms: forms A and B over a grid of runs, each run its own
# seed, gain K and target L̄ through the round's runtime controller
# overrides (``launch/sweep.py``).
SWEEP_FORMS = {
    "WA": Form("FedBack sweep, compact + fused, seeds 0-3 x K 2.0, 0.5",
               dict(FORMS["A"].kw),
               sweep=dict(seeds=(0, 1, 2, 3), gains=(2.0, 0.5))),
    "WB": Form("FedBack sweep, dense, seeds 0-1 x target 0.1, 0.2",
               dict(FORMS["B"].kw),
               sweep=dict(seeds=(0, 1), target_rates=(0.1, 0.2))),
}


# The host-offloaded forms (``core/hoststate.py``): the (N, D) client
# matrices in pinned host memory, the C planned rows streamed through
# the card each round.  Each is a device form with
# ``state_backend="host"``: A, A under ``max_staleness=2``, QA and RA
# (on the pooled workload).
HOST_FORMS = {
    "HA": Form("FedBack, compact + fused, host-offloaded state",
               dict(FORMS["A"].kw, state_backend="host")),
    "HS": Form("FedBack, compact + fused, max_staleness 2, host-offloaded "
               "state", dict(FORMS["A"].kw, max_staleness=2,
                             state_backend="host")),
    "HQ": Form("FedBack, compact + fused, int8 consensus, host-offloaded "
               "state", dict(FORMS["QA"].kw, state_backend="host")),
    "HR": Form("FedBack, compact + fused, ragged clients, host-offloaded "
               "state", dict(RAGGED_FORMS["RA"].kw, state_backend="host"),
               pooled=True),
}


def form_config(form: str) -> FLConfig:
    """The ``FLConfig`` of one of :data:`FORMS`, :data:`SERVE_FORMS`,
    :data:`RAGGED_FORMS`, :data:`SWEEP_FORMS` or :data:`HOST_FORMS`, at
    L̄ = 0.1."""
    return fl_config(**{**FORMS, **SERVE_FORMS, **RAGGED_FORMS,
                        **SWEEP_FORMS, **HOST_FORMS}[form].kw)


def workload(seed: int = 0, device=None):
    """(data, test, params0, logits_fn) of the paper grid at this width
    (``benchmarks/common.py``'s ``paper`` preset: 12,000 / 2,000
    synthetic examples, two labels per client) on ``device``."""
    from repro_torch.data import federated_arrays, make_synthetic_mnist
    from repro_torch.models import init_mlp, mlp_logits
    from repro_torch.prng import PRNGKey

    data, test = federated_arrays(make_synthetic_mnist(12000, 2000),
                                  n_clients=N_CLIENTS, scheme="label_shard",
                                  seed=seed, device=device)
    params0 = init_mlp(PRNGKey(seed, device=device), device=device)
    return data, test, params0, mlp_logits


def pooled(ds, *, seed: int, device, shards: int = 1, **split):
    """(data, test, ragged) of ``data.federated_pooled`` over
    :data:`N_CLIENTS` clients on ``device``; with ``shards`` > 1 the
    clients reordered by ``sharding.balanced_permutation`` (each
    contiguous block of N/shards clients holds about Σnᵢ/shards rows)
    and pooled again in that order."""
    from repro_torch.data import federated_pooled
    from repro_torch.device import resolve_device
    from repro_torch.sharding import balanced_permutation
    from repro_torch.utils.ragged import pool_data

    device = resolve_device(device)
    data, test, ragged, _ = federated_pooled(
        ds, n_clients=N_CLIENTS, seed=seed, device="cpu", **split)
    if shards > 1:
        perm = balanced_permutation(ragged.sizes, shards)
        data, ragged = pool_data(
            *([data[k][ragged.client_slice(int(i))] for i in perm]
              for k in ("x", "y")), max_buckets=len(ragged.buckets),
            device="cpu")
    return ({k: v.to(device) for k, v in data.items()},
            {k: v.to(device) for k, v in test.items()}, ragged)


def pooled_workload(seed: int = 0, device=None, shards: int = 1):
    """(data, test, params0, logits_fn, ragged) of :func:`workload` with
    every client's shard kept whole (12,000 examples pooled over the
    100 clients, 114–123 each) instead of trimmed to the smallest;
    ``shards`` as in :func:`pooled`."""
    from repro_torch.data import make_synthetic_mnist
    from repro_torch.models import init_mlp, mlp_logits
    from repro_torch.prng import PRNGKey

    data, test, ragged = pooled(make_synthetic_mnist(12000, 2000),
                                seed=seed, device=device, shards=shards,
                                scheme="label_shard")
    params0 = init_mlp(PRNGKey(seed, device=device), device=device)
    return data, test, params0, mlp_logits, ragged
