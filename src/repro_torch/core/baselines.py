"""Baseline presets and the SCAFFOLD round (port of
``repro/core/baselines.py``).

The paper's baselines (FedADMM, FedAvg, FedProx) and vanilla ADMM are
instances of the generic round (:func:`repro_torch.core.fedback.
make_round_fn`): :func:`baseline_config` names their presets.  SCAFFOLD
(Karimireddy et al. 2020) keeps server and client control variates, so
it has a round of its own, on either layout of the round: flat
(``spec=``: ω and the server variate c are (D,) fp32, the client
variates c_i (N, D)) or the reference's own tree layout (``spec=None``:
ω and c are dicts like the params, c_i the stacked dict).  Every client
solves (as in the reference) and only the drawn ones commit.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import fp32_products, resolve_device
from repro_torch.utils.flatstate import FlatSpec
from repro_torch.utils.pytree import rows_mask, tree_broadcast_like, \
    tree_map, tree_where, tree_zeros_like

from .fedback import FLConfig, _epoch_indices, _local_solve


def baseline_config(name: str, **kw) -> FLConfig:
    """Named presets matching the paper's experimental setup."""
    name = name.lower()
    presets = {
        "fedback": dict(algorithm="fedback"),
        "fedadmm": dict(algorithm="fedadmm"),
        "admm": dict(algorithm="admm", participation=1.0),
        "fedavg": dict(algorithm="fedavg", rho=0.0),
        "fedprox": dict(algorithm="fedprox"),
    }
    if name not in presets:
        raise ValueError(f"unknown baseline {name}")
    return FLConfig(**{**presets[name], **kw})


class ScaffoldState(NamedTuple):
    c_server: object  # (D,) fp32 or a params tree — server variate c
    c_clients: object  # (N, D) fp32 or a stacked tree — client c_i
    omega: object  # (D,) fp32 or a params tree — server parameters ω
    rng: torch.Tensor  # (2,) int64 — threefry key words
    round: torch.Tensor  # () int32


def init_scaffold(cfg: FLConfig, params0, *, spec: FlatSpec | None = None,
                  device=None) -> ScaffoldState:
    """Zero control variates and ω = ``params0`` (flattened with
    ``spec``, a copy of the dict without), on ``device`` (CUDA unless
    another is passed)."""
    device = resolve_device(device)
    if spec is not None:
        omega = spec.flatten(params0).to(device)
    else:
        omega = tree_map(lambda x: torch.as_tensor(x).to(device).clone(),
                         params0)
    return ScaffoldState(
        c_server=tree_zeros_like(omega),
        c_clients=tree_map(lambda w: w.new_zeros((cfg.n_clients,)
                                                 + tuple(w.shape)), omega),
        omega=omega,
        rng=prng.PRNGKey(cfg.seed, device=device),
        round=torch.zeros((), dtype=torch.int32, device=device))


def make_scaffold_round(cfg: FLConfig, loss_fn: Callable, data: dict, *,
                        spec: FlatSpec | None = None,
                        device=None) -> Callable:
    """SCAFFOLD with option-II control-variate updates and a uniform
    random subset of the clients each round; returns
    ``round_fn(state) -> (state, {"events", "train_loss",
    "num_events"})``.  ``data`` and ``spec`` as for ``make_round_fn``,
    the data moved to ``device`` (CUDA by default)."""
    device = resolve_device(device)
    fp32_products(device)
    n = cfg.n_clients
    x = torch.as_tensor(data["x"], device=device)
    y = torch.as_tensor(data["y"], device=device)
    if x.shape[0] != n:
        raise ValueError(f"data has {x.shape[0]} clients, cfg.n_clients={n}")
    n_points = x.shape[1]
    # The reference's rule, kept as it is: Python's round() (half to
    # even) of L̄·N, not selection.subset_size's floor.
    k_sel = max(int(round(cfg.participation * n)), 1)

    def round_fn(state: ScaffoldState):
        rng, sel_rng, data_rng = prng.split(state.rng, 3)
        events = torch.zeros((n,), dtype=torch.bool, device=device)
        events.index_fill_(0, prng.permutation(sel_rng, n)[:k_sel], True)
        idx = _epoch_indices(prng.split(data_rng, n), n_points,
                             cfg.batch_size, cfg.epochs)
        omega_b = tree_broadcast_like(state.omega, n)
        theta, losses = _local_solve(
            loss_fn, spec, omega_b, omega_b, x, y, idx, rho=0.0, lr=cfg.lr,
            momentum=cfg.momentum, control=(state.c_server,
                                            state.c_clients))
        # option II: c_i⁺ = c_i − c + (ω − θ)/(steps·lr), in fp32
        coef = float(np.float32(1.0) / (np.float32(idx.shape[1])
                                        * np.float32(cfg.lr)))
        ci_new = tree_map(lambda ci, c, w, t: ci - c + coef * (w - t),
                          state.c_clients, state.c_server, state.omega,
                          theta)
        ev = events.to(torch.float32)
        denom = torch.clamp(torch.sum(ev), min=1.0)

        def masked_sum(new, old):  # Σ over the drawn clients of new − old
            return torch.sum(torch.where(rows_mask(events, new), new - old,
                                         torch.zeros((), dtype=new.dtype,
                                                     device=device)), dim=0)

        new = ScaffoldState(
            c_server=tree_map(lambda c, cn, co: c + masked_sum(cn, co) / n,
                              state.c_server, ci_new, state.c_clients),
            c_clients=tree_where(events, ci_new, state.c_clients),
            omega=tree_map(lambda w, t: w + masked_sum(t, w) / denom,
                           state.omega, theta),
            rng=rng, round=state.round + 1)
        return new, {"events": events,
                     "train_loss": torch.sum(losses * ev) / denom,
                     "num_events": torch.sum(events.to(torch.int32))}

    return round_fn
