"""Inexact proximal local solver for the ADMM primal update (Eq. 2.3).

Port of ``repro/optim/prox.py``: θ⁺ ≈ argmin_θ f_i(θ) + (ρ/2)‖θ − c‖²,
c = ω − λ⁺, by mini-batch SGD with momentum over a fixed batch
schedule.  The round batches this solve over clients itself
(``core/fedback.py::_local_solve``); these are the single-client
library forms.  Parameters are a params tree (nested dicts of tensors,
or one tensor); ``loss_fn(params, batch) -> scalar``.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import tree_map

from .sgd import sgd_init, sgd_state_step


def prox_grad_fn(loss_fn, rho: float):
    """Gradient of the prox-augmented objective:
    ``grad_fn(params, center, batch)`` = ∇f(params) + ρ(params − center)."""
    gf = torch.func.grad(loss_fn)

    def grad_fn(params, center, batch):
        return tree_map(lambda g, p, c: g + rho * (p - c),
                        gf(params, batch), params, center)

    return grad_fn


def _step_batch(batches, i):
    if isinstance(batches, dict):
        return {k: _step_batch(v, i) for k, v in batches.items()}
    if isinstance(batches, (tuple, list)):
        return type(batches)(_step_batch(b, i) for b in batches)
    return batches[i]


def _n_steps(batches) -> int:
    if isinstance(batches, dict):
        return _n_steps(next(iter(batches.values())))
    if isinstance(batches, (tuple, list)):
        return _n_steps(batches[0])
    return batches.shape[0]


def solve_prox(loss_fn, params0, center, batches, *, rho: float, lr: float,
               momentum: float = 0.9):
    """SGD with momentum over ``batches`` (a tree of tensors whose
    leading axis is the step: epochs already unrolled).  Returns
    (params, the mean loss over the schedule)."""
    grad_loss = torch.func.grad_and_value(loss_fn)
    params, opt = params0, sgd_init(params0)
    losses = []
    for i in range(_n_steps(batches)):
        g, loss = grad_loss(params, _step_batch(batches, i))
        g = tree_map(lambda gl, p, c: gl + rho * (p - c), g, params, center)
        params, opt = sgd_state_step(params, g, opt, lr, momentum)
        losses.append(loss)
    return params, torch.mean(torch.stack(losses))
