"""AdamW (port of ``repro/optim/adam.py``), the large-architecture
training step's optimizer (``launch/steps.py::make_train_step``).

First and second moments in fp32 whatever the parameters' dtype (mixed
precision), decoupled weight decay, bias correction 1 − βᵗ; the update
is computed in fp32 and cast to each parameter's dtype.  The operations
are the reference's, in its order, each rounded to fp32 as the
reference's eager ops round them, so a step is bit-equal to the JAX
package's in fp32.  Parameters, gradients and moments are trees of one
structure (:mod:`repro_torch.utils.pytree`); ``lr`` is a Python scalar
or a schedule ``lr(step) -> () fp32`` (:mod:`.schedules`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


class AdamState(NamedTuple):
    mu: object
    nu: object
    step: torch.Tensor  # () int32


def adam_init(params) -> AdamState:
    """Zero fp32 moments and step 0, on the parameters' device."""
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                     step=torch.zeros((), dtype=torch.int32,
                                      device=tree_leaves(params)[0].device))


def _f32(x: float) -> float:
    """A Python hyper-parameter as the fp32 value JAX's weakly typed
    scalar takes in an fp32 operation."""
    return float(np.float32(x))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root, as XLA's.  CUDA's fp32
    ``sqrt`` is correctly rounded already (tests/test_torch_cuda.py holds
    it to the float64 one); torch's vectorised CPU ``sqrt`` is off by an
    ulp on ~0.7% of fp32 inputs, so on the CPU it is taken in float64
    and rounded once (exact for fp32 inputs)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def adam_step(params, grads, state: AdamState, lr, b1=0.9, b2=0.95,
              eps=1e-8, weight_decay=0.0):
    """One AdamW step; returns (new params, new ``AdamState``)."""
    lr_t = lr(state.step) if callable(lr) else _f32(lr)
    step = state.step + 1
    c1, c2 = _f32(1 - b1), _f32(1 - b2)
    mu = tree_map(lambda m, g: _f32(b1) * m + c1 * g.to(torch.float32),
                  state.mu, grads)
    nu = tree_map(lambda v, g: _f32(b2) * v + c2 * torch.square(
        g.to(torch.float32)), state.nu, grads)
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(_f32(b1), device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(_f32(b2), device=t.device), t)

    def upd(p, m, v):
        u = (m / bc1) / (_sqrt(v / bc2) + _f32(eps))
        if weight_decay:
            u = u + _f32(weight_decay) * p.to(torch.float32)
        return (p.to(torch.float32) - lr_t * u).to(p.dtype)

    return tree_map(upd, params, mu, nu), AdamState(mu=mu, nu=nu, step=step)
