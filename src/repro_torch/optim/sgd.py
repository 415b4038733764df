"""SGD with heavy-ball momentum, the paper's local solver.

Port of ``repro/optim/sgd.py`` with the same operation order, so the
update is bit-identical given the same gradient:

    buf ← momentum·buf + g ;  p ← p − lr·buf

Parameters, gradients and momentum are trees of one structure
(:mod:`repro_torch.utils.pytree`): the round's flat (C, D) rows, or the
stacked params dict of the tree layout.  One step is two elementwise
passes over every leaf of the solve batch.  The round carries the
momentum buffer itself; :class:`SGDState` (the buffer and a step count,
from :func:`sgd_init`) is the reference's optimizer state, stepped by
:func:`sgd_state_step`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map, \
    tree_zeros_like


class SGDState(NamedTuple):
    momentum: object  # tree like params
    step: torch.Tensor  # () int32


def sgd_init(params) -> SGDState:
    """Zero momentum and step 0, on the params' device."""
    return SGDState(momentum=tree_zeros_like(params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device))


def sgd_step(params, grads, buf, lr: float, momentum: float = 0.9):
    """One SGD+momentum update; returns (new_params, new_buf)."""
    buf = tree_map(lambda m, g: momentum * m + g, buf, grads)
    return tree_map(lambda p, u: p - lr * u, params, buf), buf


def sgd_state_step(params, grads, state: SGDState, lr: float,
                   momentum: float = 0.9):
    """:func:`sgd_step` on an :class:`SGDState`; returns (new_params,
    SGDState)."""
    params, buf = sgd_step(params, grads, state.momentum, lr, momentum)
    return params, SGDState(momentum=buf, step=state.step + 1)
