"""SGD with heavy-ball momentum, the paper's local solver.

Port of ``repro/optim/sgd.py`` with the same operation order, so the
update is bit-identical given the same gradient:

    buf ← momentum·buf + g ;  p ← p − lr·buf

Parameters, gradients and momentum are trees of one structure
(:mod:`repro_torch.utils.pytree`): the round's flat (C, D) rows, or the
stacked params dict of the tree layout.  One step is two elementwise
passes over every leaf of the solve batch.
"""
from __future__ import annotations

from repro_torch.utils.pytree import tree_map


def sgd_step(params, grads, buf, lr: float, momentum: float = 0.9):
    """One SGD+momentum update; returns (new_params, new_buf)."""
    buf = tree_map(lambda m, g: momentum * m + g, buf, grads)
    return tree_map(lambda p, u: p - lr * u, params, buf), buf
