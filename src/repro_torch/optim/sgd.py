"""SGD with heavy-ball momentum, the paper's local solver.

Port of ``repro/optim/sgd.py`` with the same operation order, so the
update is bit-identical given the same gradient:

    buf ← momentum·buf + g ;  p ← p − lr·buf

The round keeps parameters and momentum as flat (C, D) rows, so one
step is two elementwise passes over the whole solve batch.
"""
from __future__ import annotations

import torch


def sgd_step(params: torch.Tensor, grads: torch.Tensor, buf: torch.Tensor,
             lr: float, momentum: float = 0.9):
    """One SGD+momentum update; returns (new_params, new_buf)."""
    buf = momentum * buf + grads
    return params - lr * buf, buf
