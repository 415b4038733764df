"""Event trigger (paper Eq. 3.1): S_i^k = 1{ ‖ω^k − z_i^prev‖ ≥ δ_i }.

Port of ``repro/core/trigger.py``: z_prev is a stacked tree (N, ...) —
on the flat layout the one (N, D) matrix — and ω the matching unstacked
tree.  The distance is the global norm over every leaf.  The round
takes its l2 distances from the K1 kernel op instead
(``kernels.ops.trigger_sq_norms_pytree``, ``core/fedback.py``); this
plain form serves the linf and cosine metrics.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import stacked_sq_norms, tree_leaves, \
    tree_map


def trigger_distances(omega, z_prev, metric: str = "l2") -> torch.Tensor:
    """Per-client distances ‖ω − z_i^prev‖ → (N,) fp32."""
    n = tree_leaves(z_prev)[0].shape[0]
    diff = tree_map(lambda z, w: z.to(torch.float32)
                    - w.to(torch.float32)[None], z_prev, omega)
    if metric == "l2":
        return torch.sqrt(stacked_sq_norms(diff))
    if metric == "linf":
        out = torch.zeros((n,), dtype=torch.float32,
                          device=tree_leaves(diff)[0].device)
        for x in tree_leaves(diff):
            out = torch.maximum(out, torch.amax(torch.abs(x).reshape(n, -1),
                                                dim=1))
        return out
    if metric == "cosine":
        num = stacked_sq_norms(diff)
        den = torch.sqrt(stacked_sq_norms(z_prev)) + 1e-12
        return torch.sqrt(num) / den
    raise ValueError(f"unknown trigger metric: {metric}")


def evaluate_trigger(distances: torch.Tensor,
                     delta: torch.Tensor) -> torch.Tensor:
    """S_i = 1 iff distance_i ≥ δ_i (a negative δ always fires)."""
    return distances >= delta


def trigger_events(omega, z_prev, delta: torch.Tensor,
                   metric: str = "l2") -> torch.Tensor:
    """S_i = 1{‖ω − z_i^prev‖ ≥ δ_i}, the plain distances and the
    trigger in one call."""
    return evaluate_trigger(trigger_distances(omega, z_prev, metric), delta)
