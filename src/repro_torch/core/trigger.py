"""Event trigger (paper Eq. 3.1): S_i^k = 1{ ‖ω^k − z_i^prev‖ ≥ δ_i }.

Port of ``repro/core/trigger.py`` on the flat layout: z_prev is the
(N, D) matrix, ω the (D,) vector.  The round takes its l2 distances
from the K1 kernel op instead (``core/fedback.py``); this plain form
serves the linf and cosine metrics.
"""
from __future__ import annotations

import torch


def trigger_distances(omega: torch.Tensor, z_prev: torch.Tensor,
                      metric: str = "l2") -> torch.Tensor:
    """Per-client distances ‖ω − z_i^prev‖ → (N,) fp32."""
    diff = z_prev.to(torch.float32) - omega.to(torch.float32)[None]
    if metric == "l2":
        return torch.sqrt(torch.sum(diff * diff, dim=1))
    if metric == "linf":
        return torch.amax(torch.abs(diff), dim=1)
    if metric == "cosine":
        z = z_prev.to(torch.float32)
        num = torch.sum(diff * diff, dim=1)
        den = torch.sqrt(torch.sum(z * z, dim=1)) + 1e-12
        return torch.sqrt(num) / den
    raise ValueError(f"unknown trigger metric: {metric}")


def evaluate_trigger(distances: torch.Tensor,
                     delta: torch.Tensor) -> torch.Tensor:
    """S_i = 1 iff distance_i ≥ δ_i (a negative δ always fires)."""
    return distances >= delta

