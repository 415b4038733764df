"""Integral feedback controller for client participation (paper Alg. 1).

Port of ``repro/core/controller.py``:

    low-pass      L_i^{k+1} = (1−α) L_i^k + α S_i^k          (Eq. 3.4)
    integral law  δ_i^{k+1} = δ_i^k + K (L_i^k − L̄_i)        (Eq. 3.3)

over (N,) tensors, one ``controller_step`` for all clients; under
bounded staleness the target is clamped to the feasible rate 1/(1+δ_i)
(:func:`clamp_target_rate`).  The
operations are the reference's, in its order; the one known difference
is that XLA's CPU backend contracts ``(1−α)·L + α·S`` into a single FMA
while torch rounds the product first, so L (and the demand EMA) can
differ from the JAX package by one ulp.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class ControllerConfig(NamedTuple):
    """K: integral gain; alpha: low-pass constant; target_rate: L̄ (scalar
    or (N,)); delta0: initial threshold; use_filtered_error: use L^{k+1}
    instead of the paper's L^k in the integral law (ablation)."""

    K: float = 2.0
    alpha: float = 0.9
    target_rate: float | torch.Tensor = 0.1
    delta0: float = 0.0
    use_filtered_error: bool = False


class ControllerState(NamedTuple):
    delta: torch.Tensor  # (N,) fp32 — thresholds δ_i^k
    load: torch.Tensor  # (N,) fp32 — low-pass participation L_i^k
    round: torch.Tensor  # () int32 — k
    event_count: torch.Tensor  # (N,) int32 — Σ_j S_i^j


def init_controller(n_clients: int, cfg: ControllerConfig,
                    device=None) -> ControllerState:
    """δ⁰ for every client and a zero load, on ``device`` (CUDA unless
    another is passed)."""
    device = resolve_device(device)
    return ControllerState(
        delta=torch.full((n_clients,), float(cfg.delta0),
                         dtype=torch.float32, device=device),
        load=torch.zeros((n_clients,), dtype=torch.float32, device=device),
        round=torch.zeros((), dtype=torch.int32, device=device),
        event_count=torch.zeros((n_clients,), dtype=torch.int32,
                                device=device),
    )


def _target(rate, device):
    """L̄ as the fp32 value the reference uses: a Python scalar stays a
    scalar, rounded to fp32 on the host without a tensor (no host→device
    copy and no scalar read-back happen per round); a tensor moves to
    ``device``."""
    if isinstance(rate, torch.Tensor):
        return rate.to(device=device, dtype=torch.float32)
    return float(np.float32(rate))  # tracecheck: ok — a host scalar


def controller_step(state: ControllerState, events: torch.Tensor,
                    cfg: ControllerConfig) -> ControllerState:
    """Advance the loop one round given the measured events S^k (N,) bool."""
    s = events.to(torch.float32)
    target = _target(cfg.target_rate, s.device)
    new_load = (1.0 - cfg.alpha) * state.load + cfg.alpha * s
    err_load = new_load if cfg.use_filtered_error else state.load
    new_delta = state.delta + cfg.K * (err_load - target)
    return ControllerState(
        delta=new_delta,
        load=new_load,
        round=state.round + 1,
        event_count=state.event_count + events.to(torch.int32),
    )


def demand_load_step(load: torch.Tensor, demand: torch.Tensor,
                     alpha: float) -> torch.Tensor:
    """The Eq. 3.4 filter applied to solver-row demand (fired ∪ pending);
    the compacted round's adaptive capacity reads its sum."""
    return (1.0 - alpha) * load + alpha * demand.to(torch.float32)


def feasible_rate(delay: torch.Tensor) -> torch.Tensor:
    """The highest rate a client can reach under bounded staleness,
    1/(1+δ_i): an in-flight client may not re-fire, so its events are at
    least δ_i + 1 rounds apart.  1 where δ_i = 0."""
    return 1.0 / (1.0 + delay.to(torch.float32))


def clamp_target_rate(target_rate, delay: torch.Tensor) -> torch.Tensor:
    """The stale-tolerant controller's anti-windup target, per client:
    L̄_i ← min(L̄_i, 1/(1+δ_i)), an (N,) fp32 vector on the delays'
    device (a scalar L̄ is rounded to fp32 first, as the reference's
    ``jnp.asarray``).  With δ ≡ 0 it is L̄, bit for bit."""
    target = _target(target_rate, delay.device)
    if not isinstance(target, torch.Tensor):
        target = torch.full(delay.shape, target, dtype=torch.float32,
                            device=delay.device)
    return torch.minimum(target, feasible_rate(delay))


def delta_bounds(cfg: ControllerConfig,
                 delta_plus: float) -> tuple[float, float]:
    """Paper Lemma 1: (lower, upper) bounds on δ_i^k given a trigger
    saturation level δ₊ (S(δ) = 0 for every δ ≥ δ₊)."""
    K, a, d0 = cfg.K, cfg.alpha, cfg.delta0
    lower = min(d0 - K / a, -K * (1 + a) / a)
    upper = max(delta_plus + K * (1 + a) / a, d0 + K / a)
    return lower, upper


def tracking_error_bounds(cfg: ControllerConfig, delta_plus: float,
                          horizon: int) -> tuple[float, float]:
    """Paper Theorem 2: c1/T ≤ (1/T) Σ_k S^k − L̄ ≤ c2/T; returns
    (c1/T, c2/T)."""
    K, a, d0 = cfg.K, cfg.alpha, cfg.delta0
    c1 = min(-2.0 / a, -d0 / K - (2.0 + a) / a)
    c2 = max((delta_plus - d0) / K + (2.0 + a) / a, (2.0 + a) / a)
    return c1 / horizon, c2 / horizon


def realized_rate(state: ControllerState) -> torch.Tensor:
    """Time-averaged participation rate (1/T) Σ_k S_i^k per client."""
    t = torch.clamp(state.round, min=1).to(torch.float32)
    return state.event_count.to(torch.float32) / t
