"""The round's shared ADMM algebra (port of ``repro/core/engine.py``).

    dual ascent   λ_i ← λ_i + θ_i − ω            (Eq. 2.3, dual)
    prox center   c_i = ω − λ_i
    gated commit  state_i ← proposed_i  iff  S_i^k
    consensus     ω = (1/N) Σ_i z_i^prev       (Eq. 2.4)
    participants  ω = mean of z_i over S_i^k   (FedAvg, FedProx)

on the flat layout: (N, D) client matrices and a (D,) ω.
"""
from __future__ import annotations

import torch


def dual_ascent(lam, theta, omega):
    """λ_i^{k+1} = λ_i^k + θ_i^k − ω^k."""
    return lam + theta - omega[None]


def prox_center(omega, lam_new):
    """c_i = ω^k − λ_i^{k+1}."""
    return omega[None] - lam_new


def gated_commit(events, proposed, current):
    """Row i takes ``proposed`` iff S_i^k, else keeps ``current``."""
    return torch.where(events[:, None], proposed, current)


def consensus_mean(z_prev):
    """ω = (1/N) Σ_i z_i^prev — stale rows included (Eq. 2.4)."""
    return torch.mean(z_prev, dim=0)


def participant_mean(per_client, events, fallback, num_events=None):
    """Mean of the (N, D) rows whose event fired (FedAvg/FedProx
    aggregation): the masked sum in fp32 over max(count, 1), cast to the
    rows' dtype; ``fallback`` (D,) where no client fired.  The count
    stays on the device (no host branch)."""
    if num_events is None:
        num_events = torch.sum(events.to(torch.int32))
    acc = torch.promote_types(per_client.dtype, torch.float32)
    total = torch.sum(torch.where(events[:, None], per_client,
                                  torch.zeros((), dtype=per_client.dtype,
                                              device=per_client.device)
                                  ).to(acc), dim=0)
    mean = total / torch.clamp(num_events, min=1).to(acc)
    return torch.where(num_events > 0, mean.to(per_client.dtype), fallback)


def participant_mean_loss(losses, events):
    """Mean local train loss among this round's participants."""
    ev = events.to(torch.float32)
    return torch.sum(losses * ev) / torch.clamp(torch.sum(ev), min=1.0)
