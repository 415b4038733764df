"""The round's shared ADMM algebra (port of ``repro/core/engine.py``).

    dual ascent   λ_i ← λ_i + θ_i − ω            (Eq. 2.3, dual)
    prox center   c_i = ω − λ_i
    gated commit  state_i ← proposed_i  iff  S_i^k
    consensus     ω = (1/N) Σ_i z_i^prev       (Eq. 2.4)

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


def participant_mean_loss(losses, events):
    """Mean local train loss among this round's participants."""
    ev = events.to(torch.float32)
    return torch.sum(losses * ev) / torch.clamp(torch.sum(ev), min=1.0)
