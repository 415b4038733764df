"""The round's shared ADMM algebra (port of ``repro/core/engine.py``).

    dual ascent   λ_i ← λ_i + θ_i − ω            (Eq. 2.3, dual)
    prox center   c_i = ω − λ_i
    gated commit  state_i ← proposed_i  iff  S_i^k
    consensus     ω = (1/N) Σ_i z_i^prev       (Eq. 2.4)
    participants  ω = mean of z_i over S_i^k   (FedAvg, FedProx)

over stacked trees (:mod:`repro_torch.utils.pytree`): client state has
a leading axis N on every leaf and ω is the unstacked tree.  The flat
layout is the one-leaf case — (N, D) client matrices and a (D,) ω.
Each leaf takes the reference's operations in its order, so the
algebra is bit-exact in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import rows_mask, tree_map, tree_where


def dual_ascent(lam, theta, omega):
    """λ_i^{k+1} = λ_i^k + θ_i^k − ω^k."""
    return tree_map(lambda l, t, w: l + t - w[None], lam, theta, omega)


def prox_center(omega, lam_new):
    """c_i = ω^k − λ_i^{k+1}."""
    return tree_map(lambda w, l: w[None] - l, omega, lam_new)


def gated_commit(events, proposed, current):
    """Row i takes ``proposed`` iff S_i^k, else keeps ``current``."""
    return tree_where(events, proposed, current)


def consensus_mean(z_prev):
    """ω = (1/N) Σ_i z_i^prev — stale rows included (Eq. 2.4)."""
    return tree_map(lambda z: torch.mean(z, dim=0), z_prev)


def participant_mean(per_client, events, fallback, num_events=None):
    """Mean of the rows whose event fired (FedAvg/FedProx aggregation):
    per leaf, the masked sum in fp32 over max(count, 1), cast to the
    leaf's dtype; ``fallback`` (unstacked) where no client fired.  The
    count stays on the device (no host branch)."""
    if num_events is None:
        num_events = torch.sum(events.to(torch.int32))

    def avg(z, w):
        acc = torch.promote_types(z.dtype, torch.float32)
        total = torch.sum(torch.where(rows_mask(events, z), z,
                                      torch.zeros((), dtype=z.dtype,
                                                  device=z.device)
                                      ).to(acc), dim=0)
        mean = total / torch.clamp(num_events, min=1).to(acc)
        return torch.where(num_events > 0, mean.to(z.dtype), w)

    return tree_map(avg, per_client, fallback)


def participant_mean_loss(losses, events):
    """Mean local train loss among this round's participants."""
    ev = events.to(torch.float32)
    return torch.sum(losses * ev) / torch.clamp(torch.sum(ev), min=1.0)
