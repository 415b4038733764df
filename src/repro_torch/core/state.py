"""Federated state containers of the port (``repro/core/state.py``).

θ, λ, z_prev and ω are held in one of the round's two layouts, all on
the round's device: the flat layout (``spec=``) keeps θ, λ and z_prev
as (N, D) fp32 matrices and ω as a (D,) vector; the tree layout
(``spec=None``) keeps them as nested dicts with the model's keys, each
client-state leaf stacked (N, ...) and ω the unstacked dict.  The
containers are NamedTuples like the JAX package's, but the port's
compacted flat round with the fused commit updates θ/λ/z_prev **in
place** (``kernels.fused_gss``), so a state passed to such a round
must not be used afterwards as if unchanged; clone it first.

Under a client mesh (``init_state(..., mesh=)``) the state is the shard
list: one ``FLState`` per shard, holding its clients' rows of the
:data:`CLIENT_STACKED_FIELDS` and :data:`CTRL_STACKED_FIELDS` on its
device, and a copy of everything else (ω, the key, the round counters).

Stale-tolerant pipelines (``InFlight``), compressed-consensus residuals
and host-offloaded state belong to later slices of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .controller import ControllerState

#: FLState fields whose leaves carry the leading (N, ...) client axis.
CLIENT_STACKED_FIELDS = ("theta", "lam", "z_prev", "queue")

#: ControllerState fields with a per-client (N,) vector.
CTRL_STACKED_FIELDS = ("delta", "load", "event_count")


class DeferQueue(NamedTuple):
    """Deferral queue of the compacted round (``core/compact.py``)."""

    age: torch.Tensor  # (N,) int32 — rounds spent deferred; 0 = not pending
    load: torch.Tensor  # (N,) fp32 — EMA of demand membership


class FLState(NamedTuple):
    theta: object  # (N, D) fp32 or a stacked tree — local primal θ_i
    lam: object  # (N, D) fp32 or a stacked tree — dual variables λ_i
    z_prev: object  # (N, D) or a stacked tree — z_i^prev = θ_i + λ_i
    omega: object  # (D,) fp32 or the params tree — server parameters ω
    ctrl: ControllerState
    rng: torch.Tensor  # (2,) int64 — threefry key words (repro_torch.prng)
    round: torch.Tensor  # () int32
    queue: DeferQueue


class RoundMetrics(NamedTuple):
    events: torch.Tensor  # (N,) bool — S_i^k
    num_events: torch.Tensor  # () int32
    distances: torch.Tensor  # (N,) fp32 — ‖ω − z_i^prev‖
    delta: torch.Tensor  # (N,) fp32 — thresholds after the round
    load: torch.Tensor  # (N,) fp32 — low-pass participation estimates
    train_loss: torch.Tensor  # () fp32 — mean local loss of participants
    num_deferred: torch.Tensor  # () int32 — queue length after the round
    realized_capacity: torch.Tensor  # () int32 — rows the round could commit
    realized_slack: torch.Tensor  # () fp32 — realized_capacity / (L̄·N)
    committed: torch.Tensor  # (N,) bool — rows committed this round
