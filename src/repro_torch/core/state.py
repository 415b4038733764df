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

With ``max_staleness`` set, ``FLState.inflight`` holds the
stale-tolerant round's delay pipeline (:class:`InFlight`): per-client
delays, countdowns, the parked θ/λ/z payloads in the state's layout and
the issued-event ring; its fields are client-stacked, so a client mesh
keeps each shard's rows on the shard's device.

With ``consensus_compress`` set (flat layout only), ``FLState.comm``
holds the compressed consensus's (N, D) fp32 error-feedback residual
(``core/compress.py``), client-stacked like θ.

With ``state_backend="host"`` the round's state is a :class:`HostState`
(``core/hoststate.py``): the (N, D) matrices in host memory, the
vectors on the card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.utils.pytree import tree_zeros_like

from .controller import ControllerState

#: FLState fields whose leaves carry the leading (N, ...) client axis.
CLIENT_STACKED_FIELDS = ("theta", "lam", "z_prev", "queue", "inflight",
                         "comm")

#: ControllerState fields with a per-client (N,) vector.
CTRL_STACKED_FIELDS = ("delta", "load", "event_count")


class DeferQueue(NamedTuple):
    """Deferral queue of the compacted round (``core/compact.py``)."""

    age: torch.Tensor  # (N,) int32 — rounds spent deferred; 0 = not pending
    load: torch.Tensor  # (N,) fp32 — EMA of demand membership


class InFlight(NamedTuple):
    """Delay pipeline of the stale-tolerant round
    (``repro/core/state.py::InFlight``): a solve serviced at round k
    parks here and lands at round k + δ_i; a client with a solve in
    flight may not fire again, so one slot per client suffices.  Every
    field has the leading client axis."""

    delay: torch.Tensor  # (N,) int32 — δ_i in [0, max_staleness], fixed
    ttl: torch.Tensor  # (N,) int32 — rounds until the payload lands; 0 =
    #                    nothing in flight (the client is eligible)
    theta: object  # parked θ_i, the state's layout
    lam: object  # parked λ_i^{k+1}
    z: object  # parked z_i = θ_i + λ_i
    hist: torch.Tensor  # (N, max_staleness+1) bool — issued-event ring:
    #                     column k mod (S+1) holds round k's issues


def delay_schedule(n_clients: int, max_staleness: int, *,
                   kind: str = "roundrobin", seed: int = 0,
                   device=None) -> torch.Tensor:
    """The per-client delays δ_i ∈ [0, max_staleness], (N,) int32 on
    ``device`` (CUDA unless another is passed): ``roundrobin`` cycles
    0..S over the client index; ``uniform`` draws them from
    ``fold_in(PRNGKey(seed), 0x5A1E)`` with ``randint``, bit-equal to
    the reference's draw."""
    if max_staleness < 0:
        raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
    device = resolve_device(device)
    if kind == "roundrobin":
        return (torch.arange(n_clients, dtype=torch.int32, device=device)
                % (max_staleness + 1))
    if kind == "uniform":
        key = prng.fold_in(prng.PRNGKey(seed, device=device), 0x5A1E)
        return prng.randint(key, (n_clients,), 0, max_staleness + 1)
    raise ValueError(f"unknown delay schedule kind: {kind}")


def init_inflight(template, delay: torch.Tensor,
                  max_staleness: int) -> InFlight:
    """An empty pipeline for the clients of ``delay`` (their rows of
    :func:`delay_schedule`): nothing in flight, an all-False ring, and
    zero payloads shaped like ``template`` (a client-stacked tree: the
    flat (N, D) matrix or the tree layout's dict), on its device."""
    n = delay.shape[0]
    dev = delay.device
    return InFlight(
        delay=delay,
        ttl=torch.zeros((n,), dtype=torch.int32, device=dev),
        theta=tree_zeros_like(template),
        lam=tree_zeros_like(template),
        z=tree_zeros_like(template),
        hist=torch.zeros((n, max_staleness + 1), dtype=torch.bool,
                         device=dev))


class FLState(NamedTuple):
    theta: object  # (N, D) fp32 or a stacked tree — local primal θ_i
    lam: object  # (N, D) fp32 or a stacked tree — dual variables λ_i
    z_prev: object  # (N, D) or a stacked tree — z_i^prev = θ_i + λ_i
    omega: object  # (D,) fp32 or the params tree — server parameters ω
    ctrl: ControllerState
    rng: torch.Tensor  # (2,) int64 — threefry key words (repro_torch.prng)
    round: torch.Tensor  # () int32
    queue: DeferQueue
    inflight: InFlight | None = None  # the delay pipeline; None = the
    #                                   synchronous round
    comm: torch.Tensor | None = None  # (N, D) fp32 — the compressed
    #                                   consensus's error-feedback residual;
    #                                   None = the exact fp32 consensus


@dataclasses.dataclass
class HostState:
    """Host-offloaded client state (``FLConfig.state_backend="host"``;
    ``repro/core/state.py::HostState``).

    θ, λ, z_prev, the EF residual ``comm`` and the parked in-flight
    θ/λ/z payloads are (N, D) fp32 **host** tensors, pinned when the
    round's device is CUDA (``pin_memory`` needs CUDA, so on the CPU
    they are plain CPU tensors and the same code runs); ω, the
    controller, queue and pipeline vectors, the key and ``distances``
    live on the device.  The round (``core/hoststate.py``) copies the
    planned rows out of the host matrices and writes its results back
    into them in place, so this is a mutable dataclass and not part of
    the ``FLState`` tuple.

    ``distances`` caches the next round's trigger distances ‖ω − z_i‖,
    computed by the round's one full-width pass together with the
    consensus; None after an init or a restore (the next round computes
    them first).  It is derived state and never checkpointed.
    """

    theta: torch.Tensor  # (N, D) fp32, host
    lam: torch.Tensor  # (N, D) fp32, host
    z_prev: torch.Tensor  # (N, D) fp32, host
    omega: torch.Tensor  # (D,) fp32, device
    ctrl: ControllerState  # (N,) vectors, device
    rng: torch.Tensor
    round: torch.Tensor  # () int32
    queue: DeferQueue  # (N,) vectors, device
    distances: torch.Tensor | None = None  # (N,) fp32, device
    inflight: InFlight | None = None  # delay/ttl/hist on the device, the
    #                                   parked θ/λ/z payloads on the host
    comm: torch.Tensor | None = None  # (N, D) fp32, host

    def to_checkpoint_tree(self) -> FLState:
        """An ``FLState`` with the same leaves, the matrices still host
        tensors (no device round-trip); its structure is a device
        state's of the same config, so checkpoints resume across the
        backends.  ``distances`` is left out."""
        return FLState(theta=self.theta, lam=self.lam, z_prev=self.z_prev,
                       omega=self.omega, ctrl=self.ctrl, rng=self.rng,
                       round=self.round, queue=self.queue,
                       inflight=self.inflight, comm=self.comm)

    def device_state_bytes(self) -> int:
        """Bytes of the state that stays on the device between rounds:
        ω and the O(N) vectors (no (N, D) matrix)."""
        fl = self.inflight
        parts = [self.omega, self.rng, self.round, self.distances,
                 *self.ctrl, *self.queue]
        if fl is not None:
            parts += [fl.delay, fl.ttl, fl.hist]
        return sum(t.numel() * t.element_size() for t in parts
                   if t is not None)

    def host_state_bytes(self) -> int:
        """Bytes of the host-resident (N, D) matrices."""
        mats = [self.theta, self.lam, self.z_prev, self.comm]
        if self.inflight is not None:
            mats += [self.inflight.theta, self.inflight.lam,
                     self.inflight.z]
        return sum(m.numel() * m.element_size() for m in mats
                   if m is not None)


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
    num_inflight: torch.Tensor  # () int32 — solves in flight after the
    #                             round (0 on the synchronous round)
    num_landed: torch.Tensor  # () int32 — delayed solves that landed
    committed: torch.Tensor  # (N,) bool — rows committed this round
    #                          (under staleness: δ = 0 service | landed)
