"""Client selection (port of ``repro/core/selection.py``).

``FedBackSelection`` is the paper's event trigger driven by the integral
controller; ``FullSelection`` fires every client every round (vanilla
consensus ADMM); ``RandomSelection`` draws the ⌊L̄·N⌋-subset of the
paper's baselines (FedADMM, FedAvg, FedProx), ``BernoulliSelection``
flips an i.i.d. coin per client and ``RoundRobinSelection`` cycles
through the clients ⌊L̄·N⌋ at a time.  Every strategy splits into
``decide`` (the events) and ``measure`` (the controller step on the
observed events); ``__call__`` composes them for the synchronous round.
The random draws come from the ``jax.random`` twin
(:mod:`repro_torch.prng`), so a strategy given the reference's key picks
the reference's clients.  Everything runs on the device of the inputs;
round-robin reads ``state.round`` there, without a host sync.

Under a client mesh (:meth:`_SelectionBase.decide_shards`) the
per-client strategies (fedback, full) decide on each shard's own rows;
the draws over all clients (random, bernoulli, round robin) run once
over the global N from the replicated key on shard 0's device, and the
events are cut per shard — the reference keeps its permutation
replicated and scatters the events, and its threefry draws do not
depend on the sharding, so either way a client gets the unsharded
event.

Every strategy takes an optional ``ctrl_overrides`` dict of runtime
controller overrides (``{"K": k, "target_rate": r}``, 0-d fp32 tensors
on the state's device), which is how the sweep runner
(:mod:`repro_torch.launch.sweep`) steps one round function over a grid
of gains and target rates.  FedBack's controller takes them in
``measure``; the strategies whose controller is inert (random,
bernoulli, full, round robin) ignore them, as in the reference.  Under
bounded staleness the feasible-rate clamp applies to the overridden
target.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import prng

from repro_torch.sharding.clients import ClientMesh, shard_rows, \
    unshard_rows

from .controller import ControllerConfig, ControllerState, \
    clamp_target_rate, controller_step
from .trigger import evaluate_trigger


class _SelectionBase:
    """``decide`` takes the engine's eligibility mask (None on the
    synchronous engine): the open-loop k-subset strategies draw their
    picks among eligible clients; the others ignore it (the engine masks
    their events).  The strategies that draw over all clients take
    ``n_clients``, the count they draw over (by default the state's
    rows).  ``measure`` steps the controller on the events the server
    observed: the round's own on the synchronous engine, the commit-time
    ones under bounded staleness, where ``staleness_delay`` (the (N,)
    delays) clamps the target to the feasible rate 1/(1+δ_i)."""

    #: A client's event depends on its own rows alone.
    per_client = False

    def _measure_cfg(self, ctrl_overrides) -> ControllerConfig:
        raise NotImplementedError

    def decide(self, rng, state, distances, ctrl_overrides=None,
               eligible=None, n_clients=None):
        raise NotImplementedError

    def decide_shards(self, rng, shards, distances, mesh: ClientMesh,
                      eligible=None) -> tuple:
        """Events per shard of a client mesh: ``shards`` the per-shard
        states, ``distances`` (and ``eligible``, if given) the per-shard
        (N/P,) vectors.  A per-client strategy decides on each shard; a
        draw over all clients runs once over the global N on shard 0's
        device (with the gathered mask) and is cut per shard."""
        if self.per_client:
            return tuple(self.decide(rng, s, d, eligible=e) for s, d, e in
                         zip(shards, distances, eligible or (None,) *
                             len(shards), strict=True))
        n = sum(s.ctrl.delta.shape[0] for s in shards)
        events = self.decide(rng, shards[0], None, eligible=(
            None if eligible is None else unshard_rows(eligible)),
            n_clients=n)
        return shard_rows(events, mesh)

    def measure(self, ctrl: ControllerState, events, ctrl_overrides=None,
                *, staleness_delay=None) -> ControllerState:
        cfg = self._measure_cfg(ctrl_overrides)
        if staleness_delay is not None:
            cfg = cfg._replace(target_rate=clamp_target_rate(
                cfg.target_rate, staleness_delay))
        return controller_step(ctrl, events, cfg)

    def __call__(self, rng, state, distances, ctrl_overrides=None):
        events = self.decide(rng, state, distances, ctrl_overrides)
        return events, self.measure(state.ctrl, events, ctrl_overrides)


def _first_k_eligible(order_rank: torch.Tensor, eligible, k: int):
    """Events for the first k eligible clients in the order ``order_rank``
    ((N,) int32, each client's position in the draw order): with
    ``eligible=None`` exactly ``order_rank < k``; otherwise ineligible
    clients go behind every eligible one (order kept within each group,
    a stable sort as ``jnp.argsort``) and the first k eligible fire."""
    n = order_rank.shape[0]
    if eligible is None:
        return order_rank < k
    keyed = torch.where(eligible, order_rank, order_rank + n)
    order = torch.argsort(keyed, stable=True)
    pos = torch.empty_like(order_rank)
    pos[order] = torch.arange(n, dtype=order_rank.dtype,
                              device=order_rank.device)
    return (pos < k) & eligible


def subset_size(rate: float, n: int) -> int:
    """k = max(⌊L̄·N⌋, 1), the paper's k-subset size; the epsilon absorbs
    products such as 0.29·100 = 28.999…96 that land just below an
    integer in binary."""
    return max(math.floor(rate * n + 1e-9), 1)


@dataclasses.dataclass(frozen=True)
class FedBackSelection(_SelectionBase):
    controller: ControllerConfig
    metric: str = "l2"
    per_client = True

    def _measure_cfg(self, ctrl_overrides):
        return (self.controller if not ctrl_overrides
                else self.controller._replace(**ctrl_overrides))

    def decide(self, rng, state, distances, ctrl_overrides=None,
               eligible=None, n_clients=None):
        return evaluate_trigger(distances, state.ctrl.delta)


@dataclasses.dataclass(frozen=True)
class RandomSelection(_SelectionBase):
    """Uniform ⌊L̄·N⌋-subset without replacement (the paper's
    baselines): the first k of ``permutation(rng, N)``."""

    rate: float

    def _measure_cfg(self, ctrl_overrides):
        return ControllerConfig(K=0.0, target_rate=self.rate)

    def decide(self, rng, state, distances, ctrl_overrides=None,
               eligible=None, n_clients=None):
        n = n_clients or state.ctrl.delta.shape[0]
        perm = prng.permutation(rng, n)
        rank = torch.empty((n,), dtype=torch.int32, device=perm.device)
        rank[perm] = torch.arange(n, dtype=torch.int32, device=perm.device)
        return _first_k_eligible(rank, eligible, subset_size(self.rate, n))


@dataclasses.dataclass(frozen=True)
class BernoulliSelection(_SelectionBase):
    """I.i.d. Bernoulli(L̄) participation (unreliable clients): an
    ineligible client's flip is dropped, not redrawn."""

    rate: float

    def _measure_cfg(self, ctrl_overrides):
        return ControllerConfig(K=0.0, target_rate=self.rate)

    def decide(self, rng, state, distances, ctrl_overrides=None,
               eligible=None, n_clients=None):
        return prng.bernoulli(rng, self.rate,
                              (n_clients or state.ctrl.delta.shape[0],))


@dataclasses.dataclass(frozen=True)
class FullSelection(_SelectionBase):
    """δ ≡ 0 — every client, every round."""

    per_client = True

    def _measure_cfg(self, ctrl_overrides):
        return ControllerConfig(K=0.0, target_rate=1.0)

    def decide(self, rng, state, distances, ctrl_overrides=None,
               eligible=None, n_clients=None):
        return torch.ones_like(state.ctrl.delta, dtype=torch.bool)


@dataclasses.dataclass(frozen=True)
class RoundRobinSelection(_SelectionBase):
    """Deterministic cyclic ⌊L̄·N⌋-subset starting at round·k mod N."""

    rate: float

    def _measure_cfg(self, ctrl_overrides):
        return ControllerConfig(K=0.0, target_rate=self.rate)

    def decide(self, rng, state, distances, ctrl_overrides=None,
               eligible=None, n_clients=None):
        n = n_clients or state.ctrl.delta.shape[0]
        k = subset_size(self.rate, n)
        start = (state.round * k) % n
        cyclic = (torch.arange(n, dtype=torch.int32,
                               device=state.round.device) - start) % n
        return _first_k_eligible(cyclic.to(torch.int32), eligible, k)


def make_selection(name: str, *, rate: float, controller: ControllerConfig,
                   metric: str = "l2"):
    name = name.lower()
    if name == "fedback":
        return FedBackSelection(controller=controller, metric=metric)
    if name == "random":
        return RandomSelection(rate=rate)
    if name == "bernoulli":
        return BernoulliSelection(rate=rate)
    if name == "full":
        return FullSelection()
    if name == "round_robin":
        return RoundRobinSelection(rate=rate)
    raise ValueError(f"unknown selection strategy: {name}")
