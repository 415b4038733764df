"""Client selection (port of ``repro/core/selection.py``).

``FedBackSelection`` is the paper's event trigger driven by the integral
controller; ``FullSelection`` fires every client every round (vanilla
consensus ADMM).  Both split into ``decide`` (the events) and
``measure`` (the controller step on the observed events); ``__call__``
composes them for the synchronous round.  The randomized k-subset
strategies come with a later slice of the port.
"""
from __future__ import annotations

import dataclasses

import torch

from .controller import ControllerConfig, ControllerState, controller_step
from .trigger import evaluate_trigger


class _SelectionBase:
    def _measure_cfg(self) -> ControllerConfig:
        raise NotImplementedError

    def decide(self, state, distances):
        raise NotImplementedError

    def measure(self, ctrl: ControllerState, events) -> ControllerState:
        return controller_step(ctrl, events, self._measure_cfg())

    def __call__(self, state, distances):
        events = self.decide(state, distances)
        return events, self.measure(state.ctrl, events)


@dataclasses.dataclass(frozen=True)
class FedBackSelection(_SelectionBase):
    controller: ControllerConfig
    metric: str = "l2"

    def _measure_cfg(self):
        return self.controller

    def decide(self, state, distances):
        return evaluate_trigger(distances, state.ctrl.delta)


@dataclasses.dataclass(frozen=True)
class FullSelection(_SelectionBase):
    """δ ≡ 0 — every client, every round."""

    def _measure_cfg(self):
        return ControllerConfig(K=0.0, target_rate=1.0)

    def decide(self, state, distances):
        return torch.ones_like(state.ctrl.delta, dtype=torch.bool)


def make_selection(name: str, *, rate: float, controller: ControllerConfig,
                   metric: str = "l2"):
    name = name.lower()
    if name == "fedback":
        return FedBackSelection(controller=controller, metric=metric)
    if name == "full":
        return FullSelection()
    if name in ("random", "bernoulli", "round_robin"):
        raise NotImplementedError(
            f"selection {name!r} is not ported yet (fedback and full are)")
    raise ValueError(f"unknown selection strategy: {name}")
