"""Carry weights and round state across from the JAX package.

The JAX package hands its values over as numpy arrays (``np.asarray`` /
``jax.device_get`` of its pytrees); nothing here imports JAX.  Tensors
go to ``device``: CUDA unless the caller passes another.

* :func:`params_from_numpy` — a params pytree (nested dict of arrays)
  → the port's state dict (dotted keys, e.g. ``fc1.w``), which
  ``models.MLP.load_state_dict`` takes;
* :func:`state_from_numpy` — a fetched JAX ``FLState`` → the port's
  ``FLState`` (θ/λ/z_prev/ω, controller, deferral queue, the rng key's
  two uint32 words, the round);
* :func:`state_to_numpy` — the other way, as the port's ``FLState``
  with numpy leaves, for comparisons.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.controller import ControllerState
from repro_torch.core.state import DeferQueue, FLState
from repro_torch.device import resolve_device


def params_from_numpy(tree, device=None) -> dict:
    """Nested dict of arrays → {dotted key: tensor of the array's dtype}
    on ``device``."""
    device = resolve_device(device)
    out = {}

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = torch.from_numpy(np.array(v)).to(device)

    walk(tree, "")
    return out


def nest_params(state_dict: dict) -> dict:
    """Dotted-key state dict → the nested params dict of the engine."""
    out: dict = {}
    for key, v in state_dict.items():
        node = out
        *path, leaf = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def state_from_numpy(s, device=None) -> FLState:
    """A JAX ``FLState`` with numpy-convertible leaves → the port's state
    on ``device``.  The flat layout is required (θ is (N, D))."""
    device = resolve_device(device)
    if np.ndim(s.theta) != 2:
        raise ValueError("state_from_numpy takes the flat (N, D) layout")
    return FLState(
        theta=_t(s.theta, device, torch.float32),
        lam=_t(s.lam, device, torch.float32),
        z_prev=_t(s.z_prev, device, torch.float32),
        omega=_t(s.omega, device, torch.float32),
        ctrl=ControllerState(
            delta=_t(s.ctrl.delta, device, torch.float32),
            load=_t(s.ctrl.load, device, torch.float32),
            round=_t(s.ctrl.round, device, torch.int32),
            event_count=_t(s.ctrl.event_count, device, torch.int32)),
        rng=_t(np.asarray(s.rng).astype(np.uint32).astype(np.int64),
               device),
        round=_t(s.round, device, torch.int32),
        queue=DeferQueue(age=_t(s.queue.age, device, torch.int32),
                         load=_t(s.queue.load, device, torch.float32)),
    )


def state_to_numpy(s: FLState) -> FLState:
    """The port's state with numpy leaves (the rng as two uint32 words)."""
    def cpu(t):
        return t.detach().cpu().numpy()

    return FLState(
        theta=cpu(s.theta), lam=cpu(s.lam), z_prev=cpu(s.z_prev),
        omega=cpu(s.omega),
        ctrl=ControllerState(*(cpu(t) for t in s.ctrl)),
        rng=cpu(s.rng).astype(np.uint32), round=cpu(s.round),
        queue=DeferQueue(*(cpu(t) for t in s.queue)))
