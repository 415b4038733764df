"""Shared transformer building blocks (``repro/models/layers.py``).

Functions over plain tensors; parameters are nested dicts of tensors
(or the :class:`ParamTree` modules built from them) in the JAX
package's layout: a dense weight is (n_in, n_out) and applies as
``x @ w``.

Init follows the JAX package's key tree with the ``jax.random`` twin
(:mod:`repro_torch.prng`): each init takes a key (two uint32 words),
splits it as the reference does and draws its normals in fp32 with
:func:`repro_torch.prng.normal`, so a seed gives the reference's weights
within the twin's ulp bound (ROADMAP D5).  On ``device="meta"`` the
draws are shapes only (``param_count``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: leaves become parameters
    (no gradient: the port serves, it does not train yet), sub-dicts
    become sub-modules, and ``tree["key"]`` reads either, so the
    functional code below takes a ``ParamTree`` or a plain dict alike.
    State-dict keys are the JAX tree's paths joined by dots."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)


def scaled_normal(key, shape, scale, dtype, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device`` times a
    Python scale (rounded to fp32, as JAX takes a weakly typed scalar),
    cast to ``dtype``; on ``device="meta"`` shapes only."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    draws = prng.normal(key.to(device), shape)
    return (draws * float(np.float32(scale))).to(dtype)


def dense_init(key, n_in, n_out, dtype, device, scale=None):
    s = scale if scale is not None else (2.0 / (n_in + n_out)) ** 0.5
    return scaled_normal(key, (n_in, n_out), s, dtype, device)


def rmsnorm_init(dim, dtype, device):
    return torch.ones((dim,), dtype=dtype, device=device)


def rmsnorm(x, gamma, eps=1e-5):
    """fp32 statistics, cast back to x's dtype, then scaled by γ."""
    x32 = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * gamma


def swiglu_init(key, d_model, d_ff, dtype, device):
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w_gate": dense_init(k1, d_model, d_ff, dtype, device),
        "w_up": dense_init(k2, d_model, d_ff, dtype, device),
        "w_down": dense_init(k3, d_ff, d_model, dtype, device),
    }


def swiglu(p, x):
    g = F.silu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


def rope_frequencies(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta=1e4):
    """Half-split rotary embedding.  x: (..., S, H, hd); positions:
    broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def embed_init(key, vocab, d_model, dtype, device):
    return scaled_normal(key, (vocab, d_model), 1.0 / d_model ** 0.5, dtype,
                         device)
