"""Shared transformer building blocks (``repro/models/layers.py``).

Functions over plain tensors; parameters are nested dicts of tensors
(or the :class:`ParamTree` modules built from them) in the JAX
package's layout: a dense weight is (n_in, n_out) and applies as
``x @ w``.

Init draws from an explicit ``torch.Generator`` with the JAX package's
distributions and scales.  It is not bit-equal to ``jax.random`` (the
two generators differ), so tests carry weights across with
``repro_torch.convert.lm_params_from_numpy`` instead.  A generator of
``None`` with ``device="meta"`` gives shapes only (``param_count``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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


def normal(gen, shape, device) -> torch.Tensor:
    """Standard normal fp32 draws from ``gen`` on ``device``."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen, n_in, n_out, dtype, device, scale=None):
    s = scale if scale is not None else (2.0 / (n_in + n_out)) ** 0.5
    return (normal(gen, (n_in, n_out), device) * s).to(dtype)


def rmsnorm_init(dim, dtype, device):
    return torch.ones((dim,), dtype=dtype, device=device)


def rmsnorm(x, gamma, eps=1e-5):
    """fp32 statistics, cast back to x's dtype, then scaled by γ."""
    x32 = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * gamma


def swiglu_init(gen, d_model, d_ff, dtype, device):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
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


def embed_init(gen, vocab, d_model, dtype, device):
    return (normal(gen, (vocab, d_model), device)
            * (1.0 / d_model ** 0.5)).to(dtype)
