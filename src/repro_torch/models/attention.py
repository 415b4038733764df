"""GQA attention: flash-kernel prefill + cached decode
(``repro/models/attention.py``).

Prefill (causal, positions 0..S−1, optional sliding window) goes through
``kernels.ops.flash_attention`` (K4) on the model's (B, S, H, hd)
layout.  Decode is one query against the cache: the plain einsum /
softmax of the JAX package's ``attention_decode``, which computes it
outside any Pallas kernel too, including the ring-buffer positions
under a window.

Numerics: the JAX prefill path (``blockwise_attention``) scales q in
the parameter dtype and casts the probabilities to v's dtype before the
PV product; the Pallas kernel and K4 keep both in fp32.  In fp32 (the
parity tests) the two agree; in bf16 the port follows the kernel.

Only the masks the served models use are ported: ``mask_mode``
"prefix" (PaliGemma) and "bidir" (HuBERT) raise ``NotImplementedError``
(ROADMAP M17).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels import ops

from .layers import apply_rope, dense_init

NEG_INF = -1e30


def attention_init(key, d_model, num_heads, num_kv_heads, head_dim, dtype,
                   device):
    kq, kk, kv, ko = prng.split(key, 4)
    return {
        "wq": dense_init(kq, d_model, num_heads * head_dim, dtype, device),
        "wk": dense_init(kk, d_model, num_kv_heads * head_dim, dtype,
                         device),
        "wv": dense_init(kv, d_model, num_kv_heads * head_dim, dtype,
                         device),
        "wo": dense_init(ko, num_heads * head_dim, d_model, dtype, device),
    }


def check_mask_mode(mask_mode: str) -> None:
    if mask_mode in ("prefix", "bidir"):
        raise NotImplementedError(
            f"mask_mode {mask_mode!r} is not ported to repro_torch yet "
            "(ROADMAP M17); the port serves causal attention")
    if mask_mode != "causal":
        raise ValueError(mask_mode)


def attention_forward(p, x, *, positions, rope_theta, num_heads, num_kv_heads,
                      head_dim, mask_mode="causal", window=0, return_kv=False):
    """Self-attention over x: (B, S, d) at positions 0..S−1."""
    check_mask_mode(mask_mode)
    b, s, d = x.shape
    q = (x @ p["wq"]).reshape(b, s, num_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, num_kv_heads, head_dim)
    q = apply_rope(q, positions[None, :], rope_theta)
    k = apply_rope(k, positions[None, :], rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              layout="bshd")
    y = out.reshape(b, s, num_heads * head_dim) @ p["wo"]
    return (y, (k, v)) if return_kv else y


def attention_decode(p, x, kv_cache, cache_pos: int, *, rope_theta, num_heads,
                     num_kv_heads, head_dim, window=0):
    """Single-token decode against a (B, S_max, Kv, hd) ring/linear cache.

    x: (B, 1, d); cache_pos: the position being generated (a host int).
    With a sliding window the cache is a ring buffer of size S_max and
    absolute positions are reconstructed modulo S_max.  The new k/v are
    written into the cache tensors **in place** (the JAX function
    returns new arrays); the updated pair is returned as well.
    """
    b = x.shape[0]
    k_cache, v_cache = kv_cache
    s_max = k_cache.shape[1]
    q = (x @ p["wq"]).reshape(b, 1, num_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, 1, num_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, 1, num_kv_heads, head_dim)
    pos = torch.full((1, 1), cache_pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)

    slot = cache_pos % s_max if window else cache_pos
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]

    # absolute positions of cache slots
    idx = torch.arange(s_max, device=x.device)
    if window:
        # ring buffer: slot holds the latest position ≡ slot (mod s_max)
        kv_pos = cache_pos - torch.remainder(cache_pos - idx, s_max)
        valid = (kv_pos >= 0) & (kv_pos >= cache_pos - window + 1)
    else:
        valid = idx <= cache_pos

    g = num_heads // num_kv_heads
    scale = head_dim ** -0.5
    qg = (q * scale).reshape(b, num_kv_heads, g, head_dim).to(torch.float32)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.to(torch.float32))
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w, v_cache.to(torch.float32))
    out = out.reshape(b, 1, num_heads * head_dim).to(x.dtype)
    return out @ p["wo"], (k_cache, v_cache)
