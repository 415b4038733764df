"""Shared transformer building blocks (``repro/models/layers.py``).

Functions over plain tensors; parameters are nested dicts of tensors
in the JAX package's layout: a dense weight is (n_in, n_out) and
applies as ``x @ w``.

The LM loss (:func:`cross_entropy_logits`, :func:`chunked_lm_loss`) is
plain differentiable torch: no Pallas kernel has a VJP, so autograd
through the plain path is the twin of ``jax.value_and_grad``.

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
from torch.utils.checkpoint import checkpoint

from repro_torch import prng


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


def rmsnorm(x, gamma, eps=1e-5, mean_sq=None):
    """fp32 statistics, cast back to x's dtype, then scaled by γ.  A
    block of the normalised dim passes ``mean_sq`` (fp32, (…, 1)): the
    mean square over the whole dim, in place of the block's own."""
    x32 = x.to(torch.float32)
    if mean_sq is None:
        mean_sq = torch.mean(x32 * x32, dim=-1, keepdim=True)
    rms = torch.rsqrt(mean_sq + eps)
    return (x32 * rms).to(x.dtype) * gamma


def swiglu_init(key, d_model, d_ff, dtype, device):
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w_gate": dense_init(k1, d_model, d_ff, dtype, device),
        "w_up": dense_init(k2, d_model, d_ff, dtype, device),
        "w_down": dense_init(k3, d_ff, d_model, dtype, device),
    }


def swiglu_hidden(p, x):
    """silu(x · w_gate) ⊙ (x · w_up), the rows w_down projects."""
    return F.silu(x @ p["w_gate"]) * (x @ p["w_up"])


def swiglu(p, x):
    return swiglu_hidden(p, x) @ p["w_down"]


class _MatmulFp32(torch.autograd.Function):
    """:func:`matmul_fp32` on narrow operands.  Backward: dx = g · wᵀ
    and dw = xᵀ · g from the fp32 gradient g, each summed in fp32 and
    rounded once to its operand's dtype, as autograd of the widened
    product gives them (``torch.mm``'s ``out_dtype`` overload has no
    derivative)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            flat = torch.mm(x.reshape(-1, x.shape[-1]), w,
                            out_dtype=torch.float32)
            return flat.reshape(*x.shape[:-1], w.shape[-1])
        return x.to(torch.float32) @ w.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g @ w.to(torch.float32).t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            flat = g.reshape(-1, g.shape[-1])
            dw = (x.reshape(-1, x.shape[-1]).to(torch.float32).t()
                  @ flat).to(w.dtype)
        return dx, dw


def matmul_fp32(x, w):
    """x @ w (…, K) · (K, N) with an fp32 result: bf16 or fp16 operands'
    products and their sum in fp32 and never rounded (a model shard's
    partial product, rounded once after the shards' partials are added:
    ``sharding/serve.py``, ``sharding/train.py``); fp32 operands as
    ``x @ w``.  On a CUDA tensor one matmul with an fp32 output
    (``torch.mm``'s ``out_dtype``), elsewhere the operands widened
    first: both sum the same exact products in fp32, and both have
    :class:`_MatmulFp32`'s gradient."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    return _MatmulFp32.apply(x, w)


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


def _token_log_likelihood(logits, labels, ignore_index, valid_vocab):
    """(Σ log p(label) over valid positions, their count): fp32 logits,
    the padded columns (index ≥ ``valid_vocab``) at −1e30 before the
    softmax, positions whose label is ``ignore_index`` left out."""
    logits = logits.to(torch.float32)
    if valid_vocab and valid_vocab < logits.shape[-1]:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < valid_vocab, logits, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).to(torch.int64)
    ll = torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
    return torch.sum(torch.where(valid, ll, 0.0)), torch.sum(valid)


def cross_entropy_logits(logits, labels, ignore_index=-100,
                         valid_vocab: int = 0):
    """Token cross-entropy, the mean over positions whose label is not
    ``ignore_index``; logits in fp32, and with ``valid_vocab`` > 0 the
    padded vocabulary columns masked to −1e30 before the softmax (the
    embedding and the head are padded to a multiple of 256)."""
    total, n = _token_log_likelihood(logits, labels, ignore_index,
                                     valid_vocab)
    return -total / torch.clamp(n, min=1)


def chunked_lm_sums(hidden, embed_out, labels, chunk: int = 0,
                    ignore_index=-100, valid_vocab: int = 0):
    """(Σ −log p(label) over the valid positions (fp32), their count):
    the numerator and denominator of :func:`chunked_lm_loss`, which a
    batch split over data shards adds shard by shard."""
    s = hidden.shape[1]
    if not chunk or s <= chunk:
        total, n = _token_log_likelihood(hidden @ embed_out, labels,
                                         ignore_index, valid_vocab)
        return -total, n

    def chunk_loss(hc, yc):
        total, n = _token_log_likelihood(hc @ embed_out, yc, ignore_index,
                                         valid_vocab)
        return -total, n

    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    tok_sum = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(0, s, chunk):
        li, ti = checkpoint(chunk_loss, hidden[:, i:i + chunk],
                            labels[:, i:i + chunk], use_reentrant=False)
        loss_sum = loss_sum + li
        tok_sum = tok_sum + ti
    return loss_sum, tok_sum


def chunked_lm_loss(hidden, embed_out, labels, chunk: int = 0,
                    ignore_index=-100, valid_vocab: int = 0):
    """LM head + cross-entropy, chunked over the sequence axis.

    hidden: (B, S, d); embed_out: (d, V).  With ``chunk`` > 0 and S >
    ``chunk`` the (B, c, V) fp32 logits of one chunk at a time are made
    and recomputed in backward (``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint``), so the whole (B, S, V) logits are
    never held; the chunks' sums and counts are added in order."""
    nll, n = chunked_lm_sums(hidden, embed_out, labels, chunk, ignore_index,
                             valid_vocab)
    return nll / torch.clamp(n, min=1)
