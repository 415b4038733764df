"""GQA attention: flash-kernel prefill, blockwise training attention
and cached decode (``repro/models/attention.py``).

Prefill under the causal mask (positions 0..S−1, optional sliding
window) goes through ``kernels.ops.flash_attention`` (K4) on the
model's (B, S, H, hd) layout.  The prefix-LM mask (PaliGemma's
serving) goes through :func:`blockwise_attention`, the reference's own
path: neither K4 nor the Pallas kernel has a prefix mode, so a vlm
prefill launches no kernel.  The bidirectional mask (HuBERT) is
reached only by the audio family's loss, which has no serving path; it
too goes through :func:`blockwise_attention` wherever it is asked for.
The training loss calls :func:`blockwise_attention` by name
(``attention_forward(..., blockwise=True)``): the reference's plain,
differentiable online-softmax scan over KV blocks, the path its
``jax.value_and_grad`` goes through; autograd differentiates it here.
K4 has no backward, and its wrapper refuses an input that requires
grad.  Decode is one query against the cache: the plain einsum /
softmax of the JAX package's ``attention_decode``, which computes it
outside any Pallas kernel too, including the ring-buffer positions
under a window.

Numerics: the JAX prefill path (``blockwise_attention``) scales q in
the parameter dtype and casts the probabilities to v's dtype before the
PV product; the Pallas kernel and K4 keep both in fp32.  In fp32 (the
parity tests) the two agree; in bf16 the port follows the kernel.

:func:`_allowed` and the blockwise path have the reference's four
masks (causal, causal with a window, prefix, bidir); any other
``mask_mode`` raises ``ValueError``.
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


MASK_MODES = ("causal", "prefix", "bidir")


def check_mask_mode(mask_mode: str) -> None:
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask_mode {mask_mode!r}; the masks are "
                         f"{', '.join(MASK_MODES)}")


def _allowed(q_pos, kv_pos, *, mask_mode, window, prefix_len):
    """Boolean mask (…, Sq, Skv) from position indices."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    if mask_mode == "bidir":
        ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                        dtype=torch.bool, device=q.device)
    elif mask_mode == "causal":
        ok = k <= q
    elif mask_mode == "prefix":
        ok = (k <= q) | (k < prefix_len)
    else:
        raise ValueError(mask_mode)
    if window:
        ok = ok & (k > q - window)
    return ok


def blockwise_attention(q, k, v, *, q_positions, kv_positions, kv_valid=None,
                        mask_mode="causal", window=0, prefix_len=0,
                        kv_block=512):
    """Online-softmax attention over KV blocks, plain and differentiable.

    q: (B, Sq, H, hd); k, v: (B, Skv, Kv, hd); positions: (Sq,) /
    (Skv,).  Returns (B, Sq, H, hd) in q's dtype.  The reference's
    arithmetic: q scaled by hd^−½ in its dtype, the scores and the PV
    product accumulated in fp32 (bf16 operands are widened, so each
    product is exact as in ``preferred_element_type``), P cast to v's
    dtype before PV, m/l/acc carried in fp32 over the blocks in order,
    l floored at 1e-30.  Every block is visited and masked, as in the
    reference (no block is skipped)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if kv_valid is None:
        kv_valid = torch.ones((skv,), dtype=torch.bool, device=q.device)
    nb = -(-skv // kv_block)
    pad = nb * kv_block - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad))
        kv_valid = torch.nn.functional.pad(kv_valid, (0, pad))
    qg = (q * hd ** -0.5).reshape(b, sq, kvh, g, hd).to(torch.float32)
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(nb):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        kblk, vblk = k[:, blk], v[:, blk]
        s = torch.einsum("bskgh,btkh->bskgt", qg, kblk.to(torch.float32))
        ok = _allowed(q_positions, kv_positions[blk], mask_mode=mask_mode,
                      window=window, prefix_len=prefix_len) & \
            kv_valid[blk][None, :]
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bskgt,btkh->bskgh", p.to(vblk.dtype).to(torch.float32),
            vblk.to(torch.float32))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _project_kv(p, x, kv, num_kv_heads, head_dim):
    """(k, v) of x before RoPE, (B, S, KvH, hd): ``kv`` where the caller
    made them, else x's projections through ``p["wk"]`` / ``p["wv"]``."""
    if kv is not None:
        return kv
    b, s = x.shape[:2]
    return ((x @ p["wk"]).reshape(b, s, num_kv_heads, head_dim),
            (x @ p["wv"]).reshape(b, s, num_kv_heads, head_dim))


def attention_forward(p, x, *, positions, rope_theta, num_heads, num_kv_heads,
                      head_dim, mask_mode="causal", window=0, prefix_len=0,
                      return_kv=False, blockwise=False, kv_block=512,
                      kv=None, project=True, q=None):
    """Self-attention over x: (B, S, d) at positions 0..S−1: K4 for
    serving under the causal mask; :func:`blockwise_attention` in blocks
    of min(``kv_block``, S) under the prefix and bidir masks (no kernel
    has them) and, with ``blockwise=True``, under every mask (the
    training loss).

    A model shard under tensor parallelism passes its own blocks:
    ``p["wq"]`` its heads' columns, ``p["wo"]`` their rows (the result
    is then its partial of the output), ``num_heads`` / ``num_kv_heads``
    its local counts, and, where its k/v heads are not its own column
    block of wk / wv, ``kv``: the (B, S, KvH, hd) k and v it takes,
    before RoPE, each a tensor of its own (K4 takes no strided view).
    With ``project=False`` the heads' output (B, S, H·hd) is returned
    before wo, for the shard to take its partial product itself; ``q``
    the (B, S, H·hd) query projection of heads that are not its own
    column block of wq (they straddle the blocks)."""
    check_mask_mode(mask_mode)
    blockwise = blockwise or mask_mode != "causal"
    b, s, d = x.shape
    q = (x @ p["wq"] if q is None else q).reshape(b, s, num_heads,
                                                  head_dim)
    k, v = _project_kv(p, x, kv, num_kv_heads, head_dim)
    q = apply_rope(q, positions[None, :], rope_theta)
    k = apply_rope(k, positions[None, :], rope_theta)
    if blockwise:
        out = blockwise_attention(
            q, k, v, q_positions=positions, kv_positions=positions,
            mask_mode=mask_mode, window=window, prefix_len=prefix_len,
            kv_block=min(kv_block, s))
    else:
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  layout="bshd")
    y = out.reshape(b, s, num_heads * head_dim)
    if project:
        y = y @ p["wo"]
    return (y, (k, v)) if return_kv else y


def attention_decode(p, x, kv_cache, cache_pos: int, *, rope_theta, num_heads,
                     num_kv_heads, head_dim, window=0, kv=None, project=True,
                     q=None):
    """Single-token decode against a (B, S_max, Kv, hd) ring/linear cache.

    x: (B, 1, d); cache_pos: the position being generated (a host int).
    With a sliding window the cache is a ring buffer of size S_max and
    absolute positions are reconstructed modulo S_max.  The new k/v are
    written into the cache tensors **in place** (the JAX function
    returns new arrays); the updated pair is returned as well.  A model
    shard passes its blocks, counts and ``kv`` (the new token's (B, 1,
    KvH, hd) k and v before RoPE), ``project`` and ``q`` as
    :func:`attention_forward` says.
    """
    b = x.shape[0]
    k_cache, v_cache = kv_cache
    s_max = k_cache.shape[1]
    q = (x @ p["wq"] if q is None else q).reshape(b, 1, num_heads,
                                                  head_dim)
    k, v = _project_kv(p, x, kv, num_kv_heads, head_dim)
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
    return (out @ p["wo"] if project else out), (k_cache, v_cache)
