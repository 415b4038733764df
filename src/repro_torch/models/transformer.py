"""The hybrid family's stack (``repro/models/transformer.py``): a
Mamba-2 backbone plus ONE shared attention+MLP block applied after every
``attn_every`` mamba layers (Zamba2's shared-block design: the same
parameters are re-applied at each group's depth).

Parameters are a :class:`~repro_torch.models.layers.ParamTree` whose
paths mirror the JAX tree's, with the JAX package's stacked (L, ...)
layer axis split into ``layers`` — an ``nn.ModuleList`` with one
module per mamba layer.  Layer i belongs to group i // attn_every.
The JAX package's ``constrain_batch`` is a sharding hint and has no
counterpart on one device.

Serving only: prefill (K4 and K5 through the attention and SSM modules)
and single-token decode.  The other families (dense, moe, ssm, vlm,
audio), the training loss and the MoE block raise
``NotImplementedError`` (ROADMAP M17).

The cache mirrors the JAX package's: ``layers.ssm`` (L, B, H, P, N)
fp32, ``layers.conv`` (L, B, K−1, conv_dim), ``k``/``v``
(L/attn_every, B, S_cache, KvH, hd), and ``pos``, the next position,
kept as a host int so decode never reads it back from the card.
Decode updates the cache tensors in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import prng

from .attention import attention_decode, attention_forward, attention_init
from .layers import (
    ParamTree,
    dense_init,
    embed_init,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
)
from .ssm import ssm_cache_init, ssm_decode_step, ssm_forward, ssm_init


def check_family(cfg) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            "repro_torch yet (ROADMAP M17); the port serves the hybrid "
            "family")
    if cfg.num_experts:
        raise NotImplementedError("MoE blocks are not ported (ROADMAP M17)")


# ----------------------------------------------------------------------
# per-layer blocks
# ----------------------------------------------------------------------


def _attn_block_init(key, cfg, device):
    dt = cfg.param_dtype
    k1, k2 = prng.split(key)
    return {
        "ln1": rmsnorm_init(cfg.d_model, dt, device),
        "attn": attention_init(k1, cfg.d_model, cfg.num_heads,
                               cfg.num_kv_heads, cfg.head_dim, dt, device),
        "ln2": rmsnorm_init(cfg.d_model, dt, device),
        "mlp": swiglu_init(k2, cfg.d_model, cfg.d_ff, dt, device),
    }


def _attn_block_apply(cfg, p, h, positions, *, window):
    """The shared block in prefill → (h, its (k, v) for the cache)."""
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    att, kv = attention_forward(
        p["attn"], x, positions=positions, rope_theta=cfg.rope_theta,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, mask_mode="causal", window=window,
        return_kv=True)
    h = h + att
    x = rmsnorm(h, p["ln2"], cfg.norm_eps)
    return h + swiglu(p["mlp"], x), kv


def _attn_block_decode(cfg, p, h, kv_cache, pos, *, window):
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    att, kv_cache = attention_decode(
        p["attn"], x, kv_cache, pos, rope_theta=cfg.rope_theta,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, window=window)
    h = h + att
    x = rmsnorm(h, p["ln2"], cfg.norm_eps)
    return h + swiglu(p["mlp"], x), kv_cache


def _ssm_kw(cfg):
    return dict(expand=cfg.expand, ssm_state=cfg.ssm_state,
                head_dim=cfg.ssm_head_dim, conv_kernel=cfg.conv_kernel)


def _ssm_block_init(key, cfg, device):
    return {
        "ln": rmsnorm_init(cfg.d_model, cfg.param_dtype, device),
        "ssm": ssm_init(key, cfg.d_model, dtype=cfg.param_dtype,
                        device=device, **_ssm_kw(cfg)),
    }


def _intra_dtype(cfg):
    return torch.float32 if cfg.ssd_intra_dtype == "float32_forced" else None


def _ssm_block_apply(cfg, p, h):
    """One mamba layer in prefill → (h, final ssm state, conv tail)."""
    x = rmsnorm(h, p["ln"], cfg.norm_eps)
    y, st = ssm_forward(p["ssm"], x, chunk=cfg.chunk, return_state=True,
                        intra_dtype=_intra_dtype(cfg), **_ssm_kw(cfg))
    return h + y, st, _conv_tail(cfg, p, x)


def _ssm_block_decode(cfg, p, h, cache):
    x = rmsnorm(h, p["ln"], cfg.norm_eps)
    y, cache = ssm_decode_step(p["ssm"], x, cache, **_ssm_kw(cfg))
    return h + y, cache


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------


def init_params(cfg, seed: int = 0, *, device) -> ParamTree:
    """The hybrid's parameters of the JAX package's
    ``init_params(PRNGKey(seed), cfg)``, drawn on ``device`` by the
    ``jax.random`` twin along the reference's key tree (on
    ``device="meta"``: shapes only).  The reference draws the layer stack
    as one ``vmap`` over per-layer keys; here each layer, and each leaf,
    is drawn on its own, which gives the same values and bounds the
    draws' temporaries by the largest leaf."""
    check_family(cfg)
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.num_layers} layers do not split into groups "
                         f"of {cfg.attn_every}")
    device = torch.device(device)
    keys = prng.split(prng.PRNGKey(seed, device=device), 8)
    dt = cfg.param_dtype
    tree = {
        "final_ln": rmsnorm_init(cfg.d_model, dt, device),
        "embed": embed_init(keys[0], cfg.vocab_padded, cfg.d_model, dt,
                            device),
        "lm_head": dense_init(keys[1], cfg.d_model, cfg.vocab_padded, dt,
                              device),
        "shared": _attn_block_init(keys[5], cfg, device),
    }
    layers = [_ssm_block_init(k, cfg, device)
              for k in prng.split(keys[2], cfg.num_layers)]
    return hybrid_params(tree, layers)


def hybrid_params(tree: dict, layers: list) -> ParamTree:
    """Top-level tensors (embed, lm_head, final_ln, shared block) and one
    dict per mamba layer → the port's parameter module."""
    params = ParamTree(tree)
    params.layers = nn.ModuleList(ParamTree(lp) for lp in layers)
    return params


# ----------------------------------------------------------------------
# serving: prefill + single-token decode
# ----------------------------------------------------------------------


def init_cache(cfg, batch_size, max_seq, dtype=None, *, device):
    check_family(cfg)
    dtype = dtype or cfg.param_dtype
    ng = cfg.num_layers // cfg.attn_every
    one = ssm_cache_init(batch_size, cfg.d_model, dtype=dtype, device=device,
                         **_ssm_kw(cfg))
    s = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    kv = (ng, batch_size, s, cfg.num_kv_heads, cfg.head_dim)
    return {
        "layers": {k: torch.zeros((cfg.num_layers,) + x.shape, dtype=x.dtype,
                                  device=device) for k, x in one.items()},
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": 0,
    }


def _groups(cfg):
    g = cfg.attn_every
    return [range(i * g, (i + 1) * g) for i in range(cfg.num_layers // g)]


@torch.no_grad()
def prefill(cfg, params, batch, max_seq=None):
    """Process a prompt; returns (last-token logits (B, 1, V) fp32, the
    filled cache)."""
    check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_seq = max_seq or s
    h = params["embed"][tokens]
    positions = torch.arange(s, device=h.device)
    ssm_states, conv_tails, ks, vs = [], [], [], []
    for group in _groups(cfg):
        for i in group:
            h, st, tail = _ssm_block_apply(cfg, params.layers[i], h)
            ssm_states.append(st)
            conv_tails.append(tail)
        h, (k, v) = _attn_block_apply(cfg, params["shared"], h, positions,
                                      window=cfg.sliding_window)
        ks.append(k)
        vs.append(v)
    kvc = _fit_kv_cache(cfg, torch.stack(ks), torch.stack(vs), max_seq, s)
    cache = {"layers": {"ssm": torch.stack(ssm_states),
                        "conv": torch.stack(conv_tails)},
             "k": kvc["k"], "v": kvc["v"], "pos": s}
    h = rmsnorm(h[:, -1:], params["final_ln"], cfg.norm_eps)
    logits = (h @ params["lm_head"]).to(torch.float32)
    return logits[..., :cfg.vocab_size], cache


def _conv_tail(cfg, lp, x):
    """Last (K−1) conv inputs of a mamba layer (for the decode ring)."""
    d_inner = cfg.expand * cfg.d_model
    # Only the last K−1 positions are needed; the projection is linear
    # per position, so project just those rows.
    zxbcdt = x[:, -(cfg.conv_kernel - 1):] @ lp["ssm"]["in_proj"]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * cfg.ssm_state]
    return xbc


def _fit_kv_cache(cfg, ks, vs, max_seq, s):
    """Pad/crop prefill KV (G, B, S, Kv, hd) into the serving cache."""
    window = cfg.sliding_window
    size = min(max_seq, window) if window else max_seq
    if window and s > size:
        # keep the last `size` positions, ring-aligned: slot = pos % size
        shift = s % size
        ks = torch.roll(ks[:, :, -size:], shift, dims=2)
        vs = torch.roll(vs[:, :, -size:], shift, dims=2)
    elif s < size:
        pad = (0, 0, 0, 0, 0, size - s)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    return {"k": ks.contiguous(), "v": vs.contiguous(), "pos": s}


@torch.no_grad()
def decode_step(cfg, params, token, cache):
    """One token (B, 1) given a filled cache → (logits (B, 1, V) fp32,
    the cache, updated in place with ``pos`` advanced)."""
    check_family(cfg)
    h = params["embed"][token]
    pos = cache["pos"]
    lc = cache["layers"]
    for gi, group in enumerate(_groups(cfg)):
        for i in group:
            h, new = _ssm_block_decode(
                cfg, params.layers[i], h,
                {"conv": lc["conv"][i], "ssm": lc["ssm"][i]})
            lc["conv"][i] = new["conv"]
            lc["ssm"][i] = new["ssm"]
        h, _ = _attn_block_decode(cfg, params["shared"], h,
                                  (cache["k"][gi], cache["v"][gi]), pos,
                                  window=cfg.sliding_window)
    cache["pos"] = pos + 1
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = (h @ params["lm_head"]).to(torch.float32)
    return logits[..., :cfg.vocab_size], cache
