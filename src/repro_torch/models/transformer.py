"""The model zoo's stacks (``repro/models/transformer.py``), two
families so far:

  dense   — [GQA attn + SwiGLU] × L                 (granite)
  hybrid  — Mamba-2 backbone + ONE shared attn+MLP block applied after
            every ``attn_every`` mamba layers (Zamba2's shared-block
            design: the same parameters are re-applied at each group's
            depth)

Parameters are the JAX tree's layout: a nested dict of tensors whose
``layers`` leaves are stacked along a leading L axis (for the hybrid,
layer i belongs to group i // attn_every).  Serving and training take
the same tree; each layer reads views of its rows.  The JAX package's
``constrain_batch`` is a sharding hint and has no counterpart on one
device.

Serving (both families): prefill (K4 through the attention module, K5
through the SSM module) and single-token decode.  Training (dense
only): :func:`forward_hidden` and :func:`loss_fn`, the attention
through ``blockwise_attention`` (plain and differentiable), each layer
recomputed in backward under ``cfg.remat`` (``torch.utils.checkpoint``
over groups of ``cfg.remat_group`` layers, as the reference's
``jax.checkpoint`` of its scan body).  The hybrid family's loss and the
other families (moe, ssm, vlm, audio) raise ``NotImplementedError``
(ROADMAP M17b).

The caches mirror the JAX package's: dense ``k``/``v`` (L, B, S_cache,
KvH, hd); hybrid ``layers.ssm`` (L, B, H, P, N) fp32, ``layers.conv``
(L, B, K−1, conv_dim), ``k``/``v`` (L/attn_every, B, S_cache, KvH, hd);
and ``pos``, the next position, kept as a host int so decode never
reads it back from the card.  Decode updates the cache tensors in
place.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng

from .attention import attention_decode, attention_forward, attention_init
from .layers import (
    chunked_lm_loss,
    dense_init,
    embed_init,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
)
from .ssm import ssm_cache_init, ssm_decode_step, ssm_forward, ssm_init
from repro_torch.utils.pytree import tree_leaves, tree_map


FAMILIES = ("dense", "hybrid")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to "
            "repro_torch yet (ROADMAP M17b); the port has the dense and "
            "hybrid families")
    if cfg.num_experts:
        raise NotImplementedError("MoE blocks are not ported (ROADMAP M17b)")


def check_loss(cfg) -> None:
    check_family(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family} family's training loss ({cfg.name}) is not "
            "ported to repro_torch yet (ROADMAP M17b); the port trains the "
            "dense family")


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


def _attn_block_apply(cfg, p, h, positions, *, window, blockwise=False):
    """One attention+MLP block → (h, its (k, v) for the cache): K4 in
    serving, ``blockwise_attention`` with ``blockwise=True`` (the
    training loss)."""
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    att, kv = attention_forward(
        p["attn"], x, positions=positions, rope_theta=cfg.rope_theta,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, mask_mode="causal", window=window,
        return_kv=True, blockwise=blockwise, kv_block=cfg.kv_block)
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


def init_params(cfg, seed: int = 0, *, device) -> dict:
    """The parameters of the JAX package's ``init_params(PRNGKey(seed),
    cfg)``, in its layout, drawn on ``device`` by the ``jax.random``
    twin along the reference's key tree (on ``device="meta"``: shapes
    only): keys[0] the embedding, keys[1] the head, keys[2] split over
    the layers as ``stacked_init`` splits it, keys[5] the hybrid's
    shared block.  The reference draws the layer stack as one ``vmap``
    over per-layer keys; here each layer is drawn on its own and written
    into its row of the stacked leaves, which gives the same values and
    bounds the draws' temporaries by one layer."""
    check_family(cfg)
    if cfg.family == "hybrid" and cfg.num_layers % cfg.attn_every:
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
    }
    block = _attn_block_init if cfg.family == "dense" else _ssm_block_init
    if cfg.family == "hybrid":
        tree["shared"] = _attn_block_init(keys[5], cfg, device)
    stacked = None
    for i, k in enumerate(prng.split(keys[2], cfg.num_layers)):
        lp = block(k, cfg, device)
        if stacked is None:
            stacked = tree_map(
                lambda x: x.new_empty((cfg.num_layers,) + x.shape), lp)
        if device.type != "meta":
            for dst, src in zip(tree_leaves(stacked), tree_leaves(lp),
                                strict=True):
                dst[i] = src
    tree["layers"] = stacked
    return tree


def _layers(params, n: int) -> list:
    """The per-layer parameter trees: views of row i of each stacked
    (L, ...) leaf (one backward node per leaf gathers the layers'
    gradients)."""
    split = tree_map(lambda x: x.unbind(0), params["layers"])
    return [tree_map(lambda parts, i=i: parts[i], split) for i in range(n)]


# ----------------------------------------------------------------------
# training: the dense family's forward and loss
# ----------------------------------------------------------------------


def _stack_attn(cfg, params, h, positions):
    """The dense stack in training: each block's attention through
    ``blockwise_attention``; under ``cfg.remat`` each group of
    ``cfg.remat_group`` layers (1 where it does not divide L) is
    recomputed in backward."""
    layers = _layers(params, cfg.num_layers)
    g = cfg.remat_group if cfg.num_layers % max(cfg.remat_group, 1) == 0 \
        else 1
    g = max(g, 1)

    def group(hh, *lps):
        for lp in lps:
            hh, _ = _attn_block_apply(cfg, lp, hh, positions,
                                      window=cfg.sliding_window,
                                      blockwise=True)
        return hh

    for i in range(0, cfg.num_layers, g):
        lps = layers[i:i + g]
        if cfg.remat:
            h = checkpoint(group, h, *lps, use_reentrant=False)
        else:
            h = group(h, *lps)
    return h


def forward_hidden(cfg, params, batch):
    """Embed the tokens and run the dense stack → final hidden states
    (B, S, d) (the reference's ``aux`` is 0 without MoE)."""
    check_loss(cfg)
    # ``embedding``: its backward adds the rows in a fixed order, where
    # indexing's backward (an accumulating ``index_put_``) does not on
    # the CPU, and a round must repeat bit for bit.
    h = torch.nn.functional.embedding(batch["tokens"], params["embed"])
    positions = torch.arange(h.shape[1], device=h.device)
    return _stack_attn(cfg, params, h, positions)


def loss_fn(cfg, params, batch):
    """Next-token cross-entropy of the dense family: ``batch`` holds
    ``tokens`` and ``labels`` (B, S); the head's padded vocabulary
    columns are masked, the sequence chunked by ``cfg.loss_chunk``."""
    h = forward_hidden(cfg, params, batch)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    return chunked_lm_loss(h, params["lm_head"], batch["labels"],
                           cfg.loss_chunk, valid_vocab=cfg.vocab_size)


# ----------------------------------------------------------------------
# serving: prefill + single-token decode
# ----------------------------------------------------------------------


def init_cache(cfg, batch_size, max_seq, dtype=None, *, device):
    check_family(cfg)
    dtype = dtype or cfg.param_dtype
    s = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    n_kv = (cfg.num_layers if cfg.family == "dense"
            else cfg.num_layers // cfg.attn_every)
    kv = (n_kv, batch_size, s, cfg.num_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "pos": 0,
    }
    if cfg.family == "hybrid":
        one = ssm_cache_init(batch_size, cfg.d_model, dtype=dtype,
                             device=device, **_ssm_kw(cfg))
        cache["layers"] = {
            k: torch.zeros((cfg.num_layers,) + x.shape, dtype=x.dtype,
                           device=device) for k, x in one.items()}
    return cache


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
    layers = _layers(params, cfg.num_layers)
    ks, vs = [], []
    if cfg.family == "dense":
        for lp in layers:
            h, (k, v) = _attn_block_apply(cfg, lp, h, positions,
                                          window=cfg.sliding_window)
            ks.append(k)
            vs.append(v)
        cache = _fit_kv_cache(cfg, torch.stack(ks), torch.stack(vs),
                              max_seq, s)
    else:
        ssm_states, conv_tails = [], []
        for group in _groups(cfg):
            for i in group:
                h, st, tail = _ssm_block_apply(cfg, layers[i], h)
                ssm_states.append(st)
                conv_tails.append(tail)
            h, (k, v) = _attn_block_apply(cfg, params["shared"], h,
                                          positions,
                                          window=cfg.sliding_window)
            ks.append(k)
            vs.append(v)
        cache = _fit_kv_cache(cfg, torch.stack(ks), torch.stack(vs),
                              max_seq, s)
        cache["layers"] = {"ssm": torch.stack(ssm_states),
                           "conv": torch.stack(conv_tails)}
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
    """Pad/crop prefill KV (L or G, B, S, Kv, hd) into the serving
    cache."""
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
    layers = _layers(params, cfg.num_layers)
    if cfg.family == "dense":
        for i, lp in enumerate(layers):
            h, _ = _attn_block_decode(cfg, lp, h,
                                      (cache["k"][i], cache["v"][i]), pos,
                                      window=cfg.sliding_window)
    else:
        lc = cache["layers"]
        for gi, group in enumerate(_groups(cfg)):
            for i in group:
                h, new = _ssm_block_decode(
                    cfg, layers[i], h,
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
