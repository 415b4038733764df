"""The model zoo's stacks (``repro/models/transformer.py``), its six
families:

  dense   — [GQA attn + SwiGLU] × L                 (granite, phi3,
                                                     deepseek)
  moe     — [GQA attn + top-k MoE] × L              (mixtral, qwen3,
                                                     moonshot)
  ssm     — [Mamba-2 mixer] × L                     (mamba2)
  hybrid  — Mamba-2 backbone + ONE shared attn+MLP block applied after
            every ``attn_every`` mamba layers (Zamba2's shared-block
            design: the same parameters are re-applied at each group's
            depth)
  vlm     — dense decoder over projected patch embeddings and the
            text, prefix-LM masked over the patches (PaliGemma)
  audio   — bidirectional encoder over projected frame embeddings
            (HuBERT; no embedding, no decode)

Parameters are the JAX tree's layout: a nested dict of tensors whose
``layers`` leaves are stacked along a leading L axis (for the hybrid,
layer i belongs to group i // attn_every).  Serving and training take
the same tree; each layer reads views of its rows.  The JAX package's
``constrain_batch`` is a sharding hint and has no counterpart on one
device.

Serving on a model mesh lives in ``sharding/serve.py``: under fsdp it
runs :func:`prefill` / :func:`decode_step` on gathered layers, under
tp, fsdp_tp and ep it calls this module's per-family hooks on one model
shard's parameters (:func:`_embed`, :func:`_layers`, :func:`_groups`,
:func:`_attention` / :func:`_attention_step` with a shard's head
counts, :func:`_fit_kv_cache`, :func:`_check_room`) and the mixers'
per-head and per-expert pieces (``models/ssm.py``, ``models/moe.py``).

Serving (every family but audio): prefill (K4 through the attention
module for the causal masks, K5 through the SSM module; the vlm's
prefix mask through ``blockwise_attention``, as neither K4 nor the
Pallas kernel has it) and single-token decode.  Training:
:func:`forward_hidden` and :func:`loss_fn`, on the plain differentiable
paths the reference's ``jax.value_and_grad`` goes through — the
attention through ``blockwise_attention``, the SSD's inter-chunk scan
through ``ssd_scan_ref`` (K4 and K5 have no backward) — with the
mamba layers' intra-chunk terms in ``cfg.ssd_intra_dtype``, which
prefill ignores as the reference's does.  Under ``cfg.remat`` each
group is recomputed in backward (``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint`` of its scan body): ``cfg.remat_group``
layers in the attention and ssm stacks, one group of ``attn_every``
mamba layers and the shared block in the hybrid.  The MoE blocks' load
balance loss is summed over the layers and added to the loss times
``cfg.aux_coef``; the vlm's loss covers the text positions only.

The caches mirror the JAX package's: dense, moe and vlm ``k``/``v``
(L, B, S_cache, KvH, hd); ssm ``layers.ssm`` (L, B, H, P, N) fp32 and
``layers.conv`` (L, B, K−1, conv_dim); hybrid both, its ``k``/``v``
(L/attn_every, B, S_cache, KvH, hd); and ``pos``, the next position,
kept as a host int
so decode never reads it back from the card.  Decode updates the cache
tensors in place, and refuses a position past the end of a cache without
a window (the reference clamps the write onto the last slot: ROADMAP
D11, which a vlm cache sized for the text alone meets).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng

from .attention import attention_decode, attention_forward, attention_init
from .layers import (
    chunked_lm_sums,
    dense_init,
    embed_init,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
)
from .moe import moe_apply, moe_init
from .ssm import ssm_cache_init, ssm_decode_step, ssm_forward, ssm_init
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.utils.pytree import tree_leaves, tree_map


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
ATTN_STACK = ("dense", "moe", "vlm", "audio")  # [attn + MLP or MoE] × L
NO_DECODE = "encoder-only architectures have no decode path"


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); "
                         f"the families are {', '.join(FAMILIES)}")


# ----------------------------------------------------------------------
# per-layer blocks
# ----------------------------------------------------------------------


def _attn_block_init(key, cfg, device):
    dt = cfg.param_dtype
    k1, k2 = prng.split(key)
    p = {
        "ln1": rmsnorm_init(cfg.d_model, dt, device),
        "attn": attention_init(k1, cfg.d_model, cfg.num_heads,
                               cfg.num_kv_heads, cfg.head_dim, dt, device),
        "ln2": rmsnorm_init(cfg.d_model, dt, device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_init(k2, cfg.d_model, cfg.d_ff, cfg.num_experts, dt,
                            device)
    else:
        p["mlp"] = swiglu_init(k2, cfg.d_model, cfg.d_ff, dt, device)
    return p


def _ffn(cfg, p, x, return_aux=True):
    """The block's MLP or MoE → (y, aux fp32 0-d; 0 without MoE; the
    MoE's load statistics (2, E) with ``return_aux="stats"``)."""
    if "moe" in p:
        return moe_apply(p["moe"], x, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         return_aux=return_aux)
    return swiglu(p["mlp"], x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)


def _attention(cfg, p, x, positions, *, window, mask_mode="causal",
               prefix_len=0, blockwise=False, num_heads=None,
               num_kv_heads=None, kv=None, project=True, q=None):
    """The attention of the block ``p`` over its normed input x →
    (output, its (k, v) for the cache): K4 under the causal mask in
    serving, ``blockwise_attention`` under the prefix mask or with
    ``blockwise=True``.  A model shard passes its head counts, ``kv``,
    ``q`` and ``project=False`` (``attention_forward``)."""
    return attention_forward(
        p["attn"], x, positions=positions, rope_theta=cfg.rope_theta,
        num_heads=num_heads or cfg.num_heads,
        num_kv_heads=num_kv_heads or cfg.num_kv_heads,
        head_dim=cfg.head_dim, mask_mode=mask_mode, prefix_len=prefix_len,
        window=window, return_kv=True, blockwise=blockwise,
        kv_block=cfg.kv_block, kv=kv, project=project, q=q)


def _attention_step(cfg, p, x, kv_cache, pos, *, window, num_heads=None,
                    num_kv_heads=None, kv=None, project=True, q=None):
    """One decode step of the block's attention against its (k, v) cache
    (updated in place); a model shard passes its head counts, ``kv``,
    ``q`` and ``project=False`` (``attention_decode``)."""
    att, _ = attention_decode(
        p["attn"], x, kv_cache, pos, rope_theta=cfg.rope_theta,
        num_heads=num_heads or cfg.num_heads,
        num_kv_heads=num_kv_heads or cfg.num_kv_heads,
        head_dim=cfg.head_dim, window=window, kv=kv, project=project, q=q)
    return att


def _attn_block_apply(cfg, p, h, positions, *, window, mask_mode="causal",
                      prefix_len=0, blockwise=False, return_aux=True):
    """One attention+MLP (or MoE) block → (h, aux (``_ffn``'s), its (k,
    v) for the cache): the causal mask through K4 in serving, the prefix
    mask through ``blockwise_attention`` (no kernel has it), and with
    ``blockwise=True`` (the training loss) every mask through
    ``blockwise_attention``."""
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    att, kv = _attention(cfg, p, x, positions, window=window,
                         mask_mode=mask_mode, prefix_len=prefix_len,
                         blockwise=blockwise)
    h = h + att
    x = rmsnorm(h, p["ln2"], cfg.norm_eps)
    y, aux = _ffn(cfg, p, x, return_aux=return_aux)
    return h + y, aux, kv


def _attn_block_decode(cfg, p, h, kv_cache, pos, *, window):
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    h = h + _attention_step(cfg, p, x, kv_cache, pos, window=window)
    x = rmsnorm(h, p["ln2"], cfg.norm_eps)
    y, _ = _ffn(cfg, p, x, return_aux=False)
    return h + y


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
    """One mamba layer in training: the intra-chunk terms in
    ``cfg.ssd_intra_dtype`` and the inter-chunk scan through the plain
    ``ssd_scan_ref``, which autograd differentiates (the reference's
    ``_ssm_block_apply``)."""
    x = rmsnorm(h, p["ln"], cfg.norm_eps)
    return h + ssm_forward(p["ssm"], x, chunk=cfg.chunk,
                           intra_dtype=_intra_dtype(cfg), scan=ssd_scan_ref,
                           **_ssm_kw(cfg))


def _ssm_block_prefill(cfg, p, h):
    """One mamba layer in prefill → (h, final ssm state, conv tail): K5,
    the intra-chunk terms in the input dtype whatever
    ``cfg.ssd_intra_dtype`` says (the reference's prefill calls
    ``ssm_forward`` without it)."""
    x = rmsnorm(h, p["ln"], cfg.norm_eps)
    y, st = ssm_forward(p["ssm"], x, chunk=cfg.chunk, return_state=True,
                        **_ssm_kw(cfg))
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
    only): keys[0] the embedding (none in the audio family, whose
    frames come through ``frontend_proj`` from keys[3]), keys[1] the
    head, keys[2] split over the layers as ``stacked_init`` splits it,
    keys[4] the vlm's ``patch_proj``, keys[5] the hybrid's shared block.
    The reference draws the layer stack as one ``vmap`` over per-layer
    keys; here each layer is drawn on its own and written into its row
    of the stacked leaves, which gives the same values and bounds the
    draws' temporaries by one layer."""
    check_family(cfg)
    if cfg.family == "hybrid" and cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.num_layers} layers do not split into groups "
                         f"of {cfg.attn_every}")
    device = torch.device(device)
    keys = prng.split(prng.PRNGKey(seed, device=device), 8)
    dt = cfg.param_dtype
    tree = {"final_ln": rmsnorm_init(cfg.d_model, dt, device)}
    if cfg.family == "audio":
        tree["frontend_proj"] = dense_init(keys[3], cfg.frontend_dim,
                                           cfg.d_model, dt, device)
    else:
        tree["embed"] = embed_init(keys[0], cfg.vocab_padded, cfg.d_model,
                                   dt, device)
    tree["lm_head"] = dense_init(keys[1], cfg.d_model, cfg.vocab_padded, dt,
                                 device)
    if cfg.family == "vlm":
        tree["patch_proj"] = dense_init(keys[4], cfg.frontend_dim,
                                        cfg.d_model, dt, device)
    block = (_attn_block_init if cfg.family in ATTN_STACK
             else _ssm_block_init)
    if cfg.family == "hybrid":
        tree["shared"] = _attn_block_init(keys[5], cfg, device)
    stacked = None
    for i, k in enumerate(prng.split(keys[2], cfg.num_layers)):
        lp = block(k, cfg, device)
        if stacked is None:
            stacked = tree_map(
                lambda x: x.new_empty((cfg.num_layers,) + x.shape), lp)
        if device.type == "meta":
            break  # shapes only: one layer gives the stack's
        for dst, src in zip(tree_leaves(stacked), tree_leaves(lp),
                            strict=True):
            dst[i] = src
    tree["layers"] = stacked
    return tree


def _layers(params, n: int):
    """The per-layer parameter trees: views of row i of each stacked
    (L, ...) leaf (one backward node per leaf gathers the layers'
    gradients).  A sharded tree read ZeRO-3 style gives its own
    sequence: serving's (``sharding.params.GatheredParams``) each layer
    gathered onto its device when the layer is indexed, right before it
    runs; training's (``sharding.train.GradView``) a callable per layer
    that gathers it when :func:`_run_groups` calls it, inside the
    recomputed group."""
    if not isinstance(params, dict):
        return params.layers(n)
    split = tree_map(lambda x: x.unbind(0), params["layers"])
    return [tree_map(lambda parts, i=i: parts[i], split) for i in range(n)]


# ----------------------------------------------------------------------
# training: forward and loss
# ----------------------------------------------------------------------


def _run_groups(cfg, state, groups, body):
    """``state = body(state, *group)`` for each group of per-layer trees,
    ``state`` a tuple of tensors ((h,) or (h, aux)); under ``cfg.remat``
    each group is recomputed in backward (the reference's
    ``jax.checkpoint`` of its scan body).  A layer given as a callable
    (a sharded tree's, gathered when called) is called inside the group,
    so that under ``cfg.remat`` backward gathers it again and no
    gathered layer is kept from forward to backward."""
    def run(state, *grp):
        return body(state, *(lp() if callable(lp) else lp for lp in grp))

    for grp in groups:
        state = (checkpoint(run, state, *grp, use_reentrant=False)
                 if cfg.remat else run(state, *grp))
    return state


def _remat_groups(cfg, layers):
    """The layers in groups of ``cfg.remat_group`` (1 where it does not
    divide L), as the reference's ``_group``."""
    g = cfg.remat_group if cfg.num_layers % max(cfg.remat_group, 1) == 0 \
        else 1
    g = max(g, 1)
    return [layers[i:i + g] for i in range(0, cfg.num_layers, g)]


def _stack_attn(cfg, params, h, positions, *, mask_mode="causal",
                prefix_len=0, moe_stats=False):
    """The attention stack in training (dense, moe, vlm, audio): each
    block's attention through ``blockwise_attention`` under
    ``mask_mode``; → (h, the blocks' aux summed; with ``moe_stats`` the
    MoE blocks' load statistics stacked (L, 2, E))."""
    def body(state, *lps):
        hh, aux = state
        for lp in lps:
            hh, a, _ = _attn_block_apply(
                cfg, lp, hh, positions, window=cfg.sliding_window,
                mask_mode=mask_mode, prefix_len=prefix_len, blockwise=True,
                return_aux="stats" if moe_stats else True)
            aux = torch.cat([aux, a[None]]) if moe_stats else aux + a
        return hh, aux

    if moe_stats:
        aux = torch.zeros((0, 2, cfg.num_experts), dtype=torch.float32,
                          device=h.device)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _run_groups(cfg, (h, aux), _remat_groups(
        cfg, _layers(params, cfg.num_layers)), body)


def _stack_ssm(cfg, params, h):
    """The ssm stack in training (the reference's ``_stack_ssm``)."""
    def body(state, *lps):
        (hh,) = state
        for lp in lps:
            hh = _ssm_block_apply(cfg, lp, hh)
        return (hh,)

    (h,) = _run_groups(cfg, (h,), _remat_groups(
        cfg, _layers(params, cfg.num_layers)), body)
    return h


def _stack_hybrid(cfg, params, h, positions):
    """The hybrid stack in training (the reference's ``_stack_hybrid``):
    per group, ``attn_every`` mamba layers, then the shared block with
    its attention through ``blockwise_attention``; under ``cfg.remat``
    one group is the recomputed unit.  The shared block's leaves are
    used once per group, and autograd adds their gradients."""
    layers = _layers(params, cfg.num_layers)
    shared = params["shared"]

    def body(state, *lps):
        (hh,) = state
        for lp in lps:
            hh = _ssm_block_apply(cfg, lp, hh)
        hh, _, _ = _attn_block_apply(cfg, shared, hh, positions,
                                     window=cfg.sliding_window,
                                     blockwise=True)
        return (hh,)

    (h,) = _run_groups(cfg, (h,), [[layers[i] for i in g]
                                   for g in _groups(cfg)], body)
    return h


def _embed(params, tokens):
    # ``embedding``: its backward adds the rows in a fixed order, where
    # indexing's backward (an accumulating ``index_put_``) does not on
    # the CPU, and a round must repeat bit for bit.
    return torch.nn.functional.embedding(tokens, params["embed"])


def forward_hidden(cfg, params, batch, moe_stats=False):
    """Embed the inputs and run the stack → (final hidden states (B, S,
    d), the MoE blocks' aux summed; 0 without MoE): ``batch`` holds
    ``tokens``, and for the vlm ``patches`` (B, P, frontend_dim) too,
    projected and put before the text; the audio family takes
    ``features`` (B, S, frontend_dim) in place of tokens.  With
    ``moe_stats`` the MoE family gives its blocks' load statistics (L,
    2, E) (``moe.load_stats``) in place of aux."""
    check_family(cfg)
    if cfg.family == "audio":
        h = batch["features"].to(cfg.param_dtype) @ params["frontend_proj"]
        positions = torch.arange(h.shape[1], device=h.device)
        return _stack_attn(cfg, params, h, positions, mask_mode="bidir")
    h = _embed(params, batch["tokens"])
    if cfg.family == "vlm":
        patches = batch["patches"].to(cfg.param_dtype) @ params["patch_proj"]
        h = torch.cat([patches, h], dim=1)
        positions = torch.arange(h.shape[1], device=h.device)
        return _stack_attn(cfg, params, h, positions, mask_mode="prefix",
                           prefix_len=cfg.prefix_tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "ssm":
        return _stack_ssm(cfg, params, h), zero
    if cfg.family == "hybrid":
        return _stack_hybrid(cfg, params, h, positions), zero
    return _stack_attn(cfg, params, h, positions,
                       moe_stats=moe_stats and cfg.family == "moe")


IGNORE_LABEL = -100  # a label the loss leaves out (``chunked_lm_sums``)


def loss_terms(cfg, params, batch, moe_stats=False):
    """The training loss's terms → (Σ −log p(label) over the labelled
    positions (fp32), their count (int64), the MoE blocks' load-balance
    loss summed over the layers; 0 without MoE): next-token prediction
    (masked prediction for the audio family, the text positions only for
    the vlm) over ``batch["labels"]``, the head's padded vocabulary
    columns masked, the sequence chunked by ``cfg.loss_chunk``.  A batch
    split over data shards adds the shards' sums and counts, and with
    ``moe_stats`` the MoE family's load statistics in place of its aux
    (``forward_hidden``; ``sharding/train.py``)."""
    h, aux = forward_hidden(cfg, params, batch, moe_stats=moe_stats)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    if cfg.family == "vlm":
        h = h[:, cfg.prefix_tokens:]  # loss only over text positions
    nll, n = chunked_lm_sums(h, params["lm_head"], batch["labels"],
                             cfg.loss_chunk, ignore_index=IGNORE_LABEL,
                             valid_vocab=cfg.vocab_size)
    return nll, n, aux


def loss_fn(cfg, params, batch):
    """The training loss: the mean cross-entropy of :func:`loss_terms`
    plus ``cfg.aux_coef`` times the MoE blocks' load-balance loss."""
    nll, n, aux = loss_terms(cfg, params, batch)
    return nll / torch.clamp(n, min=1) + cfg.aux_coef * aux


# ----------------------------------------------------------------------
# serving: prefill + single-token decode
# ----------------------------------------------------------------------


def check_decodes(cfg) -> None:
    """The audio family is an encoder: it has no cache, prefill or
    decode (the reference raises the same ``ValueError``)."""
    check_family(cfg)
    if cfg.family == "audio":
        raise ValueError(NO_DECODE)


def init_cache(cfg, batch_size, max_seq, dtype=None, *, device):
    check_family(cfg)
    if cfg.family == "audio":
        raise ValueError(f"no cache for family {cfg.family}")
    dtype = dtype or cfg.param_dtype
    cache = {}
    if cfg.family != "ssm":
        s = (min(max_seq, cfg.sliding_window) if cfg.sliding_window
             else max_seq)
        n_kv = (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
                else cfg.num_layers)
        kv = (n_kv, batch_size, s, cfg.num_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(kv, dtype=dtype, device=device)
        cache["v"] = torch.zeros(kv, dtype=dtype, device=device)
    if cfg.family in ("ssm", "hybrid"):
        one = ssm_cache_init(batch_size, cfg.d_model, dtype=dtype,
                             device=device, **_ssm_kw(cfg))
        cache["layers"] = {
            k: torch.zeros((cfg.num_layers,) + x.shape, dtype=x.dtype,
                           device=device) for k, x in one.items()}
    cache["pos"] = 0
    return cache


def _groups(cfg):
    g = cfg.attn_every
    return [range(i * g, (i + 1) * g) for i in range(cfg.num_layers // g)]


@torch.no_grad()
def prefill(cfg, params, batch, max_seq=None):
    """Process a prompt; returns (last-token logits (B, 1, V) fp32, the
    filled cache).  The vlm's ``batch`` holds ``patches`` too: they are
    projected and put before the text, prefix-masked, and count in the
    cache's positions; ``max_seq`` defaults to the text's length, as the
    reference's does, and a cache without a window then holds prefix +
    text positions and no room for decode (D11: size it for the
    prefix)."""
    check_decodes(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_seq = max_seq or s
    h = _embed(params, tokens)
    mask = {}
    if cfg.family == "vlm":
        patches = batch["patches"].to(cfg.param_dtype) @ params["patch_proj"]
        h = torch.cat([patches, h], dim=1)
        s = h.shape[1]
        mask = dict(mask_mode="prefix", prefix_len=cfg.prefix_tokens)
    positions = torch.arange(s, device=h.device)
    layers = _layers(params, cfg.num_layers)
    ks, vs, ssm_states, conv_tails = [], [], [], []

    def mamba(hh, lp):
        hh, st, tail = _ssm_block_prefill(cfg, lp, hh)
        ssm_states.append(st)
        conv_tails.append(tail)
        return hh

    def attn(hh, lp):
        hh, _, (k, v) = _attn_block_apply(cfg, lp, hh, positions,
                                          window=cfg.sliding_window, **mask)
        ks.append(k)
        vs.append(v)
        return hh

    if cfg.family in ATTN_STACK:
        for lp in layers:
            h = attn(h, lp)
    elif cfg.family == "ssm":
        for lp in layers:
            h = mamba(h, lp)
    else:
        for group in _groups(cfg):
            for i in group:
                h = mamba(h, layers[i])
            h = attn(h, params["shared"])
    cache = (_fit_kv_cache(cfg, torch.stack(ks), torch.stack(vs), max_seq, s)
             if ks else {"pos": s})
    if ssm_states:
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


def _check_room(cfg, cache) -> None:
    """Without a window, a decode position past the cache's end raises."""
    pos = cache["pos"]
    if "k" in cache and not cfg.sliding_window and \
            pos >= cache["k"].shape[2]:
        raise ValueError(
            f"decode at position {pos} of a cache of {cache['k'].shape[2]} "
            "positions: the cache has no room for decode"
            + (f"; it was sized without the {cfg.prefix_tokens} prefix "
               "tokens (prefill's max_seq must count them: prefix + "
               "prompt + new tokens)" if cfg.family == "vlm" else ""))


@torch.no_grad()
def decode_step(cfg, params, token, cache):
    """One token (B, 1) given a filled cache → (logits (B, 1, V) fp32,
    the cache, updated in place with ``pos`` advanced).  Without a
    window, a position past the cache's end raises ``ValueError``."""
    check_decodes(cfg)
    pos = cache["pos"]
    _check_room(cfg, cache)
    h = _embed(params, token)
    layers = _layers(params, cfg.num_layers)

    def mamba(hh, i):
        lc = cache["layers"]
        hh, new = _ssm_block_decode(cfg, layers[i], hh,
                                    {"conv": lc["conv"][i],
                                     "ssm": lc["ssm"][i]})
        lc["conv"][i] = new["conv"]
        lc["ssm"][i] = new["ssm"]
        return hh

    def attn(hh, lp, j):
        return _attn_block_decode(cfg, lp, hh,
                                  (cache["k"][j], cache["v"][j]), pos,
                                  window=cfg.sliding_window)

    if cfg.family in ATTN_STACK:
        for i, lp in enumerate(layers):
            h = attn(h, lp, i)
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            h = mamba(h, i)
    else:
        for gi, group in enumerate(_groups(cfg)):
            for i in group:
                h = mamba(h, i)
            h = attn(h, params["shared"], gi)
    cache["pos"] = pos + 1
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
    logits = (h @ params["lm_head"]).to(torch.float32)
    return logits[..., :cfg.vocab_size], cache
