"""Public model API (``repro/models/api.py``): ``build_model(cfg)``
returns a ``Model`` bundle of functions — init, loss, prefill,
decode_step, init_cache — over the JAX package's parameter layout
(nested dicts of tensors, the layers stacked along L), and
:func:`input_specs` / :func:`abstract_params` / :func:`abstract_cache`
give a workload's inputs, parameters and cache as tensors on the meta
device (shapes and dtypes, no storage), the counterpart of the
reference's ``ShapeDtypeStruct`` stand-ins.

``loss`` is the training loss of every family (dense, moe, ssm,
hybrid, vlm, audio) on its plain differentiable path; ``prefill``,
``decode_step`` and ``init_cache`` serve every family but the audio
encoder, which raises ``ValueError`` as the reference does.
``init`` and ``init_cache`` run on CUDA unless the caller passes
``device=``; without CUDA they raise.  Tokens and labels are int64
(torch's index dtype; the reference's are int32); the vlm's patches
and the audio family's frames are in the parameter dtype.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.model_config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.utils.pytree import tree_leaves

from . import transformer as tf

META = torch.device("meta")


class Model(NamedTuple):
    config: ModelConfig
    init: Callable  # (seed, device=None) -> params
    loss: Callable  # (params, batch) -> scalar
    prefill: Callable  # (params, batch, max_seq) -> (logits, cache)
    decode_step: Callable  # (params, token, cache) -> (logits, cache)
    init_cache: Callable  # (batch, max_seq, device=None) -> cache


def build_model(cfg: ModelConfig) -> Model:
    tf.check_family(cfg)
    return Model(
        config=cfg,
        init=lambda seed=0, device=None: tf.init_params(
            cfg, seed, device=resolve_device(device)),
        loss=lambda params, batch: tf.loss_fn(cfg, params, batch),
        prefill=lambda params, batch, max_seq=None: tf.prefill(
            cfg, params, batch, max_seq),
        decode_step=lambda params, token, cache: tf.decode_step(
            cfg, params, token, cache),
        init_cache=lambda batch, max_seq, device=None: tf.init_cache(
            cfg, batch, max_seq, device=resolve_device(device)),
    )


def input_specs(cfg: ModelConfig, *, mode: str, batch: int, seq: int):
    """The batch of a train / prefill / decode step as meta tensors:
    ``{"tokens", "labels"}`` (B, S), ``{"tokens"}`` (B, S) or
    ``{"token"}`` (B, 1), int64; the audio family's train batch holds
    ``features`` (B, S, frontend_dim) in place of tokens, and the vlm's
    ``patches`` (B, prefix_tokens, frontend_dim) and S − prefix_tokens
    text positions."""
    def tok(*shape):
        return torch.empty(shape, dtype=torch.int64, device=META)

    def emb(*shape):
        return torch.empty(shape, dtype=cfg.param_dtype, device=META)

    text = seq - cfg.prefix_tokens
    if mode == "train":
        if cfg.family == "audio":
            return {"features": emb(batch, seq, cfg.frontend_dim),
                    "labels": tok(batch, seq)}
        if cfg.family == "vlm":
            return {"patches": emb(batch, cfg.prefix_tokens,
                                   cfg.frontend_dim),
                    "tokens": tok(batch, text), "labels": tok(batch, text)}
        return {"tokens": tok(batch, seq), "labels": tok(batch, seq)}
    if mode == "prefill":
        if cfg.family == "vlm":
            return {"patches": emb(batch, cfg.prefix_tokens,
                                   cfg.frontend_dim),
                    "tokens": tok(batch, text)}
        return {"tokens": tok(batch, seq)}
    if mode == "decode":
        return {"token": tok(batch, 1)}
    raise ValueError(mode)


def abstract_params(model: Model):
    """The parameter tree on the meta device (no allocation)."""
    return tf.init_params(model.config, device=META)


def abstract_cache(model: Model, batch: int, max_seq: int):
    return tf.init_cache(model.config, batch, max_seq, device=META)


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the model, counted from shapes (no allocation)."""
    return sum(p.numel() for p in tree_leaves(
        tf.init_params(cfg, device=META)))


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters per token: the MoE blocks' expert weights
    (``w_gate``, ``w_up``, ``w_down`` under ``moe``) count top_k of
    num_experts, every other weight in full."""
    total = param_count(cfg)
    if not cfg.num_experts:
        return total
    layers = tf.init_params(cfg, device=META)["layers"]
    expert = sum(layers["moe"][k].numel()
                 for k in ("w_gate", "w_up", "w_down"))
    return total - expert + expert * cfg.top_k // cfg.num_experts
