"""Public model API (``repro/models/api.py``): ``build_model(cfg)``
returns a ``Model`` bundle of functions — init, prefill, decode_step,
init_cache — over the port's parameter modules.

Only the serving path of the hybrid family is ported (ROADMAP M17): no
``loss`` (training), and no ``input_specs`` / abstract helpers (the
dry-run's).  ``init`` and ``init_cache`` run on CUDA unless the caller
passes ``device=``; without CUDA they raise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.model_config import ModelConfig
from repro_torch.device import resolve_device

from . import transformer as tf


class Model(NamedTuple):
    config: ModelConfig
    init: Callable  # (seed, device=None) -> params
    prefill: Callable  # (params, batch, max_seq) -> (logits, cache)
    decode_step: Callable  # (params, token, cache) -> (logits, cache)
    init_cache: Callable  # (batch, max_seq, device=None) -> cache


def build_model(cfg: ModelConfig) -> Model:
    tf.check_family(cfg)
    return Model(
        config=cfg,
        init=lambda seed=0, device=None: tf.init_params(
            cfg, seed, device=resolve_device(device)),
        prefill=lambda params, batch, max_seq=None: tf.prefill(
            cfg, params, batch, max_seq),
        decode_step=lambda params, token, cache: tf.decode_step(
            cfg, params, token, cache),
        init_cache=lambda batch, max_seq, device=None: tf.init_cache(
            cfg, batch, max_seq, device=resolve_device(device)),
    )


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the model, counted from shapes (no allocation)."""
    params = tf.init_params(cfg, device="meta")
    return sum(p.numel() for p in params.parameters())
