"""Architecture and workload-shape registry (the twin of
``repro/configs/__init__.py``).

Every architecture of the model zoo is a module ``<id>.py`` holding its
``CONFIG`` (the public spec, its source cited), a copy of the JAX
package's, across the six families: dense (deepseek-67b, granite-3-2b,
phi3-medium-14b), moe (qwen3-moe-235b-a22b, moonshot-v1-16b-a3b,
mixtral-8x7b), ssm (mamba2-2.7b), hybrid (zamba2-2.7b), vlm
(paligemma-3b) and audio (hubert-xlarge).  ``get_config`` takes the
module name or the dashed id (``zamba2-2.7b``); an unknown name raises
``KeyError``.  The paper's workloads (``paper_mnist``, ``paper_cifar``)
are not model configurations: build them with their module's
``workload()``.
"""
from __future__ import annotations

import importlib

from .model_config import ModelConfig

ARCHITECTURES = (
    "deepseek_67b",
    "paligemma_3b",
    "mamba2_2_7b",
    "zamba2_2_7b",
    "qwen3_moe_235b_a22b",
    "granite_3_2b",
    "moonshot_v1_16b_a3b",
    "mixtral_8x7b",
    "phi3_medium_14b",
    "hubert_xlarge",
)

# canonical ids as assigned (dashes) → module names (underscores)
_ALIASES = {a.replace("_", "-"): a for a in ARCHITECTURES}
_ALIASES["mamba2-2.7b"] = "mamba2_2_7b"
_ALIASES["zamba2-2.7b"] = "zamba2_2_7b"

# workload shapes: (mode, seq_len, global_batch)
INPUT_SHAPES = {
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("decode", 524_288, 1),
}

_WORKLOADS = ("paper_mnist", "paper_cifar")


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name in _WORKLOADS:
        # The reference reaches ``mod.CONFIG`` here, which these modules
        # lack (an AttributeError).
        raise KeyError(f"{arch!r} is the paper's workload, not a model "
                       f"configuration: use repro_torch.configs.{mod_name}"
                       ".workload()")
    if mod_name not in ARCHITECTURES:
        raise KeyError(f"unknown architecture {arch!r}; "
                       f"available: {sorted(_ALIASES)}")
    return importlib.import_module(f"{__name__}.{mod_name}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHITECTURES}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    mode, seq, batch = INPUT_SHAPES[shape]
    if mode == "decode" and not cfg.supports_decode:
        return False, "encoder-only architecture: no autoregressive decode"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention architecture without sliding-window "
                       "variant: long_500k requires sub-quadratic attention")
    return True, ""
