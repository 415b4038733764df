"""Experiment configurations of the port.

``get_config`` knows the model configurations the port serves so far:
``zamba2-2.7b`` (alias ``zamba2_2_7b``).  The JAX package's other
architectures are not ported yet (ROADMAP M17) and raise
``NotImplementedError``.
"""
from __future__ import annotations

from .model_config import ModelConfig

_ALIASES = {"zamba2-2.7b": "zamba2_2_7b", "zamba2_2_7b": "zamba2_2_7b"}
# The JAX package's registry (``repro/configs/__init__.py``), for the
# error message.
UNPORTED = ("deepseek_67b", "paligemma_3b", "mamba2_2_7b",
            "qwen3_moe_235b_a22b", "granite_3_2b", "moonshot_v1_16b_a3b",
            "mixtral_8x7b", "phi3_medium_14b", "hubert_xlarge")


def get_config(arch: str) -> ModelConfig:
    name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name == "zamba2_2_7b":
        from .zamba2_2_7b import CONFIG
        return CONFIG
    if name in UNPORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet "
            "(ROADMAP M17); ported: zamba2-2.7b")
    raise KeyError(f"unknown architecture {arch!r}; ported: zamba2-2.7b")
