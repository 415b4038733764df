"""Experiment configurations of the port.

``get_config`` knows the model configurations the port has so far:
``zamba2-2.7b`` (alias ``zamba2_2_7b``; the hybrid family, served) and
``granite-3-2b`` (alias ``granite_3_2b``; the dense family, served and
trained).  The JAX package's other architectures are not ported yet
(ROADMAP M17b) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from .model_config import ModelConfig

_ALIASES = {"zamba2-2.7b": "zamba2_2_7b", "zamba2_2_7b": "zamba2_2_7b",
            "granite-3-2b": "granite_3_2b", "granite_3_2b": "granite_3_2b"}
PORTED = ("zamba2-2.7b", "granite-3-2b")
# The JAX package's registry (``repro/configs/__init__.py``), for the
# error message.
UNPORTED = ("deepseek_67b", "paligemma_3b", "mamba2_2_7b",
            "qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b",
            "mixtral_8x7b", "phi3_medium_14b", "hubert_xlarge")


def get_config(arch: str) -> ModelConfig:
    name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name == "zamba2_2_7b":
        from .zamba2_2_7b import CONFIG
        return CONFIG
    if name == "granite_3_2b":
        from .granite_3_2b import CONFIG
        return CONFIG
    ported = ", ".join(PORTED)
    if name in UNPORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet "
            f"(ROADMAP M17b); ported: {ported}")
    raise KeyError(f"unknown architecture {arch!r}; ported: {ported}")
