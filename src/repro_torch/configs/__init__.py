"""Experiment configurations of the port.

``get_config`` knows the model configurations the port has so far,
each under its name and its module's name (``zamba2-2.7b`` or
``zamba2_2_7b``): ``zamba2-2.7b`` (the hybrid family) and
``mamba2-2.7b`` (the ssm family), served and trained;
``granite-3-2b`` (dense, served and trained); ``phi3-medium-14b`` and
``deepseek-67b`` (dense; deepseek does not fit one card and runs
reduced).  The JAX package's other architectures are not ported yet
(ROADMAP M17b) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from .model_config import ModelConfig

PORTED = ("zamba2-2.7b", "granite-3-2b", "mamba2-2.7b", "phi3-medium-14b",
          "deepseek-67b")
_ALIASES = {alias: name.replace("-", "_").replace(".", "_")
            for name in PORTED
            for alias in (name, name.replace("-", "_").replace(".", "_"))}
# The JAX package's registry (``repro/configs/__init__.py``), for the
# error message.
UNPORTED = ("paligemma_3b", "qwen3_moe_235b_a22b", "moonshot_v1_16b_a3b",
            "mixtral_8x7b", "hubert_xlarge")


def get_config(arch: str) -> ModelConfig:
    name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if name in _ALIASES.values():
        return importlib.import_module(f"{__name__}.{name}").CONFIG
    ported = ", ".join(PORTED)
    if name in UNPORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet "
            f"(ROADMAP M17b); ported: {ported}")
    raise KeyError(f"unknown architecture {arch!r}; ported: {ported}")
