"""The plain PyTorch version of every ported kernel, in one place.

Each kernel module defines its own plain version beside its wrapper;
this module collects them as the port's counterpart of
``repro/kernels/ref.py`` (the oracles the tests and ``chip_smoke.py``
hold the kernels against).
"""
from .admm_update import admm_update_ref, admm_update_sharded_ref  # noqa: F401
from .flash_attention import flash_attention_ref  # noqa: F401
from .fused_gss import fused_gss_ref  # noqa: F401
from .ssd_scan import ssd_scan_ref  # noqa: F401
from .trigger_norms import (  # noqa: F401
    trigger_sq_norms_ref,
    trigger_sq_norms_sharded_ref,
)
from .trigger_pytree import trigger_sq_norms_pytree_ref  # noqa: F401
