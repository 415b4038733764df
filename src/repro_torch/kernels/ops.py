"""Public kernel entry points of the port (``repro/kernels/ops.py``).

Each op takes the hand-written CUDA kernel for CUDA tensors and the
plain PyTorch version for CPU tensors; the choice is made by the
wrapper from where its inputs lie, never by a fallback.  Every kernel
wrapper counts its launches; :func:`launch_counts` reads the counts and
:func:`reset_launch_counts` sets them to 0 (flash attention's counts by
instance, ``flash_attention.instance_launches``, too), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from .admm_update import admm_update, admm_update_hbm_bytes  # noqa: F401
from .flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_flops,
    flash_attention_hbm_bytes,
)
from .fused_gss import fused_gss, fused_gss_hbm_bytes  # noqa: F401
from .ref import (  # noqa: F401
    admm_update_ref,
    flash_attention_ref,
    fused_gss_ref,
    ssd_scan_ref,
    trigger_sq_norms_ref,
)
from .ssd_scan import ssd_scan, ssd_scan_hbm_bytes  # noqa: F401
from .trigger_norms import (  # noqa: F401
    trigger_sq_norms,
    trigger_sq_norms_hbm_bytes,
)

KERNELS = {"trigger_sq_norms": trigger_sq_norms,
           "admm_update": admm_update,
           "fused_gss": fused_gss,
           "flash_attention": flash_attention,
           "ssd_scan": ssd_scan}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    flash_attention.instance_launches = dict.fromkeys(
        flash_attention.instance_launches, 0)


def trigger_sq_norms_pytree(z_prev: torch.Tensor,
                            omega: torch.Tensor) -> torch.Tensor:
    """The server trigger on the flat layout: the (N, D) state is read
    in place.  (The stacked-pytree form of the JAX package is not
    ported: the port keeps client state flat.)"""
    if z_prev.dim() != 2:
        raise NotImplementedError("only the flat (N, D) layout is ported")
    return trigger_sq_norms(z_prev, omega.reshape(-1))
