"""K1: per-client squared trigger distances ‖z_i^prev − ω‖².

Replaces ``src/repro/kernels/trigger_norms.py::trigger_sq_norms`` (the
Pallas body ``_kernel``).  The CUDA kernel
(``csrc/fedback_kernels.cu::trigger_sq_norms_kernel``) runs one block
per client row, summing groups of 4 in an order that depends only on
the row's values (identical rows give bit-equal sums, whatever their
alignment), with an fp32 block reduction; see the source note for its
bound and its known limit.  It masks the ragged edge of D itself
instead of padding to TPU tiles.

The caller takes the square root (``core/fedback.py``).
"""
from __future__ import annotations

import torch

from ._build import check_launch, load_library
from ._checks import check_f32, is_cpu, stream_ptr


def trigger_sq_norms_hbm_bytes(rows: int, dim: int) -> int:
    """Bytes one call must move: z read once, ω read once, (N,) written."""
    return 4 * (rows * dim + dim + rows)


def trigger_sq_norms_ref(z_prev: torch.Tensor,
                         omega: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, D), (D,) → (N,) fp32."""
    diff = z_prev.to(torch.float32) - omega.to(torch.float32)[None]
    return torch.sum(diff * diff, dim=1)


def trigger_sq_norms(z_prev: torch.Tensor,
                     omega: torch.Tensor) -> torch.Tensor:
    """(N, D) fp32, (D,) fp32 → (N,) fp32 squared distances.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).
    """
    if is_cpu(z_prev, omega):
        return trigger_sq_norms_ref(z_prev, omega)
    n, d = z_prev.shape
    check_f32("z_prev", z_prev, (n, d))
    check_f32("omega", omega, (d,))
    out = torch.empty((n,), dtype=torch.float32, device=z_prev.device)
    if n == 0:
        return out
    if d == 0:
        return out.zero_()
    rc = load_library().fb_trigger_sq_norms(
        z_prev.data_ptr(), omega.data_ptr(), out.data_ptr(), n, d,
        stream_ptr(z_prev))
    check_launch("trigger_sq_norms", rc)
    trigger_sq_norms.launches += 1
    return out


trigger_sq_norms.launches = 0
