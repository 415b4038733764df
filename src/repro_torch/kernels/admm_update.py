"""K2: the fused ADMM client update (paper Eq. 2.3).

    λ⁺ = (λ + θ) − ω ;  z = θ + λ⁺ ;  c = ω − λ⁺

Replaces ``src/repro/kernels/admm_update.py::admm_update`` (Pallas
bodies ``_kernel3`` / ``_kernel2``).  The CUDA kernel
(``csrc/fedback_kernels.cu::admm_update_kernel``) is one grid-stride
elementwise pass with the reference's operation order, so its outputs
are bit-identical to :func:`admm_update_ref`.  ``with_z=False`` (λ⁺ and
the prox center only) is the dense round's pre-solve form.
"""
from __future__ import annotations

import torch

from ._build import check_launch, load_library
from ._checks import check_f32, is_cpu, stream_ptr


def admm_update_hbm_bytes(rows: int, dim: int, *, with_z: bool = True,
                          dtype_bytes: int = 4) -> int:
    """Bytes one pass must move: θ and λ read once, ω once, and one
    write per output — 5 streams with z, 4 without."""
    n_out = 3 if with_z else 2
    return dtype_bytes * ((2 + n_out) * rows * dim + dim)


def admm_update_ref(theta, lam, omega, *, with_z: bool = True):
    """Plain PyTorch version: (λ⁺, z, c), or (λ⁺, c) without z."""
    lam_new = lam + theta - omega[None]
    center = omega[None] - lam_new
    if not with_z:
        return lam_new, center
    return lam_new, theta + lam_new, center


def admm_update(theta, lam, omega, *, with_z: bool = True):
    """θ, λ: (N, D) fp32; ω: (D,) fp32 → new (N, D) tensors.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).
    """
    if is_cpu(theta, lam, omega):
        return admm_update_ref(theta, lam, omega, with_z=with_z)
    n, d = theta.shape
    check_f32("theta", theta, (n, d))
    check_f32("lam", lam, (n, d))
    check_f32("omega", omega, (d,))
    lam_new = torch.empty_like(theta)
    center = torch.empty_like(theta)
    z = torch.empty_like(theta) if with_z else None
    if n * d:
        rc = load_library().fb_admm_update(
            theta.data_ptr(), lam.data_ptr(), omega.data_ptr(),
            lam_new.data_ptr(), None if z is None else z.data_ptr(),
            center.data_ptr(), n, d, int(with_z), stream_ptr(theta))
        check_launch("admm_update", rc)
        admm_update.launches += 1
    return (lam_new, z, center) if with_z else (lam_new, center)


admm_update.launches = 0
