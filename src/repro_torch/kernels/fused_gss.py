"""K3: the compact round's fused gather → ADMM commit → scatter.

Replaces ``src/repro/kernels/fused_gss.py::fused_gss`` (Pallas bodies
``_fused_gss3`` / ``_fused_gss2``).  For every capacity slot i with
``valid[i]``, at state row r = idx[i]:

    λ⁺ = (λ[r] + θ[r]) − ω ;  θ[r] ← solved[i] ;  λ[r] ← λ⁺ ;
    z_prev[r] ← solved[i] + λ⁺

**In place.**  The JAX kernel returns new arrays that alias its inputs
under donation; here θ, λ and z_prev are updated in place and returned
for convenience.  Rows not planned, and slots with ``valid[i]`` false,
are left untouched.  Plan indices must be distinct (a compact plan's
are: they are a prefix of a permutation).  Callers that need the old
state clone it first.

The CUDA kernel (``csrc/fedback_kernels.cu::fused_gss_kernel``) runs a
(⌈D/1024⌉, C) grid whose blocks read their slot's index and mask
themselves; see the source note for its bound.
"""
from __future__ import annotations

import torch

from ._build import check_launch, load_library
from ._checks import check_f32, is_cpu, stream_ptr


def fused_gss_hbm_bytes(rows: int, dim: int, *, with_z: bool = True,
                        dtype_bytes: int = 4) -> int:
    """Bytes one commit over ``rows`` valid slots must move: θ/λ rows and
    the solved row read, θ/λ (+z) rows written — 6 streams with z, 5
    without — plus ω once.  (The Pallas kernel also reads z_prev for its
    masked write-back: 7 streams; this kernel never reads it.)"""
    n_stream = 6 if with_z else 5
    return dtype_bytes * (n_stream * rows * dim + dim)


def fused_gss_ref(idx, valid, solved, omega, theta, lam, z_prev=None, *,
                  with_z: bool = True):
    """Plain PyTorch version, in place like the kernel.

    Invalid lanes write their gathered rows back unchanged (indices are
    distinct, so that is a no-op commit), which keeps the plain version
    free of host syncs.
    """
    if with_z and z_prev is None:
        raise ValueError("with_z=True needs z_prev")
    rows = idx.long()
    v = valid[:, None]
    th_rows = theta[rows]
    la_rows = lam[rows]
    lam_new = la_rows + th_rows - omega[None]
    theta[rows] = torch.where(v, solved, th_rows)
    lam[rows] = torch.where(v, lam_new, la_rows)
    if not with_z:
        return theta, lam
    z_prev[rows] = torch.where(v, solved + lam_new, z_prev[rows])
    return theta, lam, z_prev


def fused_gss(idx, valid, solved, omega, theta, lam, z_prev=None, *,
              with_z: bool = True):
    """idx: (C,) int32 distinct rows; valid: (C,) bool; solved: (C, D);
    ω: (D,); θ/λ/z_prev: (N, D) fp32, updated in place.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).  Returns (θ, λ, z_prev), or (θ, λ) without z.
    """
    if with_z and z_prev is None:
        raise ValueError("with_z=True needs z_prev")
    state = (theta, lam) + ((z_prev,) if with_z else ())
    if is_cpu(idx, valid, solved, omega, *state):
        return fused_gss_ref(idx, valid, solved, omega, theta, lam, z_prev,
                             with_z=with_z)
    n, d = theta.shape
    c = idx.shape[0]
    if idx.dtype != torch.int32 or tuple(idx.shape) != (c,):
        raise TypeError(f"idx: expected (C,) int32, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (c,):
        raise TypeError(f"valid: expected ({c},) bool, got {valid.dtype} "
                        f"{tuple(valid.shape)}")
    if not (idx.is_contiguous() and valid.is_contiguous()):
        raise ValueError("idx and valid must be contiguous")
    if c > 65535:
        raise ValueError(f"at most 65535 slots per launch, got {c}")
    check_f32("solved", solved, (c, d))
    check_f32("omega", omega, (d,))
    for name, t in zip(("theta", "lam", "z_prev"), state, strict=False):
        check_f32(name, t, (n, d))
    if c and d:
        rc = load_library().fb_fused_gss(
            idx.data_ptr(), valid.data_ptr(), solved.data_ptr(),
            omega.data_ptr(), theta.data_ptr(), lam.data_ptr(),
            z_prev.data_ptr() if with_z else None, c, n, d, int(with_z),
            stream_ptr(theta))
        check_launch("fused_gss", rc)
        fused_gss.launches += 1
    return state


fused_gss.launches = 0
