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
grid sized to the card (:func:`fused_gss_geometry`) whose blocks stride
over (slot, 1024-column) tiles, two at a time, each tile reading its
slot's index and mask itself and skipping an invalid slot; rows move as
float2 where D is even and every base is 8-byte aligned
(:func:`check_kernel_args`), else as scalars.  See the source note for
its bound.

K3a: every operand but the plan in bf16 takes the kernel's bf16
instance, which rounds to bf16 after every add or subtract in the
reference's order — λ⁺ = rn(rn(λ[r] + θ[r]) − ω), z_prev[r] ←
rn(solved[i] + λ⁺) — as the plain version's bf16 ops do, so it is
bit-identical to :func:`fused_gss_ref`; its pairs are 4-byte words,
taken where D is even and every base is 4-byte aligned.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.utils.spans import kernel_wrapper

from ._build import check_launch, load_library
from ._checks import check_f32, is_cpu, refuse_grad, stream_ptr

DTYPES = (torch.float32, torch.bfloat16)


TILE_COLS = 1024  # columns of a tile: 4 for each of the kernel's 256 threads
# Two waves of the 8 blocks of 256 threads an SM holds: at the round's
# width (C = 16, D = 159,010) each block gets 1 or 2 tiles, which ran
# 9% faster than 4 blocks per SM striding over ~5 on an H100 (PERF.md).
BLOCKS_PER_SM = 16
MAX_TILES = 2**31 - 1


def fused_gss_geometry(c: int, d: int, sms: int) -> tuple[int, int]:
    """(grid, T): C·T tiles of ``TILE_COLS`` columns, tile t = slot·T +
    chunk covering columns [chunk·TILE_COLS, (chunk+1)·TILE_COLS) ∩
    [0, d) of its slot; block b of the grid takes the tiles b, b + grid,
    b + 2·grid, ...  The grid is ``BLOCKS_PER_SM`` blocks per SM, or one
    per tile where there are fewer tiles."""
    if c < 1 or d < 1 or sms < 1:
        raise ValueError(f"c, d and sms must be >= 1, got {(c, d, sms)}")
    tiles_per_slot = -(-d // TILE_COLS)
    if c * tiles_per_slot > MAX_TILES:
        raise ValueError(f"{c} slots × {tiles_per_slot} tiles exceed "
                         f"{MAX_TILES} tiles")
    return min(c * tiles_per_slot, sms * BLOCKS_PER_SM), tiles_per_slot


def check_kernel_args(c: int, d: int, sms: int, ptrs: tuple[int, ...],
                      elem_bytes: int = 4) -> tuple[int, int, int]:
    """The launch of the CUDA kernel for C slots of rows of ``d``
    elements on a card of ``sms`` SMs, with its arrays of
    ``elem_bytes``-byte elements (4: fp32, 2: bf16; solved, ω, θ, λ and
    z_prev if present) at ``ptrs``: (grid, T, vector width — 2 where d
    is even and every base is aligned to a pair, 2·``elem_bytes`` bytes,
    so every row is, else 1).  Raises ValueError on what it does not
    take.  It needs no card."""
    grid, tiles_per_slot = fused_gss_geometry(c, d, sms)
    pair = 2 * elem_bytes
    vec = 2 if d % 2 == 0 and all(p % pair == 0 for p in ptrs) else 1
    return grid, tiles_per_slot, vec


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


@kernel_wrapper("fused_gss")
def fused_gss(idx, valid, solved, omega, theta, lam, z_prev=None, *,
              with_z: bool = True):
    """idx: (C,) int32 distinct rows; valid: (C,) bool; solved: (C, D);
    ω: (D,); θ/λ/z_prev: (N, D), updated in place; solved, ω and the
    state all fp32 or all bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).  Returns (θ, λ, z_prev), or (θ, λ) without z.
    """
    refuse_grad("fused_gss", idx, valid, solved, omega, theta, lam, z_prev)
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
    check_f32("theta", theta, (n, d), DTYPES)
    check_f32("solved", solved, (c, d), (theta.dtype,))
    check_f32("omega", omega, (d,), (theta.dtype,))
    for name, t in zip(("lam", "z_prev"), state[1:], strict=False):
        check_f32(name, t, (n, d), (theta.dtype,))
    if c and d:
        bf16 = theta.dtype == torch.bfloat16
        grid, tiles_per_slot, vec = check_kernel_args(
            c, d, _sm_count(theta.device),
            tuple(t.data_ptr() for t in (solved, omega) + state),
            elem_bytes=theta.element_size())
        with torch.cuda.device(theta.device):
            lib = load_library()
            launch = lib.fb_fused_gss_bf16 if bf16 else lib.fb_fused_gss
            rc = launch(
                idx.data_ptr(), valid.data_ptr(), solved.data_ptr(),
                omega.data_ptr(), theta.data_ptr(), lam.data_ptr(),
                z_prev.data_ptr() if with_z else None, c, n, d, grid,
                tiles_per_slot, vec, int(with_z), stream_ptr(theta))
        check_launch("fused_gss", rc)
        fused_gss.launches += 1
    return state


fused_gss.launches = 0
