"""K2: the fused ADMM client update (paper Eq. 2.3).

    λ⁺ = (λ + θ) − ω ;  z = θ + λ⁺ ;  c = ω − λ⁺

Replaces ``src/repro/kernels/admm_update.py::admm_update`` (Pallas
bodies ``_kernel3`` / ``_kernel2``).  The CUDA kernel
(``csrc/fedback_kernels.cu::admm_update_kernel``) is one grid-stride
elementwise pass with the reference's operation order, so its outputs
are bit-identical to :func:`admm_update_ref`.  ``with_z=False`` (λ⁺ and
the prox center only) is the dense round's pre-solve form.

K2a: θ, λ and ω all bf16 take the kernel's bf16 instance
(``admm_update_kernel<BF16>``), which rounds to bf16 after every add or
subtract, in the reference's order — λ⁺ = rn(rn(λ + θ) − ω), z =
rn(θ + λ⁺), c = rn(ω − λ⁺) — as the plain version's bf16 ops do, so it
too is bit-identical to :func:`admm_update_ref`.  Its streams move as
16-byte words of 8 elements where every base is 16-byte aligned
(:func:`bf16_vector_width`; ``admm_update_bf16x8_kernel``), else
element by element.

K2b, :func:`admm_update_sharded`, replaces
``admm_update.py::admm_update_sharded`` (``shard_map`` of K2 over the
``clients`` mesh axis): the same kernel launched once per shard of a
client mesh on that shard's rows; elementwise, so bit-equal to K2 on
those rows, and like K2 bound by the bytes of its rows.
"""
from __future__ import annotations

import torch

from repro_torch.utils.spans import kernel_wrapper

from ._build import check_launch, load_library
from ._checks import check_f32, check_shards, is_cpu, refuse_grad, \
    stream_ptr

DTYPES = (torch.float32, torch.bfloat16)


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


def bf16_vector_width(ptrs) -> int:
    """K2a's access width for the bf16 arrays at ``ptrs`` (θ, λ and the
    outputs): 8 elements (16 bytes) where every base is 16-byte aligned,
    else 1.  It needs no card."""
    return 8 if all(p % 16 == 0 for p in ptrs) else 1


def _kernel(theta, lam, omega, with_z: bool):
    """K2's kernel on one CUDA device — the fp32 instance, or K2a's for
    bf16 operands: (its outputs, whether a launch was made — none for an
    empty state).  The callers count."""
    n, d = theta.shape
    check_f32("theta", theta, (n, d), DTYPES)
    check_f32("lam", lam, (n, d), (theta.dtype,))
    check_f32("omega", omega, (d,), (theta.dtype,))
    lam_new = torch.empty_like(theta)
    center = torch.empty_like(theta)
    z = torch.empty_like(theta) if with_z else None
    out = (lam_new, z, center) if with_z else (lam_new, center)
    if not n * d:
        return out, False
    ptrs = [t.data_ptr() for t in (theta, lam, lam_new, center)
            + ((z,) if with_z else ())]
    with torch.cuda.device(theta.device):
        lib = load_library()
        args = (theta.data_ptr(), lam.data_ptr(), omega.data_ptr(),
                lam_new.data_ptr(), None if z is None else z.data_ptr(),
                center.data_ptr(), n, d, int(with_z))
        if theta.dtype == torch.bfloat16:
            rc = lib.fb_admm_update_bf16(*args, bf16_vector_width(ptrs),
                                         stream_ptr(theta))
        else:
            rc = lib.fb_admm_update(*args, stream_ptr(theta))
    check_launch("admm_update", rc)
    return out, True


@kernel_wrapper("admm_update")
def admm_update(theta, lam, omega, *, with_z: bool = True, mesh=None):
    """θ, λ: (N, D); ω: (D,), all fp32 or all bf16 → new (N, D)
    tensors in that dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise).  With ``mesh`` the arguments are per shard and the call
    is :func:`admm_update_sharded`'s.
    """
    refuse_grad("admm_update", theta, lam, omega)
    if mesh is not None:
        return admm_update_sharded(theta, lam, omega, mesh, with_z=with_z)
    if is_cpu(theta, lam, omega):
        return admm_update_ref(theta, lam, omega, with_z=with_z)
    out, launched = _kernel(theta, lam, omega, with_z)
    admm_update.launches += launched
    return out


admm_update.launches = 0


def admm_update_sharded_ref(theta, lam, omega, *, with_z: bool = True):
    """Plain version of K2b: K2's plain version on each shard, returned
    as :func:`admm_update_sharded` returns."""
    per = [admm_update_ref(t, la, w, with_z=with_z)
           for t, la, w in zip(theta, lam, omega, strict=True)]
    return tuple(list(x) for x in zip(*per, strict=True))


@kernel_wrapper("admm_update_sharded")
def admm_update_sharded(theta, lam, omega, mesh, *, with_z: bool = True):
    """K2 per shard of a client mesh: θ and λ the P per-shard (N/P, D)
    blocks and ω the P copies of the (D,) vector (all fp32 or all bf16:
    a bf16 shard takes K2a), shard i's on
    ``mesh.devices[i]`` → (λ⁺, z, c), or (λ⁺, c) without z, each a list
    of P per-shard blocks.

    One launch of K2's kernel per shard (the plain version for a shard
    on the CPU); each launch counts here, not under K2.
    """
    refuse_grad("admm_update_sharded", theta, lam, omega)
    check_shards(mesh, theta=theta, lam=lam, omega=omega)
    per = []
    for t, la, w in zip(theta, lam, omega, strict=True):
        if is_cpu(t, la, w):
            per.append(admm_update_ref(t, la, w, with_z=with_z))
            continue
        out, launched = _kernel(t, la, w, with_z)
        admm_update_sharded.launches += launched
        per.append(out)
    return tuple(list(x) for x in zip(*per, strict=True))


admm_update_sharded.launches = 0
